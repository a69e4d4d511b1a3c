// LayerNorm + gated MLP over an NHWC map, the PGSSTB tail on the training
// route: y = [x +] s_b * (fc2(a * gelu(g)) + b2), [a | g] = fc1(LN(x)) + b1,
// with an optional per-sample drop-path scale s_b.
//
//   mp_mlp      replaces _mlp_kernel (mp_hsir_tpu/ops/pallas_attention.py:965,
//               host _mlp_fwd_call :996, K6). bf16: mlp_tc_kernel, the
//               tensor-core tail tile of mlp_tail.cuh on the x tile staged
//               as bf16 (cp.async; LN in place). float32: mlp_f32_kernel,
//               the same tile in 3xTF32 (mlp_tail.cuh mlp_tail_f32) on the x
//               tile staged as float32. The scaled branch is rounded once,
//               then the residual added.
//   mp_mlp_bwd_tc  K6's VJP in bf16 (replaces _mlp_bwd_kernel,
//               mp_hsir_tpu/ops/pallas_vjp.py:124, host _mlp_bwd_call :260,
//               K9): mlp_bwd_tc_kernel below computes everything per pixel
//               in one tile, the wrapper's two grad.cu wgrad launches the
//               weight products (dW1 = dh^T LN(x), dW2 = dys^T gated) and one
//               in-order sum_parts the per-tile partials.
//   mp_mlp_bwd  the float32 VJP's per-tile half (mlp_bwd_kernel): recompute
//               LN, fc1 and the gate per 64-wide hidden chunk, dgated, dh;
//               it writes LN(x), dh, gated and dys for grad.cu
//               (ln_linear_bwd: dxn and the LN backward; the weight products)
//               and per-tile partials of db2 and d s_b. SIMT FMA.
//
// In both, d s_b = sum dy * (gated fc2 + b2) is taken as sum dy b2 + sum
// gated (dy fc2^T): one extra product per chunk. Rounding points (those of
// mlp_bwd_plain): LN(x) rounded, h = LN(x) W1 + b1 summed in float32; gated
// rounded; dys = rnd(s_b dy); dgated = dys W2 in float32, not rounded; dh =
// [dgated gelu(g) | dgated a gelu'(g)] (exact erf derivative) rounded before
// dxn and db1; dxn = dh W1 in float32 over all of 2 hid; the LN backward in
// float32 on xhat from x itself; dx (+ dy with the residual) rounded once.
//
// Bound on this card: 6*C*hidden flops per pixel forward (12*C*hidden
// backward, + 2*C*hidden with drop-path) against ~4C bytes per pixel:
// tensor-core rate.
//
// The bf16 backward tile (one 8x8 tile of 64 pixels per 512-thread block, 16
// warps; the forward tail tile's pieces from mlp_tail.cuh):
// - x and dy staged as bf16 [64][CK + 8] (cp.async; CK = C rounded up to
//   64, zero past C), LN in place (tail_ln, keeping each row's mean and
//   rstd); with drop-path dys = rnd(dy s_b) in a third tile (without it dys
//   is dy); LN(x) and dys go to global memory for the weight products, and
//   each tile's column sums of dys (db2) and of dy (d s_b's dy b2 part).
// - The weights stream from pack_mlp_weights' packs through one cp.async
//   ring (TailRingT<true>, 2-4 stages of [128][64]): per 64-unit hidden
//   chunk the fc1 slab's CK / 64 depth tiles ([slab row][channel]; row 32 q
//   + i is a-unit 16 q + i, row 32 q + 16 + i its g), then fc2's ceil(CK /
//   128) tiles ([channel][unit]), then the slab once more.
// - fc1 recomputed as the forward's tail_fc1: warp w holds rows 16 (w / 4)
//   .. + 15 and units 16 (w % 4) .. + 15 of the chunk, a and g in one thread.
// - dgated = dys W2[:, chunk] and, with drop-path, dq = dy W2[:, chunk] from
//   the fc2 tiles read transposed (ldmatrix.trans), the warps tiled so that
//   both land in a and g's thread and layout. dh in registers, rounded: to
//   global memory in the torch order, and to a bf16 [64][136] chunk in the
//   slab's row order; gated = rnd(a gelu(g)) to global memory; the d s_b
//   partial sum gated dq; db1's column sums over the warp's rows by
//   shuffles, then over the 4 row warps in order.
// - dxn += dh chunk x slab: the slab's tiles again, read transposed, one
//   64-channel group per tile; the sums stay in registers across the hidden
//   loop (tail_out's layout, up to C = 384: 48 floats a thread).
// - Epilogue in float32: x staged again (xhat from x, not from the rounded
//   LN(x)); the LN backward per pixel with its row sums across the 4 column
//   warps through shared memory; dx rounded once into x's place, then stored
//   in 16-byte runs; per-tile partials of d ln_w, d ln_b, db1 and db2 in one
//   row per tile (one in-order sum_parts finishes them) and d s_b per tile.
//   No float atomics: two calls give bitwise the same outputs.
#include "mlp_tail.cuh"

namespace mp {

// float32 (K6 on the tensor cores, 3xTF32): x staged as float32 ([64][CK +
// 4], cp.async where vec: C % 4 == 0 and x 16-byte aligned; zero past C), LN
// in place, then per output group of at most kTailMaxC channels the tail
// tile with its sums started from b2, and out = [x +] s_b branch straight
// from the registers (the residual re-read from x). w1p / w2p:
// pack_mlp_weights' layouts in float32; `stages` ring stages.
__global__ void __launch_bounds__(kThreads)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
               const float* __restrict__ lnb, const float* __restrict__ w1p,
               const float* __restrict__ b1, const float* __restrict__ w2p,
               const float* __restrict__ b2, const float* __restrict__ dp, int residual,
               float* __restrict__ out, int H, int W, int C, int hid, float eps, int vec,
               int stages) {
  extern __shared__ float4 mlp_f32_dyn[];
  const int CK = round_up64(C), ldx = CK + 4;
  float* xs = reinterpret_cast<float*>(mlp_f32_dyn);  // [64][ldx] x, LN(x) in place
  float* gs = xs + kPix * ldx;                        // [64][kTailLdF] gated chunk
  float* ring = gs + kPix * kTailLdF;                 // [stages][kTailN][kTailLdF]
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  stage_rows(xs, ldx, x, C, CK, vec, pix);
  cp_async_commit();
  const float s = dp == nullptr ? 1.f : dp[b];
  for (int n0 = 0; n0 < CK; n0 += kTailMaxC) {
    if (n0 > 0) __syncthreads();  // the last group's tiles read before their stages refill
    TailRingF rg(w1p, w2p, ring, stages, C, hid, n0);
    rg.prefetch();
    if (n0 == 0) {
      cp_async_wait_upto(stages - 1);  // the x tile has landed
      __syncthreads();
      tail_ln([&](int i, int k) { return xs[i * ldx + k]; }, xs, ldx, C, lnw, lnb, eps);
    }
    float acc[2 * kTailGroups][4];
    tail_init(acc, C - n0, [&](int, int k) { return b2[n0 + k]; });
    mlp_tail_f32(acc, xs, ldx, gs, rg, b1, hid);
    tail_out(acc, C - n0, [&](int i, int k, float v) {
      const size_t o = pix(i) * C + n0 + k;
      out[o] = residual ? x[o] + v * s : v * s;
    });
  }
}

// bf16 (K6 on the tensor cores): x staged as bf16 ([64][round_up64(C) + 8],
// cp.async, zero past C), LN in place, the tail tile, then the branch
// rounded once (times s_b) in the x tile's place and stored in 16-byte runs,
// the residual re-read from x. w1p / w2p: pack_mlp_weights' layouts. vec: C %
// 8 == 0 and x, out 16-byte aligned, else element by element.
__global__ void __launch_bounds__(kThreads)
mlp_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
              const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ w1p,
              const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2p,
              const float* __restrict__ b2, const float* __restrict__ dp, int residual,
              __nv_bfloat16* __restrict__ out, int H, int W, int C, int hid, float eps, int vec) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tail_smem[];
  const int CK = round_up64(C), ldx = CK + 8;
  bf16* xs = (bf16*)tail_smem;         // [64][ldx] x, LN(x) in place, then the branch
  bf16* gs = xs + kPix * ldx;          // [64][kTailLdg] gated chunk
  bf16* ring = gs + kPix * kTailLdg;   // [S][kTailN][kTailLd] weight tiles
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  auto row = [&](int i) { return pix(i) * C; };
  stage_rows(xs, ldx, x, C, CK, vec, pix);
  cp_async_commit();
  TailRing rg(w1p, w2p, ring, kTailStages, C, hid);
  rg.prefetch();
  cp_async_wait<kTailStages - 1>();  // the x tile has landed
  __syncthreads();
  tail_ln([&](int i, int k) { return __bfloat162float(xs[i * ldx + k]); }, xs, ldx, C, lnw, lnb,
          eps);
  float acc[2 * kTailGroups][4];
  mlp_tail_tc(acc, xs, ldx, gs, rg, b1, hid);
  const float s = dp == nullptr ? 1.f : dp[b];
  tail_out(acc, C,
           [&](int i, int k, float v) { xs[i * ldx + k] = __float2bfloat16((v + b2[k]) * s); });
  __syncthreads();
  tail_store(xs, ldx, C, vec, [&](int i) { return out + row(i); }, [&](int i, int k, float v) {
    return residual ? __bfloat162float(x[row(i) + k]) + v : v;  // rounded by the store
  });
}

constexpr int kHC = 64;  // the float32 backward's hidden chunk

// Shared memory: LN(x) and dy are staged whole where that fits (every
// natural-scene width); at C = 384 (263 KB whole) each pixel's LN mean and
// rstd stay in shared memory and both operands of the C-deep products (fc1,
// dy fc2^T) stream in channel chunks of kc (117 KB), re-read per hidden chunk.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ lnw,
               const float* __restrict__ lnb, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ dp,
               T* __restrict__ xn_out, T* __restrict__ dh_out, T* __restrict__ gated_out,
               T* __restrict__ dys_out, float* __restrict__ pb2, float* __restrict__ pdp, int H,
               int W, int C, int hid, float eps, int kc) {
  extern __shared__ float sm[];
  __shared__ float red[kThreads / 32];
  const int ldc = kc + 1, ldh = 2 * kHC + 1, ldg = kHC + 1;
  constexpr bool resident = !kStream;  // kc = C
  float* xs = sm;                // [64][ldc] LN(x), rounded: whole or a chunk
  float* ds = xs + kPix * ldc;   // [64][ldc] dy: whole or a chunk
  float* hs = ds + kPix * ldc;   // [64][ldh] a | g of one chunk (float32)
  float* gs = hs + kPix * ldh;   // [64][ldg] gated (rounded)
  float* dg = gs + kPix * ldg;   // [64][ldg] dgated
  float* dq = dg + kPix * ldg;   // streamed: [64][ldg] dy fc2^T (the d s_b product)
  float* mu = dq + kPix * ldg;   // streamed: [64] LN mean, then [64] rstd
  float* rs = mu + kPix;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const float s = dp == nullptr ? 1.f : dp[b];
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  auto xat = [&](int i, int k) { return to_f(x[pix(i) * C + k]); };
  auto dyat = [&](int i, int k) { return to_f(dy[pix(i) * C + k]); };
  auto all = [](int) { return true; };

  if (resident) {
    for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
      const int i = idx / C, k = idx - i * C;
      xs[i * ldc + k] = xat(i, k);
      ds[i * ldc + k] = dyat(i, k);
    }
    __syncthreads();
    ln_rows_inplace<T>(xs, ldc, kPix, C, lnw, lnb, eps, all);
  } else {
    ln_stats_rows(mu, rs, kPix, C, eps, xat, all);
  }
  float part = 0.f;  // this thread's share of d s_b
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float sb = 0.f, db = 0.f;
    for (int i = 0; i < kPix; ++i) {
      const float d0 = resident ? ds[i * ldc + k] : dyat(i, k);
      const float d = rnd<T>(d0 * s);
      dys_out[pix(i) * C + k] = from_f<T>(d);
      db += d;
      sb += d0;
    }
    pb2[(size_t)tile * C + k] = db;
    part = fmaf(sb, b2[k], part);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    const float v = resident ? xs[i * ldc + k]
                             : rnd<T>((xat(i, k) - mu[i]) * rs[i] * lnw[k] + lnb[k]);
    xn_out[pix(i) * C + k] = from_f<T>(v);
  }
  for (int j0 = 0; j0 < hid; j0 += kHC) {
    const int hc = min(kHC, hid - j0);
    auto col1 = [&](int j) { return j < hc ? j0 + j : hid + j0 + (j - hc); };
    for (int c0 = 0; c0 < C; c0 += kc) {  // [a | g] = LN(x) fc1 + b1
      const int nc = min(kc, C - c0);
      if (!resident) {
        load_chunk<T>(xs, ldc, kPix, c0, nc, xat, all, mu, rs, lnw, lnb);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kPix, 2 * hc, nc,
          [&](int i, int k) { return xs[i * ldc + k]; },
          [&](int k, int j) { return to_f(w1[(size_t)(c0 + k) * 2 * hid + col1(j)]); },
          [&](int i, int j, float acc) {
            chunk_acc(hs[i * ldh + (j < hc ? j : kHC + j - hc)], acc, first, last,
                      [&](float v) { return v + b1[col1(j)]; });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * hc; idx += blockDim.x) {
      const int p = idx / hc, j = idx - p * hc;
      const float gv = rnd<T>(hs[p * ldh + j] * gelu_erf(hs[p * ldh + kHC + j]));
      gs[p * ldg + j] = gv;
      gated_out[pix(p) * hid + j0 + j] = from_f<T>(gv);
    }
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += kc) {  // dy fc2^T, and dgated = dys fc2^T
      const int nc = min(kc, C - c0);
      if (!resident) {
        load_chunk<T>(ds, ldc, kPix, c0, nc, dyat, all, nullptr, nullptr, nullptr, nullptr);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      if (dp != nullptr) {
        gemm<T>(kPix, hc, nc,
            [&](int i, int k) { return ds[i * ldc + k]; },
            [&](int k, int j) { return to_f(w2[(size_t)(j0 + j) * C + c0 + k]); },
            [&](int i, int j, float acc) {
              auto use = [&](float v) { part = fmaf(gs[i * ldg + j], v, part); return v; };
              if (resident) use(acc);
              else chunk_acc(dq[i * ldg + j], acc, first, last, use);
            });
      }
      gemm<T>(kPix, hc, nc,
          [&](int i, int k) { return rnd<T>(ds[i * ldc + k] * s); },
          [&](int k, int j) { return to_f(w2[(size_t)(j0 + j) * C + c0 + k]); },
          [&](int i, int j, float acc) {
            chunk_acc(dg[i * ldg + j], acc, first, last, [](float v) { return v; });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * 2 * hc; idx += blockDim.x) {
      const int p = idx / (2 * hc), jj = idx - p * 2 * hc;
      const int j = jj < hc ? jj : jj - hc;
      const float a = hs[p * ldh + j], g = hs[p * ldh + kHC + j], d = dg[p * ldg + j];
      const float v = jj < hc ? d * gelu_erf(g) : d * a * dgelu_erf(g);
      dh_out[pix(p) * 2 * hid + col1(jj)] = from_f<T>(v);
    }
    __syncthreads();
  }
  if (dp != nullptr) {
    part = block_sum(part, red);
    if (threadIdx.x == 0) pdp[tile] = part;
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward tile (K9 on the tensor cores; the design is at the top
// of this file).
// ---------------------------------------------------------------------------

constexpr int kBwdLdh = 2 * kTailK + 8;  // dh chunk row: the slab's 128 columns (272 B)
// the dynamic bytes a plan may take: the H100's opt-in limit less the static
constexpr size_t kBwdBudget = 232448 - 1024;

// The tile's plan at width C: three [64][CK + 8] bf16 tiles (x, then LN(x) |
// dys | dy) | the dh chunk [64][kBwdLdh] bf16 | the LN mean and rstd [2][64]
// float32 | db1's column sums [4][128] float32 | the ring (ws stages of
// [kTailN][kTailLd], as many as the budget holds, at most 4); every piece a
// multiple of 16 bytes. After the hidden loop the ring's space holds the
// epilogue's row and column sums (14 KB at most, within 2 stages).
struct MlpBwdPlan {
  int CK, ld, ws;
  size_t tile, dh, bytes;
  __host__ __device__ MlpBwdPlan(int C) {
    CK = round_up64(C);
    ld = CK + 8;
    tile = sizeof(__nv_bfloat16) * kPix * ld;
    dh = sizeof(__nv_bfloat16) * kPix * kBwdLdh;
    const size_t fixed = 3 * tile + dh + sizeof(float) * (2 * kPix + 4 * 2 * kTailK);
    for (ws = kTailStages; ws > 2 && fixed + ws * kTailStage > kBwdBudget; --ws) {
    }
    bytes = fixed + ws * kTailStage;
  }
};

// p[0] = v0 and, where ok1, p[1] = v1 (bf16); one 4-byte store where both
// are stored and pair (p 4-byte aligned).
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float v0, float v1, bool ok1,
                                             bool pair) {
  if (pair && ok1) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (ok1) p[1] = __float2bfloat16(v1);
  }
}

// Arguments: x, dy (B, H, W, C) bf16; LN,
// b1, b2 float32; w1p / w2p pack_mlp_weights' packs; dp (B,) or NULL.
// Outputs: xn, dys (B, H, W, C) (dys only with dp: without it dys is dy),
// dh (B, H, W, 2 hid) in the torch order (a-units, then g-units), gated (B,
// H, W, hid), dx (B, H, W, C); part [tiles][3 C + 2 hid] float32 = per tile
// (d ln_w | d ln_b | db1 | db2); pdp [tiles] (d s_b per tile, with dp).
__global__ void __launch_bounds__(kThreads)
mlp_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  const float* __restrict__ lnw, const float* __restrict__ lnb,
                  const __nv_bfloat16* __restrict__ w1p, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2p, const float* __restrict__ b2,
                  const float* __restrict__ dp, int residual, __nv_bfloat16* __restrict__ xn_out,
                  __nv_bfloat16* __restrict__ dh_out, __nv_bfloat16* __restrict__ gated_out,
                  __nv_bfloat16* __restrict__ dys_out, __nv_bfloat16* __restrict__ dx_out,
                  float* __restrict__ part, float* __restrict__ pdp, int H, int W, int C, int hid,
                  float eps, int vec) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 mlp_bwd_dyn[];
  __shared__ float red[kThreads / 32];
  const MlpBwdPlan pl(C);
  const int CK = pl.CK, ld = pl.ld, groups = CK / 64;
  char* sm = reinterpret_cast<char*>(mlp_bwd_dyn);
  bf16* xs = reinterpret_cast<bf16*>(sm);                 // x, LN(x) in place; x again, then dx
  bf16* ds = reinterpret_cast<bf16*>(sm + pl.tile);       // dys
  bf16* dr = reinterpret_cast<bf16*>(sm + 2 * pl.tile);   // dy (with dp)
  bf16* hs = reinterpret_cast<bf16*>(sm + 3 * pl.tile);   // the dh chunk, slab column order
  float* st = reinterpret_cast<float*>(sm + 3 * pl.tile + pl.dh);  // LN mean | rstd
  float* cs = st + 2 * kPix;                               // [4 wr][128] db1 column sums
  bf16* ring = reinterpret_cast<bf16*>(cs + 4 * 2 * kTailK);
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int r0 = 16 * wr + (lane >> 2), r1 = r0 + 8;
  const bool has_dp = dp != nullptr, pair = (hid & 1) == 0;
  const float s = has_dp ? dp[b] : 1.f;
  bf16* dyt = has_dp ? dr : ds;  // dy (without dp dys = rnd(dy * 1) is dy itself)
  float* prow = part + (size_t)tile * (3 * C + 2 * hid);
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  auto same = [](int, int, float v) { return v; };

  // x and dy staged as bf16; the weight stream's first tiles; LN in place
  stage_rows(xs, ld, x, C, CK, vec, pix);
  stage_rows(dyt, ld, dy, C, CK, vec, pix);
  cp_async_commit();
  TailRingT<true> rg(w1p, w2p, ring, pl.ws, C, hid);
  rg.prefetch();
  cp_async_wait_upto(pl.ws - 1);  // x and dy have landed
  __syncthreads();
  tail_ln([&](int i, int k) { return __bfloat162float(xs[i * ld + k]); }, xs, ld, C, lnw, lnb, eps,
          st);
  if (has_dp)
    for (int u = threadIdx.x; u < kPix * CK; u += blockDim.x) {
      const int i = u / CK, k = u - i * CK;
      ds[i * ld + k] = __float2bfloat16(__bfloat162float(dr[i * ld + k]) * s);
    }
  __syncthreads();
  tail_store(xs, ld, C, vec, [&](int i) { return xn_out + pix(i) * C; }, same);
  if (has_dp) tail_store(ds, ld, C, vec, [&](int i) { return dys_out + pix(i) * C; }, same);
  float dsb = 0.f;  // this thread's share of d s_b: sum dy b2 + sum gated (dy fc2^T)
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float db = 0.f, sb = 0.f;
    for (int i = 0; i < kPix; ++i) {
      db += __bfloat162float(ds[i * ld + k]);
      sb += __bfloat162float(dyt[i * ld + k]);
    }
    prow[2 * C + 2 * hid + k] = db;
    dsb = fmaf(sb, b2[k], dsb);
  }

  // A operands: lane gives row lane % 16 of the warp's 16 at k offset 8
  // (lane / 16). B: boff in a [n][k] tile (fc1, as mlp_tail_tc); toff in a
  // [k][n] tile read transposed (ldmatrix.trans: lane gives k row lane % 8 +
  // 8 (lane / 8 % 2) at n column 16 wc + 8 (lane / 16)): the fc2 tiles
  // ([channel][unit]) for dgated and dq, the slab tiles ([slab row][channel])
  // for dxn.
  const int arow = 16 * wr + (lane & 15), acol = 8 * (lane >> 4);
  const uint32_t ax = smem_u32(xs + arow * ld + acol), ad = smem_u32(ds + arow * ld + acol);
  const uint32_t ar = smem_u32(dr + arow * ld + acol);
  const uint32_t ah = smem_u32(hs + arow * kBwdLdh + acol);
  const int boff = ((lane & 7) + 8 * (lane >> 4)) * kTailLd + 8 * ((lane >> 3) & 1);
  const int toff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kTailLd + 16 * wc + 8 * (lane >> 4);
  float acc[2 * kTailGroups][4];  // dxn: acc[2 G + h][e] as tail_out's layout
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  for (int j = 0; j < rg.hidP / kTailK; ++j) {
    // fc1 recomputed: h[nt] a, h[nt + 2] g of units 16 wc + 8 nt + 2 t4 (+1)
    float h[4][4];
    tail_fc1(h, ax, rg, wc, boff);
    // dgated = dys fc2^T and dq = dy fc2^T (with dp), in h's layout
    float dg[2][4], dq[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dg[nt][e] = dq[nt][e] = 0.f;
    for (int i = 0; i < rg.nk2; ++i) {
      const uint32_t bt = smem_u32(rg.consume() + toff);
      const int depth = min(kTailN, CK - i * kTailN);
#pragma unroll
      for (int kk = 0; kk < kTailN / 16; ++kk) {
        if (16 * kk >= depth) break;  // block-uniform
        uint32_t af[4], bf[4];
        ldmatrix_x4_trans(bf, bt + 2 * 16 * kk * kTailLd);
        ldmatrix_x4(af, ad + 2 * (i * kTailN + 16 * kk));
        mma_16x8x16(dg[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_16x8x16(dg[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
        if (has_dp) {
          ldmatrix_x4(af, ar + 2 * (i * kTailN + 16 * kk));
          mma_16x8x16(dq[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(dq[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
    }
    // dh = [dgated gelu(g) | dgated a gelu'(g)], rounded: to global memory in
    // the torch order, to the dh chunk in the slab's order (a-unit 16 q + i
    // at column 32 q + i, its g at 32 q + 16 + i); gated = rnd(a gelu(g)) to
    // global memory; db1's sums over the warp's 16 rows to cs
    float csum[2][2][2];  // [nt][a | g][unit +0 | +1]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 16 * wc + 8 * nt + 2 * t4, u = j * kTailK + col;
      const bool ok0 = u < hid, ok1 = u + 1 < hid;
      const float ba[2] = {ok0 ? b1[u] : 0.f, ok1 ? b1[u + 1] : 0.f};
      const float bg[2] = {ok0 ? b1[hid + u] : 0.f, ok1 ? b1[hid + u + 1] : 0.f};
      float da[4], dd[4], gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = h[nt][e] + ba[e & 1], g = h[nt + 2][e] + bg[e & 1];
        const float gl = gelu_erf(g), d = dg[nt][e];
        gv[e] = rnd<bf16>(a * gl);
        da[e] = rnd<bf16>(d * gl);
        dd[e] = rnd<bf16>(d * a * dgelu_erf(g));
        dsb = fmaf(gv[e], dq[nt][e], dsb);
      }
      const int sc = 32 * wc + 8 * nt + 2 * t4;
      *reinterpret_cast<uint32_t*>(hs + r0 * kBwdLdh + sc) = pack_bf16x2(da[0], da[1]);
      *reinterpret_cast<uint32_t*>(hs + r1 * kBwdLdh + sc) = pack_bf16x2(da[2], da[3]);
      *reinterpret_cast<uint32_t*>(hs + r0 * kBwdLdh + sc + 16) = pack_bf16x2(dd[0], dd[1]);
      *reinterpret_cast<uint32_t*>(hs + r1 * kBwdLdh + sc + 16) = pack_bf16x2(dd[2], dd[3]);
      if (ok0) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const size_t p = pix(rr ? r1 : r0);
          store_bf16x2(gated_out + p * hid + u, gv[2 * rr], gv[2 * rr + 1], ok1, pair);
          store_bf16x2(dh_out + p * 2 * hid + u, da[2 * rr], da[2 * rr + 1], ok1, true);
          store_bf16x2(dh_out + p * 2 * hid + hid + u, dd[2 * rr], dd[2 * rr + 1], ok1, pair);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        csum[nt][0][e] = da[e] + da[2 + e];
        csum[nt][1][e] = dd[e] + dd[2 + e];
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float& v = csum[q >> 2][(q >> 1) & 1][q & 1];
        v += __shfl_xor_sync(0xffffffffu, v, o);
      }
    if (lane < 4)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        cs[wr * 2 * kTailK + 32 * wc + 16 * ((q >> 1) & 1) + 8 * (q >> 2) + 2 * t4 + (q & 1)] =
            csum[q >> 2][(q >> 1) & 1][q & 1];
    // dxn += dh chunk x the slab (re-streamed), one 64-channel group per
    // tile; the first tile's barrier makes the dh chunk and cs visible
    for (int kt = 0; kt < rg.nk1; ++kt) {
      const uint32_t bt = smem_u32(rg.consume() + toff);
      if (kt == 0 && threadIdx.x < 2 * kTailK) {  // db1: this chunk's units, sums in order
        const int c = threadIdx.x, q = c >> 5, i = c & 31;
        const int unit = j * kTailK + 16 * q + (i & 15);
        if (unit < hid)
          prow[2 * C + (i < 16 ? unit : hid + unit)] =
              cs[c] + cs[2 * kTailK + c] + cs[4 * kTailK + c] + cs[6 * kTailK + c];
      }
#pragma unroll
      for (int kk = 0; kk < 2 * kTailK / 16; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, ah + 2 * 16 * kk);
        ldmatrix_x4_trans(bf, bt + 2 * 16 * kk * kTailLd);
#pragma unroll
        for (int G = 0; G < kTailGroups; ++G) {
          if (G == kt) {  // block-uniform
            mma_16x8x16(acc[2 * G], af[0], af[1], af[2], af[3], bf[0], bf[1]);
            mma_16x8x16(acc[2 * G + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // x again, for xhat from the input itself: the last reader of LN(x) (the
  // last fc1 tile) came before the last dxn tile's barrier
  stage_rows(xs, ld, x, C, CK, vec, pix);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // and every thread is past the hidden loop: the ring is free
  float* rowred = reinterpret_cast<float*>(ring);  // [4 wc][64][2] row sums
  float* colred = rowred + 4 * kPix * 2;           // [4 wr][2][CK] column sums
  const float* mu = st;
  const float* rs = st + kPix;
  // LayerNorm backward: per row m1 = sum g, m2 = sum g xhat with g = dxn
  // ln_w; per channel sum dxn xhat and sum dxn (d ln_w, d ln_b)
  float m[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q) {
    if ((q >> 1) >= groups) break;  // block-uniform
    const int col = 64 * (q >> 1) + 16 * wc + 8 * (q & 1) + 2 * t4;
    float cw[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r1, k = col + (e & 1);
      if (k < C) {
        const float xh = (__bfloat162float(xs[i * ld + k]) - mu[i]) * rs[i], d = acc[q][e];
        const float g = d * lnw[k];
        m[e >> 1][0] += g;
        m[e >> 1][1] = fmaf(g, xh, m[e >> 1][1]);
        cw[e & 1] = fmaf(d, xh, cw[e & 1]);
        cb[e & 1] += d;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cw[e] += __shfl_xor_sync(0xffffffffu, cw[e], o);
        cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], o);
      }
    if (lane < 4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        colred[(wr * 2) * CK + col + e] = cw[e];
        colred[(wr * 2 + 1) * CK + col + e] = cb[e];
      }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q >> 1][q & 1] += __shfl_xor_sync(0xffffffffu, m[q >> 1][q & 1], o);
  if (t4 == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) rowred[(wc * kPix + (q < 2 ? r0 : r1)) * 2 + (q & 1)] = m[q >> 1][q & 1];
  __syncthreads();
  float m1[2], m2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = rr ? r1 : r0;
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < 4; ++w) {
      s1 += rowred[(w * kPix + i) * 2];
      s2 += rowred[(w * kPix + i) * 2 + 1];
    }
    m1[rr] = s1 / C;
    m2[rr] = s2 / C;
  }
  // dx = (g - m1 - xhat m2) rstd (+ dy), rounded once, into x's place (each
  // element read and written by its own thread only)
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q) {
    if ((q >> 1) >= groups) break;
    const int col = 64 * (q >> 1) + 16 * wc + 8 * (q & 1) + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r0 : r1, k = col + (e & 1);
      if (k < C) {
        const float xh = (__bfloat162float(xs[i * ld + k]) - mu[i]) * rs[i];
        float v = (acc[q][e] * lnw[k] - m1[e >> 1] - xh * m2[e >> 1]) * rs[i];
        if (residual) v += __bfloat162float(dyt[i * ld + k]);
        xs[i * ld + k] = __float2bfloat16(v);
      }
    }
  }
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int w = 0; w < 4; ++w) {
      sw += colred[(w * 2) * CK + k];
      sb += colred[(w * 2 + 1) * CK + k];
    }
    prow[k] = sw;
    prow[C + k] = sb;
  }
  __syncthreads();
  tail_store(xs, ld, C, vec, [&](int i) { return dx_out + pix(i) * C; }, same);
  if (has_dp) {
    dsb = block_sum(dsb, red);
    if (threadIdx.x == 0) pdp[tile] = dsb;
  }
}

// float32: the x tile, the gated chunk and tail_f32_stages(C) ring stages
inline size_t mlp_f32_smem(int C) { return tail_f32_bytes(C, tail_f32_stages(C)); }

// bf16: the x tile, the gated chunk and a kTailStages-deep ring
inline size_t mlp_tc_smem(int C) { return tail_scratch_bytes(C, kTailStages); }

// The backward instance of a chunk: resident (LN(x) and dy whole) where kc
// covers C, a kernel of its own as the natural-scene widths' plan.
template <typename T>
inline auto mlp_bwd_kernel_for(int kc, int C) {
  return kc >= C ? mlp_bwd_kernel<T, false> : mlp_bwd_kernel<T, true>;
}

// kc = C: LN(x) and dy whole; kc < C: their chunks, the d s_b product's
// chunk sums and the LN statistics.
inline size_t mlp_bwd_smem(int C, int kc) {
  const size_t whole = (size_t)2 * kPix * (kc + 1) + (size_t)kPix * (2 * kHC + 1) +
                       (size_t)2 * kPix * (kHC + 1);
  return sizeof(float) * (kc >= C ? whole : whole + (size_t)kPix * (kHC + 1) + 2 * kPix);
}

inline int mlp_bwd_chunk(int C) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(mlp_bwd_kernel_for<float>(kc, C), mlp_bwd_smem(C, kc));
  });
}

template <typename T>
cudaError_t launch_mlp(const void* x, const float* lnw, const float* lnb, const void* w1,
                       const float* b1, const void* w2, const float* b2, const float* dp,
                       int residual, void* out, int B, int H, int W, int C, int hid, float eps,
                       cudaStream_t stream) {
  const dim3 grid(W / kTile, H / kTile, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (C > kTailMaxC) return cudaErrorInvalidValue;
    const size_t smem = mlp_tc_smem(C);
    cudaError_t err = set_smem(mlp_tc_kernel, smem);
    if (err != cudaSuccess) return err;
    const int vec = C % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
    mlp_tc_kernel<<<grid, kThreads, smem, stream>>>(
        (const T*)x, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, dp, residual, (T*)out, H, W,
        C, hid, eps, vec);
  } else {
    if (!aligned(w1, 16) || !aligned(w2, 16)) return cudaErrorInvalidValue;
    const size_t smem = mlp_f32_smem(C);
    cudaError_t err = set_smem(mlp_f32_kernel, smem);
    if (err != cudaSuccess) return err;
    const int vec = C % 4 == 0 && aligned(x, 16);
    mlp_f32_kernel<<<grid, kThreads, smem, stream>>>(
        (const float*)x, lnw, lnb, (const float*)w1, b1, (const float*)w2, b2, dp, residual,
        (float*)out, H, W, C, hid, eps, vec, tail_f32_stages(C));
  }
  return cudaGetLastError();
}

// The float32 backward (the bf16 compute type runs launch_mlp_bwd_tc).
cudaError_t launch_mlp_bwd(const float* x, const float* dy, const float* lnw, const float* lnb,
                           const float* w1, const float* b1, const float* w2, const float* b2,
                           const float* dp, float* xn, float* dh, float* gated, float* dys,
                           float* pb2, float* pdp, int B, int H, int W, int C, int hid, int kc,
                           float eps, cudaStream_t stream) {
  const size_t smem = mlp_bwd_smem(C, kc);
  const auto kernel = mlp_bwd_kernel_for<float>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, dy, lnw, lnb, w1, b1, w2, b2, dp, xn, dh, gated, dys, pb2, pdp, H, W, C, hid, eps, kc);
  return cudaGetLastError();
}

// The bf16 tile: C up to kTailMaxC; w1p and w2p 16-byte aligned.
cudaError_t launch_mlp_bwd_tc(const __nv_bfloat16* x, const __nv_bfloat16* dy, const float* lnw,
                              const float* lnb, const __nv_bfloat16* w1p, const float* b1,
                              const __nv_bfloat16* w2p, const float* b2, const float* dp,
                              int residual, __nv_bfloat16* xn, __nv_bfloat16* dh,
                              __nv_bfloat16* gated, __nv_bfloat16* dys, __nv_bfloat16* dx,
                              float* part, float* pdp, int B, int H, int W, int C, int hid,
                              float eps, cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(w1p, 16) || !aligned(w2p, 16)) return cudaErrorInvalidValue;
  const size_t smem = MlpBwdPlan(C).bytes;
  const int vec = C % 8 == 0 && aligned(x, 16) && aligned(dy, 16) && aligned(xn, 16) &&
                  aligned(dx, 16) && (dp == nullptr || aligned(dys, 16));
  cudaError_t err = set_smem(mlp_bwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  mlp_bwd_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, dy, lnw, lnb, w1p, b1, w2p, b2, dp, residual, xn, dh, gated, dys, dx, part, pdp, H, W, C,
      hid, eps, vec);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, C); LN, b1, b2 float32; dp (B,) float32 drop-path scales or
// NULL. Weights: pack_mlp_weights' w1p [hidP/64][128][CK], w2p [CK][hidP]
// in the compute type (16-byte aligned; bf16 takes C up to 384).
// out (B, H, W, C).
extern "C" int mp_mlp(const void* x, const void* lnw, const void* lnb, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* dp, void* out,
                      int dtype, int B, int H, int W, int C, int hid, int residual, float eps,
                      void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_mlp<float>(x, f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(dp), residual,
                                      out, B, H, W, C, hid, eps, st);
  return (int)mp::launch_mlp<__nv_bfloat16>(x, f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(dp),
                                            residual, out, B, H, W, C, hid, eps, st);
}

// The per-tile half of the float32 MLP backward (bf16 runs mp_mlp_bwd_tc).
// Outputs: xn (B, H, W, C) LN(x), dh (B, H, W, 2*hid), gated
// (B, H, W, hid), dys (B, H, W, C); pb2 (tiles, C) and pdp (tiles,) float32
// partials (pdp only with dp). kc: the channel chunk (mp_mlp_bwd_chunk).
extern "C" int mp_mlp_bwd(const void* x, const void* dy, const void* lnw, const void* lnb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* dp, void* xn, void* dh, void* gated, void* dys, void* pb2,
                          void* pdp, int B, int H, int W, int C, int hid, int kc, float eps,
                          void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_mlp_bwd(f(x), f(dy), f(lnw), f(lnb), f(w1), f(b1), f(w2), f(b2), f(dp),
                                 (float*)xn, (float*)dh, (float*)gated, (float*)dys, (float*)pb2,
                                 (float*)pdp, B, H, W, C, hid, kc, eps, (cudaStream_t)stream);
}

// The bf16 MLP backward tile (C <= 384): x, dy (B, H, W, C) bf16; LN, b1, b2
// float32; w1p / w2p pack_mlp_weights' packs; dp (B,) float32 or NULL.
// Outputs: xn, dx (B, H, W, C), dys (B, H, W, C) only with dp, dh (B, H, W,
// 2*hid), gated (B, H, W, hid), all bf16; part (tiles, 3 C + 2 hid) float32
// per-tile (d ln_w | d ln_b | db1 | db2); pdp (tiles,) d s_b per tile (with dp).
extern "C" int mp_mlp_bwd_tc(const void* x, const void* dy, const void* lnw, const void* lnb,
                             const void* w1p, const void* b1, const void* w2p, const void* b2,
                             const void* dp, void* xn, void* dh, void* gated, void* dys, void* dx,
                             void* part, void* pdp, int B, int H, int W, int C, int hid,
                             int residual, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  auto f = [](const void* p) { return (const float*)p; };
  auto h = [](const void* p) { return (const bf16*)p; };
  return (int)mp::launch_mlp_bwd_tc(h(x), h(dy), f(lnw), f(lnb), h(w1p), f(b1), h(w2p), f(b2),
                                    f(dp), residual, (bf16*)xn, (bf16*)dh, (bf16*)gated,
                                    (bf16*)dys, (bf16*)dx, (float*)part, (float*)pdp, B, H, W, C,
                                    hid, eps, (cudaStream_t)stream);
}

// The channel chunk the float32 backward kernel launches with at C.
extern "C" int mp_mlp_bwd_chunk(int C) { return mp::mlp_bwd_chunk(C); }

// Shared-memory plans per block (bytes, static included): the forward's in
// the compute type (dtype 0 float32, 1 bf16; -1: bf16 past C = 384), the
// float32 backward's at channel chunk kc, the bf16 backward tile's
// (MlpBwdPlan; -1 past C = 384).
extern "C" long long mp_mlp_smem(int C, int dtype) {
  if (dtype == 0) return mp::plan_bytes(mp::mlp_f32_kernel, mp::mlp_f32_smem(C));
  return C > mp::kTailMaxC ? -1 : mp::plan_bytes(mp::mlp_tc_kernel, mp::mlp_tc_smem(C));
}

extern "C" long long mp_mlp_bwd_smem(int C, int kc) {
  return mp::plan_bytes(mp::mlp_bwd_kernel_for<float>(kc, C), mp::mlp_bwd_smem(C, kc));
}

extern "C" long long mp_mlp_bwd_tc_smem(int C) {
  return C > mp::kTailMaxC ? -1
                           : mp::plan_bytes(mp::mlp_bwd_tc_kernel, mp::MlpBwdPlan(C).bytes);
}
