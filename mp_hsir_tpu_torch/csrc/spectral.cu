// Spectral (C x C transposed, MDTA) attention over an NHWC map, in two
// launches around a small fold done in PyTorch:
//
//   mp_spectral_stats  q, k = dw3x3(1x1([LN] x)); per-head Gram q^T k and the
//                      squared norms of q and k, summed over all pixels
//                      (bf16: the tensor-core tile of spectral_stats.cuh;
//                      float32: the 3xTF32 tile of spectral_stats_f32.cuh).
//   (fold, PyTorch)    comb = softmax(Gram / (|q| |k|) * temp) folded with the
//                      output projection into one C x C matrix.
//   mp_spectral_apply  v = dw3x3(1x1([LN] x)); out = v @ comb plus the
//                      epilogue: [x * gate] [+ x] [+ shortcut], then optionally
//                      the PGSSTB tail out + fc2(a * gelu(g)), [a|g] = fc1(LN2(out))
//                      (bf16: the tensor-core tile of spectral_front.cuh with
//                      the tail tile of mlp_tail.cuh after it; float32:
//                      spectral_apply_kernel below, SIMT FMA, with the 3xTF32
//                      tail tile of mlp_tail.cuh, mlp_tail_f32).
//
// Replaces _spectral_kernel (mp_hsir_tpu/ops/pallas_attention.py:1429, K2: the
// stats launch is its phase 0, the apply launch its phase 1) and the spectral
// half of _nhwc_sp0_kernel (:362, K3). The TPU grid carries the Gram sums from
// step to step in scratch; Hopper blocks run in no order, so each block writes
// its partial sums over a fixed range of tiles and a second small kernel adds
// the partials in a fixed order: the result is deterministic, with no float
// atomics. `shift` > 0: the input is the rolled-frame window-attention output
// of a shifted block; both launches read it through the (+shift, +shift)
// roll-back (the unrolled frame, where the dwconv zero padding lives) and the
// apply launch indexes the per-window gate through the roll.
//
// Bound on this card: 4C^2 + 6C*hidden flops per pixel in the apply launch and
// 4C^2 + 2C*dh in the stats launch against ~4C bytes per pixel: tensor-core
// rate bounds both at these widths. bf16 products run as mma.sync on the
// tensor cores, float32 ones as SIMT FMA (common.cuh gemm; PERF.md) but for
// the apply launch's PGSSTB tail and the stats launch, 3xTF32 mma.sync
// (mlp_tail.cuh, spectral_stats_f32.cuh); the bf16 stats and apply launches
// run their own tiles (spectral_stats.cuh, spectral_front.cuh). The bf16
// stats backward runs two tensor-core tiles: spectral_stats_bwd_tc_kernel
// (spectral_stats.cuh) and dwconv_dx_tc_kernel (dwconv_dx.cuh); the float32
// one spectral_stats_bwd_kernel below and grad.cu's dwconv_bwd and
// ln_linear_bwd. So does the bf16 apply backward:
// spectral_apply_bwd_tc_kernel (spectral_apply_bwd.cuh) and
// dwconv_dx_tc_kernel<true, true>; the float32 one spectral_apply_bwd_kernel
// below and grad.cu's stages.
#include "dwconv_dx.cuh"
#include "spectral_apply_bwd.cuh"
#include "spectral_stats_f32.cuh"

namespace mp {

// Loads the 10x10 halo of tile (ty, tx) of the logical input cat(x1, x2) in the
// unrolled frame into s ([kHaloPix][ld]), zero outside the image, then applies
// the optional LayerNorm (zero rows stay zero, as in the JAX kernels, which
// mask after normalising).
template <typename T>
__device__ __forceinline__ void load_halo(float* s, int ld, const T* __restrict__ x1,
                                          const T* __restrict__ x2, int C1, int C2, int b,
                                          int ty, int tx, int H, int W, int shift,
                                          const float* lnw, const float* lnb, float eps) {
  const int C = C1 + C2;
  for (int idx = threadIdx.x; idx < kHaloPix * C; idx += blockDim.x) {
    const int p = idx / C, k = idx - p * C;
    const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
    float v = 0.f;
    if (ur >= 0 && ur < H && uc >= 0 && uc < W) {
      const int sr = (ur - shift + H) % H, sc = (uc - shift + W) % W;
      const size_t pix = ((size_t)b * H + sr) * W + sc;
      v = k < C1 ? to_f(x1[pix * C1 + k]) : to_f(x2[pix * C2 + (k - C1)]);
    }
    s[p * ld + k] = v;
  }
  if (lnw != nullptr) {
    __syncthreads();
    ln_rows_inplace<T>(s, ld, kHaloPix, C, lnw, lnb, eps, [&](int p) {
      const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
      return ur >= 0 && ur < H && uc >= 0 && uc < W;
    });
  }
}

// The logical input cat(x1, x2) of tile (ty, tx)'s 10x10 halo in the unrolled
// frame: at(p, k) is channel k of halo pixel p, inside(p) whether it lies in
// the image (outside, the halo is zero after the optional LayerNorm).
template <typename T>
struct Halo {
  const T* x1;
  const T* x2;
  int C1, C2, b, ty, tx, H, W, shift;
  __device__ __forceinline__ bool inside(int p) const {
    const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
    return ur >= 0 && ur < H && uc >= 0 && uc < W;
  }
  __device__ __forceinline__ float at(int p, int k) const {
    const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
    const int sr = (ur - shift + H) % H, sc = (uc - shift + W) % W;
    const size_t pix = ((size_t)b * H + sr) * W + sc;
    return k < C1 ? to_f(x1[pix * C1 + k]) : to_f(x2[pix * C2 + (k - C1)]);
  }
};

// Stages the halo's channels [c0, c0 + nc) into s ([kHaloPix][ld]), with the
// LayerNorm from (mu, rs) when lnw != nullptr; mu / rs come from halo_stats.
template <typename T>
__device__ __forceinline__ void halo_chunk(float* s, int ld, const Halo<T>& hl, int c0, int nc,
                                           const float* mu, const float* rs,
                                           const float* lnw, const float* lnb) {
  load_chunk<T>(s, ld, kHaloPix, c0, nc, [&](int p, int k) { return hl.at(p, k); },
                [&](int p) { return hl.inside(p); }, mu, rs, lnw, lnb);
}

template <typename T>
__device__ __forceinline__ void halo_stats(float* mu, float* rs, const Halo<T>& hl, float eps) {
  ln_stats_rows(mu, rs, kHaloPix, hl.C1 + hl.C2, eps, [&](int p, int k) { return hl.at(p, k); },
                [&](int p) { return hl.inside(p); });
}

// out[b][i] = sum over parts (in order) of part[b][part][i]
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int n_parts, int n) {
  const int b = blockIdx.y;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += part[((size_t)b * n_parts + p) * n + i];
    out[(size_t)b * n + i] = s;
  }
}

// The stats kernels' second pass: part [B][n_parts][C dh + 2C] summed over the
// parts in order into gram [B][C dh], nq [B][C] and nk [B][C].
__global__ void sum_stats_kernel(const float* __restrict__ part, float* __restrict__ gram,
                                 float* __restrict__ nq, float* __restrict__ nk, int n_parts,
                                 int n, int C) {
  const int b = blockIdx.y, m = n + 2 * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += part[((size_t)b * n_parts + p) * m + i];
    if (i < n) gram[(size_t)b * n + i] = s;
    else if (i < n + C) nq[(size_t)b * C + i - n] = s;
    else nk[(size_t)b * C + i - n - C] = s;
  }
}

int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return v;
}

cudaError_t launch_sum_parts(const float* part, float* out, int nb, int n_parts, int n,
                             cudaStream_t stream) {
  const int blocks = min(ceil_div(n, kThreads), 1024);
  sum_parts_kernel<<<dim3(blocks, nb), kThreads, 0, stream>>>(part, out, n_parts, n);
  return cudaGetLastError();
}

constexpr int kVC = 32;   // v channel chunk when the input is resident
constexpr int kVCw = 128; // v channel chunk when it is streamed (fewer re-reads)

// The float32 apply kernel's plan (and the apply backward's, without the
// tail): the halo input chunk xc [100][kc+1] and the v 1x1 chunk vt
// [100][nv+1] share one region with the output y (y is written after the v
// stage): [64][C+1], or with the tail [64][CK+4] (CK = C rounded up to 64),
// where LN2(y) is taken in place; vs [64][C+1] holds v. With the tail, the
// tail tile's scratch (LN2(y) in y's place, the gated chunk, the ring;
// tail_f32_bytes) covers the dead front after the comb product, and the plan
// is the larger of the two. Resident (kc = C): the natural-scene layout, a
// kernel instance of its own whose chunks are compile-time constants. The
// bf16 apply kernel has its own plan (FrontPlan).
struct ApplyPlan {
  int kc, nv;
  __host__ __device__ size_t front(int C, bool tail = false) const {
    const size_t stage = (size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (nv + 1);
    const size_t y = (size_t)kPix * (tail ? round_up64(C) + 4 : C + 1);
    return stage > y ? stage : y;
  }
  __host__ __device__ size_t floats(int C, bool tail) const {
    return front(C, tail) + (size_t)kPix * (C + 1);
  }
};

template <bool kStream>
__host__ __device__ inline ApplyPlan apply_plan(int kc, int C) {
  return kStream ? ApplyPlan{kc, kVCw} : ApplyPlan{C, kVC};
}

template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
spectral_apply_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int C1, int C2,
                      const float* __restrict__ lnw, const float* __restrict__ lnb,
                      const T* __restrict__ wqkv, const T* __restrict__ wdw,
                      const float* __restrict__ comb, const T* __restrict__ gate,
                      const T* __restrict__ shortcut, int residual,
                      const float* __restrict__ ln2w, const float* __restrict__ ln2b,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2, int hid,
                      const float* __restrict__ dp, T* __restrict__ out, int H, int W,
                      int shift, float eps, int kc, int tail_stages) {
  extern __shared__ float4 apply_dyn[];  // 16-byte aligned: the tail's cp.async and ldmatrix
  float* sm = reinterpret_cast<float*>(apply_dyn);
  __shared__ float mu[kHaloPix], rs[kHaloPix];
  const int C = C1 + C2, C3 = 3 * C;
  const bool tail = w1 != nullptr;
  const ApplyPlan plan = apply_plan<kStream>(kc, C);
  const int ldc = plan.kc + 1, ldx = C + 1, ldv = plan.nv + 1;
  const int ldy = tail ? round_up64(C) + 4 : ldx;
  float* xc = sm;                       // [100][ldc] halo input chunk
  float* vt = xc + kHaloPix * ldc;      // [100][ldv] 1x1 output chunk
  float* y = sm;                        // [64][ldy] output (after the v stage)
  float* vs = sm + plan.front(C, tail); // [64][ldx] v
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const Halo<T> hl{x1, x2, C1, C2, b, ty, tx, H, W, shift};

  if (lnw != nullptr) {
    halo_stats(mu, rs, hl, eps);
    __syncthreads();
  }
  if constexpr (!kStream) {
    halo_chunk(xc, ldc, hl, 0, C, mu, rs, lnw, lnb);
    __syncthreads();
  }
  for (int v0 = 0; v0 < C; v0 += plan.nv) {
    const int nvc = min(plan.nv, C - v0);
    for (int c0 = 0; c0 < C; c0 += plan.kc) {
      const int nc = min(plan.kc, C - c0);
      if constexpr (kStream) {
        halo_chunk(xc, ldc, hl, c0, nc, mu, rs, lnw, lnb);
        __syncthreads();
      }
      const bool first = !kStream || c0 == 0, last = !kStream || c0 + nc >= C;
      gemm<T>(kHaloPix, nvc, nc,
          [&](int i, int k) { return xc[i * ldc + k]; },
          [&](int k, int j) { return to_f(wqkv[(size_t)(c0 + k) * C3 + 2 * C + v0 + j]); },
          [&](int i, int j, float acc) {
            chunk_acc(vt[i * ldv + j], acc, first, last, [](float v) { return rnd<T>(v); });
          });
      __syncthreads();
    }
    dwconv3_tile(vt, ldv, nvc,
        [&](int tap, int j) { return to_f(wdw[tap * C3 + 2 * C + v0 + j]); },
        [&](int p, int j, float acc) { vs[p * ldx + v0 + j] = rnd<T>(acc); });
    __syncthreads();
  }

  const float* cb = comb + (size_t)b * C * C;
  gemm<T>(kPix, C, C,
      [&](int i, int k) { return vs[i * ldx + k]; },
      [&](int k, int j) { return rnd<T>(cb[(size_t)k * C + j]); },
      [&](int i, int j, float acc) {
        const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
        float v = rnd<T>(acc);
        if (gate != nullptr || residual || dp != nullptr) {
          // the input pixel in the unrolled frame (raw, before any LN)
          const int sr = (r - shift + H) % H, sc = (c - shift + W) % W;
          const size_t pix = ((size_t)b * H + sr) * W + sc;
          const float u = j < C1 ? to_f(x1[pix * C1 + j]) : to_f(x2[pix * C2 + (j - C1)]);
          const float g = gate == nullptr ? 0.f
              : to_f(gate[(((size_t)b * (H / kTile) + sr / kTile) * (W / kTile) + sc / kTile) * C + j]);
          if (dp != nullptr) {
            // drop-path scale on the float32 branch sum, rounded once (as
            // _sp1_kernel with has_dp; the backward scales dy the same way)
            v = rnd<T>((acc + u * g) * dp[b]);
          } else if (gate != nullptr) {
            v = rnd<T>(rnd<T>(u * g) + v);
          }
          if (residual) v = rnd<T>(u + v);
        }
        if (shortcut != nullptr) v = rnd<T>(to_f(shortcut[(((size_t)b * H + r) * W + c) * C + j]) + v);
        y[i * ldy + j] = v;
      });
  __syncthreads();
  auto dst = [&](int i) { return out + tile_pix(b, ty, tx, i, H, W) * C; };
  if (!tail) {
    for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
      const int i = idx / C, k = idx - i * C;
      dst(i)[k] = from_f<T>(y[i * ldy + k]);
    }
    return;
  }
  // the PGSSTB tail on the tensor cores (3xTF32, mlp_tail_f32) over the dead
  // front: LN2(y) in y's place, the gated chunk, the ring. Up to C = 384
  // fc2's sums start from y + b2 and hold the whole output; wider, y goes to
  // `out` first and each output group of 384 channels adds its sums there.
  const int CK = round_up64(C);
  const bool one = CK <= kTailMaxC;
  float* gs = y + kPix * ldy;            // [64][kTailLdF] gated chunk
  float* ring = gs + kPix * kTailLdF;    // [tail_stages][kTailN][kTailLdF]
  float acc[2 * kTailGroups][4];
  for (int n0 = 0; n0 < CK; n0 += kTailMaxC) {
    if (n0 > 0) __syncthreads();  // the last group's tiles read before their stages refill
    TailRingF rg(w1, w2, ring, tail_stages, C, hid, n0);
    rg.prefetch();
    if (n0 == 0) {
      if (one) {
        tail_init(acc, C, [&](int i, int k) { return y[i * ldy + k] + b2[k]; });
      } else {
        for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
          const int i = idx / C, k = idx - i * C;
          dst(i)[k] = y[i * ldy + k];
        }
      }
      __syncthreads();
      tail_ln([&](int i, int k) { return y[i * ldy + k]; }, y, ldy, C, ln2w, ln2b, eps);
    }
    if (!one) tail_init(acc, C - n0, [&](int, int k) { return b2[n0 + k]; });
    mlp_tail_f32(acc, y, ldy, gs, rg, b1, hid);
    tail_out(acc, C - n0, [&](int i, int k, float v) {
      float* o = dst(i) + n0 + k;
      *o = one ? v : *o + v;
    });
  }
}

// Arguments: as mp_spectral_apply in bf16, with wv the v rows of wqkv ([C][C8],
// torch layout), taps the v rows of the depthwise weight ([C][9]) and comb in
// bf16 ([B][C][C8]); flags: kVecX | kPairs | kVecOut (launch_apply_tc).
__global__ void __launch_bounds__(kThreads)
spectral_apply_tc_kernel(const __nv_bfloat16* __restrict__ x1, const __nv_bfloat16* __restrict__ x2,
                         int C1, int C2, const float* __restrict__ lnw,
                         const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ wv,
                         const __nv_bfloat16* __restrict__ taps,
                         const __nv_bfloat16* __restrict__ comb,
                         const __nv_bfloat16* __restrict__ gate,
                         const __nv_bfloat16* __restrict__ shortcut, int residual,
                         const float* __restrict__ ln2w, const float* __restrict__ ln2b,
                         const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                         int hid, const float* __restrict__ dp, __nv_bfloat16* __restrict__ out,
                         int H, int W, int shift, float eps, int flags, int tail_stages) {
  extern __shared__ float4 front_dyn[];
  __shared__ int hsrc[kFrontRows];            // halo row -> raw source pixel (-1: zero row)
  __shared__ int esrc[kPix], egate[kPix];     // tile pixel -> raw source pixel, gate row
  const int C = C1 + C2;
  const FrontPlan pl(C);
  const int ld = pl.ld, CP = pl.CP, C8 = round_up8(C);
  char* sm = reinterpret_cast<char*>(front_dyn);
  __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(sm);        // [9][CP / 2] tap pairs
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(sm + pl.taps);  // [64][ld] v
  __nv_bfloat16* xh = vs + kPix * ld;                                  // [112][ld] halo
  __nv_bfloat16* rg = xh + kFrontRows * ld;                            // ring / 1x1 output
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(sm);             // [64][ld] (after comb)
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec_x = flags & kVecX, pairs = flags & kPairs;

  // the raw source pixel of each halo pixel (unrolled frame, read through the
  // roll-back) and of each tile pixel, and each tile pixel's gate window
  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x) {
    hsrc[p] = halo_src(p, b, ty, tx, H, W, shift);
    if (p < kPix) {
      const int sr = (ty * kTile + (p >> 3) - shift + H) % H;
      const int sc = (tx * kTile + (p & 7) - shift + W) % W;
      esrc[p] = (b * H + sr) * W + sc;
      egate[p] = (b * (H / kTile) + sr / kTile) * (W / kTile) + sc / kTile;
    }
  }
  // the depthwise taps of v as bf16 pairs [9][CP / 2], zero past C
  for (int i = threadIdx.x; i < 9 * (CP / 2); i += blockDim.x) {
    const int tap = i / (CP / 2), c = 2 * (i - tap * (CP / 2));
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    tp[i] = __halves2bfloat162(c < C ? taps[c * 9 + tap] : z, c + 1 < C ? taps[(c + 1) * 9 + tap] : z);
  }
  __syncthreads();

  // the halo as bf16, one commit group
  stage_halo(xh, ld, hsrc, x1, x2, C1, C2, CP, vec_x);

  // the 1x1 weights of pass p: [NP out][64 in] tiles of wv, zero past C
  float acc[kFrontUnits][4][4];
  for (int n0 = 0; n0 < CP; n0 += pl.NP) {
    const int np = min(pl.NP, CP - n0), n_units = 7 * (np / 32);
    auto wr = front_ring(rg, (size_t)pl.NP * kFrontLdw, pl.ws, pl.nk,
        [=](int t, __nv_bfloat16* dst) {
          stage_tile(dst, kFrontLdw, wv + (size_t)n0 * C8 + 64 * t, C8, np, 64, C - n0, C8 - 64 * t);
        });
    wr.prefetch();
    if (n0 == 0) {
      // the halo landed (the oldest group); LayerNorm in place, one warp per
      // row, as ln_rows_inplace computes it
      cp_async_wait_upto(pl.ws - 1);
      __syncthreads();
      if (lnw != nullptr) halo_ln(xh, ld, hsrc, C, lnw, lnb, eps);
    }
    halo_1x1(acc, xh, ld, wr, n_units, CP, pl.nk);
    cp_async_wait<0>();
    __syncthreads();
    // the pass's 1x1 output, rounded to bf16, into the ring's space ([100][NP + 8])
    const int ldt = pl.NP + 8;
    front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
      if (r < kHaloPix)
        *reinterpret_cast<uint32_t*>(rg + r * ldt + c) = pack_bf16x2(v0, v1);
    });
    __syncthreads();
    // depthwise 3x3 on bf16 pairs into v
    dw3_pairs(rg, ldt, tp + n0 / 2, CP / 2, vs + n0, ld, np / 2);
    __syncthreads();
  }

  // comb's product: [64 k][CP n] tiles of this image's comb through the halo
  // and ring space, v by ldmatrix, comb by ldmatrix.trans
  {
    const __nv_bfloat16* cb = comb + (size_t)b * C * C8;
    auto cr = front_ring(xh, pl.cstage / sizeof(__nv_bfloat16), pl.cs, pl.nk,
        [=](int t, __nv_bfloat16* dst) {
          stage_tile(dst, ld, cb + (size_t)64 * t * C8, C8, 64, CP, C - 64 * t, C8);
        });
    cr.prefetch();
    const int n_units = 4 * (CP / 32);
    uint32_t a[kFrontUnits], bo[kFrontUnits];
#pragma unroll
    for (int j = 0; j < kFrontUnits; ++j) {
      const int q = warp + 16 * j, mt = q & 3, nb = q >> 2;
      a[j] = smem_u32(vs + (16 * mt + (lane & 15)) * ld + 8 * (lane >> 4));
      bo[j] = 2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 32 * nb + 8 * (lane >> 4));
    }
    front_zero(acc);
    for (int t = 0; t < pl.nk; ++t) {
      const uint32_t tile = smem_u32(cr.consume());
      uint32_t at[kFrontUnits], bt[kFrontUnits];
#pragma unroll
      for (int j = 0; j < kFrontUnits; ++j) {
        at[j] = a[j] + 2 * 64 * t;
        bt[j] = tile + bo[j];
      }
      front_mma<true>(acc, at, bt, n_units, min(4, (CP - 64 * t) / 16), ld);
    }
    cp_async_wait<0>();
    __syncthreads();
    // the epilogue from the accumulators into y (bf16)
    const bool epi = gate != nullptr || residual || dp != nullptr;
    const float dpb = dp != nullptr ? dp[b] : 1.f;
    front_out(acc, n_units, 4, [&](int i, int c, float v0, float v1) {
      if (c >= C) return;
      float o0 = __bfloat162float(__float2bfloat16(v0)), o1 = __bfloat162float(__float2bfloat16(v1));
      if (epi) {
        const float2 u = load_pair(x1, x2, C1, C2, esrc[i], c, pairs);
        const float2 g = gate != nullptr ? load_pair(gate, nullptr, C, 0, egate[i], c, pairs)
                                         : make_float2(0.f, 0.f);
        if (dp != nullptr) {
          o0 = rnd<__nv_bfloat16>((v0 + u.x * g.x) * dpb);
          o1 = rnd<__nv_bfloat16>((v1 + u.y * g.y) * dpb);
        } else if (gate != nullptr) {
          o0 = rnd<__nv_bfloat16>(rnd<__nv_bfloat16>(u.x * g.x) + o0);
          o1 = rnd<__nv_bfloat16>(rnd<__nv_bfloat16>(u.y * g.y) + o1);
        }
        if (residual) {
          o0 = rnd<__nv_bfloat16>(u.x + o0);
          o1 = rnd<__nv_bfloat16>(u.y + o1);
        }
      }
      if (shortcut != nullptr) {
        const float2 s = load_pair(shortcut, nullptr, C, 0, tile_pix(b, ty, tx, i, H, W), c, pairs);
        o0 = rnd<__nv_bfloat16>(s.x + o0);
        o1 = rnd<__nv_bfloat16>(s.y + o1);
      }
      *reinterpret_cast<uint32_t*>(y + i * ld + c) = pack_bf16x2(o0, o1);
    });
    __syncthreads();
  }

  const bool vec_out = flags & kVecOut;
  auto dst = [&](int i) { return out + tile_pix(b, ty, tx, i, H, W) * C; };
  auto same = [](int, int, float v) { return v; };
  if (w1 == nullptr) {
    tail_store(y, ld, C, vec_out, dst, same);
    return;
  }
  // the tail tile in the space after y: LN2(y) as bf16, the gated chunk, the
  // ring; y + branch rounded once
  const int ldn = round_up64(C) + 8;
  __nv_bfloat16* xn = y + kPix * ld;
  __nv_bfloat16* gs = xn + kPix * ldn;
  TailRing tr(w1, w2, gs + kPix * kTailLdg, tail_stages, C, hid);
  tr.prefetch();
  tail_ln([&](int i, int k) { return __bfloat162float(y[i * ld + k]); }, xn, ldn, C, ln2w, ln2b,
          eps);
  float tacc[2 * kTailGroups][4];
  mlp_tail_tc(tacc, xn, ldn, gs, tr, b1, hid);
  tail_out(tacc, C, [&](int i, int k, float v) {
    xn[i * ldn + k] = __float2bfloat16(__bfloat162float(y[i * ld + k]) + (v + b2[k]));
  });
  __syncthreads();
  tail_store(xn, ldn, C, vec_out, dst, same);
}

// The float32 apply plan: the front's layout and, with the tail, the tail
// tile's scratch over it (tail_f32_stages(C) ring stages), whichever is larger.
inline size_t apply_smem(int C, bool tail, int kc) {
  const ApplyPlan plan = kc >= C ? apply_plan<false>(kc, C) : apply_plan<true>(kc, C);
  const size_t front = sizeof(float) * plan.floats(C, tail);
  const size_t t = tail ? tail_f32_bytes(C, tail_f32_stages(C)) : 0;
  return front > t ? front : t;
}

// The plan in the compute type: bf16 takes the front tile's plan (always
// resident: no chunk), float32 the chunked layout above.
inline size_t apply_smem(int C, bool tail, int kc, bool bf16) {
  return bf16 ? FrontPlan(C).bytes(tail) : apply_smem(C, tail, kc);
}

// The float32 apply kernel instance of a chunk: resident where kc covers C.
inline auto apply_kernel(int kc, int C) {
  return kc >= C ? spectral_apply_kernel<float, false> : spectral_apply_kernel<float, true>;
}

inline long long apply_plan_bytes(int C, bool tail, int kc, bool bf16) {
  const size_t smem = apply_smem(C, tail, kc, bf16);
  return bf16 ? plan_bytes(spectral_apply_tc_kernel, smem) : plan_bytes(apply_kernel(kc, C), smem);
}

inline int apply_chunk(int C, bool tail, bool bf16) {
  return bf16 ? C : pick_chunk(C, [&](int kc) { return apply_plan_bytes(C, tail, kc, false); });
}

// The parts per image of a stats launch: the blocks the card holds at once
// (SMs x the kernel's occupancy at this plan) shared among the B images, at
// least one and at most one per tile.
template <typename K>
int stats_parts(K kernel, int threads, size_t smem, int B, int n_tiles) {
  int dev = 0, sms = 0, occ = 0;
  if (set_smem(kernel, smem) != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem) != cudaSuccess)
    return 0;
  const int parts = sms * (occ > 1 ? occ : 1) / B;
  return parts < 1 ? 1 : parts > n_tiles ? n_tiles : parts;
}

// The parts per image of a launch (dtype 0: the float32 tile; 1: the bf16
// tile).
inline int stats_launch_parts(int dtype, int B, int H, int W, int C, int nH) {
  const int n_tiles = (H / kTile) * (W / kTile);
  if (dtype == 0)
    return stats_parts(spectral_stats_f32_kernel, kThreads, StatsF32Plan(C, nH).bytes, B, n_tiles);
  return stats_parts(spectral_stats_tc_kernel, kThreads, StatsPlan(C, nH).bytes, B, n_tiles);
}

cudaError_t launch_sum_stats(const float* part, float* gram, float* nq, float* nk, int B,
                             int n_parts, int C, int dh, cudaStream_t stream) {
  const int m = C * dh + 2 * C;
  sum_stats_kernel<<<dim3(min(ceil_div(m, kThreads), 1024), B), kThreads, 0, stream>>>(
      part, gram, nq, nk, n_parts, C * dh, C);
  return cudaGetLastError();
}

// The float32 tile (spectral_stats_f32.cuh): wqk [2C][C8] (16-byte
// aligned), taps [2C][9]; heads up to 96 wide.
cudaError_t launch_stats(const float* x1, const float* x2, int C1, int C2, const float* lnw,
                         const float* lnb, const float* wqk, const float* taps, float* part,
                         float* gram, float* nq, float* nk, int B, int H, int W, int nH,
                         int shift, float eps, int n_parts, cudaStream_t stream) {
  const int C = C1 + C2;
  const StatsF32Plan pl(C, nH);
  if (!pl.ok() || !aligned(wqk, 16)) return cudaErrorInvalidValue;
  const int vec_x = C1 % 4 == 0 && C2 % 4 == 0 && aligned(x1, 16) && aligned(x2, 16);
  cudaError_t err = set_smem(spectral_stats_f32_kernel, pl.bytes);
  if (err != cudaSuccess) return err;
  spectral_stats_f32_kernel<<<dim3(n_parts, B), kThreads, pl.bytes, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqk, taps, H, W, nH, shift, eps, vec_x, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_stats(part, gram, nq, nk, B, n_parts, C, C / nH, stream);
}

// The bf16 tile (spectral_stats.cuh): wqk [2C][C8] (16-byte aligned), taps
// [2C][9]; C up to kFrontMaxC.
cudaError_t launch_stats_tc(const __nv_bfloat16* x1, const __nv_bfloat16* x2, int C1, int C2,
                            const float* lnw, const float* lnb, const __nv_bfloat16* wqk,
                            const __nv_bfloat16* taps, float* part, float* gram, float* nq,
                            float* nk, int B, int H, int W, int nH, int shift, float eps,
                            int n_parts, cudaStream_t stream) {
  const int C = C1 + C2;
  if (C > kFrontMaxC || !aligned(wqk, 16)) return cudaErrorInvalidValue;
  const size_t smem = StatsPlan(C, nH).bytes;
  int flags = 0;
  if (C1 % 8 == 0 && C2 % 8 == 0 && aligned(x1, 16) && aligned(x2, 16)) flags |= kVecX;
  cudaError_t err = set_smem(spectral_stats_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_tc_kernel<<<dim3(n_parts, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqk, taps, H, W, nH, shift, eps, flags, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_stats(part, gram, nq, nk, B, n_parts, C, C / nH, stream);
}

cudaError_t launch_apply(const float* x1, const float* x2, int C1, int C2, const float* lnw,
                         const float* lnb, const float* wqkv, const float* wdw, const float* comb,
                         const float* gate, const float* shortcut, int residual,
                         const float* ln2w, const float* ln2b, const float* w1, const float* b1,
                         const float* w2, const float* b2, int hid, const float* dp, float* out,
                         int B, int H, int W, int shift, int kc, float eps, cudaStream_t stream) {
  const int C = C1 + C2;
  const bool tail = w1 != nullptr;
  if (tail && (!aligned(w1, 16) || !aligned(w2, 16))) return cudaErrorInvalidValue;
  const size_t smem = apply_smem(C, tail, kc);
  const auto kernel = apply_kernel(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqkv, wdw, comb, gate, shortcut, residual, ln2w, ln2b, w1, b1, w2,
      b2, hid, dp, out, H, W, shift, eps, kc, tail ? tail_f32_stages(C) : 0);
  return cudaGetLastError();
}

// The bf16 tile (spectral_front.cuh): wv [C][C8], taps [C][9], comb
// [B][C][C8] bf16 (C8 = C rounded up to 8; wv and comb 16-byte aligned); C up
// to kFrontMaxC.
cudaError_t launch_apply_tc(const __nv_bfloat16* x1, const __nv_bfloat16* x2, int C1, int C2,
                            const float* lnw, const float* lnb, const __nv_bfloat16* wv,
                            const __nv_bfloat16* taps, const __nv_bfloat16* comb,
                            const __nv_bfloat16* gate, const __nv_bfloat16* shortcut,
                            int residual, const float* ln2w, const float* ln2b,
                            const __nv_bfloat16* w1, const float* b1, const __nv_bfloat16* w2,
                            const float* b2, int hid, const float* dp, __nv_bfloat16* out, int B,
                            int H, int W, int shift, float eps, cudaStream_t stream) {
  const int C = C1 + C2;
  if (C > kFrontMaxC || !aligned(wv, 16) || !aligned(comb, 16)) return cudaErrorInvalidValue;
  const bool tail = w1 != nullptr;
  const FrontPlan pl(C);
  const size_t smem = pl.bytes(tail);
  int flags = 0;
  if (C1 % 8 == 0 && C2 % 8 == 0 && aligned(x1, 16) && aligned(x2, 16)) flags |= kVecX;
  if (C1 % 2 == 0 && C2 % 2 == 0 && aligned(x1, 4) && aligned(x2, 4) && aligned(gate, 4) &&
      aligned(shortcut, 4))
    flags |= kPairs;
  if (C % 8 == 0 && aligned(out, 16)) flags |= kVecOut;
  cudaError_t err = set_smem(spectral_apply_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_apply_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wv, taps, comb, gate, shortcut, residual, ln2w, ln2b, w1, b1, w2,
      b2, hid, dp, out, H, W, shift, eps, flags, tail ? tail_stages(C, smem - pl.y) : 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (training). Each launch below is one 8x8 tile of the unrolled
// frame; it recomputes the forward's q/k (or v) from the input with its halo
// and writes the per-pixel operands of the rest of the backward: the conv
// input t (float32), the cotangent at the depthwise output (float32), the
// (LN'd) input, and for the apply launch v and the scaled dy. grad.cu then
// runs the depthwise-conv backward, the 1x1 + LayerNorm backward (which rolls
// dx back into the input's frame) and the weight products.
// ---------------------------------------------------------------------------

// VJP of the stats launch (K10a), float32 (bf16 runs the tiles of
// spectral_stats.cuh and dwconv_dx.cuh): dq = k dG^T + 2 q dnq, dk = q dG +
// 2 k dnk per head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spectral_stats_bwd_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                          const float* __restrict__ lnb, const T* __restrict__ wqkv,
                          const T* __restrict__ wdw, const float* __restrict__ dgram,
                          const float* __restrict__ dnq, const float* __restrict__ dnk,
                          T* __restrict__ un_out, float* __restrict__ t_out,
                          float* __restrict__ dqk_out, int H, int W, int C, int nH, int shift,
                          float eps) {
  extern __shared__ float sm[];
  const int C3 = 3 * C, dh = C / nH;
  const int ldx = C + 1, ldt = 2 * dh + 1;
  float* xs = sm;                   // [100][ldx] (LN'd) halo input
  float* ts = xs + kHaloPix * ldx;  // [100][ldt] 1x1 output, q|k of one head
  float* qk = ts + kHaloPix * ldt;  // [64][ldt] q|k after the dwconv
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };  // halo index of pixel i

  load_halo<T>(xs, ldx, x, (const T*)nullptr, C, 0, b, ty, tx, H, W, shift, lnw, lnb, eps);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    un_out[tile_pix(b, ty, tx, i, H, W) * C + k] = from_f<T>(xs[hp(i) * ldx + k]);
  }
  const float* dg = dgram + (size_t)b * C * dh;
  for (int h = 0; h < nH; ++h) {
    auto col = [&](int j) { return j < dh ? h * dh + j : C + h * dh + (j - dh); };
    gemm<T>(kHaloPix, 2 * dh, C,
        [&](int i, int k) { return xs[i * ldx + k]; },
        [&](int k, int j) { return to_f(wqkv[(size_t)k * C3 + col(j)]); },
        [&](int i, int j, float acc) { ts[i * ldt + j] = rnd<T>(acc); });
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * 2 * dh; idx += blockDim.x) {
      const int i = idx / (2 * dh), j = idx - i * 2 * dh;
      t_out[tile_pix(b, ty, tx, i, H, W) * 2 * C + col(j)] = ts[hp(i) * ldt + j];
    }
    dwconv3_tile(ts, ldt, 2 * dh,
        [&](int tap, int j) { return to_f(wdw[tap * C3 + col(j)]); },
        [&](int p, int j, float acc) { qk[p * ldt + j] = rnd<T>(acc); });
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * 2 * dh; idx += blockDim.x) {
      const int p = idx / (2 * dh), j = idx - p * 2 * dh;
      const float* row = qk + p * ldt;
      float acc;
      if (j < dh) {  // dq[d = j] = sum_e k[e] dG[d][e] + 2 q[d] dnq[d]
        acc = 2.f * row[j] * dnq[(size_t)b * C + h * dh + j];
        for (int e = 0; e < dh; ++e) acc = fmaf(row[dh + e], rnd<T>(dg[(h * dh + j) * dh + e]), acc);
      } else {       // dk[e = j - dh] = sum_d q[d] dG[d][e] + 2 k[e] dnk[e]
        const int e = j - dh;
        acc = 2.f * row[j] * dnk[(size_t)b * C + h * dh + e];
        for (int d = 0; d < dh; ++d) acc = fmaf(row[d], rnd<T>(dg[(h * dh + d) * dh + e]), acc);
      }
      dqk_out[tile_pix(b, ty, tx, p, H, W) * 2 * C + col(j)] = acc;
    }
    __syncthreads();
  }
}

// VJP of the apply launch without the MLP tail (K10b), float32 (bf16 runs
// the tiles of spectral_apply_bwd.cuh and dwconv_dx.cuh): v recomputed; dys =
// dy * dp (rounded) feeds dv = dys comb^T and the dcomb product; the gate and
// residual epilogues give the extra input cotangent dys * g + dy; with dp the
// per-tile partial of d dp = sum dy * (v comb + u g).
//
// Shared memory: the halo input is staged whole where that fits (every
// natural-scene width; v in kVC-wide chunks); at C = 384 (266 KB whole) each
// halo pixel's LN statistics stay in shared memory and the halo streams in
// channel chunks of kc per kVCw-wide v chunk (198 KB: the chunks share one
// region with dys, as the forward's with y; `apply_plan`, without the tail).
// v stays whole. The resident plan is a kernel instance of its own.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
spectral_apply_bwd_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                          const float* __restrict__ lnb, const T* __restrict__ wqkv,
                          const T* __restrict__ wdw, const float* __restrict__ comb,
                          const T* __restrict__ gate, const float* __restrict__ dp,
                          int residual, const T* __restrict__ dy, T* __restrict__ un_out,
                          float* __restrict__ t_out, T* __restrict__ v_out,
                          T* __restrict__ dys_out, float* __restrict__ dv_out,
                          float* __restrict__ extra_out, float* __restrict__ pdp, int H, int W,
                          int C, int shift, float eps, int kc) {
  extern __shared__ float sm[];
  __shared__ float red[kThreads / 32];
  const int C3 = 3 * C;
  constexpr bool resident = !kStream;  // kc = C
  const ApplyPlan plan = apply_plan<kStream>(kc, C);
  const int ldc = plan.kc + 1, ldx = C + 1, ldv = plan.nv + 1;
  float* xs = sm;                       // [100][ldc] halo input: whole or a chunk
  float* vt = xs + kHaloPix * ldc;      // [100][ldv] 1x1 output chunk
  float* vs = sm + plan.front(C);       // [64][ldx] v
  float* mu = vs + kPix * ldx;          // streamed: [100] LN mean, then [100] rstd
  float* rs = mu + kHaloPix;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const Halo<T> hl{x, (const T*)nullptr, C, 0, b, ty, tx, H, W, shift};
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };
  // raw input pixel behind unrolled-frame pixel i (the roll-back)
  auto src = [&](int i) {
    const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
    return ((size_t)b * H + (r - shift + H) % H) * W + (c - shift + W) % W;
  };
  auto gate_at = [&](int i, int j) {
    const int r = (ty * kTile + (i >> 3) - shift + H) % H, c = (tx * kTile + (i & 7) - shift + W) % W;
    return to_f(gate[(((size_t)b * (H / kTile) + r / kTile) * (W / kTile) + c / kTile) * C + j]);
  };
  // the (LN'd) input of this tile's pixels, channels [c0, c0 + nc) of xs
  auto write_un = [&](int c0, int nc) {
    for (int idx = threadIdx.x; idx < kPix * nc; idx += blockDim.x) {
      const int i = idx / nc, k = idx - i * nc;
      un_out[tile_pix(b, ty, tx, i, H, W) * C + c0 + k] = from_f<T>(xs[hp(i) * ldc + k]);
    }
  };

  if (resident) {
    load_halo<T>(xs, ldc, x, (const T*)nullptr, C, 0, b, ty, tx, H, W, shift, lnw, lnb, eps);
    __syncthreads();
    write_un(0, C);
  } else if (lnw != nullptr) {
    halo_stats(mu, rs, hl, eps);
    __syncthreads();
  }
  for (int v0 = 0; v0 < C; v0 += plan.nv) {
    const int nvc = min(plan.nv, C - v0);
    for (int c0 = 0; c0 < C; c0 += plan.kc) {
      const int nc = min(plan.kc, C - c0);
      if (!resident) {
        halo_chunk(xs, ldc, hl, c0, nc, mu, rs, lnw, lnb);
        __syncthreads();
        if (v0 == 0) write_un(c0, nc);
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kHaloPix, nvc, nc,
          [&](int i, int k) { return xs[i * ldc + k]; },
          [&](int k, int j) { return to_f(wqkv[(size_t)(c0 + k) * C3 + 2 * C + v0 + j]); },
          [&](int i, int j, float acc) {
            chunk_acc(vt[i * ldv + j], acc, first, last, [](float v) { return rnd<T>(v); });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * nvc; idx += blockDim.x) {
      const int i = idx / nvc, j = idx - i * nvc;
      t_out[tile_pix(b, ty, tx, i, H, W) * C + v0 + j] = vt[hp(i) * ldv + j];
    }
    dwconv3_tile(vt, ldv, nvc,
        [&](int tap, int j) { return to_f(wdw[tap * C3 + 2 * C + v0 + j]); },
        [&](int p, int j, float acc) { vs[p * ldx + v0 + j] = rnd<T>(acc); });
    __syncthreads();
  }
  const float dpb = dp == nullptr ? 1.f : dp[b];
  float* ds = xs;
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    const size_t o = tile_pix(b, ty, tx, i, H, W) * C + k;
    v_out[o] = from_f<T>(vs[i * ldx + k]);
    const float d0 = to_f(dy[o]);
    const float d = dp == nullptr ? d0 : rnd<T>(d0 * dpb);
    ds[i * ldx + k] = d;
    dys_out[o] = from_f<T>(d);
    if (extra_out != nullptr)
      extra_out[o] = (gate != nullptr ? d * gate_at(i, k) : 0.f) + (residual ? d0 : 0.f);
  }
  __syncthreads();
  const float* cb = comb + (size_t)b * C * C;
  // dv[p][k] = sum_o dys[p][o] comb[k][o]
  gemm<T>(kPix, C, C,
      [&](int i, int o) { return ds[i * ldx + o]; },
      [&](int o, int k) { return rnd<T>(cb[(size_t)k * C + o]); },
      [&](int i, int k, float acc) { dv_out[tile_pix(b, ty, tx, i, H, W) * C + k] = acc; });
  if (dp != nullptr) {
    float part = 0.f;
    gemm<T>(kPix, C, C,
        [&](int i, int k) { return vs[i * ldx + k]; },
        [&](int k, int j) { return rnd<T>(cb[(size_t)k * C + j]); },
        [&](int i, int j, float acc) {
          const float u = gate != nullptr ? to_f(x[src(i) * C + j]) * gate_at(i, j) : 0.f;
          part = fmaf(to_f(dy[tile_pix(b, ty, tx, i, H, W) * C + j]), acc + u, part);
        });
    part = block_sum(part, red);
    if (threadIdx.x == 0) pdp[tile] = part;
  }
}

// d gate[b][window][k] = sum over the window's pixels (rolled frame) of
// dys * x: the per-window gate multiplies the raw input (K10b's dgate).
template <typename T>
__global__ void spectral_gate_grad_kernel(const T* __restrict__ dys, const T* __restrict__ x,
                                          float* __restrict__ dgate, int H, int W, int C,
                                          int shift) {
  const int wx = blockIdx.x, wy = blockIdx.y, b = blockIdx.z;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < kPix; ++i) {
      const int r = wy * kTile + (i >> 3), c = wx * kTile + (i & 7);
      const size_t u = ((size_t)b * H + (r + shift) % H) * W + (c + shift) % W;
      s = fmaf(to_f(dys[u * C + k]), to_f(x[(((size_t)b * H + r) * W + c) * C + k]), s);
    }
    dgate[(((size_t)b * (H / kTile) + wy) * (W / kTile) + wx) * C + k] = s;
  }
}

inline size_t stats_bwd_smem(int C, int nH) {
  const int dh = C / nH;
  return sizeof(float) * ((size_t)kHaloPix * (C + 1) + (size_t)kHaloPix * (2 * dh + 1) +
                          (size_t)kPix * (2 * dh + 1));
}

// The halo stage (or dys) and v; kc < C adds the LN statistics.
inline size_t apply_bwd_smem(int C, int kc) {
  return apply_smem(C, false, kc) + (kc >= C ? 0 : sizeof(float) * 2 * kHaloPix);
}

// The apply backward instance of a chunk: resident where kc covers C.
template <typename T>
inline auto apply_bwd_kernel(int kc, int C) {
  return kc >= C ? spectral_apply_bwd_kernel<T, false> : spectral_apply_bwd_kernel<T, true>;
}

inline int apply_bwd_chunk(int C) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(apply_bwd_kernel<float>(kc, C), apply_bwd_smem(C, kc));
  });
}

template <typename T>
cudaError_t launch_stats_bwd(const void* x, const float* lnw, const float* lnb, const void* wqkv,
                             const void* wdw, const float* dgram, const float* dnq,
                             const float* dnk, void* un, float* t, float* dqk, int B, int H,
                             int W, int C, int nH, int shift, float eps, cudaStream_t stream) {
  const size_t smem = stats_bwd_smem(C, nH);
  cudaError_t err = set_smem(spectral_stats_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_bwd_kernel<T><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)wqkv, (const T*)wdw, dgram, dnq, dnk, (T*)un, t, dqk, H,
      W, C, nH, shift, eps);
  return cudaGetLastError();
}

// The bf16 stats backward's two tiles: launch 1 (spectral_stats.cuh) writes
// un, t and dqk; launch 2 (dwconv_dx.cuh, K = 2C) dtt, dx and the per-tile
// partials. wqk [2C][C8] and taps [2C][9] as the forward tile's; C up to
// kFrontMaxC.
cudaError_t launch_stats_bwd_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                                const __nv_bfloat16* wqk, const __nv_bfloat16* taps,
                                const float* dgram, const float* dnq, const float* dnk,
                                __nv_bfloat16* un, __nv_bfloat16* t, float* dqk, int B, int H,
                                int W, int C, int nH, int shift, float eps, cudaStream_t stream) {
  if (C > kFrontMaxC || !aligned(wqk, 16)) return cudaErrorInvalidValue;
  const size_t smem = StatsBwdPlan(C, nH).bytes;
  const int flags = C % 8 == 0 && aligned(x, 16) && aligned(un, 16) ? kVecX : 0;
  cudaError_t err = set_smem(spectral_stats_bwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_bwd_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, wqk, taps, dgram, dnq, dnk, C, H, W, nH, shift, eps, flags, un, t, dqk);
  return cudaGetLastError();
}

cudaError_t launch_dwconv_dx_tc(const float* dout, const __nv_bfloat16* t,
                                const __nv_bfloat16* taps, const __nv_bfloat16* w,
                                const __nv_bfloat16* x, const float* lnw, __nv_bfloat16* dt,
                                __nv_bfloat16* dx, float* part, int B, int H, int W, int C, int K,
                                int shift, float eps, cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(w, 16)) return cudaErrorInvalidValue;
  const size_t smem = DwDxPlan(C, K, true).bytes;
  const int vec_in = K % 8 == 0 && aligned(dout, 16) && aligned(t, 16);
  const int vec_x = C % 8 == 0 && aligned(x, 16) && aligned(dx, 16);
  cudaError_t err = set_smem(dwconv_dx_tc_kernel<true>, smem);
  if (err != cudaSuccess) return err;
  dwconv_dx_tc_kernel<true><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      dout, t, taps, w, x, lnw, H, W, C, K, shift, eps, vec_in, vec_x, dt, dx, part, 0, nullptr);
  return cudaGetLastError();
}

// The bf16 apply backward's first tile (spectral_apply_bwd.cuh): wv [C][C8],
// taps [C][9] and comb [B][C][C8] as the forward tile's; C up to kFrontMaxC.
cudaError_t launch_apply_bwd_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                                const __nv_bfloat16* wv, const __nv_bfloat16* taps,
                                const __nv_bfloat16* comb, const __nv_bfloat16* gate,
                                const float* dp, int residual, const __nv_bfloat16* dy,
                                __nv_bfloat16* un, __nv_bfloat16* t, __nv_bfloat16* v,
                                __nv_bfloat16* dys, float* dv, float* extra, float* pdp, int ldp,
                                int B, int H, int W, int C, int shift, float eps,
                                cudaStream_t stream) {
  if (C > kFrontMaxC || !aligned(wv, 16) || !aligned(comb, 16)) return cudaErrorInvalidValue;
  const size_t smem = ApplyBwdPlan(C).bytes;
  int flags = 0;
  if (C % 8 == 0 && aligned(x, 16)) flags |= kVecX;
  if (C % 2 == 0 && aligned(x, 4) && aligned(gate, 4) && aligned(dy, 4) && aligned(dys, 4) &&
      aligned(dv, 8) && aligned(extra, 8))
    flags |= kPairs;
  if (C % 8 == 0 && aligned(un, 16) && aligned(t, 16) && aligned(v, 16)) flags |= kVecOut;
  cudaError_t err = set_smem(spectral_apply_bwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_apply_bwd_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, wv, taps, comb, gate, dp, residual, dy, H, W, C, shift, eps, flags, un, t, v,
      dys, dv, extra, pdp, ldp);
  return cudaGetLastError();
}

// Its second tile: dwconv_dx_tc_kernel<true, true> at K = C with the extra
// cotangent; the part rows at stride ldp.
cudaError_t launch_apply_dx_tc(const float* dv, const __nv_bfloat16* t, const __nv_bfloat16* taps,
                               const __nv_bfloat16* wv, const __nv_bfloat16* x, const float* lnw,
                               const float* extra, __nv_bfloat16* dt, __nv_bfloat16* dx,
                               float* part, int ldp, int B, int H, int W, int C, int shift,
                               float eps, cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(wv, 16)) return cudaErrorInvalidValue;
  const size_t smem = DwDxPlan(C, C, true).bytes;
  const int vec_in = C % 8 == 0 && aligned(dv, 16) && aligned(t, 16) && aligned(extra, 16);
  const int vec_x = C % 8 == 0 && aligned(x, 16) && aligned(dx, 16);
  cudaError_t err = set_smem(dwconv_dx_tc_kernel<true, true>, smem);
  if (err != cudaSuccess) return err;
  dwconv_dx_tc_kernel<true, true><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      dv, t, taps, wv, x, lnw, H, W, C, C, shift, eps, vec_in, vec_x, dt, dx, part, ldp, extra);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply_bwd(const void* x, const float* lnw, const float* lnb, const void* wqkv,
                             const void* wdw, const float* comb, const void* gate,
                             const float* dp, int residual, const void* dy, void* un, float* t,
                             void* v, void* dys, float* dv, float* extra, float* pdp,
                             float* dgate, int B, int H, int W, int C, int shift, int kc,
                             float eps, cudaStream_t stream) {
  const size_t smem = apply_bwd_smem(C, kc);
  const auto kernel = apply_bwd_kernel<T>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W / kTile, H / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)wqkv, (const T*)wdw, comb, (const T*)gate, dp, residual,
      (const T*)dy, (T*)un, t, (T*)v, (T*)dys, dv, extra, pdp, H, W, C, shift, eps, kc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (gate != nullptr)
    spectral_gate_grad_kernel<T><<<grid, 256, 0, stream>>>((const T*)dys, (const T*)x, dgate, H,
                                                           W, C, shift);
  return cudaGetLastError();
}

}  // namespace mp

// Inputs: x1 (B, H, W, C1) and optional x2 (B, H, W, C2), logical input
// cat(x1, x2); optional LN (float32, over C1 + C2). float32 (dtype 0) or
// bf16 (dtype 1): wqkv the q|k rows of the torch weight ([2C][C8], C8 = C
// rounded up to 8, zero past C; 16-byte aligned), wdw their depthwise taps
// ([2C][9]); float32 takes heads up to 96 wide, bf16 C up to 384. Partial buffer part [B][n_parts][C*dh + 2C] (n_parts from
// mp_spectral_stats_parts). Outputs (float32): gram [B][C][dh] (row h*dh + d,
// col e), nq and nk [B][nH][dh].
extern "C" int mp_spectral_stats(const void* x1, const void* x2, const void* lnw,
                                 const void* lnb, const void* wqkv, const void* wdw, void* part,
                                 void* gram, void* nq, void* nk, int dtype, int B, int H, int W,
                                 int C1, int C2, int nH, int shift, float eps, int n_parts,
                                 void* stream) {
  if ((C1 + C2) % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || n_parts <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  float *pt = (float*)part, *g = (float*)gram, *q = (float*)nq, *k = (float*)nk;
  if (dtype == 0)
    return (int)mp::launch_stats(f(x1), f(x2), C1, C2, f(lnw), f(lnb), f(wqkv), f(wdw), pt, g, q,
                                 k, B, H, W, nH, shift, eps, n_parts, st);
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_stats_tc((bf)x1, (bf)x2, C1, C2, f(lnw), f(lnb), (bf)wqkv, (bf)wdw, pt, g,
                                  q, k, B, H, W, nH, shift, eps, n_parts, st);
}

// The parts per image a stats launch takes (0 on a device error): the
// blocks the card holds at once over B images, at most one per tile.
extern "C" int mp_spectral_stats_parts(int dtype, int B, int H, int W, int C, int nH) {
  return mp::stats_launch_parts(dtype, B, H, W, C, nH);
}

// comb [B][C][C] (row: v channel h*dh + e, col: output channel). gate (B,
// H/8, W/8, C) per-window gates of the rolled frame, shortcut (B, H, W, C),
// residual adds the raw input; dp (B,) float32 per-sample drop-path scales of
// the branch (NULL = none); w1 / w2 the PGSSTB tail (NULL = none). Output (B,
// H, W, C) in the unrolled frame.
// float32 (dtype 0): wqkv [C][3C], wdw [9][3C] ([in][out] copies), comb
// float32, tail pack_mlp_weights' w1p [hidP/64][128][CK], w2p [CK][hidP] in
// float32 (16-byte aligned); kc the channel chunk (mp_spectral_apply_chunk;
// kc = C is the resident instance).
// bf16 (dtype 1, C <= 384): wqkv the v rows of the torch weight ([C][C8], C8 =
// C rounded up to 8, zero past C; 16-byte aligned), wdw their depthwise taps
// ([C][9]), comb bf16 [B][C][C8] (16-byte aligned), tail pack_mlp_weights' w1p
// [hidP/64][128][CK], w2p [CK][hidP]; kc is C.
extern "C" int mp_spectral_apply(const void* x1, const void* x2, const void* lnw,
                                 const void* lnb, const void* wqkv, const void* wdw,
                                 const void* comb, const void* gate, const void* shortcut,
                                 const void* ln2w, const void* ln2b, const void* w1,
                                 const void* b1, const void* w2, const void* b2, const void* dp,
                                 void* out, int dtype, int B, int H, int W, int C1, int C2,
                                 int residual, int hid, int shift, int kc, float eps,
                                 void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C1 + C2)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_apply(f(x1), f(x2), C1, C2, f(lnw), f(lnb), f(wqkv), f(wdw), f(comb),
                                 f(gate), f(shortcut), residual, f(ln2w), f(ln2b), f(w1), f(b1),
                                 f(w2), f(b2), hid, f(dp), (float*)out, B, H, W, shift, kc, eps,
                                 st);
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_apply_tc((bf)x1, (bf)x2, C1, C2, f(lnw), f(lnb), (bf)wqkv, (bf)wdw,
                                  (bf)comb, (bf)gate, (bf)shortcut, residual, f(ln2w), f(ln2b),
                                  (bf)w1, f(b1), (bf)w2, f(b2), hid, f(dp), (__nv_bfloat16*)out,
                                  B, H, W, shift, eps, st);
}

// The device's opt-in shared-memory limit per block, in bytes.
extern "C" int mp_smem_optin() { return mp::smem_optin(); }

// The channel chunk the float32 apply kernel launches with at a shape.
extern "C" int mp_spectral_apply_chunk(int C, int tail, int dtype) {
  return mp::apply_chunk(C, tail != 0, dtype != 0);
}

// Shared-memory plans per block (bytes, static included) at a shape. The
// float32 stats tile's (StatsF32Plan; no chunk): -1 past heads 96 wide.
extern "C" long long mp_spectral_stats_smem(int C, int nH) {
  const mp::StatsF32Plan pl(C, nH);
  return pl.ok() ? mp::plan_bytes(mp::spectral_stats_f32_kernel, pl.bytes) : -1;
}

// The bf16 stats tile's plan (StatsPlan; no chunk).
extern "C" long long mp_spectral_stats_tc_smem(int C, int nH) {
  return mp::plan_bytes(mp::spectral_stats_tc_kernel, mp::StatsPlan(C, nH).bytes);
}

// The apply plan takes the compute type (dtype 0 float32, 1 bf16).
extern "C" long long mp_spectral_apply_smem(int C, int tail, int dtype, int kc) {
  return mp::apply_plan_bytes(C, tail != 0, kc, dtype != 0);
}

extern "C" long long mp_spectral_stats_bwd_smem(int C, int nH) {
  return mp::plan_bytes(mp::spectral_stats_bwd_kernel<float>, mp::stats_bwd_smem(C, nH));
}

// The bf16 stats backward's tiles (StatsBwdPlan; DwDxPlan at C and K = 2C
// for this route); -1 past C = 384.
extern "C" long long mp_spectral_stats_bwd_tc_smem(int C, int nH) {
  return C > mp::kFrontMaxC ? -1
                            : mp::plan_bytes(mp::spectral_stats_bwd_tc_kernel,
                                             mp::StatsBwdPlan(C, nH).bytes);
}

extern "C" long long mp_dwconv_dx_tc_smem(int C, int K) {
  return C > mp::kTailMaxC ? -1
                           : mp::plan_bytes(mp::dwconv_dx_tc_kernel<true>,
                                            mp::DwDxPlan(C, K, true).bytes);
}

extern "C" long long mp_spectral_apply_bwd_smem(int C, int kc) {
  return mp::plan_bytes(mp::apply_bwd_kernel<float>(kc, C), mp::apply_bwd_smem(C, kc));
}

// The channel chunk the apply backward kernel launches with at C.
extern "C" int mp_spectral_apply_bwd_chunk(int C) { return mp::apply_bwd_chunk(C); }

// The float32 backward of mp_spectral_stats for one raw input (no x2; bf16
// runs mp_spectral_stats_bwd_tc and mp_dwconv_dx_tc). Inputs: x, LN, wqkv
// [C][3C], wdw [9][3C] as in the forward; dgram (B, C, dh), dnq / dnk (B,
// nH, dh). Outputs, unrolled frame: un (B, H, W, C) the (LN'd) input, t (B,
// H, W, 2C) the q|k 1x1 output, dqk (B, H, W, 2C) the cotangent after the
// depthwise conv.
extern "C" int mp_spectral_stats_bwd(const void* x, const void* lnw, const void* lnb,
                                     const void* wqkv, const void* wdw, const void* dgram,
                                     const void* dnq, const void* dnk, void* un, void* t,
                                     void* dqk, int B, int H, int W, int C, int nH, int shift,
                                     float eps, void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_stats_bwd<float>(x, f(lnw), f(lnb), wqkv, wdw, f(dgram), f(dnq), f(dnk),
                                          un, (float*)t, (float*)dqk, B, H, W, C, nH, shift, eps,
                                          (cudaStream_t)stream);
}

// The bf16 stats backward's first tile (C <= 384): x (B, H, W, C) bf16, LN
// float32 or NULL; wqk the q|k rows of the torch weight ([2C][C8], 16-byte
// aligned) and taps [2C][9] bf16 (the forward tile's operands); dgram (B, C,
// dh), dnq / dnk (B, nH, dh) float32. Outputs, unrolled frame, torch channel
// order: un (B, H, W, C) bf16, t (B, H, W, 2C) bf16, dqk (B, H, W, 2C) float32.
extern "C" int mp_spectral_stats_bwd_tc(const void* x, const void* lnw, const void* lnb,
                                        const void* wqk, const void* taps, const void* dgram,
                                        const void* dnq, const void* dnk, void* un, void* t,
                                        void* dqk, int B, int H, int W, int C, int nH, int shift,
                                        float eps, void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_stats_bwd_tc((bf)x, f(lnw), f(lnb), (bf)wqk, (bf)taps, f(dgram), f(dnq),
                                      f(dnk), (__nv_bfloat16*)un, (__nv_bfloat16*)t, (float*)dqk,
                                      B, H, W, C, nH, shift, eps, (cudaStream_t)stream);
}

// The second tile (C <= 384): the backward of [LN ->] 1x1 -> depthwise 3x3
// from the cotangent dout (B, H, W, K) float32 at the depthwise output; t (B,
// H, W, K) bf16 its input; taps [K][9] and w [K][C8] bf16 (16-byte aligned);
// x (B, H, W, C) bf16 whose pixel (r - shift, c - shift) is the kernel
// frame's (r, c); lnw NULL = no LN. Outputs: dt (B, H, W, K) bf16 kernel
// frame, dx (B, H, W, C) bf16 x's frame, part (tiles, 9 K [+ 2 C]) float32.
extern "C" int mp_dwconv_dx_tc(const void* dout, const void* t, const void* taps, const void* w,
                               const void* x, const void* lnw, void* dt, void* dx, void* part,
                               int B, int H, int W, int C, int K, int shift, float eps,
                               void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_dwconv_dx_tc((const float*)dout, (bf)t, (bf)taps, (bf)w, (bf)x,
                                      (const float*)lnw, (__nv_bfloat16*)dt, (__nv_bfloat16*)dx,
                                      (float*)part, B, H, W, C, K, shift, eps,
                                      (cudaStream_t)stream);
}

// The bf16 backward of mp_spectral_apply (C <= 384), first tile: x (B, H,
// W, C) bf16, LN float32 or NULL; wv [C][C8], taps [C][9], comb [B][C][C8]
// bf16 (pack_front's operands, wv and comb 16-byte aligned); gate (B, H/8,
// W/8, C) bf16, dp (B,) float32, each NULL = none; dy (B, H, W, C) bf16,
// unrolled frame. Outputs, unrolled frame: un, t, v (B, H, W, C) bf16, dys
// (dy * dp rounded; with dp only), dv (B, H, W, C) float32, extra (float32;
// NULL without gate and residual), pdp (with dp: the d dp column of every
// tile's part row, row stride ldp).
extern "C" int mp_spectral_apply_bwd_tc(const void* x, const void* lnw, const void* lnb,
                                        const void* wv, const void* taps, const void* comb,
                                        const void* gate, const void* dp, const void* dy, void* un,
                                        void* t, void* v, void* dys, void* dv, void* extra,
                                        void* pdp, int B, int H, int W, int C, int residual,
                                        int shift, int ldp, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || (dp != nullptr) != (dys != nullptr))
    return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  using bo = __nv_bfloat16*;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_apply_bwd_tc((bf)x, f(lnw), f(lnb), (bf)wv, (bf)taps, (bf)comb, (bf)gate,
                                      f(dp), residual, (bf)dy, (bo)un, (bo)t, (bo)v, (bo)dys,
                                      (float*)dv, (float*)extra, (float*)pdp, ldp, B, H, W, C,
                                      shift, eps, (cudaStream_t)stream);
}

// Its second tile (C <= 384): dv (B, H, W, C) float32 and t bf16 (unrolled
// frame), taps and wv as the first tile's, x and lnw as its, extra float32
// or NULL (added to dx before it rounds). Outputs: dt (B, H, W, C) bf16
// unrolled frame, dx (B, H, W, C) bf16 x's frame, part rows (stride ldp):
// the tap partials [9][C], then with LN d ln_w and d ln_b.
extern "C" int mp_spectral_apply_dx_tc(const void* dv, const void* t, const void* taps,
                                       const void* wv, const void* x, const void* lnw,
                                       const void* extra, void* dt, void* dx, void* part, int B,
                                       int H, int W, int C, int shift, int ldp, float eps,
                                       void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_apply_dx_tc((const float*)dv, (bf)t, (bf)taps, (bf)wv, (bf)x,
                                     (const float*)lnw, (const float*)extra, (__nv_bfloat16*)dt,
                                     (__nv_bfloat16*)dx, (float*)part, ldp, B, H, W, C, shift,
                                     eps, (cudaStream_t)stream);
}

// d gate (B, H/8, W/8, C) float32 of the bf16 backward: per window of the
// rolled frame the sum of dys * x (dys (B, H, W, C) unrolled frame, x rolled).
extern "C" int mp_spectral_gate_grad(const void* dys, const void* x, void* dgate, int B, int H,
                                     int W, int C, int shift, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  mp::spectral_gate_grad_kernel<__nv_bfloat16>
      <<<dim3(W / mp::kTile, H / mp::kTile, B), 256, 0, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)dys, (const __nv_bfloat16*)x, (float*)dgate, H, W, C, shift);
  return (int)cudaGetLastError();
}

// The bf16 apply backward's plans (bytes, static included): tile 1
// (ApplyBwdPlan) or 2 (DwDxPlan at K = C, its own instance); -1 past C = 384.
extern "C" long long mp_spectral_apply_bwd_tc_smem(int C, int tile) {
  if (C > mp::kFrontMaxC) return -1;
  return tile == 1 ? mp::plan_bytes(mp::spectral_apply_bwd_tc_kernel, mp::ApplyBwdPlan(C).bytes)
                   : mp::plan_bytes(mp::dwconv_dx_tc_kernel<true, true>,
                                    mp::DwDxPlan(C, C, true).bytes);
}

// The float32 backward of mp_spectral_apply without the MLP tail or x2 (bf16
// runs mp_spectral_apply_bwd_tc, mp_spectral_gate_grad and
// mp_spectral_apply_dx_tc). dy (B, H, W, C) unrolled frame. Outputs,
// unrolled frame: un (LN'd input), t (float32 v 1x1 output), v, dys (dy *
// dp), dv (float32), extra (float32 input cotangent of the gate / residual
// epilogue; NULL when neither), pdp (per-tile d dp partials; NULL without
// dp), dgate (B, H/8, W/8, C) float32. kc: the channel chunk
// (mp_spectral_apply_bwd_chunk).
extern "C" int mp_spectral_apply_bwd(const void* x, const void* lnw, const void* lnb,
                                     const void* wqkv, const void* wdw, const void* comb,
                                     const void* gate, const void* dp, const void* dy, void* un,
                                     void* t, void* v, void* dys, void* dv, void* extra,
                                     void* pdp, void* dgate, int dtype, int B, int H, int W,
                                     int C, int residual, int shift, int kc, float eps,
                                     void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C || dtype != 0)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_apply_bwd<float>(x, f(lnw), f(lnb), wqkv, wdw, f(comb), gate, f(dp),
                                          residual, dy, un, (float*)t, v, dys, (float*)dv,
                                          (float*)extra, (float*)pdp, (float*)dgate, B, H, W, C,
                                          shift, kc, eps, (cudaStream_t)stream);
}
