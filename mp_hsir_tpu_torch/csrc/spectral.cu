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
//                      spectral_apply_f32_kernel below, the 3xTF32 tile built
//                      from spectral_front_f32.cuh, with the 3xTF32 tail tile
//                      of mlp_tail.cuh, mlp_tail_f32).
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
// rate bounds both at these widths. Every forward product runs on the
// tensor cores: bf16 as mma.sync in the tiles of spectral_stats.cuh and
// spectral_front.cuh, float32 as 3xTF32 mma.sync in those of
// spectral_stats_f32.cuh, spectral_apply_f32_kernel below and mlp_tail.cuh
// (PERF.md). The float32 backward kernels below keep SIMT FMA (common.cuh
// gemm). The bf16 stats backward runs two tensor-core tiles:
// spectral_stats_bwd_tc_kernel (spectral_stats.cuh) and dwconv_dx_tc_kernel
// (dwconv_dx.cuh); the float32 one spectral_stats_bwd_kernel below and
// grad.cu's dwconv_bwd and ln_linear_bwd. So does the bf16 apply backward:
// spectral_apply_bwd_tc_kernel (spectral_apply_bwd.cuh) and
// dwconv_dx_tc_kernel<true, true>; the float32 one spectral_apply_bwd_kernel
// below and grad.cu's stages.
#include "dwconv_dx.cuh"
#include "spectral_apply_bwd.cuh"
#include "spectral_stats_f32.cuh"

namespace mp {

// The source of halo pixel p of tile (ty, tx) in the unrolled frame: a pixel
// of the map (its offset in B H W), -1 outside the image (zero after the
// optional LayerNorm), or -2 - q for pixel q of a row shard's halo rows hal
// [2][B][W][C] (q = (side B + b) W + column; side 0 above the shard, 1
// below), on the rows just above (-1) and below (H) the shard where `halo`
// has bit 0 / bit 1 set (shift 0 there). The float32 backward's counterpart
// of the forward tiles' halo_src.
__device__ __forceinline__ long long bwd_halo_src(int p, int b, int B, int ty, int tx, int H,
                                                  int W, int shift, int halo) {
  const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
  if (uc < 0 || uc >= W) return -1;
  if (ur == -1) return (halo & 1) ? -2 - ((long long)b * W + uc) : -1;
  if (ur == H) return (halo & 2) ? -2 - ((long long)(B + b) * W + uc) : -1;
  if (ur < 0 || ur >= H) return -1;
  const int sr = (ur - shift + H) % H, sc = (uc - shift + W) % W;
  return ((long long)b * H + sr) * W + sc;
}

// Loads the 10x10 halo of tile (ty, tx) of the logical input cat(x1, x2) in the
// unrolled frame into s ([kHaloPix][ld]), zero outside the image, then applies
// the optional LayerNorm (zero rows stay zero, as in the JAX kernels, which
// mask after normalising). hal / halo: a row shard's halo rows (bwd_halo_src),
// which are real data and go through the LayerNorm.
template <typename T>
__device__ __forceinline__ void load_halo(float* s, int ld, const T* __restrict__ x1,
                                          const T* __restrict__ x2, int C1, int C2, int b,
                                          int ty, int tx, int H, int W, int shift,
                                          const float* lnw, const float* lnb, float eps,
                                          const float* __restrict__ hal = nullptr,
                                          int halo = 0) {
  const int C = C1 + C2, B = gridDim.z;
  for (int idx = threadIdx.x; idx < kHaloPix * C; idx += blockDim.x) {
    const int p = idx / C, k = idx - p * C;
    const long long src = bwd_halo_src(p, b, B, ty, tx, H, W, shift, halo);
    float v = 0.f;
    if (src <= -2)
      v = hal[(-2 - src) * C + k];
    else if (src >= 0)
      v = k < C1 ? to_f(x1[src * C1 + k]) : to_f(x2[src * C2 + (k - C1)]);
    s[p * ld + k] = v;
  }
  if (lnw != nullptr) {
    __syncthreads();
    ln_rows_inplace<T>(s, ld, kHaloPix, C, lnw, lnb, eps, [&](int p) {
      return bwd_halo_src(p, b, B, ty, tx, H, W, shift, halo) != -1;
    });
  }
}

// The logical input cat(x1, x2) of tile (ty, tx)'s 10x10 halo in the unrolled
// frame: at(p, k) is channel k of halo pixel p, inside(p) whether it holds
// data (outside, the halo is zero after the optional LayerNorm); hal / halo a
// row shard's halo rows, as in load_halo.
template <typename T>
struct Halo {
  const T* x1;
  const T* x2;
  int C1, C2, b, ty, tx, H, W, shift;
  const float* hal = nullptr;
  int halo = 0;
  __device__ __forceinline__ long long src(int p) const {
    return bwd_halo_src(p, b, gridDim.z, ty, tx, H, W, shift, halo);
  }
  __device__ __forceinline__ bool inside(int p) const { return src(p) != -1; }
  __device__ __forceinline__ float at(int p, int k) const {
    const long long s = src(p);
    if (s <= -2) return hal[(-2 - s) * (C1 + C2) + k];
    return k < C1 ? to_f(x1[s * C1 + k]) : to_f(x2[s * C2 + (k - C1)]);
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

// The float32 apply backward's plan: the halo input chunk xc [100][kc+1] and
// the v 1x1 chunk vt [100][nv+1] share one region with dys [64][C+1] (dys
// is staged after the v stage); vs [64][CL+1] holds v (CL the v width: C, or
// a head block). Resident (kc = C): the natural-scene layout, a kernel
// instance of its own whose chunks are compile-time constants.
struct ApplyPlan {
  int kc, nv;
  __host__ __device__ size_t front(int C) const {
    const size_t stage = (size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (nv + 1);
    const size_t y = (size_t)kPix * (C + 1);
    return stage > y ? stage : y;
  }
  __host__ __device__ size_t floats(int C, int CL) const {
    return front(C) + (size_t)kPix * (CL + 1);
  }
};

template <bool kStream>
__host__ __device__ inline ApplyPlan apply_plan(int kc, int C) {
  return kStream ? ApplyPlan{kc, kVCw} : ApplyPlan{C, kVC};
}

// The float32 apply tile: phase 1 of _spectral_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1597-1650) and _sp1_kernel (:1962)
// in float32, on the tensor cores in 3xTF32, with no rounding points. One
// 8x8 tile per 512-thread block: v = dw3x3(1x1([LN] cat(x1, x2))) over the
// tile's 10x10 halo, out = v @ comb, the epilogue [x * gate] [+ x] [+
// shortcut] (with drop-path (out + x * gate) * dp), then optionally the
// PGSSTB tail (mlp_tail_f32). Design (the float32 twin of the bf16 front,
// built from the pieces of spectral_front_f32.cuh; plan ApplyF32Plan):
// - v's 1x1 per column group of at most 192 v channels: the halo's and the
//   group's v rows' 32-channel chunks streamed together through a cp.async
//   ring ([112 + GW][36] float32 stages), LayerNorm per chunk from per-pixel
//   mean / rstd, the 1x1 into registers (halo_1x1_f32), its output [100][GW
//   + 8] over the ring's space, the depthwise 3x3 by fmaf in tap order
//   (dw3_f32, taps staged once as [9][CP]) into the v tile [64][CP + 4].
// - comb's product per pass of at most 384 output channels (one pass up to
//   C = 384): v from the v tile by ldmatrix (A), comb^T's 32-deep chunks
//   ([np][36] stages, the wrapper's transposed pack) through the same ring
//   form (B); every k8 step's three TF32 products summed from zero on the
//   tensor cores and added in float32 (mma_3xtf32).
// - The epilogue straight from the accumulators (raw input pixel, gate
//   window and output pixel precomputed per tile pixel; float32 pair loads):
//   with the tail up to C = 384 into y [64][CK + 4] over the dead front,
//   which tail_ln normalises in place; else to `out`, where the tail (past
//   C = 384) reads y back and adds each output group of 384 channels.
// - A member's head block under the spectral mesh axis (parallel/tp.py): v
//   is CL < C channels wide (its 1x1 still C deep), comb (CL, C) and the
//   product's depth CL; the gate, residual, drop-path and shortcut epilogue
//   reads and writes the C-wide maps as for the whole attention (the caller
//   scales the gate by 1/n and sums the members' outputs). No tail then.
// Arguments: x1, x2, lnw, lnb, gate, shortcut, residual, dp and the tail as
// mp_spectral_apply (float32); CL the v width; wv the v rows of wqkv
// ([CL][C8], torch layout, zero past C; 16-byte aligned), taps their
// depthwise taps ([CL][9]), combt comb transposed ([B][C out][CL8 in], CL8
// = CL rounded up to 8, 16-byte aligned); hal, halo a
// row shard's halo rows and which are real, as spectral_stats_f32_kernel's
// (they feed only v's depthwise at the shard's first and last rows); flags:
// kVecX (16-byte halo copies) | kPairs (8-byte epilogue loads and stores);
// gwin the gate's window, 8 or 1 for a per-pixel gate map (gate_row).
__global__ void __launch_bounds__(kThreads)
spectral_apply_f32_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int C1,
                          int C2, const float* __restrict__ lnw, const float* __restrict__ lnb,
                          const float* __restrict__ wv, const float* __restrict__ taps,
                          const float* __restrict__ combt, const float* __restrict__ gate,
                          const float* __restrict__ shortcut, int residual,
                          const float* __restrict__ ln2w, const float* __restrict__ ln2b,
                          const float* __restrict__ w1, const float* __restrict__ b1,
                          const float* __restrict__ w2, const float* __restrict__ b2, int hid,
                          const float* __restrict__ dp, float* __restrict__ out, int H, int W,
                          int shift, float eps, int flags, int tail_stages,
                          const float* __restrict__ hal, int halo, int gwin, int CL) {
  extern __shared__ float4 apply_f32_dyn[];  // 16-byte aligned: cp.async and ldmatrix
  __shared__ int hsrc[kFrontRows];            // halo row -> raw source pixel (-1: zero row)
  __shared__ int esrc[kPix], egate[kPix];     // tile pixel -> raw source pixel, gate row
  const int C = C1 + C2, C8 = round_up8(C), CL8 = round_up8(CL);
  const ApplyF32Plan pl(C, CL);
  const int CP = pl.CP, CPL = pl.CPL, ldv = pl.ldv;
  float* tp = reinterpret_cast<float*>(apply_f32_dyn);  // [9][CPL] v taps
  float* mu = tp + 9 * CPL;                             // [112]
  float* rs = mu + kFrontRows;                          // [112]
  float* vs = rs + kFrontRows;                          // [64][ldv] v
  float* rg = vs + kPix * ldv;                          // ring / 1x1 output [100][ldt]
  float* y = reinterpret_cast<float*>(apply_f32_dyn);   // [64][CK + 4] (after comb, tail)
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const bool pairs = flags & kPairs;
  const HaloF32 hl{x1, x2, C1, C2, hsrc, (flags & kVecX) != 0, hal};
  auto dst = [&](int i) { return out + tile_pix(b, ty, tx, i, H, W) * C; };

  // the raw source pixel of each halo pixel (unrolled frame, read through
  // the roll-back; a shard's halo rows) and of each tile pixel, each tile
  // pixel's gate window, and the taps of v, zero past CL
  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x) {
    hsrc[p] = halo_src(p, b, ty, tx, gridDim.z, H, W, shift, halo);
    if (p < kPix) {
      const int sr = (ty * kTile + (p >> 3) - shift + H) % H;
      const int sc = (tx * kTile + (p & 7) - shift + W) % W;
      esrc[p] = (b * H + sr) * W + sc;
      egate[p] = gate_row(b, sr, sc, H, W, gwin);
    }
  }
  for (int i = threadIdx.x; i < 9 * CPL; i += blockDim.x) {
    const int tap = i / CPL, c = i - tap * CPL;
    tp[i] = c < CL ? taps[c * 9 + tap] : 0.f;
  }
  __syncthreads();
  if (lnw != nullptr)  // read after the first chunk's barrier
    ln_stats_rows(mu, rs, kHaloPix, C, eps, [&](int p, int k) { return hl.at(hsrc[p], k); },
                  [&](int p) { return hsrc[p] != -1; });

  // v, one column group at a time
  for (int g0 = 0; g0 < CPL; g0 += pl.GW) {
    const int gw = min(pl.GW, CPL - g0), n_units = 7 * (gw / 32);
    auto ring = front_ring(rg, pl.stage / sizeof(float), pl.ws, pl.nk,
        [=](int kt, float* st) {
          stage_f32_chunk(st, hl, wv, C8, gw, [=](int n) { return g0 + n < CL ? g0 + n : -1; },
                          kt);
        });
    ring.prefetch();
    float acc[kFrontUnits][4][4];
    halo_1x1_f32(acc, ring, n_units, pl.nk, [&](float* st, int kt) {
      if (lnw != nullptr) {
        ln_f32_chunk(st, hsrc, mu, rs, lnw, lnb, C, kt);
        __syncthreads();
      }
    });
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: the 1x1 output takes its space
    front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
      if (r < kHaloPix) *reinterpret_cast<float2*>(rg + r * pl.ldt + c) = make_float2(v0, v1);
    });
    __syncthreads();
    dw3_f32(rg, pl.ldt, tp + g0, CPL, vs + g0, ldv, gw / 2);
    __syncthreads();  // v's columns are complete; the ring's space is free
  }

  // comb's product and the epilogue, one pass of output channels at a time
  const bool tail = w1 != nullptr, one = round_up64(C) <= kTailMaxC;
  const int ldy = round_up64(C) + 4;
  const bool epi = gate != nullptr || residual || dp != nullptr;
  const float dpb = dp != nullptr ? dp[b] : 1.f;
  const float* cb = combt + (size_t)b * C * CL8;
  for (int n0 = 0; n0 < CP; n0 += pl.NP) {
    const int np = min(pl.NP, CP - n0), n_units = 4 * (np / 32);
    auto cr = front_ring(rg, pl.cstage / sizeof(float), pl.cs, pl.nkv,
        [=](int kt, float* st) {
          stage_w_f32_chunk(st, cb, CL8, np, [=](int n) { return n0 + n < C ? n0 + n : -1; }, kt);
        });
    cr.prefetch();
    float acc[kFrontUnits][4][4];
    comb_f32(acc, vs, ldv, cr, n_units, pl.nkv);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with v and the ring: y may take their space
    front_out(acc, n_units, 4, [&](int i, int cc, float v0, float v1) {
      const int c = n0 + cc;
      if (c >= C) return;
      if (epi) {
        const float2 u = load_pair(x1, x2, C1, C2, esrc[i], c, pairs);
        const float2 g = gate != nullptr ? load_pair(gate, nullptr, C, 0, egate[i], c, pairs)
                                         : make_float2(0.f, 0.f);
        if (dp != nullptr) {
          v0 = __fmul_rn(__fadd_rn(v0, __fmul_rn(u.x, g.x)), dpb);
          v1 = __fmul_rn(__fadd_rn(v1, __fmul_rn(u.y, g.y)), dpb);
        } else if (gate != nullptr) {
          v0 = __fadd_rn(__fmul_rn(u.x, g.x), v0);
          v1 = __fadd_rn(__fmul_rn(u.y, g.y), v1);
        }
        if (residual) {
          v0 = u.x + v0;
          v1 = u.y + v1;
        }
      }
      if (shortcut != nullptr) {
        const float2 s = load_pair(shortcut, nullptr, C, 0, tile_pix(b, ty, tx, i, H, W), c,
                                   pairs);
        v0 = s.x + v0;
        v1 = s.y + v1;
      }
      if (tail && one) {
        *reinterpret_cast<float2*>(y + i * ldy + c) = make_float2(v0, v1);
      } else if (pairs) {
        *reinterpret_cast<float2*>(dst(i) + c) = make_float2(v0, v1);
      } else {
        dst(i)[c] = v0;
        if (c + 1 < C) dst(i)[c + 1] = v1;
      }
    });
  }
  if (!tail) return;
  __syncthreads();  // y is complete (in shared memory, or in `out` past C = 384)

  // the PGSSTB tail on the tensor cores (3xTF32, mlp_tail_f32) over the dead
  // front: LN2(y) in y's place, the gated chunk, the ring. Up to C = 384
  // fc2's sums start from y + b2 and hold the whole output; wider, each
  // output group of 384 channels adds its sums to y in `out`.
  const int CK = round_up64(C);
  float* gs = y + kPix * ldy;            // [64][kTailLdF] gated chunk
  float* ring = gs + kPix * kTailLdF;    // [tail_stages][kTailN][kTailLdF]
  float acc[2 * kTailGroups][4];
  for (int n0 = 0; n0 < CK; n0 += kTailMaxC) {
    if (n0 > 0) __syncthreads();  // the last group's tiles read before their stages refill
    TailRingF rg2(w1, w2, ring, tail_stages, C, hid, n0);
    rg2.prefetch();
    if (n0 == 0) {
      if (one) {
        tail_init(acc, C, [&](int i, int k) { return y[i * ldy + k] + b2[k]; });
        __syncthreads();  // y read before LN2 overwrites it
        tail_ln([&](int i, int k) { return y[i * ldy + k]; }, y, ldy, C, ln2w, ln2b, eps);
      } else {
        tail_ln([&](int i, int k) { return dst(i)[k]; }, y, ldy, C, ln2w, ln2b, eps);
      }
    }
    if (!one) tail_init(acc, C - n0, [&](int, int k) { return b2[n0 + k]; });
    mlp_tail_f32(acc, y, ldy, gs, rg2, b1, hid);
    tail_out(acc, C - n0, [&](int i, int k, float v) {
      float* o = dst(i) + n0 + k;
      *o = one ? v : *o + v;
    });
  }
}

// Arguments: as mp_spectral_apply in bf16, with wv the v rows of wqkv ([CL][C8],
// torch layout), taps the v rows of the depthwise weight ([CL][9]) and comb in
// bf16 ([B][CL][C8]); CL the v width (C, or a member's head block under the
// spectral mesh axis: v, its taps and comb's depth CL, the halo, comb's
// columns and the output C; no tail); flags: kVecX | kPairs | kVecOut
// (launch_apply_tc); hal, halo a row shard's halo rows [2][B][W][C] bf16 and
// which are real (halo_src; the source map is static, so the plan does not
// change); gwin the gate's window, 8 or 1 for a per-pixel gate map
// (gate_row).
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
                         int H, int W, int shift, float eps, int flags, int tail_stages,
                         const __nv_bfloat16* __restrict__ hal, int halo, int gwin, int CL) {
  extern __shared__ float4 front_dyn[];
  __shared__ int hsrc[kFrontRows];            // halo row -> source pixel (halo_src)
  __shared__ int esrc[kPix], egate[kPix];     // tile pixel -> raw source pixel, gate row
  const int C = C1 + C2;
  const FrontPlan pl(C, CL);
  const int ld = pl.ld, ldv = pl.ldv, CP = pl.CP, CPL = pl.CPL, C8 = round_up8(C);
  char* sm = reinterpret_cast<char*>(front_dyn);
  __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(sm);        // [9][CPL / 2] tap pairs
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(sm + pl.taps);  // [64][ldv] v
  __nv_bfloat16* xh = vs + kPix * ldv;                                 // [112][ld] halo
  __nv_bfloat16* rg = xh + kFrontRows * ld;                            // ring / 1x1 output
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(sm);             // [64][ld] (after comb)
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec_x = flags & kVecX, pairs = flags & kPairs;

  // the raw source pixel of each halo pixel (unrolled frame, read through the
  // roll-back) and of each tile pixel, and each tile pixel's gate window
  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x) {
    hsrc[p] = halo_src(p, b, ty, tx, gridDim.z, H, W, shift, halo);
    if (p < kPix) {
      const int sr = (ty * kTile + (p >> 3) - shift + H) % H;
      const int sc = (tx * kTile + (p & 7) - shift + W) % W;
      esrc[p] = (b * H + sr) * W + sc;
      egate[p] = gate_row(b, sr, sc, H, W, gwin);
    }
  }
  // the depthwise taps of v as bf16 pairs [9][CPL / 2], zero past CL
  for (int i = threadIdx.x; i < 9 * (CPL / 2); i += blockDim.x) {
    const int tap = i / (CPL / 2), c = 2 * (i - tap * (CPL / 2));
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    tp[i] = __halves2bfloat162(c < CL ? taps[c * 9 + tap] : z,
                               c + 1 < CL ? taps[(c + 1) * 9 + tap] : z);
  }
  __syncthreads();

  // the halo as bf16, one commit group
  stage_halo(xh, ld, hsrc, x1, x2, C1, C2, CP, vec_x, hal);

  // the 1x1 weights of pass p: [NP out][64 in] tiles of wv, zero past CL
  // rows and C columns
  float acc[kFrontUnits][4][4];
  for (int n0 = 0; n0 < CPL; n0 += pl.NP) {
    const int np = min(pl.NP, CPL - n0), n_units = 7 * (np / 32);
    auto wr = front_ring(rg, (size_t)pl.NP * kFrontLdw, pl.ws, pl.nk,
        [=](int t, __nv_bfloat16* dst) {
          stage_tile(dst, kFrontLdw, wv + (size_t)n0 * C8 + 64 * t, C8, np, 64, CL - n0, C8 - 64 * t);
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
    dw3_pairs(rg, ldt, tp + n0 / 2, CPL / 2, vs + n0, ldv, np / 2);
    __syncthreads();
  }

  // comb's product: [64 k][CP n] tiles of this image's comb (CL rows deep)
  // through the halo and ring space, v by ldmatrix, comb by ldmatrix.trans
  {
    const __nv_bfloat16* cb = comb + (size_t)b * CL * C8;
    auto cr = front_ring(xh, pl.cstage / sizeof(__nv_bfloat16), pl.cs, pl.nkc,
        [=](int t, __nv_bfloat16* dst) {
          stage_tile(dst, ld, cb + (size_t)64 * t * C8, C8, 64, CP, CL - 64 * t, C8);
        });
    cr.prefetch();
    const int n_units = 4 * (CP / 32);
    uint32_t a[kFrontUnits], bo[kFrontUnits];
#pragma unroll
    for (int j = 0; j < kFrontUnits; ++j) {
      const int q = warp + 16 * j, mt = q & 3, nb = q >> 2;
      a[j] = smem_u32(vs + (16 * mt + (lane & 15)) * ldv + 8 * (lane >> 4));
      bo[j] = 2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 32 * nb + 8 * (lane >> 4));
    }
    front_zero(acc);
    for (int t = 0; t < pl.nkc; ++t) {
      const uint32_t tile = smem_u32(cr.consume());
      uint32_t at[kFrontUnits], bt[kFrontUnits];
#pragma unroll
      for (int j = 0; j < kFrontUnits; ++j) {
        at[j] = a[j] + 2 * 64 * t;
        bt[j] = tile + bo[j];
      }
      front_mma<true>(acc, at, bt, n_units, min(4, (CPL - 64 * t) / 16), ld);
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

// The apply plan in the compute type (bytes, static included): the bf16
// tile's FrontPlan or the float32 tile's ApplyF32Plan (neither has a chunk);
// CL the v width (C, or a member's head block).
inline long long apply_plan_bytes(int C, bool tail, bool bf16, int CL) {
  return bf16 ? plan_bytes(spectral_apply_tc_kernel, FrontPlan(C, CL).bytes(tail))
              : plan_bytes(spectral_apply_f32_kernel, ApplyF32Plan(C, CL).bytes(tail));
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

// The parts per image of a launch (dtype 0: the float32 tile, 1: the bf16
// tile; q|k width CL).
inline int stats_launch_parts(int dtype, int B, int H, int W, int C, int CL, int nH) {
  const int n_tiles = (H / kTile) * (W / kTile);
  if (dtype == 0)
    return stats_parts(spectral_stats_f32_kernel, kThreads, StatsF32Plan(C, CL, nH).bytes, B,
                       n_tiles);
  return stats_parts(spectral_stats_tc_kernel, kThreads, StatsPlan(C, CL, nH).bytes, B, n_tiles);
}

cudaError_t launch_sum_stats(const float* part, float* gram, float* nq, float* nk, int B,
                             int n_parts, int C, int dh, cudaStream_t stream) {
  const int m = C * dh + 2 * C;
  sum_stats_kernel<<<dim3(min(ceil_div(m, kThreads), 1024), B), kThreads, 0, stream>>>(
      part, gram, nq, nk, n_parts, C * dh, C);
  return cudaGetLastError();
}

// The float32 tile (spectral_stats_f32.cuh): wqk [2CL][C8] (16-byte
// aligned), taps [2CL][9]; heads up to 96 wide; CL the q|k width (C, or a
// head block of nH heads).
cudaError_t launch_stats(const float* x1, const float* x2, int C1, int C2, const float* lnw,
                         const float* lnb, const float* wqk, const float* taps, float* part,
                         float* gram, float* nq, float* nk, int B, int H, int W, int nH,
                         int shift, float eps, int n_parts, const float* hal, int halo, int CL,
                         cudaStream_t stream) {
  const int C = C1 + C2;
  const StatsF32Plan pl(C, CL, nH);
  if (!pl.ok() || !aligned(wqk, 16) || (halo != 0 && (hal == nullptr || shift != 0)) ||
      CL <= 0 || CL > C)
    return cudaErrorInvalidValue;
  const int vec_x = C1 % 4 == 0 && C2 % 4 == 0 && aligned(x1, 16) && aligned(x2, 16) &&
                    aligned(hal, 16);
  cudaError_t err = set_smem(spectral_stats_f32_kernel, pl.bytes);
  if (err != cudaSuccess) return err;
  spectral_stats_f32_kernel<<<dim3(n_parts, B), kThreads, pl.bytes, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqk, taps, H, W, nH, shift, eps, vec_x, hal, halo, part, CL);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_stats(part, gram, nq, nk, B, n_parts, CL, CL / nH, stream);
}

// The bf16 tile (spectral_stats.cuh): wqk [2CL][C8] (16-byte aligned), taps
// [2CL][9]; C up to kFrontMaxC; CL the q|k width (C, or a head block of nH
// heads); hal, halo a row shard's bf16 halo rows.
cudaError_t launch_stats_tc(const __nv_bfloat16* x1, const __nv_bfloat16* x2, int C1, int C2,
                            const float* lnw, const float* lnb, const __nv_bfloat16* wqk,
                            const __nv_bfloat16* taps, float* part, float* gram, float* nq,
                            float* nk, int B, int H, int W, int nH, int shift, float eps,
                            int n_parts, const __nv_bfloat16* hal, int halo, int CL,
                            cudaStream_t stream) {
  const int C = C1 + C2;
  if (C > kFrontMaxC || !aligned(wqk, 16) || (halo != 0 && (hal == nullptr || shift != 0)) ||
      CL <= 0 || CL > C)
    return cudaErrorInvalidValue;
  const size_t smem = StatsPlan(C, CL, nH).bytes;
  int flags = 0;
  if (C1 % 8 == 0 && C2 % 8 == 0 && aligned(x1, 16) && aligned(x2, 16) && aligned(hal, 16))
    flags |= kVecX;
  cudaError_t err = set_smem(spectral_stats_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_tc_kernel<<<dim3(n_parts, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqk, taps, H, W, nH, shift, eps, flags, hal, halo, part, CL);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_stats(part, gram, nq, nk, B, n_parts, CL, CL / nH, stream);
}

// The float32 tile: wv [CL][C8], taps [CL][9], combt [B][C][CL8] float32 (wv
// and combt 16-byte aligned), the tail's packs 16-byte aligned; CL the v
// width (C, or a head block, which takes no tail).
cudaError_t launch_apply_f32(const float* x1, const float* x2, int C1, int C2, const float* lnw,
                             const float* lnb, const float* wv, const float* taps,
                             const float* combt, const float* gate, const float* shortcut,
                             int residual, const float* ln2w, const float* ln2b, const float* w1,
                             const float* b1, const float* w2, const float* b2, int hid,
                             const float* dp, float* out, int B, int H, int W, int shift,
                             float eps, const float* hal, int halo, int gwin, int CL,
                             cudaStream_t stream) {
  const int C = C1 + C2;
  const bool tail = w1 != nullptr;
  if (!aligned(wv, 16) || !aligned(combt, 16) || (tail && (!aligned(w1, 16) || !aligned(w2, 16))) ||
      (halo != 0 && (hal == nullptr || shift != 0)) || CL <= 0 || CL > C || (tail && CL != C))
    return cudaErrorInvalidValue;
  const size_t smem = ApplyF32Plan(C, CL).bytes(tail);
  int flags = 0;
  if (C1 % 4 == 0 && C2 % 4 == 0 && aligned(x1, 16) && aligned(x2, 16) && aligned(hal, 16))
    flags |= kVecX;
  if (C1 % 2 == 0 && C2 % 2 == 0 && aligned(x1, 8) && aligned(x2, 8) && aligned(gate, 8) &&
      aligned(shortcut, 8) && aligned(out, 8))
    flags |= kPairs;
  cudaError_t err = set_smem(spectral_apply_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_apply_f32_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wv, taps, combt, gate, shortcut, residual, ln2w, ln2b, w1, b1,
      w2, b2, hid, dp, out, H, W, shift, eps, flags, tail ? tail_f32_stages(C) : 0, hal, halo,
      gwin, CL);
  return cudaGetLastError();
}

// The bf16 tile (spectral_front.cuh): wv [CL][C8], taps [CL][9], comb
// [B][CL][C8] bf16 (C8 = C rounded up to 8; wv and comb 16-byte aligned); C up
// to kFrontMaxC; CL the v width (C, or a head block, which takes no tail);
// hal, halo a row shard's bf16 halo rows.
cudaError_t launch_apply_tc(const __nv_bfloat16* x1, const __nv_bfloat16* x2, int C1, int C2,
                            const float* lnw, const float* lnb, const __nv_bfloat16* wv,
                            const __nv_bfloat16* taps, const __nv_bfloat16* comb,
                            const __nv_bfloat16* gate, const __nv_bfloat16* shortcut,
                            int residual, const float* ln2w, const float* ln2b,
                            const __nv_bfloat16* w1, const float* b1, const __nv_bfloat16* w2,
                            const float* b2, int hid, const float* dp, __nv_bfloat16* out, int B,
                            int H, int W, int shift, float eps, const __nv_bfloat16* hal,
                            int halo, int gwin, int CL, cudaStream_t stream) {
  const int C = C1 + C2;
  const bool tail = w1 != nullptr;
  if (C > kFrontMaxC || !aligned(wv, 16) || !aligned(comb, 16) ||
      (halo != 0 && (hal == nullptr || shift != 0)) || CL <= 0 || CL > C || (tail && CL != C))
    return cudaErrorInvalidValue;
  const FrontPlan pl(C, CL);
  const size_t smem = pl.bytes(tail);
  int flags = 0;
  if (C1 % 8 == 0 && C2 % 8 == 0 && aligned(x1, 16) && aligned(x2, 16) && aligned(hal, 16))
    flags |= kVecX;
  if (C1 % 2 == 0 && C2 % 2 == 0 && aligned(x1, 4) && aligned(x2, 4) && aligned(gate, 4) &&
      aligned(shortcut, 4))
    flags |= kPairs;
  if (C % 8 == 0 && aligned(out, 16)) flags |= kVecOut;
  cudaError_t err = set_smem(spectral_apply_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_apply_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wv, taps, comb, gate, shortcut, residual, ln2w, ln2b, w1, b1, w2,
      b2, hid, dp, out, H, W, shift, eps, flags, tail ? tail_stages(C, smem - pl.y) : 0, hal,
      halo, gwin, CL);
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
// 2 k dnk per head. CL the q|k width (C, or a member's head block under the
// spectral mesh axis: wqkv [C][3CL], wdw [9][3CL], dgram (B, CL, dh), t and
// dqk 2CL wide; the input, un and its halo rows stay C wide).
template <typename T>
__global__ void __launch_bounds__(kThreads)
spectral_stats_bwd_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                          const float* __restrict__ lnb, const T* __restrict__ wqkv,
                          const T* __restrict__ wdw, const float* __restrict__ dgram,
                          const float* __restrict__ dnq, const float* __restrict__ dnk,
                          T* __restrict__ un_out, float* __restrict__ t_out,
                          float* __restrict__ dqk_out, int H, int W, int C, int nH, int shift,
                          float eps, const float* __restrict__ hal, int halo,
                          float* __restrict__ un_halo, float* __restrict__ t_halo, int CL) {
  extern __shared__ float sm[];
  const int C3 = 3 * CL, dh = CL / nH;
  const int ldx = C + 1, ldt = 2 * dh + 1;
  float* xs = sm;                   // [100][ldx] (LN'd) halo input
  float* ts = xs + kHaloPix * ldx;  // [100][ldt] 1x1 output, q|k of one head
  float* qk = ts + kHaloPix * ldt;  // [64][ldt] q|k after the dwconv
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };  // halo index of pixel i

  load_halo<T>(xs, ldx, x, (const T*)nullptr, C, 0, b, ty, tx, H, W, shift, lnw, lnb, eps, hal,
               halo);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    un_out[tile_pix(b, ty, tx, i, H, W) * C + k] = from_f<T>(xs[hp(i) * ldx + k]);
  }
  for (int side = 0; side < 2; ++side)
    if (shard_row(side, ty, H, halo))
      halo_row_out(un_halo, xs, ldx, C, side, b, tx, W, C, [](int j) { return j; });
  const float* dg = dgram + (size_t)b * CL * dh;
  for (int h = 0; h < nH; ++h) {
    auto col = [&](int j) { return j < dh ? h * dh + j : CL + h * dh + (j - dh); };
    gemm<T>(kHaloPix, 2 * dh, C,
        [&](int i, int k) { return xs[i * ldx + k]; },
        [&](int k, int j) { return to_f(wqkv[(size_t)k * C3 + col(j)]); },
        [&](int i, int j, float acc) { ts[i * ldt + j] = rnd<T>(acc); });
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * 2 * dh; idx += blockDim.x) {
      const int i = idx / (2 * dh), j = idx - i * 2 * dh;
      t_out[tile_pix(b, ty, tx, i, H, W) * 2 * CL + col(j)] = ts[hp(i) * ldt + j];
    }
    for (int side = 0; side < 2; ++side)
      if (shard_row(side, ty, H, halo))
        halo_row_out(t_halo, ts, ldt, 2 * dh, side, b, tx, W, 2 * CL, col);
    dwconv3_tile(ts, ldt, 2 * dh,
        [&](int tap, int j) { return to_f(wdw[tap * C3 + col(j)]); },
        [&](int p, int j, float acc) { qk[p * ldt + j] = rnd<T>(acc); });
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * 2 * dh; idx += blockDim.x) {
      const int p = idx / (2 * dh), j = idx - p * 2 * dh;
      const float* row = qk + p * ldt;
      float acc;
      if (j < dh) {  // dq[d = j] = sum_e k[e] dG[d][e] + 2 q[d] dnq[d]
        acc = 2.f * row[j] * dnq[(size_t)b * CL + h * dh + j];
        for (int e = 0; e < dh; ++e) acc = fmaf(row[dh + e], rnd<T>(dg[(h * dh + j) * dh + e]), acc);
      } else {       // dk[e = j - dh] = sum_d q[d] dG[d][e] + 2 k[e] dnk[e]
        const int e = j - dh;
        acc = 2.f * row[j] * dnk[(size_t)b * CL + h * dh + e];
        for (int d = 0; d < dh; ++d) acc = fmaf(row[d], rnd<T>(dg[(h * dh + d) * dh + e]), acc);
      }
      dqk_out[tile_pix(b, ty, tx, p, H, W) * 2 * CL + col(j)] = acc;
    }
    __syncthreads();
  }
}

// VJP of the apply launch without the MLP tail (K10b), float32 (bf16 runs
// the tiles of spectral_apply_bwd.cuh and dwconv_dx.cuh): v recomputed; dys =
// dy * dp (rounded) feeds dv = dys comb^T and the dcomb product; the gate and
// residual epilogues give the extra input cotangent dys * g + dy; with dp the
// per-tile partial of d dp = sum dy * (v comb + u g). A member's head block
// under the spectral mesh axis: v is CL wide (wqkv [C][3CL], wdw [9][3CL],
// comb (B, CL, C), t / v / dv CL wide), dv = dys comb^T at width CL; the
// input, dy, dys, the gate and the extra cotangent stay C wide.
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
                          int C, int shift, float eps, int kc, const float* __restrict__ hal,
                          int halo, float* __restrict__ un_halo, float* __restrict__ t_halo,
                          int gwin, int CL) {
  extern __shared__ float sm[];
  __shared__ float red[kThreads / 32];
  const int C3 = 3 * CL;
  constexpr bool resident = !kStream;  // kc = C
  const ApplyPlan plan = apply_plan<kStream>(kc, C);
  const int ldc = plan.kc + 1, ldx = C + 1, ldv = plan.nv + 1, lds = CL + 1;
  float* xs = sm;                       // [100][ldc] halo input: whole or a chunk
  float* vt = xs + kHaloPix * ldc;      // [100][ldv] 1x1 output chunk
  float* vs = sm + plan.front(C);       // [64][lds] v
  float* mu = vs + kPix * lds;          // streamed: [100] LN mean, then [100] rstd
  float* rs = mu + kHaloPix;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const Halo<T> hl{x, (const T*)nullptr, C, 0, b, ty, tx, H, W, shift, hal, halo};
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };
  // raw input pixel behind unrolled-frame pixel i (the roll-back)
  auto src = [&](int i) {
    const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
    return ((size_t)b * H + (r - shift + H) % H) * W + (c - shift + W) % W;
  };
  auto gate_at = [&](int i, int j) {
    const int r = (ty * kTile + (i >> 3) - shift + H) % H, c = (tx * kTile + (i & 7) - shift + W) % W;
    return to_f(gate[(size_t)gate_row(b, r, c, H, W, gwin) * C + j]);
  };
  // the (LN'd) input of this tile's pixels, channels [c0, c0 + nc) of xs
  // (and of a row shard's halo rows that this tile reads)
  auto write_un = [&](int c0, int nc) {
    for (int idx = threadIdx.x; idx < kPix * nc; idx += blockDim.x) {
      const int i = idx / nc, k = idx - i * nc;
      un_out[tile_pix(b, ty, tx, i, H, W) * C + c0 + k] = from_f<T>(xs[hp(i) * ldc + k]);
    }
    for (int side = 0; side < 2; ++side)
      if (shard_row(side, ty, H, halo))
        halo_row_out(un_halo, xs, ldc, nc, side, b, tx, W, C, [&](int j) { return c0 + j; });
  };

  if (resident) {
    load_halo<T>(xs, ldc, x, (const T*)nullptr, C, 0, b, ty, tx, H, W, shift, lnw, lnb, eps,
                 hal, halo);
    __syncthreads();
    write_un(0, C);
  } else if (lnw != nullptr) {
    halo_stats(mu, rs, hl, eps);
    __syncthreads();
  }
  for (int v0 = 0; v0 < CL; v0 += plan.nv) {
    const int nvc = min(plan.nv, CL - v0);
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
          [&](int k, int j) { return to_f(wqkv[(size_t)(c0 + k) * C3 + 2 * CL + v0 + j]); },
          [&](int i, int j, float acc) {
            chunk_acc(vt[i * ldv + j], acc, first, last, [](float v) { return rnd<T>(v); });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * nvc; idx += blockDim.x) {
      const int i = idx / nvc, j = idx - i * nvc;
      t_out[tile_pix(b, ty, tx, i, H, W) * CL + v0 + j] = vt[hp(i) * ldv + j];
    }
    for (int side = 0; side < 2; ++side)
      if (shard_row(side, ty, H, halo))
        halo_row_out(t_halo, vt, ldv, nvc, side, b, tx, W, CL, [&](int j) { return v0 + j; });
    dwconv3_tile(vt, ldv, nvc,
        [&](int tap, int j) { return to_f(wdw[tap * C3 + 2 * CL + v0 + j]); },
        [&](int p, int j, float acc) { vs[p * lds + v0 + j] = rnd<T>(acc); });
    __syncthreads();
  }
  const float dpb = dp == nullptr ? 1.f : dp[b];
  float* ds = xs;
  for (int idx = threadIdx.x; idx < kPix * CL; idx += blockDim.x) {
    const int i = idx / CL, k = idx - i * CL;
    v_out[tile_pix(b, ty, tx, i, H, W) * CL + k] = from_f<T>(vs[i * lds + k]);
  }
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    const size_t o = tile_pix(b, ty, tx, i, H, W) * C + k;
    const float d0 = to_f(dy[o]);
    const float d = dp == nullptr ? d0 : rnd<T>(d0 * dpb);
    ds[i * ldx + k] = d;
    dys_out[o] = from_f<T>(d);
    if (extra_out != nullptr)
      extra_out[o] = (gate != nullptr ? d * gate_at(i, k) : 0.f) + (residual ? d0 : 0.f);
  }
  __syncthreads();
  const float* cb = comb + (size_t)b * CL * C;
  // dv[p][k] = sum_o dys[p][o] comb[k][o]
  gemm<T>(kPix, CL, C,
      [&](int i, int o) { return ds[i * ldx + o]; },
      [&](int o, int k) { return rnd<T>(cb[(size_t)k * C + o]); },
      [&](int i, int k, float acc) { dv_out[tile_pix(b, ty, tx, i, H, W) * CL + k] = acc; });
  if (dp != nullptr) {
    float part = 0.f;
    gemm<T>(kPix, C, CL,
        [&](int i, int k) { return vs[i * lds + k]; },
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
// dys * x: the per-window gate multiplies the raw input (K10b's dgate); one
// block a window of gwin x gwin pixels (gwin 1: a per-pixel gate map).
template <typename T>
__global__ void spectral_gate_grad_kernel(const T* __restrict__ dys, const T* __restrict__ x,
                                          float* __restrict__ dgate, int H, int W, int C,
                                          int shift, int gwin) {
  const int wx = blockIdx.x, wy = blockIdx.y, b = blockIdx.z;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < gwin * gwin; ++i) {
      const int r = wy * gwin + i / gwin, c = wx * gwin + i % gwin;
      const size_t u = ((size_t)b * H + (r + shift) % H) * W + (c + shift) % W;
      s = fmaf(to_f(dys[u * C + k]), to_f(x[(((size_t)b * H + r) * W + c) * C + k]), s);
    }
    dgate[(size_t)gate_row(b, wy * gwin, wx * gwin, H, W, gwin) * C + k] = s;
  }
}

inline size_t stats_bwd_smem(int C, int CL, int nH) {
  const int dh = CL / nH;
  return sizeof(float) * ((size_t)kHaloPix * (C + 1) + (size_t)kHaloPix * (2 * dh + 1) +
                          (size_t)kPix * (2 * dh + 1));
}

// The halo stage (or dys) and v (CL wide); kc < C adds the LN statistics.
inline size_t apply_bwd_smem(int C, int CL, int kc) {
  const ApplyPlan plan = kc >= C ? apply_plan<false>(kc, C) : apply_plan<true>(kc, C);
  return sizeof(float) * plan.floats(C, CL) + (kc >= C ? 0 : sizeof(float) * 2 * kHaloPix);
}

// The apply backward instance of a chunk: resident where kc covers C.
template <typename T>
inline auto apply_bwd_kernel(int kc, int C) {
  return kc >= C ? spectral_apply_bwd_kernel<T, false> : spectral_apply_bwd_kernel<T, true>;
}

inline int apply_bwd_chunk(int C, int CL) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(apply_bwd_kernel<float>(kc, C), apply_bwd_smem(C, CL, kc));
  });
}

template <typename T>
cudaError_t launch_stats_bwd(const void* x, const float* lnw, const float* lnb, const void* wqkv,
                             const void* wdw, const float* dgram, const float* dnq,
                             const float* dnk, void* un, float* t, float* dqk, int B, int H,
                             int W, int C, int nH, int shift, float eps, const float* hal,
                             int halo, float* un_halo, float* t_halo, int CL,
                             cudaStream_t stream) {
  const size_t smem = stats_bwd_smem(C, CL, nH);
  cudaError_t err = set_smem(spectral_stats_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_bwd_kernel<T><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)wqkv, (const T*)wdw, dgram, dnq, dnk, (T*)un, t, dqk, H,
      W, C, nH, shift, eps, hal, halo, un_halo, t_halo, CL);
  return cudaGetLastError();
}

// The bf16 stats backward's two tiles: launch 1 (spectral_stats.cuh) writes
// un, t and dqk; launch 2 (dwconv_dx.cuh, K = 2CL) dtt, dx and the per-tile
// partials. wqk [2CL][C8] and taps [2CL][9] as the forward tile's (CL the
// q|k width: C, or a head block); C up to kFrontMaxC; hal, halo, un_halo,
// t_halo a row shard's (shift 0).
cudaError_t launch_stats_bwd_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                                const __nv_bfloat16* wqk, const __nv_bfloat16* taps,
                                const float* dgram, const float* dnq, const float* dnk,
                                __nv_bfloat16* un, __nv_bfloat16* t, float* dqk, int B, int H,
                                int W, int C, int nH, int shift, float eps,
                                const __nv_bfloat16* hal, int halo, __nv_bfloat16* un_halo,
                                __nv_bfloat16* t_halo, int CL, cudaStream_t stream) {
  if (C > kFrontMaxC || !aligned(wqk, 16) || CL <= 0 || CL > C ||
      (halo != 0 && (hal == nullptr || un_halo == nullptr || t_halo == nullptr || shift != 0)))
    return cudaErrorInvalidValue;
  const size_t smem = StatsBwdPlan(C, CL, nH).bytes;
  const int flags = C % 8 == 0 && aligned(x, 16) && aligned(un, 16) && aligned(hal, 16) ? kVecX : 0;
  cudaError_t err = set_smem(spectral_stats_bwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_bwd_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, wqk, taps, dgram, dnq, dnk, C, H, W, nH, shift, eps, flags, un, t, dqk, hal,
      halo, un_halo, t_halo, CL);
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

// The bf16 apply backward's first tile (spectral_apply_bwd.cuh): wv [CL][C8],
// taps [CL][9] and comb [B][CL][C8] as the forward tile's (CL the v width: C,
// or a head block); C up to kFrontMaxC; hal, halo, un_halo, t_halo a row
// shard's (shift 0).
cudaError_t launch_apply_bwd_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                                const __nv_bfloat16* wv, const __nv_bfloat16* taps,
                                const __nv_bfloat16* comb, const __nv_bfloat16* gate,
                                const float* dp, int residual, const __nv_bfloat16* dy,
                                __nv_bfloat16* un, __nv_bfloat16* t, __nv_bfloat16* v,
                                __nv_bfloat16* dys, float* dv, float* extra, float* pdp, int ldp,
                                int B, int H, int W, int C, int shift, float eps,
                                const __nv_bfloat16* hal, int halo, __nv_bfloat16* un_halo,
                                __nv_bfloat16* t_halo, int gwin, int CL, cudaStream_t stream) {
  if (C > kFrontMaxC || !aligned(wv, 16) || !aligned(comb, 16) || CL <= 0 || CL > C ||
      (halo != 0 && (hal == nullptr || un_halo == nullptr || t_halo == nullptr || shift != 0)))
    return cudaErrorInvalidValue;
  const size_t smem = ApplyBwdPlan(C, CL).bytes;
  int flags = 0;
  if (C % 8 == 0 && aligned(x, 16) && aligned(hal, 16)) flags |= kVecX;
  if (C % 2 == 0 && CL % 2 == 0 && aligned(x, 4) && aligned(gate, 4) && aligned(dy, 4) &&
      aligned(dys, 4) && aligned(dv, 8) && aligned(extra, 8))
    flags |= kPairs;
  if (C % 8 == 0 && CL % 8 == 0 && aligned(un, 16) && aligned(t, 16) && aligned(v, 16))
    flags |= kVecOut;
  cudaError_t err = set_smem(spectral_apply_bwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  spectral_apply_bwd_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, wv, taps, comb, gate, dp, residual, dy, H, W, C, shift, eps, flags, un, t, v,
      dys, dv, extra, pdp, ldp, hal, halo, un_halo, t_halo, gwin, CL);
  return cudaGetLastError();
}

// Its second tile: dwconv_dx_tc_kernel<true, true> at K = CL with the extra
// cotangent (C wide); the part rows at stride ldp.
cudaError_t launch_apply_dx_tc(const float* dv, const __nv_bfloat16* t, const __nv_bfloat16* taps,
                               const __nv_bfloat16* wv, const __nv_bfloat16* x, const float* lnw,
                               const float* extra, __nv_bfloat16* dt, __nv_bfloat16* dx,
                               float* part, int ldp, int B, int H, int W, int C, int CL,
                               int shift, float eps, cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(wv, 16) || CL <= 0 || CL > C) return cudaErrorInvalidValue;
  const size_t smem = DwDxPlan(C, CL, true).bytes;
  // vec_in also gates the extra cotangent's 16-byte copies (C wide)
  const int vec_in = C % 8 == 0 && CL % 8 == 0 && aligned(dv, 16) && aligned(t, 16) &&
                     aligned(extra, 16);
  const int vec_x = C % 8 == 0 && aligned(x, 16) && aligned(dx, 16);
  cudaError_t err = set_smem(dwconv_dx_tc_kernel<true, true>, smem);
  if (err != cudaSuccess) return err;
  dwconv_dx_tc_kernel<true, true><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      dv, t, taps, wv, x, lnw, H, W, C, CL, shift, eps, vec_in, vec_x, dt, dx, part, ldp, extra);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply_bwd(const void* x, const float* lnw, const float* lnb, const void* wqkv,
                             const void* wdw, const float* comb, const void* gate,
                             const float* dp, int residual, const void* dy, void* un, float* t,
                             void* v, void* dys, float* dv, float* extra, float* pdp,
                             float* dgate, int B, int H, int W, int C, int shift, int kc,
                             float eps, const float* hal, int halo, float* un_halo,
                             float* t_halo, int gwin, int CL, cudaStream_t stream) {
  const size_t smem = apply_bwd_smem(C, CL, kc);
  const auto kernel = apply_bwd_kernel<T>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W / kTile, H / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)wqkv, (const T*)wdw, comb, (const T*)gate, dp, residual,
      (const T*)dy, (T*)un, t, (T*)v, (T*)dys, dv, extra, pdp, H, W, C, shift, eps, kc, hal, halo,
      un_halo, t_halo, gwin, CL);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (gate != nullptr)
    spectral_gate_grad_kernel<T><<<dim3(W / gwin, H / gwin, B), 256, 0, stream>>>(
        (const T*)dys, (const T*)x, dgate, H, W, C, shift, gwin);
  return cudaGetLastError();
}

}  // namespace mp

// Inputs: x1 (B, H, W, C1) and optional x2 (B, H, W, C2), logical input
// cat(x1, x2); optional LN (float32, over C1 + C2). CL: the q|k width, C =
// C1 + C2 for the whole attention; a member's head block of nH heads under
// the spectral mesh axis has CL < C (both types).
// float32 (dtype 0) or bf16 (dtype 1): wqkv the q|k rows of the torch weight
// ([2CL][C8], C8 = C rounded up to 8, zero past C; 16-byte aligned), wdw
// their depthwise taps ([2CL][9]); float32 takes heads up to 96 wide, bf16 C
// up to 384. Partial buffer part [B][n_parts][CL*dh + 2CL] (n_parts from
// mp_spectral_stats_parts). Outputs (float32): gram [B][CL][dh] (row h*dh +
// d, col e), nq and nk [B][nH][dh]. A row shard of a larger map (shift 0): halo
// [2][B][W][C1 + C2] in the compute type holds the row above the shard and
// the row below it, of cat(x1, x2); halo_flags bit 0 says the row above
// is real data (else the shard's top is the image edge), bit 1 the row
// below. halo_flags 0: the shard is the whole map (halo may be NULL).
extern "C" int mp_spectral_stats(const void* x1, const void* x2, const void* lnw,
                                 const void* lnb, const void* wqkv, const void* wdw, void* part,
                                 void* gram, void* nq, void* nk, const void* halo, int dtype,
                                 int B, int H, int W, int C1, int C2, int CL, int nH, int shift,
                                 float eps, int n_parts, int halo_flags, void* stream) {
  if (CL % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || n_parts <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  float *pt = (float*)part, *g = (float*)gram, *q = (float*)nq, *k = (float*)nk;
  if (dtype == 0)
    return (int)mp::launch_stats(f(x1), f(x2), C1, C2, f(lnw), f(lnb), f(wqkv), f(wdw), pt, g, q,
                                 k, B, H, W, nH, shift, eps, n_parts, f(halo), halo_flags, CL, st);
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_stats_tc((bf)x1, (bf)x2, C1, C2, f(lnw), f(lnb), (bf)wqkv, (bf)wdw, pt, g,
                                  q, k, B, H, W, nH, shift, eps, n_parts, (bf)halo, halo_flags,
                                  CL, st);
}

// The parts per image a stats launch takes (0 on a device error): the
// blocks the card holds at once over B images, at most one per tile; CL the
// q|k width as mp_spectral_stats'.
extern "C" int mp_spectral_stats_parts(int dtype, int B, int H, int W, int C, int CL, int nH) {
  return mp::stats_launch_parts(dtype, B, H, W, C, CL, nH);
}

// comb [B][CL][C] (row: v channel h*dh + e, col: output channel; CL the v
// width: C, or a member's head block under the spectral mesh axis, whose
// output is its partial projection plus the epilogue, in both types and
// without the tail). gate (B,
// H/8, W/8, C) per-window gates of the rolled frame (gate_win 8), or (B, H,
// W, C) a per-pixel gate map (gate_win 1; a row shard's, as JAX's
// gate_map), shortcut (B, H, W, C),
// residual adds the raw input; dp (B,) float32 per-sample drop-path scales of
// the branch (NULL = none); w1 / w2 the PGSSTB tail (NULL = none). Output (B,
// H, W, C) in the unrolled frame.
// wqkv the v rows of the torch weight ([CL][C8], C8 = C rounded up to 8,
// zero past C; 16-byte aligned), wdw their depthwise taps ([CL][9]); the
// tail pack_mlp_weights' w1p [hidP/64][128][CK], w2p [CK][hidP] (16-byte
// aligned), all in the compute type.
// float32 (dtype 0): comb transposed, [B][C out][CL8 in] float32 (CL8 = CL
// rounded up to 8; 16-byte aligned; pack_front_f32).
// bf16 (dtype 1, C <= 384): comb bf16 [B][CL][C8] (16-byte aligned).
// halo, halo_flags: a row shard's halo rows, as mp_spectral_stats' (shift
// 0).
extern "C" int mp_spectral_apply(const void* x1, const void* x2, const void* lnw,
                                 const void* lnb, const void* wqkv, const void* wdw,
                                 const void* comb, const void* gate, const void* shortcut,
                                 const void* ln2w, const void* ln2b, const void* w1,
                                 const void* b1, const void* w2, const void* b2, const void* dp,
                                 void* out, const void* halo, int dtype, int B, int H, int W,
                                 int C1, int C2, int CL, int residual, int hid, int shift,
                                 float eps, int halo_flags, int gate_win, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || (gate_win != 1 && gate_win != mp::kTile))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_apply_f32(f(x1), f(x2), C1, C2, f(lnw), f(lnb), f(wqkv), f(wdw),
                                     f(comb), f(gate), f(shortcut), residual, f(ln2w), f(ln2b),
                                     f(w1), f(b1), f(w2), f(b2), hid, f(dp), (float*)out, B, H,
                                     W, shift, eps, f(halo), halo_flags, gate_win, CL, st);
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_apply_tc((bf)x1, (bf)x2, C1, C2, f(lnw), f(lnb), (bf)wqkv, (bf)wdw,
                                  (bf)comb, (bf)gate, (bf)shortcut, residual, f(ln2w), f(ln2b),
                                  (bf)w1, f(b1), (bf)w2, f(b2), hid, f(dp), (__nv_bfloat16*)out,
                                  B, H, W, shift, eps, (bf)halo, halo_flags, gate_win, CL, st);
}

// The device's opt-in shared-memory limit per block, in bytes.
extern "C" int mp_smem_optin() { return mp::smem_optin(); }

// Makes card `dev` this library's current device on the calling thread. The
// library links its own CUDA runtime, whose current device torch's
// torch.cuda.set_device does not move: the wrappers call this before they
// launch on a tensor of another card than the last one (_route.py).
extern "C" int mp_set_device(int dev) { return (int)cudaSetDevice(dev); }

// Shared-memory plans per block (bytes, static included) at a shape. CL is
// the q/k/v width of the call: C, or a member's head block.
// The float32 stats tile's (StatsF32Plan; no chunk): -1 past heads 96 wide.
extern "C" long long mp_spectral_stats_smem(int C, int CL, int nH) {
  const mp::StatsF32Plan pl(C, CL, nH);
  return pl.ok() ? mp::plan_bytes(mp::spectral_stats_f32_kernel, pl.bytes) : -1;
}

// The bf16 stats tile's plan (StatsPlan; no chunk).
extern "C" long long mp_spectral_stats_tc_smem(int C, int CL, int nH) {
  return mp::plan_bytes(mp::spectral_stats_tc_kernel, mp::StatsPlan(C, CL, nH).bytes);
}

// The apply plan takes the compute type (dtype 0 float32: ApplyF32Plan, 1
// bf16: FrontPlan); neither has a chunk.
extern "C" long long mp_spectral_apply_smem(int C, int CL, int tail, int dtype) {
  return mp::apply_plan_bytes(C, tail != 0, dtype != 0, CL);
}

extern "C" long long mp_spectral_stats_bwd_smem(int C, int CL, int nH) {
  return mp::plan_bytes(mp::spectral_stats_bwd_kernel<float>, mp::stats_bwd_smem(C, CL, nH));
}

// The bf16 stats backward's tiles (StatsBwdPlan at q|k width CL; DwDxPlan
// at C and K = 2CL for this route); -1 past C = 384.
extern "C" long long mp_spectral_stats_bwd_tc_smem(int C, int CL, int nH) {
  return C > mp::kFrontMaxC ? -1
                            : mp::plan_bytes(mp::spectral_stats_bwd_tc_kernel,
                                             mp::StatsBwdPlan(C, CL, nH).bytes);
}

extern "C" long long mp_dwconv_dx_tc_smem(int C, int K) {
  return C > mp::kTailMaxC ? -1
                           : mp::plan_bytes(mp::dwconv_dx_tc_kernel<true>,
                                            mp::DwDxPlan(C, K, true).bytes);
}

extern "C" long long mp_spectral_apply_bwd_smem(int C, int CL, int kc) {
  return mp::plan_bytes(mp::apply_bwd_kernel<float>(kc, C), mp::apply_bwd_smem(C, CL, kc));
}

// The channel chunk the apply backward kernel launches with at (C, CL).
extern "C" int mp_spectral_apply_bwd_chunk(int C, int CL) { return mp::apply_bwd_chunk(C, CL); }

// The float32 backward of mp_spectral_stats for one raw input (no x2; bf16
// runs mp_spectral_stats_bwd_tc and mp_dwconv_dx_tc). Inputs: x, LN, wqkv
// [C][3CL], wdw [9][3CL] as in the forward (CL: C, or a member's head
// block); dgram (B, CL, dh), dnq / dnk (B, nH, dh). Outputs, unrolled frame:
// un (B, H, W, C) the (LN'd) input, t (B, H, W, 2CL) the q|k 1x1 output, dqk
// (B, H, W, 2CL) the cotangent after the depthwise conv. A row shard (shift
// 0): hal [2][B][W][C] and halo_flags as mp_spectral_stats's; then un_halo
// [2][B][W][C] and t_halo [2][B][W][2CL] receive the (LN'd) input and the q|k 1x1 output of each real halo row (the
// other side's rows are not written). halo_flags 0: hal, un_halo and t_halo
// may be NULL.
extern "C" int mp_spectral_stats_bwd(const void* x, const void* lnw, const void* lnb,
                                     const void* wqkv, const void* wdw, const void* dgram,
                                     const void* dnq, const void* dnk, void* un, void* t,
                                     void* dqk, const void* hal, void* un_halo, void* t_halo,
                                     int B, int H, int W, int C, int CL, int nH, int shift,
                                     float eps, int halo_flags, void* stream) {
  if (CL % nH != 0 || CL <= 0 || CL > C || H % mp::kTile != 0 || W % mp::kTile != 0)
    return (int)cudaErrorInvalidValue;
  if (halo_flags != 0 && (hal == nullptr || un_halo == nullptr || t_halo == nullptr || shift != 0))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_stats_bwd<float>(x, f(lnw), f(lnb), wqkv, wdw, f(dgram), f(dnq), f(dnk),
                                          un, (float*)t, (float*)dqk, B, H, W, C, nH, shift, eps,
                                          f(hal), halo_flags, (float*)un_halo, (float*)t_halo, CL,
                                          (cudaStream_t)stream);
}

// The bf16 stats backward's first tile (C <= 384): x (B, H, W, C) bf16, LN
// float32 or NULL; wqk the q|k rows of the torch weight ([2CL][C8], 16-byte
// aligned) and taps [2CL][9] bf16 (the forward tile's operands; CL the q|k
// width: C, or a member's head block); dgram (B, CL, dh), dnq / dnk (B, nH,
// dh) float32. Outputs, unrolled frame, torch channel order: un (B, H, W, C)
// bf16, t (B, H, W, 2CL) bf16, dqk (B, H, W, 2CL) float32. A row shard
// (shift 0): hal [2][B][W][C] bf16 and halo_flags as mp_spectral_stats's;
// then un_halo [2][B][W][C] and t_halo [2][B][W][2CL] (bf16) receive the
// LN'd input and the q|k 1x1 output of each real halo row (the other side's
// rows are not written). halo_flags 0: all three may be NULL.
extern "C" int mp_spectral_stats_bwd_tc(const void* x, const void* lnw, const void* lnb,
                                        const void* wqk, const void* taps, const void* dgram,
                                        const void* dnq, const void* dnk, void* un, void* t,
                                        void* dqk, const void* hal, void* un_halo, void* t_halo,
                                        int B, int H, int W, int C, int CL, int nH, int shift,
                                        float eps, int halo_flags, void* stream) {
  if (CL % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0)
    return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  using bo = __nv_bfloat16*;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_stats_bwd_tc((bf)x, f(lnw), f(lnb), (bf)wqk, (bf)taps, f(dgram), f(dnq),
                                      f(dnk), (bo)un, (bo)t, (float*)dqk, B, H, W, C, nH, shift,
                                      eps, (bf)hal, halo_flags, (bo)un_halo, (bo)t_halo, CL,
                                      (cudaStream_t)stream);
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
// W, C) bf16, LN float32 or NULL; wv [CL][C8], taps [CL][9], comb
// [B][CL][C8] bf16 (pack_front's operands, wv and comb 16-byte aligned; CL
// the v width: C, or a member's head block); gate (B, H/8, W/8, C) bf16
// (gate_win 8; a gate map (B, H, W, C) at gate_win 1), dp (B,) float32, each
// NULL = none; dy (B, H, W, C) bf16, unrolled frame. Outputs, unrolled
// frame: un (B, H, W, C), t, v (B, H, W, CL) bf16, dys (dy * dp rounded, C
// wide; with dp only), dv (B, H, W, CL) float32, extra (B, H, W, C) float32
// (NULL without gate and residual), pdp (with dp: the d dp column of every
// tile's part row, row stride ldp). A row shard (shift 0): hal [2][B][W][C]
// bf16 and halo_flags as mp_spectral_apply's; then un_halo ([2][B][W][C])
// and t_halo ([2][B][W][CL], bf16) receive the LN'd input and the v 1x1
// output of each real halo row. halo_flags 0: all three may be NULL.
extern "C" int mp_spectral_apply_bwd_tc(const void* x, const void* lnw, const void* lnb,
                                        const void* wv, const void* taps, const void* comb,
                                        const void* gate, const void* dp, const void* dy, void* un,
                                        void* t, void* v, void* dys, void* dv, void* extra,
                                        void* pdp, const void* hal, void* un_halo, void* t_halo,
                                        int B, int H, int W, int C, int CL, int residual,
                                        int shift, int ldp, float eps, int halo_flags,
                                        int gate_win, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || (dp != nullptr) != (dys != nullptr) ||
      (gate_win != 1 && gate_win != mp::kTile))
    return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  using bo = __nv_bfloat16*;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_apply_bwd_tc((bf)x, f(lnw), f(lnb), (bf)wv, (bf)taps, (bf)comb, (bf)gate,
                                      f(dp), residual, (bf)dy, (bo)un, (bo)t, (bo)v, (bo)dys,
                                      (float*)dv, (float*)extra, (float*)pdp, ldp, B, H, W, C,
                                      shift, eps, (bf)hal, halo_flags, (bo)un_halo, (bo)t_halo,
                                      gate_win, CL, (cudaStream_t)stream);
}

// Its second tile (C <= 384): dv (B, H, W, CL) float32 and t bf16 (unrolled
// frame), taps and wv as the first tile's, x and lnw as its, extra (B, H, W,
// C) float32 or NULL (added to dx before it rounds). Outputs: dt (B, H, W,
// CL) bf16 unrolled frame, dx (B, H, W, C) bf16 x's frame, part rows (stride
// ldp): the tap partials [9][CL], then with LN d ln_w and d ln_b.
extern "C" int mp_spectral_apply_dx_tc(const void* dv, const void* t, const void* taps,
                                       const void* wv, const void* x, const void* lnw,
                                       const void* extra, void* dt, void* dx, void* part, int B,
                                       int H, int W, int C, int CL, int shift, int ldp, float eps,
                                       void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_apply_dx_tc((const float*)dv, (bf)t, (bf)taps, (bf)wv, (bf)x,
                                     (const float*)lnw, (const float*)extra, (__nv_bfloat16*)dt,
                                     (__nv_bfloat16*)dx, (float*)part, ldp, B, H, W, C, CL,
                                     shift, eps, (cudaStream_t)stream);
}

// d gate (B, H/8, W/8, C) float32 of the bf16 backward: per window of the
// rolled frame the sum of dys * x (dys (B, H, W, C) unrolled frame, x
// rolled); gate_win 1: d gate map (B, H, W, C), dys * x per pixel.
extern "C" int mp_spectral_gate_grad(const void* dys, const void* x, void* dgate, int B, int H,
                                     int W, int C, int shift, int gate_win, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || (gate_win != 1 && gate_win != mp::kTile))
    return (int)cudaErrorInvalidValue;
  mp::spectral_gate_grad_kernel<__nv_bfloat16>
      <<<dim3(W / gate_win, H / gate_win, B), 256, 0, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)dys, (const __nv_bfloat16*)x, (float*)dgate, H, W, C, shift,
          gate_win);
  return (int)cudaGetLastError();
}

// The bf16 apply backward's plans (bytes, static included) at v width CL:
// tile 1 (ApplyBwdPlan) or 2 (DwDxPlan at K = CL, its own instance); -1 past
// C = 384.
extern "C" long long mp_spectral_apply_bwd_tc_smem(int C, int CL, int tile) {
  if (C > mp::kFrontMaxC) return -1;
  return tile == 1 ? mp::plan_bytes(mp::spectral_apply_bwd_tc_kernel,
                                    mp::ApplyBwdPlan(C, CL).bytes)
                   : mp::plan_bytes(mp::dwconv_dx_tc_kernel<true, true>,
                                    mp::DwDxPlan(C, CL, true).bytes);
}

// The float32 backward of mp_spectral_apply without the MLP tail or x2 (bf16
// runs mp_spectral_apply_bwd_tc, mp_spectral_gate_grad and
// mp_spectral_apply_dx_tc). CL the v width (C, or a member's head block:
// wqkv [C][3CL], wdw [9][3CL], comb (B, CL, C); t, v and dv CL wide). dy (B,
// H, W, C) unrolled frame. Outputs, unrolled frame: un (LN'd input), t
// (float32 v 1x1 output), v, dys (dy *
// dp), dv (float32), extra (float32 input cotangent of the gate / residual
// epilogue; NULL when neither), pdp (per-tile d dp partials; NULL without
// dp), dgate (B, H/8, W/8, C) float32 (gate_win 8; at gate_win 1 gate and
// dgate are per-pixel maps (B, H, W, C)). kc: the channel chunk
// (mp_spectral_apply_bwd_chunk). A row shard (shift 0): hal [2][B][W][C]
// and halo_flags as mp_spectral_apply's; then un_halo [2][B][W][C] and
// t_halo [2][B][W][CL] receive the (LN'd) input and the v 1x1 output of each
// real halo row. halo_flags 0: hal, un_halo and t_halo may be NULL.
extern "C" int mp_spectral_apply_bwd(const void* x, const void* lnw, const void* lnb,
                                     const void* wqkv, const void* wdw, const void* comb,
                                     const void* gate, const void* dp, const void* dy, void* un,
                                     void* t, void* v, void* dys, void* dv, void* extra,
                                     void* pdp, void* dgate, const void* hal, void* un_halo,
                                     void* t_halo, int dtype, int B, int H, int W, int C, int CL,
                                     int residual, int shift, int kc, float eps, int halo_flags,
                                     int gate_win, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C || dtype != 0 ||
      (gate_win != 1 && gate_win != mp::kTile) || CL <= 0 || CL > C)
    return (int)cudaErrorInvalidValue;
  if (halo_flags != 0 && (hal == nullptr || un_halo == nullptr || t_halo == nullptr || shift != 0))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_apply_bwd<float>(x, f(lnw), f(lnb), wqkv, wdw, f(comb), gate, f(dp),
                                          residual, dy, un, (float*)t, v, dys, (float*)dv,
                                          (float*)extra, (float*)pdp, (float*)dgate, B, H, W, C,
                                          shift, kc, eps, f(hal), halo_flags, (float*)un_halo,
                                          (float*)t_halo, gate_win, CL, (cudaStream_t)stream);
}
