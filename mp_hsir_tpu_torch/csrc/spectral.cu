// Spectral (C x C transposed, MDTA) attention over an NHWC map, in two
// launches around a small fold done in PyTorch:
//
//   mp_spectral_stats  q, k = dw3x3(1x1([LN] x)); per-head Gram q^T k and the
//                      squared norms of q and k, summed over all pixels
//                      (bf16: the tensor-core tile of spectral_stats.cuh;
//                      float32: spectral_stats_kernel below).
//   (fold, PyTorch)    comb = softmax(Gram / (|q| |k|) * temp) folded with the
//                      output projection into one C x C matrix.
//   mp_spectral_apply  v = dw3x3(1x1([LN] x)); out = v @ comb plus the
//                      epilogue: [x * gate] [+ x] [+ shortcut], then optionally
//                      the PGSSTB tail out + fc2(a * gelu(g)), [a|g] = fc1(LN2(out))
//                      (bf16: the tensor-core tile of spectral_front.cuh with
//                      the tail tile of mlp_tail.cuh after it; float32:
//                      spectral_apply_kernel below with common.cuh mlp_tail_tile).
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
// tensor cores, float32 ones as SIMT FMA (common.cuh gemm; PERF.md); the bf16
// stats and apply launches run their own tiles (spectral_stats.cuh,
// spectral_front.cuh).
#include "spectral_stats.cuh"

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

// The float32 stats kernel. Shared memory: the halo input is staged in
// channel chunks of kc (all C at once where that fits: every natural-scene
// width). Plans at the remote-sensing widths: C = 384, dh 48 and C = 192, dh
// 96 stage 64 channels. Part `ipart` of image b walks tiles [ipart T / P,
// (ipart + 1) T / P) and writes its Gram and norm sums to part[b][ipart].
template <typename T>
__global__ void __launch_bounds__(kThreads)
spectral_stats_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int C1, int C2,
                      const float* __restrict__ lnw, const float* __restrict__ lnb,
                      const T* __restrict__ wqkv, const T* __restrict__ wdw, int H, int W,
                      int nH, int shift, float eps, float* __restrict__ part, int kc) {
  extern __shared__ float sm[];
  __shared__ float mu[kHaloPix], rs[kHaloPix];
  const int C = C1 + C2, C3 = 3 * C, dh = C / nH;
  const int ldc = kc + 1, ldt = 2 * dh + 1;
  float* xc = sm;                     // [100][ldc] halo input chunk
  float* ts = xc + kHaloPix * ldc;    // [100][ldt] 1x1 output, q|k of one head
  float* qk = ts + kHaloPix * ldt;    // [64][ldt] q|k after the dwconv
  float* gacc = qk + kPix * ldt;      // [C*dh] Gram partial, [h][d][e]
  float* nacc = gacc + C * dh;        // [2C] |q|^2, |k|^2 partials
  const int ipart = blockIdx.x, b = blockIdx.y, n_parts = gridDim.x;
  const int tiles_w = W / kTile, n_tiles = (H / kTile) * tiles_w;
  const bool resident = kc >= C;

  for (int i = threadIdx.x; i < C * dh; i += blockDim.x) gacc[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) nacc[i] = 0.f;

  const int t1 = (int)((long long)(ipart + 1) * n_tiles / n_parts);
  for (int t = (int)((long long)ipart * n_tiles / n_parts); t < t1; ++t) {
    const Halo<T> hl{x1, x2, C1, C2, b, t / tiles_w, t % tiles_w, H, W, shift};
    __syncthreads();
    if (lnw != nullptr) {
      halo_stats(mu, rs, hl, eps);
      __syncthreads();
    }
    if (resident) {
      halo_chunk(xc, ldc, hl, 0, C, mu, rs, lnw, lnb);
      __syncthreads();
    }
    for (int h = 0; h < nH; ++h) {
      // column j < dh: q channel h*dh + j; j >= dh: k channel C + h*dh + j - dh
      auto col = [&](int j) { return j < dh ? h * dh + j : C + h * dh + (j - dh); };
      for (int c0 = 0; c0 < C; c0 += kc) {
        const int nc = min(kc, C - c0);
        if (!resident) {
          halo_chunk(xc, ldc, hl, c0, nc, mu, rs, lnw, lnb);
          __syncthreads();
        }
        const bool first = c0 == 0, last = c0 + nc >= C;
        gemm<T>(kHaloPix, 2 * dh, nc,
            [&](int i, int k) { return xc[i * ldc + k]; },
            [&](int k, int j) { return to_f(wqkv[(size_t)(c0 + k) * C3 + col(j)]); },
            [&](int i, int j, float acc) {
              chunk_acc(ts[i * ldt + j], acc, first, last, [](float v) { return rnd<T>(v); });
            });
        __syncthreads();
      }
      dwconv3_tile(ts, ldt, 2 * dh,
          [&](int tap, int j) { return to_f(wdw[tap * C3 + col(j)]); },
          [&](int p, int j, float acc) { qk[p * ldt + j] = rnd<T>(acc); });
      __syncthreads();
      // this tile's Gram: G[d][e] += sum_p q[p][d] k[p][e]; the owner of each
      // entry is the same thread on every tile, so the sum order is fixed
      gemm<T>(dh, dh, kPix,
          [&](int d, int p) { return qk[p * ldt + d]; },
          [&](int p, int e) { return qk[p * ldt + dh + e]; },
          [&](int d, int e, float acc) { gacc[(h * dh + d) * dh + e] += acc; });
      for (int j = threadIdx.x; j < 2 * dh; j += blockDim.x) {
        float n = 0.f;
        for (int p = 0; p < kPix; ++p) n = fmaf(qk[p * ldt + j], qk[p * ldt + j], n);
        nacc[(j < dh ? 0 : C) + h * dh + (j < dh ? j : j - dh)] += n;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // the Gram, then |q|^2 and |k|^2 (nacc follows gacc)
  float* out = part + ((size_t)b * n_parts + ipart) * (C * dh + 2 * C);
  for (int i = threadIdx.x; i < C * dh + 2 * C; i += blockDim.x) out[i] = gacc[i];
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
constexpr int kHCw = 32;  // tail hidden chunk when it is streamed (C = 384: 226 KB at kc 64)

// The float32 apply kernel's plan (and the apply backward's): the halo input
// chunk xc [100][kc+1] and the v 1x1 chunk vt [100][nv+1] share one region
// with the output y [64][C+1] (y is written after the v stage); vs [64][C+1]
// holds v, later LN2(y); hb holds the tail's hidden chunk. Resident (kc = C):
// the natural-scene layout, a kernel instance of its own whose chunks are
// compile-time constants. The bf16 apply kernel has its own plan (FrontPlan).
struct ApplyPlan {
  int kc, nv, khc;
  __host__ __device__ size_t front(int C) const {
    const size_t stage = (size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (nv + 1);
    const size_t y = (size_t)kPix * (C + 1);
    return stage > y ? stage : y;
  }
  __host__ __device__ size_t floats(int C, bool tail) const {
    return front(C) + (size_t)kPix * (C + 1) + (tail ? (size_t)kPix * (2 * khc + 1) : 0);
  }
};

template <bool kStream>
__host__ __device__ inline ApplyPlan apply_plan(int kc, int C) {
  return kStream ? ApplyPlan{kc, kVCw, kHCw} : ApplyPlan{C, kVC, kHC};
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
                      int shift, float eps, int kc) {
  extern __shared__ float sm[];
  __shared__ float mu[kHaloPix], rs[kHaloPix];
  const int C = C1 + C2, C3 = 3 * C;
  const ApplyPlan plan = apply_plan<kStream>(kc, C);
  const int ldc = plan.kc + 1, ldx = C + 1, ldv = plan.nv + 1;
  float* xc = sm;                       // [100][ldc] halo input chunk
  float* vt = xc + kHaloPix * ldc;      // [100][ldv] 1x1 output chunk
  float* y = sm;                        // [64][ldx] output (after the v stage)
  float* vs = sm + plan.front(C);       // [64][ldx] v; later LN2(y)
  float* hb = vs + kPix * ldx;          // [64][2*khc+1] MLP hidden chunk
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
        y[i * ldx + j] = v;
      });
  __syncthreads();
  if (w1 != nullptr) {
    mlp_tail_tile<T>(y, vs, ldx, hb, C, hid, ln2w, ln2b, w1, b1, w2, b2, eps, false, plan.khc);
  }

  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
    out[(((size_t)b * H + r) * W + c) * C + k] = from_f<T>(y[i * ldx + k]);
  }
}

inline size_t stats_smem(int C, int nH, int kc) {
  const int dh = C / nH;
  return sizeof(float) * ((size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (2 * dh + 1) +
                          (size_t)kPix * (2 * dh + 1) + (size_t)C * dh + 2 * C);
}

inline size_t apply_smem(int C, bool tail, int kc) {
  const ApplyPlan plan = kc >= C ? apply_plan<false>(kc, C) : apply_plan<true>(kc, C);
  return sizeof(float) * plan.floats(C, tail);
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

inline int stats_chunk(int C, int nH) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(spectral_stats_kernel<float>, stats_smem(C, nH, kc));
  });
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

// The parts per image of a launch (dtype 0: float32 at chunk kc; 1: the bf16
// tile).
inline int stats_launch_parts(int dtype, int B, int H, int W, int C, int nH, int kc) {
  const int n_tiles = (H / kTile) * (W / kTile);
  if (dtype == 0)
    return stats_parts(spectral_stats_kernel<float>, kThreads, stats_smem(C, nH, kc), B, n_tiles);
  return stats_parts(spectral_stats_tc_kernel, kThreads, StatsPlan(C, nH).bytes, B, n_tiles);
}

cudaError_t launch_sum_stats(const float* part, float* gram, float* nq, float* nk, int B,
                             int n_parts, int C, int dh, cudaStream_t stream) {
  const int m = C * dh + 2 * C;
  sum_stats_kernel<<<dim3(min(ceil_div(m, kThreads), 1024), B), kThreads, 0, stream>>>(
      part, gram, nq, nk, n_parts, C * dh, C);
  return cudaGetLastError();
}

cudaError_t launch_stats(const float* x1, const float* x2, int C1, int C2, const float* lnw,
                         const float* lnb, const float* wqkv, const float* wdw, float* part,
                         float* gram, float* nq, float* nk, int B, int H, int W, int nH,
                         int shift, float eps, int n_parts, int kc, cudaStream_t stream) {
  const int C = C1 + C2;
  const size_t smem = stats_smem(C, nH, kc);
  cudaError_t err = set_smem(spectral_stats_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  spectral_stats_kernel<float><<<dim3(n_parts, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqkv, wdw, H, W, nH, shift, eps, part, kc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_stats(part, gram, nq, nk, B, n_parts, C, C / nH, stream);
}

inline bool aligned(const void* p, int n) { return (uintptr_t)p % n == 0; }

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
  const size_t smem = apply_smem(C, w1 != nullptr, kc);
  const auto kernel = apply_kernel(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x1, x2, C1, C2, lnw, lnb, wqkv, wdw, comb, gate, shortcut, residual, ln2w, ln2b, w1, b1, w2,
      b2, hid, dp, out, H, W, shift, eps, kc);
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

// VJP of the stats launch (K10a): dq = k dG^T + 2 q dnq, dk = q dG + 2 k dnk
// per head, dG rounded to T as _sp0_bwd_kernel does.
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

// VJP of the apply launch without the MLP tail (K10b): v recomputed; dys =
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
// cat(x1, x2); optional LN (float32, over C1 + C2). float32 (dtype 0): wqkv
// [C][3C] and wdw [9][3C] ([in][out] copies), kc the channel chunk
// (mp_spectral_stats_chunk). bf16 (dtype 1, C <= 384): wqkv the q|k rows of
// the torch weight ([2C][C8], C8 = C rounded up to 8, zero past C; 16-byte
// aligned), wdw their depthwise taps ([2C][9]); kc is C.
// Partial buffer part [B][n_parts][C*dh + 2C] (n_parts from
// mp_spectral_stats_parts). Outputs (float32): gram [B][C][dh] (row h*dh + d,
// col e), nq and nk [B][nH][dh].
extern "C" int mp_spectral_stats(const void* x1, const void* x2, const void* lnw,
                                 const void* lnb, const void* wqkv, const void* wdw, void* part,
                                 void* gram, void* nq, void* nk, int dtype, int B, int H, int W,
                                 int C1, int C2, int nH, int shift, float eps, int n_parts, int kc,
                                 void* stream) {
  if ((C1 + C2) % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 ||
      kc > C1 + C2 || n_parts <= 0)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  float *pt = (float*)part, *g = (float*)gram, *q = (float*)nq, *k = (float*)nk;
  if (dtype == 0)
    return (int)mp::launch_stats(f(x1), f(x2), C1, C2, f(lnw), f(lnb), f(wqkv), f(wdw), pt, g, q,
                                 k, B, H, W, nH, shift, eps, n_parts, kc, st);
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_stats_tc((bf)x1, (bf)x2, C1, C2, f(lnw), f(lnb), (bf)wqkv, (bf)wdw, pt, g,
                                  q, k, B, H, W, nH, shift, eps, n_parts, st);
}

// The parts per image a stats launch takes (0 on a device error): the
// blocks the card holds at once over B images, at most one per tile.
extern "C" int mp_spectral_stats_parts(int dtype, int B, int H, int W, int C, int nH, int kc) {
  return mp::stats_launch_parts(dtype, B, H, W, C, nH, kc);
}

// comb [B][C][C] (row: v channel h*dh + e, col: output channel). gate (B,
// H/8, W/8, C) per-window gates of the rolled frame, shortcut (B, H, W, C),
// residual adds the raw input; dp (B,) float32 per-sample drop-path scales of
// the branch (NULL = none); w1 / w2 the PGSSTB tail (NULL = none). Output (B,
// H, W, C) in the unrolled frame.
// float32 (dtype 0): wqkv [C][3C], wdw [9][3C] ([in][out] copies), comb
// float32, tail w1 [C][2*hid], w2 [hid][C]; kc the channel chunk
// (mp_spectral_apply_chunk; kc = C is the resident instance).
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

// The channel chunks the stats and apply kernels launch with at a shape.
extern "C" int mp_spectral_stats_chunk(int C, int nH) { return mp::stats_chunk(C, nH); }

extern "C" int mp_spectral_apply_chunk(int C, int tail, int dtype) {
  return mp::apply_chunk(C, tail != 0, dtype != 0);
}

// Shared-memory plans per block (bytes, static included) at a shape and
// channel chunk kc.
extern "C" long long mp_spectral_stats_smem(int C, int nH, int kc) {
  return mp::plan_bytes(mp::spectral_stats_kernel<float>, mp::stats_smem(C, nH, kc));
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

extern "C" long long mp_spectral_apply_bwd_smem(int C, int kc) {
  return mp::plan_bytes(mp::apply_bwd_kernel<float>(kc, C), mp::apply_bwd_smem(C, kc));
}

// The channel chunk the apply backward kernel launches with at C.
extern "C" int mp_spectral_apply_bwd_chunk(int C) { return mp::apply_bwd_chunk(C); }

// Backward of mp_spectral_stats for one raw input (no x2). Inputs: x, LN,
// wqkv [C][3C], wdw [9][3C] as in the forward; dgram (B, C, dh), dnq / dnk
// (B, nH, dh) float32. Outputs, unrolled frame: un (B, H, W, C) the (LN'd)
// input, t (B, H, W, 2C) float32 the q|k 1x1 output, dqk (B, H, W, 2C)
// float32 the cotangent after the depthwise conv.
extern "C" int mp_spectral_stats_bwd(const void* x, const void* lnw, const void* lnb,
                                     const void* wqkv, const void* wdw, const void* dgram,
                                     const void* dnq, const void* dnk, void* un, void* t,
                                     void* dqk, int dtype, int B, int H, int W, int C, int nH,
                                     int shift, float eps, void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_stats_bwd<float>(x, f(lnw), f(lnb), wqkv, wdw, f(dgram), f(dnq),
                                            f(dnk), un, (float*)t, (float*)dqk, B, H, W, C, nH,
                                            shift, eps, st);
  return (int)mp::launch_stats_bwd<__nv_bfloat16>(x, f(lnw), f(lnb), wqkv, wdw, f(dgram), f(dnq),
                                                  f(dnk), un, (float*)t, (float*)dqk, B, H, W, C,
                                                  nH, shift, eps, st);
}

// Backward of mp_spectral_apply without the MLP tail or x2. dy (B, H, W, C)
// unrolled frame. Outputs, unrolled frame: un (LN'd input), t (float32 v 1x1
// output), v, dys (dy * dp, rounded), dv (float32), extra (float32 input
// cotangent of the gate / residual epilogue; NULL when neither), pdp
// (per-tile d dp partials; NULL without dp), dgate (B, H/8, W/8, C) float32.
// kc: the channel chunk (mp_spectral_apply_bwd_chunk).
extern "C" int mp_spectral_apply_bwd(const void* x, const void* lnw, const void* lnb,
                                     const void* wqkv, const void* wdw, const void* comb,
                                     const void* gate, const void* dp, const void* dy, void* un,
                                     void* t, void* v, void* dys, void* dv, void* extra,
                                     void* pdp, void* dgate, int dtype, int B, int H, int W,
                                     int C, int residual, int shift, int kc, float eps,
                                     void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_apply_bwd<float>(x, f(lnw), f(lnb), wqkv, wdw, f(comb), gate, f(dp),
                                            residual, dy, un, (float*)t, v, dys, (float*)dv,
                                            (float*)extra, (float*)pdp, (float*)dgate, B, H, W,
                                            C, shift, kc, eps, st);
  return (int)mp::launch_apply_bwd<__nv_bfloat16>(x, f(lnw), f(lnb), wqkv, wdw, f(comb), gate,
                                                  f(dp), residual, dy, un, (float*)t, v, dys,
                                                  (float*)dv, (float*)extra, (float*)pdp,
                                                  (float*)dgate, B, H, W, C, shift, kc, eps, st);
}
