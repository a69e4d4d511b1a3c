// LayerNorm + 8x8 (shifted-)window multi-head self-attention + output
// projection + per-window means, over an NHWC map (mp_window_attention), and
// the same window MSA over window tokens without the LayerNorm
// (mp_window_msa).
//
// mp_window_attention replaces the TPU kernels _nhwc_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:198, K1) and the window half of
// _nhwc_sp0_kernel (:362, K3). The TPU kernel fuses the spectral phase-0
// statistics into this pass by running one slab behind; Hopper blocks run in
// no order and cannot read a neighbour's fresh output, so the statistics are a
// second launch here (spectral.cu, mp_spectral_stats).
//
// mp_window_msa replaces _kernel (pallas_attention.py:40, K14, host
// fused_window_attention :2339): (NW, 64, C) tokens, qkv and proj biases,
// per-token region labels tiled over the windows, knocked-out scores at -inf
// (not K1's -100). The TPU kernel flattens a block of windows into one T x T
// problem masked block-diagonally to suit Mosaic; here one block is one
// window, and the per-head code is K1's (window_msa_tile).
//
// One block = one 8x8 window. The (-shift, -shift) cyclic roll of shifted
// blocks is index arithmetic on the load; the output stays in the rolled
// frame, like the TPU kernel's shift_in path. Scores use an ordinary
// max-subtracted float32 softmax (the TPU kernel's unsubtracted, clipped exp2
// is a Mosaic workaround and is not copied). LN, softmax and every
// accumulation are float32; values are rounded to the compute type where the
// JAX kernels cast.
//
// Shared memory: the block keeps the heads' output [64][C+1], one head's
// q|k|v and the scores; the (normalised) input is staged in channel chunks of
// kc (pick_chunk): all C at once where that fits (every natural-scene width),
// 64 at C = 384 (245 KB whole, 166 KB chunked).
//
// Bound on this card: the qkv/proj products dominate (8C^2 + 256C flops per
// pixel against 4C bytes in and out), so tensor-core rate bounds it. bf16
// products run as mma.sync on the tensor cores, float32 ones as SIMT FMA
// (common.cuh gemm); PERF.md records the gap.
#include <math.h>

#include "common.cuh"

namespace mp {

// One window: q|k|v = xn Wqkv + bqkv per head, scores q k^T / sqrt(dh) + the
// relative-position bias, masked where the region labels differ (lab in shared
// memory, or nullptr: no mask) by -100 (neg_inf false) or -inf, softmax, o =
// p v; then y = o Wp + bp. load(xc, ld, c0, nc) stages input channels
// [c0, c0 + nc) into xc; store(ys, ld, n0, nn) takes output columns
// [n0, n0 + nn) (rounded to T) from ys. Both are called by every thread.
template <typename T, typename Load, typename Store>
__device__ __forceinline__ void window_msa_tile(float* sm, int C, int nH, int kc,
                                                const T* __restrict__ wqkv,
                                                const float* __restrict__ bqkv,
                                                const float* __restrict__ bias, const int* lab,
                                                bool neg_inf, const T* __restrict__ wp,
                                                const float* __restrict__ bp, Load load,
                                                Store store) {
  const int dh = C / nH, C3 = 3 * C;
  const int ldc = kc + 1, ldo = C + 1, ldq = 3 * dh + 1, lds = kPix + 1;
  float* xc = sm;                // [64][ldc] input chunk, later a projected chunk
  float* os = xc + kPix * ldc;   // [64][ldo] attention output, heads packed
  float* qkv = os + kPix * ldo;  // [64][ldq] q | k | v of one head
  float* s = qkv + kPix * ldq;   // [64][lds] scores / probabilities
  const bool resident = kc >= C;
  if (resident) {
    load(xc, ldc, 0, C);
    __syncthreads();
  }
  const float scale = rsqrtf((float)dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = 0; h < nH; ++h) {
    // q, k, v of head h: column j of section j / dh
    auto col = [&](int j) { const int sec = j / dh; return sec * C + h * dh + (j - sec * dh); };
    for (int c0 = 0; c0 < C; c0 += kc) {
      const int nc = min(kc, C - c0);
      if (!resident) {
        load(xc, ldc, c0, nc);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kPix, 3 * dh, nc,
          [&](int i, int k) { return xc[i * ldc + k]; },
          [&](int k, int j) { return to_f(wqkv[(size_t)(c0 + k) * C3 + col(j)]); },
          [&](int i, int j, float acc) {
            chunk_acc(qkv[i * ldq + j], acc, first, last,
                      [&](float v) { return rnd<T>(v + bqkv[col(j)]); });
          });
      __syncthreads();
    }
    gemm<T>(kPix, kPix, dh,
        [&](int i, int k) { return qkv[i * ldq + k]; },
        [&](int k, int j) { return qkv[j * ldq + dh + k]; },
        [&](int i, int j, float acc) {
          float v = acc * scale + bias[((size_t)h * kPix + i) * kPix + j];
          if (lab != nullptr && lab[i] != lab[j]) v = neg_inf ? -INFINITY : v - 100.f;
          s[i * lds + j] = v;
        });
    __syncthreads();
    for (int i = warp; i < kPix; i += blockDim.x >> 5) {
      float* row = s + i * lds;
      const float m = warp_max(fmaxf(row[lane], row[lane + 32]));
      const float e0 = expf(row[lane] - m), e1 = expf(row[lane + 32] - m);
      const float inv = 1.f / warp_sum(e0 + e1);
      row[lane] = rnd<T>(e0 * inv);
      row[lane + 32] = rnd<T>(e1 * inv);
    }
    __syncthreads();
    gemm<T>(kPix, dh, kPix,
        [&](int i, int k) { return s[i * lds + k]; },
        [&](int k, int j) { return qkv[k * ldq + 2 * dh + j]; },
        [&](int i, int j, float acc) { os[i * ldo + h * dh + j] = rnd<T>(acc); });
    __syncthreads();
  }

  // output projection in column chunks of kc, through xc
  for (int n0 = 0; n0 < C; n0 += kc) {
    const int nn = min(kc, C - n0);
    gemm<T>(kPix, nn, C,
        [&](int i, int k) { return os[i * ldo + k]; },
        [&](int k, int j) { return to_f(wp[(size_t)k * C + n0 + j]); },
        [&](int i, int j, float acc) { xc[i * ldc + j] = rnd<T>(acc + bp[n0 + j]); });
    __syncthreads();
    store(xc, ldc, n0, nn);
    __syncthreads();
  }
}

inline size_t window_smem(int C, int nH, int kc) {
  const int dh = C / nH;
  return sizeof(float) * (size_t)(kPix * (kc + 1) + kPix * (C + 1) + kPix * (3 * dh + 1) +
                                  kPix * (kPix + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                        const float* __restrict__ lnb, const T* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ bias,
                        const int* __restrict__ labels, const T* __restrict__ wp,
                        const float* __restrict__ bp, T* __restrict__ out,
                        T* __restrict__ pooled, int H, int W, int C, int nH, int shift,
                        float eps, int kc) {
  extern __shared__ float sm[];
  __shared__ int lab[kPix];
  __shared__ float mu[kPix], rs[kPix];
  const int wx = blockIdx.x, wy = blockIdx.y, b = blockIdx.z;
  // the window in the rolled frame: token (r, c) reads x[(r+shift)%H, (c+shift)%W]
  auto at = [&](int i, int k) {
    const int sr = (wy * kTile + (i >> 3) + shift) % H;
    const int sc = (wx * kTile + (i & 7) + shift) % W;
    return to_f(x[(((size_t)b * H + sr) * W + sc) * C + k]);
  };
  auto all = [](int) { return true; };
  ln_stats_rows(mu, rs, kPix, C, eps, at, all);
  if (threadIdx.x < kPix) {
    const int i = threadIdx.x;
    lab[i] = labels ? labels[(wy * kTile + (i >> 3)) * W + wx * kTile + (i & 7)] : 0;
  }
  __syncthreads();
  window_msa_tile<T>(
      sm, C, nH, kc, wqkv, bqkv, bias, labels ? lab : nullptr, false, wp, bp,
      [&](float* xc, int ld, int c0, int nc) {
        load_chunk<T>(xc, ld, kPix, c0, nc, at, all, mu, rs, lnw, lnb);
      },
      [&](const float* ys, int ld, int n0, int nn) {
        for (int idx = threadIdx.x; idx < kPix * nn; idx += blockDim.x) {
          const int i = idx / nn, j = idx - i * nn;
          out[tile_pix(b, wy, wx, i, H, W) * C + n0 + j] = from_f<T>(ys[i * ld + j]);
        }
        for (int j = threadIdx.x; j < nn; j += blockDim.x) {
          float sum = 0.f;
          for (int i = 0; i < kPix; ++i) sum += ys[i * ld + j];
          pooled[(((size_t)b * (H / kTile) + wy) * (W / kTile) + wx) * C + n0 + j] =
              from_f<T>(sum * (1.f / kPix));
        }
      });
}

// K14: window w's tokens are rows w*64 .. w*64+63 of x; its labels are row
// w % n_pat of labels (the pattern tiled over the windows), or none.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_msa_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const float* __restrict__ bias,
                  const int* __restrict__ labels, int n_pat, const T* __restrict__ wp,
                  const float* __restrict__ bp, T* __restrict__ out, int C, int nH, int kc) {
  extern __shared__ float sm[];
  __shared__ int lab[kPix];
  const size_t w = blockIdx.x;
  if (labels != nullptr && threadIdx.x < kPix)
    lab[threadIdx.x] = labels[(w % n_pat) * kPix + threadIdx.x];
  __syncthreads();
  auto at = [&](int i, int k) { return to_f(x[(w * kPix + i) * C + k]); };
  window_msa_tile<T>(
      sm, C, nH, kc, wqkv, bqkv, bias, labels ? lab : nullptr, true, wp, bp,
      [&](float* xc, int ld, int c0, int nc) {
        load_chunk<T>(xc, ld, kPix, c0, nc, at, [](int) { return true; }, nullptr, nullptr,
                      nullptr, nullptr);
      },
      [&](const float* ys, int ld, int n0, int nn) {
        for (int idx = threadIdx.x; idx < kPix * nn; idx += blockDim.x) {
          const int i = idx / nn, j = idx - i * nn;
          out[(w * kPix + i) * C + n0 + j] = from_f<T>(ys[i * ld + j]);
        }
      });
}

// The channel chunk of the window kernels at (C, nH): both kernels share a
// layout and a static footprint no larger than the first's.
inline int window_chunk(int C, int nH) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(window_attention_kernel<float>, window_smem(C, nH, kc));
  });
}

template <typename T>
cudaError_t launch_window(const void* x, const float* lnw, const float* lnb, const void* wqkv,
                          const float* bqkv, const float* bias, const int* labels,
                          const void* wp, const float* bp, void* out, void* pooled, int B,
                          int H, int W, int C, int nH, int shift, int kc, float eps,
                          cudaStream_t stream) {
  const size_t smem = window_smem(C, nH, kc);
  cudaError_t err = set_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(W / kTile, H / kTile, B);
  window_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)wqkv, bqkv, bias, labels, (const T*)wp, bp, (T*)out,
      (T*)pooled, H, W, C, nH, shift, eps, kc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_window_msa(const void* x, const void* wqkv, const float* bqkv,
                              const float* bias, const int* labels, int n_pat, const void* wp,
                              const float* bp, void* out, int NW, int C, int nH, int kc,
                              cudaStream_t stream) {
  const size_t smem = window_smem(C, nH, kc);
  cudaError_t err = set_smem(window_msa_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  window_msa_kernel<T><<<NW, kThreads, smem, stream>>>(
      (const T*)x, (const T*)wqkv, bqkv, bias, labels, n_pat, (const T*)wp, bp, (T*)out, C, nH,
      kc);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward (K8, replaces _win_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:539).
// One block = one window of the rolled frame. It recomputes LN(x) and, per
// head, q/k/v and the max-subtracted softmax A (the forward's -100 mask);
// dy gets the pooled-mean cotangent dpool / 64 on every token of its window.
// Per head: o = rnd(A) v (the saved-o of the TPU kernel, recomputed here),
// do = rnd(dy Wp^T), dA = do v^T, dS = A (dA - rowsum(A dA)), dq = dS k
// scale, dk = dS^T q scale, dv = rnd(A)^T do. It writes LN(x), o, the
// rounded dy, dqkv (all in the rolled frame) and per-window partials of the
// relative-bias and bp cotangents; grad.cu does the qkv/LN backward (rolling
// dx back) and the weight products.
// ---------------------------------------------------------------------------
//
// Shared memory: LN(x) and dy are staged whole where that fits (every
// natural-scene width, and C = 192 with 2 heads at 231 KB); at C = 384 with 8
// heads (280 KB whole) each pixel's LN mean and rstd stay in shared memory
// and both operands of the C-deep products (qkv, do) stream in channel chunks
// of kc, re-read per head (117 KB).
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                            const float* __restrict__ lnb, const T* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const float* __restrict__ bias,
                            const int* __restrict__ labels, const T* __restrict__ wp,
                            const T* __restrict__ dy, const T* __restrict__ dpool,
                            T* __restrict__ xn_out, T* __restrict__ o_out,
                            T* __restrict__ dyt_out, T* __restrict__ dqkv_out,
                            float* __restrict__ pbias, float* __restrict__ pbp, int H, int W,
                            int C, int nH, int shift, float eps, int kc) {
  extern __shared__ float sm[];
  __shared__ int lab[kPix];
  const int dh = C / nH, C3 = 3 * C;
  const int ldc = kc + 1, ldq = 3 * dh + 1, lds = kPix + 1, ldo = dh + 1;
  constexpr bool resident = !kStream;  // kc = C
  float* xs = sm;                // [64][ldc] LN(x): whole or a chunk
  float* dys = xs + kPix * ldc;  // [64][ldc] dy + dpool / 64, rounded: whole or a chunk
  float* qkv = dys + kPix * ldc; // [64][ldq] q | k | v of one head
  float* s = qkv + kPix * ldq;   // [64][lds] A
  float* d = s + kPix * lds;     // [64][lds] dA, then dS
  float* dos = d + kPix * lds;   // [64][ldo] do of one head (rounded)
  float* mu = dos + kPix * ldo;  // streamed: [64] LN mean, then [64] rstd
  float* rs = mu + kPix;
  const int wx = blockIdx.x, wy = blockIdx.y, b = blockIdx.z;
  const int win = (b * (H / kTile) + wy) * (W / kTile) + wx;
  auto fp = [&](int i) { return tile_pix(b, wy, wx, i, H, W); };  // rolled-frame pixel
  auto xat = [&](int i, int k) {
    const int sr = (wy * kTile + (i >> 3) + shift) % H, sc = (wx * kTile + (i & 7) + shift) % W;
    return to_f(x[(((size_t)b * H + sr) * W + sc) * C + k]);
  };
  auto dyat = [&](int i, int k) {
    return to_f(dy[fp(i) * C + k]) + to_f(dpool[(size_t)win * C + k]) * (1.f / kPix);
  };
  auto all = [](int) { return true; };

  if (threadIdx.x < kPix) {
    const int i = threadIdx.x;
    lab[i] = labels ? labels[(wy * kTile + (i >> 3)) * W + wx * kTile + (i & 7)] : 0;
  }
  if (resident) {
    for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
      const int i = idx / C, k = idx - i * C;
      xs[i * ldc + k] = xat(i, k);
      dys[i * ldc + k] = dyat(i, k);
    }
    __syncthreads();
    ln_rows_inplace<T>(xs, ldc, kPix, C, lnw, lnb, eps, all);
  } else {
    ln_stats_rows(mu, rs, kPix, C, eps, xat, all);
  }
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float sum = 0.f;
    for (int i = 0; i < kPix; ++i) sum += resident ? dys[i * ldc + k] : dyat(i, k);
    pbp[(size_t)win * C + k] = sum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    float v, xn;
    if (resident) {
      v = rnd<T>(dys[i * ldc + k]);
      dys[i * ldc + k] = v;
      xn = xs[i * ldc + k];
    } else {
      v = rnd<T>(dyat(i, k));
      xn = rnd<T>((xat(i, k) - mu[i]) * rs[i] * lnw[k] + lnb[k]);
    }
    dyt_out[fp(i) * C + k] = from_f<T>(v);
    xn_out[fp(i) * C + k] = from_f<T>(xn);
  }
  __syncthreads();

  const float scale = rsqrtf((float)dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = 0; h < nH; ++h) {
    auto qcol = [&](int j) { const int sec = j / dh; return sec * C + h * dh + (j - sec * dh); };
    for (int c0 = 0; c0 < C; c0 += kc) {  // q | k | v = LN(x) Wqkv + bqkv
      const int nc = min(kc, C - c0);
      if (!resident) {
        load_chunk<T>(xs, ldc, kPix, c0, nc, xat, all, mu, rs, lnw, lnb);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kPix, 3 * dh, nc,
          [&](int i, int k) { return xs[i * ldc + k]; },
          [&](int k, int j) { return to_f(wqkv[(size_t)(c0 + k) * C3 + qcol(j)]); },
          [&](int i, int j, float acc) {
            chunk_acc(qkv[i * ldq + j], acc, first, last,
                      [&](float v) { return rnd<T>(v + bqkv[qcol(j)]); });
          });
      __syncthreads();
    }
    gemm<T>(kPix, kPix, dh,
        [&](int i, int k) { return qkv[i * ldq + k]; },
        [&](int k, int j) { return qkv[j * ldq + dh + k]; },
        [&](int i, int j, float acc) {
          float v = acc * scale + bias[((size_t)h * kPix + i) * kPix + j];
          if (labels != nullptr && lab[i] != lab[j]) v -= 100.f;
          s[i * lds + j] = v;
        });
    // do = rnd(dy Wp^T) for this head's columns: do[i][j] = sum_o dy[i][o] Wp[h*dh + j][o]
    for (int c0 = 0; c0 < C; c0 += kc) {
      const int nc = min(kc, C - c0);
      if (!resident) {
        __syncthreads();  // the previous chunk's readers are done
        load_chunk<T>(dys, ldc, kPix, c0, nc, [&](int i, int k) { return rnd<T>(dyat(i, k)); },
                      all, nullptr, nullptr, nullptr, nullptr);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kPix, dh, nc,
          [&](int i, int k) { return dys[i * ldc + k]; },
          [&](int k, int j) { return to_f(wp[(size_t)(h * dh + j) * C + c0 + k]); },
          [&](int i, int j, float acc) {
            chunk_acc(dos[i * ldo + j], acc, first, last, [](float v) { return rnd<T>(v); });
          });
    }
    __syncthreads();
    for (int i = warp; i < kPix; i += kThreads / 32) {
      float* row = s + i * lds;
      const float m = warp_max(fmaxf(row[lane], row[lane + 32]));
      const float e0 = expf(row[lane] - m), e1 = expf(row[lane + 32] - m);
      const float inv = 1.f / warp_sum(e0 + e1);
      row[lane] = e0 * inv;
      row[lane + 32] = e1 * inv;
    }
    __syncthreads();
    gemm<T>(kPix, dh, kPix,  // o = rnd(A) v
        [&](int i, int k) { return rnd<T>(s[i * lds + k]); },
        [&](int k, int j) { return qkv[k * ldq + 2 * dh + j]; },
        [&](int i, int j, float acc) { o_out[fp(i) * C + h * dh + j] = from_f<T>(acc); });
    gemm<T>(kPix, kPix, dh,  // dA = do v^T
        [&](int i, int k) { return dos[i * ldo + k]; },
        [&](int k, int j) { return qkv[j * ldq + 2 * dh + k]; },
        [&](int i, int j, float acc) { d[i * lds + j] = acc; });
    __syncthreads();
    for (int i = warp; i < kPix; i += kThreads / 32) {
      const float* a = s + i * lds;
      float* g = d + i * lds;
      const float dot = warp_sum(a[lane] * g[lane] + a[lane + 32] * g[lane + 32]);
      const float v0 = a[lane] * (g[lane] - dot), v1 = a[lane + 32] * (g[lane + 32] - dot);
      g[lane] = v0;
      g[lane + 32] = v1;
      float* pb = pbias + (((size_t)win * nH + h) * kPix + i) * kPix;
      pb[lane] = v0;
      pb[lane + 32] = v1;
    }
    __syncthreads();
    T* dq = dqkv_out;
    gemm<T>(kPix, dh, kPix,  // dq = rnd(dS) k scale
        [&](int i, int k) { return rnd<T>(d[i * lds + k]); },
        [&](int k, int j) { return qkv[k * ldq + dh + j]; },
        [&](int i, int j, float acc) { dq[fp(i) * C3 + h * dh + j] = from_f<T>(acc * scale); });
    gemm<T>(kPix, dh, kPix,  // dk = rnd(dS)^T q scale
        [&](int i, int k) { return rnd<T>(d[k * lds + i]); },
        [&](int k, int j) { return qkv[k * ldq + j]; },
        [&](int i, int j, float acc) { dq[fp(i) * C3 + C + h * dh + j] = from_f<T>(acc * scale); });
    gemm<T>(kPix, dh, kPix,  // dv = rnd(A)^T do
        [&](int i, int k) { return rnd<T>(s[k * lds + i]); },
        [&](int k, int j) { return dos[k * ldo + j]; },
        [&](int i, int j, float acc) { dq[fp(i) * C3 + 2 * C + h * dh + j] = from_f<T>(acc); });
    __syncthreads();
  }
}

// The backward instance of a chunk: resident (LN(x) and dy whole) where kc
// covers C, a kernel of its own as the natural-scene widths' plan.
template <typename T>
inline auto window_bwd_kernel_for(int kc, int C) {
  return kc >= C ? window_attention_bwd_kernel<T, false> : window_attention_bwd_kernel<T, true>;
}

// kc = C: LN(x) and dy whole; kc < C: their chunks and the LN statistics.
inline size_t window_bwd_smem(int C, int nH, int kc) {
  const int dh = C / nH;
  const size_t n = (size_t)(2 * kPix * (kc + 1) + kPix * (3 * dh + 1) + 2 * kPix * (kPix + 1) +
                            kPix * (dh + 1));
  return sizeof(float) * (kc >= C ? n : n + 2 * kPix);
}

inline int window_bwd_chunk(int C, int nH) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(window_bwd_kernel_for<float>(kc, C), window_bwd_smem(C, nH, kc));
  });
}

template <typename T>
cudaError_t launch_window_bwd(const void* x, const float* lnw, const float* lnb,
                              const void* wqkv, const float* bqkv, const float* bias,
                              const int* labels, const void* wp, const void* dy,
                              const void* dpool, void* xn, void* o, void* dyt, void* dqkv,
                              float* pbias, float* pbp, int B, int H, int W, int C, int nH,
                              int shift, int kc, float eps, cudaStream_t stream) {
  const size_t smem = window_bwd_smem(C, nH, kc);
  const auto kernel = window_bwd_kernel_for<T>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)wqkv, bqkv, bias, labels, (const T*)wp, (const T*)dy,
      (const T*)dpool, (T*)xn, (T*)o, (T*)dyt, (T*)dqkv, pbias, pbp, H, W, C, nH, shift, eps, kc);
  return cudaGetLastError();
}

}  // namespace mp

// dtype: 0 = float32, 1 = bfloat16. Weights are [in][out] in the compute
// type; LN, biases and the (nH, 64, 64) relative-position bias are float32;
// labels is the (H, W) int32 shift-region map or NULL; kc the channel chunk
// (mp_window_chunk).
extern "C" int mp_window_attention(const void* x, const void* lnw, const void* lnb,
                                   const void* wqkv, const void* bqkv, const void* bias,
                                   const void* labels, const void* wp, const void* bp,
                                   void* out, void* pooled, int dtype, int B, int H, int W,
                                   int C, int nH, int shift, int kc, float eps, void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_window<float>(x, (const float*)lnw, (const float*)lnb, wqkv,
                                         (const float*)bqkv, (const float*)bias,
                                         (const int*)labels, wp, (const float*)bp, out, pooled,
                                         B, H, W, C, nH, shift, kc, eps, st);
  return (int)mp::launch_window<__nv_bfloat16>(x, (const float*)lnw, (const float*)lnb, wqkv,
                                               (const float*)bqkv, (const float*)bias,
                                               (const int*)labels, wp, (const float*)bp, out,
                                               pooled, B, H, W, C, nH, shift, kc, eps, st);
}

// K14. x (NW, 64, C) window tokens; wqkv [C][3C], wp [C][C] in the compute
// type; bqkv, bp, the (nH, 64, 64) bias float32; labels (n_pat, 64) int32
// region labels tiled over the windows (NW % n_pat == 0) or NULL. Output
// (NW, 64, C). kc: the channel chunk (mp_window_chunk).
extern "C" int mp_window_msa(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                             const void* labels, const void* wp, const void* bp, void* out,
                             int dtype, int NW, int C, int nH, int n_pat, int kc, void* stream) {
  if (C % nH != 0 || (labels != nullptr && (n_pat <= 0 || NW % n_pat != 0)) || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_window_msa<float>(x, wqkv, f(bqkv), f(bias), (const int*)labels, n_pat,
                                             wp, f(bp), out, NW, C, nH, kc, st);
  return (int)mp::launch_window_msa<__nv_bfloat16>(x, wqkv, f(bqkv), f(bias), (const int*)labels,
                                                   n_pat, wp, f(bp), out, NW, C, nH, kc, st);
}

// The channel chunk both window kernels launch with at (C, nH).
extern "C" int mp_window_chunk(int C, int nH) { return mp::window_chunk(C, nH); }

// Shared-memory plans per block (bytes, static included) at a shape and
// channel chunk kc.
extern "C" long long mp_window_attention_smem(int C, int nH, int kc) {
  return mp::plan_bytes(mp::window_attention_kernel<float>, mp::window_smem(C, nH, kc));
}

extern "C" long long mp_window_msa_smem(int C, int nH, int kc) {
  return mp::plan_bytes(mp::window_msa_kernel<float>, mp::window_smem(C, nH, kc));
}

extern "C" long long mp_window_attention_bwd_smem(int C, int nH, int kc) {
  return mp::plan_bytes(mp::window_bwd_kernel_for<float>(kc, C), mp::window_bwd_smem(C, nH, kc));
}

// The channel chunk the backward kernel launches with at (C, nH).
extern "C" int mp_window_attention_bwd_chunk(int C, int nH) { return mp::window_bwd_chunk(C, nH); }

// The per-window half of the window-attention backward. dy (B, H, W, C) in
// the rolled frame, dpool (B, H/8, W/8, C). Outputs, rolled frame, compute
// type: xn = LN(x), o (pre-projection attention output), dyt (dy + dpool/64),
// dqkv (B, H, W, 3C); float32 partials pbias (windows, nH, 64, 64) and pbp
// (windows, C). kc: the channel chunk (mp_window_attention_bwd_chunk).
extern "C" int mp_window_attention_bwd(const void* x, const void* lnw, const void* lnb,
                                       const void* wqkv, const void* bqkv, const void* bias,
                                       const void* labels, const void* wp, const void* dy,
                                       const void* dpool, void* xn, void* o, void* dyt,
                                       void* dqkv, void* pbias, void* pbp, int dtype, int B,
                                       int H, int W, int C, int nH, int shift, int kc, float eps,
                                       void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_window_bwd<float>(x, f(lnw), f(lnb), wqkv, f(bqkv), f(bias),
                                             (const int*)labels, wp, dy, dpool, xn, o, dyt, dqkv,
                                             (float*)pbias, (float*)pbp, B, H, W, C, nH, shift,
                                             kc, eps, st);
  return (int)mp::launch_window_bwd<__nv_bfloat16>(x, f(lnw), f(lnb), wqkv, f(bqkv), f(bias),
                                                   (const int*)labels, wp, dy, dpool, xn, o, dyt,
                                                   dqkv, (float*)pbias, (float*)pbp, B, H, W, C,
                                                   nH, shift, kc, eps, st);
}
