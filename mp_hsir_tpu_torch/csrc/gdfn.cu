// LayerNorm + gated depthwise-conv feed-forward network (Restormer GDFN) over
// an NHWC map: LN -> 1x1 (C -> 2*hidden) -> 3x3 depthwise -> gelu(x1) * x2 ->
// 1x1 (hidden -> C) [+ x] [-> trailing 1x1 (C -> Co), PromptFusion's exit conv].
//
// Replaces _gdfn_kernel (mp_hsir_tpu/ops/pallas_attention.py:1274, K5). As
// there, the halo rows are zeroed after the LayerNorm (LN(0) = bias != 0), the
// 1x1 output and the depthwise taps stay float32, and the gated product is
// rounded to the compute type before project_out. GELU is the exact erf form
// (the TPU kernel's polynomial is a Mosaic workaround, 1.5e-6 from it).
//
// One block = one 8x8 tile; the hidden width is walked in chunks of 32 units
// of each half, so the 2*hidden-wide intermediate never leaves shared memory.
// Bound on this card: 6*C*hidden + 2*C*Co flops per pixel (plus the halo
// recompute) against (C + Co) elements of traffic: tensor-core rate bounds
// it. bf16 products run as mma.sync, float32 ones as SIMT FMA (common.cuh
// gemm; PERF.md).
#include "common.cuh"

namespace mp {

constexpr int kGC = 32;  // hidden chunk

// Shared memory: the LN'd halo is staged in channel chunks of kc (all C at
// once where that fits: every natural-scene width; 64 at C = 384, where the
// whole halo makes the plan 280 KB).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gdfn_kernel(const T* __restrict__ x, const float* __restrict__ lnw, const float* __restrict__ lnb,
            const T* __restrict__ win, const T* __restrict__ wdw, const T* __restrict__ wout,
            const T* __restrict__ wproj, int Co, int residual, T* __restrict__ out, int H, int W,
            int C, int hid, float eps, int kc) {
  extern __shared__ float sm[];
  __shared__ float mu[kHaloPix], rs[kHaloPix];
  const int ldc = kc + 1, ldx = C + 1, ldt = 2 * kGC + 1, ldg = kGC + 1;
  float* xc = sm;                    // [100][ldc] LN(x) halo chunk
  float* ts = xc + kHaloPix * ldc;   // [100][ldt] project_in chunk: x1 | x2
  float* gs = ts + kHaloPix * ldt;   // [64][ldg] gelu(x1) * x2
  float* acc = gs + kPix * ldg;      // [64][ldx] project_out accumulator
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int H2 = 2 * hid;
  const bool resident = kc >= C;

  auto inside = [&](int p) {
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    return r >= 0 && r < H && c >= 0 && c < W;
  };
  auto at = [&](int p, int k) {
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    return to_f(x[(((size_t)b * H + r) * W + c) * C + k]);
  };
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int p = idx / C, k = idx - p * C;
    acc[p * ldx + k] = 0.f;
  }
  ln_stats_rows(mu, rs, kHaloPix, C, eps, at, inside);
  __syncthreads();
  if (resident) {
    load_chunk<T>(xc, ldc, kHaloPix, 0, C, at, inside, mu, rs, lnw, lnb);
    __syncthreads();
  }

  for (int j0 = 0; j0 < hid; j0 += kGC) {
    const int hc = min(kGC, hid - j0);
    // column j < hc: x1 unit j0 + j; j >= hc: x2 unit hid + j0 + j - hc
    auto col = [&](int j) { return j < hc ? j0 + j : hid + j0 + (j - hc); };
    for (int c0 = 0; c0 < C; c0 += kc) {
      const int nc = min(kc, C - c0);
      if (!resident) {
        load_chunk<T>(xc, ldc, kHaloPix, c0, nc, at, inside, mu, rs, lnw, lnb);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kHaloPix, 2 * hc, nc,
          [&](int i, int k) { return xc[i * ldc + k]; },
          [&](int k, int j) { return to_f(win[(size_t)(c0 + k) * H2 + col(j)]); },
          [&](int i, int j, float a) {
            chunk_acc(ts[i * ldt + (j < hc ? j : kGC + j - hc)], a, first, last,
                      [](float v) { return v; });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * hc; idx += blockDim.x) {
      const int p = idx / hc, j = idx - p * hc;
      const int pr = p >> 3, pc = p & 7;
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* t = ts + ((pr + dy) * kHalo + pc + dx) * ldt;
          const int tap = dy * 3 + dx;
          a1 = fmaf(t[j], to_f(wdw[tap * H2 + j0 + j]), a1);
          a2 = fmaf(t[kGC + j], to_f(wdw[tap * H2 + hid + j0 + j]), a2);
        }
      gs[p * ldg + j] = rnd<T>(gelu_erf(a1) * a2);
    }
    __syncthreads();
    gemm<T>(kPix, C, hc,
        [&](int i, int k) { return gs[i * ldg + k]; },
        [&](int k, int j) { return to_f(wout[(size_t)(j0 + k) * C + j]); },
        [&](int i, int j, float a) { acc[i * ldx + j] += a; });
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int p = idx / C, k = idx - p * C;
    float v = acc[p * ldx + k];
    if (residual) {
      const int r = ty * kTile + (p >> 3), c = tx * kTile + (p & 7);
      v += to_f(x[(((size_t)b * H + r) * W + c) * C + k]);
    }
    acc[p * ldx + k] = rnd<T>(v);
  }
  __syncthreads();
  if (wproj != nullptr) {
    gemm<T>(kPix, Co, C,
        [&](int i, int k) { return acc[i * ldx + k]; },
        [&](int k, int j) { return to_f(wproj[(size_t)k * Co + j]); },
        [&](int i, int j, float a) {
          const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
          out[(((size_t)b * H + r) * W + c) * Co + j] = from_f<T>(a);
        });
  } else {
    for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
      const int p = idx / C, k = idx - p * C;
      const int r = ty * kTile + (p >> 3), c = tx * kTile + (p & 7);
      out[(((size_t)b * H + r) * W + c) * C + k] = from_f<T>(acc[p * ldx + k]);
    }
  }
}

inline size_t gdfn_smem(int C, int kc) {
  return sizeof(float) * ((size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (2 * kGC + 1) +
                          (size_t)kPix * (kGC + 1) + (size_t)kPix * (C + 1));
}

inline int gdfn_chunk(int C) {
  return pick_chunk(C, [&](int kc) { return plan_bytes(gdfn_kernel<float>, gdfn_smem(C, kc)); });
}

template <typename T>
cudaError_t launch_gdfn(const void* x, const float* lnw, const float* lnb, const void* win,
                        const void* wdw, const void* wout, const void* wproj, int Co,
                        int residual, void* out, int B, int H, int W, int C, int hid, int kc,
                        float eps, cudaStream_t stream) {
  const size_t smem = gdfn_smem(C, kc);
  cudaError_t err = set_smem(gdfn_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  gdfn_kernel<T><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)win, (const T*)wdw, (const T*)wout, (const T*)wproj, Co,
      residual, (T*)out, H, W, C, hid, eps, kc);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward (K11, replaces _gdfn_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:342):
// per 8x8 tile and hidden chunk, recompute LN(x) on the halo, t = LN(x) W_in
// (float32, as the forward keeps it) and the depthwise output [a1 | a2];
// dgated = dy W_out^T; da1 = dgated a2 gelu'(a1), da2 = dgated gelu(a1). It
// writes LN(x), t and d[a1 | a2] (float32) and the gated product for grad.cu
// (depthwise backward, 1x1 + LN backward with the residual, weight products).
// ---------------------------------------------------------------------------
//
// Shared memory: the LN'd halo is staged whole where that fits (every
// natural-scene width); at C = 384 (295 KB whole) each halo pixel's LN mean
// and rstd stay in shared memory and the halo streams in channel chunks of
// kc for project_in (168 KB), re-read per hidden chunk. dy stays whole.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
gdfn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                const float* __restrict__ lnb, const T* __restrict__ win,
                const T* __restrict__ wdw, const T* __restrict__ wout, const T* __restrict__ dy,
                T* __restrict__ xn_out, float* __restrict__ t_out, float* __restrict__ dc_out,
                T* __restrict__ gated_out, int H, int W, int C, int hid, float eps, int kc) {
  extern __shared__ float sm[];
  const int ldc = kc + 1, ldx = C + 1, ldt = 2 * kGC + 1;
  constexpr bool resident = !kStream;  // kc = C
  float* xs = sm;                    // [100][ldc] LN(x) halo: whole or a chunk
  float* ts = xs + kHaloPix * ldc;   // [100][ldt] project_in chunk: x1 | x2
  float* cs = ts + kHaloPix * ldt;   // [64][ldt] depthwise output a1 | a2
  float* dys = cs + kPix * ldt;      // [64][ldx] dy
  float* mu = dys + kPix * ldx;      // streamed: [100] LN mean, then [100] rstd
  float* rs = mu + kHaloPix;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int H2 = 2 * hid;
  auto inside = [&](int p) {
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    return r >= 0 && r < H && c >= 0 && c < W;
  };
  auto at = [&](int p, int k) {
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    return to_f(x[(((size_t)b * H + r) * W + c) * C + k]);
  };
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    dys[i * ldx + k] = to_f(dy[pix(i) * C + k]);
  }
  if (resident) {
    for (int idx = threadIdx.x; idx < kHaloPix * C; idx += blockDim.x) {
      const int p = idx / C, k = idx - p * C;
      xs[p * ldc + k] = inside(p) ? at(p, k) : 0.f;
    }
    __syncthreads();
    ln_rows_inplace<T>(xs, ldc, kHaloPix, C, lnw, lnb, eps, inside);
  } else {
    ln_stats_rows(mu, rs, kHaloPix, C, eps, at, inside);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C, p = hp(i);
    const float v = resident ? xs[p * ldc + k]
                             : rnd<T>((at(p, k) - mu[p]) * rs[p] * lnw[k] + lnb[k]);
    xn_out[pix(i) * C + k] = from_f<T>(v);
  }
  for (int j0 = 0; j0 < hid; j0 += kGC) {
    const int hc = min(kGC, hid - j0);
    auto col = [&](int j) { return j < hc ? j0 + j : hid + j0 + (j - hc); };
    for (int c0 = 0; c0 < C; c0 += kc) {
      const int nc = min(kc, C - c0);
      if (!resident) {
        load_chunk<T>(xs, ldc, kHaloPix, c0, nc, at, inside, mu, rs, lnw, lnb);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kHaloPix, 2 * hc, nc,
          [&](int i, int k) { return xs[i * ldc + k]; },
          [&](int k, int j) { return to_f(win[(size_t)(c0 + k) * H2 + col(j)]); },
          [&](int i, int j, float a) {
            chunk_acc(ts[i * ldt + (j < hc ? j : kGC + j - hc)], a, first, last,
                      [](float v) { return v; });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * 2 * hc; idx += blockDim.x) {
      const int i = idx / (2 * hc), j = idx - i * 2 * hc;
      t_out[pix(i) * H2 + col(j)] = ts[hp(i) * ldt + (j < hc ? j : kGC + j - hc)];
    }
    for (int idx = threadIdx.x; idx < kPix * hc; idx += blockDim.x) {
      const int p = idx / hc, j = idx - p * hc;
      const int pr = p >> 3, pc = p & 7;
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int dy3 = 0; dy3 < 3; ++dy3)
#pragma unroll
        for (int dx3 = 0; dx3 < 3; ++dx3) {
          const float* t = ts + ((pr + dy3) * kHalo + pc + dx3) * ldt;
          const int tap = dy3 * 3 + dx3;
          a1 = fmaf(t[j], to_f(wdw[tap * H2 + j0 + j]), a1);
          a2 = fmaf(t[kGC + j], to_f(wdw[tap * H2 + hid + j0 + j]), a2);
        }
      cs[p * ldt + j] = a1;
      cs[p * ldt + kGC + j] = a2;
      gated_out[pix(p) * hid + j0 + j] = from_f<T>(rnd<T>(gelu_erf(a1) * a2));
    }
    __syncthreads();
    gemm<T>(kPix, hc, C,  // dgated = dy W_out^T
        [&](int i, int k) { return dys[i * ldx + k]; },
        [&](int k, int j) { return to_f(wout[(size_t)(j0 + j) * C + k]); },
        [&](int i, int j, float g) {
          const float a1 = cs[i * ldt + j], a2 = cs[i * ldt + kGC + j];
          dc_out[pix(i) * H2 + j0 + j] = g * a2 * dgelu_erf(a1);
          dc_out[pix(i) * H2 + hid + j0 + j] = g * gelu_erf(a1);
        });
    __syncthreads();
  }
}

// The backward instance of a chunk: resident (the whole halo) where kc
// covers C, a kernel of its own as the natural-scene widths' plan.
template <typename T>
inline auto gdfn_bwd_kernel_for(int kc, int C) {
  return kc >= C ? gdfn_bwd_kernel<T, false> : gdfn_bwd_kernel<T, true>;
}

// kc = C: the whole halo; kc < C: a chunk of it and the LN statistics.
inline size_t gdfn_bwd_smem(int C, int kc) {
  const size_t whole = (size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (2 * kGC + 1) +
                       (size_t)kPix * (2 * kGC + 1) + (size_t)kPix * (C + 1);
  return sizeof(float) * (kc >= C ? whole : whole + 2 * kHaloPix);
}

inline int gdfn_bwd_chunk(int C) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(gdfn_bwd_kernel_for<float>(kc, C), gdfn_bwd_smem(C, kc));
  });
}

template <typename T>
cudaError_t launch_gdfn_bwd(const void* x, const float* lnw, const float* lnb, const void* win,
                            const void* wdw, const void* wout, const void* dy, void* xn, float* t,
                            float* dc, void* gated, int B, int H, int W, int C, int hid, int kc,
                            float eps, cudaStream_t stream) {
  const size_t smem = gdfn_bwd_smem(C, kc);
  const auto kernel = gdfn_bwd_kernel_for<T>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)win, (const T*)wdw, (const T*)wout, (const T*)dy, (T*)xn,
      t, dc, (T*)gated, H, W, C, hid, eps, kc);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, C); LN float32; win [C][2*hid], wdw [9][2*hid], wout [hid][C],
// wproj [C][Co] or NULL, all in the compute type. Output (B, H, W, Co), with
// Co = C when wproj is NULL. kc: the channel chunk (mp_gdfn_chunk).
extern "C" int mp_gdfn(const void* x, const void* lnw, const void* lnb, const void* win,
                       const void* wdw, const void* wout, const void* wproj, void* out,
                       int dtype, int B, int H, int W, int C, int hid, int Co, int residual,
                       int kc, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_gdfn<float>(x, (const float*)lnw, (const float*)lnb, win, wdw, wout,
                                       wproj, Co, residual, out, B, H, W, C, hid, kc, eps, st);
  return (int)mp::launch_gdfn<__nv_bfloat16>(x, (const float*)lnw, (const float*)lnb, win, wdw,
                                             wout, wproj, Co, residual, out, B, H, W, C, hid,
                                             kc, eps, st);
}

// The channel chunk the forward kernel launches with at C.
extern "C" int mp_gdfn_chunk(int C) { return mp::gdfn_chunk(C); }

// Shared-memory plans per block (bytes, static included) at C and channel
// chunk kc.
extern "C" long long mp_gdfn_smem(int C, int kc) {
  return mp::plan_bytes(mp::gdfn_kernel<float>, mp::gdfn_smem(C, kc));
}

extern "C" long long mp_gdfn_bwd_smem(int C, int kc) {
  return mp::plan_bytes(mp::gdfn_bwd_kernel_for<float>(kc, C), mp::gdfn_bwd_smem(C, kc));
}

// The channel chunk the backward kernel launches with at C.
extern "C" int mp_gdfn_bwd_chunk(int C) { return mp::gdfn_bwd_chunk(C); }

// The per-tile half of the GDFN backward (no exit projection). dy (B, H, W,
// C). Outputs: xn (B, H, W, C) LN(x) and gated (B, H, W, hid) in the compute
// type; t and dc (B, H, W, 2*hid) float32: project_in output and the
// cotangent at the depthwise output. kc: the channel chunk (mp_gdfn_bwd_chunk).
extern "C" int mp_gdfn_bwd(const void* x, const void* lnw, const void* lnb, const void* win,
                           const void* wdw, const void* wout, const void* dy, void* xn, void* t,
                           void* dc, void* gated, int dtype, int B, int H, int W, int C, int hid,
                           int kc, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_gdfn_bwd<float>(x, (const float*)lnw, (const float*)lnb, win, wdw, wout,
                                           dy, xn, (float*)t, (float*)dc, gated, B, H, W, C, hid,
                                           kc, eps, st);
  return (int)mp::launch_gdfn_bwd<__nv_bfloat16>(x, (const float*)lnw, (const float*)lnb, win, wdw,
                                                 wout, dy, xn, (float*)t, (float*)dc, gated, B, H,
                                                 W, C, hid, kc, eps, st);
}
