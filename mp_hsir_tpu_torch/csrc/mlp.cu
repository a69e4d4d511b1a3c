// LayerNorm + gated MLP over an NHWC map, the PGSSTB tail on the training
// route: y = [x +] s_b * (fc2(a * gelu(g)) + b2), [a | g] = fc1(LN(x)) + b1,
// with an optional per-sample drop-path scale s_b.
//
//   mp_mlp      replaces _mlp_kernel (mp_hsir_tpu/ops/pallas_attention.py:965,
//               host _mlp_fwd_call :996, K6). bf16: mlp_tc_kernel, the
//               tensor-core tail tile of mlp_tail.cuh on the x tile staged
//               as bf16 (cp.async; LN in place). float32: mlp_kernel, the
//               spectral apply kernel's float32 tail (common.cuh
//               mlp_tail_tile). As there, the scaled branch is rounded once,
//               then the residual added.
//   mp_mlp_bwd  the per-tile half of K6's VJP (_mlp_bwd_kernel,
//               mp_hsir_tpu/ops/pallas_vjp.py:124, K9): recompute LN, fc1 and
//               the gate per 64-wide hidden chunk; dgated = dys fc2^T with
//               dys = s_b * dy rounded; dh = [dgated gelu(g) | dgated a
//               gelu'(g)] (exact erf derivative). It writes LN(x), dh, the
//               gated product and dys for grad.cu (fc1/LN backward, weight
//               products) and per-tile partials of db2 and d s_b, where
//               d s_b = sum dy * (gated fc2 + b2) is taken as
//               sum dy b2 + sum gated (dy fc2^T), one extra product per chunk.
//
// One block = one 8x8 tile. Bound on this card: 6*C*hidden flops per pixel
// forward (12*C*hidden backward, + 2*C*hidden with drop-path) against ~4C
// bytes per pixel: tensor-core rate. The backward's bf16 products run on
// mma.sync fed element by element (common.cuh gemm), float32 on SIMT FMA.
#include "mlp_tail.cuh"

namespace mp {

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const T* __restrict__ x, const float* __restrict__ lnw, const float* __restrict__ lnb,
           const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ dp, int residual,
           T* __restrict__ out, int H, int W, int C, int hid, float eps) {
  extern __shared__ float sm[];
  const int ld = C + 1;
  float* ys = sm;              // [64][ld] x, then the branch
  float* yn = ys + kPix * ld;  // [64][ld] LN(x)
  float* hb = yn + kPix * ld;  // [64][2*kHC+1] hidden chunk
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    ys[i * ld + k] = to_f(x[tile_pix(b, ty, tx, i, H, W) * C + k]);
  }
  __syncthreads();
  mlp_tail_tile<T>(ys, yn, ld, hb, C, hid, lnw, lnb, w1, b1, w2, b2, eps, /*branch_only=*/true);
  const float s = dp == nullptr ? 1.f : dp[b];
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    const size_t o = tile_pix(b, ty, tx, i, H, W) * C + k;
    float v = rnd<T>(ys[i * ld + k] * s);
    if (residual) v = rnd<T>(to_f(x[o]) + v);
    out[o] = from_f<T>(v);
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
  auto row = [&](int i) { return tile_pix(b, ty, tx, i, H, W) * C; };
  if (vec) {
    const int units = CK / 8;
    for (int u = threadIdx.x; u < kPix * units; u += blockDim.x) {
      const int i = u / units, c = (u - i * units) * 8;
      const bool in = c < C;
      cp_async16(smem_u32(xs + i * ldx + c), in ? x + row(i) + c : x, in ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * CK; u += blockDim.x) {
      const int i = u / CK, c = u - i * CK;
      xs[i * ldx + c] = c < C ? x[row(i) + c] : __float2bfloat16(0.f);
    }
  }
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

inline size_t mlp_smem(int C) {
  return sizeof(float) * ((size_t)2 * kPix * (C + 1) + (size_t)kPix * (2 * kHC + 1));
}

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
    const size_t smem = mlp_smem(C);
    cudaError_t err = set_smem(mlp_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    mlp_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)x, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, dp, residual, (T*)out, H, W, C,
        hid, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mlp_bwd(const void* x, const void* dy, const float* lnw, const float* lnb,
                           const void* w1, const float* b1, const void* w2, const float* b2,
                           const float* dp, void* xn, void* dh, void* gated, void* dys,
                           float* pb2, float* pdp, int B, int H, int W, int C, int hid, int kc,
                           float eps, cudaStream_t stream) {
  const size_t smem = mlp_bwd_smem(C, kc);
  const auto kernel = mlp_bwd_kernel_for<T>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, dp, (T*)xn,
      (T*)dh, (T*)gated, (T*)dys, pb2, pdp, H, W, C, hid, eps, kc);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, C); LN, b1, b2 float32; dp (B,) float32 drop-path scales or
// NULL. Weights in the compute type: float32 w1 [C][2*hid], w2 [hid][C];
// bf16 (C <= 384) pack_mlp_weights' w1p [hidP/64][128][CK], w2p [CK][hidP].
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

// The per-tile half of the MLP backward. Outputs: xn (B, H, W, C) LN(x), dh
// (B, H, W, 2*hid), gated (B, H, W, hid), dys (B, H, W, C), all in the compute
// type; pb2 (tiles, C) and pdp (tiles,) float32 partials (pdp only with dp).
// kc: the channel chunk (mp_mlp_bwd_chunk).
extern "C" int mp_mlp_bwd(const void* x, const void* dy, const void* lnw, const void* lnb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* dp, void* xn, void* dh, void* gated, void* dys, void* pb2,
                          void* pdp, int dtype, int B, int H, int W, int C, int hid, int kc,
                          float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_mlp_bwd<float>(x, dy, f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(dp), xn,
                                          dh, gated, dys, (float*)pb2, (float*)pdp, B, H, W, C,
                                          hid, kc, eps, st);
  return (int)mp::launch_mlp_bwd<__nv_bfloat16>(x, dy, f(lnw), f(lnb), w1, f(b1), w2, f(b2),
                                                f(dp), xn, dh, gated, dys, (float*)pb2,
                                                (float*)pdp, B, H, W, C, hid, kc, eps, st);
}

// The channel chunk the backward kernel launches with at C.
extern "C" int mp_mlp_bwd_chunk(int C) { return mp::mlp_bwd_chunk(C); }

// Shared-memory plans per block (bytes, static included): the forward's in
// the compute type (dtype 0 float32, 1 bf16; -1: bf16 past C = 384), the
// backward's at channel chunk kc.
extern "C" long long mp_mlp_smem(int C, int dtype) {
  if (dtype == 0) return mp::plan_bytes(mp::mlp_kernel<float>, mp::mlp_smem(C));
  return C > mp::kTailMaxC ? -1 : mp::plan_bytes(mp::mlp_tc_kernel, mp::mlp_tc_smem(C));
}

extern "C" long long mp_mlp_bwd_smem(int C, int kc) {
  return mp::plan_bytes(mp::mlp_bwd_kernel_for<float>(kc, C), mp::mlp_bwd_smem(C, kc));
}
