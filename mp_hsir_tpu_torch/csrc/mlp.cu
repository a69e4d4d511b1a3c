// LayerNorm + gated MLP over an NHWC map, the PGSSTB tail on the training
// route: y = [x +] s_b * (fc2(a * gelu(g)) + b2), [a | g] = fc1(LN(x)) + b1,
// with an optional per-sample drop-path scale s_b.
//
//   mp_mlp      replaces _mlp_kernel (mp_hsir_tpu/ops/pallas_attention.py:965,
//               host _mlp_fwd_call :996, K6). The tile body is the spectral
//               apply kernel's tail (common.cuh mlp_tail_tile). As there,
//               the scaled branch is rounded once, then the residual added.
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
// bytes per pixel: tensor-core rate. bf16 products on mma.sync, float32 SIMT.
#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ lnw,
               const float* __restrict__ lnb, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ dp,
               T* __restrict__ xn_out, T* __restrict__ dh_out, T* __restrict__ gated_out,
               T* __restrict__ dys_out, float* __restrict__ pb2, float* __restrict__ pdp, int H,
               int W, int C, int hid, float eps) {
  extern __shared__ float sm[];
  __shared__ float red[kThreads / 32];
  const int ld = C + 1, ldh = 2 * kHC + 1, ldg = kHC + 1;
  float* xs = sm;                // [64][ld] LN(x), rounded
  float* ds = xs + kPix * ld;    // [64][ld] dy
  float* hs = ds + kPix * ld;    // [64][ldh] a | g of one chunk (float32)
  float* gs = hs + kPix * ldh;   // [64][ldg] gated (rounded)
  float* dg = gs + kPix * ldg;   // [64][ldg] dgated
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const float s = dp == nullptr ? 1.f : dp[b];
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };

  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    xs[i * ld + k] = to_f(x[pix(i) * C + k]);
    ds[i * ld + k] = to_f(dy[pix(i) * C + k]);
  }
  __syncthreads();
  ln_rows_inplace<T>(xs, ld, kPix, C, lnw, lnb, eps, [](int) { return true; });
  float part = 0.f;  // this thread's share of d s_b
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float sb = 0.f, db = 0.f;
    for (int i = 0; i < kPix; ++i) {
      const float d = rnd<T>(ds[i * ld + k] * s);
      dys_out[pix(i) * C + k] = from_f<T>(d);
      db += d;
      sb += ds[i * ld + k];
    }
    pb2[(size_t)tile * C + k] = db;
    part = fmaf(sb, b2[k], part);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    xn_out[pix(i) * C + k] = from_f<T>(xs[i * ld + k]);
  }
  for (int j0 = 0; j0 < hid; j0 += kHC) {
    const int hc = min(kHC, hid - j0);
    auto col1 = [&](int j) { return j < hc ? j0 + j : hid + j0 + (j - hc); };
    gemm<T>(kPix, 2 * hc, C,
        [&](int i, int k) { return xs[i * ld + k]; },
        [&](int k, int j) { return to_f(w1[(size_t)k * 2 * hid + col1(j)]); },
        [&](int i, int j, float acc) { hs[i * ldh + (j < hc ? j : kHC + j - hc)] = acc + b1[col1(j)]; });
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * hc; idx += blockDim.x) {
      const int p = idx / hc, j = idx - p * hc;
      const float gv = rnd<T>(hs[p * ldh + j] * gelu_erf(hs[p * ldh + kHC + j]));
      gs[p * ldg + j] = gv;
      gated_out[pix(p) * hid + j0 + j] = from_f<T>(gv);
    }
    __syncthreads();
    if (dp != nullptr) {
      gemm<T>(kPix, hc, C,
          [&](int i, int k) { return ds[i * ld + k]; },
          [&](int k, int j) { return to_f(w2[(size_t)(j0 + j) * C + k]); },
          [&](int i, int j, float acc) { part = fmaf(gs[i * ldg + j], acc, part); });
    }
    gemm<T>(kPix, hc, C,
        [&](int i, int k) { return rnd<T>(ds[i * ld + k] * s); },
        [&](int k, int j) { return to_f(w2[(size_t)(j0 + j) * C + k]); },
        [&](int i, int j, float acc) { dg[i * ldg + j] = acc; });
    __syncthreads();
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

inline size_t mlp_bwd_smem(int C) {
  return sizeof(float) * ((size_t)2 * kPix * (C + 1) + (size_t)kPix * (2 * kHC + 1) +
                          (size_t)2 * kPix * (kHC + 1));
}

template <typename T>
cudaError_t launch_mlp(const void* x, const float* lnw, const float* lnb, const void* w1,
                       const float* b1, const void* w2, const float* b2, const float* dp,
                       int residual, void* out, int B, int H, int W, int C, int hid, float eps,
                       cudaStream_t stream) {
  const size_t smem = mlp_smem(C);
  cudaError_t err = set_smem(mlp_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  mlp_kernel<T><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, dp, residual, (T*)out, H, W, C,
      hid, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mlp_bwd(const void* x, const void* dy, const float* lnw, const float* lnb,
                           const void* w1, const float* b1, const void* w2, const float* b2,
                           const float* dp, void* xn, void* dh, void* gated, void* dys,
                           float* pb2, float* pdp, int B, int H, int W, int C, int hid, float eps,
                           cudaStream_t stream) {
  const size_t smem = mlp_bwd_smem(C);
  cudaError_t err = set_smem(mlp_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  mlp_bwd_kernel<T><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, lnw, lnb, (const T*)w1, b1, (const T*)w2, b2, dp, (T*)xn,
      (T*)dh, (T*)gated, (T*)dys, pb2, pdp, H, W, C, hid, eps);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, C); LN, b1, b2 float32; w1 [C][2*hid], w2 [hid][C] in the
// compute type; dp (B,) float32 drop-path scales or NULL. out (B, H, W, C).
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
extern "C" int mp_mlp_bwd(const void* x, const void* dy, const void* lnw, const void* lnb,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* dp, void* xn, void* dh, void* gated, void* dys, void* pb2,
                          void* pdp, int dtype, int B, int H, int W, int C, int hid, float eps,
                          void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_mlp_bwd<float>(x, dy, f(lnw), f(lnb), w1, f(b1), w2, f(b2), f(dp), xn,
                                          dh, gated, dys, (float*)pb2, (float*)pdp, B, H, W, C,
                                          hid, eps, st);
  return (int)mp::launch_mlp_bwd<__nv_bfloat16>(x, dy, f(lnw), f(lnb), w1, f(b1), w2, f(b2),
                                                f(dp), xn, dh, gated, dys, (float*)pb2,
                                                (float*)pdp, B, H, W, C, hid, eps, st);
}

// Shared-memory plans per block (bytes, static included).
extern "C" long long mp_mlp_smem(int C) {
  return mp::plan_bytes(mp::mlp_kernel<float>, mp::mlp_smem(C));
}

extern "C" long long mp_mlp_bwd_smem(int C) {
  return mp::plan_bytes(mp::mlp_bwd_kernel<float>, mp::mlp_bwd_smem(C));
}
