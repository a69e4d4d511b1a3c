// Shared device helpers for the MP-HSIR Hopper kernels.
//
// Every kernel runs 512 threads per block over one 8x8 pixel tile (or one
// 8x8 attention window) and keeps its working set in shared memory as float32.
// Products go through gemm<T>: warp-level mma.sync on the tensor cores for
// bf16, block-level loops over 4x4 register tiles (SIMT FMA) for float32.
// The exceptions stage their bf16 operands as bf16 with cp.async and feed
// mma.sync by ldmatrix: conv3 (an implicit GEMM over 16x16-pixel tiles), the
// bf16 window forward and backward (window_attention.cu), the PGSSTB tail MLP
// (mlp_tail.cuh), the bf16 spectral apply front (spectral_front.cuh), the
// bf16 backward tiles, and the bf16 weight product (grad.cu wgrad_tc_kernel).
// The float32 twins of conv3, the K1 window tile, the tail MLP and the
// spectral stats and apply tiles stage float32 and run 3xTF32 mma.sync (the
// helpers at the end of this file). The other float32 kernels keep SIMT FMA. wgmma and TMA are later work; see
// PERF.md for the gap to each bound.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace mp {

constexpr int kThreads = 512;  // 16 warps: enough in flight to hide load latency
constexpr int kTile = 8;              // tile side in pixels
constexpr int kPix = kTile * kTile;   // pixels per tile
constexpr int kHalo = kTile + 2;      // tile side with the 3x3 halo
constexpr int kHaloPix = kHalo * kHalo;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round a float to T's precision (the points where the JAX kernels cast to
// the compute dtype)
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// d/dx [x Phi(x)] = Phi(x) + x phi(x), the exact-erf GELU's derivative
__device__ __forceinline__ float dgelu_erf(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
}

// Sum of one float per thread over the block, in a fixed order (warp
// shuffles, then the warps' sums in warp order); every thread gets it.
// `red` is kThreads / 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Block-wide product: for every i < M, j < N calls epi(i, j, sum_k la(i, k) *
// lb(k, j)), each (i, j) from exactly one thread. Thread t owns 4x4 output
// tiles t, t + blockDim.x, ...; neighbouring threads take neighbouring column tiles
// so that lb reads of a row-major [K][N] operand coalesce.
template <typename LA, typename LB, typename Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K, LA la, LB lb, Epi epi) {
  const int tiles_n = (N + 3) >> 2;
  const int tiles = ((M + 3) >> 2) * tiles_n;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int i0 = (t / tiles_n) << 2;
    const int j0 = (t % tiles_n) << 2;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    const int mr = min(4, M - i0);
    const int nc = min(4, N - j0);
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = r < mr ? la(i0 + r, k) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = c < nc ? lb(k, j0 + c) : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (r < mr && c < nc) epi(i0 + r, j0 + c, acc[r][c]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D = A (16x16, row) * B (16x8, col) + D on the tensor cores, bf16 in, f32 sum.
__device__ __forceinline__ void mma_16x8x16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared-memory address of a generic pointer, as the PTX below takes it.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned);
// src_bytes = 0 reads nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 8- and 4-byte asynchronous copies (cp.async.cg takes 16 bytes only), for
// operands whose rows are not a whole number of 16-byte vectors; dst and
// src aligned to the copy's size, src_bytes = 0 fills with zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. Lane l receives row l / 4, elements 2 (l % 4) and
// +1 of each (with trans: column l / 4, rows 2 (l % 4) and +1), which is
// the mma.m16n8k16 fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Same contract as block_gemm, on the tensor cores: each warp owns 16x32
// output tiles (four m16n8k16 products per 16-deep step). Operands are
// packed to bf16 as they are read, so every value la / lb return must
// already be bf16-exact (the kernels round there anyway); the sums are
// float32. Rows, columns and depth past M, N, K read as zeros.
template <typename LA, typename LB, typename Epi>
__device__ __forceinline__ void block_gemm_mma(int M, int N, int K, LA la, LB lb, Epi epi) {
  constexpr int NB = 4;  // n8 sub-tiles per warp tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles_n = (N + 8 * NB - 1) / (8 * NB);
  const int tiles = ((M + 15) >> 4) * tiles_n;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += blockDim.x >> 5) {
    const int i0 = (tile / tiles_n) << 4, j0 = (tile % tiles_n) * 8 * NB;
    const int r0 = i0 + g, r1 = r0 + 8;
    float c[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[nb][q] = 0.f;
    auto A = [&](int r, int k) { return (r < M && k < K) ? la(r, k) : 0.f; };
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * t, kb = ka + 8;
      const uint32_t a0 = pack_bf16x2(A(r0, ka), A(r0, ka + 1));
      const uint32_t a1 = pack_bf16x2(A(r1, ka), A(r1, ka + 1));
      const uint32_t a2 = pack_bf16x2(A(r0, kb), A(r0, kb + 1));
      const uint32_t a3 = pack_bf16x2(A(r1, kb), A(r1, kb + 1));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (j0 + nb * 8 >= N) break;  // warp-uniform
        const int col = j0 + nb * 8 + g;
        auto B = [&](int k) { return (col < N && k < K) ? lb(k, col) : 0.f; };
        mma_16x8x16(c[nb], a0, a1, a2, a3, pack_bf16x2(B(ka), B(ka + 1)),
                    pack_bf16x2(B(kb), B(kb + 1)));
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = j0 + nb * 8 + 2 * t;
      if (r0 < M && col < N) epi(r0, col, c[nb][0]);
      if (r0 < M && col + 1 < N) epi(r0, col + 1, c[nb][1]);
      if (r1 < M && col < N) epi(r1, col, c[nb][2]);
      if (r1 < M && col + 1 < N) epi(r1, col + 1, c[nb][3]);
    }
  }
}

// The kernels' product: tensor cores for bf16, SIMT FMA for float32 (whose
// results the float32 checks hold to 1e-4 of the plain version).
template <typename T, typename LA, typename LB, typename Epi>
__device__ __forceinline__ void gemm(int M, int N, int K, LA la, LB lb, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    block_gemm_mma(M, N, K, la, lb, epi);
  } else {
    block_gemm(M, N, K, la, lb, epi);
  }
}

// LayerNorm of `rows` rows of width C held in shared memory (row stride ld),
// in place, one warp per row; `valid(i)` false rows are set to zero (the
// out-of-image halo is zero in normalised space). Result rounded to T.
template <typename T, typename Valid>
__device__ __forceinline__ void ln_rows_inplace(float* s, int ld, int rows, int C,
                                                const float* __restrict__ w,
                                                const float* __restrict__ b, float eps,
                                                Valid valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    float* row = s + i * ld;
    if (!valid(i)) {
      for (int k = lane; k < C; k += 32) row[k] = 0.f;
      continue;
    }
    float sum = 0.f;
    for (int k = lane; k < C; k += 32) sum += row[k];
    const float mu = warp_sum(sum) / C;
    float var = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = row[k] - mu;
      var += d * d;
    }
    const float rs = rsqrtf(warp_sum(var) / C + eps);
    for (int k = lane; k < C; k += 32) row[k] = rnd<T>((row[k] - mu) * rs * w[k] + b[k]);
  }
}

// Channel-chunked staging (the plans that fit C = 384 and dh = 96 in 227 KB).
// A kernel whose input is too wide to stage whole keeps only each pixel's
// LayerNorm mean and rstd in shared memory and streams the input of every 1x1
// product in chunks of kc channels from L2, normalising as they arrive. The
// statistics are computed exactly as ln_rows_inplace computes them (the same
// lane-strided sums), so a chunk holds the values that kernel would hold.
//
// ln_stats_rows: mu / rs of `rows` pixels, channel k of pixel i read as
// at(i, k); one warp per pixel. Pixels with valid(i) false get 0 / 0.
template <typename At, typename Valid>
__device__ __forceinline__ void ln_stats_rows(float* mu, float* rs, int rows, int C, float eps,
                                              At at, Valid valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += blockDim.x >> 5) {
    float m = 0.f, r = 0.f;
    if (valid(i)) {
      float sum = 0.f;
      for (int k = lane; k < C; k += 32) sum += at(i, k);
      m = warp_sum(sum) / C;
      float var = 0.f;
      for (int k = lane; k < C; k += 32) {
        const float d = at(i, k) - m;
        var += d * d;
      }
      r = rsqrtf(warp_sum(var) / C + eps);
    }
    if (lane == 0) {
      mu[i] = m;
      rs[i] = r;
    }
  }
}

// s[i][j] ([rows][ld]) = channel c0 + j (j < nc) of pixel i, normalised with
// (mu, rs, lnw, lnb) and rounded to T when lnw != nullptr, raw otherwise;
// zero where valid(i) is false (the out-of-image halo is zero after the LN).
template <typename T, typename At, typename Valid>
__device__ __forceinline__ void load_chunk(float* s, int ld, int rows, int c0, int nc, At at,
                                           Valid valid, const float* mu, const float* rs,
                                           const float* __restrict__ lnw,
                                           const float* __restrict__ lnb) {
  for (int idx = threadIdx.x; idx < rows * nc; idx += blockDim.x) {
    const int i = idx / nc, j = idx - i * nc, k = c0 + j;
    float v = 0.f;
    if (valid(i)) {
      v = at(i, k);
      if (lnw != nullptr) v = rnd<T>((v - mu[i]) * rs[i] * lnw[k] + lnb[k]);
    }
    s[i * ld + j] = v;
  }
}

// Epilogue of one K-chunk of a chunked product: the float32 sum of the chunks
// so far lives in acc; the last chunk hands the total to finish (which rounds).
template <typename Fin>
__device__ __forceinline__ void chunk_acc(float& acc, float part, bool first, bool last, Fin finish) {
  const float v = first ? part : acc + part;
  acc = last ? finish(v) : v;
}

// One 8x8 tile of a 3x3 depthwise conv with zero padding: src holds the
// 10x10 halo ([kHaloPix][lds]) of `nc` channels, dst gets [kPix][ldd];
// tap weight of channel j at tap t is wtap(t, j). epi(p, j, acc) stores.
template <typename WT, typename Epi>
__device__ __forceinline__ void dwconv3_tile(const float* src, int lds, int nc, WT wtap, Epi epi) {
  for (int idx = threadIdx.x; idx < kPix * nc; idx += blockDim.x) {
    const int p = idx / nc, j = idx - p * nc;
    const int pr = p >> 3, pc = p & 7;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(src[((pr + dy) * kHalo + pc + dx) * lds + j], wtap(dy * 3 + dx, j), acc);
    epi(p, j, acc);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, int n) { return (uintptr_t)p % n == 0; }

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Shared memory a block of the current device may opt into (bytes; 232,448
// on an H100), read from the device (defined in spectral.cu).
int smem_optin();

// A launch plan's shared memory per block: `dyn` dynamic bytes plus the
// kernel's static shared memory.
template <typename K>
inline long long plan_bytes(K kernel, size_t dyn) {
  cudaFuncAttributes a{};
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return -1;
  return (long long)(dyn + a.sharedSizeBytes);
}

// The channel chunk of a staged kernel: C (the whole input resident, staged
// once, the plan of the natural-scene widths) where that plan fits the
// device, else 64 (whether or not that fits: the wrapper's plan check then
// raises before the launch). bytes(kc) is the plan. The wrappers ask once per
// shape (mp_<kernel>_chunk) and pass the chunk to every launch.
template <typename F>
inline int pick_chunk(int C, F bytes) {
  return C <= 64 || bytes(C) <= smem_optin() ? C : 64;
}

// out[b][i] = sum over p (in order) of part[b][p][i], i < n: the second pass
// of every deterministic cross-block reduction (defined in spectral.cu).
cudaError_t launch_sum_parts(const float* part, float* out, int nb, int n_parts, int n,
                             cudaStream_t stream);

// Global index of pixel i (0..63) of 8x8 tile (ty, tx) of image b.
__device__ __forceinline__ size_t tile_pix(int b, int ty, int tx, int i, int H, int W) {
  return ((size_t)b * H + ty * kTile + (i >> 3)) * W + tx * kTile + (i & 7);
}

// The spectral apply's gate row of raw pixel (sr, sc) of image b: gwin 8 for
// per-window gates (B, H/8, W/8, C), 1 for a per-pixel gate map (B, H, W, C).
__device__ __forceinline__ int gate_row(int b, int sr, int sc, int H, int W, int gwin) {
  return (b * (H / gwin) + sr / gwin) * (W / gwin) + sc / gwin;
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores: the float32 tiles (mlp_tail.cuh's mlp_tail_f32,
// conv3.cu's float32 instance, window_attention.cu's window_f32_kernel,
// spectral_stats_f32.cuh's spectral_stats_f32_kernel, spectral.cu's
// spectral_apply_f32_kernel) load
// float32 fragments (ldmatrix on 4-byte elements: lane l receives row l / 4,
// element l % 4 of each 8x4 matrix, the m16n8k8 TF32 fragment layout) and
// split each into two TF32 values.
// ---------------------------------------------------------------------------

// A finite float32's bits rounded to TF32 as cvt.rna.tf32.f32 rounds them
// (the 13 low mantissa bits off, ties away from zero, the carry into the
// exponent), in two integer operations (cvt.rna also sorts out NaN and
// infinity, at a few more instructions a value).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t u) { return (u + 0x1000u) & 0xFFFFE000u; }

// x (four float32 fragment registers) = big + small, both TF32; x - big is
// exact in float32, so x - big - small is ~2^-22 |x|.
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = tf32_rna(x[e]);
    small[e] = tf32_rna(__float_as_uint(__uint_as_float(x[e]) - __uint_as_float(big[e])));
  }
}

// one float32 value split as split_tf32 splits a fragment register
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(__float_as_uint(x));
  small = tf32_rna(__float_as_uint(x - __uint_as_float(big)));
}

// D = A (16x8, row) * B (8x8, col) + D on the tensor cores, TF32 in, f32 sum.
__device__ __forceinline__ void mma_16x8x8_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 from the split fragments (ab, as: A's big and small;
// b: B's big b0, b1 then small b0, b1), the small terms first. The tensor
// cores round their float32 sums toward zero, a bias that grows with every
// sum chained through them (~1e-5 of the output over K = 1024 on the card),
// so the step's three products are summed from zero there and added to d in
// float32, rounded to nearest: the truncation stays at one k8 step's scale.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_16x8x8_tf32(t, as, bb0, bb1);
  mma_16x8x8_tf32(t, ab, bs0, bs1);
  mma_16x8x8_tf32(t, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Two n8 tiles of one k8 step: B's fragments from a float32 [n][k] tile by
// one ldmatrix (lane address b: n row (lane % 8) + 8 (lane / 16), k offset 4
// (lane / 8 % 2) floats), split, and the 3xTF32 products into d0 and d1.
__device__ __forceinline__ void mma_pair_f32(float* d0, float* d1, const uint32_t (&ab)[4],
                                             const uint32_t (&as)[4], uint32_t b) {
  uint32_t bv[4], bb[4], bs[4];
  ldmatrix_x4(bv, b);
  split_tf32(bv, bb, bs);
  mma_3xtf32(d0, ab, as, bb[0], bb[1], bs[0], bs[1]);
  mma_3xtf32(d1, ab, as, bb[2], bb[3], bs[2], bs[3]);
}

}  // namespace mp
