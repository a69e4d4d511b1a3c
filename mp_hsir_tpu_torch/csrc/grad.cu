// Shared stages of the backward kernels (training slice). Each module's
// backward tile kernel (mlp.cu, window_attention.cu, spectral.cu, gdfn.cu)
// recomputes its forward per 8x8 tile and writes per-pixel operands; these
// launches finish the backward from them:
//
//   mp_wgrad          weight cotangents, out[b][m][n] = sum_p A[b][p][m] B[b][p][n]:
//                     each block sums a fixed pixel range of an output tile
//                     (bf16: 128x128 on the tensor cores, wgrad_tc_kernel;
//                     float32: 64x64, SIMT) into its own partial, then the
//                     partials are added in a fixed order (deterministic, no
//                     float atomics).
//   mp_dwconv_bwd     3x3 depthwise conv backward: dt = the transposed stencil
//                     of dout (zero padding), per-tile tap-weight partials.
//   mp_dwconv_halo_bwd  the halo-row terms of a row shard's depthwise
//                     backward, which the stencil kernels (mp_dwconv_bwd;
//                     bf16: dwconv_dx.cuh's tile) leave out: the halo rows'
//                     dt and their tap partials.
//   mp_ln_linear_bwd  dxn = d W^T through a 1x1 (Linear) layer, then the
//                     LayerNorm backward, plus optional extra cotangents;
//                     per-tile LN and bias partials. Reads the input and
//                     writes dx through a cyclic roll of `shift` pixels, so
//                     a kernel frame that is the rolled (window) or unrolled
//                     (spectral) one maps back to the input's own frame.
//   mp_sum_parts      the in-order sum of per-block partials.
//
// These replace the in-kernel f32 accumulators of the TPU backward kernels
// (mp_hsir_tpu/ops/pallas_vjp.py _mlp_bwd_kernel :124, _gdfn_bwd_kernel :342,
// _win_bwd_kernel :539, _sp0_bwd_kernel :1443, _sp1_bwd_kernel :1501), which
// carry weight sums across a sequential grid; Hopper blocks run in no order.
// Bound: the weight products are 2*P*M*N flops over P*(M+N) elements read,
// ~50 flops a byte at the flagship's widths: the bytes bound them, and a
// bf16 product has to run at ~200 TFLOP/s to reach that bound.
#include "common.cuh"

namespace mp {

constexpr int kWM = 64, kWN = 64, kWK = 32, kWThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWThreads)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ Bm, int P, int M, int N,
             int n_parts, int chunk, float* __restrict__ out) {
  __shared__ float as[kWK][kWM + 1];
  __shared__ float bs[kWK][kWN + 1];
  __shared__ float acc[kWM][kWN + 1];
  const int n0 = blockIdx.x * kWN, m0 = blockIdx.y * kWM;
  const int b = blockIdx.z / n_parts, part = blockIdx.z - b * n_parts;
  const T* a = A + (size_t)b * P * M;
  const T* bb = Bm + (size_t)b * P * N;
  const int p_end = min(P, (part + 1) * chunk);
  for (int idx = threadIdx.x; idx < kWM * kWN; idx += blockDim.x) acc[idx / kWN][idx % kWN] = 0.f;
  for (int p0 = part * chunk; p0 < p_end; p0 += kWK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kWK * kWM; idx += blockDim.x) {
      const int k = idx / kWM, i = idx - k * kWM;
      as[k][i] = (p0 + k < p_end && m0 + i < M) ? to_f(a[(size_t)(p0 + k) * M + m0 + i]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kWK * kWN; idx += blockDim.x) {
      const int k = idx / kWN, j = idx - k * kWN;
      bs[k][j] = (p0 + k < p_end && n0 + j < N) ? to_f(bb[(size_t)(p0 + k) * N + n0 + j]) : 0.f;
    }
    __syncthreads();
    // every (i, j) belongs to the same thread on every step: fixed sum order
    gemm<T>(kWM, kWN, kWK,
        [&](int i, int k) { return as[k][i]; },
        [&](int k, int j) { return bs[k][j]; },
        [&](int i, int j, float v) { acc[i][j] += v; });
  }
  __syncthreads();
  float* o = out + ((size_t)b * n_parts + part) * M * N;
  for (int idx = threadIdx.x; idx < kWM * kWN; idx += blockDim.x) {
    const int i = idx / kWN, j = idx - i * kWN;
    if (m0 + i < M && n0 + j < N) o[(size_t)(m0 + i) * N + n0 + j] = acc[i][j];
  }
}

// The bf16 weight product on the tensor cores. Each 256-thread block owns a
// kWT x kWT tile of out (rows of A's width, columns of B's) and one part's
// pixel range; the depth of the product is pixels. Both operands are
// [pixel][channel] rows in device memory and stage as bf16 [kWP][kWT + 8]
// tiles (272-byte rows: 16-byte aligned, ldmatrix rows conflict-free) through
// a kWS-stage ring; A is the [m][k] operand stored [k][m] and B the [k][n]
// operand, so both are read by ldmatrix.trans into mma.sync m16n8k16, float32
// sums in registers. The 8 warps own 64x32 sub-tiles (2 x 4); a warp whose
// sub-tile starts past M or N skips the products (the rows and columns past
// them in a live sub-tile are zeros, never stored), and where a tile holds
// at most 64 live rows (or columns) the live warps are 0-3, one on each of
// the SM's four tensor cores. Per 16 pixels a warp loads all six fragments
// (two of B, four of A) before its 16 products, so that one shared-memory
// latency is exposed, not one per fragment. A block writes its partial once
// (out itself when there is one part); one sum_parts adds the parts in order.
//
// Copies: per operand the widest its row width and base pointer allow,
// V elements each (8: 16-byte cp.async.cg, 4 / 2: 8 / 4-byte cp.async.ca;
// 1: two 2-byte loads into registers while the previous stage is multiplied,
// then one 4-byte st.shared). Columns past the width and pixels past the
// part's end read as zeros. M <= 128 sits in one row of tiles, so the wide
// operand B is read from device memory once and A once per 128 columns.
constexpr int kWT = 128, kWP = 32, kWS = 4, kWLd = kWT + 8, kWTcThreads = 256;
constexpr int kWStage = kWP * kWLd;  // bf16 elements of one operand's stage
constexpr size_t kWgradTcSmem = sizeof(__nv_bfloat16) * 2 * kWS * kWStage;  // 69,632 B

// The kWP x kWT tile of X ([P][width]) at pixel p0 and column c0 into s: the
// cp.async copies (V >= 2), or the loads into held (V == 1, stored by
// wg_store after the current stage's product).
template <int V>
__device__ __forceinline__ void wg_issue(const __nv_bfloat16* __restrict__ X, int width, int p0,
                                         int p_end, int c0, __nv_bfloat16* s, uint32_t* held) {
  constexpr int kE = V >= 2 ? V : 2;  // elements per unit
  constexpr int kRow = kWT / kE, kPer = kWP * kRow / kWTcThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = threadIdx.x + i * kWTcThreads;
    const int r = u / kRow, c = (u - r * kRow) * kE;
    const int p = p0 + r, col = c0 + c;
    if constexpr (V >= 2) {
      const bool ok = p < p_end && col < width;
      const __nv_bfloat16* src = ok ? X + (size_t)p * width + col : X;
      const uint32_t dst = smem_u32(s + r * kWLd + c);
      if constexpr (V == 8) {
        cp_async16(dst, src, ok ? 16 : 0);
      } else if constexpr (V == 4) {
        cp_async8(dst, src, ok ? 8 : 0);
      } else {
        cp_async4(dst, src, ok ? 4 : 0);
      }
    } else {
      uint32_t lo = 0, hi = 0;
      if (p < p_end) {
        const unsigned short* row = reinterpret_cast<const unsigned short*>(X) + (size_t)p * width;
        if (col < width) lo = __ldg(row + col);
        if (col + 1 < width) hi = __ldg(row + col + 1);
      }
      held[i] = lo | (hi << 16);
    }
  }
}

template <int V>
__device__ __forceinline__ void wg_store(__nv_bfloat16* s, const uint32_t* held) {
  if constexpr (V == 1) {
    constexpr int kRow = kWT / 2, kPer = kWP * kRow / kWTcThreads;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = threadIdx.x + i * kWTcThreads;
      const int r = u / kRow, c = (u - r * kRow) * 2;
      *reinterpret_cast<uint32_t*>(s + r * kWLd + c) = held[i];
    }
  }
}

template <int VA, int VB>
__global__ void __launch_bounds__(kWTcThreads, 2)
wgrad_tc_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Bm, int P,
                int M, int N, int n_parts, int chunk, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(wg_smem);  // [kWS][kWP][kWLd]
  __nv_bfloat16* sb = sa + kWS * kWStage;                         // [kWS][kWP][kWLd]
  const int n0 = blockIdx.x * kWT, m0 = blockIdx.y * kWT;
  const int b = blockIdx.z / n_parts, part = blockIdx.z - b * n_parts;
  const __nv_bfloat16* a = A + (size_t)b * P * M;
  const __nv_bfloat16* bb = Bm + (size_t)b * P * N;
  const int p_begin = min(P, part * chunk), p_end = min(P, p_begin + chunk);
  const int steps = (p_end - p_begin + kWP - 1) / kWP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool low = M - m0 <= 64;
  const int wm = low ? warp >> 2 : warp & 1, wn = low ? warp & 3 : warp >> 1;
  const int rm = m0 + wm * 64, cn = n0 + wn * 32;  // the warp's first row and column
  const bool live = rm < M && cn < N;               // warp-uniform
  uint32_t ha[VA == 1 ? kWP * kWT / 2 / kWTcThreads : 1];
  uint32_t hb[VB == 1 ? kWP * kWT / 2 / kWTcThreads : 1];
  auto issue = [&](int step) {
    const int p0 = p_begin + step * kWP, slot = step % kWS;
    wg_issue<VA>(a, M, p0, p_end, m0, sa + slot * kWStage, ha);
    wg_issue<VB>(bb, N, p0, p_end, n0, sb + slot * kWStage, hb);
  };
  auto store = [&](int step) {
    const int slot = step % kWS;
    wg_store<VA>(sa + slot * kWStage, ha);
    wg_store<VB>(sb + slot * kWStage, hb);
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  for (int s = 0; s < kWS - 1; ++s) {
    if (s < steps) {
      issue(s);
      store(s);
    }
    cp_async_commit();
  }
  // ldmatrix lanes: row lr of matrix lj; A's four 8x8 matrices are (k, m)
  // blocks (0,0) (0,8) (8,0) (8,8), B's (k, n) blocks (0,0) (8,0) (0,8) (8,8)
  const int lr = lane & 7, lj = lane >> 3;
  const int a_off = ((lj >> 1) * 8 + lr) * kWLd + wm * 64 + (lj & 1) * 8;
  const int b_off = ((lj & 1) * 8 + lr) * kWLd + wn * 32 + (lj >> 1) * 8;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kWS - 2>();
    __syncthreads();  // stage `step` landed; the slot of step - 1 is free
    const int next = step + kWS - 1;
    if (next < steps) issue(next);
    cp_async_commit();
    if (live) {
      const uint32_t xa = smem_u32(sa + (step % kWS) * kWStage + a_off);
      const uint32_t xb = smem_u32(sb + (step % kWS) * kWStage + b_off);
#pragma unroll
      for (int kk = 0; kk < kWP; kk += 16) {
        uint32_t bq[2][4], af[4][4];  // bq[j]: n8 tiles 2j (regs 0, 1) and 2j + 1 (2, 3)
#pragma unroll
        for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(bq[j], xb + 2 * (kk * kWLd + j * 16));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ldmatrix_x4_trans(af[mt], xa + 2 * (kk * kWLd + mt * 16));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_16x8x16(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                        bq[nt >> 1][2 * (nt & 1)], bq[nt >> 1][2 * (nt & 1) + 1]);
      }
    }
    if (next < steps) store(next);
  }
  float* o = out + ((size_t)b * n_parts + part) * M * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = cn + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rm + mt * 16 + g + 8 * h;
        if (r >= M) continue;
        if (c < N) o[(size_t)r * N + c] = acc[mt][nt][2 * h];
        if (c + 1 < N) o[(size_t)r * N + c + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

constexpr int kDC = 32;  // channel chunk of the depthwise backward

// One 8x8 tile: dt[p][c] = sum_tap w[tap][c] dout[p - off(tap)][c] and
// part[tile][tap][c] = sum_p t[p + off(tap)][c] dout[p][c], with zeros
// outside the image on both maps (the forward's zero padding of t; a row
// shard's halo rows add their terms in dwconv_halo_bwd_kernel).
template <typename T>
__global__ void __launch_bounds__(256)
dwconv_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ t,
                  const T* __restrict__ w, int ldw, T* __restrict__ dt, float* __restrict__ part,
                  int H, int W, int Cn) {
  __shared__ float ds[kHaloPix][kDC + 1];
  __shared__ float ts[kHaloPix][kDC + 1];
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  for (int c0 = 0; c0 < Cn; c0 += kDC) {
    const int nc = min(kDC, Cn - c0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kHaloPix * kDC; idx += blockDim.x) {
      const int p = idx / kDC, j = idx - p * kDC;
      const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
      float dv = 0.f, tv = 0.f;
      if (j < nc && r >= 0 && r < H && c >= 0 && c < W) {
        const size_t o = (((size_t)b * H + r) * W + c) * Cn + c0 + j;
        dv = dout[o];
        tv = t[o];
      }
      ds[p][j] = dv;
      ts[p][j] = tv;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * nc; idx += blockDim.x) {
      const int p = idx / nc, j = idx - p * nc;
      const int pr = p >> 3, pc = p & 7;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = fmaf(ds[(pr + 2 - dy) * kHalo + pc + 2 - dx][j],
                     to_f(w[(dy * 3 + dx) * ldw + c0 + j]), acc);
      dt[tile_pix(b, ty, tx, p, H, W) * Cn + c0 + j] = from_f<T>(acc);
    }
    for (int idx = threadIdx.x; idx < 9 * nc; idx += blockDim.x) {
      const int tap = idx / nc, j = idx - tap * nc;
      const int dy = tap / 3, dx = tap - dy * 3;
      float acc = 0.f;
      for (int p = 0; p < kPix; ++p)
        acc = fmaf(ts[((p >> 3) + dy) * kHalo + (p & 7) + dx][j],
                   ds[((p >> 3) + 1) * kHalo + (p & 7) + 1][j], acc);
      part[((size_t)tile * 9 + tap) * Cn + c0 + j] = acc;
    }
  }
}

constexpr int kLC = 64;  // depth chunk of the 1x1 backward product

// One 8x8 tile of the kernel frame: dxn = d_tile @ W^T (W [C][ldw], the
// forward's [in][out] operand), LayerNorm backward against the input read at
// the rolled position, + extras, dx written there. Per-tile partials:
// lnpart[tile][0:C] = sum dxn * xhat, [C:2C] = sum dxn; bpart[tile][k] =
// sum_p d[p][k] (the Linear bias cotangent).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_linear_bwd_kernel(const T* __restrict__ d, int K, const T* __restrict__ w, int ldw,
                     const T* __restrict__ x, const float* __restrict__ lnw,
                     const T* __restrict__ extra_t, const float* __restrict__ extra_f,
                     T* __restrict__ dx, float* __restrict__ lnpart, float* __restrict__ bpart,
                     int H, int W, int C, int shift, float eps) {
  extern __shared__ float sm[];
  const int ldx = C + 1, ldc = kLC + 1;
  float* dxn = sm;                   // [64][ldx]
  float* xh = dxn + kPix * ldx;      // [64][ldx] xhat
  float* dc = xh + kPix * ldx;       // [64][ldc] chunk of d
  float* rs = dc + kPix * ldc;       // [64] rstd
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  auto src = [&](int i) {
    const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
    return ((size_t)b * H + ((r + shift) % H + H) % H) * W + ((c + shift) % W + W) % W;
  };
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) dxn[(idx / C) * ldx + idx % C] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kLC) {
    const int kc = min(kLC, K - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPix * kc; idx += blockDim.x) {
      const int i = idx / kc, k = idx - i * kc;
      dc[i * ldc + k] = to_f(d[tile_pix(b, ty, tx, i, H, W) * K + k0 + k]);
    }
    __syncthreads();
    if (bpart != nullptr) {
      for (int k = threadIdx.x; k < kc; k += blockDim.x) {
        float s = 0.f;
        for (int i = 0; i < kPix; ++i) s += dc[i * ldc + k];
        bpart[(size_t)tile * K + k0 + k] = s;
      }
    }
    gemm<T>(kPix, C, kc,
        [&](int i, int k) { return dc[i * ldc + k]; },
        [&](int k, int j) { return to_f(w[(size_t)j * ldw + k0 + k]); },
        [&](int i, int j, float v) { dxn[i * ldx + j] += v; });
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  if (lnw != nullptr) {
    for (int i = warp; i < kPix; i += nwarps) {
      const T* xr = x + src(i) * C;
      float s = 0.f;
      for (int k = lane; k < C; k += 32) s += to_f(xr[k]);
      const float mu = warp_sum(s) / C;
      float v = 0.f;
      for (int k = lane; k < C; k += 32) {
        const float t = to_f(xr[k]) - mu;
        v += t * t;
      }
      const float rstd = rsqrtf(warp_sum(v) / C + eps);
      for (int k = lane; k < C; k += 32) xh[i * ldx + k] = (to_f(xr[k]) - mu) * rstd;
      if (lane == 0) rs[i] = rstd;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < C; k += blockDim.x) {
      float sw = 0.f, sb = 0.f;
      for (int i = 0; i < kPix; ++i) {
        sw = fmaf(dxn[i * ldx + k], xh[i * ldx + k], sw);
        sb += dxn[i * ldx + k];
      }
      lnpart[(size_t)tile * 2 * C + k] = sw;
      lnpart[(size_t)tile * 2 * C + C + k] = sb;
    }
    __syncthreads();
    for (int i = warp; i < kPix; i += nwarps) {
      float m1 = 0.f, m2 = 0.f;
      for (int k = lane; k < C; k += 32) {
        const float g = dxn[i * ldx + k] * lnw[k];
        m1 += g;
        m2 = fmaf(g, xh[i * ldx + k], m2);
      }
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
      for (int k = lane; k < C; k += 32) {
        const float g = dxn[i * ldx + k] * lnw[k];
        xh[i * ldx + k] = (g - m1 - xh[i * ldx + k] * m2) * rs[i];  // xh now holds dx
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x)
      xh[(idx / C) * ldx + idx % C] = dxn[(idx / C) * ldx + idx % C];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    const size_t fp = tile_pix(b, ty, tx, i, H, W) * C + k;
    float v = xh[i * ldx + k];
    if (extra_t != nullptr) v += to_f(extra_t[fp]);
    if (extra_f != nullptr) v += extra_f[fp];
    dx[src(i) * C + k] = from_f<T>(v);
  }
}

template <typename T>
cudaError_t launch_wgrad(const void* A, const void* Bm, float* part, float* out, int nb, int P,
                         int M, int N, int n_parts, cudaStream_t stream) {
  const int chunk = ceil_div(ceil_div(P, n_parts), kWK) * kWK;
  float* dst = n_parts > 1 ? part : out;
  wgrad_kernel<T><<<dim3(ceil_div(N, kWN), ceil_div(M, kWM), nb * n_parts), kWThreads, 0, stream>>>(
      (const T*)A, (const T*)Bm, P, M, N, n_parts, chunk, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return err;
  return launch_sum_parts(part, out, nb, n_parts, M * N, stream);
}

// Elements per copy of an operand with rows of `width` bf16 from p: the
// widest of 8, 4, 2 that divides the width and whose byte size aligns p;
// else 1 (element loads).
inline int wgrad_copy_elems(const void* p, int width) {
  for (int v = 8; v >= 2; v >>= 1)
    if (width % v == 0 && aligned(p, 2 * v)) return v;
  return 1;
}

template <int VA, int VB>
cudaError_t launch_wgrad_tc_v(const void* A, const void* Bm, float* dst, int nb, int P, int M,
                              int N, int n_parts, int chunk, cudaStream_t stream) {
  cudaError_t err = set_smem(wgrad_tc_kernel<VA, VB>, kWgradTcSmem);
  if (err != cudaSuccess) return err;
  wgrad_tc_kernel<VA, VB><<<dim3(ceil_div(N, kWT), ceil_div(M, kWT), nb * n_parts), kWTcThreads,
                            kWgradTcSmem, stream>>>((const __nv_bfloat16*)A,
                                                    (const __nv_bfloat16*)Bm, P, M, N, n_parts,
                                                    chunk, dst);
  return cudaGetLastError();
}

template <int VA>
cudaError_t launch_wgrad_tc_b(int vb, const void* A, const void* Bm, float* dst, int nb, int P,
                              int M, int N, int n_parts, int chunk, cudaStream_t stream) {
  switch (vb) {
    case 8: return launch_wgrad_tc_v<VA, 8>(A, Bm, dst, nb, P, M, N, n_parts, chunk, stream);
    case 4: return launch_wgrad_tc_v<VA, 4>(A, Bm, dst, nb, P, M, N, n_parts, chunk, stream);
    case 2: return launch_wgrad_tc_v<VA, 2>(A, Bm, dst, nb, P, M, N, n_parts, chunk, stream);
    default: return launch_wgrad_tc_v<VA, 1>(A, Bm, dst, nb, P, M, N, n_parts, chunk, stream);
  }
}

// The bf16 route: wgrad_tc_kernel over ceil(N / 128) x ceil(M / 128) tiles x
// nb x n_parts, each part kWP-aligned pixels, then the in-order part sums.
cudaError_t launch_wgrad_tc(const void* A, const void* Bm, float* part, float* out, int nb, int P,
                            int M, int N, int n_parts, cudaStream_t stream) {
  if (nb * n_parts > 65535 || M <= 0 || N <= 0) return cudaErrorInvalidValue;
  const int chunk = ceil_div(ceil_div(P, n_parts), kWP) * kWP;
  float* dst = n_parts > 1 ? part : out;
  const int vb = wgrad_copy_elems(Bm, N);
  cudaError_t err;
  switch (wgrad_copy_elems(A, M)) {
    case 8: err = launch_wgrad_tc_b<8>(vb, A, Bm, dst, nb, P, M, N, n_parts, chunk, stream); break;
    case 4: err = launch_wgrad_tc_b<4>(vb, A, Bm, dst, nb, P, M, N, n_parts, chunk, stream); break;
    case 2: err = launch_wgrad_tc_b<2>(vb, A, Bm, dst, nb, P, M, N, n_parts, chunk, stream); break;
    default: err = launch_wgrad_tc_b<1>(vb, A, Bm, dst, nb, P, M, N, n_parts, chunk, stream);
  }
  if (err != cudaSuccess || n_parts == 1) return err;
  return launch_sum_parts(part, out, nb, n_parts, M * N, stream);
}

// The halo-row terms of a row shard's depthwise backward (K10a / K10b: the
// dtop / dbot rows of _sp0_bwd_kernel / _sp1_bwd_kernel's stencil,
// mp_hsir_tpu/ops/pallas_vjp.py:1443, :1501), which dwconv_bwd_kernel and
// bf16's dwconv_dx_tc_kernel leave out: they read t as zero beyond the
// shard and their dt covers the shard's rows only. Side 0 is the row above the shard (read by the taps'
// first row dy = 0 at output row 0), side 1 the row below (dy = 2 at output
// row H - 1). One block per (8 columns, image, side):
//   dt_halo[side][b][c] = sum over dx of dout[row][c + 1 - dx] w[dy][dx]
// in the order of dwconv3_bwd_plain (each product rounded, then added; the
// other taps add zeros), rounded to T; and the tap partials
//   part[side][b W/8 + tx][dx][k] = sum over the block's 8 columns c of
//   t_halo[side][b][c + dx - 1][k] dout[row][c][k],
// zero outside the image's columns. A side without its halo bit writes zeros
// (its row is an image edge, zero after the LayerNorm). The wrapper adds
// part's rows in order (launch_dwconv_halo_bwd) after the tile's partials.
template <typename T>
__global__ void __launch_bounds__(256)
dwconv_halo_bwd_kernel(const float* __restrict__ dout, const T* __restrict__ t_halo,
                       const T* __restrict__ taps, T* __restrict__ dt_halo,
                       float* __restrict__ part, int H, int W, int K, int halo) {
  const int tx = blockIdx.x, b = blockIdx.y, side = blockIdx.z, B = gridDim.y;
  const bool real = halo & (1 << side);
  const int row = side == 0 ? 0 : H - 1, dy = side == 0 ? 0 : 2;
  const float* d = dout + ((size_t)b * H + row) * W * K;  // the output row it reaches
  const T* th = t_halo + ((size_t)side * B + b) * W * K;
  for (int idx = threadIdx.x; idx < kTile * K; idx += blockDim.x) {
    const int pc = idx / K, k = idx - pc * K, c = tx * kTile + pc;
    float acc = 0.f;
    if (real) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int cc = c + dx - 1;  // dout's column: the flipped tap 2 - dx
        const float v = cc >= 0 && cc < W ? d[(size_t)cc * K + k] : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(v, to_f(taps[(size_t)k * 9 + dy * 3 + 2 - dx])));
      }
    }
    dt_halo[(((size_t)side * B + b) * W + c) * K + k] = from_f<T>(acc);
  }
  float* prow = part + (((size_t)side * B + b) * (W / kTile) + tx) * 3 * K;
  for (int idx = threadIdx.x; idx < 3 * K; idx += blockDim.x) {
    const int dx = idx / K, k = idx - dx * K;
    float s = 0.f;
    if (real) {
      for (int pc = 0; pc < kTile; ++pc) {
        const int c = tx * kTile + pc, cc = c + dx - 1;
        if (cc >= 0 && cc < W) s = fmaf(to_f(th[(size_t)cc * K + k]), d[(size_t)c * K + k], s);
      }
    }
    prow[idx] = s;
  }
}

template <typename T>
cudaError_t launch_dwconv_bwd(const float* dout, const float* t, const void* w, int ldw, void* dt,
                              float* part, float* dw, int B, int H, int W, int Cn,
                              cudaStream_t stream) {
  dwconv_bwd_kernel<T><<<dim3(W / kTile, H / kTile, B), 256, 0, stream>>>(
      dout, t, (const T*)w, ldw, (T*)dt, part, H, W, Cn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, dw, 1, B * (H / kTile) * (W / kTile), 9 * Cn, stream);
}

// The halo-row terms, then their tap partials summed in order per side into
// dw_halo [2][3][K].
template <typename T>
cudaError_t launch_dwconv_halo_bwd(const float* dout, const void* t_halo, const void* taps,
                                   void* dt_halo, float* part, float* dw_halo, int B, int H,
                                   int W, int K, int halo, cudaStream_t stream) {
  dwconv_halo_bwd_kernel<T><<<dim3(W / kTile, B, 2), 256, 0, stream>>>(
      dout, (const T*)t_halo, (const T*)taps, (T*)dt_halo, part, H, W, K, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_parts(part, dw_halo, 2, B * (W / kTile), 3 * K, stream);
}

template <typename T>
cudaError_t launch_ln_linear_bwd(const void* d, const void* w, const void* x, const float* lnw,
                                 const void* extra_t, const float* extra_f, void* dx,
                                 float* lnpart, float* dln, float* bpart, float* dbias, int B,
                                 int H, int W, int C, int K, int ldw, int shift, float eps,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kPix * (C + 1) + kPix * (kLC + 1) + kPix);
  cudaError_t err = set_smem(ln_linear_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ln_linear_bwd_kernel<T><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)d, K, (const T*)w, ldw, (const T*)x, lnw, (const T*)extra_t, extra_f, (T*)dx,
      lnpart, bpart, H, W, C, shift, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_tiles = B * (H / kTile) * (W / kTile);
  if (lnw != nullptr && (err = launch_sum_parts(lnpart, dln, 1, n_tiles, 2 * C, stream)) != cudaSuccess)
    return err;
  if (bpart != nullptr) return launch_sum_parts(bpart, dbias, 1, n_tiles, K, stream);
  return cudaSuccess;
}

}  // namespace mp

// out (nb, M, N) float32 = A (nb, P, M)^T B (nb, P, N), A and B in the compute
// type; part holds nb * n_parts * M * N floats (unused when n_parts == 1).
extern "C" int mp_wgrad(const void* A, const void* B, void* part, void* out, int dtype, int nb,
                        int P, int M, int N, int n_parts, void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_wgrad<float>(A, B, (float*)part, (float*)out, nb, P, M, N, n_parts, st);
  return (int)mp::launch_wgrad_tc(A, B, (float*)part, (float*)out, nb, P, M, N, n_parts, st);
}

// Shared memory per block of the bf16 weight product (dynamic, bytes).
extern "C" long long mp_wgrad_tc_smem() { return (long long)mp::kWgradTcSmem; }

// dout, t (B, H, W, Cn) float32; w the forward's [9][ldw] taps (pointer at the
// first column), compute type. Outputs: dt (B, H, W, Cn) compute type, part
// (tiles, 9, Cn) scratch, dw (9, Cn) float32. A row shard's halo rows are
// mp_dwconv_halo_bwd's.
extern "C" int mp_dwconv_bwd(const void* dout, const void* t, const void* w, void* dt,
                             void* part, void* dw, int dtype, int B, int H, int W, int Cn,
                             int ldw, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_dwconv_bwd<float>((const float*)dout, (const float*)t, w, ldw, dt,
                                             (float*)part, (float*)dw, B, H, W, Cn, st);
  return (int)mp::launch_dwconv_bwd<__nv_bfloat16>((const float*)dout, (const float*)t, w, ldw,
                                                   dt, (float*)part, (float*)dw, B, H, W, Cn, st);
}

// A row shard's halo-row terms of the depthwise backward: dout (B, H, W, K)
// float32 the cotangent at the depthwise output, t_halo [2][B][W][K] the
// halo rows' depthwise input (row above, row below), taps [K][9], both in
// the compute type (dtype 0 float32, 1 bf16); halo_flags bit 0 / 1: the row
// above / below is real. Outputs: dt_halo [2][B][W][K] compute type the halo
// rows' cotangents (zero on a side without its bit), part [2][B W/8][3][K]
// scratch, dw_halo [2][3][K] float32 the taps' gradient share of rows dy =
// 0 (side 0) and dy = 2 (side 1).
extern "C" int mp_dwconv_halo_bwd(const void* dout, const void* t_halo, const void* taps,
                                  void* dt_halo, void* part, void* dw_halo, int dtype, int B,
                                  int H, int W, int K, int halo_flags, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto d = (const float*)dout;
  if (dtype == 0)
    return (int)mp::launch_dwconv_halo_bwd<float>(d, t_halo, taps, dt_halo, (float*)part,
                                                  (float*)dw_halo, B, H, W, K, halo_flags, st);
  return (int)mp::launch_dwconv_halo_bwd<__nv_bfloat16>(d, t_halo, taps, dt_halo, (float*)part,
                                                        (float*)dw_halo, B, H, W, K, halo_flags,
                                                        st);
}

// d (B, H, W, K) in the kernel frame; w [C][ldw] (pointer at the first of K
// columns); x (B, H, W, C) the layer input in its own frame (pixel (r, c) of
// the kernel frame is x's (r + shift, c + shift), cyclic); lnw NULL = no LN;
// extra_t / extra_f (B, H, W, C) kernel-frame cotangents added after the LN
// backward (NULL = none); bpart NULL = no bias cotangent. Outputs: dx (x's
// frame), dln (2, C) = (d weight, d bias) of the LN, dbias (K,).
extern "C" int mp_ln_linear_bwd(const void* d, const void* w, const void* x, const void* lnw,
                                const void* extra_t, const void* extra_f, void* dx,
                                void* lnpart, void* dln, void* bpart, void* dbias, int dtype,
                                int B, int H, int W, int C, int K, int ldw, int shift, float eps,
                                void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_ln_linear_bwd<float>(d, w, x, (const float*)lnw, extra_t,
                                                (const float*)extra_f, dx, (float*)lnpart,
                                                (float*)dln, (float*)bpart, (float*)dbias, B, H,
                                                W, C, K, ldw, shift, eps, st);
  return (int)mp::launch_ln_linear_bwd<__nv_bfloat16>(d, w, x, (const float*)lnw, extra_t,
                                                      (const float*)extra_f, dx, (float*)lnpart,
                                                      (float*)dln, (float*)bpart, (float*)dbias,
                                                      B, H, W, C, K, ldw, shift, eps, st);
}

// out (nb, n) = in-order sum over n_parts of part (nb, n_parts, n), float32.
extern "C" int mp_sum_parts(const void* part, void* out, int nb, int n_parts, int n,
                            void* stream) {
  return (int)mp::launch_sum_parts((const float*)part, (float*)out, nb, n_parts, n,
                                   (cudaStream_t)stream);
}
