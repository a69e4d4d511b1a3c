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
// window, and both kernels run the same window tile.
//
// The (-shift, -shift) cyclic roll of shifted windows is index arithmetic on
// the load; the output stays in the rolled frame, like the TPU kernel's
// shift_in path. Scores use an ordinary max-subtracted float32 softmax (the
// TPU kernel's unsubtracted, clipped exp2 is a Mosaic workaround and is not
// copied). LN, softmax and every accumulation are float32; values are
// rounded to the compute type where the JAX kernels cast: qkv after its bias,
// P after normalisation, the heads' output O, y after its bias, the mean.
//
// Bound on this card: operations. A token costs 8C^2 + 256C flops (qkv and
// projection 8C^2, scores and PV 256C) against 4C bytes in and out, so the
// products must run on the tensor cores, fed as fast as they consume.
//
// bf16 (window_tc_kernel): a block of four warps per window (or per half of
// its heads, below); warp w owns token rows 16w .. 16w + 15 from the load to
// the store, so no product waits on another warp's rows except through k
// and v.
// - The window's input (LN(x) for K1, rounded to bf16, or x for K14) is staged
//   once as bf16 rows of C (padded to the 64-deep K chunk) + 8 elements: a
//   16-byte-aligned stride whose eight ldmatrix rows fall on eight distinct
//   bank groups. A whole window fits at every width (50 KB at C = 384), so
//   there is no channel chunking.
// - The wrapper packs the weights into a head-major layout
//   (ops/kernels/window_attention.py: pack_qkv_weight, pack_proj_weight): per
//   head its q, k and v rows [3][DHP][C], and per output chunk of one head
//   width [DHP][C] of Wp, zero-padded to the head width DHP (16 .. 128) and
//   the K chunk. The block streams them as one sequence of [DHP][64] tiles
//   through a cp.async ring (about 40 KB: 2 to 6 stages); each staged tile
//   serves all 64 tokens, with one block-wide barrier per tile.
// - q stays in registers: the m16n8 accumulators of its product, biased and
//   rounded, are m16n8k16 A fragments. k and v go to shared memory (bf16,
//   [64][DHP + 8]). S = q k^T runs in accumulators (16 x 64 per warp), gets
//   the scale, the float32 relative bias and the mask, and is normalised with
//   quad shuffles; P = rnd(e / l) is packed straight from the accumulators
//   into A fragments and O = P V takes V through ldmatrix.trans. No score
//   tile lives in shared memory and no barrier sits between S, the softmax
//   and PV.
// - O (bf16, heads packed) stays in shared memory for the projection
//   Y = O Wp + bp, which streams Wp one head width of output columns at a
//   time. y is staged in the input's buffer and written in 16-byte runs;
//   K1's window means are a fixed-order column sum of the rounded y (no
//   atomics: deterministic).
// - Where windows are few, a window's heads split over a thread-block
//   cluster of two blocks (tc_cluster: where twice the windows still fit on
//   the card at once, e.g. 64 windows at C = 384), which exchange their
//   heads' O through distributed shared memory before the projection; each
//   block writes the output columns of its heads. Elsewhere one window per
//   block (4096 blocks at the flagship's 512^2).
//
// float32 (the checks and the float32 CLI): K1 runs window_f32_kernel, the
// same tile in 3xTF32 on the tensor cores (its note is above the kernel);
// K14's float32 instance keeps the earlier SIMT tile (window_msa_tile<float>:
// float32 staging, SIMT FMA products, input channel chunks of kc where
// C = 384 does not fit). Both are held to 1e-4 of the plain version.
#include <cooperative_groups.h>
#include <math.h>

#include <map>
#include <mutex>
#include <utility>

#include "dwconv_dx.cuh"

namespace mp {

// K14's float32 window tile (SIMT). One window: q|k|v = x Wqkv + bqkv per
// head, scores q k^T / sqrt(dh) + the relative-position bias, masked where the region labels differ (lab in shared
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

// The channel chunk of the float32 window MSA kernel (K14) at (C, nH): C
// where its whole-window plan fits, else 64.
inline int window_chunk(int C, int nH) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(window_msa_kernel<float>, window_smem(C, nH, kc));
  });
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
// bf16 on the tensor cores: window_tc_kernel (K1 with kK1, else K14). The
// design is in the note at the top of this file.
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcK = 64;         // depth of a streamed weight tile
constexpr int kTcLd = kTcK + 8;  // its row stride: 144 B, an odd multiple of 16 B

// The padded head width of the bf16 plan at head width dh (0: dh > 128, no
// plan); ops/kernels/window_attention.py:head_width must agree.
inline int tc_head_width(int dh) {
  for (int d : {16, 32, 48, 64, 96, 128})
    if (dh <= d) return d;
  return 0;
}
// ring stages at head width dhp: about 40 KB of tiles, 2 to 6 of them (2 at
// dhp >= 96, so that two blocks fit on an SM at C = 192 with 2 heads)
__host__ __device__ constexpr int tc_stages(int dhp) {
  return dhp >= 96 ? 2 : 40960 / (dhp * kTcLd * 2) > 6 ? 6 : 40960 / (dhp * kTcLd * 2);
}
__host__ __device__ constexpr int round64(int n) { return (n + kTcK - 1) / kTcK * kTcK; }

// input / y [64][kx + 8], O [64][ko + 8], k and v [64][DHP + 8], the ring
inline size_t window_tc_smem(int C, int nH) {
  const int dhp = tc_head_width(C / nH), kx = round64(C), ko = round64(nH * dhp);
  return sizeof(__nv_bfloat16) * ((size_t)kPix * (kx + 8) + (size_t)kPix * (ko + 8) +
                                  2 * (size_t)kPix * (dhp + 8) + (size_t)tc_stages(dhp) * dhp * kTcLd);
}

__device__ __forceinline__ void st_u32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// eight bf16 (16 bytes) as float32
__device__ __forceinline__ void bf16x8_to_f32(uint4 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// acc (16 rows x DHP columns as m16n8 fragments, acc[4 nt + q]) += A x B^T,
// A the warp's 16 rows at a (row stride lda, 64 deep), B the staged tile wt
// ([DHP][kTcLd]: row n, depth k).
template <int DHP>
__device__ __forceinline__ void tc_rows16_k64(float* acc, const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* wt, int lane) {
  // A: lane gives row lane % 16 at k offset 8 (lane / 16): matrices a0..a3.
  // B: lane gives n row (lane % 8) + 8 (lane / 16) at k offset 8 (lane / 8 % 2):
  // b0, b1 of n8 tile 2p, then of 2p + 1.
  const uint32_t a0 = smem_u32(a + (lane & 15) * lda + 8 * (lane >> 4));
  const uint32_t b0 = smem_u32(wt + ((lane & 7) + 8 * (lane >> 4)) * kTcLd + 8 * ((lane >> 3) & 1));
#pragma unroll
  for (int kk = 0; kk < kTcK / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a0 + 2 * 16 * kk);
#pragma unroll
    for (int p = 0; p < DHP / 16; ++p) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b0 + 2 * (16 * p * kTcLd + 16 * kk));
      mma_16x8x16(acc + 8 * p, af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_16x8x16(acc + 8 * p + 4, af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

// LayerNorm in place on a window's 64 staged bf16 rows xs ([64][ldx]),
// float32 statistics, rounded to bf16: token row threadIdx.x / 2, its 16-byte
// units (vec) or elements split between the thread pair, whose sums meet by
// one shuffle. Called by all kTcThreads threads.
__device__ __forceinline__ void tc_ln_rows(__nv_bfloat16* xs, int ldx, int C, int vec,
                                           const float* __restrict__ lnw,
                                           const float* __restrict__ lnb, float eps) {
  using bf16 = __nv_bfloat16;
  static_assert(kTcThreads == 2 * kPix, "two threads per token row");
  const int hf = threadIdx.x & 1;
  bf16* row = xs + (threadIdx.x >> 1) * ldx;
  float f[8], sum = 0.f, var = 0.f;
  if (vec) {
    for (int c = 8 * hf; c < C; c += 16) {
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(row + c), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += f[e];
    }
  } else {
    for (int k = hf; k < C; k += 2) sum += __bfloat162float(row[k]);
  }
  const float mu = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) / C;
  if (vec) {
    for (int c = 8 * hf; c < C; c += 16) {
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(row + c), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) var += (f[e] - mu) * (f[e] - mu);
    }
  } else {
    for (int k = hf; k < C; k += 2) {
      const float d = __bfloat162float(row[k]) - mu;
      var += d * d;
    }
  }
  const float rs = rsqrtf((var + __shfl_xor_sync(0xffffffffu, var, 1)) / C + eps);
  if (vec) {
    for (int c = 8 * hf; c < C; c += 16) {
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(row + c), f);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16x2((f[2 * e] - mu) * rs * lnw[c + 2 * e] + lnb[c + 2 * e],
                           (f[2 * e + 1] - mu) * rs * lnw[c + 2 * e + 1] + lnb[c + 2 * e + 1]);
      *reinterpret_cast<uint4*>(row + c) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int k = hf; k < C; k += 2)
      row[k] = __float2bfloat16((__bfloat162float(row[k]) - mu) * rs * lnw[k] + lnb[k]);
  }
}

// K1 (kK1): x (B, H, W, C), window w = (b, wy, wx) of the rolled frame, LN
// first, the -100 mask from the (H, W) label map, y in the rolled frame and
// the window means. K14: x (NW, 64, C), window w, no LN, the -inf mask from
// row w % n_pat of the (n_pat, 64) labels. labels NULL: no mask. wqkv
// [nH][3][DHP][round64(C)], wp [nH][DHP][round64(nH DHP)] (the wrapper's
// packs). vec: C % 8 == 0 and x, out 16-byte aligned (16-byte loads and
// stores), else element by element.
//
// G blocks per window (a thread-block cluster of G, G | nH; 1 where windows
// fill the card): block rank r of window w = blockIdx.x / G runs heads
// r nH / G .. and writes output columns of the same heads. Each block stages
// the whole window; after the heads, the cluster exchanges O through
// distributed shared memory, so each block's projection reads all heads.
template <bool kK1, int DHP>
__global__ void __launch_bounds__(kTcThreads)
window_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
                 const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ wqkv,
                 const float* __restrict__ bqkv, const float* __restrict__ bias,
                 const int* __restrict__ labels, int n_pat, const __nv_bfloat16* __restrict__ wp,
                 const float* __restrict__ bp, __nv_bfloat16* __restrict__ out,
                 __nv_bfloat16* __restrict__ pooled, int H, int W, int C, int nH, int shift,
                 float eps, int vec, int G) {
  using bf16 = __nv_bfloat16;
  constexpr int S = tc_stages(DHP), NT = DHP / 8, ldk = DHP + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int lab[kPix];
  const int dh = C / nH, kx = round64(C), ko = round64(nH * DHP);
  const int ldx = kx + 8, ldo = ko + 8;
  bf16* xs = (bf16*)tc_smem;  // [64][ldx] the input, later y
  bf16* os = xs + kPix * ldx;  // [64][ldo] O, heads packed at DHP
  bf16* ks = os + kPix * ldo;  // [64][ldk] k of one head
  bf16* vs = ks + kPix * ldk;  // [64][ldk] v of one head
  bf16* ring = vs + kPix * ldk;  // [S][DHP][kTcLd] weight tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;  // the thread's accumulator rows

  const int w = blockIdx.x / G, rank = blockIdx.x - w * G;
  const int nhb = nH / G, h0 = rank * nhb;  // this block's heads
  int b = 0, wy = 0, wx = 0;
  if (kK1) {
    const int nwx = W / kTile, nwy = H / kTile;
    wx = w % nwx;
    wy = w / nwx % nwy;
    b = w / (nwx * nwy);
  }
  // token i's input row (K1: x[(r + shift) % H, (c + shift) % W] of the
  // rolled frame's window) and output row
  auto src_row = [&](int i) -> const bf16* {
    if (kK1) {
      const int sr = (wy * kTile + (i >> 3) + shift) % H, sc = (wx * kTile + (i & 7) + shift) % W;
      return x + (((size_t)b * H + sr) * W + sc) * C;
    }
    return x + ((size_t)w * kPix + i) * C;
  };
  auto dst_row = [&](int i) -> bf16* {
    return out + (kK1 ? tile_pix(b, wy, wx, i, H, W) : (size_t)w * kPix + i) * C;
  };

  // the input, zero past C
  if (vec) {
    const int units = kx / 8;
    for (int u = threadIdx.x; u < kPix * units; u += kTcThreads) {
      const int i = u / units, c = (u - i * units) * 8;
      const bool in = c < C;
      cp_async16(smem_u32(xs + i * ldx + c), in ? src_row(i) + c : x, in ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * kx; u += kTcThreads) {
      const int i = u / kx, c = u - i * kx;
      xs[i * ldx + c] = c < C ? src_row(i)[c] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  // O's columns past the heads are depth padding of the projection: zeros
  const int opad = ko - nH * DHP;
  for (int u = threadIdx.x; u < kPix * opad; u += kTcThreads) {
    const int i = u / opad;
    os[i * ldo + nH * DHP + u - i * opad] = __float2bfloat16(0.f);
  }
  const bool masked = labels != nullptr;
  if (masked && threadIdx.x < kPix) {
    const int i = threadIdx.x;
    lab[i] = kK1 ? labels[(wy * kTile + (i >> 3)) * W + wx * kTile + (i & 7)]
                 : labels[(w % n_pat) * kPix + i];
  }

  // The weight stream of the block's heads: tile t < nqkv is K chunk t % nkx
  // of section 3 h0 + t / nkx (head h = / 3, q | k | v = % 3) of wqkv; then K
  // chunk u % nko of output chunk h0 + u / nko of wp (u = t - nqkv). Each
  // call of next() waits for tile t, passes one block-wide barrier (after it
  // nobody reads tile t - 1, whose buffer takes tile t + S - 1), issues that
  // tile and returns tile t.
  const int nkx = kx / kTcK, nko = ko / kTcK, nqkv = 3 * nhb * nkx, T = nqkv + nhb * nko;
  auto issue = [&](int t) {
    if (t < T) {
      const bf16* src;
      int ld;
      if (t < nqkv) {
        const int sec = t / nkx;
        src = wqkv + (size_t)(3 * h0 + sec) * DHP * kx + (t - sec * nkx) * kTcK;
        ld = kx;
      } else {
        const int u = t - nqkv, j = u / nko;
        src = wp + (size_t)(h0 + j) * DHP * ko + (u - j * nko) * kTcK;
        ld = ko;
      }
      bf16* dst = ring + (t % S) * DHP * kTcLd;
      for (int u = threadIdx.x; u < DHP * (kTcK / 8); u += kTcThreads) {
        const int r = u >> 3, c = (u & 7) * 8;
        cp_async16(smem_u32(dst + r * kTcLd + c), src + (size_t)r * ld + c, 16);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < S - 1; ++t) issue(t);
  cp_async_wait<S - 1>();  // the input has landed
  __syncthreads();
  if (kK1) tc_ln_rows(xs, ldx, C, vec, lnw, lnb, eps);
  int t = 0;
  auto next = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue(t + S - 1);
    return ring + (t++ % S) * DHP * kTcLd;
  };

  const float scale = rsqrtf((float)dh);
  const bf16* xa = xs + 16 * warp * ldx;
  // key rows of k for S (non-trans, as B), key rows of v for PV (trans)
  const uint32_t kb = smem_u32(ks + ((lane & 7) + 8 * (lane >> 4)) * ldk + 8 * ((lane >> 3) & 1));
  const uint32_t vb = smem_u32(vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldk + 8 * (lane >> 4));
  for (int h = h0; h < h0 + nhb; ++h) {
    uint32_t qa[DHP / 16][4];  // q of the warp's rows as A fragments
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float acc[NT * 4];
#pragma unroll
      for (int q = 0; q < NT * 4; ++q) acc[q] = 0.f;
      for (int kc = 0; kc < nkx; ++kc) tc_rows16_k64<DHP>(acc, xa + kc * kTcK, ldx, next(), lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * t4;
        const float* bq = bqkv + s * C + h * dh + col;
        const float b0 = col < dh ? bq[0] : 0.f, b1 = col + 1 < dh ? bq[1] : 0.f;
        const uint32_t lo = pack_bf16x2(acc[4 * nt] + b0, acc[4 * nt + 1] + b1);
        const uint32_t hi = pack_bf16x2(acc[4 * nt + 2] + b0, acc[4 * nt + 3] + b1);
        if (s == 0) {
          qa[nt >> 1][2 * (nt & 1)] = lo;
          qa[nt >> 1][2 * (nt & 1) + 1] = hi;
        } else {
          bf16* d = s == 1 ? ks : vs;
          st_u32(d + r0 * ldk + col, lo);
          st_u32(d + r1 * ldk + col, hi);
        }
      }
    }
    __syncthreads();  // k and v of head h are complete

    // S = q k^T: 16 rows x 64 keys, sc[4 nt + q] for keys 8 nt ..
    float sc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) sc[q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kb + 2 * (16 * p * ldk + 16 * kk));
        mma_16x8x16(sc + 8 * p, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bf[0], bf[1]);
        mma_16x8x16(sc + 8 * p + 4, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bf[2], bf[3]);
      }
    // scale, relative bias, mask; max-subtracted softmax over the quad's rows
    const float* bh = bias + (size_t)h * kPix * kPix;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t4;
      const float2 c0 = *reinterpret_cast<const float2*>(bh + r0 * kPix + col);
      const float2 c1 = *reinterpret_cast<const float2*>(bh + r1 * kPix + col);
      float* v = sc + 4 * nt;
      v[0] = v[0] * scale + c0.x;
      v[1] = v[1] * scale + c0.y;
      v[2] = v[2] * scale + c1.x;
      v[3] = v[3] * scale + c1.y;
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (lab[e < 2 ? r0 : r1] != lab[col + (e & 1)]) v[e] = kK1 ? v[e] - 100.f : -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(v[0], v[1]));
      m1 = fmaxf(m1, fmaxf(v[2], v[3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* v = sc + 4 * nt;
      v[0] = expf(v[0] - m0);
      v[1] = expf(v[1] - m0);
      v[2] = expf(v[2] - m1);
      v[3] = expf(v[3] - m1);
      l0 += v[0] + v[1];
      l1 += v[2] + v[3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;

    // O = rnd(P) V: the accumulators of keys 16 kk .. are the A fragment
    float oa[NT * 4];
#pragma unroll
    for (int q = 0; q < NT * 4; ++q) oa[q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* s0 = sc + 8 * kk;
      const float* s1 = s0 + 4;
      const uint32_t a0 = pack_bf16x2(s0[0] * i0, s0[1] * i0);
      const uint32_t a1 = pack_bf16x2(s0[2] * i1, s0[3] * i1);
      const uint32_t a2 = pack_bf16x2(s1[0] * i0, s1[1] * i0);
      const uint32_t a3 = pack_bf16x2(s1[2] * i1, s1[3] * i1);
#pragma unroll
      for (int p = 0; p < DHP / 16; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vb + 2 * (16 * kk * ldk + 16 * p));
        mma_16x8x16(oa + 8 * p, a0, a1, a2, a3, bf[0], bf[1]);
        mma_16x8x16(oa + 8 * p + 4, a0, a1, a2, a3, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = h * DHP + 8 * nt + 2 * t4;
      st_u32(os + r0 * ldo + col, pack_bf16x2(oa[4 * nt], oa[4 * nt + 1]));
      st_u32(os + r1 * ldo + col, pack_bf16x2(oa[4 * nt + 2], oa[4 * nt + 3]));
    }
  }

  if (G > 1) {  // the other heads' O from the cluster's blocks
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's O is complete
    const int units = nhb * DHP / 8;
    for (int q = 1; q < G; ++q) {
      const int peer = (rank + q) % G;
      const bf16* src = cluster.map_shared_rank(os, peer);
      for (int u = threadIdx.x; u < kPix * units; u += kTcThreads) {
        const int i = u / units, c = peer * nhb * DHP + (u - i * units) * 8;
        *reinterpret_cast<uint4*>(os + i * ldo + c) =
            *reinterpret_cast<const uint4*>(src + i * ldo + c);
      }
    }
  }

  // y = O Wp + bp, one head width of output columns at a time, staged in xs
  // (the warp's own rows: its input is no longer read)
  const bf16* oaddr = os + 16 * warp * ldo;
  for (int j = h0; j < h0 + nhb; ++j) {
    float acc[NT * 4];
#pragma unroll
    for (int q = 0; q < NT * 4; ++q) acc[q] = 0.f;
    for (int kc = 0; kc < nko; ++kc) tc_rows16_k64<DHP>(acc, oaddr + kc * kTcK, ldo, next(), lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t4 + (e & 1);
        if (col < dh)
          xs[(e < 2 ? r0 : r1) * ldx + j * dh + col] =
              __float2bfloat16(acc[4 * nt + e] + bp[j * dh + col]);
      }
  }
  __syncthreads();
  // the block's output columns c0 .. c0 + cb - 1
  const int c0 = h0 * dh, cb = nhb * dh;
  if (vec && c0 % 8 == 0 && cb % 8 == 0) {
    const int units = cb / 8;
    for (int u = threadIdx.x; u < kPix * units; u += kTcThreads) {
      const int i = u / units, c = c0 + (u - i * units) * 8;
      *reinterpret_cast<uint4*>(dst_row(i) + c) = *reinterpret_cast<const uint4*>(xs + i * ldx + c);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * cb; u += kTcThreads) {
      const int i = u / cb, c = c0 + u - i * cb;
      dst_row(i)[c] = xs[i * ldx + c];
    }
  }
  if (kK1) {
    // the window's mean of the rounded y, in a fixed order: item (column
    // pair p, row quarter q) sums rows 16 q .. 16 q + 15 in order; the four
    // quarters of a pair sit on neighbouring lanes and meet by two shuffles
    if (c0 % 2 == 0 && cb % 2 == 0) {
      const int items = 2 * cb;  // cb / 2 pairs x 4 quarters
      for (int base = 0; base < items; base += kTcThreads) {
        const int it = base + threadIdx.x, c = c0 + 2 * (it >> 2), q = it & 3;
        float s0 = 0.f, s1 = 0.f;
        if (it < items) {
          for (int i = 16 * q; i < 16 * q + 16; ++i) {
            const float2 v =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + i * ldx + c));
            s0 += v.x;
            s1 += v.y;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (it < items && q == 0)
          st_u32(pooled + (size_t)w * C + c, pack_bf16x2(s0 * (1.f / kPix), s1 * (1.f / kPix)));
      }
    } else {
      for (int c = c0 + threadIdx.x; c < c0 + cb; c += kTcThreads) {
        float sum = 0.f;
        for (int i = 0; i < kPix; ++i) sum += __bfloat162float(xs[i * ldx + c]);
        pooled[(size_t)w * C + c] = __float2bfloat16(sum * (1.f / kPix));
      }
    }
  }
  // no block of the cluster leaves while another may still read its O
  if (G > 1) cooperative_groups::this_cluster().sync();
}

using TcKernel = void (*)(const __nv_bfloat16*, const float*, const float*, const __nv_bfloat16*,
                          const float*, const float*, const int*, int, const __nv_bfloat16*,
                          const float*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,
                          float, int, int);

// the instance of head width dhp (nullptr: none)
template <bool kK1>
inline TcKernel tc_kernel_for(int dhp) {
  switch (dhp) {
    case 16: return window_tc_kernel<kK1, 16>;
    case 32: return window_tc_kernel<kK1, 32>;
    case 48: return window_tc_kernel<kK1, 48>;
    case 64: return window_tc_kernel<kK1, 64>;
    case 96: return window_tc_kernel<kK1, 96>;
    case 128: return window_tc_kernel<kK1, 128>;
    default: return nullptr;
  }
}

// The bf16 plan at (C, nH): shared memory per block, static included (-1:
// no plan, dh > 128).
template <bool kK1>
inline long long window_tc_plan(int C, int nH) {
  const TcKernel k = tc_kernel_for<kK1>(tc_head_width(C / nH));
  return k == nullptr ? -1 : plan_bytes(k, window_tc_smem(C, nH));
}

// Blocks per window (the cluster size G): 2 where nH is even and twice the
// windows still fit on the card at once (64 windows at C = 384, 128 at
// C = 256), else 1. Splitting further, or into a second wave, measured
// slower: each block stages and normalises the whole window.
inline int tc_cluster(TcKernel kernel, size_t smem, int nwin, int nH) {
  if (nH % 2 != 0) return 1;
  // the card's block slots for (kernel, smem), asked of the runtime once
  static std::mutex mu;
  static std::map<std::pair<TcKernel, size_t>, long long> slots;
  std::lock_guard<std::mutex> lock(mu);
  auto it = slots.find({kernel, smem});
  if (it == slots.end()) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem) !=
            cudaSuccess)
      return 1;
    it = slots.emplace(std::make_pair(kernel, smem), (long long)sms * per_sm).first;
  }
  return 2LL * nwin <= it->second ? 2 : 1;
}

// The cluster size the bf16 kernel launches with for nwin windows at (C, nH)
// (k14: the window MSA's instance); 0 where there is no bf16 plan.
template <bool kK1>
inline int window_tc_cluster(int C, int nH, int nwin) {
  const TcKernel kernel = tc_kernel_for<kK1>(tc_head_width(C / nH));
  if (kernel == nullptr) return 0;
  const size_t smem = window_tc_smem(C, nH);
  if (set_smem(kernel, smem) != cudaSuccess) return 0;
  return tc_cluster(kernel, smem, nwin, nH);
}

template <bool kK1>
cudaError_t launch_window_tc(const void* x, const float* lnw, const float* lnb, const void* wqkv,
                             const float* bqkv, const float* bias, const int* labels, int n_pat,
                             const void* wp, const float* bp, void* out, void* pooled, int nwin,
                             int H, int W, int C, int nH, int shift, float eps,
                             cudaStream_t stream) {
  const TcKernel kernel = tc_kernel_for<kK1>(tc_head_width(C / nH));
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = window_tc_smem(C, nH);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = tc_cluster(kernel, smem, nwin, nH);
  const int vec = C % 8 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0;
  using bf16 = __nv_bfloat16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nwin * G);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)x, lnw, lnb, (const bf16*)wqkv, bqkv, bias,
                           labels, n_pat, (const bf16*)wp, bp, (bf16*)out, (bf16*)pooled, H, W, C,
                           nH, shift, eps, vec, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: window_f32_kernel (K1), the twin of
// window_tc_kernel in 3xTF32 (m16n8k8 mma.sync, each operand split into big =
// tf32(x) and small = tf32(x - big), three products per k8 step summed from
// zero on the tensor cores and added to float32 registers: common.cuh's
// helpers, as the float32 tail tile runs them). The same block (four warps
// per window, warp w owning token rows 16w .. 16w + 15 from the load to the
// store), the same head-major packs in float32 (rows of 64-float tiles, 16
// bytes aligned) through a cp.async ring of [DHP][68] tiles, the same data
// flow:
// - the window staged once as float32 [64][kx + 4] (16-byte cp.async where
//   C % 4 == 0 and x, out are 16-byte aligned, else element by element), LN
//   in place, float32 statistics;
// - q stays in registers; k [64][DHP + 8] and v [64][DHP + 4] go to shared
//   memory in float32. The accumulators of a m16n8 product hold columns 2t
//   and 2t + 1 of the thread's rows, where an m16n8k8 A fragment wants
//   columns t and t + 4; the k order of q k^T and of P V is free, so each
//   k8 step takes its eight columns in the order 0, 2, 4, 6, 1, 3, 5, 7: q's
//   and P's accumulators are A fragments as they stand, and k (a float2 at
//   columns 2t, 2t + 1 of key row g) and v (rows 2t and 2t + 1 of the step's
//   keys) are read in the same order. The row strides put every such read
//   on distinct banks (k: 8 or 24 words mod 32 for the float2 reads; v: 4
//   or 20);
// - S = q k^T in accumulators with the scale, the float32 relative bias and
//   K1's -100 mask, a max-subtracted float32 softmax normalised by quad
//   shuffles, P in registers for P V, O [64][ko + 4] in shared memory for
//   Y = O Wp + bp, which streams Wp one head width of output columns at a
//   time; y staged in the input's buffer; the window means a fixed-order
//   column sum (no atomics: deterministic).
// Shared memory: the plan (window_f32_smem) holds the window and O whole at
// every preset width but C = 384 (8 heads of 48: 252,416 B). There a
// window's heads split over a cluster of two blocks (as window_tc_kernel's
// do where windows are few; float32 splits only where it must): each block
// keeps only its heads' O ([64][196]), the pair waits on the cluster, each
// block copies both halves of O through distributed shared memory into its
// dead input buffer, waits again, and projects its heads' output columns
// from the whole O (203,264 B). The
// projection's sums run in the same order whatever the split, so one and
// two blocks per window give the same bits. A head width over 128, or a
// width whose plan fits neither way, has no plan: the wrapper raises.
// ---------------------------------------------------------------------------

constexpr int kTcLdF = kTcK + 4;  // float32 weight-tile row stride: 272 B, 4 words mod 32
constexpr int kTcF32Ring = 26624;  // bytes of weight tiles the float32 ring aims at

// ring stages at head width dhp: about 26 KB of [DHP][68] float32 tiles, 2 to
// 6 (3 at dhp 32, so that two blocks fit on an SM at C = 128)
__host__ __device__ constexpr int tc_f32_stages(int dhp) {
  return kTcF32Ring / (dhp * kTcLdF * 4) > 6   ? 6
         : kTcF32Ring / (dhp * kTcLdF * 4) < 2 ? 2
                                               : kTcF32Ring / (dhp * kTcLdF * 4);
}

// the float32 plan at (C, nH) with G blocks per window (dynamic bytes): the
// input, later the assembled O (G = 2) or y (G = 1), [64][max(kx, ko) + 4];
// O of the block's heads [64][ldo] (G = 1: ko + 4; G = 2: nH DHP / 2 + 4,
// later y); k [64][DHP + 8]; v [64][DHP + 4]; the ring [S][DHP][kTcLdF]
inline size_t window_f32_smem(int C, int nH, int G) {
  const int dhp = tc_head_width(C / nH), kx = round64(C), ko = round64(nH * dhp);
  const int ldx = (kx > ko ? kx : ko) + 4, ldo = (G == 1 ? ko : nH / G * dhp) + 4;
  return sizeof(float) * ((size_t)kPix * ldx + (size_t)kPix * ldo + (size_t)kPix * (2 * dhp + 12) +
                          (size_t)tc_f32_stages(dhp) * dhp * kTcLdF);
}

// acc (16 rows x DHP columns as m16n8 fragments, acc[4 nt + q]) += A x B^T
// in 3xTF32, A the warp's 16 rows at a (row stride lda floats, 4 words mod
// 32; 64 deep), B the staged float32 tile wt ([DHP][kTcLdF]: row n, depth k).
template <int DHP>
__device__ __forceinline__ void tc_rows16_k64_f32(float* acc, const float* a, int lda,
                                                  const float* wt, int lane) {
  // A: lane gives row lane % 16 at k offset 4 (lane / 16): matrices a0..a3.
  // B: lane gives n row (lane % 8) + 8 (lane / 16) at k offset 4 (lane / 8 % 2):
  // b0, b1 of n8 tile 2p, then of 2p + 1.
  const uint32_t a0 = smem_u32(a + (lane & 15) * lda + 4 * (lane >> 4));
  const uint32_t b0 = smem_u32(wt + ((lane & 7) + 8 * (lane >> 4)) * kTcLdF + 4 * ((lane >> 3) & 1));
#pragma unroll
  for (int kk = 0; kk < kTcK / 8; ++kk) {
    uint32_t av[4], ab[4], as[4];
    ldmatrix_x4(av, a0 + 4 * 8 * kk);
    split_tf32(av, ab, as);
#pragma unroll
    for (int p = 0; p < DHP / 16; ++p)
      mma_pair_f32(acc + 8 * p, acc + 8 * p + 4, ab, as, b0 + 4 * (16 * p * kTcLdF + 8 * kk));
  }
}

// LayerNorm in place on a window's 64 staged float32 rows xs ([64][ldx]):
// token row threadIdx.x / 2, its 16-byte units (vec) or elements split
// between the thread pair, whose sums meet by one shuffle. Called by all
// kTcThreads threads; each warp normalises its own 16 rows.
__device__ __forceinline__ void tc_ln_rows_f32(float* xs, int ldx, int C, int vec,
                                               const float* __restrict__ lnw,
                                               const float* __restrict__ lnb, float eps) {
  const int hf = threadIdx.x & 1;
  float* row = xs + (threadIdx.x >> 1) * ldx;
  float sum = 0.f, var = 0.f;
  if (vec) {
    for (int c = 4 * hf; c < C; c += 8) {
      const float4 v = *reinterpret_cast<const float4*>(row + c);
      sum += v.x + v.y + v.z + v.w;
    }
  } else {
    for (int k = hf; k < C; k += 2) sum += row[k];
  }
  const float mu = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) / C;
  if (vec) {
    for (int c = 4 * hf; c < C; c += 8) {
      const float4 v = *reinterpret_cast<const float4*>(row + c);
      var += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu) + (v.z - mu) * (v.z - mu) +
             (v.w - mu) * (v.w - mu);
    }
  } else {
    for (int k = hf; k < C; k += 2) var += (row[k] - mu) * (row[k] - mu);
  }
  const float rs = rsqrtf((var + __shfl_xor_sync(0xffffffffu, var, 1)) / C + eps);
  for (int k = hf; k < C; k += 2) row[k] = (row[k] - mu) * rs * lnw[k] + lnb[k];
}

// K1 in float32: x (B, H, W, C), window w = (b, wy, wx) of the rolled frame,
// LN first, the -100 mask from the (H, W) label map (NULL: no mask), y in
// the rolled frame and the window means. wqkv [nH][3][DHP][round64(C)], wp
// [nH][DHP][round64(nH DHP)] (the wrapper's packs, float32). vec: C % 4 == 0
// and x, out 16-byte aligned. G blocks per window (1 or 2, a cluster of G):
// block rank r of window w = blockIdx.x / G runs heads r nH / G .. and writes
// the output columns of the same heads.
template <int DHP>
__global__ void __launch_bounds__(kTcThreads)
window_f32_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                  const float* __restrict__ lnb, const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const float* __restrict__ bias,
                  const int* __restrict__ labels, const float* __restrict__ wp,
                  const float* __restrict__ bp, float* __restrict__ out,
                  float* __restrict__ pooled, int H, int W, int C, int nH, int shift, float eps,
                  int vec, int G) {
  constexpr int S = tc_f32_stages(DHP), NT = DHP / 8, ldk = DHP + 8, ldv = DHP + 4;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int lab[kPix];
  const int dh = C / nH, kx = round64(C), ko = round64(nH * DHP), nhb = nH / G;
  const int ldx = (kx > ko ? kx : ko) + 4, ldo = (G == 1 ? ko : nhb * DHP) + 4;
  float* xs = (float*)tc_smem;   // [64][ldx] the input; then O (G = 2) or y (G = 1)
  float* os = xs + kPix * ldx;   // [64][ldo] O of the block's heads; then y (G = 2)
  float* ks = os + kPix * ldo;   // [64][ldk] k of one head
  float* vs = ks + kPix * ldk;   // [64][ldv] v of one head
  float* ring = vs + kPix * ldv;  // [S][DHP][kTcLdF] weight tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // the thread's accumulator rows

  const int w = blockIdx.x / G, rank = blockIdx.x - w * G, h0 = rank * nhb;
  const int nwx = W / kTile, nwy = H / kTile;
  const int wx = w % nwx, wy = w / nwx % nwy, b = w / (nwx * nwy);
  // token i's input row (x[(r + shift) % H, (c + shift) % W] of the rolled
  // frame's window) and output row
  auto src_row = [&](int i) -> const float* {
    const int sr = (wy * kTile + (i >> 3) + shift) % H, sc = (wx * kTile + (i & 7) + shift) % W;
    return x + (((size_t)b * H + sr) * W + sc) * C;
  };
  auto dst_row = [&](int i) -> float* { return out + tile_pix(b, wy, wx, i, H, W) * C; };

  // the input, zero from C to kx
  if (vec) {
    const int units = kx / 4;
    for (int u = threadIdx.x; u < kPix * units; u += kTcThreads) {
      const int i = u / units, c = (u - i * units) * 4;
      const bool in = c < C;
      cp_async16(smem_u32(xs + i * ldx + c), in ? src_row(i) + c : x, in ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * kx; u += kTcThreads) {
      const int i = u / kx, c = u - i * kx;
      xs[i * ldx + c] = c < C ? src_row(i)[c] : 0.f;
    }
  }
  cp_async_commit();
  const int opad = ko - nH * DHP;  // O's columns past the heads: depth padding, zeros
  if (G == 1) {
    for (int u = threadIdx.x; u < kPix * opad; u += kTcThreads) {
      const int i = u / opad;
      os[i * ldo + nH * DHP + u - i * opad] = 0.f;
    }
  }
  const bool masked = labels != nullptr;
  if (masked && threadIdx.x < kPix) {
    const int i = threadIdx.x;
    lab[i] = labels[(wy * kTile + (i >> 3)) * W + wx * kTile + (i & 7)];
  }

  // The weight stream of the block's heads, window_tc_kernel's order: tile
  // t < nqkv is K chunk t % nkx of section 3 h0 + t / nkx of wqkv; then K
  // chunk u % nko of output chunk h0 + u / nko of wp (u = t - nqkv). next()
  // waits for tile t, passes one block-wide barrier, issues tile t + S - 1
  // into the buffer tile t - 1 left and returns tile t.
  const int nkx = kx / kTcK, nko = ko / kTcK, nqkv = 3 * nhb * nkx, T = nqkv + nhb * nko;
  auto issue = [&](int t) {
    if (t < T) {
      const float* src;
      int ld;
      if (t < nqkv) {
        const int sec = t / nkx;
        src = wqkv + (size_t)(3 * h0 + sec) * DHP * kx + (t - sec * nkx) * kTcK;
        ld = kx;
      } else {
        const int u = t - nqkv, j = u / nko;
        src = wp + (size_t)(h0 + j) * DHP * ko + (u - j * nko) * kTcK;
        ld = ko;
      }
      float* dst = ring + (t % S) * DHP * kTcLdF;
      for (int u = threadIdx.x; u < DHP * (kTcK / 4); u += kTcThreads) {
        const int r = u >> 4, c = (u & 15) * 4;
        cp_async16(smem_u32(dst + r * kTcLdF + c), src + (size_t)r * ld + c, 16);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < S - 1; ++t) issue(t);
  cp_async_wait<S - 1>();  // the input has landed
  __syncthreads();
  tc_ln_rows_f32(xs, ldx, C, vec, lnw, lnb, eps);
  int t = 0;
  auto next = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue(t + S - 1);
    return ring + (t++ % S) * DHP * kTcLdF;
  };

  const float scale = rsqrtf((float)dh);
  const float* xa = xs + 16 * warp * ldx;
  for (int h = h0; h < h0 + nhb; ++h) {
    float q[NT * 4];  // q + bq of the warp's rows, as m16n8 accumulators
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float acc[NT * 4];
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) acc[e] = 0.f;
      for (int kc = 0; kc < nkx; ++kc)
        tc_rows16_k64_f32<DHP>(acc, xa + kc * kTcK, ldx, next(), lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * t4;
        const float* bq = bqkv + s * C + h * dh + col;
        const float b0 = col < dh ? bq[0] : 0.f, b1 = col + 1 < dh ? bq[1] : 0.f;
        const float2 lo = make_float2(acc[4 * nt] + b0, acc[4 * nt + 1] + b1);
        const float2 hi = make_float2(acc[4 * nt + 2] + b0, acc[4 * nt + 3] + b1);
        if (s == 0) {
          q[4 * nt] = lo.x;
          q[4 * nt + 1] = lo.y;
          q[4 * nt + 2] = hi.x;
          q[4 * nt + 3] = hi.y;
        } else {
          float* d = s == 1 ? ks : vs;
          const int ld = s == 1 ? ldk : ldv;
          *reinterpret_cast<float2*>(d + r0 * ld + col) = lo;
          *reinterpret_cast<float2*>(d + r1 * ld + col) = hi;
        }
      }
    }
    __syncthreads();  // k and v of head h are complete

    // S = q k^T: 16 rows x 64 keys, sc[4 p + e] for keys 8 p ..; k8 step kk
    // takes columns 8 kk + (0, 2, 4, 6, 1, 3, 5, 7): q's accumulators (rows
    // g, g + 8; columns 2t, 2t + 1) are its A fragment, k's row g its float2
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t av[4] = {__float_as_uint(q[4 * kk]), __float_as_uint(q[4 * kk + 2]),
                              __float_as_uint(q[4 * kk + 1]), __float_as_uint(q[4 * kk + 3])};
      uint32_t ab[4], as[4];
      split_tf32(av, ab, as);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float2 kv = *reinterpret_cast<const float2*>(ks + (8 * p + g) * ldk + 8 * kk + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kv.x, bb0, bs0);
        split_tf32(kv.y, bb1, bs1);
        mma_3xtf32(sc + 4 * p, ab, as, bb0, bb1, bs0, bs1);
      }
    }
    // scale, relative bias, mask; max-subtracted softmax over the quad's rows
    const float* bh = bias + (size_t)h * kPix * kPix;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t4;
      const float2 c0 = *reinterpret_cast<const float2*>(bh + r0 * kPix + col);
      const float2 c1 = *reinterpret_cast<const float2*>(bh + r1 * kPix + col);
      float* v = sc + 4 * nt;
      v[0] = v[0] * scale + c0.x;
      v[1] = v[1] * scale + c0.y;
      v[2] = v[2] * scale + c1.x;
      v[3] = v[3] * scale + c1.y;
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (lab[e < 2 ? r0 : r1] != lab[col + (e & 1)]) v[e] -= 100.f;
      }
      m0 = fmaxf(m0, fmaxf(v[0], v[1]));
      m1 = fmaxf(m1, fmaxf(v[2], v[3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* v = sc + 4 * nt;
      v[0] = expf(v[0] - m0);
      v[1] = expf(v[1] - m0);
      v[2] = expf(v[2] - m1);
      v[3] = expf(v[3] - m1);
      l0 += v[0] + v[1];
      l1 += v[2] + v[3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;

    // O = P V: k8 step kk takes keys 8 kk + (0, 2, 4, 6, 1, 3, 5, 7), so P's
    // accumulators of keys 8 kk .. are its A fragment and v is read at rows
    // 8 kk + 2t (b0) and + 1 (b1), column 8 nt + g
    float oa[NT * 4];
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) oa[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* s0 = sc + 4 * kk;
      const uint32_t av[4] = {__float_as_uint(s0[0] * i0), __float_as_uint(s0[2] * i1),
                              __float_as_uint(s0[1] * i0), __float_as_uint(s0[3] * i1)};
      uint32_t ab[4], as[4];
      split_tf32(av, ab, as);
      const float* v0 = vs + (8 * kk + 2 * t4) * ldv + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(v0[8 * nt], bb0, bs0);
        split_tf32(v0[ldv + 8 * nt], bb1, bs1);
        mma_3xtf32(oa + 4 * nt, ab, as, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (h - h0) * DHP + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(os + r0 * ldo + col) = make_float2(oa[4 * nt], oa[4 * nt + 1]);
      *reinterpret_cast<float2*>(os + r1 * ldo + col) =
          make_float2(oa[4 * nt + 2], oa[4 * nt + 3]);
    }
  }

  // the projection's operand (all heads' O) and where y is staged: G = 1 O
  // in os, y over the warp's own rows of the input; G = 2 O assembled in the
  // input's buffer, y over the block's O (output column c at c - c0)
  const int c0 = h0 * dh, cb = nhb * dh;
  const float* oall = os;
  int lda = ldo, ldy = ldx, yc0 = 0;
  float* ys = xs;
  if (G > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's O is complete
    const int units = nhb * DHP / 4;
    for (int q = 0; q < G; ++q) {
      const int peer = (rank + q) % G;
      const float* src = q == 0 ? os : cluster.map_shared_rank(os, peer);
      for (int u = threadIdx.x; u < kPix * units; u += kTcThreads) {
        const int i = u / units, c = (u - i * units) * 4;
        *reinterpret_cast<float4*>(xs + i * ldx + peer * nhb * DHP + c) =
            *reinterpret_cast<const float4*>(src + i * ldo + c);
      }
    }
    for (int u = threadIdx.x; u < kPix * opad; u += kTcThreads) {
      const int i = u / opad;
      xs[i * ldx + nH * DHP + u - i * opad] = 0.f;
    }
    cluster.sync();  // O is whole in every block; no block reads a peer's os again
    oall = xs;
    lda = ldx;
    ys = os;
    ldy = ldo;
    yc0 = c0;
  }

  // y = O Wp + bp, one head width of output columns at a time (each warp its
  // own rows)
  const float* oaddr = oall + 16 * warp * lda;
  for (int j = h0; j < h0 + nhb; ++j) {
    float acc[NT * 4];
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) acc[e] = 0.f;
    for (int kc = 0; kc < nko; ++kc)
      tc_rows16_k64_f32<DHP>(acc, oaddr + kc * kTcK, lda, next(), lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t4 + (e & 1);
        if (col < dh)
          ys[(e < 2 ? r0 : r1) * ldy + j * dh + col - yc0] = acc[4 * nt + e] + bp[j * dh + col];
      }
  }
  __syncthreads();
  // the block's output columns c0 .. c0 + cb - 1, then their window means,
  // each column summed over the 64 rows in order
  const float* yb = ys + c0 - yc0;
  if (vec && c0 % 4 == 0 && cb % 4 == 0) {
    const int units = cb / 4;
    for (int u = threadIdx.x; u < kPix * units; u += kTcThreads) {
      const int i = u / units, c = (u - i * units) * 4;
      *reinterpret_cast<float4*>(dst_row(i) + c0 + c) =
          *reinterpret_cast<const float4*>(yb + i * ldy + c);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * cb; u += kTcThreads) {
      const int i = u / cb, c = u - i * cb;
      dst_row(i)[c0 + c] = yb[i * ldy + c];
    }
  }
  for (int c = threadIdx.x; c < cb; c += kTcThreads) {
    float sum = 0.f;
    for (int i = 0; i < kPix; ++i) sum += yb[i * ldy + c];
    pooled[(size_t)w * C + c0 + c] = sum * (1.f / kPix);
  }
}

using F32Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, const int*, const float*, const float*, float*, float*,
                           int, int, int, int, int, float, int, int);

// the float32 instance of head width dhp (nullptr: none)
inline F32Kernel f32_kernel_for(int dhp) {
  switch (dhp) {
    case 16: return window_f32_kernel<16>;
    case 32: return window_f32_kernel<32>;
    case 48: return window_f32_kernel<48>;
    case 64: return window_f32_kernel<64>;
    case 96: return window_f32_kernel<96>;
    case 128: return window_f32_kernel<128>;
    default: return nullptr;
  }
}

// Blocks per window of the float32 tile at (C, nH): 1 where the one-block
// plan fits the device; else 2 where nH is even and the split plan fits; 0:
// no plan.
inline int window_f32_blocks(int C, int nH) {
  const F32Kernel kernel = f32_kernel_for(tc_head_width(C / nH));
  if (kernel == nullptr) return 0;
  if (plan_bytes(kernel, window_f32_smem(C, nH, 1)) <= smem_optin()) return 1;
  return nH % 2 == 0 && plan_bytes(kernel, window_f32_smem(C, nH, 2)) <= smem_optin() ? 2 : 0;
}

// The float32 plan at (C, nH), static included: the one-block plan where it
// fits the device (or where nH is odd), else the split plan; -1: no
// instance (head width over 128).
inline long long window_f32_plan(int C, int nH) {
  const F32Kernel kernel = f32_kernel_for(tc_head_width(C / nH));
  if (kernel == nullptr) return -1;
  const long long one = plan_bytes(kernel, window_f32_smem(C, nH, 1));
  return one <= smem_optin() || nH % 2 != 0 ? one : plan_bytes(kernel, window_f32_smem(C, nH, 2));
}

cudaError_t launch_window_f32(const float* x, const float* lnw, const float* lnb,
                              const float* wqkv, const float* bqkv, const float* bias,
                              const int* labels, const float* wp, const float* bp, float* out,
                              float* pooled, int B, int H, int W, int C, int nH, int shift,
                              float eps, cudaStream_t stream) {
  const F32Kernel kernel = f32_kernel_for(tc_head_width(C / nH));
  const int nwin = B * (H / kTile) * (W / kTile);
  const int G = window_f32_blocks(C, nH);
  if (kernel == nullptr || G == 0) return cudaErrorInvalidValue;
  const size_t smem = window_f32_smem(C, nH, G);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = C % 4 == 0 && aligned(x, 16) && aligned(out, 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nwin * G);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, lnw, lnb, wqkv, bqkv, bias, labels, wp, bp, out,
                           pooled, H, W, C, nH, shift, eps, vec, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 backward (K8, replaces _win_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:539;
// bf16 runs the tensor-core tiles below). One block = one window of the rolled frame. It recomputes LN(x) and, per
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


// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores (K8, replaces _win_bwd_kernel,
// mp_hsir_tpu/ops/pallas_vjp.py:539, host _win_bwd_call :816): two tiles,
// then grad.cu's weight products and one in-order sum of the partials.
//
// Tile 1, window_attention_bwd_tc_kernel: one window of the rolled frame per
// block of four warps, all heads; warp w owns token rows 16w .. 16w + 15 in
// every product whose rows are tokens, and key rows 16w .. in dk and dv.
// - Staged once as bf16 rows of C (padded to the 64-deep K chunk) + 8: x with
//   the LayerNorm in place (the forward tile's staging and tc_ln_rows), and
//   dy + dpool / 64, rounded (its float32 column sums are the bp partial).
//   LN(x) and the rounded dy are written back for the weight products.
// - Per head, one cp.async ring of [DHP][64] tiles streams the head's q, k
//   and v weight tiles (the forward's pack_qkv_weight) and its columns of Wp
//   (pack_proj_t_weight: the rows of Wp^T, [nH][DHP][round64(C)]): q, k, v
//   = rnd(LN(x) Wqkv + b) and do = rnd(dy Wp) into shared memory as bf16
//   [64][DHP + 8] (one barrier per weight tile, one after the four).
// - S = q k^T scale + bias (-100 where the region labels differ) and A, the
//   max-subtracted softmax, stay in registers (16 x 64 per warp), as in the
//   forward; o = rnd(rnd(A) v) goes out for dWp; dA = do v^T in registers;
//   dS = A (dA - rowsum(A dA)) (the row sum from A itself, as
//   window_attention_bwd_plain); its float32 values are the relative-bias
//   partial; dq = rnd(dS) k scale from the registers.
// - rnd(dS) and rnd(A) are staged as bf16 [64][72]; after one barrier dk =
//   rnd(dS)^T q scale and dv = rnd(A)^T do read them by ldmatrix.trans (and q,
//   do as [k][n] operands by ldmatrix.trans).
// - dqkv goes out in bf16 in the torch channel order (s C + h dh + d); the
//   per-window partial row [nH][64][64] (dS) | [C] (bp) is float32 and is
//   summed in window order by sum_parts: no atomics, two calls are bitwise
//   equal.
// Tile 2 is dwconv_dx.cuh's tile without the stencil at K = 3C: dxn =
// dqkv Wqkv in registers over the 64-channel chunks, the LayerNorm backward
// with x read at the roll-back, dx rounded once, per-window partials of
// dbqkv (the column sums of dqkv), d ln_w and d ln_b after tile 1's.
//
// Bound: a token costs 8C^2 (qkv, do) + 6 x 128 C (S, o, dA, dq, dk, dv)
// flops in tile 1 and 6C^2 in tile 2 against ~20 C bytes: the tensor-core
// rate bounds both at every width here.
// ---------------------------------------------------------------------------

// The bf16 tile 1's dynamic shared memory at (C, nH): xs and ys [64][kx + 8],
// q, k, v, do [64][DHP + 8], rnd(dS) and rnd(A) [64][72], the ring of
// tc_stages(DHP) [DHP][72] weight tiles (the Python mirror is
// ops/kernels/window_attention.py:window_bwd_tc_plan).
inline size_t window_bwd_tc_smem(int C, int nH) {
  const int dhp = tc_head_width(C / nH), kx = round64(C);
  return sizeof(__nv_bfloat16) *
         (2 * (size_t)kPix * (kx + 8) + 4 * (size_t)kPix * (dhp + 8) + 2 * (size_t)kPix * kTcLd +
          (size_t)tc_stages(dhp) * dhp * kTcLd);
}

// x (B, H, W, C) and dy (B, H, W, C) bf16, dy in the rolled frame, dpool (B,
// H/8, W/8, C) bf16; lnw, lnb, bqkv, bias (nH, 64, 64) float32; labels the
// (H, W) region map or NULL; wqkv [nH][3][DHP][kx] and wpt [nH][DHP][kx]
// bf16 (16-byte aligned). Outputs, rolled frame, bf16: xn = LN(x), o, dyt =
// rnd(dy + dpool / 64), dqkv (B, H, W, 3C); part row w (at part + w ldp) gets
// dS [nH][64][64] | the bp partial [C]. vec: C % 8 == 0 with x, dy, xn, dyt
// 16-byte aligned.
template <int DHP>
__global__ void __launch_bounds__(kTcThreads)
window_attention_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
                               const float* __restrict__ lnb,
                               const __nv_bfloat16* __restrict__ wqkv,
                               const float* __restrict__ bqkv, const float* __restrict__ bias,
                               const int* __restrict__ labels,
                               const __nv_bfloat16* __restrict__ wpt,
                               const __nv_bfloat16* __restrict__ dy,
                               const __nv_bfloat16* __restrict__ dpool,
                               __nv_bfloat16* __restrict__ xn_out, __nv_bfloat16* __restrict__ o_out,
                               __nv_bfloat16* __restrict__ dyt_out,
                               __nv_bfloat16* __restrict__ dqkv_out, float* __restrict__ part,
                               int ldp, int H, int W, int C, int nH, int shift, float eps,
                               int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int S = tc_stages(DHP), NT = DHP / 8, ldk = DHP + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int lab[kPix];
  const int dh = C / nH, C3 = 3 * C, kx = round64(C), ldx = kx + 8, nkx = kx / kTcK;
  bf16* xs = (bf16*)tc_smem;      // [64][ldx] LN(x)
  bf16* ys = xs + kPix * ldx;     // [64][ldx] rnd(dy + dpool / 64)
  bf16* qs = ys + kPix * ldx;     // [64][ldk] q, k, v and do of one head
  bf16* ks = qs + kPix * ldk;
  bf16* vs = ks + kPix * ldk;
  bf16* ds = vs + kPix * ldk;
  bf16* gs = ds + kPix * ldk;     // [64][kTcLd] rnd(dS)
  bf16* as = gs + kPix * kTcLd;   // [64][kTcLd] rnd(A)
  bf16* ring = as + kPix * kTcLd; // [S][DHP][kTcLd] weight tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;  // the thread's accumulator rows
  const int w = blockIdx.x, nwx = W / kTile, nwy = H / kTile;
  const int wx = w % nwx, wy = w / nwx % nwy, b = w / (nwx * nwy);
  // x's pixel behind token i (x[(r + shift) % H, (c + shift) % W]); token
  // i's pixel of the rolled frame
  auto src = [&](int i) -> size_t {
    const int sr = (wy * kTile + (i >> 3) + shift) % H, sc = (wx * kTile + (i & 7) + shift) % W;
    return ((size_t)b * H + sr) * W + sc;
  };
  auto pix = [&](int i) { return tile_pix(b, wy, wx, i, H, W); };
  float* prow = part + (size_t)w * ldp;

  stage_rows(xs, ldx, x, C, kx, vec, src);
  stage_rows(ys, ldx, dy, C, kx, vec, pix);
  cp_async_commit();
  const bool masked = labels != nullptr;
  if (masked && threadIdx.x < kPix) {
    const int i = threadIdx.x;
    lab[i] = labels[(wy * kTile + (i >> 3)) * W + wx * kTile + (i & 7)];
  }
  // The weight stream: tile t is K chunk t % nkx of section t / nkx % 4 of
  // head t / (4 nkx): q, k, v of wqkv, then the head's rows of wpt. next()
  // waits for tile t, passes one block-wide barrier (after it nobody reads
  // tile t - 1, whose stage takes tile t + S - 1), issues that tile and
  // returns tile t.
  const int T = 4 * nH * nkx;
  auto issue = [&](int t) {
    if (t < T) {
      const int sec = t / nkx, h = sec >> 2, q = sec & 3;
      const bf16* from = (q < 3 ? wqkv + (size_t)(3 * h + q) * DHP * kx
                                : wpt + (size_t)h * DHP * kx) + (t - sec * nkx) * kTcK;
      bf16* dst = ring + (t % S) * DHP * kTcLd;
      for (int u = threadIdx.x; u < DHP * (kTcK / 8); u += kTcThreads) {
        const int r = u >> 3, c = (u & 7) * 8;
        cp_async16(smem_u32(dst + r * kTcLd + c), from + (size_t)r * kx + c, 16);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < S - 1; ++t) issue(t);
  cp_async_wait<S - 1>();  // x and dy have landed
  __syncthreads();
  tc_ln_rows(xs, ldx, C, vec, lnw, lnb, eps);
  // dy + dpool / 64 in float32: its column sums (in token order) are the bp
  // partial; rounded in place
  for (int c = threadIdx.x; c < C; c += kTcThreads) {
    const float add = __bfloat162float(dpool[(size_t)w * C + c]) * (1.f / kPix);
    float sum = 0.f;
    for (int i = 0; i < kPix; ++i) {
      const float v = __bfloat162float(ys[i * ldx + c]) + add;
      sum += v;
      ys[i * ldx + c] = __float2bfloat16(v);
    }
    prow[nH * kPix * kPix + c] = sum;
  }
  __syncthreads();
  auto same = [](int, int, float v) { return v; };
  tail_store(xs, ldx, C, vec, [&](int i) { return xn_out + pix(i) * C; }, same);
  tail_store(ys, ldx, C, vec, [&](int i) { return dyt_out + pix(i) * C; }, same);

  int t = 0;
  auto next = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue(t + S - 1);
    return ring + (t++ % S) * DHP * kTcLd;
  };
  // columns col, col + 1 (< dh) of one token row of a head's output, p at
  // the head's column 0: a bf16 pair where dh is even, else one by one
  auto put = [&](bf16* p, int col, float v0, float v1) {
    if (col >= dh) return;
    if (dh % 2 == 0) {
      st_u32(p + col, pack_bf16x2(v0, v1));
    } else {
      p[col] = __float2bfloat16(v0);
      if (col + 1 < dh) p[col + 1] = __float2bfloat16(v1);
    }
  };
  const float scale = rsqrtf((float)dh);
  // ldmatrix lane offsets: A rows (the warp's 16 rows of q / do); B from [n][k]
  // rows (k, v in S and dA); B from [k][n] rows by .trans (k, q, v, do); A^T
  // from [k][m] rows by .trans (rnd(dS), rnd(A): m = the warp's 16 keys)
  const int a_off = (16 * warp + (lane & 15)) * ldk + 8 * (lane >> 4);
  const int nk_off = ((lane & 7) + 8 * (lane >> 4)) * ldk + 8 * ((lane >> 3) & 1);
  const int kn_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldk + 8 * (lane >> 4);
  const int at_off = ((lane & 7) + 8 * (lane >> 4)) * kTcLd + 16 * warp + 8 * ((lane >> 3) & 1);
  const bf16* xa = xs + 16 * warp * ldx;
  const bf16* ya = ys + 16 * warp * ldx;
  for (int h = 0; h < nH; ++h) {
    // q, k, v = rnd(LN(x) Wqkv + b) and do = rnd(dy Wp) of the warp's rows
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      float acc[NT * 4];
#pragma unroll
      for (int q = 0; q < NT * 4; ++q) acc[q] = 0.f;
      const bf16* a = s < 3 ? xa : ya;
      for (int kc = 0; kc < nkx; ++kc) tc_rows16_k64<DHP>(acc, a + kc * kTcK, ldx, next(), lane);
      bf16* d = s == 0 ? qs : s == 1 ? ks : s == 2 ? vs : ds;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * t4;
        float b0 = 0.f, b1 = 0.f;
        if (s < 3) {
          const float* bq = bqkv + s * C + h * dh + col;
          b0 = col < dh ? bq[0] : 0.f;
          b1 = col + 1 < dh ? bq[1] : 0.f;
        }
        st_u32(d + r0 * ldk + col, pack_bf16x2(acc[4 * nt] + b0, acc[4 * nt + 1] + b1));
        st_u32(d + r1 * ldk + col, pack_bf16x2(acc[4 * nt + 2] + b0, acc[4 * nt + 3] + b1));
      }
    }
    __syncthreads();  // q, k, v and do of head h are complete

    // S = q k^T: 16 rows x 64 keys, sc[4 nt + q] for keys 8 nt ..
    float sc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) sc[q] = 0.f;
    {
      const uint32_t qa = smem_u32(qs + a_off), kb = smem_u32(ks + nk_off);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, qa + 2 * 16 * kk);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, kb + 2 * (16 * p * ldk + 16 * kk));
          mma_16x8x16(sc + 8 * p, af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(sc + 8 * p + 4, af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
    }
    // scale, relative bias, mask; A = the max-subtracted softmax (float32)
    const float* bh = bias + (size_t)h * kPix * kPix;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t4;
      const float2 c0 = *reinterpret_cast<const float2*>(bh + r0 * kPix + col);
      const float2 c1 = *reinterpret_cast<const float2*>(bh + r1 * kPix + col);
      float* v = sc + 4 * nt;
      v[0] = v[0] * scale + c0.x;
      v[1] = v[1] * scale + c0.y;
      v[2] = v[2] * scale + c1.x;
      v[3] = v[3] * scale + c1.y;
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (lab[e < 2 ? r0 : r1] != lab[col + (e & 1)]) v[e] -= 100.f;
      }
      m0 = fmaxf(m0, fmaxf(v[0], v[1]));
      m1 = fmaxf(m1, fmaxf(v[2], v[3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* v = sc + 4 * nt;
      v[0] = expf(v[0] - m0);
      v[1] = expf(v[1] - m0);
      v[2] = expf(v[2] - m1);
      v[3] = expf(v[3] - m1);
      l0 += v[0] + v[1];
      l1 += v[2] + v[3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[4 * nt] *= i0;
      sc[4 * nt + 1] *= i0;
      sc[4 * nt + 2] *= i1;
      sc[4 * nt + 3] *= i1;
    }
    // A fragment of keys 16 kk .. from 16 x 64 accumulators (rounded to bf16)
    auto frag = [](const float* f, int kk, uint32_t* a) {
      const float* s0 = f + 8 * kk;
      a[0] = pack_bf16x2(s0[0], s0[1]);
      a[1] = pack_bf16x2(s0[2], s0[3]);
      a[2] = pack_bf16x2(s0[4], s0[5]);
      a[3] = pack_bf16x2(s0[6], s0[7]);
    };
    const uint32_t vt = smem_u32(vs + kn_off);
    {  // o = rnd(rnd(A) v), out for dWp
      float oa[NT * 4];
#pragma unroll
      for (int q = 0; q < NT * 4; ++q) oa[q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        frag(sc, kk, af);
#pragma unroll
        for (int p = 0; p < DHP / 16; ++p) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vt + 2 * (16 * kk * ldk + 16 * p));
          mma_16x8x16(oa + 8 * p, af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(oa + 8 * p + 4, af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * t4;
        put(o_out + pix(r0) * C + h * dh, col, oa[4 * nt], oa[4 * nt + 1]);
        put(o_out + pix(r1) * C + h * dh, col, oa[4 * nt + 2], oa[4 * nt + 3]);
      }
    }
    // dA = do v^T, then dS = A (dA - rowsum(A dA)) in place
    float ga[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) ga[q] = 0.f;
    {
      const uint32_t da = smem_u32(ds + a_off), vb = smem_u32(vs + nk_off);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, da + 2 * 16 * kk);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, vb + 2 * (16 * p * ldk + 16 * kk));
          mma_16x8x16(ga + 8 * p, af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(ga + 8 * p + 4, af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
    }
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      d0 += sc[4 * nt] * ga[4 * nt] + sc[4 * nt + 1] * ga[4 * nt + 1];
      d1 += sc[4 * nt + 2] * ga[4 * nt + 2] + sc[4 * nt + 3] * ga[4 * nt + 3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    float* pb = prow + (size_t)h * kPix * kPix;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t4;
      float* g = ga + 4 * nt;
      const float* a = sc + 4 * nt;
      g[0] = a[0] * (g[0] - d0);
      g[1] = a[1] * (g[1] - d0);
      g[2] = a[2] * (g[2] - d1);
      g[3] = a[3] * (g[3] - d1);
      *reinterpret_cast<float2*>(pb + r0 * kPix + col) = make_float2(g[0], g[1]);
      *reinterpret_cast<float2*>(pb + r1 * kPix + col) = make_float2(g[2], g[3]);
      st_u32(gs + r0 * kTcLd + col, pack_bf16x2(g[0], g[1]));
      st_u32(gs + r1 * kTcLd + col, pack_bf16x2(g[2], g[3]));
      st_u32(as + r0 * kTcLd + col, pack_bf16x2(a[0], a[1]));
      st_u32(as + r1 * kTcLd + col, pack_bf16x2(a[2], a[3]));
    }
    // dq = rnd(dS) k scale from the registers; dk = rnd(dS)^T q scale and dv =
    // rnd(A)^T do from the staged tiles (s = 0, 1, 2: the section of dqkv)
    const uint32_t kt = smem_u32(ks + kn_off), qt = smem_u32(qs + kn_off);
    const uint32_t dt = smem_u32(ds + kn_off);
    const uint32_t gt = smem_u32(gs + at_off), atr = smem_u32(as + at_off);
#pragma unroll 1
    for (int s = 0; s < 3; ++s) {
      if (s == 1) __syncthreads();  // rnd(dS) and rnd(A) are complete
      float acc[NT * 4];
#pragma unroll
      for (int q = 0; q < NT * 4; ++q) acc[q] = 0.f;
      const uint32_t bt = s == 0 ? kt : s == 1 ? qt : dt;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        if (s == 0)
          frag(ga, kk, af);
        else
          ldmatrix_x4_trans(af, (s == 1 ? gt : atr) + 2 * 16 * kk * kTcLd);
#pragma unroll
        for (int p = 0; p < DHP / 16; ++p) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, bt + 2 * (16 * kk * ldk + 16 * p));
          mma_16x8x16(acc + 8 * p, af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(acc + 8 * p + 4, af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
      const float f = s < 2 ? scale : 1.f;
      bf16* base = dqkv_out + s * C + h * dh;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * t4;
        put(base + pix(r0) * C3, col, acc[4 * nt] * f, acc[4 * nt + 1] * f);
        put(base + pix(r1) * C3, col, acc[4 * nt + 2] * f, acc[4 * nt + 3] * f);
      }
    }
  }
}

using TcBwdKernel = void (*)(const __nv_bfloat16*, const float*, const float*,
                             const __nv_bfloat16*, const float*, const float*, const int*,
                             const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                             __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*,
                             float*, int, int, int, int, int, int, float, int);

// the backward instance of head width dhp (nullptr: none)
inline TcBwdKernel tc_bwd_kernel_for(int dhp) {
  switch (dhp) {
    case 16: return window_attention_bwd_tc_kernel<16>;
    case 32: return window_attention_bwd_tc_kernel<32>;
    case 48: return window_attention_bwd_tc_kernel<48>;
    case 64: return window_attention_bwd_tc_kernel<64>;
    case 96: return window_attention_bwd_tc_kernel<96>;
    case 128: return window_attention_bwd_tc_kernel<128>;
    default: return nullptr;
  }
}

// The bf16 backward's plans at (C, nH), static included: tile 1 (-1: dh >
// 128) and tile 2 (DwDxPlan without the stencil at K = 3C; -1: C > 384).
inline long long window_bwd_tc_plan(int C, int nH) {
  const TcBwdKernel k = tc_bwd_kernel_for(tc_head_width(C / nH));
  return k == nullptr ? -1 : plan_bytes(k, window_bwd_tc_smem(C, nH));
}
inline long long window_dx_tc_plan(int C) {
  return C > kTailMaxC ? -1 : plan_bytes(dwconv_dx_tc_kernel<false>, DwDxPlan(C, 3 * C, false).bytes);
}

cudaError_t launch_window_bwd_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                                 const __nv_bfloat16* wqkv, const float* bqkv, const float* bias,
                                 const int* labels, const __nv_bfloat16* wpt,
                                 const __nv_bfloat16* dy, const __nv_bfloat16* dpool,
                                 __nv_bfloat16* xn, __nv_bfloat16* o, __nv_bfloat16* dyt,
                                 __nv_bfloat16* dqkv, float* part, int ldp, int B, int H, int W,
                                 int C, int nH, int shift, float eps, cudaStream_t stream) {
  const TcBwdKernel kernel = tc_bwd_kernel_for(tc_head_width(C / nH));
  if (kernel == nullptr || !aligned(wqkv, 16) || !aligned(wpt, 16) || ldp % 2 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = window_bwd_tc_smem(C, nH);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = C % 8 == 0 && aligned(x, 16) && aligned(dy, 16) && aligned(xn, 16) &&
                  aligned(dyt, 16);
  kernel<<<B * (H / kTile) * (W / kTile), kTcThreads, smem, stream>>>(
      x, lnw, lnb, wqkv, bqkv, bias, labels, wpt, dy, dpool, xn, o, dyt, dqkv, part, ldp, H, W, C,
      nH, shift, eps, vec);
  return cudaGetLastError();
}

// Tile 2: the kernel frame is the rolled frame, x's pixel (r + shift, c +
// shift) behind its (r, c): dwconv_dx_tc_kernel's roll-back at -shift.
cudaError_t launch_window_dx_tc(const __nv_bfloat16* dqkv, const __nv_bfloat16* w,
                                const __nv_bfloat16* x, const float* lnw, __nv_bfloat16* dx,
                                float* part, int ldp, int B, int H, int W, int C, int shift,
                                float eps, cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(w, 16)) return cudaErrorInvalidValue;
  const int K = 3 * C;
  const size_t smem = DwDxPlan(C, K, false).bytes;
  const int vec_in = K % 8 == 0 && aligned(dqkv, 16);
  const int vec_x = C % 8 == 0 && aligned(x, 16) && aligned(dx, 16);
  cudaError_t err = set_smem(dwconv_dx_tc_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  dwconv_dx_tc_kernel<false><<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      nullptr, dqkv, nullptr, w, x, lnw, H, W, C, K, -shift, eps, vec_in, vec_x, nullptr, dx,
      part, ldp, nullptr);
  return cudaGetLastError();
}
}  // namespace mp

// K1. dtype: 0 = float32 (window_f32_kernel), 1 = bfloat16
// (window_tc_kernel); x (B, H, W, C) and the outputs in that type. The
// weights are the packs of ops/kernels/window_attention.py in that type (wqkv
// [nH][3][DHP][round64(C)], wp [nH][DHP][round64(nH DHP)]); LN, biases and
// the (nH, 64, 64) relative-position bias are float32; labels is the (H, W)
// int32 shift-region map or NULL.
extern "C" int mp_window_attention(const void* x, const void* lnw, const void* lnb,
                                   const void* wqkv, const void* bqkv, const void* bias,
                                   const void* labels, const void* wp, const void* bp,
                                   void* out, void* pooled, int dtype, int B, int H, int W,
                                   int C, int nH, int shift, float eps, void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_window_f32(f(x), f(lnw), f(lnb), f(wqkv), f(bqkv), f(bias),
                                      (const int*)labels, f(wp), f(bp), (float*)out,
                                      (float*)pooled, B, H, W, C, nH, shift, eps, st);
  const int nwin = B * (H / mp::kTile) * (W / mp::kTile);
  return (int)mp::launch_window_tc<true>(x, f(lnw), f(lnb), wqkv, f(bqkv), f(bias),
                                         (const int*)labels, 0, wp, f(bp), out, pooled, nwin, H,
                                         W, C, nH, shift, eps, st);
}

// K14. x (NW, 64, C) window tokens; wqkv, wp as mp_window_attention's; bqkv,
// bp, the (nH, 64, 64) bias float32; labels (n_pat, 64) int32 region labels
// tiled over the windows (NW % n_pat == 0) or NULL. Output (NW, 64, C). kc:
// the channel chunk (mp_window_chunk).
extern "C" int mp_window_msa(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                             const void* labels, const void* wp, const void* bp, void* out,
                             int dtype, int NW, int C, int nH, int n_pat, int kc, void* stream) {
  if (C % nH != 0 || (labels != nullptr && (n_pat <= 0 || NW % n_pat != 0)) || kc <= 0 ||
      kc > C || (dtype != 0 && kc != C))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_window_msa<float>(x, wqkv, f(bqkv), f(bias), (const int*)labels, n_pat,
                                             wp, f(bp), out, NW, C, nH, kc, st);
  return (int)mp::launch_window_tc<false>(x, nullptr, nullptr, wqkv, f(bqkv), f(bias),
                                          (const int*)labels, n_pat, wp, f(bp), out, nullptr, NW,
                                          0, 0, C, nH, 0, 0.f, st);
}

// The channel chunk the window MSA kernel (K14) launches with at (C, nH) in
// dtype: C in bf16 (the input is staged whole), float32's as pick_chunk
// finds it. K1 has none: both its tiles stage the whole window.
extern "C" int mp_window_chunk(int C, int nH, int dtype) {
  return dtype == 0 ? mp::window_chunk(C, nH) : C;
}

// Shared-memory plans per block (bytes, static included): K1's at a shape
// and dtype (-1 where there is no plan: head width over 128); K14's at a
// shape, dtype and channel chunk kc (bf16: kc = C).
extern "C" long long mp_window_attention_smem(int C, int nH, int dtype) {
  return dtype != 0 ? mp::window_tc_plan<true>(C, nH) : mp::window_f32_plan(C, nH);
}

extern "C" long long mp_window_msa_smem(int C, int nH, int dtype, int kc) {
  if (dtype != 0) return kc == C ? mp::window_tc_plan<false>(C, nH) : -1;
  return mp::plan_bytes(mp::window_msa_kernel<float>, mp::window_smem(C, nH, kc));
}

// Blocks per window the kernels launch with for nwin windows at (C, nH)
// (k14 != 0: mp_window_msa, whose float32 instance runs one block per
// window; the float32 K1 tile's does not depend on nwin); 0 where there is
// no plan.
extern "C" int mp_window_cluster(int C, int nH, int dtype, int nwin, int k14) {
  if (dtype == 0) return k14 ? 1 : mp::window_f32_blocks(C, nH);
  return k14 ? mp::window_tc_cluster<false>(C, nH, nwin) : mp::window_tc_cluster<true>(C, nH, nwin);
}

extern "C" long long mp_window_attention_bwd_smem(int C, int nH, int kc) {
  return mp::plan_bytes(mp::window_bwd_kernel_for<float>(kc, C), mp::window_bwd_smem(C, nH, kc));
}

// The channel chunk the backward kernel launches with at (C, nH).
extern "C" int mp_window_attention_bwd_chunk(int C, int nH) { return mp::window_bwd_chunk(C, nH); }

// The float32 per-window half of the window-attention backward (bf16 runs
// mp_window_attention_bwd_tc and mp_window_attention_dx_tc). dy (B, H, W, C)
// in the rolled frame, dpool (B, H/8, W/8, C). Outputs, rolled frame: xn =
// LN(x), o (pre-projection attention output), dyt (dy + dpool/64), dqkv (B,
// H, W, 3C); partials pbias (windows, nH, 64, 64) and pbp (windows, C). kc:
// the channel chunk (mp_window_attention_bwd_chunk).
extern "C" int mp_window_attention_bwd(const void* x, const void* lnw, const void* lnb,
                                       const void* wqkv, const void* bqkv, const void* bias,
                                       const void* labels, const void* wp, const void* dy,
                                       const void* dpool, void* xn, void* o, void* dyt,
                                       void* dqkv, void* pbias, void* pbp, int B, int H, int W,
                                       int C, int nH, int shift, int kc, float eps,
                                       void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_window_bwd<float>(x, f(lnw), f(lnb), wqkv, f(bqkv), f(bias),
                                           (const int*)labels, wp, dy, dpool, xn, o, dyt, dqkv,
                                           (float*)pbias, (float*)pbp, B, H, W, C, nH, shift, kc,
                                           eps, (cudaStream_t)stream);
}

// The bf16 backward's tile 1 (C up to 384, dh up to 128): x (B, H, W, C), dy
// (B, H, W, C) rolled frame and dpool (B, H/8, W/8, C) bf16; LN, bqkv and the
// (nH, 64, 64) bias float32; labels the (H, W) region map or NULL; wqkv the
// forward's pack [nH][3][DHP][round64(C)], wpt the rows of Wp^T as
// [nH][DHP][round64(C)] (bf16, 16-byte aligned). Outputs, rolled frame, bf16:
// xn = LN(x), o, dyt = rnd(dy + dpool / 64), dqkv (B, H, W, 3C) in the torch
// channel order; part (windows, ldp) float32, ldp even: row w starts with dS
// [nH][64][64] | the bp partial [C].
extern "C" int mp_window_attention_bwd_tc(const void* x, const void* lnw, const void* lnb,
                                          const void* wqkv, const void* bqkv, const void* bias,
                                          const void* labels, const void* wpt, const void* dy,
                                          const void* dpool, void* xn, void* o, void* dyt,
                                          void* dqkv, void* part, int ldp, int B, int H, int W,
                                          int C, int nH, int shift, float eps, void* stream) {
  if (C % nH != 0 || H % mp::kTile != 0 || W % mp::kTile != 0 || C > mp::kTailMaxC)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_window_bwd_tc((const bf*)x, f(lnw), f(lnb), (const bf*)wqkv, f(bqkv),
                                       f(bias), (const int*)labels, (const bf*)wpt,
                                       (const bf*)dy, (const bf*)dpool, (bf*)xn, (bf*)o,
                                       (bf*)dyt, (bf*)dqkv, (float*)part, ldp, B, H, W, C, nH,
                                       shift, eps, (cudaStream_t)stream);
}

// The bf16 backward's tile 2 (C up to 384): dqkv (B, H, W, 3C) bf16 rolled
// frame; w the torch qkv weight [3C][C8] bf16 (C8 = C rounded up to 8,
// 16-byte aligned); x (B, H, W, C) bf16 unrolled, lnw float32. Outputs: dx
// (B, H, W, C) bf16 in x's frame; part row w (at part + w ldp) gets the
// column sums of dqkv [3C] | d ln_w [C] | d ln_b [C].
extern "C" int mp_window_attention_dx_tc(const void* dqkv, const void* w, const void* x,
                                         const void* lnw, void* dx, void* part, int ldp, int B,
                                         int H, int W, int C, int shift, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  return (int)mp::launch_window_dx_tc((const bf*)dqkv, (const bf*)w, (const bf*)x,
                                      (const float*)lnw, (bf*)dx, (float*)part, ldp, B, H, W, C,
                                      shift, eps, (cudaStream_t)stream);
}

// The bf16 backward's plans per block (bytes, static included): tile 1 at
// (C, nH) (-1: head width over 128) and tile 2 at C (-1: C over 384).
extern "C" long long mp_window_attention_bwd_tc_smem(int C, int nH) {
  return mp::window_bwd_tc_plan(C, nH);
}
extern "C" long long mp_window_attention_dx_tc_smem(int C) { return mp::window_dx_tc_plan(C); }
