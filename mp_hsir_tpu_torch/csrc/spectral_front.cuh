// The bf16 spectral apply kernel: the front of phase 1 of _spectral_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1597-1633) and of _sp1_kernel (:1962),
// out = v @ comb [+ x * gate] [+ x] [+ shortcut] with v = dw3x3(1x1([LN]
// cat(x1, x2))), on the tensor cores, one 8x8 pixel tile per 512-thread
// block, then (optionally) the PGSSTB tail tile of mlp_tail.cuh. The float32
// instances keep spectral_apply_kernel (spectral.cu) and SIMT FMA.
//
// Rounding points as spectral_apply_plain: the 1x1 output rounded to bf16,
// the depthwise output rounded to bf16, the comb sum in float32 rounded once,
// the gate / residual / shortcut epilogues rounding as the float32 kernel;
// with drop-path the float32 branch sum (acc + u g) is scaled and rounded once.
//
// Bound: 2C^2 (1x1 over the 10x10 halo: 2.2 C^2 with the padding to 112
// rows) + 2C^2 (comb) + 18 C flops per pixel against ~4C bytes per pixel
// (bytes bound it on this card at every width: 0.65 ms per flagship forward).
// Design:
// - The halo (100 pixels, 112 rows with the padding to 7 row tiles) is staged
//   once as bf16 [112][CP + 8] (CP = C rounded up to 32; rows of an odd
//   multiple of 16 bytes: ldmatrix without bank conflicts) by 16-byte
//   cp.async copies, the raw source pixel computed once per halo pixel; the
//   LayerNorm runs in place on the staged rows (out-of-image rows stay zero).
// - The weights come straight from their torch layouts: wv = the v rows of
//   wqkv ([C out][C8 in], C8 = C rounded up to 8: the wrapper pads only
//   where C is not a multiple of 8) streams as [NP out][64 in] tiles through
//   a 2-3 stage cp.async ring; comb (bf16 [B][C][C8], row = v channel) as
//   [64][CP] tiles through a 2-3 stage ring, read by ldmatrix.trans.
//   Zero-filled past C.
// - v's 1x1: 112 x NP x CP per pass (one pass up to CP = 192, two above),
//   every warp holding up to 3 units of 16 x 32 outputs in registers; the
//   pass's result is rounded to bf16 into the ring's space, then the depthwise
//   3x3 runs on bf16 pairs (taps staged once), 4 output rows per thread, into
//   v ([64][CP + 8] bf16, the comb product's A operand).
// - comb's product (64 x CP x CP, 4 x CP / 32 units) ends in the epilogue
//   straight from the accumulators (raw input pixel, gate window and output
//   pixel precomputed per tile pixel; bf16 pair loads), into y ([64][CP + 8]
//   bf16), which the tail tile reads or which is stored in 16-byte runs.
#pragma once

#include "mlp_tail.cuh"

namespace mp {

constexpr int kFrontUnits = 3;   // 16 x 32 output units a warp holds in registers
constexpr int kFrontLdw = 72;    // weight tile row: 64 deep + 8 (144 B, an odd multiple of 16)
constexpr int kFrontRows = 112;  // halo rows padded to 7 row tiles of 16
constexpr int kFrontMaxC = kTailMaxC;
// launch flags: which maps take 16-byte (or bf16-pair) accesses
constexpr int kVecX = 1, kPairs = 2, kVecOut = 4;

__host__ __device__ constexpr int round_up32(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ constexpr int round_up8(int n) { return (n + 7) / 8 * 8; }

// The bf16 front's shared-memory plan at width C (every piece a multiple of
// 16 bytes). Front: taps [9][CP] | v [64][ld] | halo [112][ld] | ring (the
// weight tiles, then the pass's 1x1 output [100][NP + 8]); comb's stages take
// the halo and the ring. After the comb product: y [64][ld], then the tail's
// scratch (tail_scratch_bytes).
struct FrontPlan {
  int C, CP, ld, NP, nk, ws, cs;
  size_t taps, v, halo, ring, cstage, front, y;
  __host__ __device__ FrontPlan(int c) : C(c) {
    CP = round_up32(C);
    ld = CP + 8;
    const int nb = CP / 32;
    const int passes = (7 * nb + 16 * kFrontUnits - 1) / (16 * kFrontUnits);
    NP = 32 * ((nb + passes - 1) / passes);
    nk = (CP + 63) / 64;
    ws = passes > 1 ? 2 : 3;
    const size_t b = sizeof(__nv_bfloat16);
    taps = b * 9 * CP;
    v = b * kPix * ld;
    halo = b * kFrontRows * ld;
    const size_t wring = ws * b * NP * kFrontLdw, t = b * kHaloPix * (NP + 8);
    ring = wring > t ? wring : t;
    cstage = b * kPix * ld;
    if (halo + ring < 2 * cstage) ring = 2 * cstage - halo;
    cs = (int)((halo + ring) / cstage) > 3 ? 3 : (int)((halo + ring) / cstage);
    front = taps + v + halo + ring;
    y = b * kPix * ld;
  }
  // dynamic bytes of the launch: the tail takes at least two ring stages
  __host__ __device__ size_t bytes(bool tail) const {
    const size_t t = y + tail_scratch_bytes(C, 2);
    return tail && t > front ? t : front;
  }
};

// Copies a rows x cols tile (cols a multiple of 8) of a row-major bf16 matrix
// to shared memory (row stride ldd) by 16-byte cp.async: element (r, c) is
// src[r * lds + c] where r < rmax and c < cmax, else zero (src 16-byte
// aligned; lds and cmax multiples of 8).
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ldd,
                                           const __nv_bfloat16* __restrict__ src, int lds,
                                           int rows, int cols, int rmax, int cmax) {
  const int units = cols >> 3;
  for (int u = threadIdx.x; u < rows * units; u += blockDim.x) {
    const int r = u / units, c = (u - r * units) * 8;
    const bool ok = r < rmax && c < cmax;
    cp_async16(smem_u32(dst + r * ldd + c), ok ? src + (size_t)r * lds + c : src, ok ? 16 : 0);
  }
}

// A ring of S tile stages fed by stage(t, dst) (which copies tile t, t < T);
// the protocol of TailRing: one commit group per tile, one block-wide barrier
// per consumed tile, after which the freed stage takes the next tile.
template <typename Stage>
struct FrontRing {
  __nv_bfloat16* base;
  size_t elems;
  int S, T;
  Stage stage;
  int it = 0, istage = 0, cstage = 0;
  __device__ FrontRing(__nv_bfloat16* b, size_t e, int s, int t, Stage st)
      : base(b), elems(e), S(s), T(t), stage(st) {}
  __device__ void issue() {
    if (it < T) {
      stage(it, base + istage * elems);
      if (++istage == S) istage = 0;
    }
    ++it;
    cp_async_commit();
  }
  __device__ void prefetch() {
    for (int t = 0; t < S - 1; ++t) issue();
  }
  __device__ const __nv_bfloat16* consume() {
    cp_async_wait_upto(S - 2);
    __syncthreads();
    issue();
    const __nv_bfloat16* tile = base + cstage * elems;
    if (++cstage == S) cstage = 0;
    return tile;
  }
};

template <typename Stage>
__device__ __forceinline__ FrontRing<Stage> front_ring(__nv_bfloat16* b, size_t e, int s, int t,
                                                       Stage st) {
  return FrontRing<Stage>(b, e, s, t, st);
}

// Elements k and k + 1 (zero past C) of pixel p of the logical input
// cat(x1, x2), or of one map (x2 = nullptr, C2 = 0); pair: one 4-byte load
// (C1 and C2 even, 4-byte aligned rows), else two.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* __restrict__ x1,
                                            const __nv_bfloat16* __restrict__ x2, int C1, int C2,
                                            size_t p, int k, bool pair) {
  if (pair) {
    const __nv_bfloat16* q = k < C1 ? x1 + p * C1 + k : x2 + p * C2 + (k - C1);
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q));
  }
  auto at = [&](int i) {
    return i >= C1 + C2 ? 0.f : __bfloat162float(i < C1 ? x1[p * C1 + i] : x2[p * C2 + (i - C1)]);
  };
  return make_float2(at(k), at(k + 1));
}

// Each warp's units: unit q = warp + 16 j (j < kFrontUnits) of n_units; with
// rows_t row tiles, unit q is row tile q % rows_t, column block q / rows_t.
// acc[j][nt] += A (16 rows of unit j) x B (columns 32 nb + 8 nt ..), over
// `steps` 16-deep steps of one tile. a[j]: A's shared address for the lane at
// depth k0; b[j]: B's for the lane at the tile's depth 0 (trans: B is [k][n]
// with row stride ldb; else [n][k] with row stride kFrontLdw).
template <bool kTrans>
__device__ __forceinline__ void front_mma(float (&acc)[kFrontUnits][4][4], const uint32_t (&a)[kFrontUnits],
                                          const uint32_t (&b)[kFrontUnits], int n_units, int steps,
                                          int ldb) {
  const int warp = threadIdx.x >> 5;
  for (int kk = 0; kk < steps; ++kk) {
#pragma unroll
    for (int j = 0; j < kFrontUnits; ++j) {
      if (warp + 16 * j >= n_units) break;  // warp-uniform
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, a[j] + 32 * kk);
      if constexpr (kTrans) {
        ldmatrix_x4_trans(bf, b[j] + 2 * 16 * kk * ldb);
      } else {
        ldmatrix_x4(bf, b[j] + 32 * kk);
      }
      mma_16x8x16(acc[j][0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_16x8x16(acc[j][1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      if constexpr (kTrans) {
        ldmatrix_x4_trans(bf, b[j] + 2 * (16 * kk * ldb + 16));
      } else {
        ldmatrix_x4(bf, b[j] + 2 * (16 * kFrontLdw + 16 * kk));
      }
      mma_16x8x16(acc[j][2], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_16x8x16(acc[j][3], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

// Each accumulator pair of the warp's units: f(row, col, v0, v1) for output
// (row, col) and (row, col + 1), rows from row tile q % rows_t.
template <typename F>
__device__ __forceinline__ void front_out(const float (&acc)[kFrontUnits][4][4], int n_units,
                                          int rows_t, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kFrontUnits; ++j) {
    const int q = warp + 16 * j;
    if (q >= n_units) break;
    const int r0 = 16 * (q % rows_t) + (lane >> 2), c0 = 32 * (q / rows_t) + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      f(r0, c0 + 8 * nt, acc[j][nt][0], acc[j][nt][1]);
      f(r0 + 8, c0 + 8 * nt, acc[j][nt][2], acc[j][nt][3]);
    }
  }
}

__device__ __forceinline__ void front_zero(float (&acc)[kFrontUnits][4][4]) {
#pragma unroll
  for (int j = 0; j < kFrontUnits; ++j)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
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
    const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
    const bool in = p < kHaloPix && ur >= 0 && ur < H && uc >= 0 && uc < W;
    hsrc[p] = in ? (b * H + (ur - shift + H) % H) * W + (uc - shift + W) % W : -1;
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
  {
    const int units = CP / 8;
    for (int u = threadIdx.x; u < kFrontRows * units; u += blockDim.x) {
      const int p = u / units, c = (u - p * units) * 8;
      const int pix = hsrc[p];
      __nv_bfloat16* d = xh + p * ld + c;
      if (vec_x) {
        const bool ok = pix >= 0 && c < C;
        const __nv_bfloat16* s = !ok ? x1 : c < C1 ? x1 + (size_t)pix * C1 + c
                                                   : x2 + (size_t)pix * C2 + (c - C1);
        cp_async16(smem_u32(d), s, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = c + e;
          d[e] = pix < 0 || k >= C ? __float2bfloat16(0.f)
               : k < C1 ? x1[(size_t)pix * C1 + k] : x2[(size_t)pix * C2 + (k - C1)];
        }
      }
    }
    cp_async_commit();
  }

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
      if (lnw != nullptr) {
        for (int p = warp; p < kHaloPix; p += blockDim.x >> 5) {
          if (hsrc[p] < 0) continue;
          __nv_bfloat16* row = xh + p * ld;
          float sum = 0.f;
          for (int k = lane; k < C; k += 32) sum += __bfloat162float(row[k]);
          const float mu = warp_sum(sum) / C;
          float var = 0.f;
          for (int k = lane; k < C; k += 32) {
            const float d = __bfloat162float(row[k]) - mu;
            var += d * d;
          }
          const float rs = rsqrtf(warp_sum(var) / C + eps);
          for (int k = lane; k < C; k += 32)
            row[k] = __float2bfloat16((__bfloat162float(row[k]) - mu) * rs * lnw[k] + lnb[k]);
        }
      }
    }
    uint32_t a[kFrontUnits], bo[kFrontUnits];
#pragma unroll
    for (int j = 0; j < kFrontUnits; ++j) {
      const int q = warp + 16 * j, mt = q % 7, nb = q / 7;
      a[j] = smem_u32(xh + (16 * mt + (lane & 15)) * ld + 8 * (lane >> 4));
      bo[j] = 2 * ((32 * nb + (lane & 7) + 8 * (lane >> 4)) * kFrontLdw + 8 * ((lane >> 3) & 1));
    }
    front_zero(acc);
    for (int t = 0; t < pl.nk; ++t) {
      const uint32_t tile = smem_u32(wr.consume());
      uint32_t at[kFrontUnits], bt[kFrontUnits];
#pragma unroll
      for (int j = 0; j < kFrontUnits; ++j) {
        at[j] = a[j] + 2 * 64 * t;
        bt[j] = tile + bo[j];
      }
      front_mma<false>(acc, at, bt, n_units, min(4, (CP - 64 * t) / 16), 0);
    }
    cp_async_wait<0>();
    __syncthreads();
    // the pass's 1x1 output, rounded to bf16, into the ring's space ([100][NP + 8])
    const int ldt = pl.NP + 8;
    front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
      if (r < kHaloPix)
        *reinterpret_cast<uint32_t*>(rg + r * ldt + c) = pack_bf16x2(v0, v1);
    });
    __syncthreads();
    // depthwise 3x3 on bf16 pairs: item = (channel pair, tile column, 4 rows)
    const int npairs = np / 2;
    for (int idx = threadIdx.x; idx < 16 * npairs; idx += blockDim.x) {
      const int j = idx % npairs, h = idx / npairs, pc = h & 7, pr = (h >> 3) * 4;
      float2 w[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) w[tap] = __bfloat1622float2(tp[tap * (CP / 2) + n0 / 2 + j]);
      float2 s[4];
#pragma unroll
      for (int o = 0; o < 4; ++o) s[o] = make_float2(0.f, 0.f);
#pragma unroll
      for (int rr = 0; rr < 6; ++rr) {
        float2 in[3];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          in[dx] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              rg + ((pr + rr) * kHalo + pc + dx) * ldt + 2 * j));
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int dy = rr - o;
          if (dy < 0 || dy > 2) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            s[o].x = fmaf(in[dx].x, w[dy * 3 + dx].x, s[o].x);
            s[o].y = fmaf(in[dx].y, w[dy * 3 + dx].y, s[o].y);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < 4; ++o)
        *reinterpret_cast<uint32_t*>(vs + ((pr + o) * kTile + pc) * ld + n0 + 2 * j) =
            pack_bf16x2(s[o].x, s[o].y);
    }
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

}  // namespace mp
