// The pieces of the bf16 halo tiles: the plan, halo staging and LayerNorm,
// the weight ring, the 1x1 over the halo and the depthwise conv on bf16
// pairs. The spectral apply tile (spectral_apply_tc_kernel, spectral.cu)
// was built from them and is described here; the stats tile
// (spectral_stats.cuh) and the GDFN tile (gdfn.cu) reuse them.
//
// The bf16 spectral apply kernel: the front of phase 1 of _spectral_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1597-1633) and of _sp1_kernel (:1962),
// out = v @ comb [+ x * gate] [+ x] [+ shortcut] with v = dw3x3(1x1([LN]
// cat(x1, x2))), on the tensor cores, one 8x8 pixel tile per 512-thread
// block, then (optionally) the PGSSTB tail tile of mlp_tail.cuh. The float32
// instances keep spectral_apply_kernel (spectral.cu): a SIMT FMA front, then
// mlp_tail.cuh's float32 tail tile (3xTF32 on the tensor cores).
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
// per consumed tile, after which the freed stage takes the next tile. E: the
// stages' element type (bf16; float32 in the float32 halo tiles).
template <typename Stage, typename E = __nv_bfloat16>
struct FrontRing {
  E* base;
  size_t elems;
  int S, T;
  Stage stage;
  int it = 0, istage = 0, cstage = 0;
  __device__ FrontRing(E* b, size_t e, int s, int t, Stage st)
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
  __device__ E* consume() {
    cp_async_wait_upto(S - 2);
    __syncthreads();
    issue();
    E* tile = base + cstage * elems;
    if (++cstage == S) cstage = 0;
    return tile;
  }
};

template <typename Stage, typename E>
__device__ __forceinline__ FrontRing<Stage, E> front_ring(E* b, size_t e, int s, int t, Stage st) {
  return FrontRing<Stage, E>(b, e, s, t, st);
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

// Each warp's units: unit q = warp + 16 j (j < U, at most kFrontUnits) of
// n_units; with rows_t row tiles, unit q is row tile q % rows_t, column block
// q / rows_t. acc[j][nt] += A (16 rows of unit j) x B (columns 32 nb + 8 nt
// ..), over `steps` 16-deep steps of one tile. a[j]: A's shared address for
// the lane at depth k0; b[j]: B's for the lane at the tile's depth 0 (trans: B
// is [k][n] with row stride ldb; else [n][k] with row stride kFrontLdw).
template <bool kTrans, int U>
__device__ __forceinline__ void front_mma(float (&acc)[U][4][4], const uint32_t (&a)[U],
                                          const uint32_t (&b)[U], int n_units, int steps,
                                          int ldb) {
  const int warp = threadIdx.x >> 5;
  for (int kk = 0; kk < steps; ++kk) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
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
template <int U, typename F>
__device__ __forceinline__ void front_out(const float (&acc)[U][4][4], int n_units, int rows_t,
                                          F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < U; ++j) {
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

template <int U>
__device__ __forceinline__ void front_zero(float (&acc)[U][4][4]) {
#pragma unroll
  for (int j = 0; j < U; ++j)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
}

// The raw source pixel of halo row p of tile (ty, tx) of image b (the unrolled
// frame read through the roll-back), or -1 where the row is zero (outside the
// image, or one of the 12 padding rows).
__device__ __forceinline__ int halo_src(int p, int b, int ty, int tx, int H, int W, int shift) {
  const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
  const bool in = p < kHaloPix && ur >= 0 && ur < H && uc >= 0 && uc < W;
  return in ? (b * H + (ur - shift + H) % H) * W + (uc - shift + W) % W : -1;
}

// Stages the halo of cat(x1, x2) as bf16 [112][ld] (row p from pixel hsrc[p],
// zero where it is -1 and past C, CP / 8 units of 8 channels a row) by 16-byte
// cp.async copies where vec_x (C1, C2 multiples of 8, 16-byte aligned rows),
// else element by element; one commit group.
__device__ __forceinline__ void stage_halo(__nv_bfloat16* xh, int ld, const int* hsrc,
                                           const __nv_bfloat16* __restrict__ x1,
                                           const __nv_bfloat16* __restrict__ x2, int C1, int C2,
                                           int CP, bool vec_x) {
  const int C = C1 + C2, units = CP / 8;
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

// The LayerNorm of the staged halo in place, one warp per in-image row, as
// ln_rows_inplace computes it (zero rows stay zero).
__device__ __forceinline__ void halo_ln(__nv_bfloat16* xh, int ld, const int* hsrc, int C,
                                        const float* __restrict__ lnw,
                                        const float* __restrict__ lnb, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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

// One 1x1 pass over the staged halo: acc (the warp's units of the 112 x np
// output, 7 row tiles, n_units = 7 np / 32 <= 16 U) = halo [112][CP] x the
// ring's [np][64] weight tiles, nk tiles deep; with rows_t row tiles, over
// the first 16 rows_t rows of xh (n_units = rows_t np / 32).
template <int U, typename Ring>
__device__ __forceinline__ void halo_1x1(float (&acc)[U][4][4], const __nv_bfloat16* xh, int ld,
                                         Ring& wr, int n_units, int CP, int nk, int rows_t = 7) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t a[U], bo[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int q = warp + 16 * j, mt = q % rows_t, nb = q / rows_t;
    a[j] = smem_u32(xh + (16 * mt + (lane & 15)) * ld + 8 * (lane >> 4));
    bo[j] = 2 * ((32 * nb + (lane & 7) + 8 * (lane >> 4)) * kFrontLdw + 8 * ((lane >> 3) & 1));
  }
  front_zero(acc);
  for (int t = 0; t < nk; ++t) {
    const uint32_t tile = smem_u32(wr.consume());
    uint32_t at[U], bt[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      at[j] = a[j] + 2 * 64 * t;
      bt[j] = tile + bo[j];
    }
    front_mma<false>(acc, at, bt, n_units, min(4, (CP - 64 * t) / 16), 0);
  }
}

// The depthwise 3x3 on bf16 pairs: out[p][2j..] (p < 64, row stride ldo) from
// the 1x1 output t ([100][ldt], the 10x10 halo) and the tap pairs tp[tap * tps
// + j], j < npairs; one item = (channel pair, tile column, 4 output rows).
__device__ __forceinline__ void dw3_pairs(const __nv_bfloat16* t, int ldt,
                                          const __nv_bfloat162* tp, int tps, __nv_bfloat16* out,
                                          int ldo, int npairs) {
  for (int idx = threadIdx.x; idx < 16 * npairs; idx += blockDim.x) {
    const int j = idx % npairs, h = idx / npairs, pc = h & 7, pr = (h >> 3) * 4;
    float2 w[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) w[tap] = __bfloat1622float2(tp[tap * tps + j]);
    float2 s[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) s[o] = make_float2(0.f, 0.f);
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      float2 in[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        in[dx] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            t + ((pr + rr) * kHalo + pc + dx) * ldt + 2 * j));
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
      *reinterpret_cast<uint32_t*>(out + ((pr + o) * kTile + pc) * ldo + 2 * j) =
          pack_bf16x2(s[o].x, s[o].y);
  }
}

}  // namespace mp
