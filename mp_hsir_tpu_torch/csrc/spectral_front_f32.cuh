// The pieces of the float32 halo tiles on the tensor cores (3xTF32): the
// halo staged in K chunks beside the same chunk of the weight rows, its
// LayerNorm, the 1x1 over the halo and the depthwise conv in float32. The
// float32 spectral stats tile (spectral_stats_f32.cuh) is built from them;
// the float32 apply front's 1x1 and depthwise conv are the same pieces with
// the v rows in the place of the q|k rows.
//
// Design:
// - The halo (100 pixels, 112 rows with the padding to 7 row tiles of 16) is
//   not resident: each 32-channel chunk of it is staged beside the same chunk
//   of the N weight rows, as float32 [112][36] and [N][36] (rows of 36
//   floats, 4 words mod 32: ldmatrix reads them without bank conflicts), by
//   16-byte cp.async where C1 and C2 are multiples of 4 (else by 4-byte
//   cp.async: element-wise loads and stores into this ring's stages faulted
//   with cudaError 715 on the card), through an S-stage ring (FrontRing on
//   float stages). The plan stays small at every width; a tile's halo is
//   read again from L2 for every column group.
// - LayerNorm: every halo pixel's mean and rstd over all C channels first
//   (ln_stats_rows, one warp a pixel, from global memory), then each chunk
//   normalised in place when it lands (ln_f32_chunk).
// - The 1x1 (halo_1x1_f32): 112 x N x CK, every warp holding up to 3 units
//   of 16 x 32 outputs in registers (the bf16 front's unit map, front_out's
//   accumulator layout), on m16n8k8 TF32 mma.sync in 3xTF32: each fragment
//   loaded as float32 by ldmatrix, split into big and small TF32 halves, the
//   k8 step's three products summed from zero on the tensor cores and added
//   to the float32 sums (mma_3xtf32, common.cuh).
// - The depthwise 3x3 (dw3_f32) in float32 on column pairs, from the 1x1
//   output [100][ldt]; each output's nine taps summed by fmaf in tap order.
#pragma once

#include "spectral_front.cuh"

namespace mp {

constexpr int kF32K = 32;          // a ring stage's channels
constexpr int kF32Ld = kF32K + 4;  // a staged row: 36 floats (144 B, 4 words mod 32)

// Bytes of one ring stage with N weight rows: the halo chunk [112][36], then
// the weight rows' chunk [N][36] (a multiple of 16 bytes).
__host__ __device__ constexpr size_t f32_stage_bytes(int N) {
  return sizeof(float) * (size_t)(kFrontRows + N) * kF32Ld;
}

// The halo of one tile: row p is raw pixel hsrc[p] of cat(x1, x2) (-1: a
// zero row); vec: C1, C2 multiples of 4 and x1, x2 16-byte aligned.
struct HaloF32 {
  const float* x1;
  const float* x2;
  int C1, C2;
  const int* hsrc;
  bool vec;
  __device__ __forceinline__ float at(int pix, int k) const {
    return k < C1 ? x1[(size_t)pix * C1 + k] : x2[(size_t)pix * C2 + (k - C1)];
  }
};

// Stages K chunk kt (channels 32 kt ..) of the halo and of N weight rows
// into one ring stage st, all by cp.async: the halo [112][kF32Ld] (zero past
// C and in zero rows), then the weights [N][kF32Ld], row n from w + row(n) * ldw (-1: a
// zero row; ldw a multiple of 4, rows 16-byte aligned), zero past ldw. The
// caller commits.
template <typename Row>
__device__ __forceinline__ void stage_f32_chunk(float* st, const HaloF32& h,
                                                const float* __restrict__ w, int ldw, int N,
                                                Row row, int kt) {
  const int C = h.C1 + h.C2, k0 = kt * kF32K;
  if (h.vec) {
    for (int u = threadIdx.x; u < kFrontRows * (kF32K / 4); u += blockDim.x) {
      const int p = u >> 3, c = (u & 7) * 4, k = k0 + c, pix = h.hsrc[p];
      const bool ok = pix >= 0 && k < C;
      const float* s = !ok ? h.x1 : k < h.C1 ? h.x1 + (size_t)pix * h.C1 + k
                                             : h.x2 + (size_t)pix * h.C2 + (k - h.C1);
      cp_async16(smem_u32(st + p * kF32Ld + c), s, ok ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kFrontRows * kF32K; u += blockDim.x) {
      const int p = u / kF32K, c = u - p * kF32K, k = k0 + c, pix = h.hsrc[p];
      const bool ok = pix >= 0 && k < C;
      const float* s = !ok ? h.x1 : k < h.C1 ? h.x1 + (size_t)pix * h.C1 + k
                                             : h.x2 + (size_t)pix * h.C2 + (k - h.C1);
      cp_async4(smem_u32(st + p * kF32Ld + c), s, ok ? 4 : 0);
    }
  }
  float* sw = st + kFrontRows * kF32Ld;
  for (int u = threadIdx.x; u < N * (kF32K / 4); u += blockDim.x) {
    const int n = u >> 3, c = (u & 7) * 4, k = k0 + c, r = row(n);
    const bool ok = r >= 0 && k < ldw;
    cp_async16(smem_u32(sw + n * kF32Ld + c), ok ? w + (size_t)r * ldw + k : w, ok ? 16 : 0);
  }
}

// The LayerNorm of a staged halo chunk kt in place (in-image rows, channels
// below C); the caller passes a barrier before anyone reads it.
__device__ __forceinline__ void ln_f32_chunk(float* st, const int* hsrc, const float* mu,
                                             const float* rs, const float* __restrict__ lnw,
                                             const float* __restrict__ lnb, int C, int kt) {
  for (int u = threadIdx.x; u < kHaloPix * kF32K; u += blockDim.x) {
    const int p = u / kF32K, c = u - p * kF32K, k = kt * kF32K + c;
    if (hsrc[p] >= 0 && k < C) {
      float* v = st + p * kF32Ld + c;
      *v = (*v - mu[p]) * rs[p] * lnw[k] + lnb[k];
    }
  }
}

// The 1x1 over the halo in 3xTF32: acc (the warp's units of the 112 x N
// output: unit q = warp + 16 j is row tile q % 7, column block q / 7;
// n_units = 7 N / 32 <= 16 U) = halo [112][CK] x the weight rows [N][CK]^T,
// over the ring's nk chunks; land(st, kt) runs on each chunk after it landed
// (the LayerNorm, with its own barrier) and before it is read.
template <int U, typename Ring, typename Land>
__device__ __forceinline__ void halo_1x1_f32(float (&acc)[U][4][4], Ring& rg, int n_units,
                                             int nk, Land land) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t ao[U], bo[U];  // the lane's byte offsets of A and B in a stage
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int q = warp + 16 * j, mt = q % 7, nb = q / 7;
    ao[j] = 4 * ((16 * mt + (lane & 15)) * kF32Ld + 4 * (lane >> 4));
    bo[j] = 4 * ((kFrontRows + 32 * nb + (lane & 7) + 8 * (lane >> 4)) * kF32Ld +
                 4 * ((lane >> 3) & 1));
  }
  front_zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    float* st = rg.consume();
    land(st, kt);
    const uint32_t s = smem_u32(st);
#pragma unroll
    for (int kk = 0; kk < kF32K / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (warp + 16 * j >= n_units) break;  // warp-uniform
        uint32_t av[4], ab[4], as[4];
        ldmatrix_x4(av, s + ao[j] + 32 * kk);
        split_tf32(av, ab, as);
        mma_pair_f32(acc[j][0], acc[j][1], ab, as, s + bo[j] + 32 * kk);
        mma_pair_f32(acc[j][2], acc[j][3], ab, as, s + bo[j] + 4 * 16 * kF32Ld + 32 * kk);
      }
    }
  }
}

// The depthwise 3x3 in float32: out[p][2j..] (p < 64, row stride ldo) from
// the 1x1 output t ([100][ldt], the 10x10 halo) and the taps tp[tap * tps +
// 2j..], j < npairs; one item = (column pair, tile column, 4 output rows).
__device__ __forceinline__ void dw3_f32(const float* t, int ldt, const float* tp, int tps,
                                        float* out, int ldo, int npairs) {
  for (int idx = threadIdx.x; idx < 16 * npairs; idx += blockDim.x) {
    const int j = idx % npairs, h = idx / npairs, pc = h & 7, pr = (h >> 3) * 4;
    float2 w[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      w[tap] = *reinterpret_cast<const float2*>(tp + tap * tps + 2 * j);
    float2 s[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) s[o] = make_float2(0.f, 0.f);
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      float2 in[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        in[dx] = *reinterpret_cast<const float2*>(t + ((pr + rr) * kHalo + pc + dx) * ldt + 2 * j);
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
      *reinterpret_cast<float2*>(out + ((pr + o) * kTile + pc) * ldo + 2 * j) = s[o];
  }
}

}  // namespace mp
