// The pieces of the float32 halo tiles on the tensor cores (3xTF32): the
// halo staged in K chunks beside the same chunk of the weight rows, its
// LayerNorm, the 1x1 over the halo and the depthwise conv in float32. The
// float32 spectral stats tile (spectral_stats_f32.cuh) is built from them;
// so is the float32 apply front (spectral_apply_f32_kernel, spectral.cu),
// with the v rows in the place of the q|k rows, and its comb product, plan
// and epilogue loads below.
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
// zero row; -2 - q: pixel q of the shard's halo rows, hal [2][B][W][C1 +
// C2], see halo_src); vec: C1, C2 multiples of 4 and x1, x2, hal 16-byte
// aligned.
struct HaloF32 {
  const float* x1;
  const float* x2;
  int C1, C2;
  const int* hsrc;
  bool vec;
  const float* hal = nullptr;
  // channel k of source pixel pix (not -1)
  __device__ __forceinline__ const float* src(int pix, int k) const {
    if (pix < 0) return hal + (size_t)(-2 - pix) * (C1 + C2) + k;
    return k < C1 ? x1 + (size_t)pix * C1 + k : x2 + (size_t)pix * C2 + (k - C1);
  }
  __device__ __forceinline__ float at(int pix, int k) const { return *src(pix, k); }
};

// Stages K chunk kt (columns 32 kt ..) of N weight rows into sw ([N][kF32Ld])
// by 16-byte cp.async: row n from w + row(n) * ldw (-1: a zero row; ldw a
// multiple of 4, rows 16-byte aligned), zero past ldw. The caller commits.
template <typename Row>
__device__ __forceinline__ void stage_w_f32_chunk(float* sw, const float* __restrict__ w, int ldw,
                                                  int N, Row row, int kt) {
  const int k0 = kt * kF32K;
  for (int u = threadIdx.x; u < N * (kF32K / 4); u += blockDim.x) {
    const int n = u >> 3, c = (u & 7) * 4, k = k0 + c, r = row(n);
    const bool ok = r >= 0 && k < ldw;
    cp_async16(smem_u32(sw + n * kF32Ld + c), ok ? w + (size_t)r * ldw + k : w, ok ? 16 : 0);
  }
}

// Stages K chunk kt (channels 32 kt ..) of the halo and of N weight rows
// into one ring stage st, all by cp.async: the halo [112][kF32Ld] (zero past
// C and in zero rows; a shard's halo rows from h.hal), then the weights [N][kF32Ld], row n from w + row(n) * ldw (-1: a
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
      const bool ok = pix != -1 && k < C;
      cp_async16(smem_u32(st + p * kF32Ld + c), ok ? h.src(pix, k) : h.x1, ok ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kFrontRows * kF32K; u += blockDim.x) {
      const int p = u / kF32K, c = u - p * kF32K, k = k0 + c, pix = h.hsrc[p];
      const bool ok = pix != -1 && k < C;
      cp_async4(smem_u32(st + p * kF32Ld + c), ok ? h.src(pix, k) : h.x1, ok ? 4 : 0);
    }
  }
  stage_w_f32_chunk(st + kFrontRows * kF32Ld, w, ldw, N, row, kt);
}

// The LayerNorm of a staged halo chunk kt in place (rows with a source,
// channels below C); the caller passes a barrier before anyone reads it.
__device__ __forceinline__ void ln_f32_chunk(float* st, const int* hsrc, const float* mu,
                                             const float* rs, const float* __restrict__ lnw,
                                             const float* __restrict__ lnb, int C, int kt) {
  for (int u = threadIdx.x; u < kHaloPix * kF32K; u += blockDim.x) {
    const int p = u / kF32K, c = u - p * kF32K, k = kt * kF32K + c;
    if (hsrc[p] != -1 && k < C) {
      float* v = st + p * kF32Ld + c;
      *v = (*v - mu[p]) * rs[p] * lnw[k] + lnb[k];
    }
  }
}

// The 1x1 over the halo in 3xTF32: acc (the warp's units of the 112 x N
// output: unit q = warp + 16 j is row tile q % 7, column block q / 7;
// n_units = 7 N / 32 <= 16 U) = halo [112][CK] x the weight rows [N][CK]^T,
// over the ring's nk chunks; land(st, kt) runs on each chunk after it landed
// (the LayerNorm, with its own barrier) and before it is read. KU: the k8
// steps of a chunk unrolled (all 4 by default; fewer live registers with 1).
template <int U, int KU = kF32K / 8, typename Ring, typename Land>
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
#pragma unroll (KU)
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

// ---------------------------------------------------------------------------
// The float32 apply front (spectral_apply_f32_kernel in spectral.cu)
// ---------------------------------------------------------------------------

constexpr int kApplyF32MaxGW = 192;  // a v column group: 7 row tiles x 6 blocks of 32 <= 48 units
constexpr int kCombMaxN = 384;       // a comb pass: 4 row tiles x 12 blocks of 32 = 48 units
// the dynamic shared memory the plan may take (the H100's opt-in limit less
// the static)
constexpr size_t kApplyF32Budget = 232448 - 1024;

// The float32 apply tile's plan at input width C and v width CL (C, or a
// member's head block under the spectral mesh axis; every piece a multiple
// of 16 bytes): taps [9][CPL] | LN mean, rstd [2][112] | v [64][CPL + 4] |
// ring.
// The ring's space takes, in turn, each v column group's halo and weight
// chunks (ws stages of [112 + GW][36]) and its 1x1 output [100][GW + 8],
// then each comb pass's chunks of comb^T (cs stages of [NP][36]); stages: as
// many as the space left holds, 2 to 3. CP = C and CPL = CL rounded up to
// 32: the 1x1's nk input chunks of C, the v columns in `groups` groups of
// GW, the comb product's nkv chunks of CL deep and its output columns in
// `passes` passes of NP. With the tail, its scratch (tail_f32_bytes) lies
// over the dead front from offset 0, and the plan is the larger of the two.
// A head block (CL < C) only narrows v, its taps and comb's depth, so its
// plan is never larger than the whole attention's.
struct ApplyF32Plan {
  int C, CL, CP, CPL, ldv, nk, nkv, groups, GW, ldt, passes, NP, ws, cs;
  size_t taps, lnst, v, stage, cstage, ring, front;
  __host__ __device__ ApplyF32Plan(int c, int cl) : C(c), CL(cl) {
    CP = round_up32(c);
    CPL = round_up32(cl);
    ldv = CPL + 4;
    nk = CP / kF32K;
    nkv = CPL / kF32K;
    const int nb = CP / 32, nbl = CPL / 32;
    groups = (nbl + kApplyF32MaxGW / 32 - 1) / (kApplyF32MaxGW / 32);
    GW = 32 * ((nbl + groups - 1) / groups);
    ldt = GW + 8;
    passes = (nb + kCombMaxN / 32 - 1) / (kCombMaxN / 32);
    NP = 32 * ((nb + passes - 1) / passes);
    const size_t f = sizeof(float);
    taps = f * 9 * CPL;
    lnst = f * 2 * kFrontRows;
    v = f * kPix * ldv;
    stage = f32_stage_bytes(GW);
    cstage = f * NP * kF32Ld;
    const size_t fixed = taps + lnst + v;
    const size_t room = fixed < kApplyF32Budget ? kApplyF32Budget - fixed : 0;
    ws = room / stage >= 3 ? 3 : 2;
    cs = room / cstage >= 3 ? 3 : 2;
    const size_t t = f * kHaloPix * ldt;
    ring = ws * stage > t ? ws * stage : t;
    ring = cs * cstage > ring ? cs * cstage : ring;
    front = taps + lnst + v + ring;
  }
  __host__ __device__ size_t bytes(bool tail) const {
    const size_t t = tail ? tail_f32_bytes(C, tail_f32_stages(C)) : 0;
    return t > front ? t : front;
  }
};

// The comb product of one pass in 3xTF32: acc (the warp's units of the 64 x
// np output: unit q = warp + 16 j is row tile q % 4 = warp % 4, column block
// q / 4, front_out's layout with 4 row tiles; n_units = 4 np / 32 <= 16 U) =
// v ([64][ldv]) x comb over the ring's nk chunks of comb^T ([np][kF32Ld]
// stages, row n = output channel). A warp's units share their row tile, so
// each k8 step loads and splits its A fragment once.
template <int U, typename Ring>
__device__ __forceinline__ void comb_f32(float (&acc)[U][4][4], const float* vs, int ldv,
                                         Ring& rg, int n_units, int nk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t a = smem_u32(vs + (16 * (warp & 3) + (lane & 15)) * ldv + 4 * (lane >> 4));
  const uint32_t bo = 4 * ((32 * (warp >> 2) + (lane & 7) + 8 * (lane >> 4)) * kF32Ld +
                           4 * ((lane >> 3) & 1));
  front_zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t s = smem_u32(rg.consume()) + bo;
#pragma unroll
    for (int kk = 0; kk < kF32K / 8; ++kk) {
      uint32_t av[4], ab[4], as[4];
      ldmatrix_x4(av, a + 4 * (kF32K * kt + 8 * kk));
      split_tf32(av, ab, as);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (warp + 16 * j >= n_units) break;  // warp-uniform
        const uint32_t b = s + 4 * (4 * 32 * j * kF32Ld + 8 * kk);
        mma_pair_f32(acc[j][0], acc[j][1], ab, as, b);
        mma_pair_f32(acc[j][2], acc[j][3], ab, as, b + 4 * 16 * kF32Ld);
      }
    }
  }
}

// Elements k and k + 1 (zero past C) of pixel p of cat(x1, x2), or of one
// map (x2 = nullptr, C2 = 0); pair: one 8-byte load (C1 and C2 even, 8-byte
// aligned maps), else two.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ x1,
                                            const float* __restrict__ x2, int C1, int C2,
                                            size_t p, int k, bool pair) {
  if (pair)
    return *reinterpret_cast<const float2*>(k < C1 ? x1 + p * C1 + k : x2 + p * C2 + (k - C1));
  auto at = [&](int i) {
    return i >= C1 + C2 ? 0.f : i < C1 ? x1[p * C1 + i] : x2[p * C2 + (i - C1)];
  };
  return make_float2(at(k), at(k + 1));
}

}  // namespace mp
