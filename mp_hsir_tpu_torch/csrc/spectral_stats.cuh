// The bf16 spectral stats kernel: phase 0 of _spectral_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1553-1572), the spectral half of
// _nhwc_sp0_kernel (:362, `accumulate` :423) and _sp0_kernel (:1926-1958), on
// the tensor cores. q|k = dw3x3(1x1([LN] cat(x1, x2))) over each 8x8 tile's
// 10x10 halo (the q and k rows of wqkv / wdw), then per image the Gram q_h^T
// k_h of every head and the squared norms |q|^2, |k|^2 over all pixels. The
// float32 instances run the 3xTF32 tile of spectral_stats_f32.cuh.
//
// Rounding points as spectral_stats_plain: the 1x1 output rounded to bf16,
// the depthwise output rounded to bf16; the Gram and the norms summed in
// float32 from those bf16 values.
//
// Bound: 2 x 2C^2 (the q|k 1x1) + 36 C + 2 C dh (the Gram) + 4 C flops per
// pixel against ~2C bytes per pixel read: tensor-core rate bounds it (0.27 ms
// per flagship forward). Design (the front tile's, spectral_front.cuh):
// - Grid: n_parts blocks per image (from the SM count and the occupancy, at
//   most one per tile; stats_parts), each walking a fixed range of tiles and
//   keeping its float32 partial sums in shared memory across them; one
//   sum_parts launch adds the parts in order: the result is bitwise the same
//   from run to run on one card.
// - Per tile the halo (112 rows: 7 row tiles) is staged once as bf16 [112][CP
//   + 8] by 16-byte cp.async copies, LayerNorm in place (stage_halo, halo_ln).
// - The output columns are ordered by head, each head [q_h | k_h] with dh
//   padded to dhp (a multiple of 16) by zero weights, and taken in groups of
//   whole heads: a group's 1x1 runs in passes of up to 192 columns (7 row
//   tiles x 6 column blocks, every warp holding up to 3 units of 16 x 32 in
//   registers), the
//   weight rows streamed straight from the torch layout (wqk: the q|k rows
//   [2C][C8]) as [NP][64] tiles through a 2-3 stage cp.async ring, zero past
//   C; each pass's sums are rounded to bf16 into the ring's space and its
//   depthwise 3x3 runs on bf16 pairs (taps staged once per block) into the
//   group's q|k tile [64][GW + 8] bf16.
// - After its group: each head's Gram (M = N = dhp, K = 64 pixels) by
//   ldmatrix.trans + mma.sync, every 16 x 16 unit owned by one warp, added to
//   the float32 partial [nH][dhp][dhp]; the norms from the same tile, every
//   column's 64 pixels summed by 4 lanes in a fixed order.
//
// spectral_stats_bwd_tc_kernel (below) is the first of the two launches of
// the bf16 backward (K10a, _sp0_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:1443;
// the second is dwconv_dx_tc_kernel, dwconv_dx.cuh): the same front per 8x8
// tile, then dq_h = k_h dG_h^T and dk_h = q_h dG_h on the tensor cores.
#pragma once

#include "spectral_front.cuh"

namespace mp {

constexpr int kStatsMaxN = 192;  // a pass's columns: 6 blocks of 32 x 7 row tiles <= 48 units
// the dynamic shared memory a plan may take (the H100's opt-in limit less
// the static)
constexpr size_t kStatsBudget = 232448 - 1024;

__host__ __device__ constexpr int round_up16(int n) { return (n + 15) / 16 * 16; }

// The row of the q|k weights ([2C][C8]: q rows, then k rows) behind column n
// of the head-grouped order (head h: columns [h hw, h hw + dhp) q, then dhp
// of k; hw = 2 dhp), or -1 for a padding column.
__host__ __device__ inline int qk_row(int n, int hw, int dhp, int dh, int C) {
  const int h = n / hw, j = n - h * hw;
  const int d = j < dhp ? j : j - dhp;
  return d < dh ? (j < dhp ? 0 : C) + h * dh + d : -1;
}

// The bf16 stats tile's plan at width C with nH heads (every piece a
// multiple of 16 bytes): taps [9][nqk] | gram partial
// [nH][dhp][dhp] f32 | norm partial [nqk] f32 | halo [112][ld] | q|k tile
// [64][GW + 8] | ring (the weight tiles, then the pass's 1x1 output [100][NP +
// 8]). Head groups as large as the budget allows, with 3 ring stages where
// they fit, else 2.
struct StatsPlan {
  int C, nH, dh, dhp, hw, nqk, CP, ld, nk, hg, groups, GW, pp, NP, ws;
  size_t taps, gacc, nacc, halo, qk, ring, bytes;
  __host__ __device__ StatsPlan(int c, int nh) : C(c), nH(nh) {
    dh = c / nh;
    dhp = round_up16(dh);
    hw = 2 * dhp;
    nqk = nH * hw;
    CP = round_up32(C);
    ld = CP + 8;
    nk = (CP + 63) / 64;
    const size_t b = sizeof(__nv_bfloat16);
    taps = b * 9 * nqk;
    gacc = sizeof(float) * nH * dhp * dhp;
    nacc = sizeof(float) * nqk;
    halo = b * kFrontRows * ld;
    for (int hmax = kStatsMaxN / hw > 1 ? kStatsMaxN / hw : 1;; --hmax) {
      groups = (nH + hmax - 1) / hmax;
      hg = (nH + groups - 1) / groups;
      GW = hg * hw;
      pp = (GW + kStatsMaxN - 1) / kStatsMaxN;
      NP = 32 * ((GW / 32 + pp - 1) / pp);
      qk = b * kPix * (GW + 8);
      const size_t t = b * kHaloPix * (NP + 8);
      for (ws = 3; ws >= 2; --ws) {
        const size_t w = ws * b * NP * kFrontLdw;
        ring = w > t ? w : t;
        bytes = taps + gacc + nacc + halo + qk + ring;
        if (bytes <= kStatsBudget) return;
      }
      ws = 2;
      if (hmax == 1) return;
    }
  }
  __host__ __device__ int row(int n) const { return qk_row(n, hw, dhp, dh, C); }
};

// Arguments: x1, x2, lnw, lnb as mp_spectral_stats; wqk the q|k rows of wqkv
// ([2C][C8], torch layout, 16-byte aligned), taps their depthwise taps
// ([2C][9]); flags: kVecX; part [B][n_parts][C dh + 2C] float32: this block's
// Gram (row h dh + d, col e), |q|^2, |k|^2 over its tiles.
__global__ void __launch_bounds__(kThreads)
spectral_stats_tc_kernel(const __nv_bfloat16* __restrict__ x1, const __nv_bfloat16* __restrict__ x2,
                         int C1, int C2, const float* __restrict__ lnw,
                         const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ wqk,
                         const __nv_bfloat16* __restrict__ taps, int H, int W, int nH, int shift,
                         float eps, int flags, float* __restrict__ part) {
  extern __shared__ float4 stats_dyn[];
  __shared__ int hsrc[kFrontRows];  // halo row -> raw source pixel (-1: zero row)
  const int C = C1 + C2;
  const StatsPlan pl(C, nH);
  const int ld = pl.ld, C8 = round_up8(C), dhp = pl.dhp, ldq = pl.GW + 8, ldt = pl.NP + 8;
  char* sm = reinterpret_cast<char*>(stats_dyn);
  __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(sm);    // [9][nqk / 2] tap pairs
  float* gacc = reinterpret_cast<float*>(sm + pl.taps);           // [nH][dhp][dhp]
  float* nacc = gacc + nH * dhp * dhp;                            // [nqk]
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(nacc + pl.nqk);  // [112][ld] halo
  __nv_bfloat16* qk = xh + kFrontRows * ld;                       // [64][ldq] q|k of a group
  __nv_bfloat16* rg = qk + kPix * ldq;                            // ring / 1x1 output
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ipart = blockIdx.x, n_parts = gridDim.x, b = blockIdx.y;
  const int tiles_w = W / kTile, n_tiles = (H / kTile) * tiles_w;
  const int t0 = (int)((long long)ipart * n_tiles / n_parts);
  const int t1 = (int)((long long)(ipart + 1) * n_tiles / n_parts);
  const bool vec_x = flags & kVecX;

  // the taps in the head-grouped column order as bf16 pairs, zero for the
  // padding columns; the partial sums zeroed
  for (int i = threadIdx.x; i < 9 * (pl.nqk / 2); i += blockDim.x) {
    const int tap = i / (pl.nqk / 2), n = 2 * (i - tap * (pl.nqk / 2));
    const int r0 = pl.row(n), r1 = pl.row(n + 1);
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    tp[i] = __halves2bfloat162(r0 < 0 ? z : taps[r0 * 9 + tap], r1 < 0 ? z : taps[r1 * 9 + tap]);
  }
  for (int i = threadIdx.x; i < nH * dhp * dhp + pl.nqk; i += blockDim.x) gacc[i] = 0.f;

  float acc[kFrontUnits][4][4];
  for (int t = t0; t < t1; ++t) {
    const int ty = t / tiles_w, tx = t % tiles_w;
    __syncthreads();  // the last tile's readers of hsrc and the halo are done
    for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x)
      hsrc[p] = halo_src(p, b, ty, tx, H, W, shift);
    __syncthreads();
    stage_halo(xh, ld, hsrc, x1, x2, C1, C2, pl.CP, vec_x);
    for (int g = 0; g < pl.groups; ++g) {
      const int g0 = g * pl.GW, gw = min(pl.GW, pl.nqk - g0);
      for (int n0 = 0; n0 < gw; n0 += pl.NP) {
        // the pass's columns [g0 + n0, g0 + n0 + np): [np][64] tiles of the
        // q|k rows, zero for the padding columns and past C8
        const int np = min(pl.NP, gw - n0), n_units = 7 * (np / 32), c0 = g0 + n0;
        const int hw = pl.hw, dh = pl.dh;
        auto wr = front_ring(rg, (size_t)pl.NP * kFrontLdw, pl.ws, pl.nk,
            [=](int kt, __nv_bfloat16* dst) {
              for (int u = threadIdx.x; u < np * 8; u += blockDim.x) {
                const int r = u >> 3, c = 64 * kt + (u & 7) * 8;
                const int row = qk_row(c0 + r, hw, dhp, dh, C);
                const bool ok = row >= 0 && c < C8;
                cp_async16(smem_u32(dst + r * kFrontLdw + (u & 7) * 8),
                           ok ? wqk + (size_t)row * C8 + c : wqk, ok ? 16 : 0);
              }
            });
        wr.prefetch();
        if (g == 0 && n0 == 0) {
          // the halo landed (the oldest group); LayerNorm in place
          cp_async_wait_upto(pl.ws - 1);
          __syncthreads();
          if (lnw != nullptr) halo_ln(xh, ld, hsrc, C, lnw, lnb, eps);
        }
        halo_1x1(acc, xh, ld, wr, n_units, pl.CP, pl.nk);
        cp_async_wait<0>();
        __syncthreads();
        // the pass's 1x1 output, rounded to bf16, into the ring's space
        front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
          if (r < kHaloPix) *reinterpret_cast<uint32_t*>(rg + r * ldt + c) = pack_bf16x2(v0, v1);
        });
        __syncthreads();
        dw3_pairs(rg, ldt, tp + c0 / 2, pl.nqk / 2, qk + n0, ldq, np / 2);
        __syncthreads();
      }
      // each head's Gram: unit u = (head, 16-row block mi of q_h^T, 16-column
      // block ni of k_h), A = q_h^T and B = k_h by ldmatrix.trans from [pixel][col]
      const int m16 = dhp / 16, per_head = m16 * m16, units = (gw / pl.hw) * per_head;
      for (int u = warp; u < units; u += kThreads / 32) {
        const int hh = u / per_head, mi = (u - hh * per_head) / m16, ni = u % m16;
        const int qc = hh * pl.hw + 16 * mi, kc = hh * pl.hw + dhp + 16 * ni;
        const uint32_t a = smem_u32(qk + ((lane & 7) + 8 * (lane >> 4)) * ldq + qc + 8 * ((lane >> 3) & 1));
        const uint32_t bb = smem_u32(qk + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldq + kc + 8 * (lane >> 4));
        float c[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kPix / 16; ++kk) {
          uint32_t af[4], bf[4];
          ldmatrix_x4_trans(af, a + 2 * 16 * kk * ldq);
          ldmatrix_x4_trans(bf, bb + 2 * 16 * kk * ldq);
          mma_16x8x16(c[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(c[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
        float* gh = gacc + ((g * pl.hg + hh) * dhp + 16 * mi + (lane >> 2)) * dhp + 16 * ni + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          gh[8 * nt] += c[nt][0];
          gh[8 * nt + 1] += c[nt][1];
          gh[8 * dhp + 8 * nt] += c[nt][2];
          gh[8 * dhp + 8 * nt + 1] += c[nt][3];
        }
      }
      // the norms: column pair j's 64 pixels in 4 quarters of 16, one per
      // lane of a group of 4, added in a fixed order
      for (int idx = threadIdx.x; idx < 2 * gw; idx += blockDim.x) {
        const int j = idx >> 2, q0 = 16 * (idx & 3);
        float sx = 0.f, sy = 0.f;
#pragma unroll 4
        for (int p = q0; p < q0 + 16; ++p) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qk + p * ldq + 2 * j));
          sx = fmaf(v.x, v.x, sx);
          sy = fmaf(v.y, v.y, sy);
        }
        sx += __shfl_xor_sync(0xffffffffu, sx, 1);
        sy += __shfl_xor_sync(0xffffffffu, sy, 1);
        sx += __shfl_xor_sync(0xffffffffu, sx, 2);
        sy += __shfl_xor_sync(0xffffffffu, sy, 2);
        if ((idx & 3) == 0) {
          nacc[g0 + 2 * j] += sx;
          nacc[g0 + 2 * j + 1] += sy;
        }
      }
    }
  }
  __syncthreads();
  // this part's sums in the outputs' layout: Gram [C][dh], |q|^2 [C], |k|^2 [C]
  const int dh = pl.dh, n = C * dh;
  float* out = part + ((size_t)b * n_parts + ipart) * (n + 2 * C);
  for (int i = threadIdx.x; i < n + 2 * C; i += blockDim.x) {
    float v;
    if (i < n) {
      const int h = i / (dh * dh), d = (i / dh) % dh, e = i % dh;
      v = gacc[(h * dhp + d) * dhp + e];
    } else {
      const int k = i - n, side = k >= C, h = (k - side * C) / dh, d = (k - side * C) % dh;
      v = nacc[h * pl.hw + side * dhp + d];
    }
    out[i] = v;
  }
}


// ---------------------------------------------------------------------------
// The bf16 backward's first launch (K10a: the recompute and dq | dk of
// _sp0_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:1443-1498). One 8x8 tile of
// the unrolled frame per 512-thread block; the forward tile's front as it is
// (the halo staged once as bf16 with LN in place, head groups, the q|k 1x1
// passes through the cp.async ring, each pass rounded to bf16, dw3_pairs
// into the group's q|k tile), then per head of the group, on the tensor
// cores: dq_h = k_h dG_h^T (B = dG_h as [n = d][k = e], ldmatrix) and dk_h =
// q_h dG_h (B = dG_h as [k = d][n = e], ldmatrix.trans), K = dhp, every 16 x
// 16 unit owned by one warp; the epilogue adds 2 q dnq (2 k dnk) in float32.
// Writes, in the torch channel order (q at h dh + d, k at C + h dh + d): un
// (the LN'd tile pixels, bf16, for the weight product), t (the 1x1 output at
// the tile's pixels, bf16: the forward rounds it there) and dqk (float32:
// the stencil's input, not rounded, as in the plain version and in JAX).
// Rounding points as spectral_stats_bwd_plain: q, k and dG rounded to bf16;
// the products and the norm terms summed in float32.
// ---------------------------------------------------------------------------

// Launch 1's plan: StatsPlan's (the same groups, passes and ring), with dG
// (bf16 [nH][dhp][dhp + 8], zero in the padding; rows of an odd multiple of
// 16 bytes for ldmatrix) in the place of the Gram partial and the column
// cotangents dn (float32 [nqk]: dnq | dnk per head, zero in the padding) in
// that of the norms. dG takes at most the partial's bytes: the plan stays
// within the forward's.
struct StatsBwdPlan {
  StatsPlan f;
  int ldg;
  size_t dg, bytes;
  __host__ __device__ StatsBwdPlan(int c, int nh) : f(c, nh) {
    ldg = f.dhp + 8;
    dg = sizeof(__nv_bfloat16) * f.nH * f.dhp * ldg;
    bytes = f.bytes - f.gacc + dg;
  }
};

// Arguments: x (B, H, W, C) bf16, the raw input, read through the roll-back;
// lnw, lnb float32 or NULL (no LN); wqk, taps as spectral_stats_tc_kernel;
// dgram (B, C, dh), dnq, dnk (B, nH, dh) float32; flags: kVecX (C % 8 == 0,
// x and un 16-byte aligned). Outputs in the unrolled frame: un (B, H, W, C)
// and t (B, H, W, 2C) bf16, dqk (B, H, W, 2C) float32.
__global__ void __launch_bounds__(kThreads)
spectral_stats_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
                             const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ wqk,
                             const __nv_bfloat16* __restrict__ taps,
                             const float* __restrict__ dgram, const float* __restrict__ dnq,
                             const float* __restrict__ dnk, int C, int H, int W, int nH,
                             int shift, float eps, int flags, __nv_bfloat16* __restrict__ un_out,
                             __nv_bfloat16* __restrict__ t_out, float* __restrict__ dqk_out) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 stats_bwd_dyn[];
  __shared__ int hsrc[kFrontRows];  // halo row -> raw source pixel (-1: zero row)
  const StatsBwdPlan bp(C, nH);
  const StatsPlan& pl = bp.f;
  const int ld = pl.ld, C8 = round_up8(C), dh = pl.dh, dhp = pl.dhp, hw = pl.hw;
  const int ldq = pl.GW + 8, ldt = pl.NP + 8, ldg = bp.ldg, C2 = 2 * C;
  char* sm = reinterpret_cast<char*>(stats_bwd_dyn);
  __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(sm);  // [9][nqk / 2] tap pairs
  bf16* dg = reinterpret_cast<bf16*>(sm + pl.taps);             // [nH][dhp][ldg] rnd(dG)
  float* dn = reinterpret_cast<float*>(sm + pl.taps + bp.dg);   // [nqk] dnq | dnk per head
  bf16* xh = reinterpret_cast<bf16*>(dn + pl.nqk);               // [112][ld] halo
  bf16* qk = xh + kFrontRows * ld;                               // [64][ldq] q|k of a group
  bf16* rg = qk + kPix * ldq;                                    // ring / 1x1 output
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const bool vec_x = flags & kVecX;
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };  // halo row of pixel i

  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x)
    hsrc[p] = halo_src(p, b, ty, tx, H, W, shift);
  // the taps (as the forward), rnd(dG) and dn in the head-grouped order
  for (int i = threadIdx.x; i < 9 * (pl.nqk / 2); i += blockDim.x) {
    const int tap = i / (pl.nqk / 2), n = 2 * (i - tap * (pl.nqk / 2));
    const int r0 = pl.row(n), r1 = pl.row(n + 1);
    const bf16 z = __float2bfloat16(0.f);
    tp[i] = __halves2bfloat162(r0 < 0 ? z : taps[r0 * 9 + tap], r1 < 0 ? z : taps[r1 * 9 + tap]);
  }
  const float* dgb = dgram + (size_t)b * C * dh;
  for (int i = threadIdx.x; i < nH * dhp * dhp; i += blockDim.x) {
    const int h = i / (dhp * dhp), d = (i / dhp) % dhp, e = i % dhp;
    dg[(h * dhp + d) * ldg + e] =
        __float2bfloat16(d < dh && e < dh ? dgb[(h * dh + d) * dh + e] : 0.f);
  }
  for (int n = threadIdx.x; n < pl.nqk; n += blockDim.x) {
    const int h = n / hw, j = n - h * hw, side = j >= dhp, d = j - side * dhp;
    dn[n] = d < dh ? (side ? dnk : dnq)[((size_t)b * nH + h) * dh + d] : 0.f;
  }
  __syncthreads();
  stage_halo(xh, ld, hsrc, x, nullptr, C, 0, pl.CP, vec_x);

  float acc[kFrontUnits][4][4];
  for (int g = 0; g < pl.groups; ++g) {
    const int g0 = g * pl.GW, gw = min(pl.GW, pl.nqk - g0);
    for (int n0 = 0; n0 < gw; n0 += pl.NP) {
      // the pass's columns [g0 + n0, g0 + n0 + np), as the forward streams them
      const int np = min(pl.NP, gw - n0), n_units = 7 * (np / 32), c0 = g0 + n0;
      auto wr = front_ring(rg, (size_t)pl.NP * kFrontLdw, pl.ws, pl.nk,
          [=](int kt, bf16* dst) {
            for (int u = threadIdx.x; u < np * 8; u += blockDim.x) {
              const int r = u >> 3, c = 64 * kt + (u & 7) * 8;
              const int row = qk_row(c0 + r, hw, dhp, dh, C);
              const bool ok = row >= 0 && c < C8;
              cp_async16(smem_u32(dst + r * kFrontLdw + (u & 7) * 8),
                         ok ? wqk + (size_t)row * C8 + c : wqk, ok ? 16 : 0);
            }
          });
      wr.prefetch();
      if (g == 0 && n0 == 0) {
        // the halo landed; LayerNorm in place; un from the tile's rows
        cp_async_wait_upto(pl.ws - 1);
        __syncthreads();
        if (lnw != nullptr) {
          halo_ln(xh, ld, hsrc, C, lnw, lnb, eps);
          __syncthreads();
        }
        if (vec_x) {
          for (int u = threadIdx.x; u < kPix * (C / 8); u += blockDim.x) {
            const int i = u / (C / 8), c = (u - i * (C / 8)) * 8;
            *reinterpret_cast<uint4*>(un_out + pix(i) * C + c) =
                *reinterpret_cast<const uint4*>(xh + hp(i) * ld + c);
          }
        } else {
          for (int u = threadIdx.x; u < kPix * C; u += blockDim.x) {
            const int i = u / C, c = u - i * C;
            un_out[pix(i) * C + c] = xh[hp(i) * ld + c];
          }
        }
      }
      halo_1x1(acc, xh, ld, wr, n_units, pl.CP, pl.nk);
      cp_async_wait<0>();
      __syncthreads();
      front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
        if (r < kHaloPix) *reinterpret_cast<uint32_t*>(rg + r * ldt + c) = pack_bf16x2(v0, v1);
      });
      __syncthreads();
      // t at the tile's pixels, in the torch order (a column pair is one
      // side of one head: dhp is a multiple of 16)
      for (int u = threadIdx.x; u < kPix * (np / 2); u += blockDim.x) {
        const int i = u / (np / 2), j = 2 * (u - i * (np / 2));
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(rg + hp(i) * ldt + j);
        const int r0 = qk_row(c0 + j, hw, dhp, dh, C), r1 = qk_row(c0 + j + 1, hw, dhp, dh, C);
        bf16* o = t_out + pix(i) * C2;
        if (r1 == r0 + 1 && (r0 & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o + r0) = v;
        } else {
          if (r0 >= 0) o[r0] = v.x;
          if (r1 >= 0) o[r1] = v.y;
        }
      }
      dw3_pairs(rg, ldt, tp + c0 / 2, pl.nqk / 2, qk + n0, ldq, np / 2);
      __syncthreads();
    }
    // dq_h = k_h dG_h^T, dk_h = q_h dG_h: unit u = (head of the group, side,
    // 16-row block mi, 16-column block ni); A is the other side's columns of
    // the q|k tile, K = dhp
    const int m16 = dhp / 16, per_head = 8 * m16, units = (gw / hw) * per_head;
    for (int u = warp; u < units; u += kThreads / 32) {
      const int hh = u / per_head, rem = u - hh * per_head;
      const int side = rem / (4 * m16), mi = (rem / m16) & 3, ni = rem % m16;
      const int oc = hh * hw + side * dhp;            // the output's columns in the tile
      const int ac = hh * hw + (side ? 0 : dhp);      // A's: k_h for dq, q_h for dk
      const uint32_t a = smem_u32(qk + (16 * mi + (lane & 15)) * ldq + ac + 8 * (lane >> 4));
      const bf16* gh = dg + (size_t)(g * pl.hg + hh) * dhp * ldg;
      const uint32_t bq = smem_u32(gh + (16 * ni + (lane & 7) + 8 * (lane >> 4)) * ldg +
                                   8 * ((lane >> 3) & 1));
      const uint32_t bk = smem_u32(gh + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldg + 16 * ni +
                                   8 * (lane >> 4));
      float c[2][4] = {};
      for (int kk = 0; kk < m16; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, a + 32 * kk);
        if (side) {
          ldmatrix_x4_trans(bf, bk + 2 * 16 * kk * ldg);
        } else {
          ldmatrix_x4(bf, bq + 32 * kk);
        }
        mma_16x8x16(c[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_16x8x16(c[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
      // + 2 own dn in float32, to dqk in the torch order
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = 16 * mi + (lane >> 2) + 8 * rr, d = 16 * ni + 8 * nt + 2 * (lane & 3);
          const int n = g0 + oc + d;
          const float2 own = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qk + r * ldq + oc + d));
          const float v0 = c[nt][2 * rr] + 2.f * own.x * dn[n];
          const float v1 = c[nt][2 * rr + 1] + 2.f * own.y * dn[n + 1];
          const int q0 = qk_row(n, hw, dhp, dh, C), q1 = qk_row(n + 1, hw, dhp, dh, C);
          float* o = dqk_out + pix(r) * C2;
          if (q1 == q0 + 1 && (q0 & 1) == 0) {
            *reinterpret_cast<float2*>(o + q0) = make_float2(v0, v1);
          } else {
            if (q0 >= 0) o[q0] = v0;
            if (q1 >= 0) o[q1] = v1;
          }
        }
    }
  }
}

}  // namespace mp
