// The bf16 spectral stats kernel: phase 0 of _spectral_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1553-1572), the spectral half of
// _nhwc_sp0_kernel (:362, `accumulate` :423) and _sp0_kernel (:1926-1958), on
// the tensor cores. q|k = dw3x3(1x1([LN] cat(x1, x2))) over each 8x8 tile's
// 10x10 halo (the q and k rows of wqkv / wdw), then per image the Gram q_h^T
// k_h of every head and the squared norms |q|^2, |k|^2 over all pixels. The
// float32 instances keep spectral_stats_kernel (spectral.cu) and SIMT FMA.
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

}  // namespace mp
