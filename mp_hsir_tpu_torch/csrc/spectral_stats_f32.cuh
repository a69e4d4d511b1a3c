// The float32 spectral stats kernel: phase 0 of _spectral_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1553-1572), the spectral half of
// _nhwc_sp0_kernel (:362) and _sp0_kernel (:2027) in float32, on the tensor
// cores in 3xTF32. q|k = dw3x3(1x1([LN] cat(x1, x2))) over each 8x8 tile's
// 10x10 halo (the q and k rows of wqkv / wdw), then per image the Gram
// q_h^T k_h of every head and the squared norms |q|^2, |k|^2 over all
// pixels: what the bf16 tile (spectral_stats.cuh) computes, with no rounding
// points.
//
// Bound: 2 x 2C^2 (the q|k 1x1) + 36 C + 2 C dh (the Gram) + 4 C flops per
// pixel against ~4C bytes per pixel read; three TF32 products per float32
// product put it at the tensor cores' TF32 rate (1.57 ms per flagship
// forward). Design (the bf16 tile's map, the front pieces of
// spectral_front_f32.cuh):
// - Grid: n_parts blocks per image (stats_parts), each walking a fixed range
//   of tiles; one sum_stats launch adds the parts in order (bitwise the same
//   from run to run on one card, no float atomics).
// - The output columns are ordered by head, each head [q_h | k_h] with dh
//   padded to dhp (a multiple of 16) by zero weights (qk_row), in groups of
//   whole heads of at most 192 columns. The block walks its tiles once per
//   group, so only that group's float32 Gram partial [hg][dhp][dhp] and norm
//   partial are live in shared memory; they go to the part buffer when the
//   walk ends. The taps of the group are staged once per walk.
// - Per tile and group: the halo's and the group's weight rows' 32-channel
//   chunks through a 3-stage cp.async ring (the q|k rows of the torch
//   weight, wqk [2C][C8], rows padded to 16 bytes), LayerNorm per chunk; the
//   1x1 in 3xTF32 into registers (up to 3 units of 16 x 32 a warp); its
//   output [100][GW + 8] over the ring's space; the depthwise 3x3 in float32
//   into the group's q|k tile [64][GW + 8].
// - Each head's Gram (M = N = dhp, K = 64 pixels) in 3xTF32, every 16 x 16
//   unit owned by one warp, the fragments of q_h^T and k_h read by scalar
//   loads from the q|k tile (rows of 8 words mod 32: the (lane % 4, lane /
//   4) reads hit 32 banks), added to the partial by their owner thread; the
//   norms from the same tile, every column's 64 pixels summed by 8 lanes
//   (pixels lane, lane + 8, ..) and a butterfly, in a fixed order.
#pragma once

#include "spectral_front_f32.cuh"
#include "spectral_stats.cuh"

namespace mp {

constexpr int kStatsF32MaxN = 192;  // a group's columns: 7 row tiles x 6 blocks of 32 <= 48 units
// the dynamic shared memory a plan may take (the H100's opt-in limit less
// the static)
constexpr size_t kStatsF32Budget = 232448 - 1024;

// The float32 stats tile's plan at width C with nH heads (every piece a
// multiple of 16 bytes): taps [9][GW] | Gram partial [hg][dhp][dhp] | norm
// partial [GW] | LN mean, rstd [2][112] | q|k tile [64][GW + 8] | ring
// (S stages of the halo and weight chunks [112 + GW][36], then the 1x1
// output [100][GW + 8]). Heads of up to dhp = 96 (a head's 2 dhp columns in
// one group); 3 ring stages where they fit, else 2.
struct StatsF32Plan {
  int C, nH, dh, dhp, hw, nqk, nk, hg, groups, GW, ldq, S;
  size_t taps, gacc, nacc, lnst, qk, ring, bytes;
  __host__ __device__ StatsF32Plan(int c, int nh) : C(c), nH(nh) {
    dh = c / nh;
    dhp = round_up16(dh);
    hw = 2 * dhp;
    nqk = nH * hw;
    nk = (C + kF32K - 1) / kF32K;
    const int hmax = kStatsF32MaxN / hw > 1 ? kStatsF32MaxN / hw : 1;
    groups = (nH + hmax - 1) / hmax;
    hg = (nH + groups - 1) / groups;
    GW = hg * hw;
    ldq = GW + 8;
    const size_t f = sizeof(float);
    taps = f * 9 * GW;
    gacc = f * hg * dhp * dhp;
    nacc = f * GW;
    lnst = f * 2 * kFrontRows;
    qk = f * kPix * ldq;
    const size_t t = f * kHaloPix * ldq;
    for (S = 3;; --S) {
      const size_t w = S * f32_stage_bytes(GW);
      ring = w > t ? w : t;
      bytes = taps + gacc + nacc + lnst + qk + ring;
      if (bytes <= kStatsF32Budget || S == 2) break;
    }
  }
  // whether the tile takes this width (a head's columns fit one group)
  __host__ __device__ bool ok() const { return hw <= kStatsF32MaxN; }
};

// Arguments: x1, x2, lnw, lnb as mp_spectral_stats (float32); wqk the q|k
// rows of wqkv ([2C][C8], torch layout, C8 = C rounded up to 8, zero past C;
// 16-byte aligned), taps their depthwise taps ([2C][9]); vec_x: C1, C2
// multiples of 4 and x1, x2 16-byte aligned; part [B][n_parts][C dh + 2C]:
// this block's Gram (row h dh + d, col e), |q|^2, |k|^2 over its tiles.
__global__ void __launch_bounds__(kThreads)
spectral_stats_f32_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int C1,
                          int C2, const float* __restrict__ lnw, const float* __restrict__ lnb,
                          const float* __restrict__ wqk, const float* __restrict__ taps, int H,
                          int W, int nH, int shift, float eps, int vec_x,
                          float* __restrict__ part) {
  extern __shared__ float4 stats_f32_dyn[];
  __shared__ int hsrc[kFrontRows];  // halo row -> raw source pixel (-1: zero row)
  const int C = C1 + C2;
  const StatsF32Plan pl(C, nH);
  const int GW = pl.GW, ldq = pl.ldq, dh = pl.dh, dhp = pl.dhp, hw = pl.hw, C8 = round_up8(C);
  float* tp = reinterpret_cast<float*>(stats_f32_dyn);  // [9][GW] the group's taps
  float* gacc = tp + 9 * GW;                             // [hg][dhp][dhp]
  float* nacc = gacc + pl.hg * dhp * dhp;                // [GW]
  float* mu = nacc + GW;                                 // [112]
  float* rs = mu + kFrontRows;                           // [112]
  float* qk = rs + kFrontRows;                           // [64][ldq] q|k of the group
  float* rg = qk + kPix * ldq;                           // ring / 1x1 output [100][ldq]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ipart = blockIdx.x, n_parts = gridDim.x, b = blockIdx.y;
  const int tiles_w = W / kTile, n_tiles = (H / kTile) * tiles_w;
  const int t0 = (int)((long long)ipart * n_tiles / n_parts);
  const int t1 = (int)((long long)(ipart + 1) * n_tiles / n_parts);
  const HaloF32 hl{x1, x2, C1, C2, hsrc, vec_x != 0};
  const int n = C * dh;
  float* out = part + ((size_t)b * n_parts + ipart) * (n + 2 * C);

  for (int g = 0; g < pl.groups; ++g) {
    const int g0 = g * GW, gw = min(GW, pl.nqk - g0), n_units = 7 * (gw / 32);
    __syncthreads();  // the last group's readers of the taps and partials are done
    // the group's taps in the head-grouped column order, zero for the
    // padding columns; its partial sums zeroed
    for (int i = threadIdx.x; i < 9 * GW; i += blockDim.x) {
      const int tap = i / GW, c = i - tap * GW, r = c < gw ? qk_row(g0 + c, hw, dhp, dh, C) : -1;
      tp[i] = r < 0 ? 0.f : taps[r * 9 + tap];
    }
    for (int i = threadIdx.x; i < pl.hg * dhp * dhp + GW; i += blockDim.x) gacc[i] = 0.f;

    for (int t = t0; t < t1; ++t) {
      const int ty = t / tiles_w, tx = t % tiles_w;
      __syncthreads();  // the last tile's readers of hsrc, the q|k tile and the ring are done
      for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x)
        hsrc[p] = halo_src(p, b, ty, tx, H, W, shift);
      __syncthreads();
      if (lnw != nullptr)  // read after the first chunk's barrier
        ln_stats_rows(mu, rs, kHaloPix, C, eps, [&](int p, int k) { return hl.at(hsrc[p], k); },
                      [&](int p) { return hsrc[p] >= 0; });
      auto ring = front_ring(rg, f32_stage_bytes(GW) / sizeof(float), pl.S, pl.nk,
          [=](int kt, float* dst) {
            stage_f32_chunk(dst, hl, wqk, C8, gw,
                            [=](int c) { return qk_row(g0 + c, hw, dhp, dh, C); }, kt);
          });
      ring.prefetch();
      float acc[kFrontUnits][4][4];
      halo_1x1_f32(acc, ring, n_units, pl.nk, [&](float* st, int kt) {
        if (lnw != nullptr) {
          ln_f32_chunk(st, hsrc, mu, rs, lnw, lnb, C, kt);
          __syncthreads();
        }
      });
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring: the 1x1 output takes its space
      front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
        if (r < kHaloPix) *reinterpret_cast<float2*>(rg + r * ldq + c) = make_float2(v0, v1);
      });
      __syncthreads();
      dw3_f32(rg, ldq, tp, GW, qk, ldq, gw / 2);
      __syncthreads();
      // each head's Gram: unit u = (head of the group, 16-row block mi of
      // q_h^T, 16-column block ni of k_h); A[d][p] = q[p][d] and B[p][e] =
      // k[p][e] from the q|k tile, 8 pixels a k8 step
      const int m16 = dhp / 16, per_head = m16 * m16, units = (gw / hw) * per_head;
      for (int u = warp; u < units; u += kThreads / 32) {
        const int hh = u / per_head, mi = (u - hh * per_head) / m16, ni = u % m16;
        const float* qa = qk + hh * hw + 16 * mi + (lane >> 2);
        const float* kb = qk + hh * hw + dhp + 16 * ni + (lane >> 2);
        float c[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kPix / 8; ++kk) {
          const int r0 = (8 * kk + (lane & 3)) * ldq, r1 = r0 + 4 * ldq;
          uint32_t ab[4], as[4];
          split_tf32(qa[r0], ab[0], as[0]);
          split_tf32(qa[r0 + 8], ab[1], as[1]);
          split_tf32(qa[r1], ab[2], as[2]);
          split_tf32(qa[r1 + 8], ab[3], as[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(kb[r0 + 8 * nt], bb0, bs0);
            split_tf32(kb[r1 + 8 * nt], bb1, bs1);
            mma_3xtf32(c[nt], ab, as, bb0, bb1, bs0, bs1);
          }
        }
        float* gh = gacc + (hh * dhp + 16 * mi + (lane >> 2)) * dhp + 16 * ni + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          gh[8 * nt] += c[nt][0];
          gh[8 * nt + 1] += c[nt][1];
          gh[8 * dhp + 8 * nt] += c[nt][2];
          gh[8 * dhp + 8 * nt + 1] += c[nt][3];
        }
      }
      // the norms: column j's 64 pixels by 8 lanes (lane e: pixels e, e + 8,
      // ..), then a butterfly over the 8, in a fixed order
      for (int idx = threadIdx.x; idx < 8 * gw; idx += blockDim.x) {
        const int j = idx >> 3, e = idx & 7;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = qk[(e + 8 * i) * ldq + j];
          s = fmaf(v, v, s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        if (e == 0) nacc[j] += s;
      }
    }
    __syncthreads();
    // the group's sums in the outputs' layout: Gram [C][dh], |q|^2 [C], |k|^2 [C]
    const int per = dh * (dh + 2);
    for (int i = threadIdx.x; i < pl.hg * per; i += blockDim.x) {
      const int hh = i / per, r = i - hh * per, h = g * pl.hg + hh;
      if (h >= nH) continue;
      if (r < dh * dh) {
        out[(h * dh + r / dh) * dh + r % dh] = gacc[(hh * dhp + r / dh) * dhp + r % dh];
      } else {
        const int side = r - dh * dh >= dh, d = r - dh * dh - side * dh;
        out[n + side * C + h * dh + d] = nacc[hh * hw + side * dhp + d];
      }
    }
  }
}

}  // namespace mp
