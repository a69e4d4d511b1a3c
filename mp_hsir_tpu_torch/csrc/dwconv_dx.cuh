// The bf16 backward of `[LN ->] 1x1 -> depthwise 3x3` from the cotangent at
// the depthwise output, on the tensor cores: the second launch of the bf16
// spectral stats backward (K10a, the tail of _sp0_bwd_kernel:
// _sp_taps_bwd and _sp_rows_out, mp_hsir_tpu/ops/pallas_vjp.py:1401-1440).
// It replaces grad.cu's dwconv_bwd (the transposed stencil and the tap
// partials) and ln_linear_bwd (dxn and the LayerNorm backward) on that
// route; the float32 route keeps both.
//
// Without the stencil (kStencil false) the same tile is the bf16 backward of
// `LN -> 1x1` from the cotangent at the 1x1 output: the second launch of the
// bf16 window-attention backward (K8, the qkv / LayerNorm tail of
// _win_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:539), from dqkv (bf16, K =
// 3C) in place of dt. Each chunk of it is staged straight into the ring ([64]
// [72] bf16: no halo, no stencil, no tap partials); the per-tile partials are
// the chunk's column sums (the 1x1 bias cotangent), then d ln_w and d ln_b.
//
// Per 8x8 tile of the kernel frame (one 512-thread block), per 64-channel
// chunk of the K depthwise channels:
// - the chunk of dout (float32) and t (bf16) on the 10x10 halo, zero outside
//   the image, and the chunk's K rows of the 1x1 weight w ([K][C8], torch
//   layout: row = the 1x1's output channel) as one [64][CK + 8] bf16 tile,
//   all three through one 2-3 stage cp.async ring (one barrier per chunk);
// - dt = the transposed stencil in float32 (tap order and roundings as
//   dwconv3_bwd_plain: the product rounded, then added), rounded to bf16
//   into a [64][72] chunk and to device memory (the weight product's
//   operand); each thread one channel and one tile row, the 3 x 10 halo
//   values it needs read once;
// - the per-tile tap partials sum_p t[p + off] dout[p], one row per tile;
// - dxn += dt chunk x w chunk on mma.sync (B is [k][n]: ldmatrix.trans),
//   every warp 16 pixel rows x 16 columns of each 64-channel output group,
//   the sums in registers across the chunks (tail_out's layout: up to 48
//   floats a thread at C = 384).
// Epilogue in float32: x staged at the roll-back position (the kernel frame's
// pixel (r, c) is x's (r - shift, c - shift)), xhat from x itself, the LN
// backward per pixel with its row sums across the 4 column warps through
// shared memory, dx rounded once and stored in x's frame; per-tile partials
// of d ln_w and d ln_b after the tap partials. Without LN, dx = dxn. No float
// atomics: two calls give bitwise the same outputs.
//
// Rounding points as spectral_stats_bwd_plain: dt rounded to bf16 before both
// dxn and dW; dxn in float32; dx rounded once.
//
// With kExtra (the second launch of the bf16 spectral apply backward, K10b,
// at K = C: spectral_apply_bwd.cuh) the epilogue adds a float32 cotangent
// extra (B, H, W, C) in the kernel frame, staged with x, to dx before it
// rounds, after the LayerNorm backward where there is one, and the part row
// of a tile lies at part + tile ldp (the first launch writes its d dp column
// after the tap and LayerNorm partials). An instance of its own: K10a's
// dwconv_dx_tc_kernel<true, false> keeps its code as it was.
//
// With kF32T as well (the second launch of the bf16 GDFN backward, K11, at K
// = 2 hid: gdfn.cu) t is float32, as gdfn_bwd_plain keeps it between
// project_in and the depthwise conv: its halo chunk is staged as float32
// [100][68] like dout's and the tap partials read it so; vec_in gives the
// floats per copy of dout and t (4: 16-byte, 2: 8-byte cp.async, 1: element
// loads; K % 4 != 0 where hid is odd, 1021 on the main path) and vec_x (C %
// 8 == 0, x, dx and extra 16-byte aligned) the extra's 16-byte copies.
// Compiled out of the instances with bf16 t.
//
// Bound: 2 C K (dxn) + 36 K flops per pixel against ~8K + 2C bytes per pixel
// read and 2K + 2C written (K = 2C: ~22 C bytes): bytes bound it at these
// widths, the stencil and the product overlap no copy but the next chunk's.
// Without the stencil: 2 C K flops against 2K + 4C bytes (K = 3C: 6 C^2
// flops against 20 C bytes), operations-bound above C = 160.
#pragma once

#include "spectral_front.cuh"

namespace mp {

constexpr int kDxLdd = 68;  // dout (and float32 t) chunk row: 64 floats + 4 (272 B)
constexpr int kDxLdt = 72;  // t and dt chunk rows: 64 bf16 + 8 (144 B, an odd multiple of 16)
// the element type of t: float32 with kF32T, else bf16
template <bool kF32T>
using DxT = std::conditional_t<kF32T, float, __nv_bfloat16>;
// the dynamic bytes a plan may take: the H100's opt-in limit less the static
constexpr size_t kDxBudget = 232448 - 1024;

// The plan at width C (the 1x1's input) and K depthwise channels: the dt
// chunk [64][72] bf16 | S ring stages of (dout [100][68] float32, t [100][72]
// bf16, w rows [64][CK + 8] bf16), 3 where they fit the budget, else 2.
// After the last chunk the ring's space holds the epilogue: x [64][CK + 8]
// bf16, the LN mean and rstd [2][64], the row sums [4][64][2] and the column
// sums [4][2][CK] (float32), within one stage and a half at every C; with
// kExtra (K = C) the extra cotangent's rows [64][CK + 4] float32 after them,
// within two stages. Without the stencil a stage is (the cotangent chunk
// [64][72] bf16, w rows) and there is no dt chunk: 3 stages at every C up to
// 384. With float32 t (f32t) its halo chunk is [100][68] float32 like dout's.
struct DwDxPlan {
  int CK, ldw, nck, S;
  size_t dq, tt, wt, stage, da, bytes;
  __host__ __device__ DwDxPlan(int C, int K, bool stencil, bool f32t = false) {
    CK = round_up64(C);
    ldw = CK + 8;
    nck = (K + 63) / 64;
    dq = stencil ? sizeof(float) * kHaloPix * kDxLdd : 0;
    tt = stencil && f32t ? sizeof(float) * kHaloPix * kDxLdd
                         : sizeof(__nv_bfloat16) * (stencil ? kHaloPix : kPix) * kDxLdt;
    wt = sizeof(__nv_bfloat16) * 64 * ldw;
    stage = dq + tt + wt;
    da = stencil ? sizeof(__nv_bfloat16) * kPix * kDxLdt : 0;
    for (S = 3; S > 2 && da + S * stage > kDxBudget; --S) {
    }
    bytes = da + S * stage;
  }
};

// Arguments: dout (B, H, W, K) float32 and t (B, H, W, K) bf16 in the
// kernel frame; taps [K][9] and w [K][C8] bf16 (w 16-byte aligned); x (B, H,
// W, C) bf16 in its own frame; lnw float32 or NULL (no LN). vec_in: K % 8 ==
// 0 with dout and t 16-byte aligned; vec_x: C % 8 == 0 with x and dx 16-byte
// aligned (else element by element). Outputs: dt (B, H, W, K) bf16 in the
// kernel frame, dx (B, H, W, C) bf16 in x's frame, part [tiles][9 K (+ 2 C
// with LN)] float32: the tap partials [9][K], then d ln_w, d ln_b. Without
// the stencil, t is the cotangent (B, H, W, K) bf16 at the 1x1 output, dout,
// taps and dt are unused, and the part row of a tile, at part + tile ldp,
// holds the column sums [K] of t, then d ln_w, d ln_b (ldp is read only
// here, and with kExtra). extra: kExtra's cotangent (NULL: none). kF32T: t
// float32 (with the stencil and kExtra only).
template <bool kStencil, bool kExtra = false, bool kF32T = false>
__global__ void __launch_bounds__(kThreads)
dwconv_dx_tc_kernel(const float* __restrict__ dout, const DxT<kF32T>* __restrict__ t,
                    const __nv_bfloat16* __restrict__ taps, const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw, int H,
                    int W, int C, int K, int shift, float eps, int vec_in, int vec_x,
                    __nv_bfloat16* __restrict__ dt_out, __nv_bfloat16* __restrict__ dx_out,
                    float* __restrict__ part, int ldp, const float* __restrict__ extra) {
  using bf16 = __nv_bfloat16;
  using TT = DxT<kF32T>;
  extern __shared__ float4 dwdx_dyn[];
  // halo pixel -> kernel-frame pixel (-1: outside the image)
  __shared__ int hpix[kStencil ? kHaloPix : 1];
  constexpr int kRows = kStencil ? kHaloPix : kPix;  // rows of a staged t chunk
  constexpr int kLdt = kF32T ? kDxLdd : kDxLdt;      // its row
  const DwDxPlan pl(C, K, kStencil, kF32T);
  const int CK = pl.CK, ldw = pl.ldw, C8 = round_up8(C), groups = CK / 64;
  char* sm = reinterpret_cast<char*>(dwdx_dyn);
  bf16* da = reinterpret_cast<bf16*>(sm);  // [64][kDxLdt] the rounded dt chunk (stencil)
  char* ring = sm + pl.da;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int r0 = 16 * wr + (lane >> 2), r1 = r0 + 8;
  float* prow =
      part + (size_t)tile * (kStencil && !kExtra ? 9 * K + (lnw != nullptr ? 2 * C : 0) : ldp);
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  auto src = [&](int i) {  // x's pixel behind kernel-frame pixel i (the roll-back)
    const int r = ty * kTile + (i >> 3), c = tx * kTile + (i & 7);
    return ((size_t)b * H + (r - shift + H) % H) * W + (c - shift + W) % W;
  };
  auto same = [](int, int, float v) { return v; };

  if constexpr (kStencil) {
    for (int p = threadIdx.x; p < kHaloPix; p += blockDim.x) {
      const int ur = ty * kTile + p / kHalo - 1, uc = tx * kTile + p % kHalo - 1;
      hpix[p] = ur >= 0 && ur < H && uc >= 0 && uc < W ? (b * H + ur) * W + uc : -1;
    }
    __syncthreads();
  }
  // chunk j of dout, t and w into a ring stage; zero outside the image and
  // past K (and w past C8)
  auto rg = front_ring(reinterpret_cast<bf16*>(ring), pl.stage / sizeof(bf16), pl.S, pl.nck,
      [&](int j, bf16* dst) {
        float* dq = reinterpret_cast<float*>(dst);
        TT* tt = reinterpret_cast<TT*>(reinterpret_cast<char*>(dst) + pl.dq);
        bf16* wt = reinterpret_cast<bf16*>(tt + kRows * kLdt);
        const int k0 = 64 * j;
        if constexpr (!kStencil) {  // the tile's 64 pixel rows of the cotangent chunk
          if (vec_in) {
            for (int u = threadIdx.x; u < kPix * 8; u += blockDim.x) {
              const int p = u >> 3, c = (u & 7) * 8;
              const bool ok = k0 + c < K;
              cp_async16(smem_u32(tt + p * kDxLdt + c), ok ? t + pix(p) * K + k0 + c : t,
                         ok ? 16 : 0);
            }
          } else {
            for (int u = threadIdx.x; u < kPix * 64; u += blockDim.x) {
              const int p = u >> 6, c = u & 63;
              tt[p * kDxLdt + c] = k0 + c < K ? t[pix(p) * K + k0 + c] : __float2bfloat16(0.f);
            }
          }
        } else if constexpr (kF32T) {
          // float32 dout and t: vec_in floats a copy (4: 16-byte, 2: 8-byte
          // cp.async, 1: element loads), 1 << sh copies a halo row each
          const int sh = vec_in == 4 ? 4 : vec_in == 2 ? 5 : 6;
          for (int u = threadIdx.x; u < kHaloPix << sh; u += blockDim.x) {
            const int p = u >> sh, c = (u & ((1 << sh) - 1)) * vec_in, q = hpix[p];
            const bool ok = q >= 0 && k0 + c < K;
            const size_t g = ok ? (size_t)q * K + k0 + c : 0;
            float* d0 = dq + p * kDxLdd + c;
            float* d1 = tt + p * kDxLdd + c;
            if (vec_in == 4) {
              cp_async16(smem_u32(d0), dout + g, ok ? 16 : 0);
              cp_async16(smem_u32(d1), t + g, ok ? 16 : 0);
            } else if (vec_in == 2) {
              cp_async8(smem_u32(d0), dout + g, ok ? 8 : 0);
              cp_async8(smem_u32(d1), t + g, ok ? 8 : 0);
            } else {
              *d0 = ok ? dout[g] : 0.f;
              *d1 = ok ? t[g] : 0.f;
            }
          }
        } else if (vec_in) {
          for (int u = threadIdx.x; u < kHaloPix * 16; u += blockDim.x) {
            const int p = u >> 4, c = (u & 15) * 4, q = hpix[p];
            const bool ok = q >= 0 && k0 + c < K;
            cp_async16(smem_u32(dq + p * kDxLdd + c), ok ? dout + (size_t)q * K + k0 + c : dout,
                       ok ? 16 : 0);
          }
          for (int u = threadIdx.x; u < kHaloPix * 8; u += blockDim.x) {
            const int p = u >> 3, c = (u & 7) * 8, q = hpix[p];
            const bool ok = q >= 0 && k0 + c < K;
            cp_async16(smem_u32(tt + p * kDxLdt + c), ok ? t + (size_t)q * K + k0 + c : t,
                       ok ? 16 : 0);
          }
        } else {
          for (int u = threadIdx.x; u < kHaloPix * 64; u += blockDim.x) {
            const int p = u >> 6, c = u & 63, q = hpix[p];
            const bool ok = q >= 0 && k0 + c < K;
            dq[p * kDxLdd + c] = ok ? dout[(size_t)q * K + k0 + c] : 0.f;
            tt[p * kDxLdt + c] = ok ? t[(size_t)q * K + k0 + c] : __float2bfloat16(0.f);
          }
        }
        for (int u = threadIdx.x; u < 64 * (CK / 8); u += blockDim.x) {
          const int r = u / (CK / 8), c = (u - r * (CK / 8)) * 8;
          const bool ok = k0 + r < K && c < C8;
          cp_async16(smem_u32(wt + r * ldw + c), ok ? w + (size_t)(k0 + r) * C8 + c : w,
                     ok ? 16 : 0);
        }
      });
  rg.prefetch();

  float acc[2 * kTailGroups][4];  // dxn, tail_out's layout
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  // the stencil's channel and tile row; A (the dt chunk) and B (the w rows,
  // [k][n] read transposed: lane gives k row lane % 8 + 8 (lane / 8 % 2) at
  // n column 16 wc + 8 (lane / 16)) addresses
  const int sj = threadIdx.x & 63, spr = threadIdx.x >> 6;
  const uint32_t adt = smem_u32(da + (16 * wr + (lane & 15)) * kDxLdt + 8 * (lane >> 4));
  const int toff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldw + 16 * wc + 8 * (lane >> 4);
  for (int ch = 0; ch < pl.nck; ++ch) {
    const bf16* st = rg.consume();
    const float* dq = reinterpret_cast<const float*>(st);
    const TT* tt = reinterpret_cast<const TT*>(reinterpret_cast<const char*>(st) + pl.dq);
    const bf16* wt = reinterpret_cast<const bf16*>(tt + kRows * kLdt);
    const int k0 = 64 * ch;
    if constexpr (!kStencil) {
      // the chunk's column sums over the tile's pixels, in pixel order
      if (threadIdx.x < 64 && k0 + threadIdx.x < K) {
        float s = 0.f;
        for (int p = 0; p < kPix; ++p) s += __bfloat162float(tt[p * kDxLdt + threadIdx.x]);
        prow[k0 + threadIdx.x] = s;
      }
    } else {
      // dt(pr, pc) = sum over (ty, tx) in order of dout(pr + ty - 1, pc + tx
      // - 1) w[2 - ty][2 - tx]: halo row pr + a, column pc + tx
      const int k = k0 + sj;
      float wv[9], o[kTile];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wv[tap] = k < K ? __bfloat162float(taps[(size_t)k * 9 + tap]) : 0.f;
#pragma unroll
      for (int pc = 0; pc < kTile; ++pc) o[pc] = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int hc = 0; hc < kHalo; ++hc) {
          const float v = dq[((spr + a) * kHalo + hc) * kDxLdd + sj];
#pragma unroll
          for (int tx_ = 0; tx_ < 3; ++tx_) {
            const int pc = hc - tx_;
            if (pc >= 0 && pc < kTile)
              o[pc] = __fadd_rn(o[pc], __fmul_rn(v, wv[(2 - a) * 3 + 2 - tx_]));
          }
        }
#pragma unroll
      for (int pc = 0; pc < kTile; ++pc) {
        const bf16 v = __float2bfloat16(o[pc]);
        da[(spr * kTile + pc) * kDxLdt + sj] = v;
        if (k < K) dt_out[pix(spr * kTile + pc) * K + k] = v;
      }
      // the tap partials: sum over the tile's pixels of t[p + off(tap)] dout[p]
      for (int idx = threadIdx.x; idx < 9 * 64; idx += blockDim.x) {
        const int tap = idx >> 6, j = idx & 63, dy = tap / 3, dx = tap - 3 * dy;
        if (k0 + j >= K) continue;
        float s = 0.f;
#pragma unroll 8
        for (int p = 0; p < kPix; ++p) {
          const int pr = p >> 3, pc = p & 7;
          s = fmaf(to_f(tt[((pr + dy) * kHalo + pc + dx) * kLdt + j]),
                   dq[((pr + 1) * kHalo + pc + 1) * kDxLdd + j], s);
        }
        prow[tap * K + k0 + j] = s;
      }
    }
    if constexpr (kStencil) __syncthreads();  // the dt chunk is complete
    const uint32_t aa =
        kStencil ? adt : smem_u32(tt + (16 * wr + (lane & 15)) * kDxLdt + 8 * (lane >> 4));
    const uint32_t bt = smem_u32(wt) + 2 * toff;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, aa + 32 * kk);
#pragma unroll
      for (int G = 0; G < kTailGroups; ++G) {
        if (G < groups) {  // block-uniform
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, bt + 2 * (16 * kk * ldw + 64 * G));
          mma_16x8x16(acc[2 * G], af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(acc[2 * G + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
    }
  }

  __syncthreads();  // every warp is past its last product: the ring's space is free
  bf16* xs = reinterpret_cast<bf16*>(ring);                 // [64][ldw] x, then dx
  float* stt = reinterpret_cast<float*>(xs + kPix * ldw);   // LN mean | rstd
  float* rowred = stt + 2 * kPix;                           // [4 wc][64][2] row sums
  float* colred = rowred + 4 * kPix * 2;                    // [4 wr][2][CK] column sums
  stage_rows(xs, ldw, x, C, CK, vec_x, src);
  float* es = colred + 4 * 2 * CK;  // kExtra: [64][CK + 4] the extra cotangent's rows
  const int lde = CK + 4;
  if constexpr (kExtra) {
    if ((kF32T ? vec_x : vec_in) && extra != nullptr) {  // C % 8 == 0, 16-byte aligned rows
      for (int u = threadIdx.x; u < kPix * (C / 4); u += blockDim.x) {
        const int i = u / (C / 4), c = (u - i * (C / 4)) * 4;
        cp_async16(smem_u32(es + i * lde + c), extra + pix(i) * C + c, 16);
      }
    } else {  // element by element; zero without an extra cotangent
      for (int u = threadIdx.x; u < kPix * C; u += blockDim.x) {
        const int i = u / C, c = u - i * C;
        es[i * lde + c] = extra != nullptr ? extra[pix(i) * C + c] : 0.f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (lnw != nullptr) {
    // each row's mean and rstd from x itself, as tail_ln computes them
    for (int i = warp; i < kPix; i += kThreads / 32) {
      float s = 0.f;
      for (int k = lane; k < C; k += 32) s += __bfloat162float(xs[i * ldw + k]);
      const float mu = warp_sum(s) / C;
      float v = 0.f;
      for (int k = lane; k < C; k += 32) {
        const float d = __bfloat162float(xs[i * ldw + k]) - mu;
        v += d * d;
      }
      const float rs = rsqrtf(warp_sum(v) / C + eps);
      if (lane == 0) {
        stt[i] = mu;
        stt[kPix + i] = rs;
      }
    }
    __syncthreads();
    const float* mu = stt;
    const float* rs = stt + kPix;
    // per row m1 = sum g, m2 = sum g xhat with g = dxn ln_w; per channel
    // sum dxn xhat and sum dxn (d ln_w, d ln_b)
    float m[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int q = 0; q < 2 * kTailGroups; ++q) {
      if ((q >> 1) >= groups) break;  // block-uniform
      const int col = 64 * (q >> 1) + 16 * wc + 8 * (q & 1) + 2 * t4;
      float cw[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r1, k = col + (e & 1);
        if (k < C) {
          const float xh = (__bfloat162float(xs[i * ldw + k]) - mu[i]) * rs[i], d = acc[q][e];
          const float g = d * lnw[k];
          m[e >> 1][0] += g;
          m[e >> 1][1] = fmaf(g, xh, m[e >> 1][1]);
          cw[e & 1] = fmaf(d, xh, cw[e & 1]);
          cb[e & 1] += d;
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cw[e] += __shfl_xor_sync(0xffffffffu, cw[e], o);
          cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], o);
        }
      if (lane < 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          colred[(wr * 2) * CK + col + e] = cw[e];
          colred[(wr * 2 + 1) * CK + col + e] = cb[e];
        }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        m[q >> 1][q & 1] += __shfl_xor_sync(0xffffffffu, m[q >> 1][q & 1], o);
    if (t4 == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rowred[(wc * kPix + (q < 2 ? r0 : r1)) * 2 + (q & 1)] = m[q >> 1][q & 1];
    __syncthreads();
    float m1[2], m2[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = rr ? r1 : r0;
      float s1 = 0.f, s2 = 0.f;
      for (int w4 = 0; w4 < 4; ++w4) {
        s1 += rowred[(w4 * kPix + i) * 2];
        s2 += rowred[(w4 * kPix + i) * 2 + 1];
      }
      m1[rr] = s1 / C;
      m2[rr] = s2 / C;
    }
    // dx = (g - m1 - xhat m2) rstd, rounded once, into x's place (each
    // element read and written by its own thread only)
#pragma unroll
    for (int q = 0; q < 2 * kTailGroups; ++q) {
      if ((q >> 1) >= groups) break;
      const int col = 64 * (q >> 1) + 16 * wc + 8 * (q & 1) + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r1, k = col + (e & 1);
        if (k < C) {
          const float xh = (__bfloat162float(xs[i * ldw + k]) - mu[i]) * rs[i];
          if constexpr (kExtra) {
            xs[i * ldw + k] = __float2bfloat16(
                (acc[q][e] * lnw[k] - m1[e >> 1] - xh * m2[e >> 1]) * rs[i] + es[i * lde + k]);
          } else {
            xs[i * ldw + k] =
                __float2bfloat16((acc[q][e] * lnw[k] - m1[e >> 1] - xh * m2[e >> 1]) * rs[i]);
          }
        }
      }
    }
    for (int k = threadIdx.x; k < C; k += blockDim.x) {
      float sw = 0.f, sb = 0.f;
      for (int w4 = 0; w4 < 4; ++w4) {
        sw += colred[(w4 * 2) * CK + k];
        sb += colred[(w4 * 2 + 1) * CK + k];
      }
      // d ln_w, d ln_b after the tap or column sums
      prow[(kStencil ? 9 * K : K) + k] = sw;
      prow[(kStencil ? 9 * K : K) + C + k] = sb;
    }
  } else if constexpr (kExtra) {
    tail_out(acc, C, [&](int i, int k, float v) {
      xs[i * ldw + k] = __float2bfloat16(v + es[i * lde + k]);
    });
  } else {
    tail_out(acc, C, [&](int i, int k, float v) { xs[i * ldw + k] = __float2bfloat16(v); });
  }
  __syncthreads();
  tail_store(xs, ldw, C, vec_x, [&](int i) { return dx_out + src(i) * C; }, same);
}

}  // namespace mp
