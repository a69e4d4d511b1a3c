// The bf16 spectral apply backward's first tile (K10b, _sp1_bwd_kernel,
// mp_hsir_tpu/ops/pallas_vjp.py:1501, host _sp1_bwd_call :1758), on the
// tensor cores: the VJP of the apply without the MLP tail up to the
// cotangent dv at the depthwise output. The second launch is
// dwconv_dx_tc_kernel<true, true> (dwconv_dx.cuh) at K = C: the transposed
// stencil, dx through the v rows of the 1x1 and the LayerNorm, plus this
// tile's extra input cotangent, at the roll-back. The float32 route keeps
// spectral_apply_bwd_kernel (spectral.cu) and grad.cu's stages.
//
// Per 8x8 tile of the unrolled frame (one 512-thread block):
// - v recomputed with the front tile's pieces (spectral_front.cuh): the halo
//   staged once as bf16 with LN in place, the v rows of the 1x1 streamed
//   through the weight ring in passes, each pass rounded to bf16 (t, written
//   out for the weight product and tile 2), the depthwise 3x3 on bf16 pairs
//   into v [64][CP + 8] (written out for the dcomb product); un, the (LN'd)
//   input of the tile's pixels, written out for the dWv product;
// - dys = rnd(dy dp) staged as bf16 [64][CP + 8] over the dead halo (written
//   out with dp; without it dys is dy), and the extra input cotangent dys g +
//   dy (gate / residual) in float32;
// - comb (bf16 [B][C][C8], row = v channel) streamed as [64 k][CP] tiles
//   through a 2-3 stage ring behind dys; each staged tile serves two products:
//   read plain (B = the tile's rows as [n][k]) for the 64-column slab dv[:,
//   k0:k0 + 64] = dys comb[k0:k0 + 64, :]^T over the full depth CP, every warp
//   one 16 x 16 block, stored float32 straight from the accumulators; read
//   .trans (B = [k][n], as the forward's comb product) for br += v[:, k0:k0 +
//   64] comb[k0:k0 + 64, :], summed in registers across the tiles (with dp
//   only);
// - with dp: the tile's partial of d dp = sum dy (br + x g), block-summed in
//   a fixed order, into one column of this tile's part row (the wrapper sums
//   the rows per image in tile order, then the images in order).
// No float atomics: two calls give bitwise the same outputs.
// A member's head block under the spectral mesh axis (K10b's CL < C): v, t,
// dv and the taps CL wide, comb (B, CL, C) streamed as CL / 64 tiles of
// [64][CP] (dv = dys comb^T CL wide over C; br CL deep); dys, the extra
// cotangent, un and the epilogue C wide (ApplyBwdPlan(C, CL)); the second
// tile runs at K = CL.
//
// Rounding points as spectral_apply_bwd_plain: t and v rounded to bf16, comb
// rounded once (the wrapper's bf16 copy), dys rounded before both dv and
// dcomb, dv and br in float32.
//
// Shared memory: during the front as the forward's plan, v | taps | halo |
// ring; after it, v | dys | comb stages over the dead taps, halo and ring
// (ApplyBwdPlan). At C = 384 the front takes 200,192 B and the comb phase
// with two stages 200,704 B; three stages would not fit.
//
// Bound: 2.2 C^2 (the halo 1x1) + 18 C + 2 C^2 (dv) + 2 C^2 (br, with dp)
// flops per pixel against ~2C bytes read and 12C + 4C (extra) written:
// bytes bound it at these widths.
#pragma once

#include "spectral_front.cuh"

namespace mp {

// the dynamic bytes a plan may take: the H100's opt-in limit less the static
constexpr size_t kApplyBwdBudget = 232448 - 1024;

// The plan at input width C and v width CL (C, or a member's head block):
// the forward front's tiling (FrontPlan: CP, CPL, ld, ldv, NP, nk, nkc, ws);
// front = v [64][ldv] | taps | halo | ring (the weight tiles, then a pass's
// 1x1 output [100][NP + 8]); after the front, dys ([64][ld], C wide) takes
// the taps' and the halo's place and the comb ring (cs stages of [64][ld], 3
// where they fit at CL = C) follows it.
struct ApplyBwdPlan {
  int C, CL, CP, CPL, ld, ldv, NP, nk, nkc, ws, cs;
  size_t v, ds, taps, halo, ring, front, cstage, post, bytes;
  __host__ __device__ ApplyBwdPlan(int c, int cl) : C(c), CL(cl) {
    const FrontPlan f(c, cl);
    CP = f.CP;
    CPL = f.CPL;
    ld = f.ld;
    ldv = f.ldv;
    NP = f.NP;
    nk = f.nk;
    nkc = f.nkc;
    ws = f.ws;
    const size_t b = sizeof(__nv_bfloat16);
    v = f.v;
    ds = b * kPix * ld;
    taps = f.taps;
    halo = f.halo;
    const size_t wring = ws * b * NP * kFrontLdw, t = b * kHaloPix * (NP + 8);
    ring = wring > t ? wring : t;
    front = v + taps + halo + ring;
    cstage = f.cstage;
    // three comb stages where they fit beside the whole attention's v and
    // dys (a head block's plan never outgrows the whole attention's)
    cs = 2 * ds + 3 * cstage <= kApplyBwdBudget ? 3 : 2;
    post = v + ds + cs * cstage;
    bytes = front > post ? front : post;
  }
};

// Arguments: x (B, H, W, C) bf16 (the raw input, read through the roll-back);
// lnw / lnb float32 or NULL; wv [CL][C8], taps [CL][9] and comb [B][CL][C8]
// bf16 (pack_front's operands; wv and comb 16-byte aligned; CL the v width:
// C, or a member's head block); gate (B, H/8, W/8, C) bf16 or NULL (gwin 8;
// gwin 1: a per-pixel map (B, H, W, C), gate_row); dp (B,) float32 or NULL;
// dy (B, H, W, C) bf16 unrolled frame. flags: kVecX (x 16-byte rows), kPairs
// (bf16 pairs and float pairs), kVecOut (16-byte output rows). Outputs,
// unrolled frame: un (B, H, W, C), t, v (B, H, W, CL) bf16; dys (with dp);
// dv (B, H, W, CL) float32; extra (B, H, W, C) float32 or NULL (neither gate
// nor residual); pdp: the d dp column of the part rows (row stride ldp),
// NULL without dp. A row shard (shift 0): hal [2][B][W][C] bf16 and halo as
// the forward tile's (kVecX: hal 16-byte aligned too); the first and last
// tile rows then also write their real halo rows' LN'd input un_halo
// ([2][B][W][C]) and v 1x1 output t_halo ([2][B][W][CL], bf16), which the
// halo rows' cotangents and weight-gradient share read.
__global__ void __launch_bounds__(kThreads)
spectral_apply_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
                             const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ wv,
                             const __nv_bfloat16* __restrict__ taps,
                             const __nv_bfloat16* __restrict__ comb,
                             const __nv_bfloat16* __restrict__ gate, const float* __restrict__ dp,
                             int residual, const __nv_bfloat16* __restrict__ dy, int H, int W,
                             int C, int shift, float eps, int flags,
                             __nv_bfloat16* __restrict__ un_out, __nv_bfloat16* __restrict__ t_out,
                             __nv_bfloat16* __restrict__ v_out, __nv_bfloat16* __restrict__ dys_out,
                             float* __restrict__ dv_out, float* __restrict__ extra_out,
                             float* __restrict__ pdp, int ldp,
                             const __nv_bfloat16* __restrict__ hal, int halo,
                             __nv_bfloat16* __restrict__ un_halo,
                             __nv_bfloat16* __restrict__ t_halo, int gwin, int CL) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 apply_bwd_dyn[];
  __shared__ int hsrc[kFrontRows];         // halo row -> source pixel (-1: zero row; halo_src)
  __shared__ int esrc[kPix], egate[kPix];  // tile pixel -> raw source pixel, gate row
  __shared__ float red[kThreads / 32];
  const ApplyBwdPlan pl(C, CL);
  const int ld = pl.ld, ldv = pl.ldv, CP = pl.CP, CPL = pl.CPL, C8 = round_up8(C);
  char* sm = reinterpret_cast<char*>(apply_bwd_dyn);
  bf16* vs = reinterpret_cast<bf16*>(sm);                                   // [64][ldv] v
  __nv_bfloat162* tp = reinterpret_cast<__nv_bfloat162*>(sm + pl.v);        // [9][CPL / 2] taps
  bf16* xh = reinterpret_cast<bf16*>(sm + pl.v + pl.taps);                  // [112][ld] halo
  bf16* rg = xh + kFrontRows * ld;                                          // ring / 1x1 output
  bf16* ds = reinterpret_cast<bf16*>(sm + pl.v);                            // [64][ld] dys (after)
  bf16* cring = reinterpret_cast<bf16*>(sm + pl.v + pl.ds);                 // comb stages (after)
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tile = (b * (H / kTile) + ty) * (W / kTile) + tx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec_x = flags & kVecX, pairs = flags & kPairs, vec_out = flags & kVecOut;
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };  // halo row of pixel i

  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x) {
    hsrc[p] = halo_src(p, b, ty, tx, gridDim.z, H, W, shift, halo);
    if (p < kPix) {
      const int sr = (ty * kTile + (p >> 3) - shift + H) % H;
      const int sc = (tx * kTile + (p & 7) - shift + W) % W;
      esrc[p] = (b * H + sr) * W + sc;
      egate[p] = gate_row(b, sr, sc, H, W, gwin);
    }
  }
  for (int i = threadIdx.x; i < 9 * (CPL / 2); i += blockDim.x) {
    const int tap = i / (CPL / 2), c = 2 * (i - tap * (CPL / 2));
    const bf16 z = __float2bfloat16(0.f);
    tp[i] = __halves2bfloat162(c < CL ? taps[c * 9 + tap] : z,
                               c + 1 < CL ? taps[(c + 1) * 9 + tap] : z);
  }
  __syncthreads();
  stage_halo(xh, ld, hsrc, x, nullptr, C, 0, CP, vec_x, hal);

  // v: the forward front's passes; t and un on the way
  float acc[kFrontUnits][4][4];
  const int ldt = pl.NP + 8;
  for (int n0 = 0; n0 < CPL; n0 += pl.NP) {
    const int np = min(pl.NP, CPL - n0), n_units = 7 * (np / 32);
    auto wr = front_ring(rg, (size_t)pl.NP * kFrontLdw, pl.ws, pl.nk,
        [=](int t, bf16* dst) {
          stage_tile(dst, kFrontLdw, wv + (size_t)n0 * C8 + 64 * t, C8, np, 64, CL - n0, C8 - 64 * t);
        });
    wr.prefetch();
    if (n0 == 0) {
      // the halo landed; LayerNorm in place; un from the tile's rows
      cp_async_wait_upto(pl.ws - 1);
      __syncthreads();
      if (lnw != nullptr) {
        halo_ln(xh, ld, hsrc, C, lnw, lnb, eps);
        __syncthreads();
      }
      if (vec_out) {
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
      for (int side = 0; side < 2; ++side)
        if (shard_row(side, ty, H, halo))
          halo_row_out(un_halo, xh, ld, C, side, b, tx, W, C, [](int j) { return j; });
    }
    halo_1x1(acc, xh, ld, wr, n_units, CP, pl.nk);
    cp_async_wait<0>();
    __syncthreads();
    front_out(acc, n_units, 7, [&](int r, int c, float v0, float v1) {
      if (r < kHaloPix) *reinterpret_cast<uint32_t*>(rg + r * ldt + c) = pack_bf16x2(v0, v1);
    });
    __syncthreads();
    // t at the tile's pixels, channels [n0, n0 + np) below CL
    const int nt = min(np, CL - n0);
    if (vec_out) {
      for (int u = threadIdx.x; u < kPix * (nt / 8); u += blockDim.x) {
        const int i = u / (nt / 8), c = (u - i * (nt / 8)) * 8;
        *reinterpret_cast<uint4*>(t_out + pix(i) * CL + n0 + c) =
            *reinterpret_cast<const uint4*>(rg + hp(i) * ldt + c);
      }
    } else {
      for (int u = threadIdx.x; u < kPix * nt; u += blockDim.x) {
        const int i = u / nt, c = u - i * nt;
        t_out[pix(i) * CL + n0 + c] = rg[hp(i) * ldt + c];
      }
    }
    for (int side = 0; side < 2; ++side)
      if (shard_row(side, ty, H, halo))
        halo_row_out(t_halo, rg, ldt, nt, side, b, tx, W, CL, [&](int j) { return n0 + j; });
    dw3_pairs(rg, ldt, tp + n0 / 2, CPL / 2, vs + n0, ldv, np / 2);
    __syncthreads();
  }
  auto same = [](int, int, float v) { return v; };
  tail_store(vs, ldv, CL, vec_out, [&](int i) { return v_out + pix(i) * CL; }, same);

  // the comb ring behind dys (the halo and the weight ring are dead): comb's
  // [64 v rows][CP] tiles, CL rows in all
  const bf16* cb = comb + (size_t)b * CL * C8;
  auto cr = front_ring(cring, pl.cstage / sizeof(bf16), pl.cs, pl.nkc,
      [=](int t, bf16* dst) {
        stage_tile(dst, ld, cb + (size_t)64 * t * C8, C8, 64, CP, CL - 64 * t, C8);
      });
  cr.prefetch();
  // dys = rnd(dy dp) (zero past C) and the extra cotangent dys g + dy
  const float dpb = dp != nullptr ? dp[b] : 1.f;
  for (int u = threadIdx.x; u < kPix * (CP / 2); u += blockDim.x) {
    const int i = u / (CP / 2), c = 2 * (u - i * (CP / 2));
    float2 d = make_float2(0.f, 0.f);
    if (c < C) {
      const size_t o = pix(i) * C + c;
      const float2 d0 = load_pair(dy, nullptr, C, 0, pix(i), c, pairs);
      d = d0;
      if (dp != nullptr) {
        d = make_float2(rnd<bf16>(d0.x * dpb), rnd<bf16>(d0.y * dpb));
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dys_out + o) = pack_bf16x2(d.x, d.y);
        } else {
          dys_out[o] = __float2bfloat16(d.x);
          if (c + 1 < C) dys_out[o + 1] = __float2bfloat16(d.y);
        }
      }
      if (extra_out != nullptr) {
        const float2 g = gate != nullptr ? load_pair(gate, nullptr, C, 0, egate[i], c, pairs)
                                         : make_float2(0.f, 0.f);
        const float e0 = (gate != nullptr ? d.x * g.x : 0.f) + (residual ? d0.x : 0.f);
        const float e1 = (gate != nullptr ? d.y * g.y : 0.f) + (residual ? d0.y : 0.f);
        if (pairs) {
          *reinterpret_cast<float2*>(extra_out + o) = make_float2(e0, e1);
        } else {
          extra_out[o] = e0;
          if (c + 1 < C) extra_out[o + 1] = e1;
        }
      }
    }
    *reinterpret_cast<uint32_t*>(ds + i * ld + c) = pack_bf16x2(d.x, d.y);
  }

  // per comb tile t: dv[:, 64 t ..] (v channels) from the tile read plain;
  // br from it read .trans (with dp)
  const int n_units = 4 * (CP / 32);
  uint32_t a[kFrontUnits], bo[kFrontUnits];
#pragma unroll
  for (int j = 0; j < kFrontUnits; ++j) {
    const int q = warp + 16 * j, mt = q & 3, nb = q >> 2;
    a[j] = smem_u32(vs + (16 * mt + (lane & 15)) * ldv + 8 * (lane >> 4));
    bo[j] = 2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 32 * nb + 8 * (lane >> 4));
  }
  // dv: this warp's 16 x 16 block (row tile dmt, column block dnb) of a slab
  const int dmt = warp & 3, dnb = warp >> 2;
  const uint32_t da = smem_u32(ds + (16 * dmt + (lane & 15)) * ld + 8 * (lane >> 4));
  const uint32_t dbo = 2 * ((16 * dnb + (lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1));
  front_zero(acc);
  for (int t = 0; t < pl.nkc; ++t) {
    const uint32_t st = smem_u32(cr.consume());
    const int k0 = 64 * t;
    if (16 * dnb < CL - k0) {  // warp-uniform: the block has columns below CL
      float dacc[2][4] = {};
      for (int kk = 0; kk < CP / 16; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, da + 32 * kk);
        ldmatrix_x4(bf, st + dbo + 32 * kk);
        mma_16x8x16(dacc[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_16x8x16(dacc[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = 16 * dmt + (lane >> 2) + 8 * rr;
          const int k = k0 + 16 * dnb + 8 * n8 + 2 * (lane & 3);
          float* o = dv_out + pix(r) * CL + k;
          if (pairs && k < CL) {
            *reinterpret_cast<float2*>(o) = make_float2(dacc[n8][2 * rr], dacc[n8][2 * rr + 1]);
          } else {
            if (k < CL) o[0] = dacc[n8][2 * rr];
            if (k + 1 < CL) o[1] = dacc[n8][2 * rr + 1];
          }
        }
    }
    if (dp != nullptr) {  // block-uniform
      uint32_t at[kFrontUnits], bt[kFrontUnits];
#pragma unroll
      for (int j = 0; j < kFrontUnits; ++j) {
        at[j] = a[j] + 2 * k0;
        bt[j] = st + bo[j];
      }
      front_mma<true>(acc, at, bt, n_units, min(4, (CPL - k0) / 16), ld);
    }
  }
  cp_async_wait<0>();
  if (dp == nullptr) return;
  // the tile's d dp partial: sum over its pixels and channels of dy (br + x g)
  float part = 0.f;
  front_out(acc, n_units, 4, [&](int i, int c, float v0, float v1) {
    if (c >= C) return;
    const float2 d0 = load_pair(dy, nullptr, C, 0, pix(i), c, pairs);
    float2 ug = make_float2(0.f, 0.f);
    if (gate != nullptr) {
      const float2 u = load_pair(x, nullptr, C, 0, esrc[i], c, pairs);
      const float2 g = load_pair(gate, nullptr, C, 0, egate[i], c, pairs);
      ug = make_float2(u.x * g.x, u.y * g.y);
    }
    part = fmaf(d0.x, v0 + ug.x, part);
    part = fmaf(d0.y, v1 + ug.y, part);
  });
  part = block_sum(part, red);
  if (threadIdx.x == 0) pdp[(size_t)tile * ldp] = part;
}

}  // namespace mp
