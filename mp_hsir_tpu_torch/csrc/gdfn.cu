// LayerNorm + gated depthwise-conv feed-forward network (Restormer GDFN) over
// an NHWC map: LN -> 1x1 (C -> 2*hidden) -> 3x3 depthwise -> gelu(x1) * x2 ->
// 1x1 (hidden -> C) [+ x] [-> trailing 1x1 (C -> Co), PromptFusion's exit conv].
//
// Replaces _gdfn_kernel (mp_hsir_tpu/ops/pallas_attention.py:1274, K5). As
// there, the halo rows are zeroed after the LayerNorm (LN(0) = bias != 0), the
// 1x1 output and the depthwise taps stay float32, and the gated product is
// rounded to the compute type before project_out. GELU is the exact erf form
// (the TPU kernel's polynomial is a Mosaic workaround, 1.5e-6 from it).
//
// Bound on this card: 6*C*hidden + 2*C*Co flops per pixel (plus the halo
// recompute) against (C + Co) elements of traffic: tensor-core rate bounds
// it. Two kernels:
//
// - bf16: gdfn_tc_kernel below, one 8x8 tile per 512-thread block on the
//   tensor cores (cp.async, ldmatrix, mma.sync), built from the halo tiles'
//   pieces (spectral_front.cuh) and the tail tile's fc2 (mlp_tail.cuh):
//   * the 10x10 halo staged once as bf16 [112][CP + 8] (100 rows padded to 7
//     row tiles; CP = C rounded up to 32), the LayerNorm in place; rows
//     outside the image stay zero after it;
//   * the hidden width in chunks of 64 units: project_in is a 112 x 128 x CP
//     product (the chunk's 64 x1 rows and its 64 x2 rows of w_in, read from
//     the torch layout [2 hid][C8], zero past hid), each warp holding up to 2
//     units of 16 x 32 sums; t goes to shared memory in float32
//     ([100][136]: float2 stores without bank conflicts), the depthwise 3x3
//     runs in float32 on float32 taps (the chunk's rows of w_dw, staged as
//     float32 from bf16), 4 output rows a thread, then gelu(x1) * x2 is
//     rounded to bf16 into the gated tile ([64][72]);
//   * project_out: gated [64 x 64] x the chunk's columns of w_out (torch
//     layout [C][hid8], the [n][k] operand) as the tail tile's fc2, the
//     64 x C sums in registers across the whole hidden loop (C up to 384);
//   * every weight tile ([128][64] bf16: project_in, project_out, then the
//     exit 1x1's) through one cp.async ring of 2-4 stages, one block-wide
//     barrier per tile;
//   * epilogue: + x (float32), one rounding to bf16 into the halo's space,
//     then stored in 16-byte runs, or used as the A operand of the exit 1x1
//     against proj_w's torch layout [Co][C8] (the output staged in t's
//     space, then stored).
// - float32: gdfn_f32_kernel, the bf16 tile's design in 3xTF32 on m16n8k8
//   with no rounding points, built from the float32 halo tiles' pieces
//   (spectral_front_f32.cuh) and the float32 tail's fc2 (mlp_tail.cuh); the
//   design is above the kernel.
//
// The backward (K11) likewise: bf16 runs gdfn_bwd_tc_kernel, built from the
// forward tile's pieces, then dwconv_dx.cuh's tile with float32 t (the
// design is above gdfn_bwd_tc_kernel); float32 runs gdfn_bwd_kernel and
// grad.cu's stages.
#include "dwconv_dx.cuh"  // and spectral_front.cuh
#include "spectral_front_f32.cuh"

namespace mp {

constexpr int kGC = 32;  // hidden chunk of the float32 backward

// ---------------------------------------------------------------------------
// The bf16 tile (the design is at the top of this file).
// ---------------------------------------------------------------------------

constexpr int kGdfnK = kTailK;            // hidden chunk: 64 x1 units and their 64 x2 units
constexpr int kGdfnLdt = 2 * kGdfnK + 8;  // t row in floats (544 B: float2 stores conflict-free)
constexpr int kGdfnUnits = 2;             // project_in: 7 x 4 units of 16 x 32 over 16 warps
constexpr int kGdfnInUnits = 7 * (2 * kGdfnK / 32);
// the dynamic bytes a plan may take: the H100's opt-in limit less the static
constexpr size_t kGdfnBudget = 232448 - 1024;

// The bf16 tile's plan at width C, hidden width hid and exit width Co (0: no
// exit 1x1): taps [9][128] float32 | gated [64][kTailLdg] | t [100][kGdfnLdt]
// float32 | halo [112][ld] | ring (ws stages of [kTailN][kTailLd]), every
// piece a multiple of 16 bytes; the ring holds as many stages (at most 4) as
// the budget allows. The weight stream: per hidden chunk nk project_in tiles
// (64 deep) and nk2 project_out tiles (128 output channels), then npb x nk
// tiles of the exit 1x1 (128 output channels, 64 deep).
struct GdfnPlan {
  int CP, ld, nk, nch, nk2, npb, ws;
  size_t taps, gated, t, bytes;
  __host__ __device__ GdfnPlan(int C, int hid, int Co) {
    CP = round_up32(C);
    ld = CP + 8;
    nk = (CP + kGdfnK - 1) / kGdfnK;
    nch = (hid + kGdfnK - 1) / kGdfnK;
    nk2 = (round_up64(C) + kTailN - 1) / kTailN;
    npb = (Co + kTailN - 1) / kTailN;
    taps = sizeof(float) * 9 * 2 * kGdfnK;
    gated = sizeof(__nv_bfloat16) * kPix * kTailLdg;
    t = sizeof(float) * kHaloPix * kGdfnLdt;
    const size_t fixed = taps + gated + t + sizeof(__nv_bfloat16) * kFrontRows * ld;
    for (ws = kTailStages; ws > 2 && fixed + ws * kTailStage > kGdfnBudget; --ws) {
    }
    bytes = fixed + ws * kTailStage;
  }
  __host__ __device__ int tiles() const { return nch * (nk + nk2) + npb * nk; }
};

// Tile t < nch (nk + nk2) of the weight stream of the bf16 tiles (per hidden
// chunk of kGdfnK units: nk project_in tiles, then nk2 project_out tiles), as
// [kTailN][kTailLd]: project_in's the chunk's x1 rows j0.. of win, then its
// x2 rows hid + j0.., at depth k0..; project_out's output channels n0.. of
// wout at the chunk's hidden units; zero past hid and C.
__device__ __forceinline__ void stage_gdfn_tile(__nv_bfloat16* dst, int t, int per, int nk,
                                                const __nv_bfloat16* __restrict__ win,
                                                const __nv_bfloat16* __restrict__ wout, int C,
                                                int hid) {
  const int C8 = round_up8(C), hid8 = round_up8(hid), CK = round_up64(C);
  const int j0 = t / per * kGdfnK, pos = t % per;
  if (pos < nk) {
    const int k0 = kGdfnK * pos;
    stage_tile(dst, kTailLd, win + (size_t)j0 * C8 + k0, C8, kGdfnK, kGdfnK, hid - j0, C8 - k0);
    stage_tile(dst + kGdfnK * kTailLd, kTailLd, win + (size_t)(hid + j0) * C8 + k0, C8, kGdfnK,
               kGdfnK, hid - j0, C8 - k0);
  } else {
    const int n0 = kTailN * (pos - nk);
    stage_tile(dst, kTailLd, wout + (size_t)n0 * hid8 + j0, hid8, min(kTailN, CK - n0), kGdfnK,
               C - n0, hid8 - j0);
  }
}

// Arguments: x (B, H, W, C) bf16, LN float32; win [2 hid][C8], taps [2 hid][9],
// wout [C][hid8], wproj [Co][C8] or NULL: the torch layouts in bf16, rows
// padded to C8 / hid8 (rounded up to 8), 16-byte aligned; flags: kVecX |
// kVecOut. Output (B, H, W, Co), Co = C without wproj.
__global__ void __launch_bounds__(kThreads)
gdfn_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
               const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ win,
               const __nv_bfloat16* __restrict__ taps, const __nv_bfloat16* __restrict__ wout,
               const __nv_bfloat16* __restrict__ wproj, int Co, int residual,
               __nv_bfloat16* __restrict__ out, int H, int W, int C, int hid, float eps,
               int flags) {
  extern __shared__ float4 gdfn_dyn[];
  __shared__ int hsrc[kFrontRows];  // halo row -> source pixel (-1: zero row)
  const GdfnPlan pl(C, hid, wproj != nullptr ? Co : 0);
  const int ld = pl.ld, CP = pl.CP, nk = pl.nk, nk2 = pl.nk2;
  const int C8 = round_up8(C), CK = round_up64(C);
  char* sm = reinterpret_cast<char*>(gdfn_dyn);
  float* tp = reinterpret_cast<float*>(sm);                            // [9][128] the chunk's taps
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(sm + pl.taps);  // [64][kTailLdg] gated
  float* ts = reinterpret_cast<float*>(sm + pl.taps + pl.gated);       // [100][kGdfnLdt] t
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(sm + pl.taps + pl.gated + pl.t);  // halo
  __nv_bfloat16* rg = xh + kFrontRows * ld;                            // the ring
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x)
    hsrc[p] = halo_src(p, b, ty, tx, H, W, 0);
  __syncthreads();
  stage_halo(xh, ld, hsrc, x, nullptr, C, 0, CP, flags & kVecX);

  // tile t of the weight stream, zero past hid, C and Co
  const int per = nk + nk2, n_in = pl.nch * per;
  auto wr = front_ring(rg, (size_t)kTailN * kTailLd, pl.ws, pl.tiles(),
      [=](int t, __nv_bfloat16* dst) {
        if (t < n_in) {
          stage_gdfn_tile(dst, t, per, nk, win, wout, C, hid);
        } else {  // the exit 1x1: output channels n0.., depth k0..
          const int u = t - n_in, n0 = u / nk * kTailN, k0 = u % nk * kGdfnK;
          stage_tile(dst, kTailLd, wproj + (size_t)n0 * C8 + k0, C8, kTailN, kGdfnK, Co - n0,
                     C8 - k0);
        }
      });
  wr.prefetch();
  // the halo landed (the oldest group); LayerNorm in place (zero rows stay zero)
  cp_async_wait_upto(pl.ws - 1);
  __syncthreads();
  halo_ln(xh, ld, hsrc, C, lnw, lnb, eps);

  // project_out's operands as the tail tile's fc2: A the gated tile at the
  // warp's 16 rows, B the lane's offset in a tile; sums in registers
  const int wc = warp & 3, groups = CK / 64;
  const uint32_t ag = smem_u32(gs + (16 * (warp >> 2) + (lane & 15)) * kTailLdg + 8 * (lane >> 4));
  const int boff = ((lane & 7) + 8 * (lane >> 4)) * kTailLd + 8 * ((lane >> 3) & 1);
  float oacc[2 * kTailGroups][4];
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[q][e] = 0.f;
  float acc[kGdfnUnits][4][4];
  for (int j0 = 0; j0 < hid; j0 += kGdfnK) {
    // the chunk's taps in float32: column u < 64 is x1 unit j0 + u, the rest
    // x2 unit j0 + u - 64; zero past hid (every thread is past the last
    // chunk's depthwise conv: the last project_out tile's barrier)
    for (int i = threadIdx.x; i < 9 * 2 * kGdfnK; i += blockDim.x) {
      const int tap = i / (2 * kGdfnK), u = i % (2 * kGdfnK), unit = j0 + u % kGdfnK;
      tp[i] = unit < hid ? __bfloat162float(taps[(size_t)(u < kGdfnK ? unit : hid + unit) * 9 + tap])
                         : 0.f;
    }
    // project_in over the halo; t of its 100 rows in float32
    halo_1x1(acc, xh, ld, wr, kGdfnInUnits, CP, nk);
    front_out(acc, kGdfnInUnits, 7, [&](int r, int c, float v0, float v1) {
      if (r < kHaloPix) *reinterpret_cast<float2*>(ts + r * kGdfnLdt + c) = make_float2(v0, v1);
    });
    __syncthreads();
    // the depthwise 3x3 in float32 (taps in order, as dwconv3_f32), then
    // gelu(x1) * x2 rounded to bf16; one item = (unit u, tile column pc, 4
    // output rows from pr)
    for (int idx = threadIdx.x; idx < kGdfnK * 16; idx += blockDim.x) {
      const int u = idx % kGdfnK, h = idx / kGdfnK, pc = h & 7, pr = (h >> 3) * 4;
      float w1[9], w2[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        w1[tap] = tp[tap * 2 * kGdfnK + u];
        w2[tap] = tp[tap * 2 * kGdfnK + kGdfnK + u];
      }
      float s1[4], s2[4];
#pragma unroll
      for (int o = 0; o < 4; ++o) s1[o] = s2[o] = 0.f;
#pragma unroll
      for (int rr = 0; rr < 6; ++rr)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* tr = ts + ((pr + rr) * kHalo + pc + dx) * kGdfnLdt + u;
          const float v1 = tr[0], v2 = tr[kGdfnK];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int dy = rr - o;
            if (dy < 0 || dy > 2) continue;
            s1[o] = fmaf(v1, w1[dy * 3 + dx], s1[o]);
            s2[o] = fmaf(v2, w2[dy * 3 + dx], s2[o]);
          }
        }
#pragma unroll
      for (int o = 0; o < 4; ++o)
        gs[((pr + o) * kTile + pc) * kTailLdg + u] = __float2bfloat16(gelu_erf(s1[o]) * s2[o]);
    }
    // project_out; the first tile's barrier makes the gated tile visible
    for (int i = 0; i < nk2; ++i)
      tail_fc2(oacc, ag, smem_u32(wr.consume() + 16 * wc * kTailLd + boff), 2 * i, groups);
  }

  // y = the sums (+ x), rounded once, into the halo's space ([64][ld]; its
  // columns C..CP stay zero from the staging): every thread is past its last
  // halo read (the last project_in tile came before the last project_out
  // tile's barrier)
  __nv_bfloat16* y = xh;
  tail_out(oacc, C, [&](int i, int k, float v) {
    if (residual) v += __bfloat162float(x[tile_pix(b, ty, tx, i, H, W) * C + k]);
    y[i * ld + k] = __float2bfloat16(v);
  });
  __syncthreads();
  const bool vec_out = flags & kVecOut;
  auto same = [](int, int, float v) { return v; };
  if (wproj == nullptr) {
    tail_store(y, ld, C, vec_out, [&](int i) { return out + tile_pix(b, ty, tx, i, H, W) * C; },
               same);
    return;
  }
  // the exit 1x1: y x proj_w in passes of 128 output channels (4 row tiles x
  // up to 4 column blocks), rounded into t's space ([64][ldo] bf16), stored
  const int ldo = round_up8(Co) + 8;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(ts);
  for (int n0 = 0; n0 < Co; n0 += kTailN) {
    const int n_units = 4 * (min(kTailN, round_up32(Co) - n0) / 32);
    halo_1x1(acc, y, ld, wr, n_units, CP, nk, 4);
    front_out(acc, n_units, 4, [&](int r, int c, float v0, float v1) {
      if (n0 + c < Co) *reinterpret_cast<uint32_t*>(ob + r * ldo + n0 + c) = pack_bf16x2(v0, v1);
    });
  }
  __syncthreads();
  tail_store(ob, ldo, Co, vec_out, [&](int i) { return out + tile_pix(b, ty, tx, i, H, W) * Co; },
             same);
}

// The bf16 tile: C and Co up to kTailMaxC; win, wout and wproj 16-byte aligned.
cudaError_t launch_gdfn_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                           const __nv_bfloat16* win, const __nv_bfloat16* taps,
                           const __nv_bfloat16* wout, const __nv_bfloat16* wproj, int Co,
                           int residual, __nv_bfloat16* out, int B, int H, int W, int C, int hid,
                           float eps, cudaStream_t stream) {
  if (C > kTailMaxC || Co > kTailMaxC || !aligned(win, 16) || !aligned(wout, 16) ||
      !aligned(wproj, 16))
    return cudaErrorInvalidValue;
  const size_t smem = GdfnPlan(C, hid, wproj != nullptr ? Co : 0).bytes;
  int flags = 0;
  if (C % 8 == 0 && aligned(x, 16)) flags |= kVecX;
  if (Co % 8 == 0 && aligned(out, 16)) flags |= kVecOut;
  cudaError_t err = set_smem(gdfn_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  gdfn_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, win, taps, wout, wproj, Co, residual, out, H, W, C, hid, eps, flags);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float32 tile (K5 in float32; the eval CLI's PromptFusion feed-forward
// and exit 1x1, the float32 training route's forward): the bf16 tile's
// design in 3xTF32 on m16n8k8, with no rounding points. One 8x8 tile per
// 512-thread block:
// - LayerNorm statistics of the 100 halo pixels once per tile
//   (ln_stats_rows, from device memory);
// - the hidden width in chunks of kGdfnF32K units. project_in is a 112 x
//   2 kGdfnF32K x CP product, run in two passes (the chunk's x1 units, then
//   its x2 units: one unit of 16 x 32 a warp, so that its sums and the 48
//   project_out sums fit 128 registers without spills; in one pass, 2 units
//   a warp, ptxas spilled 40 B), whose A operand, the halo, is not resident
//   (a float32 halo beside t and the ring does not fit at C = 192-384): each
//   of its 32-channel chunks is streamed beside the same chunk of the pass's
//   64 rows of w_in (stage_f32_chunk, [112 + 64][36] stages; 4-byte cp.async
//   where C % 4 != 0), normalised when it lands (ln_f32_chunk; rows outside
//   the image stay zero) and multiplied into registers (halo_1x1_f32), so
//   the halo is read again from L2 twice per hidden chunk; t goes to shared
//   memory in float32 ([100][136]: float2 stores without bank conflicts);
// - the depthwise 3x3 in float32 on the chunk's taps (staged as float32
//   [9][128]), each output's nine taps summed by fmaf in tap order (as
//   dwconv3_f32), 4 output rows a thread; gelu(x1) * x2 in float32 into the
//   gated tile ([64][68]: rows 4 words mod 32, ldmatrix without bank
//   conflicts);
// - project_out: gated x the chunk's columns of w_out (torch layout
//   [C][hid4], [128 out][68] tiles through the same ring) as the float32
//   tail's fc2 (tail_fc2_f32), the 64 x C sums in registers across the whole
//   hidden loop (up to 1024 deep: every k8 step's three TF32 products are
//   summed from zero on the tensor cores and added to float32 registers,
//   mma_3xtf32); C up to 384 in one pass, wider (no exit 1x1) once per
//   output group of 384 channels with project_in recomputed;
// - epilogue: y = the sums (+ x) in float32. Without the exit 1x1 y is
//   stored from the registers (float pairs where C is even). With it, y goes
//   to shared memory ([64][CP + 4]) over the dead front, and out = y x
//   proj_w^T runs as the float32 apply's comb product (comb_f32: proj_w's
//   torch layout [Co][C4] is its [n][k] operand, 32-deep chunks through a
//   ring after y), staged [64][Co4 + 4] over y and stored in 16-byte runs
//   where Co % 4 == 0.
// Bound: as the bf16 tile's, at three TF32 products per float32 product.
// ---------------------------------------------------------------------------

constexpr int kGdfnF32K = 64;               // hidden chunk: kGdfnF32K x1 units and their x2 units
constexpr int kGdfnF32N = 2 * kGdfnF32K;    // project_in's columns per chunk
constexpr int kGdfnF32Ldt = kGdfnF32N + 8;  // t row in floats
constexpr int kGdfnF32Ldg = kGdfnF32K + 4;  // gated row and w_out tile row in floats
constexpr int kGdfnF32InUnits = 7 * kGdfnF32K / 32;         // a project_in pass's units of 16 x 32
constexpr int kGdfnF32Units = (kGdfnF32InUnits + 15) / 16;  // ... a warp
// project_out is the float32 tail's fc2 on the same [64][68] gated tile
static_assert(kGdfnF32K == kTailK && kGdfnF32Ldg == kTailLdF, "tail_fc2_f32's tile");

__host__ __device__ constexpr int round_up4(int n) { return (n + 3) / 4 * 4; }

// The float32 tile's plan at width C and exit width Co (0: no exit 1x1):
// taps [9][kGdfnF32N] | LN mean, rstd [2][112] | gated [64][kGdfnF32Ldg] |
// t [100][kGdfnF32Ldt] | ring (ws stages, at most 4, as many as the budget
// holds), every piece a multiple of 16 bytes; a stage holds a project_in
// pass's chunk ([112 + kGdfnF32K][36]) or a w_out tile ([128][kGdfnF32Ldg]). The
// exit's y [64][CP + 4] and its ring (cs stages of proj_w's [NP][36] chunks,
// NP = Co rounded up to 32) lie over the dead front from offset 0, in the
// front's bytes (cs = 3 where those hold it, else 2; with C and Co up to
// 384 two always fit), so the plan does not depend on C.
struct GdfnF32Plan {
  int CP, nk, ws, NP, ldy, cs;
  size_t stage, cstage, bytes;
  __host__ __device__ GdfnF32Plan(int C, int Co) {
    CP = round_up32(C);
    nk = CP / kF32K;
    const size_t f = sizeof(float);
    const size_t fixed = f * (9 * kGdfnF32N + 2 * kFrontRows + kPix * kGdfnF32Ldg +
                              kHaloPix * kGdfnF32Ldt);
    const size_t wtile = f * kTailN * kGdfnF32Ldg;
    stage = f32_stage_bytes(kGdfnF32K) > wtile ? f32_stage_bytes(kGdfnF32K) : wtile;
    for (ws = 4; ws > 2 && fixed + ws * stage > kGdfnBudget; --ws) {
    }
    bytes = fixed + ws * stage;
    NP = round_up32(Co);
    ldy = CP + 4;
    cstage = f * NP * kF32Ld;
    cs = f * kPix * ldy + 3 * cstage <= bytes ? 3 : 2;
  }
};

// Stages the [kTailN out][kGdfnF32Ldg] tile of w_out ([C][ldw] float32, ldw
// a multiple of 4, 16-byte aligned rows) at output channels n0.. and hidden
// units j0.. by 16-byte cp.async, zero past C and ldw. The caller commits.
__device__ __forceinline__ void stage_wout_f32(float* dst, const float* __restrict__ w, int ldw,
                                               int C, int n0, int j0) {
  constexpr int units = kGdfnF32K / 4;  // 16-byte copies a row
  for (int u = threadIdx.x; u < kTailN * units; u += blockDim.x) {
    const int r = u / units, c = (u - r * units) * 4, n = n0 + r, k = j0 + c;
    const bool ok = n < C && k < ldw;
    cp_async16(smem_u32(dst + r * kGdfnF32Ldg + c), ok ? w + (size_t)n * ldw + k : w,
               ok ? 16 : 0);
  }
}

// Each pair of the thread's fc2 sums (tail_out's layout, channels from 0):
// f(row, k, v0, v1) for channels k and k + 1, k < n (k is even).
template <typename F>
__device__ __forceinline__ void tail_out_pairs(const float (&acc)[2 * kTailGroups][4], int n,
                                               F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp >> 2) + (lane >> 2);
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q) {
    const int col = 64 * (q >> 1) + 16 * (warp & 3) + 8 * (q & 1) + 2 * (lane & 3);
    if (col < n) {
      f(r0, col, acc[q][0], acc[q][1]);
      f(r0 + 8, col, acc[q][2], acc[q][3]);
    }
  }
}

// Arguments: x (B, H, W, C) float32, LN float32; win [2 hid][C4], taps
// [2 hid][9], wout [C][hid4], wproj [Co][C4] or NULL: the torch layouts,
// rows padded with zeros to C4 / hid4 (rounded up to 4), 16-byte aligned;
// flags: kVecX (16-byte halo copies) | kPairs (8-byte loads of x and stores
// of out) | kVecOut (16-byte stores of the exit's output). Output (B, H, W,
// Co), Co = C without wproj.
__global__ void __launch_bounds__(kThreads)
gdfn_f32_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                const float* __restrict__ lnb, const float* __restrict__ win,
                const float* __restrict__ taps, const float* __restrict__ wout,
                const float* __restrict__ wproj, int Co, int residual, float* __restrict__ out,
                int H, int W, int C, int hid, float eps, int flags) {
  extern __shared__ float4 gdfn_f32_dyn[];  // 16-byte aligned: cp.async and ldmatrix
  __shared__ int hsrc[kFrontRows];          // halo row -> source pixel (-1: zero row)
  const GdfnF32Plan pl(C, wproj != nullptr ? Co : 0);
  const int nk = pl.nk, C4 = round_up4(C), hid4 = round_up4(hid), CK = round_up64(C);
  float* tp = reinterpret_cast<float*>(gdfn_f32_dyn);  // [9][kGdfnF32N] the chunk's taps
  float* mu = tp + 9 * kGdfnF32N;                       // [112]
  float* rs = mu + kFrontRows;                          // [112]
  float* gs = rs + kFrontRows;                          // [64][kGdfnF32Ldg] gated
  float* ts = gs + kPix * kGdfnF32Ldg;                  // [100][kGdfnF32Ldt] t
  float* rg = ts + kHaloPix * kGdfnF32Ldt;              // the ring
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool pairs = flags & kPairs;
  const HaloF32 hl{x, nullptr, C, 0, hsrc, (flags & kVecX) != 0};
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };

  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x)
    hsrc[p] = halo_src(p, b, ty, tx, H, W, 0);
  __syncthreads();
  // read after the first chunk's barrier
  ln_stats_rows(mu, rs, kHaloPix, C, eps, [&](int p, int k) { return hl.at(hsrc[p], k); },
                [&](int p) { return hsrc[p] >= 0; });

  // project_out's operands as the float32 tail's fc2: A the gated tile at the
  // warp's 16 rows, B the lane's offset in a w_out tile at the warp's 16
  // columns of each 64-channel group
  const int wc = warp & 3;
  const uint32_t ag =
      smem_u32(gs + (16 * (warp >> 2) + (lane & 15)) * kGdfnF32Ldg + 4 * (lane >> 4));
  const uint32_t boff =
      4 * (((lane & 7) + 8 * (lane >> 4)) * kGdfnF32Ldg + 4 * ((lane >> 3) & 1));
  float oacc[2 * kTailGroups][4];
  for (int g0 = 0; g0 < CK; g0 += kTailMaxC) {
    // the output group's channels g0 .. g0 + gc; per hidden chunk 2 nk
    // project_in chunks (the x1 pass's, then the x2 pass's), then nk2 w_out
    // tiles of 128 output channels
    const int gc = min(kTailMaxC, CK - g0), nk2 = (gc + kTailN - 1) / kTailN;
    const int per = 2 * nk + nk2;
    if (g0 > 0) __syncthreads();  // the last group's tiles read before their stages refill
    auto ring = front_ring(rg, pl.stage / sizeof(float), pl.ws,
        (hid + kGdfnF32K - 1) / kGdfnF32K * per, [=](int t, float* st) {
          const int j0 = t / per * kGdfnF32K, pos = t - t / per * per;
          if (pos < 2 * nk) {  // row n: x1 unit j0 + n in the first pass, x2 in the second
            const int x2 = pos >= nk;
            stage_f32_chunk(st, hl, win, C4, kGdfnF32K, [=](int n) {
              return j0 + n >= hid ? -1 : x2 ? hid + j0 + n : j0 + n;
            }, pos - x2 * nk);
          } else {
            stage_wout_f32(st, wout, hid4, C, g0 + kTailN * (pos - 2 * nk), j0);
          }
        });
    ring.prefetch();
#pragma unroll
    for (int q = 0; q < 2 * kTailGroups; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[q][e] = 0.f;
    for (int j0 = 0; j0 < hid; j0 += kGdfnF32K) {
      // the chunk's taps: column u < kGdfnF32K is x1 unit j0 + u, the rest x2
      // unit j0 + u - kGdfnF32K; zero past hid (every thread is past the last
      // chunk's depthwise conv: the last w_out tile's barrier)
      for (int i = threadIdx.x; i < 9 * kGdfnF32N; i += blockDim.x) {
        const int tap = i / kGdfnF32N, u = i - tap * kGdfnF32N;
        const int unit = j0 + (u < kGdfnF32K ? u : u - kGdfnF32K);
        tp[i] = unit < hid ? taps[(size_t)(u < kGdfnF32K ? unit : hid + unit) * 9 + tap] : 0.f;
      }
      // project_in over the halo, the x1 units' pass, then the x2 units',
      // LayerNorm per chunk as it lands; t of its 100 rows in float32
      for (int pass = 0; pass < 2; ++pass) {
        float acc[kGdfnF32Units][4][4];
        // (its k8 steps not unrolled: unrolled, the project_out sums beside
        // them spilled 16 B at 128 registers)
        halo_1x1_f32<kGdfnF32Units, 1>(acc, ring, kGdfnF32InUnits, nk, [&](float* st, int kt) {
          ln_f32_chunk(st, hsrc, mu, rs, lnw, lnb, C, kt);
          __syncthreads();
        });
        float* tq = ts + pass * kGdfnF32K;
        front_out(acc, kGdfnF32InUnits, 7, [&](int r, int c, float v0, float v1) {
          if (r < kHaloPix)
            *reinterpret_cast<float2*>(tq + r * kGdfnF32Ldt + c) = make_float2(v0, v1);
        });
      }
      __syncthreads();
      // the depthwise 3x3 in float32, then gelu(x1) * x2; one item = (unit
      // u, tile column pc, 4 output rows from pr)
      for (int idx = threadIdx.x; idx < kGdfnF32K * 16; idx += blockDim.x) {
        const int u = idx % kGdfnF32K, h = idx / kGdfnF32K, pc = h & 7, pr = (h >> 3) * 4;
        float w1[9], w2[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          w1[tap] = tp[tap * kGdfnF32N + u];
          w2[tap] = tp[tap * kGdfnF32N + kGdfnF32K + u];
        }
        float s1[4], s2[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) s1[o] = s2[o] = 0.f;
#pragma unroll
        for (int rr = 0; rr < 6; ++rr)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* tr = ts + ((pr + rr) * kHalo + pc + dx) * kGdfnF32Ldt + u;
            const float v1 = tr[0], v2 = tr[kGdfnF32K];
#pragma unroll
            for (int o = 0; o < 4; ++o) {
              const int dy = rr - o;
              if (dy < 0 || dy > 2) continue;
              s1[o] = fmaf(v1, w1[dy * 3 + dx], s1[o]);
              s2[o] = fmaf(v2, w2[dy * 3 + dx], s2[o]);
            }
          }
#pragma unroll
        for (int o = 0; o < 4; ++o)
          gs[((pr + o) * kTile + pc) * kGdfnF32Ldg + u] = gelu_erf(s1[o]) * s2[o];
      }
      // project_out; the first tile's barrier makes the gated tile visible
      for (int i = 0; i < nk2; ++i)
        tail_fc2_f32(oacc, ag, smem_u32(ring.consume() + 16 * wc * kGdfnF32Ldg) + boff, 2 * i,
                     gc / 64);
    }
    if (wproj != nullptr) break;  // (one group: C <= kTailMaxC)
    // y = the sums (+ x), stored from the registers
    tail_out_pairs(oacc, min(gc, C - g0), [&](int i, int k, float v0, float v1) {
      const size_t p = pix(i);
      const int c = g0 + k;
      if (residual) {
        const float2 u = load_pair(x, nullptr, C, 0, p, c, pairs);
        v0 = v0 + u.x;
        v1 = v1 + u.y;
      }
      float* o = out + p * C + c;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (c + 1 < C) o[1] = v1;
      }
    });
  }
  if (wproj == nullptr) return;

  // the exit 1x1: y = the sums (+ x) into [64][ldy] over the dead front (zero
  // from C to CP), then y x proj_w^T as the float32 apply's comb product,
  // proj_w's 32-deep chunks through a ring after y
  float* y = reinterpret_cast<float*>(gdfn_f32_dyn);
  const int ldy = pl.ldy, NP = pl.NP;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the front: y and the ring take its space
  auto cr = front_ring(y + kPix * ldy, pl.cstage / sizeof(float), pl.cs, nk,
      [=](int kt, float* st) {
        stage_w_f32_chunk(st, wproj, C4, NP, [=](int n) { return n < Co ? n : -1; }, kt);
      });
  cr.prefetch();
  tail_out_pairs(oacc, pl.CP, [&](int i, int k, float v0, float v1) {
    if (residual && k < C) {
      const float2 u = load_pair(x, nullptr, C, 0, pix(i), k, pairs);
      v0 = v0 + u.x;
      v1 = v1 + u.y;
    }
    *reinterpret_cast<float2*>(y + i * ldy + k) =
        make_float2(k < C ? v0 : 0.f, k + 1 < C ? v1 : 0.f);
  });
  float eacc[kFrontUnits][4][4];
  comb_f32(eacc, y, ldy, cr, 4 * (NP / 32), nk);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with y and the ring: the output takes their space
  const int ldo = round_up4(Co) + 4;
  float* ob = y;
  front_out(eacc, 4 * (NP / 32), 4, [&](int i, int c, float v0, float v1) {
    if (c < Co) *reinterpret_cast<float2*>(ob + i * ldo + c) = make_float2(v0, v1);
  });
  __syncthreads();
  if (flags & kVecOut) {
    const int units = Co / 4;
    for (int u = threadIdx.x; u < kPix * units; u += blockDim.x) {
      const int i = u / units, c = (u - i * units) * 4;
      *reinterpret_cast<float4*>(out + pix(i) * Co + c) =
          *reinterpret_cast<const float4*>(ob + i * ldo + c);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * Co; u += blockDim.x) {
      const int i = u / Co, c = u - i * Co;
      out[pix(i) * Co + c] = ob[i * ldo + c];
    }
  }
}

// The float32 tile: C up to kTailMaxC and Co up to kCombMaxN with the exit
// 1x1, any C without it; win, wout and wproj 16-byte aligned.
cudaError_t launch_gdfn_f32(const float* x, const float* lnw, const float* lnb, const float* win,
                            const float* taps, const float* wout, const float* wproj, int Co,
                            int residual, float* out, int B, int H, int W, int C, int hid,
                            float eps, cudaStream_t stream) {
  if ((wproj != nullptr && (C > kTailMaxC || Co > kCombMaxN)) || !aligned(win, 16) ||
      !aligned(wout, 16) || !aligned(wproj, 16))
    return cudaErrorInvalidValue;
  const size_t smem = GdfnF32Plan(C, wproj != nullptr ? Co : 0).bytes;
  int flags = 0;
  if (C % 4 == 0 && aligned(x, 16)) flags |= kVecX;
  if (C % 2 == 0 && aligned(x, 8) && aligned(out, 8)) flags |= kPairs;
  if (Co % 4 == 0 && aligned(out, 16)) flags |= kVecOut;
  cudaError_t err = set_smem(gdfn_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  gdfn_f32_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, win, taps, wout, wproj, Co, residual, out, H, W, C, hid, eps, flags);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 backward (K11, replaces _gdfn_bwd_kernel,
// mp_hsir_tpu/ops/pallas_vjp.py:342, host _gdfn_bwd_call :471) on the tensor
// cores, in two launches; the float32 route keeps gdfn_bwd_kernel below and
// grad.cu's depthwise and LayerNorm stages.
//
// Tile 1, gdfn_bwd_tc_kernel: per 8x8 tile (one 512-thread block) the
// forward tile's front, then dgated and the cotangent at the depthwise
// output:
// - the halo staged once as bf16 [112][CP + 8] with LN in place (the forward
//   tile's staging), dy staged once as bf16 [64][CP + 8] in the same copy
//   group; xn = LN(x) written from the halo's inner rows (dW_in's operand);
// - per hidden chunk of 64 units: project_in over the halo on mma.sync (the
//   forward's halo_1x1, the chunk's x1 and x2 rows of w_in through the
//   ring), t into shared memory in float32 ([100][136]) and, at the tile's
//   pixels, to device memory in float32 (tile 2's operand); the depthwise
//   3x3 in float32 in tap order with the taps read from device memory (L1),
//   a1 | a2 held in registers; gated = rnd(gelu(a1) a2) written out (dW_out's
//   operand); after a barrier a1 | a2 overlay t's first 64 rows;
// - dgated = dy W_out[:, chunk] on mma.sync: the chunk's project_out tiles of
//   the forward's stream (w_out's [C][hid8] rows, 128 channels x 64 units)
//   read .trans as B = [k = channel][n = unit], every warp a 16 x 16 block;
//   the epilogue reads a1 | a2 at each accumulator's place and writes dc =
//   [dgated a2 gelu'(a1) | dgated gelu(a1)] in float32.
// Tile 2 is dwconv_dx_tc_kernel<true, true, true> (dwconv_dx.cuh) at K =
// 2 hid: the transposed stencil of dc, dt rounded to bf16, the tap partials
// on float32 t, dxn = dt w_in on mma.sync, the LayerNorm backward and the
// residual's dy added (float32) before dx rounds. Then the wrapper's two
// wgrads (dW_in = dt^T xn, dW_out = dy^T gated) and the in-order sums of the
// part rows (per image, then over the images). No float atomics: two calls
// give bitwise the same outputs.
//
// Rounding points as gdfn_bwd_plain: LN(x) rounded (the halo), t, a, dgated,
// dc float32, gated rounded, dt rounded once before both dxn and dW_in, dx +
// dy rounded once.
//
// Bound: 6.25 C hid (project_in over the 100 halo pixels of 64) + 2 C hid
// (dgated) + 36 hid flops per pixel against 4C bytes read (x, dy) and 2C +
// 18 hid written (xn, gated, t, dc); tile 2 reads t and dc again: bytes
// bound the pair at these widths.
// ---------------------------------------------------------------------------

// Tile 1's plan at width C and hidden width hid: t [100][kGdfnLdt] float32 |
// halo [112][ld] | dy [64][ld] | ring (ws stages of [kTailN][kTailLd], at most
// kTailStages, as many as the budget allows), every piece a multiple of 16
// bytes. The taps are not staged: with them (4,608 B) C = 384 would need
// 233,856 B with 2 ring stages, over the budget. The weight stream is the
// forward's without the exit 1x1: per hidden chunk nk project_in tiles, nk2
// project_out tiles.
struct GdfnBwdPlan {
  int CP, ld, nk, nch, nk2, ws;
  size_t t, halo, dy, bytes;
  __host__ __device__ GdfnBwdPlan(int C, int hid) {
    CP = round_up32(C);
    ld = CP + 8;
    nk = (CP + kGdfnK - 1) / kGdfnK;
    nch = (hid + kGdfnK - 1) / kGdfnK;
    nk2 = (round_up64(C) + kTailN - 1) / kTailN;
    t = sizeof(float) * kHaloPix * kGdfnLdt;
    halo = sizeof(__nv_bfloat16) * kFrontRows * ld;
    dy = sizeof(__nv_bfloat16) * kPix * ld;
    const size_t fixed = t + halo + dy;
    for (ws = kTailStages; ws > 2 && fixed + ws * kTailStage > kGdfnBudget; --ws) {
    }
    bytes = fixed + ws * kTailStage;
  }
  __host__ __device__ int tiles() const { return nch * (nk + nk2); }
};

// v0 at o[0], v1 at o[1] where `both`; one 8-byte store where `pair`.
__device__ __forceinline__ void store_f2(float* o, float v0, float v1, bool both, bool pair) {
  if (both && pair) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (both) o[1] = v1;
  }
}

// Arguments: x, dy (B, H, W, C) bf16; LN float32; win [2 hid][C8], taps
// [2 hid][9], wout [C][hid8]: pack_gdfn's operands (win and wout 16-byte
// aligned). flags: kVecX (x and dy 16-byte rows) | kPairs (t and dc 8-byte
// aligned) | kVecOut (xn 16-byte rows). Outputs: xn (B, H, W, C) and gated
// (B, H, W, hid) bf16; t and dc (B, H, W, 2 hid) float32 (x1 units, then x2).
__global__ void __launch_bounds__(kThreads)
gdfn_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ win,
                   const __nv_bfloat16* __restrict__ taps, const __nv_bfloat16* __restrict__ wout,
                   const __nv_bfloat16* __restrict__ dy, int H, int W, int C, int hid, float eps,
                   int flags, __nv_bfloat16* __restrict__ xn_out, float* __restrict__ t_out,
                   float* __restrict__ dc_out, __nv_bfloat16* __restrict__ gated_out) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 gdfn_bwd_dyn[];
  __shared__ int hsrc[kFrontRows];  // halo row -> source pixel (-1: zero row)
  const GdfnBwdPlan pl(C, hid);
  const int ld = pl.ld, CP = pl.CP, nk = pl.nk, nk2 = pl.nk2, H2 = 2 * hid;
  char* sm = reinterpret_cast<char*>(gdfn_bwd_dyn);
  float* ts = reinterpret_cast<float*>(sm);  // [100][kGdfnLdt] t, then a1 | a2 in rows 0..63
  bf16* xh = reinterpret_cast<bf16*>(sm + pl.t);   // [112][ld] the LN'd halo
  bf16* ds = xh + kFrontRows * ld;                 // [64][ld] dy
  bf16* rg = ds + kPix * ld;                       // the ring
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec_x = flags & kVecX, pairs = flags & kPairs, pair2 = pairs && (hid & 1) == 0;
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };

  for (int p = threadIdx.x; p < kFrontRows; p += blockDim.x)
    hsrc[p] = halo_src(p, b, ty, tx, H, W, 0);
  // dy's rows, zero past C, in the halo's copy group
  if (vec_x) {
    for (int u = threadIdx.x; u < kPix * (CP / 8); u += blockDim.x) {
      const int i = u / (CP / 8), c = (u - i * (CP / 8)) * 8;
      cp_async16(smem_u32(ds + i * ld + c), c < C ? dy + pix(i) * C + c : dy, c < C ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * CP; u += blockDim.x) {
      const int i = u / CP, c = u - i * CP;
      ds[i * ld + c] = c < C ? dy[pix(i) * C + c] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  stage_halo(xh, ld, hsrc, x, nullptr, C, 0, CP, vec_x);

  const int per = nk + nk2;
  auto wr = front_ring(rg, (size_t)kTailN * kTailLd, pl.ws, pl.tiles(),
      [=](int t, bf16* dst) { stage_gdfn_tile(dst, t, per, nk, win, wout, C, hid); });
  wr.prefetch();
  // the halo and dy landed (the oldest group); LayerNorm in place
  cp_async_wait_upto(pl.ws - 1);
  __syncthreads();
  halo_ln(xh, ld, hsrc, C, lnw, lnb, eps);

  // dgated's operands: A dy at the warp's 16 rows (row tile wr4), B a
  // project_out tile read .trans at the warp's 16 units (column block wc):
  // lane gives k row lane % 8 + 8 (lane / 8 % 2) at n column 16 wc + 8 (lane / 16)
  const int wr4 = warp >> 2, wc = warp & 3;
  const int r0 = 16 * wr4 + (lane >> 2), cu = 16 * wc + 2 * (lane & 3);  // accumulator row, unit
  const uint32_t ad = smem_u32(ds + (16 * wr4 + (lane & 15)) * ld + 8 * (lane >> 4));
  const int boff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kTailLd + 16 * wc + 8 * (lane >> 4);
  // the depthwise conv's items: unit du, tile column dpc, rows 0-3 and 4-7
  const int du = threadIdx.x & 63, dpc = threadIdx.x >> 6;
  float acc[kGdfnUnits][4][4];
  for (int j0 = 0; j0 < hid; j0 += kGdfnK) {
    // project_in over the halo; t of its 100 rows in float32, and at the
    // tile's pixels to device memory (every thread is past the last chunk's
    // epilogue: the first project_in tile's barrier)
    halo_1x1(acc, xh, ld, wr, kGdfnInUnits, CP, nk);
    front_out(acc, kGdfnInUnits, 7, [&](int r, int c, float v0, float v1) {
      if (r >= kHaloPix) return;
      *reinterpret_cast<float2*>(ts + r * kGdfnLdt + c) = make_float2(v0, v1);
      const int hr = r / kHalo, hc = r - hr * kHalo, j = j0 + (c & (kGdfnK - 1));
      if (hr < 1 || hr > kTile || hc < 1 || hc > kTile || j >= hid) return;
      float* o = t_out + pix((hr - 1) * kTile + hc - 1) * H2 + (c < kGdfnK ? j : hid + j);
      store_f2(o, v0, v1, j + 1 < hid, c < kGdfnK ? pairs : pair2);
    });
    __syncthreads();
    // the depthwise 3x3 in float32 (taps in order, as the forward tile),
    // then gated = rnd(gelu(a1) a2) to device memory
    const int unit = j0 + du;
    float w1[9], w2[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      w1[tap] = unit < hid ? __bfloat162float(taps[(size_t)unit * 9 + tap]) : 0.f;
      w2[tap] = unit < hid ? __bfloat162float(taps[(size_t)(hid + unit) * 9 + tap]) : 0.f;
    }
    float s1[2][4], s2[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pr = 4 * hh;
#pragma unroll
      for (int o = 0; o < 4; ++o) s1[hh][o] = s2[hh][o] = 0.f;
#pragma unroll
      for (int rr = 0; rr < 6; ++rr)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* tr = ts + ((pr + rr) * kHalo + dpc + dx) * kGdfnLdt + du;
          const float v1 = tr[0], v2 = tr[kGdfnK];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int dyy = rr - o;
            if (dyy < 0 || dyy > 2) continue;
            s1[hh][o] = fmaf(v1, w1[dyy * 3 + dx], s1[hh][o]);
            s2[hh][o] = fmaf(v2, w2[dyy * 3 + dx], s2[hh][o]);
          }
        }
      if (unit < hid)
#pragma unroll
        for (int o = 0; o < 4; ++o)
          gated_out[pix((pr + o) * kTile + dpc) * hid + unit] =
              __float2bfloat16(gelu_erf(s1[hh][o]) * s2[hh][o]);
    }
    __syncthreads();  // every thread is past its reads of t: a1 | a2 over its first 64 rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        float* a = ts + ((4 * hh + o) * kTile + dpc) * kGdfnLdt + du;
        a[0] = s1[hh][o];
        a[kGdfnK] = s2[hh][o];
      }
    // dgated over the chunk's project_out tiles (the first tile's barrier
    // makes a1 | a2 visible); 16-deep steps up to CP
    float dg[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dg[q][e] = 0.f;
    for (int i = 0; i < nk2; ++i) {
      const uint32_t bt = smem_u32(wr.consume()) + 2 * boff;
      const int steps = min(kTailN, CP - kTailN * i) / 16;
      for (int kk = 0; kk < steps; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, ad + 2 * (kTailN * i + 16 * kk));
        ldmatrix_x4_trans(bf, bt + 2 * 16 * kk * kTailLd);
        mma_16x8x16(dg[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_16x8x16(dg[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
    }
    // dc = [dgated a2 gelu'(a1) | dgated gelu(a1)] at each accumulator pair
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = r0 + 8 * rr, u = cu + 8 * q, j = j0 + u;
        if (j >= hid) continue;
        const float* a = ts + i * kGdfnLdt + u;
        const float g0 = dg[q][2 * rr], g1 = dg[q][2 * rr + 1];
        float* o = dc_out + pix(i) * H2;
        store_f2(o + j, g0 * a[kGdfnK] * dgelu_erf(a[0]), g1 * a[kGdfnK + 1] * dgelu_erf(a[1]),
                 j + 1 < hid, pairs);
        store_f2(o + hid + j, g0 * gelu_erf(a[0]), g1 * gelu_erf(a[1]), j + 1 < hid, pair2);
      }
  }
  cp_async_wait<0>();
  // xn from the halo's inner rows (LayerNorm'd before the first tile's barrier)
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };
  if (flags & kVecOut) {
    for (int u = threadIdx.x; u < kPix * (C / 8); u += blockDim.x) {
      const int i = u / (C / 8), c = (u - i * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(xn_out + pix(i) * C + c) =
          *reinterpret_cast<const uint4*>(xh + hp(i) * ld + c);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * C; u += blockDim.x) {
      const int i = u / C, c = u - i * C;
      xn_out[pix(i) * C + c] = xh[hp(i) * ld + c];
    }
  }
}

// Tile 1 (C up to kTailMaxC; win and wout 16-byte aligned).
cudaError_t launch_gdfn_bwd_tc(const __nv_bfloat16* x, const float* lnw, const float* lnb,
                               const __nv_bfloat16* win, const __nv_bfloat16* taps,
                               const __nv_bfloat16* wout, const __nv_bfloat16* dy,
                               __nv_bfloat16* xn, float* t, float* dc, __nv_bfloat16* gated, int B,
                               int H, int W, int C, int hid, float eps, cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(win, 16) || !aligned(wout, 16)) return cudaErrorInvalidValue;
  const size_t smem = GdfnBwdPlan(C, hid).bytes;
  int flags = 0;
  if (C % 8 == 0 && aligned(x, 16) && aligned(dy, 16)) flags |= kVecX;
  if (aligned(t, 8) && aligned(dc, 8)) flags |= kPairs;
  if (C % 8 == 0 && aligned(xn, 16)) flags |= kVecOut;
  cudaError_t err = set_smem(gdfn_bwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  gdfn_bwd_tc_kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      x, lnw, lnb, win, taps, wout, dy, H, W, C, hid, eps, flags, xn, t, dc, gated);
  return cudaGetLastError();
}

// Tile 2: dwconv_dx_tc_kernel<true, true, true> at K = 2 hid, unshifted, the
// part row of a tile [9 K | d ln_w | d ln_b]; extra (dy in float32, the
// residual) or NULL.
cudaError_t launch_gdfn_dx_tc(const float* dc, const float* t, const __nv_bfloat16* taps,
                              const __nv_bfloat16* win, const __nv_bfloat16* x, const float* lnw,
                              const float* extra, __nv_bfloat16* dt, __nv_bfloat16* dx,
                              float* part, int B, int H, int W, int C, int hid, float eps,
                              cudaStream_t stream) {
  if (C > kTailMaxC || !aligned(win, 16)) return cudaErrorInvalidValue;
  const int K = 2 * hid;
  const size_t smem = DwDxPlan(C, K, true, true).bytes;
  const int vec_in = K % 4 == 0 && aligned(dc, 16) && aligned(t, 16) ? 4
                     : aligned(dc, 8) && aligned(t, 8)             ? 2
                                                                   : 1;
  const int vec_x = C % 8 == 0 && aligned(x, 16) && aligned(dx, 16) && aligned(extra, 16);
  const auto kernel = dwconv_dx_tc_kernel<true, true, true>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      dc, t, taps, win, x, lnw, H, W, C, K, 0, eps, vec_in, vec_x, dt, dx, part, 9 * K + 2 * C,
      extra);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float32 backward (K11, replaces _gdfn_bwd_kernel, mp_hsir_tpu/ops/pallas_vjp.py:342):
// per 8x8 tile and hidden chunk, recompute LN(x) on the halo, t = LN(x) W_in
// (float32, as the forward keeps it) and the depthwise output [a1 | a2];
// dgated = dy W_out^T; da1 = dgated a2 gelu'(a1), da2 = dgated gelu(a1). It
// writes LN(x), t and d[a1 | a2] (float32) and the gated product for grad.cu
// (depthwise backward, 1x1 + LN backward with the residual, weight products).
// ---------------------------------------------------------------------------
//
// Shared memory: the LN'd halo is staged whole where that fits (every
// natural-scene width); at C = 384 (295 KB whole) each halo pixel's LN mean
// and rstd stay in shared memory and the halo streams in channel chunks of
// kc for project_in (168 KB), re-read per hidden chunk. dy stays whole.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
gdfn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
                const float* __restrict__ lnb, const T* __restrict__ win,
                const T* __restrict__ wdw, const T* __restrict__ wout, const T* __restrict__ dy,
                T* __restrict__ xn_out, float* __restrict__ t_out, float* __restrict__ dc_out,
                T* __restrict__ gated_out, int H, int W, int C, int hid, float eps, int kc) {
  extern __shared__ float sm[];
  const int ldc = kc + 1, ldx = C + 1, ldt = 2 * kGC + 1;
  constexpr bool resident = !kStream;  // kc = C
  float* xs = sm;                    // [100][ldc] LN(x) halo: whole or a chunk
  float* ts = xs + kHaloPix * ldc;   // [100][ldt] project_in chunk: x1 | x2
  float* cs = ts + kHaloPix * ldt;   // [64][ldt] depthwise output a1 | a2
  float* dys = cs + kPix * ldt;      // [64][ldx] dy
  float* mu = dys + kPix * ldx;      // streamed: [100] LN mean, then [100] rstd
  float* rs = mu + kHaloPix;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int H2 = 2 * hid;
  auto inside = [&](int p) {
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    return r >= 0 && r < H && c >= 0 && c < W;
  };
  auto at = [&](int p, int k) {
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    return to_f(x[(((size_t)b * H + r) * W + c) * C + k]);
  };
  auto hp = [](int i) { return ((i >> 3) + 1) * kHalo + (i & 7) + 1; };
  auto pix = [&](int i) { return tile_pix(b, ty, tx, i, H, W); };
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C;
    dys[i * ldx + k] = to_f(dy[pix(i) * C + k]);
  }
  if (resident) {
    for (int idx = threadIdx.x; idx < kHaloPix * C; idx += blockDim.x) {
      const int p = idx / C, k = idx - p * C;
      xs[p * ldc + k] = inside(p) ? at(p, k) : 0.f;
    }
    __syncthreads();
    ln_rows_inplace<T>(xs, ldc, kHaloPix, C, lnw, lnb, eps, inside);
  } else {
    ln_stats_rows(mu, rs, kHaloPix, C, eps, at, inside);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPix * C; idx += blockDim.x) {
    const int i = idx / C, k = idx - i * C, p = hp(i);
    const float v = resident ? xs[p * ldc + k]
                             : rnd<T>((at(p, k) - mu[p]) * rs[p] * lnw[k] + lnb[k]);
    xn_out[pix(i) * C + k] = from_f<T>(v);
  }
  for (int j0 = 0; j0 < hid; j0 += kGC) {
    const int hc = min(kGC, hid - j0);
    auto col = [&](int j) { return j < hc ? j0 + j : hid + j0 + (j - hc); };
    for (int c0 = 0; c0 < C; c0 += kc) {
      const int nc = min(kc, C - c0);
      if (!resident) {
        load_chunk<T>(xs, ldc, kHaloPix, c0, nc, at, inside, mu, rs, lnw, lnb);
        __syncthreads();
      }
      const bool first = c0 == 0, last = c0 + nc >= C;
      gemm<T>(kHaloPix, 2 * hc, nc,
          [&](int i, int k) { return xs[i * ldc + k]; },
          [&](int k, int j) { return to_f(win[(size_t)(c0 + k) * H2 + col(j)]); },
          [&](int i, int j, float a) {
            chunk_acc(ts[i * ldt + (j < hc ? j : kGC + j - hc)], a, first, last,
                      [](float v) { return v; });
          });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kPix * 2 * hc; idx += blockDim.x) {
      const int i = idx / (2 * hc), j = idx - i * 2 * hc;
      t_out[pix(i) * H2 + col(j)] = ts[hp(i) * ldt + (j < hc ? j : kGC + j - hc)];
    }
    for (int idx = threadIdx.x; idx < kPix * hc; idx += blockDim.x) {
      const int p = idx / hc, j = idx - p * hc;
      const int pr = p >> 3, pc = p & 7;
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int dy3 = 0; dy3 < 3; ++dy3)
#pragma unroll
        for (int dx3 = 0; dx3 < 3; ++dx3) {
          const float* t = ts + ((pr + dy3) * kHalo + pc + dx3) * ldt;
          const int tap = dy3 * 3 + dx3;
          a1 = fmaf(t[j], to_f(wdw[tap * H2 + j0 + j]), a1);
          a2 = fmaf(t[kGC + j], to_f(wdw[tap * H2 + hid + j0 + j]), a2);
        }
      cs[p * ldt + j] = a1;
      cs[p * ldt + kGC + j] = a2;
      gated_out[pix(p) * hid + j0 + j] = from_f<T>(rnd<T>(gelu_erf(a1) * a2));
    }
    __syncthreads();
    gemm<T>(kPix, hc, C,  // dgated = dy W_out^T
        [&](int i, int k) { return dys[i * ldx + k]; },
        [&](int k, int j) { return to_f(wout[(size_t)(j0 + j) * C + k]); },
        [&](int i, int j, float g) {
          const float a1 = cs[i * ldt + j], a2 = cs[i * ldt + kGC + j];
          dc_out[pix(i) * H2 + j0 + j] = g * a2 * dgelu_erf(a1);
          dc_out[pix(i) * H2 + hid + j0 + j] = g * gelu_erf(a1);
        });
    __syncthreads();
  }
}

// The backward instance of a chunk: resident (the whole halo) where kc
// covers C, a kernel of its own as the natural-scene widths' plan.
template <typename T>
inline auto gdfn_bwd_kernel_for(int kc, int C) {
  return kc >= C ? gdfn_bwd_kernel<T, false> : gdfn_bwd_kernel<T, true>;
}

// kc = C: the whole halo; kc < C: a chunk of it and the LN statistics.
inline size_t gdfn_bwd_smem(int C, int kc) {
  const size_t whole = (size_t)kHaloPix * (kc + 1) + (size_t)kHaloPix * (2 * kGC + 1) +
                       (size_t)kPix * (2 * kGC + 1) + (size_t)kPix * (C + 1);
  return sizeof(float) * (kc >= C ? whole : whole + 2 * kHaloPix);
}

inline int gdfn_bwd_chunk(int C) {
  return pick_chunk(C, [&](int kc) {
    return plan_bytes(gdfn_bwd_kernel_for<float>(kc, C), gdfn_bwd_smem(C, kc));
  });
}

template <typename T>
cudaError_t launch_gdfn_bwd(const void* x, const float* lnw, const float* lnb, const void* win,
                            const void* wdw, const void* wout, const void* dy, void* xn, float* t,
                            float* dc, void* gated, int B, int H, int W, int C, int hid, int kc,
                            float eps, cudaStream_t stream) {
  const size_t smem = gdfn_bwd_smem(C, kc);
  const auto kernel = gdfn_bwd_kernel_for<T>(kc, C);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(W / kTile, H / kTile, B), kThreads, smem, stream>>>(
      (const T*)x, lnw, lnb, (const T*)win, (const T*)wdw, (const T*)wout, (const T*)dy, (T*)xn,
      t, dc, (T*)gated, H, W, C, hid, eps, kc);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, C); LN float32. Output (B, H, W, Co), with Co = C when wproj
// is NULL. The torch layouts, win [2*hid][Cp], wdw [2*hid][9], wout
// [C][hidp], wproj [Co][Cp] or NULL, rows padded with zeros to Cp / hidp (C
// and hid rounded up to 4 in float32, dtype 0; to 8 in bf16, dtype 1),
// 16-byte aligned. float32: C up to 384 and Co up to 384 with wproj, any C
// without it; bf16: C and Co up to 384. kc is C (no chunk: both tiles
// stream what they do not hold).
extern "C" int mp_gdfn(const void* x, const void* lnw, const void* lnb, const void* win,
                       const void* wdw, const void* wout, const void* wproj, void* out,
                       int dtype, int B, int H, int W, int C, int hid, int Co, int residual,
                       int kc, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc != C) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)mp::launch_gdfn_f32(f(x), f(lnw), f(lnb), f(win), f(wdw), f(wout), f(wproj), Co,
                                    residual, (float*)out, B, H, W, C, hid, eps, st);
  using bf = const __nv_bfloat16*;
  return (int)mp::launch_gdfn_tc((bf)x, f(lnw), f(lnb), (bf)win, (bf)wdw, (bf)wout, (bf)wproj, Co,
                                 residual, (__nv_bfloat16*)out, B, H, W, C, hid, eps, st);
}

// Shared-memory plans per block (bytes, static included): the float32 tile
// at C (GdfnF32Plan; its bytes depend on neither C, hid nor Co up to 384)
// and the bf16 tile at C (GdfnPlan; its bytes do not depend on hid or Co).
extern "C" long long mp_gdfn_f32_smem(int C) {
  return mp::plan_bytes(mp::gdfn_f32_kernel, mp::GdfnF32Plan(C, 0).bytes);
}

extern "C" long long mp_gdfn_tc_smem(int C) {
  return mp::plan_bytes(mp::gdfn_tc_kernel, mp::GdfnPlan(C, 0, 0).bytes);
}

extern "C" long long mp_gdfn_bwd_smem(int C, int kc) {
  return mp::plan_bytes(mp::gdfn_bwd_kernel_for<float>(kc, C), mp::gdfn_bwd_smem(C, kc));
}

// The bf16 backward's tiles (bytes, static included): tile 1 (GdfnBwdPlan;
// its bytes do not depend on hid) and tile 2 (DwDxPlan with float32 t; nor
// do its on K); -1 past C = 384.
extern "C" long long mp_gdfn_bwd_tc_smem(int C) {
  return C > mp::kTailMaxC ? -1
                           : mp::plan_bytes(mp::gdfn_bwd_tc_kernel, mp::GdfnBwdPlan(C, 0).bytes);
}

extern "C" long long mp_gdfn_dx_tc_smem(int C) {
  return C > mp::kTailMaxC ? -1
                           : mp::plan_bytes(mp::dwconv_dx_tc_kernel<true, true, true>,
                                            mp::DwDxPlan(C, 0, true, true).bytes);
}

// The channel chunk the backward kernel launches with at C.
extern "C" int mp_gdfn_bwd_chunk(int C) { return mp::gdfn_bwd_chunk(C); }

// The per-tile half of the float32 GDFN backward (no exit projection; bf16
// runs mp_gdfn_bwd_tc and mp_gdfn_dx_tc). dy (B, H, W, C). Outputs: xn (B,
// H, W, C) LN(x) and gated (B, H, W, hid); t and dc (B, H, W, 2*hid):
// project_in output and the cotangent at the depthwise output. kc: the
// channel chunk (mp_gdfn_bwd_chunk).
extern "C" int mp_gdfn_bwd(const void* x, const void* lnw, const void* lnb, const void* win,
                           const void* wdw, const void* wout, const void* dy, void* xn, void* t,
                           void* dc, void* gated, int dtype, int B, int H, int W, int C, int hid,
                           int kc, float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0 || kc <= 0 || kc > C || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return (int)mp::launch_gdfn_bwd<float>(x, (const float*)lnw, (const float*)lnb, win, wdw, wout,
                                         dy, xn, (float*)t, (float*)dc, gated, B, H, W, C, hid,
                                         kc, eps, (cudaStream_t)stream);
}

// The bf16 backward's first tile (C <= 384): x, dy (B, H, W, C) bf16, LN
// float32; win [2 hid][C8], taps [2 hid][9], wout [C][hid8] bf16 (pack_gdfn's
// operands, win and wout 16-byte aligned). Outputs: xn (B, H, W, C) and gated
// (B, H, W, hid) bf16; t and dc (B, H, W, 2 hid) float32.
extern "C" int mp_gdfn_bwd_tc(const void* x, const void* lnw, const void* lnb, const void* win,
                              const void* taps, const void* wout, const void* dy, void* xn,
                              void* t, void* dc, void* gated, int B, int H, int W, int C, int hid,
                              float eps, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  using bo = __nv_bfloat16*;
  return (int)mp::launch_gdfn_bwd_tc((bf)x, (const float*)lnw, (const float*)lnb, (bf)win,
                                     (bf)taps, (bf)wout, (bf)dy, (bo)xn, (float*)t, (float*)dc,
                                     (bo)gated, B, H, W, C, hid, eps, (cudaStream_t)stream);
}

// Its second tile (C <= 384): dc and t (B, H, W, 2 hid) float32 from the
// first; taps and win as the first tile's, x and lnw as its; extra (B, H, W,
// C) float32 (dy, the residual) or NULL, added to dx before it rounds.
// Outputs: dt (B, H, W, 2 hid) and dx (B, H, W, C) bf16, part (tiles, 9 (2
// hid) + 2 C) float32: the tap partials [9][2 hid], then d ln_w, d ln_b.
extern "C" int mp_gdfn_dx_tc(const void* dc, const void* t, const void* taps, const void* win,
                             const void* x, const void* lnw, const void* extra, void* dt, void* dx,
                             void* part, int B, int H, int W, int C, int hid, float eps,
                             void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  auto f = [](const void* p) { return (const float*)p; };
  return (int)mp::launch_gdfn_dx_tc(f(dc), f(t), (bf)taps, (bf)win, (bf)x, f(lnw), f(extra),
                                    (__nv_bfloat16*)dt, (__nv_bfloat16*)dx, (float*)part, B, H, W,
                                    C, hid, eps, (cudaStream_t)stream);
}
