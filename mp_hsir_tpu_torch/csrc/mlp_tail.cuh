// The PGSSTB tail MLP of one 64-pixel tile on the tensor cores:
// branch = fc2(a * gelu(g)) + b2 with [a | g] = fc1(LN2(y)) + b1. Called by
// the mlp kernel (K6, mlp.cu) and the spectral apply kernels' PGSSTB tail
// (spectral.cu), bf16 (mlp_tail_tc) and float32 (mlp_tail_f32, 3xTF32).
//
// bf16 rounding points: LN2(y) rounded to bf16; h = LN2(y) W1 + b1 summed in
// float32; gated = bf16(a * gelu_erf(g)); fc2 summed in float32 over all of
// hid; the caller adds b2 and its residual or scale and rounds once.
//
// Design (bound: 6 C hid flops per pixel against ~4C bytes, tensor-core rate;
// the weights are re-read from L2 by every tile, 64 flops per weight byte):
// - the wrapper packs the weights (ops/kernels/mlp.py pack_mlp_weights), hid
//   padded with zeros to a multiple of 64 and C to round_up64(C): fc1 as one
//   [128][CK] slab per 64-unit hidden chunk whose row 32 q + i (q < 4, i <
//   16) is a-unit 16 q + i of the chunk and row 32 q + 16 + i the same
//   unit's g-row; fc2 as its torch layout [CK][hidP] (row = output channel).
//   Zero fc1 rows with zero b1 give a = g = 0 and gated = 0; zero fc2 columns
//   add nothing.
// - LN2(y) is staged once as bf16 ([64][CK + 8], rows of an odd multiple of
//   16 bytes: ldmatrix without bank conflicts), zero past C.
// - The weights stream as [128 n][64 k] tiles ([kTailN][kTailLd]) through an
//   S-stage cp.async ring (S = 2 to 4, what the plan holds): per hidden chunk
//   CK / 64 fc1 tiles, then ceil(CK / 128) fc2 tiles of 128 (the last maybe
//   64) output channels. One block-wide barrier per tile.
// - 16 warps: warp w owns pixel rows 16 (w / 4) .. + 15. fc1: its 32 columns
//   32 (w % 4) .. of the chunk's 128, that is 16 a-units and the same 16
//   g-units, so a * gelu(g) pairs accumulators of one thread (n8 tiles 0-1
//   with 2-3); the gated chunk goes to shared memory as bf16 ([64][72]),
//   one store per value. fc2: the warp keeps a fixed 16 x (2 x 8) slice of
//   each 64-channel group of the 64 x CK output in registers across the
//   whole hidden loop (acc[2 G + h]: 8 floats per group, 48 at C = 384).
//
// The float32 twin (mlp_tail_f32) has the same tile map, ring order and
// register slice, with no rounding points: LN2(y) staged as float32 [64][CK
// + 4] (a row stride of 4 words mod 32: the fragments' (lane / 4, lane % 4)
// reads hit 32 banks), the packs in float32 streamed as [128][68] tiles
// (272-byte rows) through 2-4 stages of 34,816 B, the gated chunk float32
// [64][68], and every product on m16n8k8 TF32 mma.sync in 3xTF32: each
// fragment is loaded as float32 (ldmatrix moves 32-bit elements as pairs of
// b16) and split in registers, big = tf32(x), small = tf32(x - big) (TF32
// rounding as cvt.rna rounds, on the bits), and
// each k8 step takes small big + big small + big big on the tensor cores
// (the small x small term, ~2^-22 of the product, is dropped), then adds
// that to the float32 sum in registers (mma_3xtf32: the tensor cores' sums
// truncate): closer to the float32 product than SIMT FMA sums over K. The
// caller starts the sums (from y + b2 or b2),
// so its output never waits in shared memory; past C = 384 it runs the tile
// once per output group of at most 384 channels (fc1 recomputed per group).
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kTailK = 64;            // weight-tile depth; the hidden chunk
constexpr int kTailN = 128;           // weight-tile width: one chunk's a | g rows
constexpr int kTailLd = kTailK + 8;   // tile row stride: 144 B, an odd multiple of 16 B
constexpr int kTailLdg = kTailK + 8;  // gated chunk row stride
constexpr int kTailMaxC = 384;        // fc2's output slice is held in registers up to C = 384
constexpr int kTailGroups = kTailMaxC / 64;  // 64-channel output groups a warp holds
constexpr int kTailStages = 4;        // ring stages at most
constexpr size_t kTailStage = sizeof(__nv_bfloat16) * kTailN * kTailLd;  // 18,432 B
// float32: tile and gated-chunk rows of 68 floats (272 B, 4 words mod 32)
constexpr int kTailLdF = kTailK + 4;
constexpr size_t kTailStageF = sizeof(float) * kTailN * kTailLdF;  // 34,816 B
// the dynamic bytes a float32 tail plan may take: the H100's opt-in limit
// less 1 KB for the kernels' static shared memory
constexpr size_t kTailF32Budget = 232448 - 1024;

__host__ __device__ constexpr int round_up64(int n) { return (n + 63) / 64 * 64; }

// Bytes of the tail's scratch at width C with S ring stages: LN2(y), the
// gated chunk, the ring (every piece a multiple of 16 bytes).
__host__ __device__ constexpr size_t tail_scratch_bytes(int C, int S) {
  return sizeof(__nv_bfloat16) * ((size_t)kPix * (round_up64(C) + 8) + (size_t)kPix * kTailLdg) +
         (size_t)S * kTailStage;
}

// The ring stages that `bytes` of scratch hold (at most kTailStages).
__host__ __device__ constexpr int tail_stages(int C, size_t bytes) {
  return bytes < tail_scratch_bytes(C, 0) ? 0
       : (bytes - tail_scratch_bytes(C, 0)) / kTailStage > (size_t)kTailStages
           ? kTailStages
           : (int)((bytes - tail_scratch_bytes(C, 0)) / kTailStage);
}

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// The weight stream: tile t is, in hidden chunk t / per, fc1 depth chunk i
// (i < nk1) or fc2 channel chunk i - nk1 (i < nk1 + nk2, channels n0 + 128
// (i - nk1) .. of the output group from n0, at most kTailMaxC wide), with i
// = t % per; the backward (kBack) streams each chunk's fc1 slab once more
// after its fc2 tiles (i - nk1 - nk2, the dx product's depth chunks), so per
// = nk1 + nk2 (+ nk1). Tile t goes to stage t % S. issue() copies the next
// tile and consume() hands out the oldest; both walk their cursors without
// divisions. E: the packs' element type (bf16 or float32).
template <bool kBack, typename E = __nv_bfloat16>
struct TailRingT {
  static constexpr int kLd = sizeof(E) == 2 ? kTailLd : kTailLdF;  // tile row stride
  static constexpr int kVecLog = sizeof(E) == 2 ? 3 : 2;           // log2 elements per 16 B
  const E* w1p;  // [hidP / 64][128][CK]
  const E* w2p;  // [CK][hidP]
  E* ring;       // [S][kTailN][kLd]
  int S, CK, hidP, n0, nk1, nk2, T;
  int it = 0, ichunk = 0, ipos = 0, istage = 0;  // the next tile to copy
  int cstage = 0;                                // the stage of the next tile to use

  __device__ TailRingT(const E* w1, const E* w2, E* r, int s, int C, int hid, int n_first = 0)
      : w1p(w1), w2p(w2), ring(r), S(s), CK(round_up64(C)), hidP(round_up64(hid)), n0(n_first) {
    nk1 = CK / kTailK;
    nk2 = (min(kTailMaxC, CK - n0) + kTailN - 1) / kTailN;
    T = hidP / kTailK * (nk1 + nk2 + (kBack ? nk1 : 0));
  }

  // copy the next tile (nothing past the last) into its stage; one commit group
  __device__ void issue() {
    if (it < T) {
      const E* src;
      int rows, ld, pos = ipos;
      if (kBack && pos >= nk1 + nk2) pos -= nk1 + nk2;  // the slab again
      if (pos < nk1) {
        src = w1p + (size_t)ichunk * kTailN * CK + pos * kTailK;
        rows = kTailN;
        ld = CK;
      } else {
        const int n = n0 + (pos - nk1) * kTailN;
        src = w2p + (size_t)n * hidP + ichunk * kTailK;
        rows = min(kTailN, CK - n);
        ld = hidP;
      }
      E* dst = ring + istage * kTailN * kLd;
      constexpr int units = kTailK >> kVecLog;  // 16-byte copies per row
      for (int u = threadIdx.x; u < rows * units; u += blockDim.x) {
        const int r = u >> (6 - kVecLog), c = (u & (units - 1)) << kVecLog;
        cp_async16(smem_u32(dst + r * kLd + c), src + (size_t)r * ld + c, 16);
      }
      if (++ipos == nk1 + nk2 + (kBack ? nk1 : 0)) {
        ipos = 0;
        ++ichunk;
      }
      if (++istage == S) istage = 0;
    }
    ++it;
    cp_async_commit();
  }

  // the first S - 1 tiles, issued before the caller stages LN2(y)
  __device__ void prefetch() {
    for (int t = 0; t < S - 1; ++t) issue();
  }

  // the next tile: waits for it, passes one block-wide barrier (after it
  // nobody reads the previous tile, whose stage takes the tile issued here)
  __device__ const E* consume() {
    cp_async_wait_upto(S - 2);
    __syncthreads();
    issue();
    const E* tile = ring + cstage * kTailN * kLd;
    if (++cstage == S) cstage = 0;
    return tile;
  }
};
using TailRing = TailRingT<false>;
using TailRingF = TailRingT<false, float>;

// Rows of 64 tile pixels from global memory (row i at src + row(i) * C) to
// shared memory ([64][ldd], bf16 or float32 as src), zero from C to CK:
// 16-byte cp.async where vec (C a multiple of 16 bytes, 16-byte aligned rows;
// the caller commits), else element by element.
template <typename E, typename Row>
__device__ __forceinline__ void stage_rows(E* dst, int ldd, const E* src, int C, int CK, bool vec,
                                           Row row) {
  constexpr int V = 16 / sizeof(E);  // elements per copy
  if (vec) {
    const int units = CK / V;
    for (int u = threadIdx.x; u < kPix * units; u += blockDim.x) {
      const int i = u / units, c = (u - i * units) * V;
      const bool in = c < C;
      cp_async16(smem_u32(dst + i * ldd + c), in ? src + row(i) * C + c : src, in ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * CK; u += blockDim.x) {
      const int i = u / CK, c = u - i * CK;
      dst[i * ldd + c] = c < C ? src[row(i) * C + c] : from_f<E>(0.f);
    }
  }
}

// LayerNorm of the tile's 64 rows (channel k of row i read as src(i, k)),
// as ln_rows_inplace computes it (one warp per row, lane-strided float32
// sums), into dst ([64][ldd], rounded to bf16 or float32); zero from C to
// round_up64(C). src may read dst itself (each lane rewrites only the
// elements it read). stats: where not null, row i's mean and rstd go to
// stats[i], stats[64 + i].
template <typename Src, typename E>
__device__ __forceinline__ void tail_ln(Src src, E* dst, int ldd, int C,
                                        const float* __restrict__ w, const float* __restrict__ b,
                                        float eps, float* stats = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, CK = round_up64(C);
  for (int i = warp; i < kPix; i += blockDim.x >> 5) {
    float sum = 0.f;
    for (int k = lane; k < C; k += 32) sum += src(i, k);
    const float mu = warp_sum(sum) / C;
    float var = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = src(i, k) - mu;
      var += d * d;
    }
    const float rs = rsqrtf(warp_sum(var) / C + eps);
    if (stats != nullptr && lane == 0) {
      stats[i] = mu;
      stats[kPix + i] = rs;
    }
    for (int k = lane; k < CK; k += 32)
      dst[i * ldd + k] = from_f<E>(k < C ? (src(i, k) - mu) * rs * w[k] + b[k] : 0.f);
  }
}

// One fc2 tile: acc (the warp's slice of the output, see tail_out) += the
// gated chunk ([64][kTailLdg] bf16; a: the lane's ldmatrix address at its
// warp's rows) x the tile's output groups g0 and g0 + 1 (of `groups`); b: the
// lane's address in the [kTailN][kTailLd] tile at the warp's 16 columns.
__device__ __forceinline__ void tail_fc2(float (&acc)[2 * kTailGroups][4], uint32_t a, uint32_t b,
                                         int g0, int groups) {
#pragma unroll
  for (int kk = 0; kk < kTailK / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + 2 * 16 * kk);
#pragma unroll
    for (int G = 0; G < kTailGroups; ++G) {
      if (G >= g0 && G < g0 + 2 && G < groups) {  // warp-uniform
        uint32_t bf[4];
        ldmatrix_x4(bf, b + 2 * ((G - g0) * 64 * kTailLd + 16 * kk));
        mma_16x8x16(acc[2 * G], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_16x8x16(acc[2 * G + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
    }
  }
}

// fc1 of one hidden chunk from the ring's next nk1 (slab depth) tiles: h =
// the warp's 16 rows x (16 a | 16 g) columns of the chunk, without b1. a1:
// the lane's ldmatrix address of LN2(y) at the warp's rows; boff: the lane's
// offset in a [kTailN][kTailLd] tile (see mlp_tail_tc); wc = warp % 4.
// h[nt] (nt < 2) is a-unit 16 wc + 8 nt + 2 (lane % 4) (+1) of rows lane / 4
// (+8) of the warp's 16, h[nt + 2] the same units' g.
template <typename Ring>
__device__ __forceinline__ void tail_fc1(float (&h)[4][4], uint32_t a1, Ring& rg, int wc,
                                         int boff) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[q][e] = 0.f;
  for (int kt = 0; kt < rg.nk1; ++kt) {
    const uint32_t b = smem_u32(rg.consume() + 32 * wc * kTailLd + boff);
#pragma unroll
    for (int kk = 0; kk < kTailK / 16; ++kk) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, a1 + 2 * (kt * kTailK + 16 * kk));
      ldmatrix_x4(bf, b + 2 * 16 * kk);
      mma_16x8x16(h[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_16x8x16(h[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      ldmatrix_x4(bf, b + 2 * (16 * kTailLd + 16 * kk));
      mma_16x8x16(h[2], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_16x8x16(h[3], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

// The hidden loop. xn: LN2(y) as bf16 ([64][ldx], zero from C to CK); gs:
// the gated chunk ([64][kTailLdg]); rg: the weight stream, its first S - 1
// tiles issued. acc gets the fc2 sums of the warp's slice (without b2); see
// tail_out for its layout. Its first step is a block-wide barrier, so xn
// must be complete when it is called. When a thread returns, no thread
// reads xn any more (every fc1 tile came before the last fc2 tile's
// barrier): the caller may stage its output there.
__device__ __forceinline__ void mlp_tail_tc(float (&acc)[2 * kTailGroups][4],
                                            const __nv_bfloat16* xn, int ldx, __nv_bfloat16* gs,
                                            TailRing& rg, const float* __restrict__ b1,
                                            int hid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int r0 = 16 * wr + (lane >> 2), r1 = r0 + 8;
  const int groups = rg.CK / 64;
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  // A: lane gives row lane % 16 at k offset 8 (lane / 16). B ([n][k] tiles):
  // lane gives n row (lane % 8) + 8 (lane / 16) at k offset 8 (lane / 8 % 2).
  const uint32_t a1 = smem_u32(xn + (16 * wr + (lane & 15)) * ldx + 8 * (lane >> 4));
  const uint32_t a2 = smem_u32(gs + (16 * wr + (lane & 15)) * kTailLdg + 8 * (lane >> 4));
  const int boff = ((lane & 7) + 8 * (lane >> 4)) * kTailLd + 8 * ((lane >> 3) & 1);
  for (int j = 0; j < rg.hidP / kTailK; ++j) {
    float h[4][4];
    tail_fc1(h, a1, rg, wc, boff);
    // + b1, a * gelu(g), rounded: unit 16 wc + 8 nt + 2 t4 (+1) of the chunk
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 16 * wc + 8 * nt + 2 * t4, u = j * kTailK + col;
      const float ba0 = u < hid ? b1[u] : 0.f, ba1 = u + 1 < hid ? b1[u + 1] : 0.f;
      const float bg0 = u < hid ? b1[hid + u] : 0.f, bg1 = u + 1 < hid ? b1[hid + u + 1] : 0.f;
      const float* a = h[nt];
      const float* g = h[nt + 2];
      *reinterpret_cast<uint32_t*>(gs + r0 * kTailLdg + col) =
          pack_bf16x2((a[0] + ba0) * gelu_erf(g[0] + bg0), (a[1] + ba1) * gelu_erf(g[1] + bg1));
      *reinterpret_cast<uint32_t*>(gs + r1 * kTailLdg + col) =
          pack_bf16x2((a[2] + ba0) * gelu_erf(g[2] + bg0), (a[3] + ba1) * gelu_erf(g[3] + bg1));
    }
    // fc2: tile i holds output groups 2 i and 2 i + 1 (64 channels each);
    // the barrier of its consume() makes the gated chunk visible
    for (int i = 0; i < rg.nk2; ++i)
      tail_fc2(acc, a2, smem_u32(rg.consume() + 16 * wc * kTailLd + boff), 2 * i, groups);
  }
}

// Each of the thread's fc2 sums with its pixel row and channel: f(i, k, v)
// for k < C. acc[2 G + h][e] is row 16 (w / 4) + lane / 4 (+ 8 for e >= 2),
// channel 64 G + 16 (w % 4) + 8 h + 2 (lane % 4) + e % 2.
template <typename F>
__device__ __forceinline__ void tail_out(const float (&acc)[2 * kTailGroups][4], int C, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp >> 2) + (lane >> 2);
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q) {
    const int col = 64 * (q >> 1) + 16 * (warp & 3) + 8 * (q & 1) + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + (e & 1) < C) f(r0 + 8 * (e >> 1), col + (e & 1), acc[q][e]);
  }
}

// Rows of 64 tile pixels from shared memory (bf16, [64][lds]) to global
// memory: pixel i's row at dst(i); v(i, k, value) gives the value stored.
// 16-byte runs where vec (C % 8 == 0 and every row 16-byte aligned).
template <typename Dst, typename V>
__device__ __forceinline__ void tail_store(const __nv_bfloat16* s, int lds, int C, bool vec,
                                           Dst dst, V v) {
  if (vec) {
    const int units = C / 8;
    for (int u = threadIdx.x; u < kPix * units; u += blockDim.x) {
      const int i = u / units, c = (u - i * units) * 8;
      uint4 in = *reinterpret_cast<const uint4*>(s + i * lds + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&in);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        o[e] = pack_bf16x2(v(i, c + 2 * e, f.x), v(i, c + 2 * e + 1, f.y));
      }
      *reinterpret_cast<uint4*>(dst(i) + c) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int u = threadIdx.x; u < kPix * C; u += blockDim.x) {
      const int i = u / C, k = u - i * C;
      dst(i)[k] = __float2bfloat16(v(i, k, __bfloat162float(s[i * lds + k])));
    }
  }
}


// ---------------------------------------------------------------------------
// float32: the same tile on m16n8k8 TF32 mma.sync in 3xTF32
// ---------------------------------------------------------------------------

// Bytes of the float32 tail's scratch at width C with S ring stages: LN2(y)
// [64][CK + 4], the gated chunk [64][kTailLdF], the ring.
__host__ __device__ constexpr size_t tail_f32_bytes(int C, int S) {
  return sizeof(float) * ((size_t)kPix * (round_up64(C) + 4) + (size_t)kPix * kTailLdF) +
         (size_t)S * kTailStageF;
}

// The float32 ring's stages at width C: as many as kTailF32Budget holds, 2 to 4.
__host__ __device__ inline int tail_f32_stages(int C) {
  int s = kTailStages;
  while (s > 2 && tail_f32_bytes(C, s) > kTailF32Budget) --s;
  return s;
}

// fc1 of one hidden chunk in 3xTF32, tail_fc1's map on float32 [128][kTailLdF]
// tiles: h[nt] (nt < 2) a-units 16 wc + 8 nt + 2 (lane % 4) (+1), h[nt + 2]
// their g. a1: the lane's ldmatrix address of LN2(y) (row lane % 16 of the
// warp's, k offset 4 (lane / 16) floats); boff: the lane's byte offset in a
// tile (see mma_pair_f32).
__device__ __forceinline__ void tail_fc1_f32(float (&h)[4][4], uint32_t a1, TailRingF& rg,
                                             int wc, uint32_t boff) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[q][e] = 0.f;
  for (int kt = 0; kt < rg.nk1; ++kt) {
    const uint32_t b = smem_u32(rg.consume() + 32 * wc * kTailLdF) + boff;
#pragma unroll
    for (int kk = 0; kk < kTailK / 8; ++kk) {
      uint32_t av[4], ab[4], as[4];
      ldmatrix_x4(av, a1 + 4 * (kt * kTailK + 8 * kk));
      split_tf32(av, ab, as);
      // slab rows 0-15 of the warp's 32: its a-units; 16-31: their g
      mma_pair_f32(h[0], h[1], ab, as, b + 4 * 8 * kk);
      mma_pair_f32(h[2], h[3], ab, as, b + 4 * (16 * kTailLdF + 8 * kk));
    }
  }
}

// One fc2 tile in 3xTF32: acc += the gated chunk (float32 [64][kTailLdF]; a:
// the lane's address at its warp's rows) x the tile's output groups g0, g0 +
// 1 (of `groups`); b: the lane's address at the warp's 16 columns.
__device__ __forceinline__ void tail_fc2_f32(float (&acc)[2 * kTailGroups][4], uint32_t a,
                                             uint32_t b, int g0, int groups) {
#pragma unroll
  for (int kk = 0; kk < kTailK / 8; ++kk) {
    uint32_t av[4], ab[4], as[4];
    ldmatrix_x4(av, a + 4 * 8 * kk);
    split_tf32(av, ab, as);
#pragma unroll
    for (int G = 0; G < kTailGroups; ++G) {
      if (G >= g0 && G < g0 + 2 && G < groups)  // warp-uniform
        mma_pair_f32(acc[2 * G], acc[2 * G + 1], ab, as,
                     b + 4 * ((G - g0) * 64 * kTailLdF + 8 * kk));
    }
  }
}

// The float32 hidden loop for the ring's output group (channels rg.n0 ..
// + 383 at most): acc (tail_out's layout, group-relative channels) += fc2(a
// * gelu(g)) over all of hid, acc as the caller started it. xn: LN2(y)
// float32 ([64][ldx], ldx = CK + 4, zero from C to CK); gs: the gated chunk
// ([64][kTailLdF]); rg: the weight stream, its first S - 1 tiles issued. Its
// first step is a block-wide barrier, so xn must be complete when it is
// called; xn is left as it was (a later group reads it again).
__device__ __forceinline__ void mlp_tail_f32(float (&acc)[2 * kTailGroups][4], const float* xn,
                                             int ldx, float* gs, TailRingF& rg,
                                             const float* __restrict__ b1, int hid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int r0 = 16 * wr + (lane >> 2), r1 = r0 + 8;
  const int groups = min(kTailGroups, (rg.CK - rg.n0) / 64);
  const uint32_t a1 = smem_u32(xn + (16 * wr + (lane & 15)) * ldx + 4 * (lane >> 4));
  const uint32_t a2 = smem_u32(gs + (16 * wr + (lane & 15)) * kTailLdF + 4 * (lane >> 4));
  const uint32_t boff = 4 * (((lane & 7) + 8 * (lane >> 4)) * kTailLdF + 4 * ((lane >> 3) & 1));
  for (int j = 0; j < rg.hidP / kTailK; ++j) {
    float h[4][4];
    tail_fc1_f32(h, a1, rg, wc, boff);
    // + b1, a * gelu(g): unit 16 wc + 8 nt + 2 t4 (+1) of the chunk
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 16 * wc + 8 * nt + 2 * t4, u = j * kTailK + col;
      const float ba0 = u < hid ? b1[u] : 0.f, ba1 = u + 1 < hid ? b1[u + 1] : 0.f;
      const float bg0 = u < hid ? b1[hid + u] : 0.f, bg1 = u + 1 < hid ? b1[hid + u + 1] : 0.f;
      const float* a = h[nt];
      const float* g = h[nt + 2];
      *reinterpret_cast<float2*>(gs + r0 * kTailLdF + col) =
          make_float2((a[0] + ba0) * gelu_erf(g[0] + bg0), (a[1] + ba1) * gelu_erf(g[1] + bg1));
      *reinterpret_cast<float2*>(gs + r1 * kTailLdF + col) =
          make_float2((a[2] + ba0) * gelu_erf(g[2] + bg0), (a[3] + ba1) * gelu_erf(g[3] + bg1));
    }
    // fc2: tile i holds output groups 2 i and 2 i + 1; its consume()'s
    // barrier makes the gated chunk visible
    for (int i = 0; i < rg.nk2; ++i)
      tail_fc2_f32(acc, a2, smem_u32(rg.consume() + 16 * wc * kTailLdF) + boff, 2 * i, groups);
  }
}

// Starts the sums of tail_out's layout: acc[q][e] = f(row, channel) for
// channel < C, zero past it.
template <typename F>
__device__ __forceinline__ void tail_init(float (&acc)[2 * kTailGroups][4], int C, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp >> 2) + (lane >> 2);
#pragma unroll
  for (int q = 0; q < 2 * kTailGroups; ++q) {
    const int col = 64 * (q >> 1) + 16 * (warp & 3) + 8 * (q & 1) + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[q][e] = col + (e & 1) < C ? f(r0 + 8 * (e >> 1), col + (e & 1)) : 0.f;
  }
}

}  // namespace mp
