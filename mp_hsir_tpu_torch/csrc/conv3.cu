// Bias-free 3x3 convolution, stride 1, zero padding 1, over an NHWC map, with
// four writebacks: plain; res (+ a float32 residual, float32 output: the
// model's output conv plus its global input residual); down (PixelUnshuffle(2)
// in torch channel order, Downsample); up (PixelShuffle(2), Upsample).
//
// Replaces _conv3_kernel, _conv3_down_kernel and _conv3_up_kernel
// (mp_hsir_tpu/ops/pallas_attention.py:1084, :1218, :1243, K4). The TPU
// kernels shuffle with 0/1 matrix products on the MXU; here the shuffle is the
// index of the store.
//
// Bound on this card: operations, 18*Cin*Cout flops per pixel against
// (Cin + Cout) elements of traffic. So the kernel is an implicit GEMM on the
// tensor cores: M = output pixels, N = Cout, K = 9 taps x Cin. One block owns
// a 16x16 tile of output pixels (M = 256) and 64 output channels (blockIdx.x
// walks the Cout tiles); 8 warps of 64x32 (four rows of 16 pixels). The K
// loop streams Cin in chunks of 16: per chunk the block stages, three stages
// deep with cp.async, the bf16 halo (18x18 pixels x 16 channels, pixel stride
// 24 so that ldmatrix rows are 16-byte aligned and conflict-free) and the
// weight slab (9 taps x 16 x 64, 16-byte columns XOR-swizzled by k), then
// runs the 9 taps as mma.sync m16n8k16 (bf16 in, float32 sums). The A rows of
// tap (dy, dx) are the halo rows shifted by (dy, dx): no im2col buffer, and
// the fragments of one halo row serve the three dy taps of the rows they
// feed (6 A loads per 3 taps instead of 12). Each weight is staged once per
// block and chunk and reused over 256 pixels; shared memory is one
// compile-time plan whatever Cin is. The wrapper packs the weight into the
// staged layout, zero-padded to the chunk and the tile. Out-of-image halo
// pixels and channels past Cin are zero-filled (cp.async with a source size
// of 0); a Cin whose pixel rows are not 16-byte aligned (31, 100) stages the
// halo by element instead. Out-of-map rows and columns (H, W % 16 == 8) and channels
// past Cout are masked at the store; the sums are rounded once, there, to
// the output type. No atomics, no split K: the result is deterministic.
//
// float32 (the checks and the float32 CLI) runs the same tile map on the
// tensor cores in 3xTF32 (m16n8k8 mma.sync; each operand split into big =
// tf32(x) and small = tf32(x - big), three products per step, each step's
// products summed from zero there and added to float32 registers: the
// common.cuh helpers of the float32 tail tile). Its K chunk is 8 input
// channels, one k8 step per tap: the halo [324][12] (48-byte pixel rows,
// eight consecutive pixels on eight distinct bank groups, 16-byte cp.async
// where Cin % 4 == 0 and x is 16-byte aligned, else element by element) and
// the weight slab [9 taps][64 out][8 in] (the wrapper's float32 pack; each
// row's two 16-byte halves swapped on rows n with n / 4 odd, so that the
// eight rows an ldmatrix reads fall on eight distinct bank groups). A stage
// is 33,984 B in both types, so the float32 plan is the bf16 plan's 101,952 B
// (two blocks per SM). The fragments are loaded as float32 by ldmatrix and
// split in registers: B once per tap for the warp's four n8 tiles, A once
// per tap and m16 tile.
// Later work: wgmma with A from registers over the tap-shifted halo, TMA.
#include "common.cuh"

namespace mp {

enum Conv3Mode { kPlain = 0, kRes = 1, kDown = 2, kUp = 3 };

constexpr int kC3Threads = 256;             // 8 warps
constexpr int kC3T = 16;                    // output tile side, pre-shuffle pixels (M = 256)
constexpr int kC3HaloW = kC3T + 2;          // halo side
constexpr int kC3HaloPix = kC3HaloW * kC3HaloW;  // 324
constexpr int kC3N = 64;                    // output channels per block
constexpr int kC3K = 16;                    // bf16: input channels per K chunk
constexpr int kC3Stages = 3;
constexpr int kC3StLd = kC3N + 8;  // epilogue tile row (floats): float2 stores conflict-free per half-warp

// per compute type: input channels per K chunk (float32: one k8 step), the
// halo pixel stride in elements (bf16 48 bytes: 16-byte aligned ldmatrix
// rows, 8 consecutive pixels on 8 distinct bank groups; float32 48 bytes
// too) and the weight slab per chunk (elements)
template <typename T>
constexpr int kC3Kt = std::is_same<T, float>::value ? 8 : kC3K;
template <typename T>
constexpr int kC3Ld = std::is_same<T, float>::value ? 12 : 24;
template <typename T>
constexpr int kC3SlabT = 9 * kC3Kt<T> * kC3N;

template <typename T>
__host__ __device__ constexpr size_t c3_stage_bytes() {
  return sizeof(T) * ((size_t)kC3HaloPix * kC3Ld<T> + kC3SlabT<T>);
}
// three stages of 33,984 B in both types: 101,952 B (two blocks per SM); the
// epilogue's float32 tile (73,728 B) reuses them
template <typename T>
__host__ __device__ constexpr size_t conv3_smem() { return kC3Stages * c3_stage_bytes<T>(); }
static_assert(kC3T * kC3T * kC3StLd * sizeof(float) <= conv3_smem<__nv_bfloat16>() &&
                  kC3T * kC3T * kC3StLd * sizeof(float) <= conv3_smem<float>(),
              "the epilogue tile must fit the staging buffers");

// Stage K chunk c0 .. c0 + K - 1 (K = kC3Kt<T>) of tile (y0, x0) of image b
// into one buffer: the halo [324][ld] and the weight slab (wslab: this
// chunk's slab of the block's Cout tile, contiguous in the packed layout;
// bf16 [9][16][64], float32 [9][64][8]).
template <typename T, bool kVec>
__device__ __forceinline__ void c3_stage(T* xs, const T* __restrict__ x,
                                         const T* __restrict__ wslab, int b, int y0, int x0,
                                         int H, int W, int Cin, int c0) {
  constexpr int ld = kC3Ld<T>, per16 = 16 / (int)sizeof(T), K = kC3Kt<T>;
  T* ws = xs + kC3HaloPix * ld;
  for (int u = threadIdx.x; u < kC3SlabT<T> / per16; u += kC3Threads) {
    int dst;
    if constexpr (!std::is_same<T, float>::value) {
      // row = tap * 16 + k of 64 bf16 (eight 16-byte columns); column
      // ch lands at ch ^ (k & 7): the eight k rows an ldmatrix reads at one
      // column fall on eight distinct bank groups
      const int row = u >> 3, ch = u & 7;
      dst = row * kC3N + ((ch ^ (row & 7)) << 3);
    } else {
      // row = tap * 64 + n of 8 floats (two 16-byte halves); half h lands
      // at h ^ (n / 4 % 2): the eight n rows an ldmatrix reads at one half
      // fall on eight distinct bank groups
      const int row = u >> 1, h = u & 1;
      dst = row * 8 + 4 * (h ^ ((row >> 2) & 1));
    }
    cp_async16(smem_u32(ws + dst), wslab + u * per16, 16);
  }
  if constexpr (kVec) {  // Cin % per16 == 0: 16-byte copies of per16 channels
    for (int u = threadIdx.x; u < kC3HaloPix * (K / per16); u += kC3Threads) {
      const int p = u / (K / per16), g = u % (K / per16);
      const int r = y0 - 1 + p / kC3HaloW, c = x0 - 1 + p % kC3HaloW, k = c0 + per16 * g;
      const bool in = r >= 0 && r < H && c >= 0 && c < W && k < Cin;
      const T* src = in ? x + (((size_t)b * H + r) * W + c) * Cin + k : x;
      cp_async16(smem_u32(xs + p * ld + per16 * g), src, in ? 16 : 0);
    }
  } else {  // pixel rows not 16-byte aligned: element by element
    for (int u = threadIdx.x; u < kC3HaloPix * K; u += kC3Threads) {
      const int p = u / K, j = u - p * K;
      const int r = y0 - 1 + p / kC3HaloW, c = x0 - 1 + p % kC3HaloW, k = c0 + j;
      xs[p * ld + j] = (r >= 0 && r < H && c >= 0 && c < W && k < Cin)
                           ? x[(((size_t)b * H + r) * W + c) * Cin + k]
                           : from_f<T>(0.f);
    }
  }
}

// One staged chunk on the tensor cores. Warp (wm, wn) owns output rows
// 4 wm .. 4 wm + 3 of the tile (one m16 tile each: the 16 pixels of a row) and
// channels 32 wn .. 32 wn + 31 (four n8 tiles). acc[(mt * 4 + nt) * 4 + q] is
// the m16n8 accumulator fragment q of (mt, nt). Per column shift dx the warp
// loads the A fragments of its six halo rows once; row mt + dy feeds m16
// tile mt at tap (dy, dx).
__device__ __forceinline__ void c3_mma_chunk(const __nv_bfloat16* xs, float* acc, int wm, int wn,
                                             int lane) {
  constexpr int ld = kC3Ld<__nv_bfloat16>;
  const __nv_bfloat16* ws = xs + kC3HaloPix * ld;
  const int i = lane & 7, j = lane >> 3;
  // A: lane gives row i + 8 (j & 1) of the m16 tile (pixel column) at k
  // offset 8 (j >> 1): matrices a0..a3 in order
  const uint32_t a0 = smem_u32(xs + (4 * wm * kC3HaloW + i + 8 * (j & 1)) * ld + 8 * (j >> 1));
  // B ([k][n], transposed on load): lane gives k row 8 (j & 1) + i of n
  // column 4 wn + 2 p + (j >> 1): b0, b1 of n8 tile 2p, then of 2p + 1
  uint32_t b0[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    b0[p] = smem_u32(ws + (8 * (j & 1) + i) * kC3N + (((4 * wn + 2 * p + (j >> 1)) ^ i) << 3));
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    uint32_t a[6][4];
#pragma unroll
    for (int r = 0; r < 6; ++r) ldmatrix_x4(a[r], a0 + 2 * ((r * kC3HaloW + dx) * ld));
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      uint32_t bq[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(bq[p], b0[p] + 2 * ((dy * 3 + dx) * kC3K * kC3N));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16x8x16(acc + (mt * 4 + nt) * 4, a[mt + dy][0], a[mt + dy][1], a[mt + dy][2],
                      a[mt + dy][3], bq[nt >> 1][2 * (nt & 1)], bq[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
}

// One staged chunk in 3xTF32 (float32): c3_mma_chunk's warp map, one k8
// step (the chunk's 8 channels) per tap. Per tap the warp loads and splits
// the B fragments of its four n8 tiles (two ldmatrix on the swizzled slab),
// then per m16 tile the A fragment of halo row mt + dy at column shift dx
// (float32 rows of 4 by ldmatrix: lane l gets pixel l / 4, channel l % 4 and
// + 4, the m16n8k8 TF32 layout), split, and the four n8 tiles' products.
// acc[(mt * 4 + nt) * 4 + q] as in c3_mma_chunk.
__device__ __forceinline__ void c3_tf32_chunk(const float* xs, float* acc, int wm, int wn,
                                              int lane) {
  constexpr int ld = kC3Ld<float>;
  const float* ws = xs + kC3HaloPix * ld;
  // A: lane gives pixel column lane % 16 of the m16 tile at channel offset
  // 4 (lane / 16): matrices a0..a3 in order
  const uint32_t a0 = smem_u32(xs + (4 * wm * kC3HaloW + (lane & 15)) * ld + 4 * (lane >> 4));
  // B ([n][k] rows of 8): lane gives n row 32 wn + 16 p + nr at channel half
  // lane / 8 % 2 (swizzled as c3_stage stores it; 16 p keeps n / 4 % 2): b0,
  // b1 of n8 tile 2p, then of 2p + 1
  const int nr = (lane & 7) + 8 * (lane >> 4);
  const uint32_t b0 =
      smem_u32(ws + (32 * wn + nr) * 8 + 4 * (((lane >> 3) & 1) ^ ((nr >> 2) & 1)));
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - 3 * dy;
    uint32_t bb[2][4], bs[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t bv[4];
      ldmatrix_x4(bv, b0 + 4 * ((tap * kC3N + 16 * p) * 8));
      split_tf32(bv, bb[p], bs[p]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t av[4], ab[4], as[4];
      ldmatrix_x4(av, a0 + 4 * (((mt + dy) * kC3HaloW + dx) * ld));
      split_tf32(av, ab, as);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = nt >> 1, q = 2 * (nt & 1);
        mma_3xtf32(acc + (mt * 4 + nt) * 4, ab, as, bb[p][q], bb[p][q + 1], bs[p][q],
                   bs[p][q + 1]);
      }
    }
  }
}

// The epilogue. The block's float32 sums are staged in shared memory as
// st[256 pixels][kC3StLd] (pixel = row * 16 + column of the tile, channel
// n - n0), then written in the mode's output layout, where the block's
// outputs are runs of contiguous channels ("segments"): plain / res one run
// of nc channels per pixel; down one run of 4 nc per output pixel (channel
// 4 j + 2 (y % 2) + x % 2); up one run of nc / 4 per output pixel (channel
// j / 4 of pixel (2y + j / 2 % 2, 2x + j % 2)). Runs are stored as 16-byte
// vectors where the output row allows it, else element by element. Each
// value is rounded once, to the output type.

template <typename O>
__device__ __forceinline__ void c3_put(O* __restrict__ o, const float* v, int n);
template <>
__device__ __forceinline__ void c3_put<float>(float* __restrict__ o, const float* v, int n) {
  if (n == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < n; ++i) o[i] = v[i];
  }
}
template <>
__device__ __forceinline__ void c3_put<__nv_bfloat16>(__nv_bfloat16* __restrict__ o, const float* v,
                                                     int n) {
  if (n == 8) {
    *reinterpret_cast<uint4*>(o) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
    for (int i = 0; i < n; ++i) o[i] = __float2bfloat16(v[i]);
  }
}

template <typename O>
__device__ __forceinline__ void c3_write(const float* st, O* __restrict__ out,
                                         const float* __restrict__ res, int b, int y0, int x0,
                                         int n0, int H, int W, int Cout, int mode) {
  constexpr int V = 16 / (int)sizeof(O);
  const int nc = min(kC3N, Cout - n0);
  // segments, run length, output row width (channels)
  const int segs = mode == kDown ? kC3T * kC3T / 4 : mode == kUp ? 4 * kC3T * kC3T : kC3T * kC3T;
  const int len = mode == kDown ? 4 * nc : mode == kUp ? nc / 4 : nc;
  const int row = mode == kDown ? 4 * Cout : mode == kUp ? Cout / 4 : Cout;
  const int per = row % V == 0 ? V : 1;  // then len % V == 0 too: nc is Cout or 64
  const int units = len / per;
  for (int u = threadIdx.x; u < segs * units; u += kC3Threads) {
    const int sg = u / units, e0 = (u - sg * units) * per;
    int y, xc;  // the segment's pre-shuffle pixel (its top-left one for down)
    size_t o;
    if (mode == kDown) {
      y = y0 + 2 * (sg >> 3), xc = x0 + 2 * (sg & 7);
      o = (((size_t)b * (H / 2) + (y >> 1)) * (W / 2) + (xc >> 1)) * row + 4 * n0;
    } else if (mode == kUp) {
      const int oy = sg >> 5, ox = sg & 31;
      y = y0 + (oy >> 1), xc = x0 + (ox >> 1);
      o = (((size_t)b * (2 * H) + 2 * y0 + oy) * (2 * W) + 2 * x0 + ox) * row + n0 / 4;
    } else {
      y = y0 + (sg >> 4), xc = x0 + (sg & 15);
      o = (((size_t)b * H + y) * W + xc) * row + n0;
    }
    if (y >= H || xc >= W) continue;
    float v[V];
    for (int i = 0; i < per; ++i) {
      const int e = e0 + i;
      int p, j;  // tile pixel, channel in the tile
      if (mode == kDown) {
        j = e >> 2;
        p = (2 * (sg >> 3) + ((e >> 1) & 1)) * kC3T + 2 * (sg & 7) + (e & 1);
      } else if (mode == kUp) {
        const int oy = sg >> 5, ox = sg & 31;
        j = 4 * e + 2 * (oy & 1) + (ox & 1);
        p = (oy >> 1) * kC3T + (ox >> 1);
      } else {
        j = e;
        p = sg;
      }
      v[i] = st[p * kC3StLd + j];
      if (mode == kRes) v[i] += res[o + e];
    }
    c3_put<O>(out + o + e0, v, per);
  }
}

// grid (Cout tiles, row tiles x column tiles, B); w is the packed weight
// [ceil(Cout/64)][ceil(Cin/K)][slab] (bf16 [9][16][64], float32 [9][64][8]).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kC3Threads, 2)
conv3_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ res,
             void* __restrict__ out, int H, int W, int Cin, int Cout, int mode) {
  extern __shared__ __align__(16) unsigned char c3_smem[];
  auto buf = [&](int c) { return (T*)(c3_smem + (c % kC3Stages) * c3_stage_bytes<T>()); };
  const int tiles_x = (W + kC3T - 1) / kC3T;
  const int n0 = blockIdx.x * kC3N, b = blockIdx.z;
  const int y0 = blockIdx.y / tiles_x * kC3T, x0 = blockIdx.y % tiles_x * kC3T;
  constexpr int K = kC3Kt<T>, slab = kC3SlabT<T>;
  const int chunks = (Cin + K - 1) / K;
  const T* wt = w + (size_t)blockIdx.x * chunks * slab;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = 0.f;

  // stages hold chunks c, c + 1, c + 2; one barrier per chunk: after it,
  // chunk c has landed for every thread and nobody still reads chunk c - 1,
  // whose buffer takes chunk c + 2
#pragma unroll
  for (int c = 0; c < kC3Stages - 1; ++c) {
    if (c < chunks)
      c3_stage<T, kVec>(buf(c), x, wt + (size_t)c * slab, b, y0, x0, H, W, Cin, c * K);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kC3Stages - 2>();
    __syncthreads();
    const int cn = c + kC3Stages - 1;
    if (cn < chunks)
      c3_stage<T, kVec>(buf(cn), x, wt + (size_t)cn * slab, b, y0, x0, H, W, Cin, cn * K);
    cp_async_commit();
    if constexpr (std::is_same<T, float>::value) {
      c3_tf32_chunk(buf(c), acc, warp & 3, warp >> 2, lane);
    } else {
      c3_mma_chunk(buf(c), acc, warp & 3, warp >> 2, lane);
    }
  }

  __syncthreads();  // every warp is done with the last chunk's buffer
  float* st = (float*)c3_smem;
  {
    const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              st + ((4 * wm + mt) * kC3T + g + 8 * h) * kC3StLd + 32 * wn + 8 * nt + 2 * t) =
              make_float2(acc[(mt * 4 + nt) * 4 + 2 * h], acc[(mt * 4 + nt) * 4 + 2 * h + 1]);
  }
  __syncthreads();
  if (mode == kRes) {
    c3_write<float>(st, (float*)out, res, b, y0, x0, n0, H, W, Cout, mode);
  } else {
    c3_write<T>(st, (T*)out, res, b, y0, x0, n0, H, W, Cout, mode);
  }
}

template <typename T, bool kVec>
cudaError_t launch_conv3(const void* x, const void* w, const float* res, void* out, int B, int H,
                         int W, int Cin, int Cout, int mode, cudaStream_t stream) {
  constexpr size_t smem = conv3_smem<T>();
  cudaError_t err = set_smem(conv3_kernel<T, kVec>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(Cout, kC3N), ceil_div(H, kC3T) * ceil_div(W, kC3T), B);
  conv3_kernel<T, kVec><<<grid, kC3Threads, smem, stream>>>((const T*)x, (const T*)w, res, out,
                                                            H, W, Cin, Cout, mode);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, Cin) in the compute type; w the packed weight in the compute
// type, zero-padded (ops/kernels/conv3.py:pack_weight): bf16
// [ceil(Cout/64)][ceil(Cin/16)][9 taps][16 in][64 out], float32
// [ceil(Cout/64)][ceil(Cin/8)][9 taps][64 out][8 in]; res float32 (B, H, W, Cout)
// for mode 1, else NULL. mode: 0 plain, 1 res (float32 output), 2 down
// (PixelUnshuffle 2), 3 up (PixelShuffle 2, Cout % 4 == 0). H, W % 8 == 0.
extern "C" int mp_conv3(const void* x, const void* w, const void* res, void* out, int dtype,
                        int B, int H, int W, int Cin, int Cout, int mode, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  if (mode == mp::kUp && Cout % 4 != 0) return (int)cudaErrorInvalidValue;
  if (mode == mp::kRes && res == nullptr) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto r = (const float*)res;
  // 16-byte halo copies need every pixel row 16-byte aligned
  if (dtype == 0) {
    if (Cin % 4 == 0 && ((uintptr_t)x & 15) == 0)
      return (int)mp::launch_conv3<float, true>(x, w, r, out, B, H, W, Cin, Cout, mode, st);
    return (int)mp::launch_conv3<float, false>(x, w, r, out, B, H, W, Cin, Cout, mode, st);
  }
  if (Cin % 8 == 0 && ((uintptr_t)x & 15) == 0)
    return (int)mp::launch_conv3<__nv_bfloat16, true>(x, w, r, out, B, H, W, Cin, Cout, mode, st);
  return (int)mp::launch_conv3<__nv_bfloat16, false>(x, w, r, out, B, H, W, Cin, Cout, mode, st);
}

// Shared-memory plan per block (bytes, static included) of the compute type
// (0 float32, 1 bf16); it does not depend on the shape.
extern "C" long long mp_conv3_smem(int dtype) {
  if (dtype == 0) return mp::plan_bytes(mp::conv3_kernel<float, true>, mp::conv3_smem<float>());
  return mp::plan_bytes(mp::conv3_kernel<__nv_bfloat16, true>, mp::conv3_smem<__nv_bfloat16>());
}
