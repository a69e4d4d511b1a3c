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
// One block = one 8x8 output tile (pre-shuffle coordinates) and all output
// channels: the 10x10 input halo is staged once in shared memory and reused by
// all 9 taps. Bound on this card: 18*Cin*Cout flops per pixel against
// (Cin + Cout) elements of traffic, tensor-core rate at these widths; this
// version runs SIMT FMA (see PERF.md).
#include "common.cuh"

namespace mp {

enum Conv3Mode { kPlain = 0, kRes = 1, kDown = 2, kUp = 3 };
constexpr int kConvThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv3_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ res,
             void* __restrict__ out, int H, int W, int Cin, int Cout, int mode) {
  extern __shared__ float sm[];
  const int ldx = Cin + 1;
  float* xs = sm;  // [100][ldx]
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;

  for (int idx = threadIdx.x; idx < kHaloPix * Cin; idx += blockDim.x) {
    const int p = idx / Cin, k = idx - p * Cin;
    const int r = ty * kTile + p / kHalo - 1, c = tx * kTile + p % kHalo - 1;
    xs[p * ldx + k] = (r >= 0 && r < H && c >= 0 && c < W)
                          ? to_f(x[(((size_t)b * H + r) * W + c) * Cin + k])
                          : 0.f;
  }
  __syncthreads();

  const int tiles_n = (Cout + 3) >> 2;
  const int tiles = (kPix >> 2) * tiles_n;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int i0 = (t / tiles_n) << 2;
    const int j0 = (t % tiles_n) << 2;
    const int nc = min(4, Cout - j0);
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const float* arow[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        arow[r] = xs + (((i >> 3) + dy) * kHalo + (i & 7) + dx) * ldx;
      }
      const T* wt = w + (size_t)tap * Cin * Cout + j0;
      for (int k = 0; k < Cin; ++k) {
        float bv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = c < nc ? to_f(wt[(size_t)k * Cout + c]) : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = arow[r][k];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a, bv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      const int y = ty * kTile + (i >> 3), xc = tx * kTile + (i & 7);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) continue;
        const int j = j0 + c;
        const float v = acc[r][c];
        if (mode == kPlain) {
          ((T*)out)[(((size_t)b * H + y) * W + xc) * Cout + j] = from_f<T>(v);
        } else if (mode == kRes) {
          const size_t o = (((size_t)b * H + y) * W + xc) * Cout + j;
          ((float*)out)[o] = v + res[o];
        } else if (mode == kDown) {
          // out[b, y/2, x/2, j*4 + (y%2)*2 + x%2], (B, H/2, W/2, 4*Cout)
          const size_t o = (((size_t)b * (H / 2) + (y >> 1)) * (W / 2) + (xc >> 1)) * (4 * Cout) +
                           j * 4 + (y & 1) * 2 + (xc & 1);
          ((T*)out)[o] = from_f<T>(v);
        } else {
          // channel j = ch*4 + i2*2 + j2 -> out[b, 2y+i2, 2x+j2, ch], (B, 2H, 2W, Cout/4)
          const int co = Cout >> 2, ch = j >> 2, i2 = (j >> 1) & 1, j2 = j & 1;
          const size_t o = (((size_t)b * (2 * H) + 2 * y + i2) * (2 * W) + 2 * xc + j2) * co + ch;
          ((T*)out)[o] = from_f<T>(v);
        }
      }
    }
  }
}

inline size_t conv3_smem(int Cin) { return sizeof(float) * (size_t)kHaloPix * (Cin + 1); }

template <typename T>
cudaError_t launch_conv3(const void* x, const void* w, const float* res, void* out, int B,
                         int H, int W, int Cin, int Cout, int mode, cudaStream_t stream) {
  const size_t smem = conv3_smem(Cin);
  cudaError_t err = set_smem(conv3_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  conv3_kernel<T><<<dim3(W / kTile, H / kTile, B), kConvThreads, smem, stream>>>(
      (const T*)x, (const T*)w, res, out, H, W, Cin, Cout, mode);
  return cudaGetLastError();
}

}  // namespace mp

// x (B, H, W, Cin), w [9][Cin][Cout] (HWIO) in the compute type; res float32
// (B, H, W, Cout) for mode 1, else NULL. mode: 0 plain, 1 res (float32
// output), 2 down (PixelUnshuffle 2), 3 up (PixelShuffle 2, Cout % 4 == 0).
extern "C" int mp_conv3(const void* x, const void* w, const void* res, void* out, int dtype,
                        int B, int H, int W, int Cin, int Cout, int mode, void* stream) {
  if (H % mp::kTile != 0 || W % mp::kTile != 0) return (int)cudaErrorInvalidValue;
  if (mode == mp::kUp && Cout % 4 != 0) return (int)cudaErrorInvalidValue;
  if (mode == mp::kRes && res == nullptr) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)mp::launch_conv3<float>(x, w, (const float*)res, out, B, H, W, Cin, Cout, mode, st);
  return (int)mp::launch_conv3<__nv_bfloat16>(x, w, (const float*)res, out, B, H, W, Cin, Cout,
                                              mode, st);
}

// Shared-memory plan per block (bytes, static included).
extern "C" long long mp_conv3_smem(int Cin) {
  return mp::plan_bytes(mp::conv3_kernel<float>, mp::conv3_smem(Cin));
}
