// K3: zero-normalized p x p patch descriptors (ZNCC) at keypoints.
//
// Replaces: vloam_tpu/vision/features.py::_describe_zncc_pallas (its
// `kernel`), the descriptor of every keypoint of every frame on the combined
// camera + LiDAR path.
//
// What it computes, per keypoint k with pixel coordinates xy[k] = (x, y):
// the p x p patch whose top-left corner is (y0, x0) = (clip(int(y) - p/2,
// 0, H - p), clip(int(x) - p/2, 0, W - p)) (int() truncates toward zero),
// minus its mean, divided by its L2 norm; a patch whose centred norm is below
// 1e-3 gives a zero row (the Pallas kernel's floor). Output [K, p*p] f32.
//
// What bounds it on Hopper: memory latency, not bytes or FLOPs. At the main
// path's shape (2048 keypoints, p = 24) it reads 2048 x 576 pixels (4.7 MB,
// mostly re-reads of a 1.86 MB image that stays in L2) and writes 4.7 MB,
// with ~3 FLOPs per pixel. The Pallas kernel's one-hot selection matmuls
// with a hi/lo bf16 split exist only because Mosaic cannot load at unaligned
// offsets; here every pixel is a direct load through the read-only cache.
// Shape: one warp per keypoint, 8 warps per block. Lanes stride over the p^2
// pixels (consecutive lanes read consecutive columns of a patch row) and keep
// their pixels in registers (p <= 32: at most 32 per lane), so the two
// passes of the Pallas kernel (mean, then the centred sum of squares) read
// the image once. Both sums are warp-shuffle reductions; the normalized
// pixels are written by consecutive lanes to consecutive addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxP = 32;
constexpr int kMaxPerLane = kMaxP * kMaxP / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
zncc_describe_kernel(const float* __restrict__ img,  // [H, W]
                     const float* __restrict__ xy,   // [K, 2] (x, y)
                     float* __restrict__ out,        // [K, p * p]
                     int K, int H, int W, int p) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= K) return;  // whole warps only: K is split by warp
  const int half = p / 2;
  const int y0 = min(max(static_cast<int>(xy[2 * k + 1]) - half, 0), H - p);
  const int x0 = min(max(static_cast<int>(xy[2 * k]) - half, 0), W - p);
  const int pp = p * p;

  float v[kMaxPerLane];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = 0.0f;
    if (i < pp) {
      const int r = i / p;
      const int c = i - r * p;
      v[j] = __ldg(img + static_cast<size_t>(y0 + r) * W + (x0 + c));
      sum += v[j];
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(pp);

  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    if (lane + 32 * j < pp) {
      v[j] -= mu;
      sq += v[j] * v[j];
    }
  }
  const float n = sqrtf(warp_sum(sq));
  const bool flat = n < 1e-3f;
  const float den = fmaxf(n, 1e-6f);
  float* row = out + static_cast<size_t>(k) * pp;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < pp) row[i] = flat ? 0.0f : v[j] / den;
  }
}

}  // namespace

extern "C" int vloam_zncc_describe(const float* img, const float* xy,
                                   float* out, int K, int H, int W, int p,
                                   void* stream) {
  if (p < 1 || p > kMaxP || p > H || p > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = kWarps * 32;
  const int blocks = (K + kWarps - 1) / kWarps;
  zncc_describe_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      img, xy, out, K, H, W, p);
  return static_cast<int>(cudaGetLastError());
}
