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
// What bounds it on Hopper: launch and latency, then the stores. It must read
// the 1.86 MB image and write 4.7 MB of descriptors at the main path's shape
// (2048 keypoints, p = 24, a 375 x 1242 image): 1.97 us at 3.35 TB/s, with 5
// float operations a pixel. But 2048 keypoints are 2048 warps, one wave of
// 15.5 of an SM's 64 warp slots, and each warp is one chain (keypoint, patch
// loads, two warp reductions, stores). Timed by parts on an H100
// (tools/profile_zncc.py, PERF.md): the launch alone on the same grid costs
// ~2.7 us with a cold L2 and the stores of constant rows alone ~4 us, so the
// whole kernel can be no faster than ~4 us by any layout.
//
// The first kernel took 15.5 us. Its source summed each pixel inside the
// `if` that loaded it, behind a runtime integer division by p: the compiler
// made a branch, a reciprocal and a dependent add of every load, so a lane's
// 18 loads went out one after the other, each waiting for the last (its
// machine code: LDG BRA MUFU LDG FADD BRA MUFU ...), and every stored pixel
// was an IEEE division (a call). The design:
//
// - p is a template parameter (24 and 16, the engines' sizes): the row of a
//   pixel is a division by a constant. Other sizes (1 to 32) go through the
//   general instantiation (P = 0) of the same kernel.
// - All loads of a lane are issued before the first add uses one (all 18 at
//   p = 24; machine code LDG x20, then the adds), one keypoint a warp, lanes
//   over the flat pixel index so that a warp's loads and stores are
//   consecutive addresses.
// - One reciprocal of the norm a keypoint, a multiply a pixel.
//
// Measured and not taken (tools/profile_zncc.py, PERF.md): aligned 16-byte
// loads and stores (a row read as the words around it with a per-row shift,
// since W = 1242 puts consecutive rows at two alignments) were no faster; 2
// and 4 keypoints a warp were slower; 2 or 8 warps a block within 0.2 us of
// 4. A TMA tensor map needs a row stride that is a multiple of 16 bytes,
// which W = 1242 floats is not: the padded copy it would need costs ~5 us
// cold by itself.
//
// Exactness: the two passes of the Pallas kernel stay two passes over
// registers (mean, then the centred sum of squares). A one-pass sum of
// squares minus the squared sum cancels: a centred norm of 1e-3 is a sum of
// squares of 1e-6 beside an uncentred one of ~144 at p = 24, far below float32
// resolution, so the floor decision would be noise. Sums add in another order
// than the plain version's (warp shuffles), and the rows are scaled by one
// reciprocal of the norm instead of divided element by element; both move
// values by a few ulps of numbers below 1, far inside the 1e-5 the port holds
// K3 to.

#include <cuda_runtime.h>

// Design constants, overridable from nvcc's command line for
// tools/profile_zncc.py, which times the kernel's parts and other block
// sizes: warps a block, and the part of the work that runs (0 all, 1 none:
// launch only, 2 loads and sums (one float written per keypoint), 3 stores
// of constant rows only).
#ifndef VLOAM_K3_WARPS
#define VLOAM_K3_WARPS 4
#endif
#ifndef VLOAM_K3_PART
#define VLOAM_K3_PART 0
#endif

namespace {

constexpr int kWarps = VLOAM_K3_WARPS;
constexpr int kPart = VLOAM_K3_PART;
constexpr int kMaxP = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One warp a keypoint, lanes over the flat pixel index i = lane + 32 j, row
// i / p, every load issued before the first sum. P = 0 takes the size at run
// time (any p up to 32, one runtime division a pixel).
template <int P>
__global__ void __launch_bounds__(kWarps * 32)
zncc_describe_kernel(const float* __restrict__ img,  // [H, W]
                     const float* __restrict__ xy,   // [K, 2] (x, y)
                     float* __restrict__ out,        // [K, p * p]
                     int K, int H, int W, int p_rt) {
  constexpr int kN = P ? (P * P + 31) / 32 : kMaxP * kMaxP / 32;
  const int p = P ? P : p_rt;
  const int pp = p * p;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (kPart == 1 || k >= K) return;  // whole warps only
  float* row = out + static_cast<size_t>(k) * pp;
  if constexpr (kPart == 3) {
    // stores of constant rows only: no keypoint, no image
    for (int i = lane; i < pp; i += 32) row[i] = 0.5f;
    return;
  }

  // top-left corner of the patch, as a flat pixel index
  const int half = p / 2;
  const int y0 = min(max(static_cast<int>(xy[2 * k + 1]) - half, 0), H - p);
  const int x0 = min(max(static_cast<int>(xy[2 * k]) - half, 0), W - p);
  const size_t o = static_cast<size_t>(y0) * W + x0;
  float v[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = lane + 32 * j;
    v[j] = 0.f;
    if (i < pp) {
      const int r = i / p;
      v[j] = __ldg(img + o + static_cast<size_t>(r) * W + (i - r * p));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) sum += v[j];
  const float mu = warp_sum(sum) / static_cast<float>(pp);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    v[j] = lane + 32 * j < pp ? v[j] - mu : 0.f;
    sq += v[j] * v[j];
  }
  sq = warp_sum(sq);
  if constexpr (kPart == 2) {
    if (lane == 0) row[0] = sq;
    return;
  }
  const float n = sqrtf(sq);
  const bool flat = n < 1e-3f;
  const float scale = 1.0f / fmaxf(n, 1e-6f);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = lane + 32 * j;
    if (i < pp) row[i] = flat ? 0.f : v[j] * scale;
  }
}

template <int P>
cudaError_t launch(const float* img, const float* xy, float* out, int K,
                   int H, int W, int p, cudaStream_t stream) {
  const int blocks = (K + kWarps - 1) / kWarps;
  zncc_describe_kernel<P><<<blocks, kWarps * 32, 0, stream>>>(img, xy, out, K,
                                                              H, W, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vloam_zncc_describe(const float* img, const float* xy,
                                   float* out, int K, int H, int W, int p,
                                   void* stream) {
  if (p < 1 || p > kMaxP || p > H || p > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p == 24) {
    e = launch<24>(img, xy, out, K, H, W, p, s);
  } else if (p == 16) {
    e = launch<16>(img, xy, out, K, H, W, p, s);
  } else {
    e = launch<0>(img, xy, out, K, H, W, p, s);
  }
  return static_cast<int>(e);
}
