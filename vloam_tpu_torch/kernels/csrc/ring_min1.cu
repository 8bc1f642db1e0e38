// S1: the two variants of the per-ring reduction behind LO association.
//
// Replaces: scripts/profile_ring_variants.py::run_pallas with its kernels
// _kern_min1 (per ring and query the minimum squared distance and its slot,
// "corner mode: no second-min") and _kern_argmin (K2's four outputs by two
// argmin passes: the winner's slot is masked with 3.9e12 and the argmin is
// taken again).
//
//   vloam_ring_min1     [Q,3] x [S,3,C] -> dmin [S,Q] f32, amin [S,Q] i32.
//                       The corner association needs no second minimum, so
//                       it launches this and not K2 (ring_min2.cu).
//   vloam_ring_argmin2  the same inputs -> K2's (dmin, amin, d2, a2), in the
//                       argmin-then-mask formulation; timed beside K2.
//
// What bounds them on Hopper: arithmetic, as K2 (8 flops and one or two
// compares per (query, slot) pair against a few KB of inputs; the [Q, C]
// distance block is never written). Same shape as K2: one block per (ring,
// 128-query tile), the ring's [3, C] slab staged once in shared memory and
// read as a broadcast, one query per thread. ring_min1 keeps a running
// minimum in registers; ring_argmin2 walks the ring twice and recomputes
// the distances in the second pass rather than storing them.
//
// Exactness: distances are (dx*dx + dy*dy) + dz*dz with every product and
// sum rounded separately (__fmul_rn/__fadd_rn, build flag -fmad=false), as
// K2 and the plain PyTorch versions round; a strict `<` keeps the lowest
// slot on ties, which is the iota-min rule of the reference. ring_min1's
// outputs equal K2's first two and ring_argmin2's all four, bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.9e12f;  // > any sentinel distance (~3e12)

__device__ __forceinline__ float dist_sq(float qx, float qy, float qz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  const float dz = __fsub_rn(qz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage ring blockIdx.x's [3, C] slab in shared memory.
__device__ __forceinline__ void stage_ring(float* ring,
                                           const float* __restrict__ slab_t,
                                           int C) {
  const float* src = slab_t + static_cast<size_t>(blockIdx.x) * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) ring[i] = src[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ring_min1_kernel(const float* __restrict__ queries,  // [Q, 3]
                 const float* __restrict__ slab_t,   // [S, 3, C]
                 float* __restrict__ dmin, int* __restrict__ amin,
                 int Q, int C) {
  extern __shared__ float ring[];  // [3, C]
  stage_ring(ring, slab_t, C);
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float qx = queries[3 * q], qy = queries[3 * q + 1],
              qz = queries[3 * q + 2];
  float m1 = CUDART_INF_F;
  int i1 = 0;
  for (int c = 0; c < C; ++c) {
    const float d = dist_sq(qx, qy, qz, ring[c], ring[C + c], ring[2 * C + c]);
    if (d < m1) {
      m1 = d;
      i1 = c;
    }
  }
  const size_t o = static_cast<size_t>(blockIdx.x) * Q + q;
  dmin[o] = m1;
  amin[o] = i1;
}

__global__ void __launch_bounds__(kThreads)
ring_argmin2_kernel(const float* __restrict__ queries,
                    const float* __restrict__ slab_t,
                    float* __restrict__ dmin, int* __restrict__ amin,
                    float* __restrict__ d2, int* __restrict__ a2,
                    int Q, int C) {
  extern __shared__ float ring[];
  stage_ring(ring, slab_t, C);
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float qx = queries[3 * q], qy = queries[3 * q + 1],
              qz = queries[3 * q + 2];
  float m1 = CUDART_INF_F;
  int i1 = 0;
  for (int c = 0; c < C; ++c) {
    const float d = dist_sq(qx, qy, qz, ring[c], ring[C + c], ring[2 * C + c]);
    if (d < m1) {
      m1 = d;
      i1 = c;
    }
  }
  // second pass: the same distances with the winner's slot masked
  float m2 = CUDART_INF_F;
  int i2 = 0;
  for (int c = 0; c < C; ++c) {
    float d = dist_sq(qx, qy, qz, ring[c], ring[C + c], ring[2 * C + c]);
    if (c == i1) d = kBig;
    if (d < m2) {
      m2 = d;
      i2 = c;
    }
  }
  const size_t o = static_cast<size_t>(blockIdx.x) * Q + q;
  dmin[o] = m1;
  amin[o] = i1;
  d2[o] = m2;
  a2[o] = i2;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int vloam_ring_min1(const float* queries, const float* slab_t,
                               float* dmin, int* amin, int Q, int S, int C,
                               void* stream) {
  const size_t smem = static_cast<size_t>(3) * C * sizeof(float);
  const cudaError_t e = allow_smem(ring_min1_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(S, (Q + kThreads - 1) / kThreads);
  ring_min1_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      queries, slab_t, dmin, amin, Q, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vloam_ring_argmin2(const float* queries, const float* slab_t,
                                  float* dmin, int* amin, float* d2, int* a2,
                                  int Q, int S, int C, void* stream) {
  const size_t smem = static_cast<size_t>(3) * C * sizeof(float);
  const cudaError_t e = allow_smem(ring_argmin2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(S, (Q + kThreads - 1) / kThreads);
  ring_argmin2_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      queries, slab_t, dmin, amin, d2, a2, Q, C);
  return static_cast<int>(cudaGetLastError());
}
