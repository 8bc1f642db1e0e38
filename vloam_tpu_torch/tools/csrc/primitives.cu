// What the building blocks of the hand-written kernels cost on this card:
// the latency, in SM cycles, of the warp primitives and dependent chains that
// K1's pick round is made of (one warp, one block), and the rate at which
// one SM scheduler gets through the unfused float instructions of K2's
// distance loop (all SMs busy). Built and run by
// vloam_tpu_torch/tools/profile_primitives.py; standalone, no PyTorch.

#include <cstdio>
#include <cuda_runtime.h>

#define FULL 0xffffffffu
constexpr int kIters = 512;

__global__ void latencies(long long* out, int seed, float* sink) {
  const int lane = threadIdx.x;
  __shared__ int chase[1024];
  for (int i = lane; i < 1024; i += 32) chase[i] = (i * 7 + 13) & 1023;
  __syncwarp();
  unsigned x = seed + lane;
  long long t0;
  int n = 0;
#define TIMED(...)                                  \
  t0 = clock64();                                   \
  for (int i = 0; i < kIters; ++i) { __VA_ARGS__ } \
  if (lane == 0) out[n] = clock64() - t0;           \
  ++n;
  // 0: one redux.sync (with the xor and add that make it dependent)
  TIMED(x = __reduce_max_sync(FULL, x ^ lane) + 1;)
  // 1: redux max, select, redux min: a first-argmax over the warp
  int y = x;
  TIMED(const unsigned m = __reduce_max_sync(FULL, (unsigned)y ^ lane);
        y = __reduce_min_sync(
            FULL, m == ((unsigned)y ^ lane) ? lane + i : 0x7fffffff);)
  // 2: the same maximum by five shuffles
  TIMED(unsigned v = x ^ lane;
        for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
        x = v + 1;)
  // 3: ballot and find-first-set
  TIMED(const unsigned b = __ballot_sync(FULL, ((x + lane) & 7) == 3);
        x = x + __ffs(b) + 1;)
  // 4: one dependent shuffle
  TIMED(x = __shfl_sync(FULL, x, (x + 1) & 31) + 1;)
  // 5: one dependent shared-memory load
  int p = x & 1023;
  TIMED(p = chase[p];)
  // 6: three dependent float min / max / add
  float f = __int_as_float((p & 0xff) | 0x3f800000), g = f * 1.5f;
  TIMED(f = fmaxf(f, g); g = fminf(g, f) + 1.0f;)
  // 7: a divergent if around one instruction, then a shuffle
  int z = p;
  TIMED(if (lane == (z & 31)) z = z * 3 + 1;
        z = __shfl_sync(FULL, z, z & 31) + 1;)
  // 8: 30 independent compare / select / add instructions of one warp
  float a[10];
  for (int k = 0; k < 10; ++k) a[k] = f + k;
  TIMED(const int kk = (z + i) & 15;
        for (int k = 0; k < 10; ++k) a[k] = k == kk ? 0.5f : a[k] + 1.0f;)
  float s = 0;
  for (int k = 0; k < 10; ++k) s += a[k];
  sink[lane] = x + y + p + z + s + f + g;
}

// 16 independent chains a thread of mul-then-add (kFused: one fma)
template <bool kFused>
__global__ void float_rate(float* out, int n) {
  float a[16];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 0.001f + i;
  const float b = 1.0001f, c = 0.5f;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      a[i] = kFused ? __fmaf_rn(a[i], b, c)
                    : __fadd_rn(__fmul_rn(a[i], b), c);
  }
  float s = 0;
  for (int i = 0; i < 16; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool kFused>
void rate(const char* name, int per_chain, int n, int sms, double ghz) {
  const int blocks = 2 * sms, threads = 256;  // 4 warps a scheduler
  float* out;
  cudaMalloc(&out, blocks * threads * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float_rate<kFused><<<blocks, threads>>>(out, n);
  cudaEventRecord(e0);
  float_rate<kFused><<<blocks, threads>>>(out, n);
  cudaEventRecord(e1);
  cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double instr = 1.0 * blocks * threads / 32 * n * 16 * per_chain;
  printf("%s, %d iterations: %.1f us, %.2f warp instructions per clock per "
         "scheduler (%d SMs x 4 at %.2f GHz)\n",
         name, n, ms * 1e3, instr / (sms * 4) / (ms * 1e-3 * ghz * 1e9), sms,
         ghz);
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    printf("no CUDA device\n");
    return 1;
  }
  const double ghz = prop.clockRate * 1e-6;
  long long* out;
  float* sink;
  cudaMallocManaged(&out, 16 * sizeof(long long));
  cudaMalloc(&sink, 32 * sizeof(float));
  for (int r = 0; r < 2; ++r) {  // the second run is the warm one
    latencies<<<1, 32>>>(out, 3 + r, sink);
    cudaDeviceSynchronize();
  }
  const char* names[] = {
      "redux.sync max (dependent)",
      "redux.sync max + select + redux.sync min",
      "max by 5 xor-shuffles",
      "ballot + ffs",
      "one shuffle",
      "one shared-memory load",
      "3 dependent fmax / fmin / fadd",
      "divergent if + shuffle",
      "30 independent compare / select / add"};
  for (int i = 0; i < 9; ++i)
    printf("%s: %.1f cycles\n", names[i], (double)out[i] / kIters);
  rate<true>("fma", 1, 4096, prop.multiProcessorCount, ghz);
  rate<false>("mul + add, unfused", 2, 4096, prop.multiProcessorCount, ghz);
  rate<false>("mul + add, unfused", 2, 64, prop.multiProcessorCount, ghz);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) printf("%s\n", cudaGetErrorString(e));
  return e != cudaSuccess;
}
