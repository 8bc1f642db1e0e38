// masked_knn: the k nearest live candidates of each query, by (squared
// distance, candidate index), over a masked candidate cloud.
//
// Replaces: vloam_tpu/lidar/knn.py::masked_knn (XLA in the reference: a
// lax.scan over 4096-wide candidate tiles, each a dense |q|^2 + |c|^2 - 2 q.c
// tile and a top_k merged into a running top_k; no Pallas kernel) and the
// port's plain version of it, lidar/knn.py::masked_knn_plain, a Python loop
// of tile kernels (767 launches a call at the mesh engine's corner window,
// 1138 at its surf window). It is the mesh chunk's window sweep:
// parallel/sharded_mapping.py::_ring_knn, twice a frame for each grid.
//
//   vloam_masked_knn  queries [Q,3] f32, cands [C,3] f32, mask [C] u8 ->
//                     d [Q,k] f32 ascending, idx [Q,k] i64; 1 <= k <= 8.
//
// What it computes, bit for bit with the plain version:
// - per query qq = (q0*q0 + q1*q1) + q2*q2 and qm = -2 q; per candidate
//   cc = (c0*c0 + c1*c1) + c2*c2, +inf where masked; every product and sum
//   rounded apart (__fmul_rn / __fadd_rn; the build passes -fmad=false);
// - d = clamp((qq + cc) + ((qm0*c0 + qm1*c1) + qm2*c2), min 0), where the
//   clamp keeps NaN as torch.clamp does (x < 0 ? 0 : x; fmaxf would not);
// - the k smallest int64 keys (int32 bits of d) << 32 | index over C + pad
//   virtual slots, ascending: slots C .. C+pad-1 are the reference's padding
//   slots (masked, d = +inf; lidar/knn.py::_padding). For d >= 0 (or NaN)
//   the key orders as the plain version's dist_key.
//
// What bounds it on Hopper: instruction issue. A pair needs 3 products and
// 4 sums that may not fuse (7 float instructions), so the float32 rate
// (67 TFLOP/s at 6 operations a pair) is not the limit that counts; what
// the card issues is 132 SMs x 4 schedulers x 32 lanes an instruction a
// clock. At ~10 instructions a pair (the 7, a compare, the candidate's load,
// the branch) the corner window (2048 x 131,072 pairs) takes ~80 us of
// issue at 1.98 GHz and the surf window (6144 x 65,536) ~120 us. Bytes are
// nothing: ~2 MB in, 0.5 MB out.
//
// The design:
// - One thread a query, its running top-k in registers: k (bits, index)
//   pairs sorted ascending, and thr, the k-th entry's distance as a float
//   (NaN while the list holds sentinels, which are (0x7FFFFFFF, INT_MAX)).
//   A candidate is examined only if !(x >= thr) (one FSETP.LTU): within a
//   thread candidates come in increasing index order, so a candidate that
//   ties the k-th distance loses its key compare, and the strict float
//   compare is exact; NaN (an unfilled list, or a NaN entry) examines every
//   candidate. Masked candidates (x = +inf) stop being examined once the
//   list is full, even of +inf entries. The examination computes the key
//   and makes the full (bits, index) compare and a sorted insertion by
//   selects, so ties and NaN order as the int64 keys do.
// - Candidates stream through shared memory in tiles of kTile slots, laid
//   out as four float arrays (x, y, z, cc), cc computed once a tile from
//   the mask; a thread reads 4 slots with 4 broadcast 16-byte loads. The
//   main loop tests kStep = 16 slots a step (16 compares or-ed into one
//   predicate, one branch) and leaves the loop to examine that step's slots
//   one by one: the loop holds only the hot path, which chip_smoke.py
//   counts in the machine code.
// - At Q = 2048 one thread a query fills 16 blocks, 16 of 132 SMs. So the
//   candidates' tiles are dealt to gridDim.y slices, slice s taking tiles
//   s, s + S, s + 2S, ..., each block writing its slice's top-k, and a
//   second launch merges a query's slice lists by key. Dealt tiles give
//   every slice the same mix of near and far rows of a mesh window (whose
//   rows come nearest first, empty rows last), so the blocks of a launch
//   take about as long; within a slice the slots still come in increasing
//   index order. The key order is total, so the merge is exact in any
//   order; each list is sorted, so it stops at its first entry that loses.
//   The wrapper picks the slices from the SM count (kernels.knn_slices).
// - No [Q, C] tile reaches memory: what is written is slices x k x Q pairs
//   of int32 (bits, index), then the [Q, k] outputs.
//
// Measured (tools/profile_knn.py, PERF.md section 6): the main loop is 9.88
// instructions a pair in the machine code (16 LDS.128, 112 float
// instructions, 16 FSETP and a branch a step, and the loop), and alone it
// runs at 68-75% of the issue rate at the mesh windows' shapes. The
// examination doubles the time: with 32 unrelated queries a warp, a warp
// enters it at most steps of a slice's live rows while its lists fill.
// Steps of 8 or 4 slots (VLOAM_KNN_STEP) were slower, and so was an
// examination that loops over the step's passing slots (tried, removed);
// 4 slice blocks an SM (every block resident, 528 blocks at both windows)
// the fastest of 2-8.
//
// Masked slots leave the hot path once a list is full only while their
// coordinates are finite (x = +inf; the map's empty slots hold 1e6); with
// other inputs the kernel still equals the plain version, as it repeats its
// arithmetic and the examination compares whole keys.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;  // queries a block (kernels.KNN_THREADS)
constexpr int kTile = 256;     // candidate slots a shared tile (KNN_TILE)
// slots the main loop tests a step (tools/profile_knn.py times others)
#ifndef VLOAM_KNN_STEP
#define VLOAM_KNN_STEP 16
#endif
constexpr int kStep = VLOAM_KNN_STEP;
static_assert(kStep % 4 == 0 && kTile % kStep == 0,
              "a step is whole float4 groups of a tile");
constexpr int kSentBits = INT_MAX;  // a NaN pattern: thr compares unordered
constexpr int kSentIdx = INT_MAX;
// the part of the work that runs, for the measurement: 0 all, 1 the main
// loop alone (no examination, against a threshold of -(|q|^2 + 1) that no
// slot passes; the output counts the steps that would stop)
#ifndef VLOAM_KNN_PART
#define VLOAM_KNN_PART 0
#endif
constexpr int kPart = VLOAM_KNN_PART;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (qq + cc) + ((qm0*x + qm1*y) + qm2*z), unclamped
__device__ __forceinline__ float expanded(float qq, float m0, float m1,
                                          float m2, float x, float y, float z,
                                          float cc) {
  const float qc = __fadd_rn(__fadd_rn(__fmul_rn(m0, x), __fmul_rn(m1, y)),
                             __fmul_rn(m2, z));
  return __fadd_rn(__fadd_rn(qq, cc), qc);
}

// key (b, i) < key (kb, ki), as the int64 keys compare
__device__ __forceinline__ bool key_less(int b, int i, int kb, int ki) {
  return b < kb || (b == kb && i < ki);
}

// Insert (b, i), known to be below the last entry, into the sorted list:
// every entry it precedes moves down one place, by selects.
template <int K>
__device__ __forceinline__ void insert(int (&kb)[K], int (&ki)[K], int b,
                                       int i) {
  bool below = true;  // (b, i) precedes entry j (true for j = K)
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool up = key_less(b, i, kb[j - 1], ki[j - 1]);
    kb[j] = up ? kb[j - 1] : (below ? b : kb[j]);
    ki[j] = up ? ki[j - 1] : (below ? i : ki[j]);
    below = up;
  }
  kb[0] = below ? b : kb[0];
  ki[0] = below ? i : ki[0];
}

// The slow path of one slot g with unclamped distance x.
template <int K>
__device__ __forceinline__ void examine(int (&kb)[K], int (&ki)[K],
                                        float& thr, float x, int g, int C,
                                        int Cv) {
  if (!(x >= thr) && g < Cv) {
    float d = x < 0.f ? 0.f : x;  // torch.clamp(min=0): NaN stays NaN
    if (g >= C) d = __int_as_float(0x7F800000);  // a padding slot: +inf
    const int b = __float_as_int(d);
    if (key_less(b, g, kb[K - 1], ki[K - 1])) {
      insert<K>(kb, ki, b, g);
      thr = __int_as_float(kb[K - 1]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_slice_kernel(const float* __restrict__ queries,     // [Q, 3]
                 const float* __restrict__ cands,       // [C, 3]
                 const unsigned char* __restrict__ mask,  // [C]
                 int Q, int C, int Cv,
                 int* __restrict__ part_b,   // [S, K, Q]
                 int* __restrict__ part_i) {  // [S, K, Q]
  __shared__ float4 s_x[kTile / 4], s_y[kTile / 4], s_z[kTile / 4],
      s_c[kTile / 4];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int qr = min(q, Q - 1);  // threads past Q compute and store nothing
  const float* const qp = queries + 3 * static_cast<size_t>(qr);
  const float q0 = qp[0], q1 = qp[1], q2 = qp[2];
  const float qq = sq_norm(q0, q1, q2);
  const float m0 = __fmul_rn(-2.f, q0), m1 = __fmul_rn(-2.f, q1),
              m2 = __fmul_rn(-2.f, q2);
  int kb[K], ki[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    kb[j] = kSentBits;
    ki[j] = kSentIdx;
  }
  // kPart 1: a threshold the compiler cannot fold and no slot passes
  float thr = kPart == 1 ? -__fadd_rn(qq, 1.f) : __int_as_float(kSentBits);
  float* const fx = reinterpret_cast<float*>(s_x);
  float* const fy = reinterpret_cast<float*>(s_y);
  float* const fz = reinterpret_cast<float*>(s_z);
  float* const fc = reinterpret_cast<float*>(s_c);
  int hits = 0;  // kPart 1: the steps that would stop
  const int n_tiles = (Cv + kTile - 1) / kTile;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int t0 = t * kTile;
    __syncthreads();  // the previous tile is read
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int g = t0 + j;
      float x = 0.f, y = 0.f, z = 0.f;
      float c = __int_as_float(0x7F800000);  // padding and past the end
      if (g < C) {
        const float* const cp = cands + 3 * static_cast<size_t>(g);
        x = __ldg(cp);
        y = __ldg(cp + 1);
        z = __ldg(cp + 2);
        if (__ldg(mask + g)) c = sq_norm(x, y, z);
      }
      fx[j] = x;
      fy[j] = y;
      fz[j] = z;
      fc[j] = c;
    }
    __syncthreads();
    float xs[kStep];  // the unclamped distances of the step that stopped
    int j = 0;        // the step's first slot in the tile
    for (;;) {
      // the hot path: kStep slots a step, until one may enter the list
      for (; j < kTile; j += kStep) {
        bool any = false;
#pragma unroll
        for (int u = 0; u < kStep / 4; ++u) {
          const int v = j / 4 + u;
          const float4 X = s_x[v], Y = s_y[v], Z = s_z[v], W = s_c[v];
          xs[4 * u] = expanded(qq, m0, m1, m2, X.x, Y.x, Z.x, W.x);
          xs[4 * u + 1] = expanded(qq, m0, m1, m2, X.y, Y.y, Z.y, W.y);
          xs[4 * u + 2] = expanded(qq, m0, m1, m2, X.z, Y.z, Z.z, W.z);
          xs[4 * u + 3] = expanded(qq, m0, m1, m2, X.w, Y.w, Z.w, W.w);
          any |= !(xs[4 * u] >= thr) | !(xs[4 * u + 1] >= thr) |
                 !(xs[4 * u + 2] >= thr) | !(xs[4 * u + 3] >= thr);
        }
        if (kPart == 1)
          hits += any;
        else if (any)
          break;
      }
      if (j >= kTile) break;
      // the examination of the step's slots, in index order
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        examine<K>(kb, ki, thr, xs[u], t0 + j + u, C, Cv);
      j += kStep;
    }
  }
  if (kPart == 1) kb[0] = hits;
  if (q < Q) {
    const size_t base = static_cast<size_t>(blockIdx.y) * K * Q + q;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_b[base + static_cast<size_t>(j) * Q] = kb[j];
      part_i[base + static_cast<size_t>(j) * Q] = ki[j];
    }
  }
}

// One thread a query: the slices' sorted lists merged by key, in slice
// order (every entry compared: an early exit spilled at k = 8).
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const int* __restrict__ part_b, const int* __restrict__ part_i,
                 int Q, int S, float* __restrict__ out_d,
                 long long* __restrict__ out_idx) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  int kb[K], ki[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    kb[j] = __ldg(part_b + static_cast<size_t>(j) * Q + q);
    ki[j] = __ldg(part_i + static_cast<size_t>(j) * Q + q);
  }
  for (int s = 1; s < S; ++s) {
    const size_t base = static_cast<size_t>(s) * K * Q + q;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int b = __ldg(part_b + base + static_cast<size_t>(j) * Q);
      const int i = __ldg(part_i + base + static_cast<size_t>(j) * Q);
      if (key_less(b, i, kb[K - 1], ki[K - 1])) insert<K>(kb, ki, b, i);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_d[static_cast<size_t>(q) * K + j] = __int_as_float(kb[j]);
    out_idx[static_cast<size_t>(q) * K + j] = ki[j];
  }
}

template <int K>
cudaError_t launch(const float* queries, const float* cands,
                   const unsigned char* mask, int Q, int C, int Cv,
                   int slices, int* scratch, float* out_d,
                   long long* out_idx, cudaStream_t st) {
  int* const part_b = scratch;
  int* const part_i = scratch + static_cast<size_t>(slices) * K * Q;
  const unsigned q_blocks = (Q + kThreads - 1) / kThreads;
  knn_slice_kernel<K><<<dim3(q_blocks, slices), kThreads, 0, st>>>(
      queries, cands, mask, Q, C, Cv, part_b, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<K><<<q_blocks, kThreads, 0, st>>>(part_b, part_i, Q,
                                                     slices, out_d, out_idx);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels.masked_knn) checks the shapes: Q >= 1, C >= 1,
// 1 <= k <= 8, C + pad >= k and below 2^30, 1 <= slices <= the tiles of
// C + pad slots (every slice holds a tile), and scratch holding
// 2 * slices * k * Q int32.
extern "C" int vloam_masked_knn(const float* queries, const float* cands,
                                const unsigned char* mask, int Q, int C,
                                int k, int pad, int slices,
                                int* scratch, float* out_d,
                                long long* out_idx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Cv = C + pad;
  switch (k) {
#define VLOAM_KNN_CASE(K)                                                   \
  case K:                                                                   \
    return static_cast<int>(launch<K>(queries, cands, mask, Q, C, Cv,       \
                                      slices, scratch, out_d, out_idx, st));
    VLOAM_KNN_CASE(1)
    VLOAM_KNN_CASE(2)
    VLOAM_KNN_CASE(3)
    VLOAM_KNN_CASE(4)
    VLOAM_KNN_CASE(5)
    VLOAM_KNN_CASE(6)
    VLOAM_KNN_CASE(7)
    VLOAM_KNN_CASE(8)
#undef VLOAM_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
