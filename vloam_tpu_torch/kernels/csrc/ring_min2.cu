// K2: per-ring (min, argmin, second-min, second-argmin) of exact squared
// distances between queries and sentinel-padded ring slabs.
//
// Replaces: vloam_tpu/lidar/ring_assoc.py::_ring_min2_kernel (the Pallas TPU
// kernel behind ring_min2_pallas), the reduction under every LO surf
// association round (2 per frame).
//
// What bounds it on Hopper: instruction throughput, not bytes (the inputs
// are a few KB a ring and the [Q, C] distance block is never written). A
// (query, slot) pair costs 8 float instructions that may not fuse: the
// distance must round as (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded separately (__fmul_rn / __fadd_rn, and the build passes
// -fmad=false), as the plain PyTorch version rounds, so that slots and
// distances match it bit for bit. At the surf shape (1536 queries x 64 rings
// x 512 slots = 50.3 M pairs) those 8 alone are 14.3 us on 132 SMs x 4
// schedulers at 1.98 GHz, one instruction a clock each, every scheduler
// busy. Everything else a pair costs comes on top, and compares, minima and
// selects run at half the float rate, so the design removes what it can of
// the rest:
//
// - Loads. The slab is staged in shared memory in tiles of kTile slots,
//   packed as float4 {x, y, z, -} while staging (the interface keeps the
//   [S, 3, C] planes), and a thread holds kQpt queries in registers: one
//   16-byte broadcast load per slot serves all of them, instead of three
//   4-byte loads per pair. Tiles are looped over C, so shared memory per
//   block is fixed (24 KB) whatever C is. Queries are strided over the block
//   (q = base + j * kGroup + tid), so the four [S, Q] stores coalesce.
// - The top-2 update. A running (m1, i1, m2, i2) with slot indices costs two
//   compares, three minima and three selects per pair, as much as the
//   distance. Skipping it for chunks that cannot change m2 helps little: a
//   warp holds 32 x kQpt queries and takes the slow path when any of them
//   does, measured on real surf features in 60% of a warp's chunks (10% of
//   a query's) and on rings without SENTINEL padding in nearly all
//   (tools/profile_ring_variants.py prints the share).
//   Instead the main loop tracks chunks, not slots, and without branches:
//   per chunk of kChunk slots it keeps only the minimum distance (one fminf
//   per pair) and merges (chunk minimum, chunk id) into the two best chunks
//   (c1, c2) by the strict running rule, once per chunk. The two smallest
//   distances of a ring, ordered by (distance, slot), lie in c1 and c2: the
//   smallest is the first slot of the first chunk that reaches the minimum,
//   and the second is either in c1 too or the first best slot of the best
//   other chunk, which is c2. A resolve pass then runs the exact running
//   rule (d < m1: shift the old minimum to second place; else d < m2:
//   replace the second) over the at most 2 x kChunk slots of c1 and c2 in
//   slot order. That reproduces the iota-min rules of the plain version:
//   ties keep the lowest slot, duplicate points give m2 == m1, an
//   all-SENTINEL ring gives a1 = 0, a2 = 1.
// - Every slot of every ring is visited, SENTINEL slots included: live slots
//   need not be a prefix, and the bound counts them all.
//
// Block shape: the card has 132 SMs x 4 schedulers, and with 4 queries a
// thread the surf shape is only 768 warps of equal length: 1.45 a scheduler,
// so the schedulers that hold two would set the time (73% balance; measured
// 34.1 us against 27.3 us with 3 queries a thread, 1024 warps). So a block
// is two groups of kGroup threads that hold the same kGroup x kQpt queries
// and each take half of every tile's chunks: 1536 warps of half the length,
// 2.9 a scheduler. The groups exchange their two best chunks through shared
// memory, merge them by (minimum, chunk id) and resolve half of the queries
// each.
//
// Inputs must be finite (slabs pad with the finite SENTINEL): the padding of
// a ragged last chunk is +inf coordinates, whose distance +inf never wins.

#include <cuda_runtime.h>
#include <math_constants.h>

// The three constants can be set from nvcc's command line, for
// tools/profile_ring_variants.py --shapes, which times other block shapes.
#ifndef VLOAM_K2_GROUP
#define VLOAM_K2_GROUP 64
#endif
#ifndef VLOAM_K2_QPT
#define VLOAM_K2_QPT 4
#endif
#ifndef VLOAM_K2_CHUNK
#define VLOAM_K2_CHUNK 8
#endif

namespace {

constexpr int kGroup = VLOAM_K2_GROUP;  // threads that share a set of queries
constexpr int kThreads = 2 * kGroup;
constexpr int kQpt = VLOAM_K2_QPT;      // queries a thread
constexpr int kChunk = VLOAM_K2_CHUNK;  // slots a chunk
constexpr int kTile = 512;   // slots staged at a time
static_assert(kTile % kChunk == 0, "a tile is whole chunks");
static_assert(kQpt % 2 == 0, "each group resolves half of the queries");

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float cx,
                                       float cy, float cz) {
  const float dx = __fsub_rn(qx, cx);
  const float dy = __fsub_rn(qy, cy);
  const float dz = __fsub_rn(qz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (a, ia) before (b, ib): the smaller minimum, the earlier chunk on ties
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
ring_min2_kernel(const float* __restrict__ queries,  // [Q, 3]
                 const float* __restrict__ slab_t,   // [S, 3, C]
                 float* __restrict__ dmin, int* __restrict__ amin,
                 float* __restrict__ d2, int* __restrict__ a2,
                 int Q, int C) {
  __shared__ float4 tile[kTile];
  // each group's two best chunks per query: minima and chunk ids
  __shared__ float s_m[2][2][kQpt][kGroup];
  __shared__ int s_c[2][2][kQpt][kGroup];
  const int s = blockIdx.x;
  const int grp = threadIdx.x / kGroup;
  const int tid = threadIdx.x % kGroup;
  const float* ring = slab_t + static_cast<size_t>(s) * 3 * C;
  const int q0 = blockIdx.y * (kGroup * kQpt) + tid;

  float qx[kQpt], qy[kQpt], qz[kQpt];
  float m1[kQpt], m2[kQpt];  // the two smallest chunk minima
  int c1[kQpt], c2[kQpt];    // and their chunks
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    // queries past Q repeat the last one and are not stored
    const int q = min(q0 + j * kGroup, Q - 1);
    qx[j] = queries[3 * q];
    qy[j] = queries[3 * q + 1];
    qz[j] = queries[3 * q + 2];
    m1[j] = m2[j] = CUDART_INF_F;
    c1[j] = c2[j] = 0;
  }

  for (int t0 = 0; t0 < C; t0 += kTile) {
    const int n = min(kTile, C - t0);
    const int n_chunks = (n + kChunk - 1) / kChunk;
    __syncthreads();  // the previous tile is done with
    for (int i = threadIdx.x; i < n_chunks * kChunk; i += kThreads) {
      const int c = t0 + i;
      tile[i] = c < C ? make_float4(ring[c], ring[C + c], ring[2 * C + c], 0.f)
                      : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                    0.f);
    }
    __syncthreads();
    // group 0 takes the first half of the tile's chunks, group 1 the rest
    const int half = (n_chunks + 1) / 2;
    const int ch_end = grp ? n_chunks : half;
    for (int ch = grp ? half : 0; ch < ch_end; ++ch) {
      float lo[kQpt];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        // one broadcast load for kQpt queries
        const float4 p = tile[ch * kChunk + k];
#pragma unroll
        for (int j = 0; j < kQpt; ++j) {
          const float d = dist2(qx[j], qy[j], qz[j], p.x, p.y, p.z);
          lo[j] = k == 0 ? d : fminf(lo[j], d);
        }
      }
      const int id = t0 / kChunk + ch;
#pragma unroll
      for (int j = 0; j < kQpt; ++j) {
        const bool p1 = lo[j] < m1[j];
        const bool p2 = lo[j] < m2[j];
        c2[j] = p1 ? c1[j] : (p2 ? id : c2[j]);
        m2[j] = fminf(m2[j], fmaxf(m1[j], lo[j]));
        c1[j] = p1 ? id : c1[j];
        m1[j] = fminf(m1[j], lo[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    s_m[grp][0][j][tid] = m1[j];
    s_m[grp][1][j][tid] = m2[j];
    s_c[grp][0][j][tid] = c1[j];
    s_c[grp][1][j][tid] = c2[j];
  }
  __syncthreads();

  // each group takes half of the queries: merge the groups' chunk pairs,
  // then the exact running rule over the slots of the two best chunks, in
  // slot order
  for (int j = grp * (kQpt / 2); j < (grp + 1) * (kQpt / 2); ++j) {
    const int q = q0 + j * kGroup;
    if (q >= Q) continue;
    const float a1 = s_m[0][0][j][tid], a2v = s_m[0][1][j][tid];
    const float b1 = s_m[1][0][j][tid], b2v = s_m[1][1][j][tid];
    const int ia1 = s_c[0][0][j][tid], ia2 = s_c[0][1][j][tid];
    const int ib1 = s_c[1][0][j][tid], ib2 = s_c[1][1][j][tid];
    // each pair is in order; the best of the four, then the best of the rest
    const bool a_first = !before(b1, ib1, a1, ia1);
    const int first = a_first ? ia1 : ib1;
    const float xv = a_first ? a2v : a1, yv = a_first ? b1 : b2v;
    const int xi = a_first ? ia2 : ia1, yi = a_first ? ib1 : ib2;
    const int second = before(yv, yi, xv, xi) ? yi : xi;
    const int ca = min(first, second);
    const int cb = max(first, second);

    const float x = queries[3 * q], y = queries[3 * q + 1],
                z = queries[3 * q + 2];
    float r1 = CUDART_INF_F, r2 = CUDART_INF_F;
    int i1 = 0, i2 = 0;
    for (int ch = ca;; ch = cb) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int c = ch * kChunk + k;
        if (c < C) {
          const float d = dist2(x, y, z, __ldg(ring + c), __ldg(ring + C + c),
                                __ldg(ring + 2 * C + c));
          if (d < r1) {
            r2 = r1;
            i2 = i1;
            r1 = d;
            i1 = c;
          } else if (d < r2) {
            r2 = d;
            i2 = c;
          }
        }
      }
      if (ch == cb) break;
    }
    const size_t o = static_cast<size_t>(s) * Q + q;
    dmin[o] = r1;
    amin[o] = i1;
    d2[o] = r2;
    a2[o] = i2;
  }
}

}  // namespace

extern "C" int vloam_ring_min2(const float* queries, const float* slab_t,
                               float* dmin, int* amin, float* d2, int* a2,
                               int Q, int S, int C, void* stream) {
  const int per_block = kGroup * kQpt;
  const dim3 grid(S, (Q + per_block - 1) / per_block);
  ring_min2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, slab_t, dmin, amin, d2, a2, Q, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vloam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
