// S1: the two variants of the per-ring reduction behind LO association, and
// the packed-key reduction of its default form.
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
//   vloam_ring_min1_packed  the same inputs -> the smallest packed key per
//                       ring and query as (d [S,Q] f32, slot [S,Q] i32): the
//                       engines' LO association (impl "mxu"; "packed"), see
//                       below.
//
// What bounds them on Hopper: instruction issue, as K2 (ring_min2.cu, whose
// notes this follows). A (query, slot) pair costs 8 float instructions that
// may not fuse: (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// separately (__fmul_rn / __fadd_rn, build flag -fmad=false), as the plain
// PyTorch versions round, so that slots and distances match them bit for bit.
// At the corner shape the engines launch (768 queries x 64 rings x 128 slots,
// 6.3 M pairs) those 8 and one minimum a pair are ~1.7 us of issue on 132 SMs
// x 4 schedulers at 1.98 GHz; everything else is launch, staging and the
// update rule, and the design cuts the update rule and fills the schedulers:
//
// - ring_min1 is K2's first half with K2's loop. The slab is staged in
//   shared memory in tiles of kTile slots packed as float4 {x, y, z, -}, and a
//   thread holds kQpt queries in registers, so one broadcast 16-byte load
//   serves kQpt pairs instead of three 4-byte loads serving one. Queries are
//   strided over a group (q = base + j * kGroup + tid), so stores coalesce.
// - The loop tracks chunks, not slots, without branches: per chunk of kChunk
//   slots one fminf a pair, then (chunk minimum, chunk id) replaces the
//   running best chunk if its minimum is strictly smaller (one compare, one
//   select, one minimum a chunk). The minimum of a ring lies in the earliest
//   chunk that reaches it; a resolve pass over that chunk's slots with the
//   strict running rule finds its first slot. That is the iota-min rule of
//   the plain version: ties keep the lowest slot, an all-SENTINEL ring gives
//   slot 0.
// - Block shape: a block is kSplit groups of kGroup threads that hold the
//   same kGroup x kQpt queries, each group over its share of every tile's
//   chunks; the groups merge their best chunks by (minimum, chunk id) through
//   shared memory and resolve the queries between them, from the query
//   registers they already hold. At the corner shape 64 rings x 768 queries
//   with 4 queries a thread and one group of 64 are only 384 warps for 528
//   schedulers; 4 groups of 32 threads make 1536, 2.9 a scheduler, each
//   over a quarter of a ring, and 3072 at the surf shape. Chunks of 4 slots
//   keep the resolve pass short. tools/profile_ring_variants.py --shapes
//   times the others (PERF.md): the differences are a few tenths of a
//   microsecond, and at the corner shape the launch alone takes ~2.1 us and
//   everything but the chunk loop ~2.9 us of the kernel's ~5.5. The resolve
//   reads the winning chunk's slots from global memory (L1 / L2: the slab
//   was just staged from there).
// - Every slot of every ring is visited, SENTINEL slots included: live slots
//   need not be a prefix, and the bound counts them all. Inputs must be
//   finite (slabs pad with the finite SENTINEL): a ragged last chunk pads
//   with +inf coordinates, whose distance +inf never wins.
//
// ring_argmin2 is built on ring_min1's loop and block shape, with the whole
// ring staged once (float4 slots in dynamic shared memory, padded with
// +inf) in segments of `seg` chunks. Pass 1 is ring_min1's loop over
// segments: each segment's minimum per query is stored in shared memory and
// the best segment by (minimum, segment id) tracked, merged across groups.
// Pass 2 walks the stored minima with the winner's segment skipped: the
// best other segment. It reads what pass 1 computed, the same bits, instead
// of computing the distances again: a second pass over the distances (the
// first build) cost as much as the first, twice ring_min1's time (PERF.md).
// The resolve then walks the winner's segment twice (its first minimum:
// amin, dmin; then its minimum with amin's slot masked to kBig, as the plain
// version masks it) and, where the other segment beats that masked minimum
// by (minimum, segment id), that segment once. This is the plain version's
// argmin, mask, argmin: ties keep the lowest slot, duplicates give d2 ==
// dmin, an all-SENTINEL ring gives slots 0 and 1. A segment is one chunk
// while a ring's minima fit kStore bytes (C <= 256 at 32 KB), and longer
// above that (2 chunks at C = 512), so shared memory stays bounded at the
// cost of longer resolves; tools/profile_ring_variants.py --shapes times
// other budgets (at the surf shape 2048 x [64,3,512] on an H100 at 700 W,
// one run: 8 KB 48.2 us, 16 KB 39.2, 32 KB 38.4, 64 KB 59.2; longer
// resolves against fewer blocks an SM).
// Its outputs equal K2's four, bit for bit; ring_min1's equal K2's first
// two.
//
// ring_min1_packed is the reduction of ring_slab_assoc's default impl "mxu"
// and of "packed" (vloam_tpu/lidar/ring_assoc.py::ring_min1_mxu,
// ring_min1_packed; XLA in the reference, no Pallas kernel): per ring and
// query the smallest key (trunc(min(d, clip) * scale) << bits) | slot, one
// int32, returned as (d dequantized, slot). d is either form, rounded as the
// reference's compiled CPU code rounds it (XLA contracts each sum of
// products into fused multiply-adds) and as ring_assoc's plain versions
// emulate it, so all three agree bit for bit:
//   difference  fma(dz, dz, fma(dy, dy, dx * dx)), d = q - c
//   product     max((|q|^2 + |c|^2) - 2 q.c, 0), |p|^2 = fma(z, z, fma(y, y,
//               x * x)) and q.c = fma(qz, cz, fma(qy, cy, qx * cx)); |c|^2
//               is computed once a slot while the ring is staged (its 4th
//               float); s - 2 q.c is one fma(-2, q.c, s), as 2 q.c is exact
// What bounds it on Hopper: instruction issue. At the surf shape (1536
// queries x 64 rings x 512 slots, 50.3 M pairs) every instruction a pair
// costs 1.5 us on 132 SMs x 4 schedulers at 1.98 GHz; the operation bound
// (67 TFLOP/s) counts only the arithmetic, about half of what a pair
// issues. The first build issued ~13 a pair, among them a float-to-int
// conversion (F2I, a quarter of the float32 rate: 12 us of conversions
// alone at surf), the clip's minimum and the key's shift and OR. The design:
// - The truncation on the float32 pipe. With scale a power of two and
//   clip * scale <= M = 2^min(23, 30 - bits) (bits >= 7 at the reference's
//   64 m^2 clip: C >= 65), x = fma.rz.sat(d, scale / 2^24, 1 - M / 2^24)
//   lies in the binade [0.5, 1], whose unit is 2^-24: rounding toward zero
//   drops exactly the fraction of d * scale, so bits(x) = bits(1 - M /
//   2^24) + trunc(d * scale), and the saturation at 1.0 caps the count at
//   M. The clip costs no instruction: a key at or past the clip is at least
//   the clip's key at slot 0, (trunc(clip * scale) << bits), where the
//   minimum starts, and a ring whose keys all lie there ends there, as the
//   clipped reference does (its slot 0 then holds the clip's key).
// - The key in one integer multiply-add: bits(x) * 2^bits + (slot -
//   bits(1 - M / 2^24) * 2^bits), wrapping, is (trunc << bits) | slot
//   (below 2^31, as M * 2^bits <= 2^30). Then one integer minimum. That is
//   9 instructions a pair in either form (difference: 3 subtractions, a
//   product, 2 fma, the truncating fma, the multiply-add, the minimum;
//   product: a product, 2 fma for q.c, a sum, an fma, the max at 0, the
//   truncating fma, the multiply-add, the minimum), and once a slot for kQ
//   pairs a broadcast 16-byte load and the slot's constant. chip_smoke.py
//   phase 2 counts them in the built machine code and fails on an F2I in
//   the fast path.
// - Below 7 slot bits the count passes 2^23 and leaves the binade: those
//   rings (C <= 64) take the instantiation that keeps the conversion
//   (kFast false), with the same minimum, tie and clip rules.
// - Its own block shape: a block holds 32 x kQ queries of one ring, kW
//   warps split the ring's slots, kU slots an unrolled step: 4 queries a
//   thread, 4 warps, 8 slots. tools/profile_ring_variants.py --shapes times
//   others; of 14 this one was the fastest or within 0.2 us of it at both
//   engine shapes (PERF.md), so one shape serves every ring size.
// - What was right stays: the key carries its slot, so ties go to the
//   lowest slot, the warps' minima merge in any order and no resolve pass
//   runs; the whole ring is staged once for C <= kTile; SENTINEL slots are
//   visited (live slots need not be a prefix); the dequantizing epilogue.

#include <cmath>
#include <cstring>
#include <cuda_runtime.h>
#include <math_constants.h>

// ring_min1's block shape, settable from nvcc's command line for
// tools/profile_ring_variants.py --shapes, which times others.
#ifndef VLOAM_S1_GROUP
#define VLOAM_S1_GROUP 32
#endif
#ifndef VLOAM_S1_SPLIT
#define VLOAM_S1_SPLIT 4
#endif
#ifndef VLOAM_S1_QPT
#define VLOAM_S1_QPT 4
#endif
#ifndef VLOAM_S1_CHUNK
#define VLOAM_S1_CHUNK 4
#endif
// the part of ring_min1's and ring_min1_packed's work that runs, for the
// measurement: 0 all, 1 none (launch only), 2 all but the slot loop
#ifndef VLOAM_S1_PART
#define VLOAM_S1_PART 0
#endif
// ring_argmin2's shared memory for pass 1's segment minima, bytes a block
#ifndef VLOAM_A2_STORE
#define VLOAM_A2_STORE 32768
#endif
// ring_min1_packed's block shape: queries a thread, warps a block, slots an
// unrolled step; settable for tools/profile_ring_variants.py --shapes
#ifndef VLOAM_PK_QPT
#define VLOAM_PK_QPT 4
#endif
#ifndef VLOAM_PK_WARPS
#define VLOAM_PK_WARPS 4
#endif
#ifndef VLOAM_PK_UNROLL
#define VLOAM_PK_UNROLL 8
#endif

namespace {

constexpr float kBig = 3.9e12f;  // > any sentinel distance (~3e12)

// ring_min1's block shape (see the notes above)
constexpr int kGroup = VLOAM_S1_GROUP;  // threads that share a set of queries
constexpr int kSplit = VLOAM_S1_SPLIT;  // groups a block
constexpr int kMin1Threads = kSplit * kGroup;
constexpr int kQpt = VLOAM_S1_QPT;      // queries a thread
constexpr int kChunk = VLOAM_S1_CHUNK;  // slots a chunk
constexpr int kTile = 512;              // slots staged at a time
constexpr int kPart = VLOAM_S1_PART;
constexpr int kStore = VLOAM_A2_STORE;
static_assert(kTile % kChunk == 0, "a tile is whole chunks");

__device__ __forceinline__ float dist_sq(float qx, float qy, float qz,
                                         float cx, float cy, float cz) {
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

__global__ void __launch_bounds__(kMin1Threads)
ring_min1_kernel(const float* __restrict__ queries,  // [Q, 3]
                 const float* __restrict__ slab_t,   // [S, 3, C]
                 float* __restrict__ dmin, int* __restrict__ amin,
                 int Q, int C) {
  __shared__ float4 tile[kTile];
  // each group's best chunk per query: minimum and chunk id
  __shared__ float s_m[kSplit][kQpt][kGroup];
  __shared__ int s_c[kSplit][kQpt][kGroup];
  const int s = blockIdx.x;
  const int grp = threadIdx.x / kGroup;
  const int tid = threadIdx.x % kGroup;
  const float* ring = slab_t + static_cast<size_t>(s) * 3 * C;
  const int q0 = blockIdx.y * (kGroup * kQpt) + tid;
  if (kPart == 1) return;

  float qx[kQpt], qy[kQpt], qz[kQpt];
  float m1[kQpt];  // the smallest chunk minimum
  int c1[kQpt];    // and its chunk
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    // queries past Q repeat the last one and are not stored
    const int q = min(q0 + j * kGroup, Q - 1);
    qx[j] = queries[3 * q];
    qy[j] = queries[3 * q + 1];
    qz[j] = queries[3 * q + 2];
    m1[j] = CUDART_INF_F;
    c1[j] = 0;
  }

  for (int t0 = 0; t0 < C; t0 += kTile) {
    const int n = min(kTile, C - t0);
    const int n_chunks = (n + kChunk - 1) / kChunk;
    __syncthreads();  // the previous tile is done with
    for (int i = threadIdx.x; i < n_chunks * kChunk; i += kMin1Threads) {
      const int c = t0 + i;
      tile[i] = c < C ? make_float4(ring[c], ring[C + c], ring[2 * C + c], 0.f)
                      : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                    0.f);
    }
    __syncthreads();
    // group g takes the g-th share of the tile's chunks
    const int per = (n_chunks + kSplit - 1) / kSplit;
    const int ch_end = kPart == 2 ? 0 : min(n_chunks, (grp + 1) * per);
    for (int ch = grp * per; ch < ch_end; ++ch) {
      float lo[kQpt];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        // one broadcast load for kQpt queries
        const float4 p = tile[ch * kChunk + k];
#pragma unroll
        for (int j = 0; j < kQpt; ++j) {
          const float d = dist_sq(qx[j], qy[j], qz[j], p.x, p.y, p.z);
          lo[j] = k == 0 ? d : fminf(lo[j], d);
        }
      }
      const int id = t0 / kChunk + ch;
#pragma unroll
      for (int j = 0; j < kQpt; ++j) {
        c1[j] = lo[j] < m1[j] ? id : c1[j];
        m1[j] = fminf(m1[j], lo[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    s_m[grp][j][tid] = m1[j];
    s_c[grp][j][tid] = c1[j];
  }
  __syncthreads();

  // the groups share the queries: merge the groups' best chunks, then the
  // strict running rule over the winning chunk's slots, in slot order
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const int q = q0 + j * kGroup;
    if (j % kSplit != grp || q >= Q) continue;
    float bm = s_m[0][j][tid];
    int bc = s_c[0][j][tid];
#pragma unroll
    for (int g = 1; g < kSplit; ++g) {
      const float m = s_m[g][j][tid];
      const int c = s_c[g][j][tid];
      if (before(m, c, bm, bc)) {
        bm = m;
        bc = c;
      }
    }
    const float x = qx[j], y = qy[j], z = qz[j];
    const int c0 = bc * kChunk;
    float r1 = CUDART_INF_F;
    int i1 = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = c0 + k;
      if (c >= C) break;  // a ragged last chunk
      const float d = dist_sq(x, y, z, __ldg(ring + c), __ldg(ring + C + c),
                              __ldg(ring + 2 * C + c));
      if (d < r1) {
        r1 = d;
        i1 = c;
      }
    }
    const size_t o = static_cast<size_t>(s) * Q + q;
    dmin[o] = r1;
    amin[o] = i1;
  }
}

// The groups' best segment for query slot j of this thread: the smallest
// minimum, the earliest segment on ties.
__device__ __forceinline__ void merge_groups(float (*s_m)[kQpt][kGroup],
                                             int (*s_c)[kQpt][kGroup], int j,
                                             int tid, float& bm, int& bc) {
  bm = s_m[0][j][tid];
  bc = s_c[0][j][tid];
#pragma unroll
  for (int g = 1; g < kSplit; ++g) {
    const float m = s_m[g][j][tid];
    const int c = s_c[g][j][tid];
    if (before(m, c, bm, bc)) {
      bm = m;
      bc = c;
    }
  }
}

// The strict running minimum over segment `sg`'s L slots in slot order,
// slot `masked` counted as kBig: (minimum, its first slot).
__device__ __forceinline__ void resolve(const float4* tile, int sg, int L,
                                        int C, float x, float y, float z,
                                        int masked, float& best, int& slot) {
  best = CUDART_INF_F;
  slot = sg * L;
  const int end = min(C, (sg + 1) * L);  // a ragged last segment
  for (int c = sg * L; c < end; ++c) {
    const float4 p = tile[c];
    const float d = c == masked ? kBig : dist_sq(x, y, z, p.x, p.y, p.z);
    if (d < best) {
      best = d;
      slot = c;
    }
  }
}

// tile: the ring as float4 slots, n_segs segments of seg * kChunk slots
// (+inf past C); seg_min: pass 1's minimum per (segment, query),
// [n_segs][kQpt][kGroup].
__global__ void __launch_bounds__(kMin1Threads)
ring_argmin2_kernel(const float* __restrict__ queries,  // [Q, 3]
                    const float* __restrict__ slab_t,   // [S, 3, C]
                    float* __restrict__ dmin, int* __restrict__ amin,
                    float* __restrict__ d2, int* __restrict__ a2, int Q,
                    int C, int seg, int n_segs) {
  extern __shared__ float4 smem[];
  const int L = seg * kChunk;  // slots a segment
  float4* tile = smem;
  float* seg_min = reinterpret_cast<float*>(smem + n_segs * L);
  __shared__ float s_m[kSplit][kQpt][kGroup];
  __shared__ int s_c[kSplit][kQpt][kGroup];
  const int s = blockIdx.x;
  const int grp = threadIdx.x / kGroup;
  const int tid = threadIdx.x % kGroup;
  const float* ring = slab_t + static_cast<size_t>(s) * 3 * C;
  const int q0 = blockIdx.y * (kGroup * kQpt) + tid;

  for (int i = threadIdx.x; i < n_segs * L; i += kMin1Threads)
    tile[i] = i < C ? make_float4(ring[i], ring[C + i], ring[2 * C + i], 0.f)
                    : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                  0.f);
  float qx[kQpt], qy[kQpt], qz[kQpt], m1[kQpt];
  int c1[kQpt];
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    // queries past Q repeat the last one and are not stored
    const int q = min(q0 + j * kGroup, Q - 1);
    qx[j] = queries[3 * q];
    qy[j] = queries[3 * q + 1];
    qz[j] = queries[3 * q + 2];
    m1[j] = CUDART_INF_F;
    c1[j] = 0;
  }
  __syncthreads();

  // pass 1 over the staged ring, group g over the g-th share of its
  // segments: every segment's minimum stored, the best segment tracked
  const int per = (n_segs + kSplit - 1) / kSplit;
  const int sg_end = min(n_segs, (grp + 1) * per);
  for (int sg = grp * per; sg < sg_end; ++sg) {
    float lo[kQpt];
#pragma unroll
    for (int j = 0; j < kQpt; ++j) lo[j] = CUDART_INF_F;
    for (int ch = sg * seg; ch < (sg + 1) * seg; ++ch) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        // one broadcast load for kQpt queries
        const float4 p = tile[ch * kChunk + k];
#pragma unroll
        for (int j = 0; j < kQpt; ++j)
          lo[j] = fminf(lo[j], dist_sq(qx[j], qy[j], qz[j], p.x, p.y, p.z));
      }
    }
#pragma unroll
    for (int j = 0; j < kQpt; ++j) {
      seg_min[(sg * kQpt + j) * kGroup + tid] = lo[j];
      c1[j] = lo[j] < m1[j] ? sg : c1[j];
      m1[j] = fminf(m1[j], lo[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    s_m[grp][j][tid] = m1[j];
    s_c[grp][j][tid] = c1[j];
  }
  __syncthreads();

  // query j is finished by group j % kSplit: the winner's segment w, pass 2
  // over pass 1's stored minima with w skipped, then the resolves
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const int q = q0 + j * kGroup;
    if (j % kSplit != grp || q >= Q) continue;
    float bm;
    int w, bc = 0;
    merge_groups(s_m, s_c, j, tid, bm, w);
    bm = CUDART_INF_F;
    for (int sg = 0; sg < n_segs; ++sg) {
      const float l =
          sg == w ? CUDART_INF_F : seg_min[(sg * kQpt + j) * kGroup + tid];
      bc = l < bm ? sg : bc;
      bm = fminf(bm, l);
    }
    float r1, r2;
    int i1, i2;
    resolve(tile, w, L, C, qx[j], qy[j], qz[j], -1, r1, i1);
    resolve(tile, w, L, C, qx[j], qy[j], qz[j], i1, r2, i2);
    if (before(bm, bc, r2, w))
      resolve(tile, bc, L, C, qx[j], qy[j], qz[j], -1, r2, i2);
    const size_t o = static_cast<size_t>(s) * Q + q;
    dmin[o] = r1;
    amin[o] = i1;
    d2[o] = r2;
    a2[o] = i2;
  }
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// ring_min1_packed's quantization (see the notes above). The fast path's
// truncation takes k = scale / 2^24, base = 1 - M / 2^24 and the key's
// constant key0 = -(bits(base) << bits); the conversion path takes scale
// and clip. Both start the minimum at clip_key, the clip's key at slot 0.
struct PackedQuant {
  int bits;
  unsigned pow2;  // 2^bits
  int clip_key;
  float inv_scale;
  float k, base;  // fast path
  unsigned key0;
  float scale, clip;  // conversion path
};

// x = d * k + base rounded toward zero and saturated to [0, 1]: one FFMA
__device__ __forceinline__ float fma_rz_sat(float d, float k, float base) {
  float x;
  asm("fma.rz.sat.f32 %0, %1, %2, %3;" : "=f"(x) : "f"(d), "f"(k), "f"(base));
  return x;
}

// The packed key of one (query, slot) pair. kFast: bits(x) * 2^bits +
// (slot - bits(base) * 2^bits), wrapping (below 2^31 by construction);
// else (trunc(min(d, clip) * scale) << bits) | slot with the conversion.
template <bool kProduct, bool kFast>
__device__ __forceinline__ int packed_key(float qx, float qy, float qz,
                                          float qq, const float4& p,
                                          unsigned slot_key, int col,
                                          const PackedQuant& pq) {
  float d;
  if (kProduct) {
    const float qc =
        __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
    // s - 2 q.c in one rounding: 2 q.c is exact
    d = fmaxf(__fmaf_rn(-2.f, qc, __fadd_rn(qq, p.w)), 0.f);
  } else {
    d = sq_norm(__fsub_rn(qx, p.x), __fsub_rn(qy, p.y), __fsub_rn(qz, p.z));
  }
  if (kFast)
    return static_cast<int>(
        static_cast<unsigned>(__float_as_int(fma_rz_sat(d, pq.k, pq.base))) *
            pq.pow2 +
        slot_key);
  return (__float2int_rz(__fmul_rn(fminf(d, pq.clip), pq.scale)) << pq.bits) |
         col;
}

// A block holds 32 * kQ queries of one ring (kQ a thread, strided by 32 so
// stores coalesce); its kW warps split each staged tile's slots, kU slots
// an unrolled step, and merge their minima through shared memory.
template <bool kProduct, bool kFast, int kQ, int kW, int kU>
__global__ void __launch_bounds__(kW * 32)
ring_min1_packed_kernel(const float* __restrict__ queries,  // [Q, 3]
                        const float* __restrict__ slab_t,   // [S, 3, C]
                        float* __restrict__ dout, int* __restrict__ aout,
                        int Q, int C, PackedQuant pq) {
  constexpr int kThreads = kW * 32;
  __shared__ float4 tile[kTile];  // {x, y, z, |c|^2 or 0}
  __shared__ int s_k[kW][kQ][32];
  const int s = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* ring = slab_t + static_cast<size_t>(s) * 3 * C;
  const int q0 = blockIdx.y * (32 * kQ) + lane;
  if (kPart == 1) return;

  float qx[kQ], qy[kQ], qz[kQ], qq[kQ];
  int best[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    // queries past Q repeat the last one and are not stored
    const int q = min(q0 + j * 32, Q - 1);
    qx[j] = queries[3 * q];
    qy[j] = queries[3 * q + 1];
    qz[j] = queries[3 * q + 2];
    qq[j] = kProduct ? sq_norm(qx[j], qy[j], qz[j]) : 0.f;
    best[j] = pq.clip_key;
  }

  for (int t0 = 0; t0 < C; t0 += kTile) {
    const int n = min(kTile, C - t0);
    __syncthreads();  // the previous tile is done with
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float x = ring[t0 + i], y = ring[C + t0 + i],
                  z = ring[2 * C + t0 + i];
      tile[i] = make_float4(x, y, z, kProduct ? sq_norm(x, y, z) : 0.f);
    }
    __syncthreads();
    // warp w takes the w-th share of the tile's slots, in whole steps
    const int per = ((n + kW - 1) / kW + kU - 1) / kU * kU;
    const int end = kPart == 2 ? 0 : min(n, (warp + 1) * per);
    const unsigned key_t0 = pq.key0 + t0;
    int i = warp * per;
#pragma unroll 1
    for (; i + kU <= end; i += kU) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float4 p = tile[i + u];  // one broadcast load for kQ pairs
#pragma unroll
        for (int j = 0; j < kQ; ++j)
          best[j] = min(best[j], packed_key<kProduct, kFast>(
                                     qx[j], qy[j], qz[j], qq[j], p,
                                     key_t0 + i + u, t0 + i + u, pq));
      }
    }
#pragma unroll 1
    for (; i < end; ++i) {  // the share's ragged end
      const float4 p = tile[i];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        best[j] = min(best[j], packed_key<kProduct, kFast>(
                                   qx[j], qy[j], qz[j], qq[j], p, key_t0 + i,
                                   t0 + i, pq));
    }
  }

#pragma unroll
  for (int j = 0; j < kQ; ++j) s_k[warp][j][lane] = best[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int q = q0 + j * 32;
    if (j % kW != warp || q >= Q) continue;
    int m = s_k[0][j][lane];
#pragma unroll
    for (int w = 1; w < kW; ++w) m = min(m, s_k[w][j][lane]);
    const size_t o = static_cast<size_t>(s) * Q + q;
    dout[o] = __fmul_rn(__int2float_rn(m >> pq.bits), pq.inv_scale);
    aout[o] = m & static_cast<int>(pq.pow2 - 1);
  }
}

template <bool kProduct, bool kFast, int kQ, int kW, int kU>
cudaError_t launch_packed(const float* queries, const float* slab_t,
                          float* dout, int* aout, int Q, int S, int C,
                          const PackedQuant& pq, cudaStream_t st) {
  const dim3 grid(S, (Q + 32 * kQ - 1) / (32 * kQ));
  ring_min1_packed_kernel<kProduct, kFast, kQ, kW, kU>
      <<<grid, kW * 32, 0, st>>>(queries, slab_t, dout, aout, Q, C, pq);
  return cudaGetLastError();
}

// Both forms, fast path or conversion, at the block shape
template <bool kProduct>
cudaError_t launch_packed_form(bool fast, const float* queries,
                               const float* slab_t, float* dout, int* aout,
                               int Q, int S, int C, const PackedQuant& pq,
                               cudaStream_t st) {
  constexpr int kQ = VLOAM_PK_QPT, kW = VLOAM_PK_WARPS, kU = VLOAM_PK_UNROLL;
  return fast ? launch_packed<kProduct, true, kQ, kW, kU>(
                    queries, slab_t, dout, aout, Q, S, C, pq, st)
              : launch_packed<kProduct, false, kQ, kW, kU>(
                    queries, slab_t, dout, aout, Q, S, C, pq, st);
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
  const int per_block = kGroup * kQpt;
  const dim3 grid(S, (Q + per_block - 1) / per_block);
  ring_min1_kernel<<<grid, kMin1Threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      queries, slab_t, dmin, amin, Q, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vloam_ring_argmin2(const float* queries, const float* slab_t,
                                  float* dmin, int* amin, float* d2, int* a2,
                                  int Q, int S, int C, void* stream) {
  // segments of seg chunks, so that pass 1's minima fit kStore bytes
  const int per_seg = kQpt * kGroup * static_cast<int>(sizeof(float));
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int seg = max(1, (n_chunks * per_seg + kStore - 1) / kStore);
  const int n_segs = (n_chunks + seg - 1) / seg;
  const size_t smem = static_cast<size_t>(n_segs) *
                      (seg * kChunk * sizeof(float4) + per_seg);
  const cudaError_t e = allow_smem(ring_argmin2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_block = kGroup * kQpt;
  const dim3 grid(S, (Q + per_block - 1) / per_block);
  ring_argmin2_kernel<<<grid, kMin1Threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      queries, slab_t, dmin, amin, d2, a2, Q, C, seg, n_segs);
  return static_cast<int>(cudaGetLastError());
}

// product: the |q|^2 + |c|^2 - 2 q.c form ("mxu"), else the difference form
// ("packed"). bits: slot bits (2^bits >= C); scale: the quantization scale,
// a power of two; clip: the saturation. Inputs must be finite.
extern "C" int vloam_ring_min1_packed(const float* queries,
                                      const float* slab_t, float* dout,
                                      int* aout, int Q, int S, int C,
                                      int product, int bits, float scale,
                                      float clip, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PackedQuant pq{};
  pq.bits = bits;
  pq.pow2 = 1u << bits;
  pq.scale = scale;
  pq.clip = clip;
  pq.inv_scale = 1.f / scale;  // exact: scale is a power of two
  // the clip's count, truncated as the kernel truncates (exact product)
  pq.clip_key = static_cast<int>(clip * scale) << bits;
  // the fast path: counts up to M in one binade of unit 1 (see the notes)
  int e;
  const bool pow2_scale = std::frexp(scale, &e) == 0.5f;
  const unsigned M = 1u << min(23, 30 - bits);
  const bool fast = pow2_scale && clip >= 0.f &&
                    static_cast<double>(clip) * scale <= M;
  if (fast) {
    pq.k = std::ldexp(scale, -24);
    const unsigned base_bits = 0x3F800000u - M;  // 1 - M / 2^24
    std::memcpy(&pq.base, &base_bits, sizeof(float));
    pq.key0 = 0u - (base_bits << bits);
  }
  return static_cast<int>(
      product ? launch_packed_form<true>(fast, queries, slab_t, dout, aout, Q,
                                         S, C, pq, st)
              : launch_packed_form<false>(fast, queries, slab_t, dout, aout,
                                          Q, S, C, pq, st));
}
