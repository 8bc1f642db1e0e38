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
// What bounds it on Hopper: instruction issue over the live pairs. A pair
// needs 3 products and 4 sums that may not fuse (7 float instructions), so
// the float32 rate (67 TFLOP/s at 6 operations a pair) is not the limit
// that counts; what the card issues is 132 SMs x 4 schedulers x 32 lanes an
// instruction a clock. At ~10 instructions a pair the mesh windows' live
// pairs (2048 x 16,867 corner, 6144 x 19,915 surf) take 10 / 36 us of issue
// at 1.98 GHz; over every slot (131,072 and 65,536) it was 79 / 119 us.
// Bytes are nothing: ~2 MB in, 0.5 MB out.
//
// The design:
// - One thread a query, its running top-k in registers: k (bits, index)
//   pairs sorted ascending, and thr, the k-th entry's distance as a float
//   (NaN while the list holds sentinels, which are (0x7FFFFFFF, INT_MAX)).
//   A slot is examined only if !(x >= th) (one FSETP.LTU), th the smaller of
//   thr and the bound other slices published (below). Within a thread slots
//   come in increasing index order, so a slot that ties the k-th distance
//   loses its key compare, and the strict compare with thr is exact; NaN
//   examines every slot. The main loop tests kStep slots a step (16
//   compares or-ed, one branch); the warp leaves it together when a lane
//   has a passing slot (__any_sync: its lanes stay on one step, so the
//   shared loads stay broadcasts) and examines the step: for each slot the
//   key, the full (bits, index) compare and a sorted insertion by selects,
//   so ties and NaN order as the int64 keys do.
// - Masked slots stay out of the sweep. The candidates' raw tiles of kTile
//   slots are dealt to gridDim.y slices (slice s takes tiles s, s + S, ...:
//   every slice gets the same mix of a mesh window's near and far rows,
//   whose rows come nearest first and empty rows last). A block reads its
//   slice's raw tiles in order, kRound tiles a round (4 slots a thread, all
//   loads in flight together), and a ballot / popc prefix (one warp's
//   shuffle scan over the round's groups of 32 slots) packs the live
//   slots, in index order, into a shared buffer of
//   x, y, z, |c|^2 and the index; the main loop sweeps the buffer a full
//   kTile of live slots at a time (the slice's remainder once at its end),
//   and what is left of a round moves to the buffer's front. A masked
//   slot's distance is +inf whenever its coordinates and the query's are
//   below 2^60 in magnitude ("tame": no product or sum can reach inf or
//   NaN), so its key is (+inf, index) and only the k of lowest index in a
//   slice can matter: the block records those k and every tame query's list
//   takes them after its sweep; the merge takes the padding slots. A masked
//   slot that is not tame is swept like a live one, and a query that is not
//   tame compares its slice's masked slots one by one after its sweep, with
//   their computed distances: the result stays the plain version's for any
//   input.
// - One bound a query, shared by its slices: a full list's k-th distance b
//   bounds the query's global k-th distance, so after each examination
//   that improved it a thread publishes b (an atomicMax on 0x7FFFFFFF -
//   (bits(b) + 1), a word a query in the scratch, zeroed before the launch:
//   distances are >= 0, so their bits order as the floats) and it reads the
//   smallest one published at each sweep's start and after each
//   examination (the read in flight while the examination runs): the
//   slices, which fill their lists at the same time, pool what they found
//   from the first steps on. Against
//   another slice's b only slots beyond b may be skipped (they come in no
//   order with that slice's), so th = fminf(thr, nextafterf(b, +inf)), one
//   compare a slot: a slot at exactly b is still examined. A word of 0
//   reads as NaN, which fminf ignores; an infinite b is never published.
// - Each block writes its slice's top-k; a second launch merges a query's
//   slice lists by key (the order is total, so the merge is exact in any
//   order), kMergeLanes threads a query (one thread walking 33 slices' lists
//   was a chain of 33 dependent loads), and takes the padding slots. The
//   wrapper picks the slices from the SM count (kernels.knn_slices). No
//   [Q, C] tile reaches memory.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/profile_knn.py on
// its synthetic mesh windows, ~9,000 live slots of 131,072 / 65,536; PERF.md
// section 6 has the mesh engine's own windows): the main loop is 10.31
// instructions a pair in the machine code (16 LDS.128, 112 float
// instructions, 16 FSETP, the vote and the loop a step of 16 slots). A call
// takes 51 / 92 us at the corner / surf window; of it ~23 / ~26 us are
// staging, merge, memset and launches (a window with every slot masked),
// the main loop with its staging ~26 / ~42 alone, the examination the
// rest: now what bounds the kernel, as each
// slice fills its lists again from a few hundred live slots (the mesh
// engine's windows: ~256 a slice at corner, ~905 at surf).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;  // queries a block (kernels.KNN_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // slots a raw tile and a sweep (KNN_TILE)
constexpr int kRound = 2;  // raw tiles a staging round reads (1, 4 slower)
constexpr int kRaw = kRound * kTile / kThreads;  // raw slots a thread stages
constexpr int kGroups = kRaw * kWarps;  // a round's groups of 32 slots
constexpr int kStep = 16;  // slots the main loop tests a step (KNN_STEP)
// the buffer: under a tile left over, a round's live slots, a step's padding
constexpr int kBuf = kTile + kRound * kTile + kStep;
static_assert(kTile % kThreads == 0 && kGroups <= 32,
              "one warp's lanes scan a round's groups");
static_assert(kTile % kStep == 0 && kBuf % 4 == 0,
              "a sweep is whole steps of whole float4 groups");
constexpr int kSentBits = INT_MAX;  // a NaN pattern: thr compares unordered
constexpr int kSentIdx = INT_MAX;
constexpr int kInfBits = 0x7F800000;
constexpr float kTame = 0x1p60f;  // |coordinate| bound of a "tame" point
constexpr int kMergeLanes = 8;  // merge threads a query (1, 4 slower)
static_assert(32 % kMergeLanes == 0, "a warp holds whole queries' lanes");
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

// every coordinate finite and at most 2^60 in magnitude (NaN is not)
__device__ __forceinline__ bool tame(float x, float y, float z) {
  return fabsf(x) <= kTame && fabsf(y) <= kTame && fabsf(z) <= kTame;
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

// (b, i) into the list if its key is below the last entry's
template <int K>
__device__ __forceinline__ void offer(int (&kb)[K], int (&ki)[K], int b,
                                      int i) {
  if (key_less(b, i, kb[K - 1], ki[K - 1])) insert<K>(kb, ki, b, i);
}

// The slow path of one slot g with unclamped distance x: th, the sweep's
// threshold, follows thr down (lim: the published bound's, NaN if none).
template <int K>
__device__ __forceinline__ void examine(int (&kb)[K], int (&ki)[K],
                                        float& thr, float& th, float lim,
                                        float x, int g, int C, int Cv) {
  if (!(x >= th) && g < Cv) {
    float d = x < 0.f ? 0.f : x;  // torch.clamp(min=0): NaN stays NaN
    if (g >= C) d = __int_as_float(kInfBits);  // a padding slot: +inf
    const int b = __float_as_int(d);
    if (key_less(b, g, kb[K - 1], ki[K - 1])) {
      insert<K>(kb, ki, b, g);
      thr = __int_as_float(kb[K - 1]);
      th = fminf(thr, lim);
    }
  }
}

// the published bound of a query, as another block may have left it
__device__ __forceinline__ int read_bound(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// A bound word's strict threshold: nextafterf(b, +inf) for the smallest b
// published (the word 0x7FFFFFFF - (bits(b) + 1)); NaN for the word 0.
__device__ __forceinline__ float bound_limit(int w) {
  return __int_as_float(0x7FFFFFFF - w);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_slice_kernel(const float* __restrict__ queries,     // [Q, 3]
                 const float* __restrict__ cands,       // [C, 3]
                 const unsigned char* __restrict__ mask,  // [C]
                 int Q, int C, int Cv,
                 int* __restrict__ part_b,   // [S, K, Q]
                 int* __restrict__ part_i,   // [S, K, Q]
                 int* __restrict__ bound) {  // [Q], zeroed
  // the sweep's buffer: x, y, z, |c|^2 (+inf where masked) and index
  __shared__ float4 s_x[kBuf / 4], s_y[kBuf / 4], s_z[kBuf / 4],
      s_c[kBuf / 4];
  __shared__ int s_g[kBuf];
  __shared__ int s_cnt[2][kGroups];  // live, masked slots by group
  __shared__ int s_off[2][kGroups];  // their exclusive prefix sums
  __shared__ int s_tot[2];
  __shared__ int s_inf[K];  // the slice's first K tame masked slots
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int qr = min(q, Q - 1);  // threads past Q compute and store nothing
  const float* const qp = queries + 3 * static_cast<size_t>(qr);
  const float q0 = qp[0], q1 = qp[1], q2 = qp[2];
  const bool q_tame = tame(q0, q1, q2);
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
  float lim = __int_as_float(kSentBits);  // NaN: no bound published yet
  int published = 0;  // the largest word this thread wrote
  float* const fx = reinterpret_cast<float*>(s_x);
  float* const fy = reinterpret_cast<float*>(s_y);
  float* const fz = reinterpret_cast<float*>(s_z);
  float* const fc = reinterpret_cast<float*>(s_c);
  int hits = 0;  // kPart 1: the steps that would stop

  // Sweep buffer slots [4 v, 4 v_end) (whole steps). The bound is read at
  // the start and after every examination (the read in flight while it
  // runs), and published when an examination improved thr.
  auto sweep = [&](int v, int v_end) {
    lim = fminf(lim, bound_limit(read_bound(bound + qr)));
    float th = fminf(thr, lim);
    float xs[kStep];  // the unclamped distances of the step that stopped
    for (;;) {
      // the hot path: kStep slots a step, until one may enter the list
      for (; v < v_end; v += kStep / 4) {
        bool any = false;
#pragma unroll
        for (int u = 0; u < kStep / 4; ++u) {
          const float4 X = s_x[v + u], Y = s_y[v + u], Z = s_z[v + u],
                       W = s_c[v + u];
          xs[4 * u] = expanded(qq, m0, m1, m2, X.x, Y.x, Z.x, W.x);
          xs[4 * u + 1] = expanded(qq, m0, m1, m2, X.y, Y.y, Z.y, W.y);
          xs[4 * u + 2] = expanded(qq, m0, m1, m2, X.z, Y.z, Z.z, W.z);
          xs[4 * u + 3] = expanded(qq, m0, m1, m2, X.w, Y.w, Z.w, W.w);
          any |= !(xs[4 * u] >= th) | !(xs[4 * u + 1] >= th) |
                 !(xs[4 * u + 2] >= th) | !(xs[4 * u + 3] >= th);
        }
        if (kPart == 1)
          hits += any;
        else if (__any_sync(0xFFFFFFFFu, any))
          break;
      }
      if (v >= v_end) break;
      const int w = read_bound(bound + qr);
      // the examination of the step's slots, in index order
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        examine<K>(kb, ki, thr, th, lim, xs[u], s_g[4 * v + u], C, Cv);
      if (thr < __int_as_float(kInfBits)) {
        const int mine = 0x7FFFFFFF - (__float_as_int(thr) + 1);
        if (mine > published) {
          atomicMax(bound + qr, mine);
          published = mine;
        }
      }
      lim = fminf(lim, bound_limit(w));
      th = fminf(thr, lim);
      v += kStep / 4;
    }
  };

  const int n_raw = (C + kTile - 1) / kTile;  // padding: the merge's
  const int S = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;  // the lanes before this one
  int fill = 0;   // live slots in the buffer (the same in every thread)
  int n_inf = 0;  // tame masked slots recorded, at most K
  for (int t = blockIdx.y;; t += kRound * S) {
    const bool last = t >= n_raw;
    if (!last) {
      // stage kRound raw tiles t, t + S, ...: their live slots packed
      // after the buffer's, in index order. Slot i of a thread lies in
      // tile t + (i / 2) S, at (i % 2) kThreads + threadIdx.x; group
      // i kWarps + warp holds a warp's 32 slots of one i.
      float cx[kRaw], cy[kRaw], cz[kRaw];
      unsigned cm = 0;  // bit i: slot i's mask
#pragma unroll
      for (int i = 0; i < kRaw; ++i) {
        const int tile = t + (i / 2) * S;
        const int g = tile * kTile + (i % 2) * kThreads + threadIdx.x;
        cx[i] = cy[i] = cz[i] = 0.f;
        if (tile < n_raw && g < C) {
          const float* const cp = cands + 3 * static_cast<size_t>(g);
          cx[i] = __ldg(cp);
          cy[i] = __ldg(cp + 1);
          cz[i] = __ldg(cp + 2);
          cm |= static_cast<unsigned>(__ldg(mask + g) != 0) << i;
        }
      }
      unsigned lb[kRaw], ib[kRaw];
#pragma unroll
      for (int i = 0; i < kRaw; ++i) {
        const int tile = t + (i / 2) * S;
        const int g = tile * kTile + (i % 2) * kThreads + threadIdx.x;
        const bool in = tile < n_raw && g < C;
        const bool live =
            in && ((cm >> i & 1) || !tame(cx[i], cy[i], cz[i]));
        lb[i] = __ballot_sync(0xFFFFFFFFu, live);
        ib[i] = __ballot_sync(0xFFFFFFFFu, in && !live);
        if (lane == 0) {
          s_cnt[0][i * kWarps + warp] = __popc(lb[i]);
          s_cnt[1][i * kWarps + warp] = __popc(ib[i]);
        }
      }
      __syncthreads();  // the groups' counts
      if (warp < 2) {  // warp 0 scans the live counts, warp 1 the masked
        const int v = lane < kGroups ? s_cnt[warp][lane] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const int o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane >= d) incl += o;
        }
        if (lane < kGroups) s_off[warp][lane] = incl - v;
        if (lane == 31) s_tot[warp] = incl;
      }
      __syncthreads();  // the groups' offsets
#pragma unroll
      for (int i = 0; i < kRaw; ++i) {
        const int tile = t + (i / 2) * S;
        const int g = tile * kTile + (i % 2) * kThreads + threadIdx.x;
        if (lb[i] >> lane & 1) {
          const int p =
              fill + s_off[0][i * kWarps + warp] + __popc(lb[i] & below);
          fx[p] = cx[i];
          fy[p] = cy[i];
          fz[p] = cz[i];
          fc[p] = (cm >> i & 1) ? sq_norm(cx[i], cy[i], cz[i])
                                : __int_as_float(kInfBits);
          s_g[p] = g;
        }
        if (ib[i] >> lane & 1) {
          const int p =
              n_inf + s_off[1][i * kWarps + warp] + __popc(ib[i] & below);
          if (p < K) s_inf[p] = g;
        }
      }
      fill += s_tot[0];
      n_inf = min(K, n_inf + s_tot[1]);
      // staged; without a sweep to follow, the next round's first
      // __syncthreads keeps its counts from overtaking these reads
      if (fill >= kTile) __syncthreads();
    } else {
      if (fill == 0) break;
      // the slice's remainder, padded to whole steps with slots that
      // never enter a list (index past Cv)
      const int n = (fill + kStep - 1) / kStep * kStep;
      for (int j = fill + threadIdx.x; j < n; j += kThreads) {
        fx[j] = fy[j] = fz[j] = 0.f;
        fc[j] = __int_as_float(kInfBits);
        s_g[j] = INT_MAX;
      }
      __syncthreads();
    }
    // every full kTile of live slots; at the end the remainder
    int base = 0;
    while (fill - base >= kTile || (last && base < fill)) {
      const int n = min(kTile, (fill - base + kStep - 1) / kStep * kStep);
      sweep(base / 4, (base + n) / 4);
      base += n;
    }
    if (last) break;
    if (base > 0) {
      __syncthreads();  // the buffer is read
      for (int j = threadIdx.x; j < fill - base; j += kThreads) {
        fx[j] = fx[base + j];
        fy[j] = fy[base + j];
        fz[j] = fz[base + j];
        fc[j] = fc[base + j];
        s_g[j] = s_g[base + j];
      }
      fill -= base;
      __syncthreads();  // moved to the front
    }
  }
  if (kPart == 0) {
    // the tame masked slots: (+inf, index) for a tame query; one by one
    // with their distances for the others
    __syncthreads();  // s_inf written
    if (q_tame) {
      for (int j = 0; j < n_inf; ++j) offer<K>(kb, ki, kInfBits, s_inf[j]);
    } else {
      for (int r = blockIdx.y; r < n_raw; r += S) {
        for (int g = r * kTile; g < min(C, (r + 1) * kTile); ++g) {
          const float* const cp = cands + 3 * static_cast<size_t>(g);
          const float x = __ldg(cp), y = __ldg(cp + 1), z = __ldg(cp + 2);
          if (__ldg(mask + g) || !tame(x, y, z)) continue;
          const float e = expanded(qq, m0, m1, m2, x, y, z,
                                   __int_as_float(kInfBits));
          offer<K>(kb, ki, __float_as_int(e < 0.f ? 0.f : e), g);
        }
      }
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

// kMergeLanes threads a query: each merges every kMergeLanes-th slice's
// sorted list by key, then the lanes' lists meet by shuffles (halving), and
// the first lane takes the padding slots C .. Cv-1 as (+inf, index), which
// the slices leave out. The key order is total: exact in any order.

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const int* __restrict__ part_b, const int* __restrict__ part_i,
                 int Q, int S, int C, int Cv, float* __restrict__ out_d,
                 long long* __restrict__ out_idx) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int q = t / kMergeLanes, lane = t % kMergeLanes;
  const int qr = min(q, Q - 1);  // lanes past Q shuffle and store nothing
  int kb[K], ki[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    kb[j] = kSentBits;
    ki[j] = kSentIdx;
  }
  for (int s = lane; s < S; s += 2 * kMergeLanes) {
    int b[2][K], i[2][K];  // two slices' lists, their loads in flight at once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sh = s + h * kMergeLanes;
      const size_t base = static_cast<size_t>(min(sh, S - 1)) * K * Q + qr;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        b[h][j] = sh < S ? __ldg(part_b + base + static_cast<size_t>(j) * Q)
                         : kSentBits;
        i[h][j] = sh < S ? __ldg(part_i + base + static_cast<size_t>(j) * Q)
                         : kSentIdx;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < K; ++j) offer<K>(kb, ki, b[h][j], i[h][j]);
  }
#pragma unroll
  for (int d = kMergeLanes / 2; d > 0; d /= 2) {
    int b[K], i[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      b[j] = __shfl_down_sync(0xFFFFFFFFu, kb[j], d);
      i[j] = __shfl_down_sync(0xFFFFFFFFu, ki[j], d);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) offer<K>(kb, ki, b[j], i[j]);
  }
  if (lane != 0 || q >= Q) return;
  for (int g = C; g < Cv; ++g) offer<K>(kb, ki, kInfBits, g);
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
  int* const bound = scratch + 2 * static_cast<size_t>(slices) * K * Q;
  cudaError_t err =
      cudaMemsetAsync(bound, 0, sizeof(int) * static_cast<size_t>(Q), st);
  if (err != cudaSuccess) return err;
  const unsigned q_blocks = (Q + kThreads - 1) / kThreads;
  knn_slice_kernel<K><<<dim3(q_blocks, slices), kThreads, 0, st>>>(
      queries, cands, mask, Q, C, Cv, part_b, part_i, bound);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned m_blocks = (kMergeLanes * Q + kThreads - 1) / kThreads;
  knn_merge_kernel<K><<<m_blocks, kThreads, 0, st>>>(
      part_b, part_i, Q, slices, C, Cv, out_d, out_idx);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels.masked_knn) checks the shapes: Q >= 1, C >= 1,
// 1 <= k <= 8, C + pad >= k and below 2^30, 1 <= slices <= the tiles of
// C + pad slots, and scratch holding (2 * slices * k + 1) * Q int32.
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
