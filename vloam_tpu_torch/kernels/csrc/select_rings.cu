// K1: reference-exact LOAM strict sector feature selection for all rings.
//
// Replaces: vloam_tpu/lidar/scan_registration.py::_select_rings_pallas_kernel
// (called by _select_rings_pallas), the selection of
// reference scan_registration.cpp:312-440.
//
// What it computes, per ring: n_sectors x (n_corner + n_flat) pick rounds in
// order. Each round takes the first argmax of +curv (corner) or -curv (flat)
// among the unpicked points of the current sector that pass the threshold,
// labels it (2 sharp for the first n_sharp corners, 1 less-sharp, -1 flat)
// and marks the gap-connected +-5 window around it as picked (two indices
// are gap-connected iff their break-prefix values bf are equal). The last
// flat pick of a sector suppresses nothing.
//
// What bounds it on Hopper: the latency of a chain of dependent rounds, not
// bytes or operations. A ring is 12 bytes x R (22 KB at R = 1800), but the
// rounds of a sector are strictly serial (each needs the previous round's
// suppression) and a sector needs the marks the previous one left on its
// first points. The time is (rounds in a chain) x (length of a round), and
// the design shortens both.
//
// A short round: one warp per sector, the sector in registers.
// - A round never crosses a warp, so it needs no block barrier and no trip
//   through shared memory to combine partial results.
// - The ring's curv and bf are staged once in shared memory. A sector (at
//   most ceil(width / n_sectors) points: 299 at R = 1800) is copied into
//   registers, strided over the lanes (point sp + lane + 32 k in slot k, 10
//   to 32 slots a lane by template instantiation), and all of its 24 rounds
//   work on those registers. What a lane keeps is not the score but, once
//   per sector, its order-preserving unsigned key with the gate applied
//   (score > thr first, so NaN is never a candidate; zero canonicalised,
//   since -0.0 == +0.0 as floats but not as bits; 0 = no candidate), for the
//   corner rounds and for the flat rounds. A picked point's key becomes 0.
// - A round: per lane an integer max tree over its keys and the lowest slot
//   that holds the maximum (both before any communication); one redux.sync
//   max over the warp; the lanes that hold it offer their point, and a
//   second redux.sync min gives the first argmax of the sector (ties to the
//   lowest index, as the plain version's iota-min). Two redux.sync (~50
//   cycles each, measured) take the place of two rounds of five shuffles.
// - Suppression of ind +- 5 touches 11 consecutive points, which the strided
//   layout puts on 11 different lanes: each tests its one point against
//   bf[ind] (two shared-memory reads, no branch) and zeroes its key. Points
//   of the window before the sector are finished and dropped. Points past
//   the sector's end belong to the next sector: they leave the round as a
//   5-bit mask, the sector's carry.
// - A sector whose candidates have run out skips its remaining rounds of
//   that kind (picked only grows, so no later round could pick).
//
// A short chain: the sectors of a ring run at once, one warp each.
// - Sectors are not independent: a pick within 5 of a sector's end marks the
//   first points of the next one before it starts. But that is all one
//   sector tells the next (at most 5 marks), and a mark changes the next
//   sector's outcome only if it lands on a point that sector would have
//   picked: a point that is never an argmax can be removed without changing
//   any round. So every sector first runs as if no mark arrived. Then the
//   block repeats: each warp compares the carry its left neighbour now
//   reports with the one its last run assumed; it runs its sector again,
//   with the reported carry, if a mark it assumed is gone or a new mark
//   lies on a point it labelled. When no warp runs again, every sector has
//   seen its true carry (sector 0 from the start, sector j after at most j
//   repeats), and the labels are those of the serial order. The block
//   barriers are between passes, none inside the round loop.
// - Labels are kept in shared memory (a run clears its sector's first) and
//   written out once, coalesced, by the whole block, which also stages the
//   ring together.
// - Rings with sectors shorter than 5 points (a carry would cross more than
//   one sector), other sector counts than 2..8 and rings whose sectors are
//   longer than 32 x 32 points (kept in the staged ring in shared memory,
//   marked in place) run their sectors in order in one warp, the carry
//   handed from sector to sector.
//
// Block shape: one ring per block, n_sectors warps. 64 rings are 64 blocks
// on 64 of the 132 SMs, each warp alone on one of its SM's four schedulers
// (two share one when n_sectors is 6); a [B*S, R] batch spreads the same way.
//
// Inputs must satisfy counts[s] <= R (larger counts are clamped).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // sectors that may run side by side

struct Max {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return max(a, b); }
};
struct Min {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return min(a, b); }
};

// op over v[0..N) as a tree (the compiler keeps a chain a chain)
template <class Op, class T, int N>
__device__ __forceinline__ T tree(const T (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    constexpr int H = (N + 1) / 2;
    T t[H];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) t[i] = Op()(v[2 * i], v[2 * i + 1]);
    if constexpr (N & 1) t[H - 1] = v[N - 1];
    return tree<Op>(t);
  }
}

// Order-preserving unsigned key of a score that passed the gate (never NaN);
// every such key is > 0, which stands for "no candidate".
__device__ __forceinline__ unsigned score_key(float sc) {
  const unsigned u = __float_as_uint(sc == 0.0f ? 0.0f : sc);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A sector as one lane sees it: the points at offsets lane + 32 k from the
// sector's start, as keys of the current kind of round. `carry` marks the
// sector's first points that an earlier sector's pick has suppressed.
template <int CAP>
struct Sector {
  unsigned key[CAP];   // this phase's keys; 0: picked, gated out or no point
  unsigned flat[CAP];  // the flat rounds' keys, until flat_phase()
  unsigned dead = 0;   // slots picked during the corner rounds

  __device__ __forceinline__ Sector(float* s, int len, int lane,
                                    unsigned carry, float thr) {
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      const int o = lane + 32 * k;
      float v = o < len ? s[o] : CUDART_NAN_F;
      if (k == 0 && lane < 5 && ((carry >> lane) & 1u)) v = CUDART_NAN_F;
      key[k] = v > thr ? score_key(v) : 0u;  // false for NaN
      flat[k] = v < thr ? score_key(-v) : 0u;
    }
  }
  __device__ __forceinline__ void flat_phase() {
#pragma unroll
    for (int k = 0; k < CAP; ++k) key[k] = ((dead >> k) & 1u) ? 0u : flat[k];
  }
  // this lane's largest key and the offset of its first point that has it
  __device__ __forceinline__ void best(unsigned& top, int& off,
                                       int lane) const {
    top = tree<Max>(key);
    int o[CAP];
#pragma unroll
    for (int k = 0; k < CAP; ++k)
      o[k] = key[k] == top ? lane + 32 * k : INT_MAX;
    off = tree<Min>(o);
  }
  // mark the point at offset o (this lane's; -1: none) as picked
  __device__ __forceinline__ void kill(int o) {
    const int kk = o >> 5;  // -1 stays -1
#pragma unroll
    for (int k = 0; k < CAP; ++k) key[k] = k == kk ? 0u : key[k];
    if (o >= 0) dead |= 1u << kk;
  }
  __device__ __forceinline__ void round_done() const {}
};

// Sectors too long for registers stay in the staged ring, marked in place
// with NaN (so such a sector cannot be run twice).
template <>
struct Sector<0> {
  float* s;
  int len;
  float thr;
  bool corner = true;

  __device__ __forceinline__ Sector(float* s_, int len_, int lane,
                                    unsigned carry, float thr_)
      : s(s_), len(len_), thr(thr_) {
    if (lane < 5 && lane < len && ((carry >> lane) & 1u))
      s[lane] = CUDART_NAN_F;
    __syncwarp();
  }
  __device__ __forceinline__ void flat_phase() { corner = false; }
  __device__ __forceinline__ void best(unsigned& top, int& off,
                                       int lane) const {
    top = 0u;
    off = 0;
    for (int o = lane; o < len; o += 32) {
      const float v = s[o];
      const bool ok = corner ? v > thr : v < thr;
      const unsigned k = ok ? score_key(corner ? v : -v) : 0u;
      if (k > top) {  // ascending o: the first maximum
        top = k;
        off = o;
      }
    }
  }
  __device__ __forceinline__ void kill(int o) {
    if (o >= 0) s[o] = CUDART_NAN_F;
  }
  __device__ __forceinline__ void round_done() const { __syncwarp(); }
};

// One pick round on the sector [sp, ep]; false if no candidate is left.
// Marks that fall past ep are added to `out` (bit b: point ep + 1 + b).
template <int CAP>
__device__ __forceinline__ bool pick_round(Sector<CAP>& sec, const int* s_bf,
                                           signed char* s_lab, int sp, int ep,
                                           int lane, int value, bool suppress,
                                           unsigned& out) {
  unsigned mine;
  int off;
  sec.best(mine, off, lane);
  // both reductions before the test: the second needs only this lane's
  // values and the first's result, so nothing waits on a branch
  const unsigned top = __reduce_max_sync(kFull, mine);
  const int ind =
      sp + __reduce_min_sync(kFull, mine == top ? off : INT_MAX - sp);
  if (top == 0u) return false;
  if (lane == 0) s_lab[ind] = static_cast<signed char>(value);
  // the window point this lane holds in the strided layout, if any
  const int d = (lane - (ind - 5 - sp)) & 31;
  const int t = ind - 5 + d;
  const bool in_win = suppress && d < 11 && t >= sp;
  const bool hit = in_win && s_bf[in_win ? t : ind] == s_bf[ind];
  if (hit && t > ep) out |= 1u << (t - ep - 1);
  sec.kill(hit && t <= ep ? t - sp : -1);
  sec.round_done();
  return true;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

struct Params {
  int R, n_sectors, n_sharp, n_corner, n_flat;
  float thr;
};

// All rounds of sector j of a ring of `width` selectable points, given the
// marks `carry` on its first points; returns the marks it leaves on the
// points after its end.
template <int CAP>
__device__ __forceinline__ unsigned run_sector(int j, unsigned carry,
                                               int width, float* s_curv,
                                               const int* s_bf,
                                               signed char* s_lab, int lane,
                                               const Params& p) {
  // width > 0 here, so C++ division equals the reference's floor
  const int sp = 5 + width * j / p.n_sectors;
  const int ep = 5 + width * (j + 1) / p.n_sectors - 1;
  const int len = ep - sp + 1;
  for (int o = lane; o < len; o += 32) s_lab[sp + o] = 0;
  Sector<CAP> sec(s_curv + sp, len, lane, carry, p.thr);
  __syncwarp();  // the cleared labels, before lane 0 writes picks
  unsigned out = 0;
  for (int k = 0; k < p.n_corner; ++k)
    if (!pick_round(sec, s_bf, s_lab, sp, ep, lane, k < p.n_sharp ? 2 : 1,
                    true, out))
      break;
  sec.flat_phase();
  // the reference breaks before suppressing the last flat pick
  for (int k = 0; k < p.n_flat; ++k)
    if (!pick_round(sec, s_bf, s_lab, sp, ep, lane, -1, k < p.n_flat - 1,
                    out))
      break;
  out = __reduce_or_sync(kFull, out);
  // marks that reach past a sector shorter than 5 points
  return (len < 5 ? carry >> len : 0u) | out;
}

template <int CAP>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
select_rings_kernel(const float* __restrict__ curv,   // [S, R]
                    const int* __restrict__ bf,       // [S, R]
                    const int* __restrict__ counts,   // [S]
                    int* __restrict__ label,          // [S, R]
                    Params p) {
  extern __shared__ __align__(16) float smem[];
  float* s_curv = smem;
  int* s_bf = reinterpret_cast<int*>(smem + p.R);
  signed char* s_lab = reinterpret_cast<signed char*>(s_bf + p.R);
  __shared__ unsigned s_out[kMaxWarps];

  const int R = p.R;
  const int ring = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t row = static_cast<size_t>(ring) * R;
  const int cnt = min(counts[ring], R);
  // scanStartInd/scanEndInd in-ring (reference :278-280, :314)
  const int width = cnt - 6 - 5;
  const bool ring_ok = width >= 6;
  // 16-byte words where the rows allow it, and the loop unrolled, so that a
  // thread's loads are all in flight at once: staged one by one they were
  // most of the kernel's time
  const bool wide = R % 4 == 0 && aligned16(curv + row) &&
                    aligned16(bf + row) && aligned16(label + row);
  if (ring_ok) {
    if (wide) {
      const float4* c4 = reinterpret_cast<const float4*>(curv + row);
      const int4* b4 = reinterpret_cast<const int4*>(bf + row);
#pragma unroll 4
      for (int i = tid; i < (cnt + 3) / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(s_curv)[i] = __ldg(c4 + i);
        reinterpret_cast<int4*>(s_bf)[i] = __ldg(b4 + i);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < cnt; i += blockDim.x) {
        s_curv[i] = __ldg(curv + row + i);
        s_bf[i] = __ldg(bf + row + i);
      }
    }
  }
  for (int i = tid; i < (R + 3) / 4; i += blockDim.x)
    reinterpret_cast<int*>(s_lab)[i] = 0;  // the launch rounds R up to 4
  __syncthreads();

  if (ring_ok) {
    // a carry must end in the next sector for sectors to run side by side
    const bool side_by_side = CAP > 0 && n_warps > 1 &&
                              n_warps == p.n_sectors &&
                              width >= 5 * p.n_sectors;
    if (!side_by_side) {
      if (warp == 0) {
        unsigned carry = 0;
        for (int j = 0; j < p.n_sectors; ++j)
          carry = run_sector<CAP>(j, carry, width, s_curv, s_bf, s_lab, lane,
                                  p);
      }
    } else {
      const int j = warp;
      const int sp = 5 + width * j / p.n_sectors;
      unsigned assumed = 0;
      unsigned out = run_sector<CAP>(j, 0u, width, s_curv, s_bf, s_lab, lane,
                                     p);
      for (;;) {
        if (lane == 0) s_out[j] = out;
        __syncthreads();
        unsigned now = 0;
        bool again = false;
        if (j > 0) {
          now = s_out[j - 1];
          const unsigned come = now & ~assumed;
          const bool on_pick =
              lane < 5 && ((come >> lane) & 1u) && s_lab[sp + lane] != 0;
          again = (assumed & ~now) != 0u || __any_sync(kFull, on_pick);
        }
        // also keeps the reads of s_out before the next pass's writes
        if (!__syncthreads_or(again)) break;
        if (again) {
          assumed = now;
          out = run_sector<CAP>(j, now, width, s_curv, s_bf, s_lab, lane, p);
        }
      }
    }
  }
  __syncthreads();
  if (wide) {
    const char4* l4 = reinterpret_cast<const char4*>(s_lab);
    for (int i = tid; i < R / 4; i += blockDim.x) {
      const char4 l = l4[i];
      reinterpret_cast<int4*>(label + row)[i] = make_int4(l.x, l.y, l.z, l.w);
    }
  } else {
    for (int i = tid; i < R; i += blockDim.x) label[row + i] = s_lab[i];
  }
}

template <int CAP>
int launch(const float* curv, const int* bf, const int* counts, int* label,
           int S, const Params& p, cudaStream_t stream) {
  // curv, bf and one label byte per point, the labels as whole words
  const size_t smem = static_cast<size_t>(p.R) * (sizeof(float) + sizeof(int)) +
                      (static_cast<size_t>(p.R) + 3) / 4 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_rings_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int warps =
      CAP > 0 && p.n_sectors >= 2 && p.n_sectors <= kMaxWarps ? p.n_sectors
                                                              : 1;
  select_rings_kernel<CAP><<<S, 32 * warps, smem, stream>>>(curv, bf, counts,
                                                            label, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vloam_select_rings(const float* curv, const int* bf,
                                  const int* counts, int* label, int S, int R,
                                  float thr, int n_sectors, int n_sharp,
                                  int n_corner, int n_flat, void* stream) {
  if (n_sectors < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{R, n_sectors, n_sharp, n_corner, n_flat, thr};
  // the longest sector any ring of this width can have
  const int width = R - 11 > 0 ? R - 11 : 0;
  const int longest = (width + n_sectors - 1) / n_sectors;
  if (longest <= 32 * 10) return launch<10>(curv, bf, counts, label, S, p, st);
  if (longest <= 32 * 14) return launch<14>(curv, bf, counts, label, S, p, st);
  if (longest <= 32 * 22) return launch<22>(curv, bf, counts, label, S, p, st);
  if (longest <= 32 * 32) return launch<32>(curv, bf, counts, label, S, p, st);
  return launch<0>(curv, bf, counts, label, S, p, st);
}
