// S2: the map's 8-cell probe, both grids of a frame in one launch.
//
// Replaces: scripts/profile_pallas_gather.py::make_pallas_gather and
// make_pallas_gather_tiled (the Pallas TPU kernels that start one async DMA
// per bucket row) where they sit in the port: under the map's probe, the
// port of vloam_tpu/lidar/gridmap.py:157 (grid_gather) and
// vloam_tpu/lidar/batch_mapping.py:96 (batch_grid_gather). The inserts keep
// row_gather.cu: their gather follows a bucket sort.
//
// Per job (a grid: table [NB, 3*cap] f32, rows x|y|z of cap floats each,
// queries [Q, 3] f32) and query i, the 8 probed cells are hashed here and
// the planar candidates written directly:
//
//   out[a, i, k*cap + j] = table[row_k(i), a*cap + j]      out [3, Q, 8*cap]
//   row_k(i) = (i / rows_per_stream) * nb + hash_k(i) & (nb - 1)
//
// with s = q * inv_cell (inv_cell = float32 1 / cell: how the reference's
// q / cell rounds under XLA, and how PyTorch rounds it on CUDA), c = (int)
// floor(s), the neighbour side off = (fma(q, inv_cell, -c) < 0.5) ? -1 : 1
// per axis (XLA's CPU backend contracts the reference's s - c into a fused
// multiply-add; the plain version emulates it in float64), and
// cell k = (sx, sy, sz) in {0,1}^3 in the loop order of the reference
// (gridmap.py:143-149), hashed in native uint32 arithmetic as
// vloam_tpu/lidar/gridmap.py:53 does (gridmap._hash_cell emulates it in
// int64). Every step rounds or wraps as the plain composition does (no
// fast-math; the build uses -fmad=false), so the output is bit-identical to
// gridmap.grid_gather_plain / batch_mapping.batch_grid_gather_plain.
//
// Why fused: at the engines' shapes (2048 corner and 6144 surf queries a
// frame) the plain composition is ~385 small elementwise kernels for the 8
// hashes of each grid, two row gathers and two permute copies of every
// candidate (6.3 + 9.4 MB a frame); the launch floor and the copies cost
// more than the gather itself. Here a frame's probe is one launch that
// writes each candidate once.
//
// What bounds it on Hopper: bytes. The distinct bucket rows are read once,
// the candidates written once (15.7 MB a single-engine frame), the queries
// read once; there is no arithmetic to speak of. Design: one warp per
// query. Its lanes hash the 8 cells (lane l the cell l % 8) and share the
// rows by shuffle; then for each axis the warp writes the query's 8*cap
// floats of that axis (1 KB corner, 512 B surf) as contiguous float4
// stores, every lane's loads issued before its stores; a segment of cap
// floats comes from one 16-byte-aligned run of its row (cap is a multiple
// of 4). Blocks of the first job come first, then those of the second.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // queries a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Job {
  const float4* table;   // [NB, 3 * cap4] float4
  const float* queries;  // [Q, 3]
  float4* out;           // [3, Q, 8 * cap4] float4
  int Q, cap4, nb, rows_per_stream;
  float inv_cell;
};

__device__ __forceinline__ uint32_t hash_cell(uint32_t ix, uint32_t iy,
                                              uint32_t iz) {
  uint32_t h = ix * 73856093u + iy * 19349669u + iz * 83492791u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

// The query's cell along one axis and the side of its nearer neighbour.
__device__ __forceinline__ void cell_of(float q, float inv_cell, int& c,
                                        int& off) {
  const float s = __fmul_rn(q, inv_cell);
  c = static_cast<int>(floorf(s));  // cvt.rzi saturates, as torch's .to()
  off = fmaf(q, inv_cell, -static_cast<float>(c)) < 0.5f ? -1 : 1;
}

// Candidates of query i; `row` is this lane's row of cell lane % 8. CAP4 is
// cap / 4 known at compile time (8: corner, 4: surf) or 0 (any).
template <int CAP4>
__device__ __forceinline__ void write_candidates(const Job& J, int i,
                                                 int lane, int row) {
  const int cap4 = CAP4 ? CAP4 : J.cap4;
  const int words = 8 * cap4;  // float4 words a (query, axis)
  const size_t row_words = 3 * static_cast<size_t>(cap4);
  if constexpr (CAP4 != 0) {
    constexpr int kRounds = (8 * CAP4 + 31) / 32;
    float4 v[3][kRounds];
    int w_of[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int w = lane + 32 * r;
      w_of[r] = w;
      const int src = __shfl_sync(kFull, row, min(w / cap4, 7));
      const float4* from = J.table + src * row_words + w % cap4;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        if (w < words) v[a][r] = __ldg(from + a * cap4);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float4* to = J.out + (static_cast<size_t>(a) * J.Q + i) * words;
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        if (w_of[r] < words) to[w_of[r]] = v[a][r];
    }
  } else {
    for (int w0 = 0; w0 < words; w0 += 32) {  // the same trips in every lane
      const int w = w0 + lane;
      const int src = __shfl_sync(kFull, row, min(w / cap4, 7));
      if (w >= words) continue;
      const float4* from = J.table + src * row_words + w % cap4;
      for (int a = 0; a < 3; ++a)
        J.out[(static_cast<size_t>(a) * J.Q + i) * words + w] =
            __ldg(from + a * cap4);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
grid_probe_kernel(Job j0, Job j1, int blocks0) {
  const int bx = static_cast<int>(blockIdx.x);
  const bool second = bx >= blocks0;
  // field by field, so that the job stays in registers
  Job J;
  J.table = second ? j1.table : j0.table;
  J.queries = second ? j1.queries : j0.queries;
  J.out = second ? j1.out : j0.out;
  J.Q = second ? j1.Q : j0.Q;
  J.cap4 = second ? j1.cap4 : j0.cap4;
  J.nb = second ? j1.nb : j0.nb;
  J.rows_per_stream = second ? j1.rows_per_stream : j0.rows_per_stream;
  J.inv_cell = second ? j1.inv_cell : j0.inv_cell;
  const int block = second ? bx - blocks0 : bx;
  const int i = block * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (i >= J.Q) return;  // a whole warp
  const int lane = threadIdx.x & 31;

  const float* q = J.queries + 3 * static_cast<size_t>(i);
  int cx, cy, cz, ox, oy, oz;
  cell_of(__ldg(q), J.inv_cell, cx, ox);
  cell_of(__ldg(q + 1), J.inv_cell, cy, oy);
  cell_of(__ldg(q + 2), J.inv_cell, cz, oz);
  // lane l hashes cell k = l % 8 = (sx, sy, sz); int32 sums wrap as torch's
  const int k = lane & 7;
  const uint32_t ix = static_cast<uint32_t>(cx) +
                      static_cast<uint32_t>((k >> 2) * ox);
  const uint32_t iy = static_cast<uint32_t>(cy) +
                      static_cast<uint32_t>(((k >> 1) & 1) * oy);
  const uint32_t iz = static_cast<uint32_t>(cz) +
                      static_cast<uint32_t>((k & 1) * oz);
  const uint32_t h = hash_cell(ix, iy, iz) & static_cast<uint32_t>(J.nb - 1);
  const int row = (i / J.rows_per_stream) * J.nb + static_cast<int>(h);

  if (J.cap4 == 8)
    write_candidates<8>(J, i, lane, row);
  else if (J.cap4 == 4)
    write_candidates<4>(J, i, lane, row);
  else
    write_candidates<0>(J, i, lane, row);
}

Job make_job(const float* table, const float* queries, float* out, int Q,
             int cap, int nb, int rows_per_stream, float inv_cell) {
  return Job{reinterpret_cast<const float4*>(table), queries,
             reinterpret_cast<float4*>(out), Q, cap / 4, nb,
             rows_per_stream, inv_cell};
}

}  // namespace

// Two jobs (a job with Q = 0 launches no block); cap a multiple of 4, nb a
// power of two, Q a multiple of rows_per_stream, and (Q / rows_per_stream)
// * nb table rows at most: the wrapper (kernels.grid_probe) checks these.
extern "C" int vloam_grid_probe(const float* t0, const float* q0, float* o0,
                                int Q0, int cap0, int nb0, int rps0,
                                float inv0, const float* t1, const float* q1,
                                float* o1, int Q1, int cap1, int nb1,
                                int rps1, float inv1, void* stream) {
  const int blocks0 = (Q0 + kWarps - 1) / kWarps;
  const int blocks1 = (Q1 + kWarps - 1) / kWarps;
  if (blocks0 + blocks1 == 0) return 0;
  grid_probe_kernel<<<blocks0 + blocks1, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_job(t0, q0, o0, Q0, cap0, nb0, rps0, inv0),
      make_job(t1, q1, o1, Q1, cap1, nb1, rps1, inv1), blocks0);
  return static_cast<int>(cudaGetLastError());
}
