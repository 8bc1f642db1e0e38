// S2: row gather out[i, :] = table[idx[i], :] from a [NB, W] float32 table.
//
// Replaces: scripts/profile_pallas_gather.py::make_pallas_gather and
// make_pallas_gather_tiled (the Pallas TPU kernels that start one async DMA
// per row with K copies in flight; the flat and the tiled form compute the
// same function). It is the gather under the map's inserts (gridmap.
// grid_insert, batch_mapping._merged_row_insert) and the mesh's windows and
// block inserts (parallel/mesh_fused.py); the probe's gather is fused into
// grid_probe.cu.
//
// What bounds it on Hopper: at the engines' sizes, neither bytes nor
// operations but latency. An insert moves 2048 rows of 384 B (the corner
// grid's 96 floats) or 6144 of 192 B (the surf grid's 48), 0.8-1.2 MB that
// the card's memory moves in ~0.3 us; inserted points crowd into few
// buckets, so the rows repeat and their reads hit L2; the writes land in L2
// too. What is left is the launch (~2 us) and two dependent trips to
// memory: a row's index, then the row. The first build gave each row a
// power-of-two group of lanes (12 of 16 lanes moving data at W = 48, 24 of
// 32 at W = 96) and each lane one 16-byte word behind its group's index,
// read by one lane and shuffled. The design:
// - The work is flat over the output's 16-byte words: word e is column
//   e % W4 of row e / W4 (W4 = W / 4), so every lane moves data. The map's
//   widths (W4 = 12 and 24) are template constants, whose division is a
//   multiply and a shift: 0.3-0.6 us faster than the general instantiation
//   (W4 an argument) at each of the engines' shapes, timed in turns
//   (PERF.md). Other widths take the general instantiation.
// - Each thread moves kVec words kThreads apart (stores coalesce), reading
//   each word's row index itself (neighbouring lanes read the same index:
//   one broadcast load), then issuing all its row loads, then all its
//   stores: the index latency is paid once a thread and overlaps across
//   the thread's words.
// - 256 threads x 2 words a block: every block resident at once at the
//   engines' shapes (96-576 blocks); of 9 shapes the fastest in 7 of 8
//   readings (4 engine shapes, two runs) and 0.27 us off in the eighth
//   (tools/profile_row_gather.py --shapes, PERF.md). What is left is the
//   launch (2.5-2.8 us alone) and the two round trips.
//
// Indices must lie in [0, NB): nothing here checks them (the callers clamp).
// The copy is exact, so the result is bit-identical to table[idx].

#include <cuda_runtime.h>

// threads a block and 16-byte words a thread, settable from nvcc's command
// line for tools/profile_row_gather.py, which times others
#ifndef VLOAM_RG_THREADS
#define VLOAM_RG_THREADS 256
#endif
#ifndef VLOAM_RG_VEC
#define VLOAM_RG_VEC 2
#endif
// the part of the work that runs, for the measurement: 0 all, 1 none
// (launch only), 2 the index loads alone
#ifndef VLOAM_RG_PART
#define VLOAM_RG_PART 0
#endif

namespace {

constexpr int kThreads = VLOAM_RG_THREADS;
constexpr int kVec = VLOAM_RG_VEC;
constexpr int kPart = VLOAM_RG_PART;

// kW4: words a row, or 0 for the general path, which reads w4
template <int kW4>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float4* __restrict__ table,  // [NB, W4]
                  const long long* __restrict__ idx,  // [N]
                  float4* __restrict__ out,           // [N, W4]
                  unsigned total, unsigned w4) {      // total = N * W4
  // total < 2^31 (the wrapper checks it): no index below wraps
  const unsigned W4 = kW4 ? kW4 : w4;
  const unsigned e0 = blockIdx.x * (kThreads * kVec) + threadIdx.x;
  if (kPart == 1) return;
  long long src[kVec] = {};
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const unsigned e = e0 + k * kThreads;
    if (e < total) {
      const unsigned row = e / W4;
      src[k] = __ldg(idx + row) * W4 + (e - row * W4);
    }
  }
  float4 v[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (kPart == 2)  // the indices' words in place of the rows
      v[k] = make_float4(static_cast<float>(src[k]), 0.f, 0.f, 0.f);
    else if (e0 + k * kThreads < total)
      v[k] = __ldg(table + src[k]);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const unsigned e = e0 + k * kThreads;
    if (e < total) out[e] = v[k];
  }
}

template <int kW4>
cudaError_t launch(const float* table, const long long* idx, float* out,
                   unsigned total, unsigned w4, cudaStream_t st) {
  const unsigned grid = (total + kThreads * kVec - 1) / (kThreads * kVec);
  row_gather_kernel<kW4><<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), total, w4);
  return cudaGetLastError();
}

}  // namespace

// N * W / 4 must stay below 2^31 (the wrapper checks it).
extern "C" int vloam_row_gather(const float* table, const long long* idx,
                                float* out, int N, int W, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned w4 = W / 4;
  const unsigned total = static_cast<unsigned>(N) * w4;
  cudaError_t err;
  switch (w4) {  // the map's rows: surf 48 floats, corner 96
    case 12:
      err = launch<12>(table, idx, out, total, w4, st);
      break;
    case 24:
      err = launch<24>(table, idx, out, total, w4, st);
      break;
    default:
      err = launch<0>(table, idx, out, total, w4, st);
  }
  return static_cast<int>(err);
}
