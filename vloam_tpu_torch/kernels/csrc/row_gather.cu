// S2: row gather out[i, :] = table[idx[i], :] from a [NB, W] float32 table.
//
// Replaces: scripts/profile_pallas_gather.py::make_pallas_gather and
// make_pallas_gather_tiled (the Pallas TPU kernels that start one async DMA
// per row with K copies in flight; the flat and the tiled form compute the
// same function). It is the gather under the map's 8-cell probe
// (gridmap.grid_gather, batch_mapping.batch_grid_gather) and under the
// insert's row fetch (gridmap.grid_insert, batch_mapping._merged_row_insert).
//
// What bounds it on Hopper: bytes. Every row (384 B for the corner grid's 96
// floats, 192 B for the surf grid's 48) is read once and written once, with
// no arithmetic; the rows are scattered over a table far larger than L2
// (50-200 MB), so the reads are random 128-byte-sector accesses to device
// memory. The TPU kernel's DMA queue has no counterpart here: thousands of
// resident warps each with an independent 16-byte load in flight are what
// keeps the memory system busy. Design: a group of lanes per output row
// (the smallest power of two >= W/4, at most a warp), each lane moving
// float4s, so a row is one or two fully coalesced requests; the group's
// first lane reads the row's index once and broadcasts it by shuffle.
//
// Indices must lie in [0, NB): nothing here checks them (the callers clamp).
// The copy is exact, so the result is bit-identical to table[idx].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float4* __restrict__ table,  // [NB, W4]
                  const long long* __restrict__ idx,  // [N]
                  float4* __restrict__ out,           // [N, W4]
                  int N, int W4, int lanes_per_row) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes_per_row - 1);  // lane within the row's group
  const int rows_per_block = kThreads / lanes_per_row;
  const int row = blockIdx.x * rows_per_block + threadIdx.x / lanes_per_row;
  const bool live = row < N;
  long long src = 0;
  if (live && sub == 0) src = idx[row];
  // every lane of the warp takes part in the shuffle, live or not
  src = __shfl_sync(0xffffffffu, src, lane - sub);
  if (!live) return;
  const float4* from = table + static_cast<size_t>(src) * W4;
  float4* to = out + static_cast<size_t>(row) * W4;
  for (int c = sub; c < W4; c += lanes_per_row) to[c] = __ldg(from + c);
}

}  // namespace

extern "C" int vloam_row_gather(const float* table, const long long* idx,
                                float* out, int N, int W, void* stream) {
  const int W4 = W / 4;
  int lanes = 1;
  while (lanes < W4 && lanes < 32) lanes *= 2;
  const int rows_per_block = kThreads / lanes;
  const int grid = (N + rows_per_block - 1) / rows_per_block;
  row_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), N, W4, lanes);
  return static_cast<int>(cudaGetLastError());
}
