// Arena block gather (stage 0 of the arena serving program) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather.py::gather_blocks
// (body _gather_kernel). The arena holds each posting family's (doc, pos)
// event streams as int32 rows, every extent aligned to `block` rows. Output
// block i is arena block src_block[i]: out row i*block + j is arena row
// clamp(src_block[i]*block + j, 0, rows-1) when j < n_valid[i], and the
// (-1, -1) sentinel otherwise. The clamp is gather_blocks_ref's, so the
// kernel equals the plain version on any input, not only on plans.
//
// The TPU steers one whole-block DMA per grid step through a
// scalar-prefetched index map. On this card the work is a plain indexed
// copy: one thread per pair of rows (16 bytes), so each load and store is
// one 16-byte vector and neighbouring threads touch neighbouring addresses
// within an arena block. Each thread reads its block's src_block and
// n_valid itself (the 64 threads of a block hit the same two words, served
// from L1). A row is read only when it is live; dead rows are written as -1
// without a read.
//
// Bound on this card: bytes. 8 B per output row written, 8 B per live row
// read and 8 B of indirection per block, at 3.35 TB/s. At the serving
// path's shapes (a few thousand blocks) that is microseconds, so the launch
// dominates (PERF.md has the times).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_blocks_kernel(const int2* __restrict__ arena,      // [rows] (doc, pos)
                                     const int32_t* __restrict__ src_block,  // [G]
                                     const int32_t* __restrict__ n_valid,    // [G]
                                     int4* __restrict__ out,  // [G * block / 2] row pairs
                                     long long n_pairs, long long rows,
                                     int block) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int half = block / 2;
  const long long g = t / half;
  const int j = static_cast<int>(t - g * half) * 2;  // first row of the pair
  const int nv = n_valid[g];
  const long long base = static_cast<long long>(src_block[g]) * block + j;

  int4 v = make_int4(-1, -1, -1, -1);
  if (j + 1 < nv && base >= 0 && base + 1 < rows) {
    // both rows live and in range: base is even (block and j are), so the
    // pair is one aligned 16-byte vector of the arena
    v = reinterpret_cast<const int4*>(arena)[base / 2];
  } else if (j < nv) {
    const long long s0 = min(max(base, 0LL), rows - 1);
    const int2 r0 = arena[s0];
    v.x = r0.x;
    v.y = r0.y;
    if (j + 1 < nv) {
      const long long s1 = min(max(base + 1, 0LL), rows - 1);
      const int2 r1 = arena[s1];
      v.z = r1.x;
      v.w = r1.y;
    }
  }
  out[t] = v;
}

}  // namespace

extern "C" int gather_blocks_i32(const void* arena, const void* src_block,
                                 const void* n_valid, void* out, long long rows,
                                 int n_blocks, int block, void* stream) {
  const long long n_pairs = static_cast<long long>(n_blocks) * (block / 2);
  if (n_pairs == 0) return 0;
  const unsigned grid = static_cast<unsigned>((n_pairs + kThreads - 1) / kThreads);
  gather_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(arena), static_cast<const int32_t*>(src_block),
      static_cast<const int32_t*>(n_valid), static_cast<int4*>(out), n_pairs,
      rows, block);
  return static_cast<int>(cudaGetLastError());
}
