// Sorted-list block intersection (the Combiner's Step-1 pre-filter) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/intersect.py::
// intersect_sorted (body _intersect_kernel). out[i] = 1 when a[i] != PAD
// occurs in one of the n_chunks block_b-wide tiles of b that a's block
// i / block_a scans: tile index min(offsets[blk] / block_b + j,
// nb / block_b - 1) for j < n_chunks. So it under-reports when the tiles
// miss a match span and never reports a false positive, exactly like the
// TPU kernel; the caller sizes n_chunks so the tiles cover every span.
//
// The TPU grid walks the chunk axis in order and ORs into a resident output
// block. Here one CTA owns one a block (one thread per element, the value in
// a register) and walks its chunks in a loop, staging each b tile in shared
// memory and comparing against every tile element (all threads read the
// same shared word, a broadcast). The offsets are read by the CTA itself
// instead of a scalar prefetch.
//
// Bound on this card: at the serving path's sizes (a few thousand
// elements) the launch itself; the bytes are a, b and out once each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = 0x7fffffff;  // 2^31 - 1, the padding value

__global__ void intersect_sorted_kernel(const int32_t* __restrict__ a,
                                        const int32_t* __restrict__ b,
                                        const int32_t* __restrict__ offsets,
                                        int32_t* __restrict__ out, int nb,
                                        int block_b, int n_chunks) {
  extern __shared__ int32_t btile[];  // [block_b]
  const int blk = blockIdx.x;
  const int i = blk * blockDim.x + threadIdx.x;
  const int32_t v = a[i];
  const int last_tile = nb / block_b - 1;
  const int first_tile = offsets[blk] / block_b;

  int hit = 0;
  for (int j = 0; j < n_chunks; ++j) {
    int t = min(first_tile + j, last_tile);
    t = max(t, 0);
    __syncthreads();  // previous tile fully read
    for (int k = threadIdx.x; k < block_b; k += blockDim.x)
      btile[k] = b[static_cast<long long>(t) * block_b + k];
    __syncthreads();
    for (int k = 0; k < block_b; ++k) hit |= (btile[k] == v);
  }
  out[i] = hit && (v != kPad);
}

}  // namespace

extern "C" int intersect_sorted_i32(const void* a, const void* b,
                                    const void* offsets, void* out, int na,
                                    int nb, int block_a, int block_b,
                                    int n_chunks, void* stream) {
  const int blocks = na / block_a;
  if (blocks == 0) return 0;
  intersect_sorted_kernel<<<blocks, block_a, block_b * sizeof(int32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(offsets), static_cast<int32_t*>(out), nb,
      block_b, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
