// Sorted-list block intersection (the Combiner's Step-1 pre-filter) for
// Hopper (sm_90a), over any number of independent segments in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/intersect.py::
// intersect_sorted (body _intersect_kernel), applied per segment. For
// segment s with a_s, b_s, tile offsets offsets_s and its own n_chunks_s:
// out_s[i] = 1 when a_s[i] != PAD occurs in one of the block_b-wide tiles
// t_j = floor(offsets_s[blk] / block_b) + j, j < n_chunks_s, of a_s's block
// blk = i / block_a, each clamped at the last tile of b_s. A t_j below 0
// counts once from the end (t_j + nb_s / block_b) and then clamps at tile
// 0: what the TPU kernel reads in interpret mode for a negative offset,
// which block_offsets never gives. The distinct tiles form one contiguous
// window of b_s, or two when a negative first tile wraps: [0, t_last] and
// [t_0 + nb_s / block_b, the last tile], searched as one window in index
// order. So the kernel under-reports exactly where the TPU kernel does
// (the window misses a match span) and never reports a false positive.
//
// The TPU grid walks the chunk axis in order and ORs each tile's broadcast
// compare into a resident output block. Here:
// - One CTA of block_a threads (one warp group at 128) owns one a block of
//   any segment; a per-block segment id and a per-segment table (b base,
//   nb, n_chunks) let one grid cover every segment of a fold round, so a
//   round of six 8,192-element pairs is 384 CTAs across the 132 SMs.
// - The block's window is staged into shared memory with cp.async (16-byte
//   copies where the window is 16-byte aligned, 4-byte ones otherwise);
//   each thread loads its a value while the copies are in flight. A window
//   above the shared-memory budget (kSmemCapElems) is read in place through
//   the read-only path instead.
// - Each thread runs a lower-bound binary search of its value over the
//   window: ceil(log2(window)) + 1 probes, 10 for the serving path's
//   512-element windows, where the TPU kernel compares against all 512.
// - The function holds for any b, sorted or not: each thread checks its
//   adjacent pairs of the staged window, and __syncthreads_or sends a CTA
//   whose window is not non-decreasing to the linear compare of every
//   window element (the earlier form of this kernel). Duplicates and PAD
//   runs in b are non-decreasing and keep the search exact.
//
// Bound on this card: a, b, offsets and out are a few tens of KB at the
// serving path's sizes, well under a microsecond of HBM time, so the time
// is the launch and one dependent chain of shared-memory probes per thread.
// Tensor cores do not apply: there is no product, only compares.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPad = 0x7fffffff;  // 2^31 - 1, the padding value
// 32 KB of staged window per CTA: under the 48 KB that a launch may ask for
// without cudaFuncAttributeMaxDynamicSharedMemorySize, and small enough to
// keep many CTAs resident on an SM.
constexpr int kSmemCapElems = 8192;

__device__ __forceinline__ void cp_async16(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

template <bool kGlobal>
__device__ __forceinline__ int32_t load(const int32_t* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// A block's window of n elements: w1[0, n1) followed by w2[0, n - n1).
struct Window {
  const int32_t* w1;
  const int32_t* w2;
  int n1, n;
};

template <bool kGlobal>
__device__ __forceinline__ int32_t at(const Window& w, int k) {
  return k < w.n1 ? load<kGlobal>(w.w1 + k) : load<kGlobal>(w.w2 + (k - w.n1));
}

// 1 when some adjacent pair of the window is out of order, in any thread of
// the CTA (every thread takes part).
template <bool kGlobal>
__device__ __forceinline__ int cta_unsorted(const Window& w) {
  int bad = 0;
  for (int k = threadIdx.x; k + 1 < w.n; k += blockDim.x)
    bad |= at<kGlobal>(w, k) > at<kGlobal>(w, k + 1);
  return __syncthreads_or(bad);
}

// v occurs in the window: a lower-bound search over a sorted window, a
// linear compare over an unsorted one.
template <bool kGlobal>
__device__ __forceinline__ bool window_has(const Window& w, int32_t v, bool sorted) {
  if (sorted) {
    int lo = 0, len = w.n;
    while (len > 0) {
      const int half = len >> 1;
      if (at<kGlobal>(w, lo + half) < v) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    return lo < w.n && at<kGlobal>(w, lo) == v;
  }
  bool hit = false;
  for (int k = 0; k < w.n; ++k) hit |= at<kGlobal>(w, k) == v;
  return hit;
}

// blk_seg == nullptr: one segment, (b base 0, nb0, n_chunks0).
// Otherwise segs[3 * s] = (b base, nb, n_chunks) of segment s = blk_seg[blk].
__global__ void intersect_segments_kernel(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ blk_seg,
    const int32_t* __restrict__ segs, int32_t* __restrict__ out, int nb0,
    int n_chunks0, int block_b, int smem_elems) {
  extern __shared__ __align__(16) int32_t win[];
  const int blk = blockIdx.x;
  long long b_base = 0;
  int nb = nb0, n_chunks = n_chunks0;
  if (blk_seg != nullptr) {
    const int s = blk_seg[blk];
    b_base = segs[3 * s];
    nb = segs[3 * s + 1];
    n_chunks = segs[3 * s + 2];
  }
  // the tiles t_j = first + j (floor division, as the plain version
  // divides), j < n_chunks, as the tile spans [lo1, hi1] and [lo2, hi2]
  // (empty unless a negative first tile wraps to the end)
  const long long off = offsets[blk];
  const long long first = off >= 0 ? off / block_b : -((-off + block_b - 1) / block_b);
  const long long end = first + n_chunks - 1;
  const long long n_tiles = nb / block_b, last = n_tiles - 1;
  long long lo1, hi1, lo2 = 0, hi2 = -1;
  if (first >= 0) {
    lo1 = min(first, last);
    hi1 = min(end, last);
  } else {
    // the negative tiles, counted from the end and clamped at tile 0
    const long long w_lo = max(first + n_tiles, 0LL);
    const long long w_hi = max(min(end, -1LL) + n_tiles, 0LL);
    if (end < 0) {
      lo1 = w_lo;
      hi1 = w_hi;
    } else if (w_lo <= min(end, last) + 1) {  // the two spans meet
      lo1 = 0;
      hi1 = last;
    } else {
      lo1 = 0;
      hi1 = min(end, last);
      lo2 = w_lo;
      hi2 = w_hi;
    }
  }
  const int n1 = static_cast<int>(hi1 - lo1 + 1) * block_b;
  const int n = n1 + static_cast<int>(hi2 - lo2 + 1) * block_b;
  const int32_t* src1 = b + b_base + lo1 * block_b;
  const int32_t* src2 = b + b_base + lo2 * block_b;
  const long long i = static_cast<long long>(blk) * blockDim.x + threadIdx.x;

  int32_t v;
  bool hit;
  if (n <= smem_elems) {
    const bool vec = ((reinterpret_cast<uintptr_t>(src1) | reinterpret_cast<uintptr_t>(src2) |
                       (static_cast<uintptr_t>(n1) * 4) | (static_cast<uintptr_t>(n) * 4)) & 15) == 0;
    if (vec) {
      for (int k = threadIdx.x * 4; k < n; k += blockDim.x * 4)
        cp_async16(win + k, k < n1 ? src1 + k : src2 + (k - n1));
    } else {
      for (int k = threadIdx.x; k < n; k += blockDim.x)
        cp_async4(win + k, k < n1 ? src1 + k : src2 + (k - n1));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    v = a[i];  // overlaps the window's copies
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const Window w{win, win, n, n};
    const bool sorted = !cta_unsorted<false>(w);
    hit = window_has<false>(w, v, sorted);
  } else {
    v = a[i];
    const Window w{src1, src2, n1, n};
    const bool sorted = !cta_unsorted<true>(w);
    hit = window_has<true>(w, v, sorted);
  }
  out[i] = hit && v != kPad;
}

}  // namespace

// One launch over n_blocks a blocks. blk_seg and segs null: the single
// segment (nb, n_chunks). window_max: the largest window of any block
// (min(n_chunks, nb / block_b) * block_b over the segments), which sizes
// the shared memory. Returns cudaGetLastError() after the launch.
extern "C" int intersect_sorted_segments_i32(
    const void* a, const void* b, const void* offsets, const void* blk_seg,
    const void* segs, void* out, int n_blocks, int block_a, int block_b,
    int nb, int n_chunks, int window_max, void* stream) {
  if (n_blocks == 0) return 0;
  const int smem_elems = window_max < kSmemCapElems ? window_max : kSmemCapElems;
  intersect_segments_kernel<<<n_blocks, block_a, smem_elems * sizeof(int32_t),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(blk_seg),
      static_cast<const int32_t*>(segs), static_cast<int32_t*>(out), nb,
      n_chunks, block_b, smem_elems);
  return static_cast<int>(cudaGetLastError());
}
