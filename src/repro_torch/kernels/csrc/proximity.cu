// Dense minimal-fragment cover (the Combiner's Step 3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/proximity.py::
// proximity_window (body proximity_window_kernel). For each row b and each
// position e, a window [e-o, e] (o < window = 2*MaxDistance+1 <= 64) covers
// when every active lemma l (mult[l] > 0) has count >= mult[l] inside it and
// e >= o. emit[e] = some o covers and e is an event; start[e] = e - the
// smallest covering o (e where none covers).
//
// The TPU kernel builds prefix counts with a log2(N) doubling scan over a
// whole document in VMEM. Here each thread owns one position and sums the
// window directly (window <= 64 additions per lemma): no scan, no
// cross-thread dependency, and any N works because a CTA stages only its
// tile of positions plus a halo of window-1 positions in shared memory.
// Counts accumulate in the compute type's width (mod 2^8 for uint8, mod 2^32
// for int32), the same modular arithmetic as the TPU kernel's prefix
// differences, so the outputs agree for any input, not only 0/1 occupancy.
// Per lemma the thread keeps a 64-bit mask of the offsets whose count meets
// the multiplicity; the AND over lemmas gives every covering offset at
// once, and its lowest set bit is the smallest one. L is therefore not
// limited by registers.
//
// Bound on this card: the roofline bound is bytes (each occupancy byte read
// once, emit/start written once; the halo's window-1 extra columns per tile
// come from L2), but this simple form is not there: at the serving path's
// shape it runs at about 12x that bound, issuing the L * window shared-memory
// adds, compares and mask updates per position (PERF.md has the times).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // positions per CTA (= threads per CTA)

// Wrapping add in the compute type (int32 through uint32: wraps, no UB).
__device__ __forceinline__ uint8_t wrap_add(uint8_t a, uint8_t b) {
  return static_cast<uint8_t>(a + b);
}
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

template <typename T>
__global__ void proximity_window_kernel(const T* __restrict__ occ,   // [B, L, N]
                                        const T* __restrict__ mult,  // [B, L]
                                        uint8_t* __restrict__ emit,  // [B, N]
                                        int32_t* __restrict__ start, // [B, N]
                                        int L, int N, int window,
                                        int tiles_per_row) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [L, halo + kTile]
  const int halo = window - 1;
  const int width = halo + kTile;

  const long long row = blockIdx.x / tiles_per_row;
  const int t0 = (blockIdx.x % tiles_per_row) * kTile;
  const T* occ_row = occ + row * static_cast<long long>(L) * N;

  // stage positions [t0 - halo, t0 + kTile) of every lemma row; positions
  // outside [0, N) read as 0
  for (int idx = threadIdx.x; idx < L * width; idx += blockDim.x) {
    const int l = idx / width;
    const int p = t0 - halo + idx % width;
    tile[idx] = (p >= 0 && p < N) ? occ_row[static_cast<long long>(l) * N + p]
                                  : static_cast<T>(0);
  }
  __syncthreads();

  const int e = t0 + threadIdx.x;
  if (e >= N) return;

  // offsets o <= e only: a window must start inside the document
  const uint64_t all = (window >= 64) ? ~0ull : ((1ull << window) - 1ull);
  uint64_t cover = (e >= 63) ? all : (all & ((2ull << e) - 1ull));
  bool is_event = false;
  for (int l = 0; l < L; ++l) {
    const T m = mult[row * L + l];
    if (!(m > static_cast<T>(0))) continue;  // inactive lemma slot
    const T* col = tile + l * width + halo + threadIdx.x;  // col[0] = occ[e]
    is_event |= col[0] > static_cast<T>(0);
    T cnt = static_cast<T>(0);
    uint64_t ok = 0;
    for (int o = 0; o < window; ++o) {
      cnt = wrap_add(cnt, col[-o]);
      if (cnt >= m) ok |= 1ull << o;
    }
    cover &= ok;
  }
  const int o_star = cover ? __ffsll(static_cast<long long>(cover)) - 1 : 0;
  emit[row * N + e] = (cover != 0ull) && is_event;
  start[row * N + e] = e - o_star;
}

template <typename T>
int launch(const void* occ, const void* mult, void* emit, void* start, int B,
           int L, int N, int window, void* stream) {
  const int tiles_per_row = (N + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * tiles_per_row;
  const size_t smem = static_cast<size_t>(L) * (window - 1 + kTile) * sizeof(T);
  if (blocks == 0) return 0;
  proximity_window_kernel<T><<<static_cast<unsigned>(blocks), kTile, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(occ), static_cast<const T*>(mult),
      static_cast<uint8_t*>(emit), static_cast<int32_t*>(start), L, N, window,
      tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int proximity_window_u8(const void* occ, const void* mult,
                                   void* emit, void* start, int B, int L,
                                   int N, int window, void* stream) {
  return launch<uint8_t>(occ, mult, emit, start, B, L, N, window, stream);
}

extern "C" int proximity_window_i32(const void* occ, const void* mult,
                                    void* emit, void* start, int B, int L,
                                    int N, int window, void* stream) {
  return launch<int32_t>(occ, mult, emit, start, B, L, N, window, stream);
}
