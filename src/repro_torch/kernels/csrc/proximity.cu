// Dense minimal-fragment cover (the Combiner's Step 3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/proximity.py::
// proximity_window (body proximity_window_kernel). For each row b and each
// position e, a window [e-o, e] (o < window = 2*MaxDistance+1 <= 64) covers
// when every active lemma l (mult[l] > 0) has count >= mult[l] inside it and
// e >= o. emit[e] = some o covers and e is an event; start[e] = e - o*, o*
// the smallest covering o (0 where none covers), at every position.
//
// The TPU kernel keeps a whole document in VMEM and builds prefix counts
// with a log2(N) doubling scan. Here one CTA of 64 threads owns a tile of
// 512 positions of one row, 8 consecutive positions a thread, and reads the
// row's multiplicities once. It stages the active lemmas' occupancy (an
// inactive lemma row is never read) of the tile plus the 64 positions
// before it in shared memory: 16-byte loads, issued four at a time, where
// the row is aligned; scalar loads at a ragged edge; only the window - 1
// positions a window reaches back are read, the rest and positions outside
// [0, N) are 0. While staging, each thread tests its chunks for 0/1 and
// packs them into bit words (a multiply gathers 4 bytes' low bits; lane
// shuffles merge a word), and __syncthreads_or picks a branch for the CTA:
//
// - Bit path (every staged value 0 or 1; the serving path's occupancy is
//   0/1 by construction). With 0/1 counts the window count is
//   non-decreasing in o and at most 64, so it never wraps in either type,
//   and the smallest offset covering every lemma is o* = max over active
//   lemmas of o_l, the offset of the lemma's m-th occurrence counting back
//   from e. A funnel shift of the bit words gives e's window (32 bits where
//   window <= 32, else 64). For m <= 2, leading-zero counts of the window
//   at the thread's first position give o_l there, and each later position
//   follows from whether the lemma occurs at it (population and
//   leading-zero counts run at a quarter of the integer rate); for m > 2,
//   each position's window is masked to o < window, popcounted, and its
//   m - 1 nearest occurrences dropped. An o_l >= window does not cover.
// - General path (any staged value outside {0, 1}): per lemma and offset,
//   the window sums of 4 positions at a time, in the compute type's width
//   (mod 2^8 for uint8, mod 2^32 for int32: the same modular arithmetic as
//   the TPU kernel's prefix differences), so the outputs agree for any
//   input. A 64-bit mask of the covering offsets per lemma, ANDed over
//   lemmas; its lowest set bit is o*.
//
// Outputs go out 8 positions a thread: emit as one 8-byte store, start as
// two 16-byte stores, where aligned.
//
// Bound on this card: bytes (the active occupancy rows read once, emit and
// start written once; the halo's window-1 extra positions per tile come
// from L2). On an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py times it at
// the serving path's 65,536 x 8 x 512 at 0.117 ms in uint8 and 0.260 ms in
// int32, 1.3x that bound; PERF.md has the runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kPerThread = 8;                  // consecutive positions a thread
constexpr int kTile = kThreads * kPerThread;   // positions per CTA
constexpr int kHalo = 64;                      // staged positions before the tile
constexpr int kSpan = kHalo + kTile;           // staged positions per lemma row
constexpr int kWords = kSpan / 32;             // bit words per lemma row
constexpr int kNoCover = 64;                   // o* where no offset covers
constexpr int kBatch = 4;                      // chunk loads in flight a thread

// Wrapping add in the compute type (int32 through uint32: wraps, no UB).
__device__ __forceinline__ uint8_t wrap_add(uint8_t a, uint8_t b) {
  return static_cast<uint8_t>(a + b);
}
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// True where a 16-byte chunk holds a value outside {0, 1}.
__device__ __forceinline__ bool not_01(uint4 v, uint8_t) {
  return ((v.x | v.y | v.z | v.w) & 0xFEFEFEFEu) != 0u;
}
__device__ __forceinline__ bool not_01(uint4 v, int32_t) {
  return ((v.x | v.y | v.z | v.w) & ~1u) != 0u;
}

// The 16 (uint8) or 4 (int32) values of a chunk as bits, bit i <-> value i;
// only meaningful where every value is 0 or 1 (for bytes b0..b3 in {0, 1},
// the partial products of w * 0x01020408 fall on distinct bits, and bits
// 24..27 are b0..b3).
__device__ __forceinline__ uint32_t pack_bits(uint4 v, uint8_t) {
  return ((v.x * 0x01020408u) >> 24) | ((v.y * 0x01020408u) >> 24) << 4 |
         ((v.z * 0x01020408u) >> 24) << 8 | ((v.w * 0x01020408u) >> 24) << 12;
}
__device__ __forceinline__ uint32_t pack_bits(uint4 v, int32_t) {
  return v.x | v.y << 1 | v.z << 2 | v.w << 3;
}

// Elements [q0, q0 + 16 / sizeof(T)) of one lemma row; positions outside
// [lo, hi) read as 0.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ src, int q0,
                                            int lo, int hi) {
  constexpr int V = 16 / sizeof(T);
  if (q0 >= lo && q0 + V <= hi &&
      (reinterpret_cast<uintptr_t>(src + q0) & 15u) == 0u) {
    return __ldg(reinterpret_cast<const uint4*>(src + q0));
  }
  union {
    uint4 v;
    T e[V];
  } u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  if (q0 + V > lo && q0 < hi) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int q = q0 + i;
      if (q >= lo && q < hi) u.e[i] = src[q];
    }
  }
  return u.v;
}

// The offsets o < 8 * sizeof(W) of the window ending at a position at bit
// 31 - sh of word wc (wb, wa the two words before), as bit
// 8 * sizeof(W) - 1 - o <-> position e - o.
__device__ __forceinline__ void window_bits(uint32_t& r, uint32_t, uint32_t wb,
                                            uint32_t wc, int sh) {
  r = __funnelshift_l(wb, wc, sh);
}
__device__ __forceinline__ void window_bits(uint64_t& r, uint32_t wa, uint32_t wb,
                                            uint32_t wc, int sh) {
  r = static_cast<uint64_t>(__funnelshift_l(wb, wc, sh)) << 32 |
      __funnelshift_l(wa, wb, sh);
}
__device__ __forceinline__ int clz(uint32_t x) { return __clz(static_cast<int>(x)); }
__device__ __forceinline__ int clz(uint64_t x) { return __clzll(static_cast<long long>(x)); }
__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popc(uint64_t x) { return __popcll(x); }

// o*[d] = max(o*[d], offset of the M-th occurrence counting back from
// e0 + d) for the thread's positions, from the window r at e0 (unmasked:
// e0 at the top bit) and here (bit d <-> an occurrence at e0 + d).  At e0,
// o[k] = the offset of the (k+1)-th nearest occurrence, by leading-zero
// counts of the window with the nearer ones shifted out (kBits or more
// where the window holds fewer; that does not cover, as window <= kBits).
// Each later position: an occurrence there makes it the nearest and moves
// the others one rank back; all offsets grow by one.
template <int M, typename W>
__device__ __forceinline__ void nearest_m(W r, uint32_t here, int (&o_star)[kPerThread]) {
  constexpr int kBits = 8 * sizeof(W);
  int o[M];
  int used = 0;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int z = clz(r);  // kBits where r == 0
    o[k] = used + z;
    used += z + 1;
    r = z + 1 < kBits ? r << (z + 1) : W(0);
  }
  o_star[0] = max(o_star[0], o[M - 1]);
#pragma unroll
  for (int d = 1; d < kPerThread; ++d) {
    const bool occurs = (here >> d) & 1u;
#pragma unroll
    for (int k = M - 1; k > 0; --k) o[k] = (occurs ? o[k - 1] : o[k]) + 1;
    o[0] = occurs ? 0 : o[0] + 1;
    o_star[d] = max(o_star[d], o[M - 1]);
  }
}

// Bit path for the thread's positions e0 + d (staged indices j0 + d,
// d < 8; they share one word): 32-bit windows where window <= 32, 64-bit
// ones above.  For each active lemma, o_l = the offset of its m-th
// occurrence counting back from e (8 * sizeof(W) or more where the window
// holds fewer than m; any o_l >= window does not cover); o* = max over
// lemmas.  Population and leading-zero counts run at a quarter of the
// integer rate, so for m <= 2 only e0's window is counted and the later
// positions follow it (nearest_m); above, each position's window is masked
// to o < window, its popcount checked, and its m - 1 nearest occurrences
// dropped.  ev collects the events: bit d <-> position e0 + d.
template <typename W>
__device__ __forceinline__ void bit_cover(const uint32_t* bits, const int32_t* s_mult,
                                          const int32_t* s_active, int n_active,
                                          int window, int j0,
                                          int (&o_star)[kPerThread], uint32_t& ev) {
  constexpr int kBits = 8 * sizeof(W);
  const W top = W(1) << (kBits - 1);
  const W wmask = window >= kBits ? ~W(0) : ~(~W(0) >> window);  // o < window
  const int wi = j0 >> 5;
  const int sh0 = 31 - (j0 & 31);
  for (int a = 0; a < n_active; ++a) {
    const int m = s_mult[s_active[a]];  // >= 1, the same for the whole CTA
    const uint32_t* wl = bits + static_cast<size_t>(a) * kWords;
    const uint32_t wc = wl[wi], wb = wl[wi - 1], wa = wl[wi - 2];
    const uint32_t here = wc >> (j0 & 31);  // bit d <-> occurrence at e0 + d
    ev |= here;
    if (m <= 2) {
      W r;
      window_bits(r, wa, wb, wc, sh0);
      if (m == 1) {
        nearest_m<1>(r, here, o_star);
      } else {
        nearest_m<2>(r, here, o_star);
      }
    } else {
#pragma unroll
      for (int d = 0; d < kPerThread; ++d) {
        W r;
        window_bits(r, wa, wb, wc, sh0 - d);
        r &= wmask;
        int o = kBits;
        if (popc(r) >= m) {
          for (int i = 1; i < m; ++i) r ^= top >> clz(r);  // drop the nearest
          o = clz(r);
        }
        o_star[d] = max(o_star[d], o);
      }
    }
  }
}

// uint8 tiles take little shared memory: capping registers (40) lets 24 CTAs
// share an SM, so one CTA's loads overlap another's counting.  int32 tiles
// are held to about 11 CTAs an SM by their shared memory anyway.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 1 ? 24 : 8)
proximity_window_kernel(const T* __restrict__ occ,    // [B, L, N]
                        const T* __restrict__ mult,   // [B, L]
                        uint8_t* __restrict__ emit,   // [B, N]
                        int32_t* __restrict__ start,  // [B, N]
                        int L, int N, int window, int tiles_per_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per active lemma a (in lemma order): staged values and bit words
  T* tile = reinterpret_cast<T*>(smem_raw);  // [L, kSpan]
  uint32_t* bits = reinterpret_cast<uint32_t*>(tile + static_cast<size_t>(L) * kSpan);  // [L, kWords]
  int32_t* s_mult = reinterpret_cast<int32_t*>(bits + static_cast<size_t>(L) * kWords);  // [L]
  int32_t* s_active = s_mult + L;  // [L] lemma of active slot a
  int32_t* s_n_active = s_active + L;

  const long long row = blockIdx.x / tiles_per_row;
  const int t0 = static_cast<int>(blockIdx.x - row * tiles_per_row) * kTile;
  const T* occ_row = occ + row * static_cast<long long>(L) * N;
  const int lane = threadIdx.x & 31;

  // the row's multiplicities, read once, and the list of active lemmas
  if (threadIdx.x < 32) {
    int n_active = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const int m = l < L ? static_cast<int32_t>(mult[row * L + l]) : 0;
      if (l < L) s_mult[l] = m;
      const uint32_t act = __ballot_sync(0xffffffffu, m > 0);
      if (m > 0) s_active[n_active + __popc(act & ((1u << lane) - 1u))] = l;
      n_active += __popc(act);
    }
    if (lane == 0) *s_n_active = n_active;
  }
  __syncthreads();
  const int n_active = *s_n_active;

  // stage: staged index j <-> position t0 - kHalo + j of every active lemma
  // (an inactive lemma row is never read); only [t0 - (window - 1),
  // t0 + kTile) is read.  Each chunk is also packed into bits (bit i of word
  // w <-> staged index 32 w + i), merged across the lanes that hold one
  // word; they are used only if the tile turns out all 0/1.
  constexpr int V = 16 / sizeof(T);        // positions per chunk
  constexpr int kChunks = kSpan / V;       // chunks per lemma row
  constexpr int kLanesPerWord = 32 / V;    // lanes holding one bit word
  const int lo = max(0, t0 - (window - 1));
  const int hi = min(N, t0 + kTile);
  const int n_chunks = n_active * kChunks;
  bool bad = false;
  for (int base = 0; base < n_chunks; base += kBatch * kThreads) {  // CTA-uniform
    // issue a batch of loads before using any
    uint4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads + threadIdx.x;
      const int a = idx / kChunks;  // compile-time divisor
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < n_chunks) {
        v[k] = load_chunk(occ_row + static_cast<long long>(s_active[a]) * N,
                          t0 - kHalo + (idx - a * kChunks) * V, lo, hi);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads + threadIdx.x;
      const int a = idx / kChunks;
      const int c = idx - a * kChunks;
      const bool live = idx < n_chunks;
      if (live) {
        bad |= not_01(v[k], T{});
        reinterpret_cast<uint4*>(tile + static_cast<size_t>(a) * kSpan)[c] = v[k];
      }
      uint32_t w = pack_bits(v[k], T{}) << ((lane % kLanesPerWord) * V);
#pragma unroll
      for (int x = 1; x < kLanesPerWord; x <<= 1) w |= __shfl_xor_sync(0xffffffffu, w, x);
      if (live && lane % kLanesPerWord == 0) {
        bits[static_cast<size_t>(a) * kWords + c / kLanesPerWord] = w;
      }
    }
  }
  const bool general = __syncthreads_or(bad) != 0;

  const int j0 = kHalo + threadIdx.x * kPerThread;  // staged index of e0
  const int e0 = t0 + threadIdx.x * kPerThread;
  if (e0 >= N) return;
  int o_star[kPerThread];
  uint32_t ev = 0u;  // bit d: e0 + d is an event
#pragma unroll
  for (int d = 0; d < kPerThread; ++d) o_star[d] = 0;

  if (!general) {
    // ---- bit path -----------------------------------------------------------
    if (window <= 32) {
      bit_cover<uint32_t>(bits, s_mult, s_active, n_active, window, j0, o_star, ev);
    } else {
      bit_cover<uint64_t>(bits, s_mult, s_active, n_active, window, j0, o_star, ev);
    }
  } else {
    // ---- general path: wrapping window sums of the staged values ----------
    // per lemma and offset, 4 positions at a time (independent sums)
    constexpr int kGroup = 4;
    const uint64_t all = window >= 64 ? ~0ull : ((1ull << window) - 1ull);
#pragma unroll
    for (int g = 0; g < kPerThread; g += kGroup) {
      uint64_t cov[kGroup];
#pragma unroll
      for (int d = 0; d < kGroup; ++d) {
        // offsets o <= e only: a window must start inside the document
        const int e = e0 + g + d;
        cov[d] = (e >= 63) ? all : (all & ((2ull << e) - 1ull));
      }
      for (int a = 0; a < n_active; ++a) {
        const T m = static_cast<T>(s_mult[s_active[a]]);
        const T* col = tile + static_cast<size_t>(a) * kSpan + j0 + g;  // col[d] = occ[e0 + g + d]
        T cnt[kGroup];
        uint64_t ok[kGroup];
#pragma unroll
        for (int d = 0; d < kGroup; ++d) {
          if (col[d] > static_cast<T>(0)) ev |= 1u << (g + d);
          cnt[d] = static_cast<T>(0);
          ok[d] = 0ull;
        }
        for (int o = 0; o < window; ++o) {
          const uint64_t bit = 1ull << o;
#pragma unroll
          for (int d = 0; d < kGroup; ++d) {
            cnt[d] = wrap_add(cnt[d], col[d - o]);
            if (cnt[d] >= m) ok[d] |= bit;
          }
        }
#pragma unroll
        for (int d = 0; d < kGroup; ++d) cov[d] &= ok[d];
      }
#pragma unroll
      for (int d = 0; d < kGroup; ++d) {
        o_star[g + d] = cov[d] ? __ffsll(static_cast<long long>(cov[d])) - 1 : kNoCover;
      }
    }
  }

  // ---- stores: 8 consecutive positions a thread ---------------------------
  uint8_t* emit_row = emit + row * N;
  int32_t* start_row = start + row * N;
  int st[kPerThread];
  uint32_t em[2] = {0u, 0u};
#pragma unroll
  for (int d = 0; d < kPerThread; ++d) {
    const bool covered = o_star[d] < window;
    st[d] = e0 + d - (covered ? o_star[d] : 0);
    em[d / 4] |= static_cast<uint32_t>(covered && ((ev >> d) & 1u)) << (8 * (d % 4));
  }
  if (e0 + kPerThread <= N &&
      (reinterpret_cast<uintptr_t>(emit_row + e0) & 7u) == 0u &&
      (reinterpret_cast<uintptr_t>(start_row + e0) & 15u) == 0u) {
    *reinterpret_cast<uint2*>(emit_row + e0) = make_uint2(em[0], em[1]);
    *reinterpret_cast<int4*>(start_row + e0) = make_int4(st[0], st[1], st[2], st[3]);
    *reinterpret_cast<int4*>(start_row + e0 + 4) = make_int4(st[4], st[5], st[6], st[7]);
  } else {
#pragma unroll
    for (int d = 0; d < kPerThread; ++d) {
      if (e0 + d < N) {
        emit_row[e0 + d] = static_cast<uint8_t>((em[d / 4] >> (8 * (d % 4))) & 1u);
        start_row[e0 + d] = st[d];
      }
    }
  }
}

template <typename T>
int launch(const void* occ, const void* mult, void* emit, void* start, int B,
           int L, int N, int window, void* stream) {
  if (B == 0 || N == 0) return 0;
  const int tiles_per_row = (N + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * tiles_per_row;
  const size_t smem = static_cast<size_t>(L) *
                          (kSpan * sizeof(T) + kWords * sizeof(uint32_t) + 2 * sizeof(int32_t)) +
                      sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        proximity_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  proximity_window_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
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
