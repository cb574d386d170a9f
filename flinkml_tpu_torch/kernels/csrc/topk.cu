// Row-wise top-k for Hopper (sm_90a), any 1 <= k <= n.
//
// Replaces flinkml_tpu/kernels/topk.py:79 pallas_top_k (body _topk_body
// :53): the (values, int32 indices) of the k largest entries of each row
// of a [rows, n] float tensor, in descending IEEE total order with ties
// toward the lower index -- the order of jax.lax.top_k (NaN above +inf,
// +0 above -0, -NaN below -inf). The values are copies of input elements.
//
// The order is an unsigned integer order: a float's bits b map to the
// order key u = (b has its sign bit set) ? ~b : b | sign bit, so that
// unsigned comparison of keys is IEEE total order, and the map inverts
// exactly (values are rebuilt from their keys). Ties compare indices.
//
// What bounds it on the H100: bytes. Each input element is read once
// (rows * n * elem) and k values and indices are written per row; the
// selection does a few operations per element. At [256, 2048] f32 that is
// 2.2 MB (0.7 us); at the KNN chunk [4096, 60000] f32 983 MB (0.29 ms).
//
// The TPU kernel keeps an [8, n] tile in VMEM and runs k masked max passes
// over it. On the card, k passes would read the row k times, so the kernel
// selects the key of rank k first and sorts only the winners. Three routes;
// the wrapper (kernels/topk.py::route) picks one by a fixed rule on rows,
// n, k and the element size:
//
// fused (the row fits shared memory, with the sort buffer): one block per
//   row. 16-byte loads stage the row's order keys in shared memory once;
//   an MSD radix select (8-bit digits, a 256-bin shared histogram per pass,
//   stopping once the prefix group holds exactly the elements still
//   wanted) finds the prefix of the rank-k key; an ordered collect (each
//   warp owns a contiguous range, ballots give positions in index order)
//   takes every element above the prefix group and the first `want` of the
//   group by index -- this is where ties toward the lower index are kept
//   exact; a bitonic sort of the k (key desc, index asc) pairs in shared
//   memory orders them. Bounded by the passes over shared memory and the
//   sort's barriers (log2(k)^2 / 2), not by bytes.
//
// scan (rows fill the card, the row does not fit shared memory, small k:
//   the KNN chunk): one block per row, a strided scan that keeps each
//   thread's best k pairs in shared memory sorted, then k block-wide
//   arg-max rounds. It reads each element once from device memory, which
//   the radix select cannot (a pass per digit), so it keeps the KNN chunk;
//   its serialised insertions grow with k, and past k = 12 the radix route
//   is faster there (kernels/topk.py::SCAN_MAX_K). The kernel takes k up to
//   kScanMaxK.
//
// radix (everything else: long rows, rows too few to fill the card, k too
//   large for one shared-memory sort): the select runs one launch per digit
//   over rows x segs blocks; each block histograms its segment into shared
//   memory and adds the nonzero bins to the row's global histogram, and the
//   last block to arrive picks the digit (a deterministic count, whatever
//   the arrival order). A count launch and a write launch then collect the
//   winners in index order across segments (per-warp counts of the prefix
//   group, summed in a fixed order), and a sort launch orders them, one
//   block per row. k above kSortCap pairs goes in bands of kSortCap ranks:
//   band b selects the boundary of rank min(k, (b + 1) * kSortCap), takes
//   the elements inside that boundary and outside the previous one, and
//   sorts them into ranks [b * kSortCap, ...). There is no k ceiling.
//
// bfloat16 (fml_topk_bf16): each element is widened to its float32 bits as
// it is loaded (exact, and the same order), so the keys, the routes and the
// order rules are float32's; the values written back are the keys' top 16
// bits, bit for bit the input elements. Its loads are element by element.
//
// No synchronisation and no allocation: the wrapper allocates the outputs
// and the scratch (fml_topk_scratch_bytes), and the launches run on
// PyTorch's current stream. Every launch is checked with cudaGetLastError.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kDigitBits = 8;
constexpr int kScanMaxK = 32;
constexpr int kSortCap = 16384;
constexpr int kMaxSortThreads = 1024;
constexpr int kMaxSegments = 1024;
constexpr int kUnroll = 4;
constexpr size_t kMaxDynSmem = 220 * 1024;
constexpr size_t kScanSmemBudget = 200 * 1024;

enum Route { kFused = 0, kScan = 1, kRadix = 2 };

template <typename F>
struct Traits;
// U: the order key's width; B: the stored element's bits; load(p, i):
// element i's bits widened to U; kVecLoads: the routes' 16-byte loads.
template <>
struct Traits<float> {
  using U = uint32_t;
  using B = uint32_t;
  using V = uint4;
  static constexpr int kVec = 4;
  static constexpr bool kVecLoads = true;
  static __device__ __forceinline__ U load(const B* p, int64_t i) {
    return __ldg(p + i);
  }
  static __device__ __forceinline__ float from_bits(U u) {
    return __uint_as_float(u);
  }
};
template <>
struct Traits<double> {
  using U = unsigned long long;
  using B = unsigned long long;
  using V = ulonglong2;
  static constexpr int kVec = 2;
  static constexpr bool kVecLoads = true;
  static __device__ __forceinline__ U load(const B* p, int64_t i) {
    return __ldg(p + i);
  }
  static __device__ __forceinline__ double from_bits(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
};
// bf16: each element widened to its float32 bits (the same value, so the
// key order is the same), keys and selection as float32; the values are
// the keys' top 16 bits. Element by element loads.
template <>
struct Traits<__nv_bfloat16> {
  using U = uint32_t;
  using B = unsigned short;
  using V = uint4;
  static constexpr int kVec = 4;
  static constexpr bool kVecLoads = false;
  static __device__ __forceinline__ U load(const B* p, int64_t i) {
    return static_cast<U>(__ldg(p + i)) << 16;
  }
  static __device__ __forceinline__ __nv_bfloat16 from_bits(U u) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  }
};

__device__ __forceinline__ void unpack(const uint4& v, uint32_t* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void unpack(const ulonglong2& v,
                                       unsigned long long* o) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ uint4 pack(const uint32_t* o) {
  return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ ulonglong2 pack(const unsigned long long* o) {
  return make_ulonglong2(o[0], o[1]);
}

template <typename U>
__device__ __forceinline__ U sign_bit() {
  return static_cast<U>(1) << (8 * sizeof(U) - 1);
}
// Branch-free: a negative b flips every bit, a positive one its sign bit.
template <typename U>
__device__ __forceinline__ U to_key(U b) {
  using S = typename std::make_signed<U>::type;
  return b ^ (static_cast<U>(static_cast<S>(b) >> (8 * sizeof(U) - 1)) |
              sign_bit<U>());
}
template <typename U>
__device__ __forceinline__ U from_key(U u) {
  return (u & sign_bit<U>()) ? (u ^ sign_bit<U>()) : ~u;
}

// (key desc, index asc): whether (ka, ia) ranks before (kb, ib). The empty
// slot (key 0, index INT_MAX) ranks after every element: an element's
// index is below INT_MAX.
template <typename U>
__device__ __forceinline__ bool before(U ka, int ia, U kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Warp-wide: the digit d whose bins above hold fewer than `want` elements
// and whose bins from d up hold at least `want`. `bin(b)` reads bin b.
// Every lane gets d, the count in the bins above d and bin d's count.
template <typename Bin>
__device__ __forceinline__ void pick_digit(Bin bin, int want, int& digit,
                                           int& above, int& count) {
  const int lane = threadIdx.x & 31;
  int c[8];
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = bin(kBins - 1 - (lane * 8 + j));
    s += c[j];
  }
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - s;
  const unsigned hit =
      __ballot_sync(0xffffffffu, excl < want && want <= incl);
  const int src = hit ? __ffs(hit) - 1 : 0;
  int d = 0, a = 0, cnt = 0;
  bool found = false;
  int cum = excl;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!found) {
      if (cum + c[j] >= want) {
        found = true;
        d = kBins - 1 - (lane * 8 + j);
        a = cum;
        cnt = c[j];
      } else {
        cum += c[j];
      }
    }
  }
  digit = __shfl_sync(0xffffffffu, d, src);
  above = __shfl_sync(0xffffffffu, a, src);
  count = __shfl_sync(0xffffffffu, cnt, src);
}

// Bitonic sort of p2 (a power of two) (key, index) pairs in shared memory
// into (key desc, index asc) order, by the whole block.
template <typename U>
__device__ void bitonic_sort(U* key, int* idx, int p2) {
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (p2 >> 1); t += blockDim.x) {
        const int a = 2 * t - (t & (stride - 1));
        const int b = a + stride;
        const U ka = key[a], kb = key[b];
        const int ia = idx[a], ib = idx[b];
        const bool up = (a & size) == 0;
        if (up ? before(kb, ib, ka, ia) : before(ka, ia, kb, ib)) {
          key[a] = kb;
          key[b] = ka;
          idx[a] = ib;
          idx[b] = ia;
        }
      }
      __syncthreads();
    }
  }
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// -- fused route ------------------------------------------------------------

template <typename F>
size_t fused_smem(int n, int p2) {
  using U = typename Traits<F>::U;
  constexpr int kVec = Traits<F>::kVec;
  const size_t staged = (static_cast<size_t>(n) + kVec - 1) / kVec * kVec;
  return staged * sizeof(U) + static_cast<size_t>(p2) * (sizeof(U) + 4);
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
topk_fused_kernel(const F* __restrict__ x, int n, int k, int p2,
                  F* __restrict__ out_val, int32_t* __restrict__ out_idx) {
  using U = typename Traits<F>::U;
  using V = typename Traits<F>::V;
  constexpr int kVec = Traits<F>::kVec;
  constexpr int kW = 8 * sizeof(U);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int hist[kBins];
  __shared__ int warp_gt[kWarps], warp_eq[kWarps];
  __shared__ U s_prefix, s_mask;
  __shared__ int s_want, s_above, s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  U* keys = reinterpret_cast<U*>(smem);
  U* skey = keys + (n + kVec - 1) / kVec * kVec;
  int* sidx = reinterpret_cast<int*>(skey + p2);
  const int64_t row = blockIdx.x;
  const typename Traits<F>::B* xr =
      reinterpret_cast<const typename Traits<F>::B*>(x) + row * n;

  // 1. Stage the row's order keys (16-byte loads where the row is aligned).
  int head = 0;
  if (Traits<F>::kVecLoads && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const int nv = n / kVec;
    const V* xv = reinterpret_cast<const V*>(xr);
    V* kv = reinterpret_cast<V*>(keys);
    for (int v = tid; v < nv; v += kThreads) {
      U o[kVec];
      unpack(__ldg(xv + v), o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = to_key(o[j]);
      kv[v] = pack(o);
    }
    head = nv * kVec;
  }
  for (int i = head + tid; i < n; i += kThreads) {
    keys[i] = to_key(Traits<F>::load(xr, i));
  }
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_want = k;
    s_above = 0;
    s_done = 0;
  }
  __syncthreads();

  // 2. Radix select of the rank-k key's prefix.
  for (int shift = kW - kDigitBits; shift >= 0; shift -= kDigitBits) {
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    const U prefix = s_prefix, mask = s_mask;
    for (int i = tid; i < n; i += kThreads) {
      const U u = keys[i];
      if ((u & mask) == prefix) {
        atomicAdd(&hist[static_cast<int>(u >> shift) & (kBins - 1)], 1);
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int want = s_want;
      int d, above, cnt;
      pick_digit([&](int b) { return hist[b]; }, want, d, above, cnt);
      if (lane == 0) {
        s_above += above;
        s_want = want - above;
        s_prefix = prefix | (static_cast<U>(d) << shift);
        s_mask = mask | (static_cast<U>(kBins - 1) << shift);
        s_done = cnt == want - above || shift == 0;
      }
    }
    __syncthreads();
    if (s_done) break;
  }

  // 3. Ordered collect: keys above the prefix group, then the group's first
  //    `want` elements by index.
  const U prefix = s_prefix, mask = s_mask;
  const int want = s_want, above = s_above;
  const int span = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * span), hi = min(n, lo + span);
  int gt = 0, eq = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const U m = (i < hi ? keys[i] : U(0)) & mask;
    gt += __popc(__ballot_sync(0xffffffffu, i < hi && m > prefix));
    eq += __popc(__ballot_sync(0xffffffffu, i < hi && m == prefix));
  }
  if (lane == 0) {
    warp_gt[warp] = gt;
    warp_eq[warp] = eq;
  }
  __syncthreads();
  int gbase = 0, ebase = 0;
  for (int w = 0; w < warp; ++w) {
    gbase += warp_gt[w];
    ebase += warp_eq[w];
  }
  const unsigned below = lanes_below();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const U u = i < hi ? keys[i] : U(0);
    const U m = u & mask;
    const bool g = i < hi && m > prefix;
    const bool e = i < hi && m == prefix;
    const unsigned bg = __ballot_sync(0xffffffffu, g);
    const unsigned be = __ballot_sync(0xffffffffu, e);
    if (g) {
      const int p = gbase + __popc(bg & below);
      skey[p] = u;
      sidx[p] = i;
    }
    if (e) {
      const int r = ebase + __popc(be & below);
      if (r < want) {
        skey[above + r] = u;
        sidx[above + r] = i;
      }
    }
    gbase += __popc(bg);
    ebase += __popc(be);
  }
  for (int p = k + tid; p < p2; p += kThreads) {
    skey[p] = 0;
    sidx[p] = INT_MAX;
  }
  __syncthreads();

  // 4. Sort the winners and write them.
  bitonic_sort(skey, sidx, p2);
  const int64_t out = row * k;
  for (int i = tid; i < k; i += kThreads) {
    out_idx[out + i] = sidx[i];
    out_val[out + i] = Traits<F>::from_bits(from_key(skey[i]));
  }
}

// -- scan route --------------------------------------------------------------

template <typename U>
__device__ __forceinline__ void warp_best(U& key, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const U ok = __shfl_down_sync(0xffffffffu, key, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (before(ok, oi, key, idx)) {
      key = ok;
      idx = oi;
    }
  }
}

// Thread t reads the 16-byte groups t, t + T, ... of the row (coalesced;
// single elements t, t + T, ... when rows are not 16-byte aligned), kUnroll
// loads in flight, and keeps its best k (key, index) pairs in shared memory
// sorted, slot-major ([k][T]); a new element is first compared with the
// thread's k-th key, held in a register. Then k rounds of a block-wide
// arg-max over the threads' heads write the row's result. The scan issues
// a few instructions per element, so at the KNN chunk instruction issue,
// not bytes, sets its time: 16-byte loads cut the loads' share.
template <typename F>
__global__ void __launch_bounds__(kThreads)
topk_scan_kernel(const F* __restrict__ x, int n, int k, int vec,
                 F* __restrict__ out_val, int32_t* __restrict__ out_idx) {
  using U = typename Traits<F>::U;
  using V = typename Traits<F>::V;
  constexpr int kVec = Traits<F>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ U warp_key[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int winner;

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  U* keys = reinterpret_cast<U*>(smem);
  int* idxs = reinterpret_cast<int*>(keys + static_cast<size_t>(k) * T);
  const int64_t row = blockIdx.x;
  const typename Traits<F>::B* bits =
      reinterpret_cast<const typename Traits<F>::B*>(x) + row * n;

  int cnt = 0;
  U worst = 0;  // the k-th kept key, once cnt == k
  auto offer = [&](U key, int i) {
    int pos;
    if (cnt == k) {
      if (key <= worst) return;  // a tie has a larger index: ranks after
      pos = k - 1;
    } else {
      pos = cnt++;
    }
    while (pos > 0) {
      const U prev = keys[(pos - 1) * T + tid];
      if (!(key > prev)) break;
      keys[pos * T + tid] = prev;
      idxs[pos * T + tid] = idxs[(pos - 1) * T + tid];
      --pos;
    }
    keys[pos * T + tid] = key;
    idxs[pos * T + tid] = i;
    if (cnt == k) worst = keys[(k - 1) * T + tid];
  };

  // Element i belongs to thread (i / per) % T.
  const int per = vec ? kVec : 1;
  if (vec) {
    const V* xv = reinterpret_cast<const V*>(bits);
    const int nv = n / kVec;
    int v = tid;
    for (; v + (kUnroll - 1) * T < nv; v += kUnroll * T) {
      V b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) b[u] = __ldg(xv + v + u * T);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        U o[kVec];
        unpack(b[u], o);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          offer(to_key(o[j]), (v + u * T) * kVec + j);
        }
      }
    }
    for (; v < nv; v += T) {
      U o[kVec];
      unpack(__ldg(xv + v), o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) offer(to_key(o[j]), v * kVec + j);
    }
  } else {
    int i = tid;
    for (; i + (kUnroll - 1) * T < n; i += kUnroll * T) {
      U b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) b[u] = Traits<F>::load(bits, i + u * T);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) offer(to_key(b[u]), i + u * T);
    }
    for (; i < n; i += T) offer(to_key(Traits<F>::load(bits, i)), i);
  }

  const int n_warps = T >> 5;
  const int64_t out = row * k;
  int head = 0;
  for (int r = 0; r < k; ++r) {
    U ck = head < cnt ? keys[head * T + tid] : U(0);
    int ci = head < cnt ? idxs[head * T + tid] : INT_MAX;
    warp_best(ck, ci);
    if (lane == 0) {
      warp_key[warp] = ck;
      warp_idx[warp] = ci;
    }
    __syncthreads();
    if (warp == 0) {
      ck = lane < n_warps ? warp_key[lane] : U(0);
      ci = lane < n_warps ? warp_idx[lane] : INT_MAX;
      warp_best(ck, ci);
      if (lane == 0) {
        winner = ci;
        out_idx[out + r] = ci;
        out_val[out + r] = Traits<F>::from_bits(from_key(ck));
      }
    }
    __syncthreads();
    // `winner` is rewritten only after the next round's first barrier.
    if (winner != INT_MAX && (winner / per) % T == tid) ++head;
  }
}

// Threads of a scan block: 256, halved until the k pairs per thread fit
// kScanSmemBudget and while T >= 2 * n, at least one warp.
template <typename F>
int scan_threads(int n, int k) {
  using U = typename Traits<F>::U;
  const size_t pair = sizeof(U) + sizeof(int);
  int t = kThreads;
  while (t > 32 && (static_cast<size_t>(t) * k * pair > kScanSmemBudget ||
                    t >= 2 * static_cast<int64_t>(n))) {
    t >>= 1;
  }
  return t;
}

// -- radix route -------------------------------------------------------------

// One rank boundary of one row: the top r elements are those whose masked
// key is above `prefix`, then the first `want` (by index) equal to it.
template <typename U>
struct alignas(16) Select {
  U prefix;          // the boundary key's resolved high bits
  U mask;            // which bits are resolved
  int want;          // elements still to take from the prefix group
  int above;         // elements strictly above the prefix group
  int done;          // 1 once the boundary needs no further pass
  unsigned arrived;  // blocks of the current pass that have finished
  int filled;        // band slots written by the write step
  int hist[kBins];   // the current pass's digit histogram
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
topk_init_kernel(Select<U>* __restrict__ st, int want) {
  Select<U>& s = st[blockIdx.x];
  for (int b = threadIdx.x; b < kBins; b += kThreads) s.hist[b] = 0;
  if (threadIdx.x == 0) {
    s.prefix = 0;
    s.mask = 0;
    s.want = want;
    s.above = 0;
    s.done = want == 0;
    s.arrived = 0;
    s.filled = 0;
  }
}

// One digit pass over every row: block b histograms segment b % segs of
// row b / segs; the row's last block to arrive picks the digit.
template <typename F>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const F* __restrict__ x, int n, int segs, int seg_len,
                   Select<typename Traits<F>::U>* __restrict__ st,
                   int shift) {
  using U = typename Traits<F>::U;
  __shared__ int h[kBins];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / segs;
  const int seg = blockIdx.x % segs;
  Select<U>& s = st[row];
  if (s.done) return;
  const U prefix = s.prefix, mask = s.mask;
  for (int b = tid; b < kBins; b += kThreads) h[b] = 0;
  __syncthreads();
  const typename Traits<F>::B* xr =
      reinterpret_cast<const typename Traits<F>::B*>(x) + row * n;
  const int64_t lo = static_cast<int64_t>(seg) * seg_len;
  const int64_t hi = min(static_cast<int64_t>(n), lo + seg_len);
  auto add = [&](U u) {
    if ((u & mask) == prefix) {
      atomicAdd(&h[static_cast<int>(u >> shift) & (kBins - 1)], 1);
    }
  };
  int64_t i = lo + tid;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    U b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) b[u] = Traits<F>::load(xr, i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(to_key(b[u]));
  }
  for (; i < hi; i += kThreads) add(to_key(Traits<F>::load(xr, i)));
  __syncthreads();
  for (int b = tid; b < kBins; b += kThreads) {
    if (h[b]) atomicAdd(&s.hist[b], h[b]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&s.arrived, 1u) == static_cast<unsigned>(segs - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < 32) {
    const int want = s.want;
    int d, above, cnt;
    pick_digit([&](int b) { return __ldcg(&s.hist[b]); }, want, d, above,
               cnt);
    if (tid == 0) {
      s.above += above;
      s.want = want - above;
      s.prefix = prefix | (static_cast<U>(d) << shift);
      s.mask = mask | (static_cast<U>(kBins - 1) << shift);
      s.done = cnt == want - above || shift == 0;
      s.arrived = 0;
    }
  }
  __syncthreads();
  for (int b = tid; b < kBins; b += kThreads) s.hist[b] = 0;
}

// Warp w of block (row, seg) owns elements [a, b) of its segment.
__device__ __forceinline__ void warp_range(int n, int seg, int seg_len,
                                           int64_t& a, int64_t& b) {
  const int64_t lo = static_cast<int64_t>(seg) * seg_len;
  const int64_t hi = min(static_cast<int64_t>(n), lo + seg_len);
  const int64_t span = ((hi - lo + kWarps - 1) / kWarps + 31) & ~int64_t(31);
  a = min(hi, lo + (threadIdx.x >> 5) * span);
  b = min(hi, a + span);
}

// Per warp: how many of its elements fall in the lo and hi boundaries'
// prefix groups.
template <typename F>
__global__ void __launch_bounds__(kThreads)
topk_count_kernel(const F* __restrict__ x, int n, int segs, int seg_len,
                  const Select<typename Traits<F>::U>* __restrict__ lo_st,
                  const Select<typename Traits<F>::U>* __restrict__ hi_st,
                  int* __restrict__ wcnt) {
  using U = typename Traits<F>::U;
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x / segs;
  const int seg = blockIdx.x % segs;
  const U lp = lo_st[row].prefix, lm = lo_st[row].mask;
  const U hp = hi_st[row].prefix, hm = hi_st[row].mask;
  const typename Traits<F>::B* xr =
      reinterpret_cast<const typename Traits<F>::B*>(x) + row * n;
  int64_t a, b;
  warp_range(n, seg, seg_len, a, b);
  int e_lo = 0, e_hi = 0;
  for (int64_t base = a; base < b; base += 32) {
    const int64_t i = base + lane;
    const bool valid = i < b;
    const U u = valid ? to_key(Traits<F>::load(xr, i)) : U(0);
    e_lo += __popc(__ballot_sync(0xffffffffu, valid && (u & lm) == lp));
    e_hi += __popc(__ballot_sync(0xffffffffu, valid && (u & hm) == hp));
  }
  if (lane == 0) {
    int* c = wcnt + ((row * segs + seg) * kWarps + (threadIdx.x >> 5)) * 2;
    c[0] = e_lo;
    c[1] = e_hi;
  }
}

// The band's elements -- inside the hi boundary and outside the lo one --
// into the row's candidate slots (in any slot order: the sort orders them).
template <typename F>
__global__ void __launch_bounds__(kThreads)
topk_write_kernel(const F* __restrict__ x, int n, int segs, int seg_len,
                  const Select<typename Traits<F>::U>* __restrict__ lo_st,
                  Select<typename Traits<F>::U>* __restrict__ hi_st,
                  const int* __restrict__ wcnt,
                  typename Traits<F>::U* __restrict__ ckey,
                  int* __restrict__ cidx, int cap) {
  using U = typename Traits<F>::U;
  __shared__ int red[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x / segs;
  const int seg = blockIdx.x % segs;
  const Select<U>& lo = lo_st[row];
  Select<U>& hi = hi_st[row];
  const U lp = lo.prefix, lm = lo.mask, hp = hi.prefix, hm = hi.mask;
  const int lw = lo.want, hw = hi.want;

  // Group positions before this warp: the counts of every earlier warp of
  // the row, summed in a fixed order.
  const int* rc = wcnt + row * segs * kWarps * 2;
  const int64_t before_blk = static_cast<int64_t>(seg) * kWarps;
  int s_lo = 0, s_hi = 0;
  for (int64_t j = tid; j < before_blk; j += kThreads) {
    s_lo += rc[2 * j];
    s_hi += rc[2 * j + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, off);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, off);
  }
  if (lane == 0) {
    red[0][warp] = s_lo;
    red[1][warp] = s_hi;
  }
  __syncthreads();
  int base_lo = 0, base_hi = 0;
  for (int w = 0; w < kWarps; ++w) {
    base_lo += red[0][w];
    base_hi += red[1][w];
  }
  for (int w = 0; w < warp; ++w) {
    base_lo += rc[2 * (before_blk + w)];
    base_hi += rc[2 * (before_blk + w) + 1];
  }

  const typename Traits<F>::B* xr =
      reinterpret_cast<const typename Traits<F>::B*>(x) + row * n;
  const unsigned below = lanes_below();
  int64_t a, b;
  warp_range(n, seg, seg_len, a, b);
  for (int64_t base = a; base < b; base += 32) {
    const int64_t i = base + lane;
    const bool valid = i < b;
    const U u = valid ? to_key(Traits<F>::load(xr, i)) : U(0);
    const bool e_lo = valid && (u & lm) == lp;
    const bool e_hi = valid && (u & hm) == hp;
    const unsigned b_lo = __ballot_sync(0xffffffffu, e_lo);
    const unsigned b_hi = __ballot_sync(0xffffffffu, e_hi);
    const bool in_lo = valid && ((u & lm) > lp ||
                                 (e_lo && base_lo + __popc(b_lo & below) < lw));
    const bool in_hi = valid && ((u & hm) > hp ||
                                 (e_hi && base_hi + __popc(b_hi & below) < hw));
    const bool take = in_hi && !in_lo;
    const unsigned bt = __ballot_sync(0xffffffffu, take);
    int slot = 0;
    if (lane == 0 && bt) slot = atomicAdd(&hi.filled, __popc(bt));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (take) {
      const int p = slot + __popc(bt & below);
      if (p < cap) {
        ckey[row * cap + p] = u;
        cidx[row * cap + p] = static_cast<int>(i);
      }
    }
    base_lo += __popc(b_lo);
    base_hi += __popc(b_hi);
  }
}

// One block per row: sort the band's cnt candidates and write them to
// ranks [offset, offset + cnt).
template <typename F>
__global__ void __launch_bounds__(kMaxSortThreads)
topk_sort_kernel(const typename Traits<F>::U* __restrict__ ckey,
                 const int* __restrict__ cidx, int cap, int cnt, int p2,
                 int k, int offset, F* __restrict__ out_val,
                 int32_t* __restrict__ out_idx) {
  using U = typename Traits<F>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  U* skey = reinterpret_cast<U*>(smem);
  int* sidx = reinterpret_cast<int*>(skey + p2);
  const int64_t row = blockIdx.x;
  for (int p = threadIdx.x; p < p2; p += blockDim.x) {
    skey[p] = p < cnt ? ckey[row * cap + p] : U(0);
    sidx[p] = p < cnt ? cidx[row * cap + p] : INT_MAX;
  }
  __syncthreads();
  bitonic_sort(skey, sidx, p2);
  const int64_t out = row * k + offset;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    out_idx[out + i] = sidx[i];
    out_val[out + i] = Traits<F>::from_bits(from_key(skey[i]));
  }
}

// Scratch of the radix route: two boundaries per row, per-warp group
// counts, and the band's candidate slots.
template <typename F>
struct RadixScratch {
  using U = typename Traits<F>::U;
  Select<U>* lo;
  Select<U>* hi;
  int* wcnt;
  U* ckey;
  int* cidx;
  int cap;

  static size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

  // The scratch's size; with `out`, also its layout over `base`.
  static size_t bytes(int64_t rows, int k, int segs, RadixScratch* out,
                      void* base) {
    const int cap = k < kSortCap ? k : kSortCap;
    const size_t st = align16(static_cast<size_t>(rows) * sizeof(Select<U>));
    const size_t wc = align16(static_cast<size_t>(rows) * segs * kWarps * 2 *
                              sizeof(int));
    const size_t ck = align16(static_cast<size_t>(rows) * cap * sizeof(U));
    const size_t ci = align16(static_cast<size_t>(rows) * cap * sizeof(int));
    if (out) {
      unsigned char* p = static_cast<unsigned char*>(base);
      out->lo = reinterpret_cast<Select<U>*>(p);
      out->hi = reinterpret_cast<Select<U>*>(p + st);
      out->wcnt = reinterpret_cast<int*>(p + 2 * st);
      out->ckey = reinterpret_cast<U*>(p + 2 * st + wc);
      out->cidx = reinterpret_cast<int*>(p + 2 * st + wc + ck);
      out->cap = cap;
    }
    return 2 * st + wc + ck + ci;
  }
};

#define FML_CHECK_LAUNCH()                              \
  do {                                                  \
    const cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <typename F>
int launch_radix(const F* x, int64_t rows, int n, int k, int segs,
                 F* values, int32_t* indices, void* scratch,
                 cudaStream_t s) {
  using U = typename Traits<F>::U;
  constexpr int kW = 8 * sizeof(U);
  RadixScratch<F> sc;
  RadixScratch<F>::bytes(rows, k, segs, &sc, scratch);
  const int seg_len =
      static_cast<int>((static_cast<int64_t>(n) + segs - 1) / segs);
  const unsigned blocks = static_cast<unsigned>(rows * segs);
  const unsigned row_blocks = static_cast<unsigned>(rows);
  Select<U>* lo = sc.lo;
  Select<U>* hi = sc.hi;
  topk_init_kernel<U><<<row_blocks, kThreads, 0, s>>>(lo, 0);
  FML_CHECK_LAUNCH();
  for (int band_lo = 0; band_lo < k; band_lo += sc.cap) {
    const int band_hi = k - band_lo < sc.cap ? k : band_lo + sc.cap;
    const int cnt = band_hi - band_lo;
    topk_init_kernel<U><<<row_blocks, kThreads, 0, s>>>(hi, band_hi);
    FML_CHECK_LAUNCH();
    for (int shift = kW - kDigitBits; shift >= 0; shift -= kDigitBits) {
      topk_select_kernel<F><<<blocks, kThreads, 0, s>>>(x, n, segs, seg_len,
                                                        hi, shift);
      FML_CHECK_LAUNCH();
    }
    topk_count_kernel<F><<<blocks, kThreads, 0, s>>>(x, n, segs, seg_len, lo,
                                                     hi, sc.wcnt);
    FML_CHECK_LAUNCH();
    topk_write_kernel<F><<<blocks, kThreads, 0, s>>>(
        x, n, segs, seg_len, lo, hi, sc.wcnt, sc.ckey, sc.cidx, sc.cap);
    FML_CHECK_LAUNCH();
    const int p2 = next_pow2(cnt);
    const size_t smem = static_cast<size_t>(p2) * (sizeof(U) + sizeof(int));
    const cudaError_t e = cudaFuncSetAttribute(
        topk_sort_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int t = 32;
    while (t < kMaxSortThreads && t < p2 / 2) t <<= 1;
    topk_sort_kernel<F><<<row_blocks, t, smem, s>>>(
        sc.ckey, sc.cidx, sc.cap, cnt, p2, k, band_lo, values, indices);
    FML_CHECK_LAUNCH();
    Select<U>* tmp = lo;
    lo = hi;
    hi = tmp;
  }
  return static_cast<int>(cudaSuccess);
}

template <typename F>
int launch(const void* xv, int64_t rows, int n, int k, int route, int segs,
           void* values, void* indices, void* scratch, void* stream) {
  if (k < 1 || k > n || rows < 0 || segs < 1 || segs > kMaxSegments ||
      rows * segs >= INT_MAX || (route == kRadix && !scratch && rows > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F* x = static_cast<const F*>(xv);
  F* val = static_cast<F*>(values);
  int32_t* idx = static_cast<int32_t*>(indices);
  const unsigned row_blocks = static_cast<unsigned>(rows);
  switch (route) {
    case kFused: {
      const int p2 = next_pow2(k);
      const size_t smem = fused_smem<F>(n, p2);
      if (segs != 1 || smem > kMaxDynSmem) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const cudaError_t e = cudaFuncSetAttribute(
          topk_fused_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      topk_fused_kernel<F><<<row_blocks, kThreads, smem, s>>>(x, n, k, p2,
                                                              val, idx);
      FML_CHECK_LAUNCH();
      return static_cast<int>(cudaSuccess);
    }
    case kScan: {
      if (segs != 1 || k > kScanMaxK) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      using U = typename Traits<F>::U;
      const int t = scan_threads<F>(n, k);
      const size_t smem =
          static_cast<size_t>(t) * k * (sizeof(U) + sizeof(int));
      const cudaError_t e = cudaFuncSetAttribute(
          topk_scan_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      // 16-byte loads when every row starts 16-byte aligned.
      const int vec = Traits<F>::kVecLoads &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                      (static_cast<size_t>(n) * sizeof(F)) % 16 == 0;
      topk_scan_kernel<F><<<row_blocks, t, smem, s>>>(x, n, k, vec, val, idx);
      FML_CHECK_LAUNCH();
      return static_cast<int>(cudaSuccess);
    }
    case kRadix:
      return launch_radix<F>(x, rows, n, k, segs, val, idx, scratch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int64_t scratch_bytes(int64_t rows, int k, int route, int segs) {
  if (route != kRadix || rows <= 0 || k < 1 || segs < 1) return 0;
  return static_cast<int64_t>(
      RadixScratch<F>::bytes(rows, k, segs, nullptr, nullptr));
}

}  // namespace

extern "C" int fml_topk_f32(const void* x, int64_t rows, int n, int k,
                            int route, int segs, void* values, void* indices,
                            void* scratch, void* stream) {
  return launch<float>(x, rows, n, k, route, segs, values, indices, scratch,
                       stream);
}

extern "C" int fml_topk_f64(const void* x, int64_t rows, int n, int k,
                            int route, int segs, void* values, void* indices,
                            void* scratch, void* stream) {
  return launch<double>(x, rows, n, k, route, segs, values, indices, scratch,
                        stream);
}

extern "C" int fml_topk_bf16(const void* x, int64_t rows, int n, int k,
                             int route, int segs, void* values,
                             void* indices, void* scratch, void* stream) {
  return launch<__nv_bfloat16>(x, rows, n, k, route, segs, values, indices,
                               scratch, stream);
}

extern "C" int64_t fml_topk_scratch_bytes_f32(int64_t rows, int k, int route,
                                              int segs) {
  return scratch_bytes<float>(rows, k, route, segs);
}

extern "C" int64_t fml_topk_scratch_bytes_f64(int64_t rows, int k, int route,
                                              int segs) {
  return scratch_bytes<double>(rows, k, route, segs);
}

extern "C" int64_t fml_topk_scratch_bytes_bf16(int64_t rows, int k,
                                               int route, int segs) {
  return scratch_bytes<__nv_bfloat16>(rows, k, route, segs);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
