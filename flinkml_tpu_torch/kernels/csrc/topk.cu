// Row-wise top-k for Hopper (sm_90a).
//
// Replaces flinkml_tpu/kernels/topk.py:79 pallas_top_k (body _topk_body
// :53): the (values, int32 indices) of the k largest entries of each row
// of a [rows, n] float tensor, in descending IEEE total order with ties
// toward the lower index -- the order of jax.lax.top_k (NaN above +inf,
// +0 above -0, -NaN below -inf). The values are copies of input elements.
//
// The order is an integer order: a float's bits b (as a signed integer of
// its width) map to key = b ^ ((b >> (width-1)) & 0x7f..f), which flips the
// magnitude bits of negative numbers, so that signed integer comparison of
// keys is IEEE total order. Ties compare indices.
//
// What bounds it on the H100: bytes. Each input element is read once
// (rows * n * elem) and k values and indices are written per row: at the
// KNN chunk shape [4096, 60000] f32 that is 983 MB, 0.29 ms at 3.35 TB/s;
// the selection's comparisons are a few per element.
//
// The TPU kernel keeps an [8, n] tile in VMEM and runs k masked max passes
// over it (k reads of the tile from VMEM). A block has no such room, and k
// passes over device memory would read the input k times. Instead, one
// thread block per row segment (the whole row, unless the wrapper splits
// rows too few to fill the card into `segs` segments):
//
// 1. Scan. Thread t reads elements lo + t, lo + t + T, ... (neighbouring
//    threads read neighbouring elements: coalesced), kUnroll loads in
//    flight, and keeps its best k (key, index) pairs in shared memory,
//    sorted by (key desc, index asc). A new element is first compared with
//    the thread's k-th key, held in a register, so most elements cost one
//    comparison. Indices arrive in ascending order, so an element that
//    ties a kept key ranks after it.
// 2. Merge. k rounds of a block-wide arg-max over the threads' current
//    heads (warp shuffles, then one warp over the warps' winners). The
//    winner is written out and the thread that kept it advances its head.
//    For a whole row the winners are the result; for a segment they are
//    its ordered candidate list.
// 3. Split rows only: one block per row merges the segments' ordered lists
//    (a k-way merge: k more arg-max rounds over the lists' heads). The
//    segments' top-k hold every element of the row's top-k, so the merge
//    is exact.
//
// Why split: a thread's insertions diverge from its warp's, so a block
// that keeps k pairs per thread over a long row spends its time in
// serialised insertions; a 1-D input of 1e6 elements in one block took
// 18 ms on the H100. In segments of a few thousand elements every SM works
// and each thread sees few elements.
//
// Shared memory holds T * k pairs, slot-major ([k][T]), so that threads of
// a warp touch consecutive words. T is 256, halved until the pairs fit
// kSmemBudget (and while T >= 2 * segment length), at least one warp.
//
// No synchronisation and no allocation: the wrapper allocates the outputs
// and the candidate scratch, and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxThreads = 256;
constexpr int kMaxSegments = 1024;
constexpr int kUnroll = 4;
constexpr size_t kSmemBudget = 200 * 1024;

// The signed integer view of each float type.
template <typename F>
struct Bits;
template <>
struct Bits<float> {
  using T = int32_t;
};
template <>
struct Bits<double> {
  using T = long long;
};

__device__ __forceinline__ int32_t order_key(int32_t b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ long long order_key(long long b) {
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

// The empty candidate (lowest key, index INT_MAX) ranks after every
// element: an element's index is below INT_MAX.
template <typename K>
__device__ __forceinline__ K lowest();
template <>
__device__ __forceinline__ int32_t lowest<int32_t>() {
  return INT32_MIN;
}
template <>
__device__ __forceinline__ long long lowest<long long>() {
  return LLONG_MIN;
}

// (key desc, index asc): whether (ka, ia) ranks before (kb, ib).
template <typename K>
__device__ __forceinline__ bool before(K ka, int ia, K kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

template <typename K>
__device__ __forceinline__ void warp_best(K& key, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const K ok = __shfl_down_sync(0xffffffffu, key, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (before(ok, oi, key, idx)) {
      key = ok;
      idx = oi;
    }
  }
}

// k rounds of a block-wide arg-max. `current(key, idx)` gives the calling
// thread's current head, `advance(winner)` runs on every thread after a
// round (the thread that holds the winner moves past it), `emit(r, key,
// idx)` runs on thread 0 with round r's winner.
template <typename K, typename Current, typename Advance, typename Emit>
__device__ __forceinline__ void block_merge(int k, Current current,
                                            Advance advance, Emit emit) {
  __shared__ K warp_key[kMaxThreads / 32];
  __shared__ int warp_idx[kMaxThreads / 32];
  __shared__ int winner;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = 0; r < k; ++r) {
    K ck;
    int ci;
    current(ck, ci);
    warp_best(ck, ci);
    if (lane == 0) {
      warp_key[warp] = ck;
      warp_idx[warp] = ci;
    }
    __syncthreads();
    if (warp == 0) {
      ck = lane < n_warps ? warp_key[lane] : lowest<K>();
      ci = lane < n_warps ? warp_idx[lane] : INT_MAX;
      warp_best(ck, ci);
      if (lane == 0) {
        winner = ci;
        emit(r, ck, ci);
      }
    }
    __syncthreads();
    // `winner` is rewritten only after the next round's first barrier.
    advance(winner);
  }
}

// Steps 1-2. Block b ranks segment b % segs of row b / segs: elements
// [lo, hi). With segs == 1 it writes the row's values and indices; with
// segs > 1 the segment's k best (key, index) pairs in order, padded with
// the empty candidate when the segment holds fewer than k elements.
template <typename F>
__global__ void __launch_bounds__(kMaxThreads)
topk_scan_kernel(const F* __restrict__ x, int n, int k, int segs, int seg_len,
                 F* __restrict__ out_val, int32_t* __restrict__ out_idx,
                 typename Bits<F>::T* __restrict__ cand_key,
                 int* __restrict__ cand_idx) {
  using K = typename Bits<F>::T;
  extern __shared__ __align__(16) unsigned char smem[];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  K* keys = reinterpret_cast<K*>(smem);
  int* idxs = reinterpret_cast<int*>(keys + static_cast<size_t>(k) * T);
  const int64_t row_off = static_cast<int64_t>(blockIdx.x / segs) * n;
  const K* bits = reinterpret_cast<const K*>(x) + row_off;
  const int lo = static_cast<int>(blockIdx.x % segs) * seg_len;
  const int hi = n - lo < seg_len ? n : lo + seg_len;

  // -- scan -----------------------------------------------------------------
  int cnt = 0;
  K worst = lowest<K>();  // the k-th kept key, once cnt == k
  auto offer = [&](K key, int i) {
    int pos;
    if (cnt == k) {
      if (key <= worst) return;  // a tie has a larger index: ranks after
      pos = k - 1;
    } else {
      pos = cnt++;
    }
    while (pos > 0) {
      const K prev = keys[(pos - 1) * T + tid];
      if (!(key > prev)) break;
      keys[pos * T + tid] = prev;
      idxs[pos * T + tid] = idxs[(pos - 1) * T + tid];
      --pos;
    }
    keys[pos * T + tid] = key;
    idxs[pos * T + tid] = i;
    if (cnt == k) worst = keys[(k - 1) * T + tid];
  };

  int i = lo + tid;
  for (; i + (kUnroll - 1) * T < hi; i += kUnroll * T) {
    K b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) b[u] = __ldg(bits + i + u * T);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) offer(order_key(b[u]), i + u * T);
  }
  for (; i < hi; i += T) offer(order_key(__ldg(bits + i)), i);

  // -- merge ----------------------------------------------------------------
  const int64_t out_off = static_cast<int64_t>(blockIdx.x) * k;
  int head = 0;
  block_merge<K>(
      k,
      [&](K& key, int& idx) {
        key = head < cnt ? keys[head * T + tid] : lowest<K>();
        idx = head < cnt ? idxs[head * T + tid] : INT_MAX;
      },
      [&](int w) {
        if (w != INT_MAX && (w - lo) % T == tid) ++head;
      },
      [&](int r, K key, int idx) {
        if (segs == 1) {
          out_idx[out_off + r] = idx;
          out_val[out_off + r] = x[row_off + idx];
        } else {
          cand_key[out_off + r] = key;
          cand_idx[out_off + r] = idx;
        }
      });
}

// Step 3 (segs > 1): per row, a k-way merge of the segments' ordered
// candidate lists. Thread t owns lists t, t + T, ...; each list's current
// head sits in shared memory and a thread's best head in registers, so a
// round reads device memory only where the winner's list advances.
template <typename F>
__global__ void __launch_bounds__(kMaxThreads)
topk_merge_kernel(const F* __restrict__ x, int n, int k, int segs,
                  int seg_len, const typename Bits<F>::T* __restrict__ cand_key,
                  const int* __restrict__ cand_idx, F* __restrict__ out_val,
                  int32_t* __restrict__ out_idx) {
  using K = typename Bits<F>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  K* head_key = reinterpret_cast<K*>(smem);
  int* head_idx = reinterpret_cast<int*>(head_key + segs);
  int* head_pos = head_idx + segs;

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t base = row * segs * k;
  for (int s = tid; s < segs; s += T) {
    head_pos[s] = 0;
    head_key[s] = cand_key[base + static_cast<int64_t>(s) * k];
    head_idx[s] = cand_idx[base + static_cast<int64_t>(s) * k];
  }
  // Each thread reads only the heads it wrote: no barrier needed.
  K best_key;
  int best_idx;
  auto best_of_mine = [&]() {
    best_key = lowest<K>();
    best_idx = INT_MAX;
    for (int s = tid; s < segs; s += T) {
      if (before(head_key[s], head_idx[s], best_key, best_idx)) {
        best_key = head_key[s];
        best_idx = head_idx[s];
      }
    }
  };
  best_of_mine();

  block_merge<K>(
      k,
      [&](K& key, int& idx) {
        key = best_key;
        idx = best_idx;
      },
      [&](int w) {
        const int s = w / seg_len;
        if (s % T != tid) return;
        const int h = ++head_pos[s];
        const int64_t c = base + static_cast<int64_t>(s) * k + h;
        head_key[s] = h < k ? cand_key[c] : lowest<K>();
        head_idx[s] = h < k ? cand_idx[c] : INT_MAX;
        best_of_mine();
      },
      [&](int r, K, int idx) {
        out_idx[row * k + r] = idx;
        out_val[row * k + r] = x[row * n + idx];
      });
}

// Threads of a scan block: 256, halved until the k pairs per thread fit
// kSmemBudget and while T >= 2 * len, at least one warp.
template <typename F>
int scan_threads(int len, int k) {
  using K = typename Bits<F>::T;
  const size_t pair = sizeof(K) + sizeof(int);
  int t = kMaxThreads;
  while (t > 32 && (static_cast<size_t>(t) * k * pair > kSmemBudget ||
                    t >= 2 * static_cast<int64_t>(len))) {
    t >>= 1;
  }
  return t;
}

template <typename F>
int launch(const void* x, int64_t rows, int n, int k, int segs, void* values,
           void* indices, void* cand_key, void* cand_idx, void* stream) {
  using K = typename Bits<F>::T;
  if (k < 1 || k > kMaxK || k > n || segs < 1 || segs > kMaxSegments ||
      rows * segs >= INT_MAX || (segs > 1 && (!cand_key || !cand_idx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F* xf = static_cast<const F*>(x);
  const int seg_len =
      static_cast<int>((static_cast<int64_t>(n) + segs - 1) / segs);
  const int t1 = scan_threads<F>(seg_len, k);
  const size_t smem1 = static_cast<size_t>(t1) * k * (sizeof(K) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      topk_scan_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_scan_kernel<F><<<static_cast<unsigned>(rows * segs), t1, smem1, s>>>(
      xf, n, k, segs, seg_len, static_cast<F*>(values),
      static_cast<int32_t*>(indices), static_cast<K*>(cand_key),
      static_cast<int*>(cand_idx));
  if (segs > 1) {
    int t2 = 32;
    while (t2 < kMaxThreads && t2 < segs) t2 <<= 1;
    const size_t smem2 =
        static_cast<size_t>(segs) * (sizeof(K) + 2 * sizeof(int));
    topk_merge_kernel<F><<<static_cast<unsigned>(rows), t2, smem2, s>>>(
        xf, n, k, segs, seg_len, static_cast<const K*>(cand_key),
        static_cast<const int*>(cand_idx), static_cast<F*>(values),
        static_cast<int32_t*>(indices));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fml_topk_f32(const void* x, int64_t rows, int n, int k,
                            int segs, void* values, void* indices,
                            void* cand_key, void* cand_idx, void* stream) {
  return launch<float>(x, rows, n, k, segs, values, indices, cand_key,
                       cand_idx, stream);
}

extern "C" int fml_topk_f64(const void* x, int64_t rows, int n, int k,
                            int segs, void* values, void* indices,
                            void* cand_key, void* cand_idx, void* stream) {
  return launch<double>(x, rows, n, k, segs, values, indices, cand_key,
                        cand_idx, stream);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
