// Segment sum (scatter-accumulate) for Hopper (sm_90a).
//
// Replaces flinkml_tpu/kernels/segsum.py:222 pallas_segment_sum (bodies
// _unsorted_body :89, _sorted_body :107, _unsorted_grid_body :136,
// _sorted_grid_body :166):
//   out[ids[j], c] += values[j, c]
// into a zeroed [num_segments, k] output (k = 1 for the flat form); the
// wrapper allocates the zeroed output. ids are trusted to lie in
// [0, num_segments): the host packers check them before upload.
//
// What bounds it on the H100: bytes. Each cell is read once (4 B id + 4 B
// value at f32) and added once: at the sparse-fit step shape (262,144 rows
// x 39 cells, 1e6 segments, f32) that is ~82 MB, about 25 us at 3.35 TB/s,
// against ~10 M additions. The [1e6] f32 output (4 MB) stays in the 50 MB
// L2, where the atomics resolve.
//
// The TPU kernel walks the cells in order on one core, carrying the sum in
// VMEM; a GPU runs its blocks in parallel and in no order. Two paths:
//
// - unsorted: one atomicAdd per cell and payload column, a grid-stride
//   loop over the cells. Neighbouring threads read neighbouring cells, so
//   the reads are coalesced; the adds resolve in L2. The atomics add in an
//   order that changes from run to run, so the result equals the in-order
//   sum only within rounding (the wrapper refuses this path when PyTorch's
//   deterministic mode is on).
// - sorted (ids ascending): a run-flush with no atomics. Each thread owns
//   a contiguous chunk of kChunk cells and one payload column. It skips the
//   cells at its chunk's start that continue the previous chunk's run, and
//   for every run whose first cell lies in its chunk it sums the run left
//   to right (reading past its chunk's end when the run does) and stores
//   the total once. Every segment is written by exactly one thread, in the
//   TPU kernel's order (0 + v0 + v1 + ...), so the result is the same on
//   every run and equals the in-order sum bit for bit.
//
// No synchronisation and no allocation: the wrapper allocates `out` and
// launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Cells per thread in the sorted run-flush.
constexpr int kChunk = 16;
// Blocks of the grid-stride unsorted loop: 32 per SM of the H100's 132.
constexpr int kMaxBlocks = 132 * 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_unsorted_kernel(const T* __restrict__ values,
                       const int32_t* __restrict__ ids,
                       int cells, int k, T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k == 1) {
    for (int64_t j = start; j < cells; j += stride) {
      atomicAdd(out + __ldg(ids + j), __ldg(values + j));
    }
    return;
  }
  const int64_t total = static_cast<int64_t>(cells) * k;
  for (int64_t e = start; e < total; e += stride) {
    const int64_t j = e / k;
    const int c = static_cast<int>(e - j * k);
    atomicAdd(out + static_cast<int64_t>(__ldg(ids + j)) * k + c,
              __ldg(values + e));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_sorted_kernel(const T* __restrict__ values,
                     const int32_t* __restrict__ ids,
                     int cells, int k, int64_t n_threads,
                     T* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  // (chunk, column), column fastest: neighbouring threads read
  // neighbouring payload columns of the same cells.
  const int64_t chunk = t / k;
  const int c = static_cast<int>(t - chunk * k);
  const int64_t lo = chunk * kChunk;
  const int64_t hi = lo + kChunk < cells ? lo + kChunk : cells;
  int64_t j = lo;
  if (j > 0) {
    // The run entering from the left belongs to the chunk it starts in.
    const int32_t prev = __ldg(ids + j - 1);
    while (j < hi && __ldg(ids + j) == prev) ++j;
  }
  while (j < hi) {
    const int32_t id = __ldg(ids + j);
    T acc = T(0);
    do {
      acc += __ldg(values + j * k + c);
      ++j;
    } while (j < cells && __ldg(ids + j) == id);
    out[static_cast<int64_t>(id) * k + c] = acc;
  }
}

template <typename T>
int launch(bool sorted, const void* values, const void* ids, int cells,
           int k, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(values);
  const int32_t* i = static_cast<const int32_t*>(ids);
  T* o = static_cast<T*>(out);
  if (cells > 0 && k > 0) {
    if (sorted) {
      const int64_t chunks = (static_cast<int64_t>(cells) + kChunk - 1) / kChunk;
      const int64_t n_threads = chunks * k;
      const int64_t blocks = (n_threads + kThreads - 1) / kThreads;
      segsum_sorted_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          v, i, cells, k, n_threads, o);
    } else {
      const int64_t total = static_cast<int64_t>(cells) * k;
      int64_t blocks = (total + kThreads - 1) / kThreads;
      if (blocks > kMaxBlocks) blocks = kMaxBlocks;
      segsum_unsorted_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          v, i, cells, k, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fml_segsum_f32(int sorted, const void* values, const void* ids,
                              int cells, int k, void* out, void* stream) {
  return launch<float>(sorted != 0, values, ids, cells, k, out, stream);
}

extern "C" int fml_segsum_f64(int sorted, const void* values, const void* ids,
                              int cells, int k, void* out, void* stream) {
  return launch<double>(sorted != 0, values, ids, cells, k, out, stream);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
