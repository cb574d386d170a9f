// Measurement probe, not a kernel of the port: the time the card takes for
// `n` random reductions (atomicAdd with the result unused, compiled to
// RED) into an output of `dim` entries alone, with no cell stream.
// chip_smoke.py times it beside the unsorted segment_sum at the same count
// and output size (f32 and f64), as the floor that random reductions set
// under it: each resolves in L2 on one sector, whatever the kernel around
// it does.
//
// Thread t adds 1 at kPer hashed positions, issued back to back.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPer = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
red_floor_kernel(T* __restrict__ out, uint32_t dim, int64_t threads) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= threads) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    atomicAdd(out + mix(static_cast<uint32_t>(t * kPer + j)) % dim, T(1));
  }
}

template <typename T>
int launch(void* out, int dim, int64_t n, void* stream) {
  const int64_t threads = n / kPer;
  if (dim < 1 || threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  red_floor_kernel<T><<<static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), static_cast<uint32_t>(dim), threads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out holds dim entries; n reductions (rounded down to a multiple of 8).
extern "C" int fml_red_floor_f32(void* out, int dim, int64_t n, void* stream) {
  return launch<float>(out, dim, n, stream);
}

extern "C" int fml_red_floor_f64(void* out, int dim, int64_t n, void* stream) {
  return launch<double>(out, dim, n, stream);
}
