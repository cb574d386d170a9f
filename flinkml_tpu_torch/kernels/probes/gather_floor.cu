// Measurement probe, not a kernel of the port: the time the card takes for
// `n` random 4-byte gathers of w (dim entries) alone, with no cell stream.
// chip_smoke.py times it beside spmv at the same gather count and dim, as
// the floor that random gathers set under spmv: each gather moves one
// 32-byte L2 sector, whatever the kernel around it does.
//
// Thread t gathers w at kPer hashed positions, issues them together, and
// writes their sum (so the loads are not dropped).

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

__global__ void __launch_bounds__(kThreads)
gather_floor_kernel(const float* __restrict__ w, uint32_t dim,
                    float* __restrict__ out, int64_t threads) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= threads) return;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = __ldg(w + mix(static_cast<uint32_t>(t * kPer + j)) % dim);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) s += v[j];
  out[t] = s;
}

}  // namespace

// out holds n / 8 floats.
extern "C" int fml_gather_floor(const void* w, int dim, void* out, int64_t n,
                                void* stream) {
  const int64_t threads = n / kPer;
  if (dim < 1 || threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  gather_floor_kernel<<<static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<uint32_t>(dim),
      static_cast<float*>(out), threads);
  return static_cast<int>(cudaGetLastError());
}
