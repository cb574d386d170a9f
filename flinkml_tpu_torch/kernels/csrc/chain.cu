// Fused scaler -> logistic-regression transform chain for Hopper (sm_90a).
//
// Replaces flinkml_tpu/kernels/chain.py:173 pallas_chain_fn for the chains
// the port can build: up to 8 scaler stages (StandardScaler, MinMaxScaler,
// MaxAbsScaler, RobustScaler models), optionally ending in the binomial
// LogisticRegressionModel head. For every row of x [rows, d] it applies
// each stage's elementwise op sequence in order (the stages are NOT
// pre-composed: each op rounds as in the per-stage path), writes the last
// scaler's output, and with the head computes
//   dot = sum_j v[j] * coef[j],  p = 1 / (1 + exp(-dot)),
//   prediction = dot >= 0,  rawPrediction = [1 - p, p].
//
// What bounds it on the H100: bytes. x is read once and the scaler output
// written once (25.6 MB each at 100,000 x 32 float64), plus 0.8 MB of
// predictions and 1.6 MB of raw predictions: ~53.6 MB, about 16 us at
// 3.35 TB/s, against ~10 operations per element.
//
// Design: the per-stage constants (cast to the compute type and zero-guarded
// on the host) are copied once per block into shared memory. One warp owns
// one row at a time (grid-stride over rows); its lanes stride the d
// columns, so x and the output move as contiguous 128-byte segments, and
// the row's dot is combined by a fixed shuffle tree (deterministic). No
// intermediate column touches device memory. Built with -fmad=false so the
// MinMax `unit * scale + offset` rounds twice, as numpy and XLA round it.
//
// Stage encoding: 3 bits per stage in `ops` (stage s at bits 3s..3s+2):
//   bit 0  kind: 0 = shift/scale, 1 = min-max
//   bit 1  shift/scale: subtract a[j]
//   bit 2  shift/scale: divide by b[j]
// min-max: v = b[j] > 0 ? (v - a[j]) / b[j] : 0.5; v = v * scale + offset.
// Table layout (type T): stage s at s * (2d + 2): a[d], b[d], scale,
// offset; with the head, coef[d] after the last stage.
//
// No synchronisation and no allocation: the wrapper allocates the outputs
// and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_chain_kernel(const T* __restrict__ x, const T* __restrict__ table,
                   int n_run, unsigned ops, int d, int head, int64_t n_rows,
                   T* __restrict__ out, T* __restrict__ pred,
                   T* __restrict__ raw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stride = 2 * d + 2;
  const int n_table = n_run * stride + (head ? d : 0);
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) smem[i] = table[i];
  __syncthreads();
  const T* coef = smem + n_run * stride;

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps +
                     (threadIdx.x >> 5);
       row < n_rows; row += static_cast<int64_t>(gridDim.x) * warps) {
    const T* xr = x + row * d;
    T acc = T(0);
    for (int j = lane; j < d; j += 32) {
      T v = xr[j];
      for (int s = 0; s < n_run; ++s) {
        const unsigned op = (ops >> (3 * s)) & 7u;
        const T* st = smem + s * stride;
        if (op & 1u) {
          const T span = st[d + j];
          v = span > T(0) ? (v - st[j]) / span : T(0.5);
          v = v * st[2 * d] + st[2 * d + 1];
        } else {
          if (op & 2u) v = v - st[j];
          if (op & 4u) v = v / st[d + j];
        }
      }
      if (out != nullptr) out[row * d + j] = v;
      if (head) acc += v * coef[j];
    }
    if (head) {
      for (int offset = 16; offset > 0; offset >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, offset);
      }
      if (lane == 0) {
        const T p = T(1) / (T(1) + exp_t(-acc));
        pred[row] = acc >= T(0) ? T(1) : T(0);
        raw[2 * row] = T(1) - p;
        raw[2 * row + 1] = p;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* table, int n_run, unsigned ops, int d,
           int head, int64_t n_rows, void* out, void* pred, void* raw,
           void* stream) {
  if (n_rows > 0) {
    const size_t smem =
        sizeof(T) * (static_cast<size_t>(n_run) * (2 * d + 2) + (head ? d : 0));
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fused_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int warps = kThreads / 32;
    int64_t blocks = (n_rows + warps - 1) / warps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    fused_chain_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(table), n_run, ops, d,
        head, n_rows, static_cast<T*>(out), static_cast<T*>(pred),
        static_cast<T*>(raw));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fml_fused_chain_f32(const void* x, const void* table, int n_run,
                                   unsigned ops, int d, int head,
                                   int64_t n_rows, void* out, void* pred,
                                   void* raw, void* stream) {
  return launch<float>(x, table, n_run, ops, d, head, n_rows, out, pred, raw,
                       stream);
}

extern "C" int fml_fused_chain_f64(const void* x, const void* table, int n_run,
                                   unsigned ops, int d, int head,
                                   int64_t n_rows, void* out, void* pred,
                                   void* raw, void* stream) {
  return launch<double>(x, table, n_run, ops, d, head, n_rows, out, pred, raw,
                        stream);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
