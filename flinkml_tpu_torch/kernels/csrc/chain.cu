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
// The division floor: four of the chain's ops are IEEE divisions (`/` is
// not turned into a reciprocal multiply: the per-stage path divides), each
// a short Newton sequence of ~8-10 instructions; at 100,000 x 32 that is
// ~13 M divisions, about 4 us at the f32 rate and 8 us at the f64 rate,
// under the byte bound in both.
//
// Two routes, picked by the wrapper (kernels/chain.py::route):
//
// - vector, when a row is a whole number of 16-byte chunks (d * itemsize a
//   multiple of 16, at most 32 chunks) and x is 16-byte aligned: a group of
//   G lanes (the chunk count rounded up to a power of two) covers one row,
//   each lane one 16-byte chunk (4 f32 or 2 f64 columns), so a warp takes
//   32 / G rows. A lane's columns are the same for every row, so the
//   per-stage constants of its columns are read once into registers (the
//   kernel is instantiated per stage count, so only the stages in use take
//   registers). Each lane takes one row a pass in a persistent grid sized
//   to the card, and issues the next pass's load before this pass's ops,
//   so loads stay in flight while the divisions run. The row's dot is
//   combined by a fixed xor tree inside the group (deterministic);
//   rawPrediction is one float2/double2 store per row and prediction one
//   store per row from the group leaders.
// - scalar, for every other width and for misaligned views: the per-stage
//   constants are copied once per block into shared memory; one warp owns
//   one row at a time (grid-stride over rows), its lanes stride the d
//   columns, and the row's dot is combined by a fixed shuffle tree.
//
// No intermediate column touches device memory. Built with -fmad=false so
// the MinMax `unit * scale + offset` rounds twice, as numpy and XLA round
// it, and every op rounds as in the per-stage path on both routes.
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
// Vector route: threads per block.
constexpr int kVecThreads = 128;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// One stage's op on one element: a = shift or data min, b = scale or span.
template <typename T>
__device__ __forceinline__ T apply_op(unsigned op, T v, T a, T b, T scale,
                                      T offset) {
  if (op & 1u) {
    v = b > T(0) ? (v - a) / b : T(0.5);
    return v * scale + offset;
  }
  if (op & 2u) v = v - a;
  if (op & 4u) v = v / b;
  return v;
}

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));
  }
};
template <> struct Vec16<double> {
  static constexpr int n = 2;
  static __device__ __forceinline__ void load(const double* p, double* o) {
    const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
    o[0] = q.x; o[1] = q.y;
  }
  static __device__ __forceinline__ void store(double* p, const double* v) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
  static __device__ __forceinline__ void store2(double* p, double a, double b) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(a, b));
  }
};

// Vector route, NRUN scaler stages. Lane l of a warp serves row
// (l / group) of each of the warp's row slots and columns
// [(l % group) * V, + V) of it; lanes past the row's chunks idle.
template <typename T, int NRUN>
__global__ void __launch_bounds__(kVecThreads)
fused_chain_vector_kernel(const T* __restrict__ x, const T* __restrict__ table,
                          unsigned ops, int d, int head, int group,
                          int64_t n_rows, T* __restrict__ out,
                          T* __restrict__ pred, T* __restrict__ raw) {
  using W = Vec16<T>;
  constexpr int V = W::n;
  const int lane = threadIdx.x & 31;
  const int q = lane & (group - 1);
  const int col = q * V;
  const bool active = col < d;
  const int rows_per_warp = 32 / group;
  const int stride = 2 * d + 2;

  T a[NRUN][V], b[NRUN][V], scale[NRUN], offset[NRUN], coef[V];
#pragma unroll
  for (int s = 0; s < NRUN; ++s) {
    const T* st = table + s * stride;
    scale[s] = st[2 * d];
    offset[s] = st[2 * d + 1];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[s][j] = active ? st[col + j] : T(0);
      b[s][j] = active ? st[d + col + j] : T(1);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    coef[j] = head && active ? table[NRUN * stride + col + j] : T(0);
  }

  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kVecThreads +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * kVecThreads) >> 5;
  const int64_t step = n_warps * rows_per_warp;
  const int lane_row = lane / group;
  // r0: the warp's first row this pass (the same on every lane, so the
  // whole warp reaches the shuffles). The load of the next pass is issued
  // before this pass's ops, so it is in flight while they run.
  int64_t r0 = warp * rows_per_warp;
  T next[V];
  if (active && r0 + lane_row < n_rows) {
    W::load(x + (r0 + lane_row) * d + col, next);
  }
  for (; r0 < n_rows; r0 += step) {
    const int64_t row = r0 + lane_row;
    T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = next[j];
    if (active && row + step < n_rows) W::load(x + (row + step) * d + col, next);
    const bool ok = active && row < n_rows;
    T acc = T(0);
    if (ok) {
#pragma unroll
      for (int s = 0; s < NRUN; ++s) {
        const unsigned op = (ops >> (3 * s)) & 7u;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          v[j] = apply_op(op, v[j], a[s][j], b[s][j], scale[s], offset[s]);
        }
      }
      if (out != nullptr) W::store(out + row * d + col, v);
      if (head) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc += v[j] * coef[j];
      }
    }
    if (head) {
      for (int off = group >> 1; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (q == 0 && row < n_rows) {
        const T p = T(1) / (T(1) + exp_t(-acc));
        pred[row] = acc >= T(0) ? T(1) : T(0);
        W::store2(raw + 2 * row, T(1) - p, p);
      }
    }
  }
}

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
        const T* st = smem + s * stride;
        v = apply_op((ops >> (3 * s)) & 7u, v, st[j], st[d + j], st[2 * d],
                     st[2 * d + 1]);
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

template <typename T, int NRUN>
int launch_vector(const T* x, const T* table, unsigned ops, int d, int head,
                  int group, int64_t n_rows, T* out, T* pred, T* raw,
                  cudaStream_t stream) {
  static int occupancy = 0;
  if (occupancy == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy, fused_chain_vector_kernel<T, NRUN>, kVecThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occupancy < 1) occupancy = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t rows_per_block =
      static_cast<int64_t>(kVecThreads / 32) * (32 / group);
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 132) * occupancy;
  if (blocks > resident) blocks = resident;
  fused_chain_vector_kernel<T, NRUN><<<static_cast<unsigned>(blocks),
                                       kVecThreads, 0, stream>>>(
      x, table, ops, d, head, group, n_rows, out, pred, raw);
  return static_cast<int>(cudaGetLastError());
}

// group > 0: the vector route with lane groups of `group` lanes; 0: the
// scalar route.
template <typename T>
int launch(const void* x_, const void* table_, int n_run, unsigned ops, int d,
           int head, int group, int64_t n_rows, void* out_, void* pred_,
           void* raw_, void* stream_) {
  const T* x = static_cast<const T*>(x_);
  const T* table = static_cast<const T*>(table_);
  T* out = static_cast<T*>(out_);
  T* pred = static_cast<T*>(pred_);
  T* raw = static_cast<T*>(raw_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (group > 0) {
    switch (n_run) {
#define FML_CHAIN_RUN(N)                                                    \
  case N:                                                                   \
    return launch_vector<T, N>(x, table, ops, d, head, group, n_rows, out, \
                               pred, raw, stream);
      FML_CHAIN_RUN(1) FML_CHAIN_RUN(2) FML_CHAIN_RUN(3) FML_CHAIN_RUN(4)
      FML_CHAIN_RUN(5) FML_CHAIN_RUN(6) FML_CHAIN_RUN(7) FML_CHAIN_RUN(8)
#undef FML_CHAIN_RUN
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
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
                          stream>>>(x, table, n_run, ops, d, head, n_rows, out,
                                    pred, raw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fml_fused_chain_f32(const void* x, const void* table, int n_run,
                                   unsigned ops, int d, int head, int group,
                                   int64_t n_rows, void* out, void* pred,
                                   void* raw, void* stream) {
  return launch<float>(x, table, n_run, ops, d, head, group, n_rows, out, pred,
                       raw, stream);
}

extern "C" int fml_fused_chain_f64(const void* x, const void* table, int n_run,
                                   unsigned ops, int d, int head, int group,
                                   int64_t n_rows, void* out, void* pred,
                                   void* raw, void* stream) {
  return launch<double>(x, table, n_run, ops, d, head, group, n_rows, out,
                        pred, raw, stream);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
