// Padded-ELL sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces flinkml_tpu/kernels/spmv.py:74 pallas_spmv (body _spmv_body, :67):
//   out[r] = sum_s values[r, s] * w[indices[r, s]]
// over one [rows, width] ELL bucket; padding cells (index 0, value 0) add 0.
//
// What bounds it on the H100: bytes. Each cell is read once (4 B index +
// 4 B value at f32) and multiplied once, and the gather touches w at random:
// at the sparse-fit shape (262,144 rows x 39 slots, dim 1e6, f32) that is
// 82 MB of cells, ~4 MB of touched w and 1 MB of output, 26 us at 3.35
// TB/s, against 20 MFLOP. Beside the HBM bytes, each of the 10.2 M gathers
// moves a 32-byte L2 sector (~330 MB of L2 traffic), since w (4 MB) stays
// in the 50 MB L2 but not in an SM's L1.
//
// Design: the bucket is one flat stream of rows x width cells, whatever the
// width (the host's packing picks widths of 1, 7, 39, 1,000, ...). A block
// owns a tile of whole rows, at most kTileCells cells:
//
// 1. Stream. Each thread loads kGroups groups of 4 consecutive cells with
//    16-byte loads (an int4 of indices; a float4, or two double2, of
//    values) through the streaming path (__ldcs: read once, so they do not
//    displace w in L2). The wrapper finds the cell phase at which both
//    arrays are 16-byte aligned (a bucket view may start anywhere); the
//    tile's head and tail cells off that phase, or every cell when no
//    phase aligns both, load one at a time.
// 2. Gather. A thread issues all its 4 * kGroups gathers of w (__ldg)
//    before its first multiply, so they are in flight together, then
//    writes its products to the tile in shared memory.
// 3. Reduce. Each row is summed by a group of G lanes (G a power of two,
//    about width / 8, at most a warp): lane l adds cells l, l + G, ... in
//    order, then a fixed xor-shuffle tree. The order depends only on the
//    width, so two launches give the same bits.
//
// Rows wider than a tile take one block each: the block streams the row
// tile by tile, each thread adds its own products in order, and a fixed
// tree over the block's threads sums them.
//
// bfloat16 values and w (fml_spmv_bf16): each cell's value and w entry
// widen to float32, the products and the row sums run in float32, and the
// row's sum rounds once to bf16 as it is stored. A 4-cell group of values
// is one 8-byte load.
//
// The kernel trusts 0 <= indices < dim: the host checks that when it packs
// the buckets (ops/sparse.py), because a CUDA gather, unlike the JAX one,
// does not clamp. No synchronisation and no allocation: the wrapper
// allocates `out` and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;  // 4-cell groups per thread per tile
constexpr int kTileCells = kThreads * 4 * kGroups;

// The arithmetic type of a storage type: bf16 computes in float32.
template <typename S> struct Acc { using T = S; };
template <> struct Acc<__nv_bfloat16> { using T = float; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename S>
__device__ __forceinline__ S from_acc(typename Acc<S>::T v) {
  if constexpr (sizeof(S) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}
// w[i] and values[c] at the arithmetic type.
template <typename S>
__device__ __forceinline__ typename Acc<S>::T ld(const S* p, int64_t i) {
  return to_acc(__ldg(p + i));
}

__device__ __forceinline__ void load4(const __nv_bfloat16* v, int64_t c,
                                      float* o) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(v + c));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  o[0] = __low2float(a);
  o[1] = __high2float(a);
  o[2] = __low2float(b);
  o[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* v, int64_t c, float* o) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(v + c));
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}
__device__ __forceinline__ void load4(const double* v, int64_t c, double* o) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(v + c));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(v + c + 2));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

// Cells [c0, c0 + cells) split into a scalar head, `nvec` 4-cell groups
// that start on the aligned phase, and a scalar tail. phase < 0: no group.
__device__ __forceinline__ void split_cells(int64_t c0, int cells, int phase,
                                            int& head, int& nvec) {
  if (phase < 0) {
    head = cells;
    nvec = 0;
    return;
  }
  head = static_cast<int>(((phase - c0) % 4 + 4) % 4);
  if (head > cells) head = cells;
  nvec = (cells - head) / 4;
}

// Products of the 4-cell groups q0, q0 + stride, ... (kGroups of them, those
// below nvec) of cells starting at `first`, handed to `put(cell, product)`
// with the cell relative to `first`; every load is issued before the
// gathers, and every gather before the first multiply.
template <typename S, typename Put>
__device__ __forceinline__ void vector_products(
    const int32_t* __restrict__ indices, const S* __restrict__ values,
    const S* __restrict__ w, int64_t first, int q0, int stride, int nvec,
    Put put) {
  using T = typename Acc<S>::T;
  int4 iv[kGroups];
  T vv[kGroups][4];
  T wv[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int q = q0 + g * stride;
    if (q < nvec) {
      iv[g] = __ldcs(reinterpret_cast<const int4*>(indices + first) + q);
      load4(values, first + 4 * static_cast<int64_t>(q), vv[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (q0 + g * stride < nvec) {
      wv[g][0] = ld(w, iv[g].x);
      wv[g][1] = ld(w, iv[g].y);
      wv[g][2] = ld(w, iv[g].z);
      wv[g][3] = ld(w, iv[g].w);
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int q = q0 + g * stride;
    if (q < nvec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) put(4 * q + j, vv[g][j] * wv[g][j]);
    }
  }
}

// Rows of at most kTileCells cells: block b owns rows
// [b * rows_per_tile, ...), summed by groups of `group` lanes.
template <typename S>
__global__ void __launch_bounds__(kThreads)
spmv_tile_kernel(const int32_t* __restrict__ indices,
                 const S* __restrict__ values, const S* __restrict__ w,
                 int64_t rows, int width, int rows_per_tile, int group,
                 int phase, S* __restrict__ out) {
  using T = typename Acc<S>::T;
  __shared__ T prod[kTileCells];
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_tile;
  const int nr = static_cast<int>(
      rows - r0 < rows_per_tile ? rows - r0 : rows_per_tile);
  const int64_t c0 = r0 * width;
  const int cells = nr * width;
  int head, nvec;
  split_cells(c0, cells, phase, head, nvec);
  const int tail = head + 4 * nvec;

  vector_products(indices, values, w, c0 + head, tid, kThreads, nvec,
                  [&](int c, T p) { prod[head + c] = p; });
  for (int c = tid; c < head; c += kThreads) {
    prod[c] = to_acc(values[c0 + c]) * ld(w, indices[c0 + c]);
  }
  for (int c = tail + tid; c < cells; c += kThreads) {
    prod[c] = to_acc(values[c0 + c]) * ld(w, indices[c0 + c]);
  }
  __syncthreads();

  const int lane_g = tid & (group - 1);
  const int lane = tid & 31;
  const unsigned mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (lane & ~(group - 1));
  for (int r = tid / group; r < nr; r += kThreads / group) {
    T acc = T(0);
    for (int s = lane_g; s < width; s += group) acc += prod[r * width + s];
    for (int off = group >> 1; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(mask, acc, off);
    }
    if (lane_g == 0) out[r0 + r] = from_acc<S>(acc);
  }
}

// Rows wider than a tile: one block per row.
template <typename S>
__global__ void __launch_bounds__(kThreads)
spmv_wide_kernel(const int32_t* __restrict__ indices,
                 const S* __restrict__ values, const S* __restrict__ w,
                 int width, int phase, S* __restrict__ out) {
  using T = typename Acc<S>::T;
  __shared__ T part[kThreads / 32];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t c0 = row * width;
  int head, nvec;
  split_cells(c0, width, phase, head, nvec);
  const int tail = head + 4 * nvec;
  T acc = T(0);
  for (int q0 = tid; q0 < nvec; q0 += kThreads * kGroups) {
    vector_products(indices, values, w, c0 + head, q0, kThreads, nvec,
                    [&](int, T p) { acc += p; });
  }
  for (int c = tid; c < head; c += kThreads) {
    acc += to_acc(values[c0 + c]) * ld(w, indices[c0 + c]);
  }
  for (int c = tail + tid; c < width; c += kThreads) {
    acc += to_acc(values[c0 + c]) * ld(w, indices[c0 + c]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if ((tid & 31) == 0) part[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    T sum = T(0);
    for (int i = 0; i < kThreads / 32; ++i) sum += part[i];
    out[row] = from_acc<S>(sum);
  }
}

template <typename T>
int launch(const void* indices, const void* values, const void* w,
           int64_t rows, int width, int phase, void* out, void* stream) {
  if (rows < 0 || width < 0 || phase < -1 || phase > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  const T* val = static_cast<const T*>(values);
  const T* wv = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (width > kTileCells) {
    if (rows >= (int64_t(1) << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    spmv_wide_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
        idx, val, wv, width, phase, o);
  } else {
    const int rows_per_tile = width == 0 ? kTileCells : kTileCells / width;
    int group = 1;
    while (group < 32 && group * 8 < width) group <<= 1;
    const int64_t tiles = (rows + rows_per_tile - 1) / rows_per_tile;
    spmv_tile_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        idx, val, wv, rows, width, rows_per_tile, group, phase, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fml_spmv_f32(const void* indices, const void* values,
                            const void* w, int64_t rows, int width, int phase,
                            void* out, void* stream) {
  return launch<float>(indices, values, w, rows, width, phase, out, stream);
}

extern "C" int fml_spmv_f64(const void* indices, const void* values,
                            const void* w, int64_t rows, int width, int phase,
                            void* out, void* stream) {
  return launch<double>(indices, values, w, rows, width, phase, out, stream);
}

extern "C" int fml_spmv_bf16(const void* indices, const void* values,
                             const void* w, int64_t rows, int width,
                             int phase, void* out, void* stream) {
  return launch<__nv_bfloat16>(indices, values, w, rows, width, phase, out,
                               stream);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
