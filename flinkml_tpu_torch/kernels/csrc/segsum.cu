// Segment sum (scatter-accumulate) for Hopper (sm_90a).
//
// Replaces flinkml_tpu/kernels/segsum.py:222 pallas_segment_sum (bodies
// _unsorted_body :89, _sorted_body :107, _unsorted_grid_body :136,
// _sorted_grid_body :166):
//   out[ids[j], c] += values[j, c]
// into [num_segments, k] (k = 1 for the flat form). ids are trusted to lie
// in [0, num_segments): the host packers check them before upload.
//
// What bounds it on the H100. Bytes: each cell is read once (4 B id + 4 B
// value at f32) and each output element written once; at the sparse-fit
// step shape (262,144 rows x 39 cells, 1e6 segments, f32) that is ~86 MB,
// about 26 us at 3.35 TB/s. The unsorted path's adds land at random ids of
// a 4 MB output that stays in the 50 MB L2, so its true floor is the card's
// rate of random L2 reductions (kernels/probes/red_floor.cu measures it),
// not HBM bytes.
//
// The TPU kernel walks the cells in order on one core, carrying the sum in
// VMEM; a GPU runs its blocks in parallel and in no order. Two paths:
//
// - unsorted: fire-and-forget reductions (atomicAdd with its result unused
//   compiles to RED). Flat: a grid-stride loop, one cell per thread per
//   step, neighbouring threads on neighbouring cells. It already runs at
//   1.1x the card's random-reduction floor (probes/red_floor.cu): 4, 8 or
//   16 cells a thread from 16-byte loads with their REDs back to back
//   timed no faster, so the loop stays. [cells, k]: a 2-D block maps
//   threads to (cell, group of V payload columns) with no division;
//   V = 4 or 2 uses Hopper's vector reduction (red.global.add.v4/v2.f32)
//   for float32. The output must be zeroed first (the wrapper does). The
//   adds land in an order that changes from run to run, so the result
//   equals the in-order sum only within rounding (the wrapper refuses this
//   path when PyTorch's deterministic mode is on).
// - sorted (ids ascending): a run-flush with no atomics and no memset.
//   Every segment equals 0 + v0 + v1 + ... in cell order bit for bit, as
//   the JAX _sorted_body adds, and every output element is written exactly
//   once when the ids ascend:
//   * the segments before ids[0] and after ids[cells - 1] are zeroed by the
//     whole grid (every block reads those two ids);
//   * a run belongs to the thread that owns its first cell; that thread
//     sums the run left to right and stores it once, and zeroes the
//     segments between the previous cell's id and its own.
//   Flat: each block stages one tile of kTile cells (ids and values) into
//   shared memory with cp.async (16-byte copies from the aligned phase,
//   element copies otherwise); the 8 blocks resident on an SM overlap one
//   tile's copies with another's sums (measured faster than a persistent
//   block that double-buffers its tiles). Thread t owns the tile's cells
//   [8t, 8t + 8) and reads them as 16-byte vectors (a 32-byte stride, so a
//   2-way bank conflict per quarter-warp: an XOR-swizzled layout free of
//   conflicts measured no faster); a run that leaves its cells continues
//   through the next owners' cells, read the same way 8 at a time, and
//   past the tile from device memory. The gap zeroes of a
//   warp are written by all its lanes together, so long gaps store whole
//   lines. [cells, k]: threads map to (chunk of kChunk cells, payload
//   column), reading neighbouring columns of the same cells.
//   Ids that do not ascend (the caller broke its promise) would give a
//   segment two writers. The sorted kernels see every descent between two
//   neighbouring cells at a run start they already test (flat) or in a
//   scan of the chunk's ids (rows), skip the gap zeroes of that owner or
//   the whole chunk (a disorder can make a gap as long as the output), and
//   set a flag in a one-int work area. A one-block repair kernel launched
//   after them on the stream reads the flag: when it is set, the sum into
//   zeros again (zeroes, then one atomic add per cell: right, not fast, in
//   a run-dependent order), and the flag cleared; otherwise nothing. The
//   kernel boundary orders the repair after every store of the run-flush,
//   with no fence in its blocks and no host sync. Ascending ids give the
//   run-flush's bits unchanged. The JAX _sorted_body adds every flush into
//   zeros, so it too returns the sum on any ids.
//
// bfloat16 values (fml_segsum_bf16) take the same paths at T = bf16, whose
// every add rounds to bf16 (Hopper's bf16 add, or a float32 add rounded,
// which for two bf16 operands gives the same bits): the sorted run-flush
// adds each run left to right from 0, rounding at each add, bit for bit as
// the Pallas kernel's bf16 adds; the unsorted path reduces with
// red.global.add.noftz.bf16x2 (an element as its 4-byte word, the
// neighbour adding -0.0; two payload columns as one pair) and the repair
// with bf16 atomics, in a run-dependent order. The sorted flat tile
// stages 8 bf16 values a 16-byte copy, so its tiles start on the 8-cell
// phase.
//
// No synchronisation and no allocation: the wrapper allocates `out` and
// launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Blocks of the grid-stride unsorted flat loop: 32 per SM of the H100's 132.
constexpr int kMaxBlocks = 132 * 32;
// Unsorted [cells, k]: cells per thread.
constexpr int kRowCells = 4;
// Sorted flat: cells per thread and per tile.
constexpr int kOwn = 8;
constexpr int kTile = kThreads * kOwn;
// Sorted [cells, k]: cells per chunk.
constexpr int kChunk = 16;
// The repair kernel's threads (one block).
constexpr int kRepairThreads = 1024;
// Sorted flat: the cells of one 16-byte copy of ids and values together
// (the tiles start on this phase): 4, or 8 for bf16 values.
template <typename T>
constexpr int kPhaseCells = sizeof(T) == 2 ? 8 : 4;

// ---------------------------------------------------------------- loads ----

// V consecutive payload values at p (p aligned to V elements).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = q.x;
    o[1] = q.y;
    o[2] = q.z;
    o[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
    o[0] = q.x;
    o[1] = q.y;
  } else {
    o[0] = __ldcs(p);
  }
}
template <int V>
__device__ __forceinline__ void load_v(const double* p, double* o) {
  if constexpr (V == 2) {
    const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
    o[0] = q.x;
    o[1] = q.y;
  } else {
    o[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       __nv_bfloat16* o) {
  if constexpr (V == 2) {
    const __nv_bfloat162 q = __ldcs(reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = q.x;
    o[1] = q.y;
  } else {
    o[0] = __ldcs(p);
  }
}

// ---------------------------------------------------------- reductions ----

// out[0..V) += v[0..V); the result is unused, so each is a RED.
template <int V>
__device__ __forceinline__ void red_v(float* p, const float* v) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}
template <int V>
__device__ __forceinline__ void red_v(double* p, const double* v) {
  // PTX has no vector form of red.add for f64.
#pragma unroll
  for (int j = 0; j < V; ++j) atomicAdd(p + j, v[j]);
}

// *p += v with its result unused. For float and double atomicAdd compiles
// to RED. A bf16 element is reduced as its aligned 4-byte word, the
// neighbour adding -0.0 (x + -0 == x for every number x, signed zeros
// included; a NaN stays NaN): one 32-bit bf16x2 RED in place of a 16-bit
// one (cuda_bf16.h's atomicAdd is an ATOM; `chip_smoke.py --variants`
// times the 16-bit RED beside this). The neighbour lies in the output's
// allocation (the wrapper allocates it; allocations are whole 512-byte
// blocks).
__device__ __forceinline__ void red_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void red_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void red_add(__nv_bfloat16* p, __nv_bfloat16 v) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const __nv_bfloat16 nz = __ushort_as_bfloat16(0x8000);  // -0.0
  const __nv_bfloat162 q = (at & 2) ? __halves2bfloat162(nz, v)
                                    : __halves2bfloat162(v, nz);
  asm volatile("red.global.add.noftz.bf16x2 [%0], %1;" ::"l"(at & ~uintptr_t(3)),
               "r"(*reinterpret_cast<const unsigned*>(&q))
               : "memory");
}

template <int V>
__device__ __forceinline__ void red_v(__nv_bfloat16* p,
                                      const __nv_bfloat16* v) {
  if constexpr (V == 2) {
    const __nv_bfloat162 q = __halves2bfloat162(v[0], v[1]);
    asm volatile("red.global.add.noftz.bf16x2 [%0], %1;" ::"l"(p),
                 "r"(*reinterpret_cast<const unsigned*>(&q))
                 : "memory");
  } else {
    red_add(p, v[0]);
  }
}

// -------------------------------------------------------------- unsorted ----

// Flat: a grid-stride loop, one RED per cell.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_unsorted_flat(const T* __restrict__ values,
                     const int32_t* __restrict__ ids, int cells,
                     T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < cells; j += stride) {
    red_add(out + __ldg(ids + j), __ldg(values + j));
  }
}

// [cells, k]: block (bx, by) takes cells [blockIdx.x * by * kRowCells, ...);
// thread (x, y) the cells y, y + by, ... of them and the column groups
// x, x + bx, ... of V columns each (k = V * groups).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
segsum_unsorted_rows(const T* __restrict__ values,
                     const int32_t* __restrict__ ids, int cells, int k,
                     T* __restrict__ out) {
  const int by = blockDim.y;
  const int groups = k / V;
  const int cell0 = blockIdx.x * by * kRowCells + threadIdx.y;
  int id[kRowCells];
#pragma unroll
  for (int p = 0; p < kRowCells; ++p) {
    const int c = cell0 + p * by;
    id[p] = c < cells ? __ldg(ids + c) : 0;
  }
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    T v[kRowCells][V];
#pragma unroll
    for (int p = 0; p < kRowCells; ++p) {
      const int c = cell0 + p * by;
      if (c < cells) load_v<V>(values + c * k + g * V, v[p]);
    }
#pragma unroll
    for (int p = 0; p < kRowCells; ++p) {
      if (cell0 + p * by < cells) red_v<V>(out + id[p] * k + g * V, v[p]);
    }
  }
}

// ---------------------------------------------------------------- sorted ----

// Zero the segments before ids[0] and after ids[cells - 1] (k elements
// each), grid-stride over all threads of the launch.
template <typename T>
__device__ __forceinline__ void zero_head_tail(const int32_t* __restrict__ ids,
                                               int cells, int k,
                                               int num_segments,
                                               T* __restrict__ out) {
  const int n_threads = gridDim.x * blockDim.x * blockDim.y;
  const int gtid = (blockIdx.x * blockDim.y + threadIdx.y) * blockDim.x +
                   threadIdx.x;
  const int head = __ldg(ids) * k;
  for (int e = gtid; e < head; e += n_threads) out[e] = T(0.0f);
  const int tail = (__ldg(ids + cells - 1) + 1) * k;
  for (int e = tail + gtid; e < num_segments * k; e += n_threads) out[e] = T(0.0f);
}

// After a sorted kernel: when it flagged a descent, the sum into zeros
// again, then the flag cleared (see the head of this file).
template <typename T>
__global__ void __launch_bounds__(kRepairThreads)
segsum_sorted_repair(const T* __restrict__ values,
                     const int32_t* __restrict__ ids, int cells, int k,
                     int num_segments, T* __restrict__ out,
                     unsigned* __restrict__ work) {
  const bool repair = __ldcg(work) != 0u;
  __syncthreads();   // every thread has read the flag before it is cleared
  if (!repair) return;
  for (int e = threadIdx.x; e < num_segments * k; e += blockDim.x) out[e] = T(0.0f);
  __threadfence();
  __syncthreads();
  for (int e = threadIdx.x; e < cells * k; e += blockDim.x) {
    const int cell = k == 1 ? e : e / k;
    atomicAdd(out + __ldg(ids + cell) * k + (e - cell * k), __ldg(values + e));
  }
  if (threadIdx.x == 0) *work = 0u;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy the tile's cells [tb, tb + kTile) ∩ [0, cells) of `src` to `dst`
// (cell tb + s at dst[s]): whole 16-byte chunks in one copy when `aligned`
// (tb is on the 16-byte phase), element by element otherwise and at the
// edges.
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src,
                                      long long tb, int cells, bool aligned) {
  constexpr int per = 16 / sizeof(E);
  for (int q = threadIdx.x; q < kTile / per; q += kThreads) {
    const long long c = tb + q * per;
    if (aligned && c >= 0 && c + per <= cells) {
      cp_async(dst + (q * per), src + c, 16);
      continue;
    }
#pragma unroll
    for (int j = 0; j < per; ++j) {
      if (c + j >= 0 && c + j < cells) {
        if constexpr (sizeof(E) >= 4) {
          cp_async(dst + (q * per + j), src + c + j, sizeof(E));
        } else {
          // cp.async copies 4, 8 or 16 bytes: a 2-byte edge element is a
          // plain store (visible after the block's barrier).
          dst[q * per + j] = src[c + j];
        }
      }
    }
  }
}

// The owner's 8 cells from the tile: two int4 of ids, and two float4 or
// four double2 of values.
__device__ __forceinline__ void read_own(const int32_t* sid, int s0, int* id) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int4 q = *reinterpret_cast<const int4*>(sid + (s0 + 4 * h));
    id[4 * h] = q.x;
    id[4 * h + 1] = q.y;
    id[4 * h + 2] = q.z;
    id[4 * h + 3] = q.w;
  }
}
__device__ __forceinline__ void read_own(const float* sv, int s0, float* v) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 q = *reinterpret_cast<const float4*>(sv + (s0 + 4 * h));
    v[4 * h] = q.x;
    v[4 * h + 1] = q.y;
    v[4 * h + 2] = q.z;
    v[4 * h + 3] = q.w;
  }
}
__device__ __forceinline__ void read_own(const __nv_bfloat16* sv, int s0,
                                         __nv_bfloat16* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(sv + s0);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[h]);
    v[2 * h] = p.x;
    v[2 * h + 1] = p.y;
  }
}
__device__ __forceinline__ void read_own(const double* sv, int s0, double* v) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 q = *reinterpret_cast<const double2*>(sv + (s0 + 2 * h));
    v[2 * h] = q.x;
    v[2 * h + 1] = q.y;
  }
}

// Each lane's gaps [lo[i], hi[i]) zeroed by the whole warp, lane after
// lane, 32 consecutive segments per store instruction. All lanes call it;
// with no gap in the warp it costs one vote.
template <typename T>
__device__ __forceinline__ void zero_gaps(const int* lo, const int* hi,
                                          T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  bool any = false;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) any |= hi[i] > lo[i];
  unsigned pending = __ballot_sync(0xffffffffu, any);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int a = __shfl_sync(0xffffffffu, lo[i], src);
      const int b = __shfl_sync(0xffffffffu, hi[i], src);
      for (int s = a + lane; s < b; s += 32) out[s] = T(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_sorted_flat(const T* __restrict__ values,
                   const int32_t* __restrict__ ids, int cells,
                   int num_segments, int phase, T* __restrict__ out,
                   unsigned* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* tid_s = reinterpret_cast<int32_t*>(smem_raw);        // [kTile]
  T* tval_s = reinterpret_cast<T*>(smem_raw + kTile * sizeof(int32_t));

  zero_head_tail(ids, cells, 1, num_segments, out);

  // Tiles start on the aligned phase; the first one may start up to 3
  // (bf16: 7) cells before cell 0 (those slots are never loaded or read).
  const bool aligned = phase >= 0;
  const long long base0 = phase > 0 ? phase - kPhaseCells<T> : 0;
  const long long tb = base0 + static_cast<long long>(blockIdx.x) * kTile;
  stage(tid_s, ids, tb, cells, aligned);
  stage(tval_s, values, tb, cells, aligned);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int t = threadIdx.x;
  const long long c0 = tb + kOwn * t;
  int id[kOwn];
  T v[kOwn];
  read_own(tid_s, kOwn * t, id);
  read_own(tval_s, kOwn * t, v);
  // The id of the cell before this thread's first (-1 before cell 0).
  int cur = -1;
  if (c0 >= 1 && c0 - 1 < cells) {
    cur = t > 0 ? tid_s[(kOwn * t - 1)] : __ldg(ids + c0 - 1);
  }
  bool owned = false, descent = false;
  T acc = T(0.0f);
  int lo[kOwn], hi[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const long long c = c0 + i;
    lo[i] = hi[i] = 0;
    if (c >= 0 && c < cells) {
      if (id[i] != cur) {     // a run starts at c: this thread owns it
        descent |= id[i] < cur;
        if (owned) out[cur] = acc;
        if (c > 0) {
          lo[i] = cur + 1;
          hi[i] = id[i];
        }
        cur = id[i];
        owned = true;
        acc = T(0.0f);
      }
      if (owned) acc += v[i];
    }
  }
  if (descent) {   // the repair rewrites the output: no gap zeroes
    atomicOr(work, 1u);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) lo[i] = hi[i] = 0;
  }
  zero_gaps(lo, hi, out);
  if (owned) {
    // The run may go on past this thread's cells: the next owners' cells
    // 8 at a time from shared memory to the tile's end, then device
    // memory cell by cell.
    long long j = c0 + kOwn;
    const long long tile_end = tb + kTile;
    bool going = true;
    while (going && j < cells) {
      if (j < tile_end) {
        read_own(tid_s, static_cast<int>(j - tb), id);
        read_own(tval_s, static_cast<int>(j - tb), v);
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          going = going && j + i < cells && id[i] == cur;
          if (going) acc += v[i];
        }
        j += kOwn;
      } else {
        going = __ldg(ids + j) == cur;
        if (going) acc += __ldg(values + j);
        ++j;
      }
    }
    out[cur] = acc;
  }
}

// [cells, k]: block (bx, by); thread (x, y) owns chunk blockIdx.x * by + y
// (kChunk cells) for the columns x, x + bx, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_sorted_rows(const T* __restrict__ values,
                   const int32_t* __restrict__ ids, int cells, int k,
                   int num_segments, T* __restrict__ out,
                   unsigned* __restrict__ work) {
  zero_head_tail(ids, cells, k, num_segments, out);
  const int chunk = blockIdx.x * blockDim.y + threadIdx.y;
  const long long lo64 = static_cast<long long>(chunk) * kChunk;
  if (lo64 >= cells) return;
  const int lo = static_cast<int>(lo64);
  const int hi = lo + kChunk < cells ? lo + kChunk : cells;
  const int before = lo > 0 ? __ldg(ids + lo - 1) : -1;
  // A descent among the chunk's cells: the repair rewrites the output, so
  // the chunk writes nothing.
  for (int j = lo, prev = before; j < hi; ++j) {
    const int id = __ldg(ids + j);
    if (id < prev) {
      if (threadIdx.x == 0) atomicOr(work, 1u);
      return;
    }
    prev = id;
  }
  for (int col = threadIdx.x; col < k; col += blockDim.x) {
    int j = lo;
    int cur = before;
    // The run entering from the left belongs to the chunk it starts in.
    while (j < hi && __ldg(ids + j) == cur) ++j;
    while (j < hi) {
      const int id = __ldg(ids + j);
      if (j > 0) {
        for (int s = cur + 1; s < id; ++s) out[s * k + col] = T(0.0f);
      }
      T acc = T(0.0f);
      do {
        acc += __ldg(values + j * k + col);
        ++j;
      } while (j < cells && __ldg(ids + j) == id);
      out[id * k + col] = acc;
      cur = id;
    }
  }
}

// ---------------------------------------------------------------- launch ----

// Block shape (bx, by) for [cells, k]: bx threads across `width` column
// groups (a power of two, at most kThreads), by = kThreads / bx.
dim3 row_block(int width) {
  int bx = 1;
  while (bx < width && bx < kThreads) bx <<= 1;
  return dim3(bx, kThreads / bx);
}

template <typename T, int V>
void launch_unsorted_rows(const T* v, const int32_t* i, int cells, int k,
                          T* o, cudaStream_t s) {
  const dim3 block = row_block(k / V);
  const int per_block = block.y * kRowCells;
  const int blocks = (cells + per_block - 1) / per_block;
  segsum_unsorted_rows<T, V><<<blocks, block, 0, s>>>(v, i, cells, k, o);
}

template <typename T>
int launch(bool sorted, const void* values, const void* ids, int cells,
           int k, int num_segments, int phase, int vec, void* out,
           void* work_, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(values);
  const int32_t* i = static_cast<const int32_t*>(ids);
  T* o = static_cast<T*>(out);
  unsigned* work = static_cast<unsigned*>(work_);
  if (cells <= 0 || k <= 0 || num_segments <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (sorted && k == 1) {
    // One tile per block: the blocks resident on an SM overlap one tile's
    // copies with another's sums.
    const size_t smem = kTile * (sizeof(int32_t) + sizeof(T));
    const long long base0 = phase > 0 ? phase - kPhaseCells<T> : 0;
    const long long tiles = (cells - base0 + kTile - 1) / kTile;
    segsum_sorted_flat<T><<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
        v, i, cells, num_segments, phase, o, work);
  } else if (sorted) {
    const dim3 block = row_block(k);
    const long long chunks = (static_cast<long long>(cells) + kChunk - 1) / kChunk;
    const int blocks = static_cast<int>((chunks + block.y - 1) / block.y);
    segsum_sorted_rows<T><<<blocks, block, 0, s>>>(v, i, cells, k,
                                                     num_segments, o, work);
  }
  if (sorted) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    segsum_sorted_repair<T><<<1, kRepairThreads, 0, s>>>(
        v, i, cells, k, num_segments, o, work);
  } else if (k == 1) {
    long long blocks = (static_cast<long long>(cells) + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    segsum_unsorted_flat<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        v, i, cells, o);
  } else if (vec == 4) {
    if constexpr (sizeof(T) == 4) {
      launch_unsorted_rows<T, 4>(v, i, cells, k, o, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (vec == 2) {
    launch_unsorted_rows<T, 2>(v, i, cells, k, o, s);
  } else {
    launch_unsorted_rows<T, 1>(v, i, cells, k, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: payload columns per vector access on the unsorted [cells, k] path
// (4 or 2 when k and the values' alignment allow it, else 1); phase (the
// sorted flat path): the cell at which ids and values are both 16-byte
// aligned (-1: none); work (the sorted paths): one zeroed unsigned int that
// only one launch at a time uses, left zeroed by each launch.
extern "C" int fml_segsum_f32(int sorted, const void* values, const void* ids,
                              int cells, int k, int num_segments, int phase,
                              int vec, void* out, void* work, void* stream) {
  return launch<float>(sorted != 0, values, ids, cells, k, num_segments, phase,
                       vec, out, work, stream);
}

extern "C" int fml_segsum_f64(int sorted, const void* values, const void* ids,
                              int cells, int k, int num_segments, int phase,
                              int vec, void* out, void* work, void* stream) {
  return launch<double>(sorted != 0, values, ids, cells, k, num_segments,
                        phase, vec, out, work, stream);
}

extern "C" int fml_segsum_bf16(int sorted, const void* values,
                               const void* ids, int cells, int k,
                               int num_segments, int phase, int vec,
                               void* out, void* work, void* stream) {
  return launch<__nv_bfloat16>(sorted != 0, values, ids, cells, k,
                               num_segments, phase, vec, out, work, stream);
}

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
