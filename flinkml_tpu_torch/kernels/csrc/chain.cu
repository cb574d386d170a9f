// Fused row-local transform chain for Hopper (sm_90a).
//
// Replaces flinkml_tpu/kernels/chain.py:173 pallas_chain_fn for the chains
// the port can build, one launch per chain. A chain has this grammar
// (kernels/chain.py::plan_chain checks it):
//
//   prologue: OneHotEncoderModel stages over input columns, then at most
//             one VectorAssembler over input columns and one-hot outputs
//   body:     0..8 scaler stages (StandardScaler, MinMaxScaler,
//             MaxAbsScaler, RobustScaler models), linear
//   head:     none | binomial LR | multinomial LR | KMeans (euclidean)
//
// The prologue is a list of parts (at most kMaxParts), each one input
// column: a dense column [rows, w] or [rows] of any numeric type (cast to
// the row's type T, as the per-stage paths cast), or an index column that
// a one-hot expands to `width` slots. The parts in the row are
// concatenated into the row [d] of type T; a part not in the row (offset
// -1) only writes its one-hot output. One-hot keep semantics, as the JAX
// fn computes them: the index truncates toward zero; an index outside
// [0, max_index] (NaN and +-inf included) goes to the catch-all slot
// `base`; with dropLast the index max_index gives an all-zero row; the
// one-hot output is float64.
//
// The body applies each stage's elementwise op sequence in order (stages
// are NOT pre-composed: each op rounds as in the per-stage path). Heads:
//   binomial:    dot = sum_j v[j] * coef[j], p = 1 / (1 + exp(-dot)),
//                prediction = dot >= 0, rawPrediction = [1 - p, p];
//   multinomial: logits[c] = sum_j v[j] * W[c, j], rawPrediction =
//                softmax(logits) (max-subtracted, exp / sum), prediction =
//                argmax (first index on ties, the first NaN if any);
//   KMeans:      prediction (int64) = argmin_c max((|v|^2 - 2 v.C[c]) +
//                |C[c]|^2, 0), the expansion of ops/blas.py::
//                squared_distances (first index on ties, the first NaN).
// Which columns are written is the caller's: one-hot outputs, the
// assembled row (`row_out`), the last scaler's output (`out`), the head's.
//
// What bounds it on the H100. A scaler chain with the binomial head:
// bytes (x read once, the scaler output written once; ~53.6 MB, ~16 us at
// 3.35 TB/s at 100,000 x 32 float64). A [k, d] head adds 2 k operations a
// row element: at 262,144 x 128, k = 64 in float64 that is 4.3 GFLOP, ~0.13
// ms at the float64 vector rate, so the class heads are bound by
// operations. This kernel is the simple version of them: lanes take
// classes, each a sequential dot over the row staged in shared memory.
//
// Two routes, picked by the wrapper (kernels/chain.py::route):
//
// - vector, when the row is a whole number of 16-byte chunks (d * itemsize
//   a multiple of 16, at most 32 chunks), every dense input starts 16-byte
//   aligned and every part is in the row: a group of G lanes (the chunk
//   count rounded up to a power of two) covers one row, each lane one
//   16-byte chunk (4 f32 or 2 f64 columns), so a warp takes 32 / G rows.
//   With a single dense input of type T the chunk is one 16-byte load
//   (issued a pass ahead, so loads stay in flight while the divisions
//   run); otherwise each of the lane's columns is gathered from its part.
//   Scaler chains with no head or the binomial head keep the per-stage
//   constants of the lane's columns in registers (the kernel is
//   instantiated per stage count); the other chains read them from shared
//   memory. The binomial dot is combined by a fixed xor tree inside the
//   group; a class head stages the warp's rows in shared memory and runs
//   them one by one over the whole warp.
// - scalar, for every other chain: one warp owns one row at a time
//   (grid-stride over rows), walks the parts in order with its lanes
//   striding each part's columns, reads the constants from shared memory,
//   and combines the binomial dot by a fixed shuffle tree.
//
// Every head is a template specialisation, so a chain pays only for its
// own. No intermediate column touches device memory unless it is asked
// for. Built with -fmad=false so the MinMax `unit * scale + offset` rounds
// twice, as numpy and XLA round it, and every op rounds as in the
// per-stage path on both routes.
//
// Stage encoding: 3 bits per stage in `ops` (stage s at bits 3s..3s+2):
//   bit 0  kind: 0 = shift/scale, 1 = min-max
//   bit 1  shift/scale: subtract a[j]
//   bit 2  shift/scale: divide by b[j]
// min-max: v = b[j] > 0 ? (v - a[j]) / b[j] : 0.5; v = v * scale + offset.
// Table layout (type T): stage s at s * (2d + 2): a[d], b[d], scale,
// offset; then the head's block: binomial coef[d]; multinomial W^T [d][k];
// KMeans C^T [d][k] and |C[c]|^2 [k].
//
// Shared memory (the chains that use it): the first n_smem elements of the
// table, then each warp's staged rows and (multinomial) its k logits. The
// wrapper (kernels/chain.py::shared_memory) keeps the whole table there
// when it fits; else the head's block is read from device memory (it stays
// in L2), then the stages' too; then the block has fewer warps. Only a
// row (and its logits) that one warp cannot stage is refused.
//
// Precision tiers (kernels/chain.py::ChainProgram under a PrecisionPolicy,
// as the JAX package's pipeline_fusion._chain_fn computes them):
//
// NARROW, the kernels' last template argument, marks the entries whose
// values are narrower than their registers: T = float, a bf16 row; T =
// double, a row whose head runs at a narrower compute width. Without a
// tier every path runs the NARROW = false kernels it ran before.
//
// - bfloat16 rows (mixed, mixed_inference: every float input cast to bf16
//   at the chain's boundary): the `_bf16` entry, T = float registers with
//   NARROW = true. Each input is rounded to bf16 as it is loaded (no pass over
//   it), every scaler op rounds its result to bf16 (XLA and PyTorch round
//   each bf16 op, so the stage boundary rounds too), and the row and scaler
//   outputs are stored as bf16. The vector route's chunks are 16 bytes of
//   the float32 input, as without a tier; outputs store 8 bytes a chunk.
// - a float64 row under a tier (a one-hot or integer part promotes the
//   row, as the census prologue does): the `_f64_tier` entry (NARROW =
//   true, the gathering routes only). The float inputs round to the
//   compute width at the load (Part flags kRoundBf16 / kRoundF32), the body
//   runs in float64, the head rounds its inputs to the compute width
//   (`rnd` bits 0 and 2).
// - heads: the dot, distance or logit carried in registers is rounded once
//   to the accumulation width (`rnd` bits 1 and 3), and so are the values
//   computed from it (sigmoid, 1 - p, the softmax's exp, sum and quotient,
//   the distance's two additions), as the plain version rounds them;
//   prediction and rawPrediction are stored at the widths the policy gives
//   them (`pred_ty`, `raw_ty`: 0 the row type, 1 float32, 2 bf16).
// - int8 constants (int8_inference): the table arrives as int8 codes, their
//   float32 scales and a list of segments (`qseg`, 8 ints each: offset and
//   length in the working table, kind (0 a float64 value, 1 an int8 code
//   times its scale), source, first scale, elements per scale, post-op (1
//   the zero guard, 2 the min-max span: minus segment `other`), other). The
//   block dequantizes q * scale in float32 as it stages the table into
//   shared memory, then applies the guard or the span (at T), so the whole
//   working table lives in shared memory (the wrapper keeps it there) and
//   device memory holds only the codes.
//
// No synchronisation and no allocation: the wrapper allocates the outputs
// and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Vector route: threads per block.
constexpr int kVecThreads = 128;
constexpr int kMaxParts = 64;

enum HeadKind { kNoHead = 0, kBinomial = 1, kMultinomial = 2, kKMeans = 3 };

// Part::code: bits 0-3 the element type of `src`, bit 4 one-hot, bit 5
// dropLast, bit 6 round to bf16 at the load, bit 7 round to float32.
enum Elem {
  kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3, kI16 = 4, kI8 = 5, kU8 = 6, kBF16 = 7
};
constexpr int kOneHot = 16;
constexpr int kDropLast = 32;
constexpr int kRoundBf16 = 64;
constexpr int kRoundF32 = 128;

// Args::rnd bits: the head's inputs round to bf16 (1) or float32 (4); its
// results to bf16 (2) or float32 (8).
constexpr int kInBf16 = 1, kOutBf16 = 2, kInF32 = 4, kOutF32 = 8;
// Output type codes of prediction and rawPrediction.
enum OutTy { kOutT = 0, kOutFloat = 1, kOutBf = 2 };

struct Part {
  const void* src;
  void* out;            // the one-hot output, double [rows, width], or null
  long long max_index;  // one-hot: the valid categories are [0, max_index]
  int width;            // columns the part gives
  int offset;           // its first column in the row; -1: not in the row
  int base;             // one-hot: the catch-all slot
  int code;
};
struct PartList {
  Part p[kMaxParts];
};

// The input: a dense [rows, d] column of type T, or the part list.
template <typename T, bool GATHER> struct Src;
template <typename T> struct Src<T, false> {
  const T* x;
};
template <typename T> struct Src<T, true> {
  PartList parts;
  int n_parts;
};

template <typename T>
struct Args {
  const T* table;
  int n_table;
  int n_smem;  // the table's elements in shared memory (see the head)
  int n_run;
  unsigned ops;
  int d;
  int group;  // vector route: lanes per row
  int k;      // classes of a multinomial or KMeans head
  int64_t n_rows;
  void* row_out;  // the row type: T, or bf16 on a bf16 row
  void* out;
  void* pred;     // pred_ty
  void* raw;      // raw_ty
  long long* ipred;
  int rnd;        // kInBf16 | kOutBf16 | kInF32 | kOutF32
  int pred_ty;
  int raw_ty;
  // int8 constants: the segments, float64 values and scales, int8 codes.
  const int* qseg;
  int n_seg;
  const double* qf;
  const signed char* qc;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// v rounded to bf16 (a float64 through float32 first, as PyTorch and XLA
// convert it), kept in T.
template <typename T>
__device__ __forceinline__ T to_bf16(T v) {
  return T(__bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}
// Whether a NARROW kernel over T registers runs a bf16 row.
template <bool NARROW, typename T>
constexpr bool kBf16Row = NARROW && sizeof(T) == 4;

// A head input at the compute width (narrower than the row only on a
// NARROW float64 row).
template <bool NARROW, typename T>
__device__ __forceinline__ T head_in(T v, int rnd) {
  if constexpr (NARROW && sizeof(T) == 8) {
    if (rnd & kInBf16) return to_bf16(v);
    if (rnd & kInF32) return T(static_cast<float>(v));
  }
  return v;
}
// A head result at the accumulation width. `rnd` is tested at run time in
// every kernel, the untiered ones (where it is 0) too: deciding it at
// compile time there gave the multinomial head a slower schedule on the
// H100 (PERF.md, section 6).
template <typename T>
__device__ __forceinline__ T head_out(T v, int rnd) {
  if (rnd & kOutBf16) return to_bf16(v);
  if constexpr (sizeof(T) == 8) {
    if (rnd & kOutF32) return T(static_cast<float>(v));
  }
  return v;
}
// A body value on the row's width: bf16 rows round every op.
template <bool NARROW, typename T>
__device__ __forceinline__ T row_round(T v) {
  if constexpr (kBf16Row<NARROW, T>) return to_bf16(v);
  return v;
}

// One stage's op on one element: a = shift or data min, b = scale or span.
template <bool NARROW, typename T>
__device__ __forceinline__ T apply_op(unsigned op, T v, T a, T b, T scale,
                                      T offset) {
  if (op & 1u) {
    v = b > T(0) ? row_round<NARROW>(row_round<NARROW>(v - a) / b) : T(0.5);
    return row_round<NARROW>(row_round<NARROW>(v * scale) + offset);
  }
  if (op & 2u) v = row_round<NARROW>(v - a);
  if (op & 4u) v = row_round<NARROW>(v / b);
  return v;
}

// Element i of a row-typed output (T, or bf16 on a bf16 row).
template <bool NARROW, typename T>
__device__ __forceinline__ void put_row(void* base, int64_t i, T v) {
  if constexpr (kBf16Row<NARROW, T>) {
    static_cast<__nv_bfloat16*>(base)[i] =
        __float2bfloat16_rn(static_cast<float>(v));
  } else {
    static_cast<T*>(base)[i] = v;
  }
}
// Element i of a head output of type code `ty`.
template <typename T>
__device__ __forceinline__ void put_as(void* base, int64_t i, T v, int ty) {
  if (ty == kOutFloat) {
    static_cast<float*>(base)[i] = static_cast<float>(v);
  } else if (ty == kOutBf) {
    static_cast<__nv_bfloat16*>(base)[i] =
        __float2bfloat16_rn(static_cast<float>(v));
  } else {
    static_cast<T*>(base)[i] = v;
  }
}

// The binomial head's outputs from the row's dot: prediction = dot >= 0,
// rawPrediction = [1 - p, p], p = sigmoid(dot), each at its width.
template <typename T>
__device__ __forceinline__ void binomial_out(const Args<T>& a, int64_t row,
                                             T acc) {
  const T dot = head_out(acc, a.rnd);
  const T p = head_out(T(1) / (T(1) + exp_t(-dot)), a.rnd);
  put_as(a.pred, row, dot >= T(0) ? T(1) : T(0), a.pred_ty);
  put_as(a.raw, 2 * row, head_out(T(1) - p, a.rnd), a.raw_ty);
  put_as(a.raw, 2 * row + 1, p, a.raw_ty);
}

// Working-table element r of int8 segment g (8 ints, see the head).
template <typename T>
__device__ __forceinline__ T seg_raw(const Args<T>& a, const int* g, int r) {
  if (g[2] == 0) return static_cast<T>(a.qf[g[3] + r]);
  const float scale = static_cast<float>(a.qf[g[4] + r / g[5]]);
  return static_cast<T>(static_cast<float>(a.qc[g[3] + r]) * scale);
}
template <typename T>
__device__ __forceinline__ T seg_value(const Args<T>& a, int s, int r) {
  const int* g = a.qseg + 8 * s;
  T v = seg_raw(a, g, r);
  if (g[6] == 1) {
    v = v > T(0) ? v : T(1);
  } else if (g[6] == 2) {
    v = v - seg_raw(a, a.qseg + 8 * g[7], r);
  }
  return v;
}

// Element i of a numeric column as T (a widening or exact cast).
template <typename T>
__device__ __forceinline__ T load_as(const void* src, int elem, long long i) {
  switch (elem) {
    case kF32: return T(static_cast<const float*>(src)[i]);
    case kF64: return T(static_cast<const double*>(src)[i]);
    case kI32: return T(static_cast<const int32_t*>(src)[i]);
    case kI64: return T(static_cast<const long long*>(src)[i]);
    case kI16: return T(static_cast<const int16_t*>(src)[i]);
    case kI8: return T(static_cast<const int8_t*>(src)[i]);
    case kBF16:
      return T(__bfloat162float(static_cast<const __nv_bfloat16*>(src)[i]));
    default: return T(static_cast<const uint8_t*>(src)[i]);
  }
}

// The one-hot slot of row r of part P; `zero`: the row is all zero
// (dropLast and the last category).
__device__ __forceinline__ long long onehot_slot(const Part& P, long long r,
                                                 bool& zero) {
  const int elem = P.code & 15;
  bool valid;
  long long idx;
  if (elem == kF32 || elem == kF64 || elem == kBF16) {
    const double t = trunc(load_as<double>(P.src, elem, r));
    valid = t >= 0.0 && t <= static_cast<double>(P.max_index);  // NaN: no
    idx = valid ? static_cast<long long>(t) : 0;
  } else {
    idx = load_as<long long>(P.src, elem, r);
    valid = idx >= 0 && idx <= P.max_index;
  }
  zero = valid && (P.code & kDropLast) && idx == P.max_index;
  return valid ? idx : P.base;
}

// Column c of part P at row r, as T; writes the one-hot output. NARROW:
// a float part rounds to the compute width (the chain's boundary cast).
template <typename T, bool NARROW>
__device__ __forceinline__ T part_value(const Part& P, long long r, int c) {
  if (P.code & kOneHot) {
    bool zero;
    const long long slot = onehot_slot(P, r, zero);
    const T v = (!zero && slot == c) ? T(1) : T(0);
    if (P.out != nullptr) {
      static_cast<double*>(P.out)[r * P.width + c] = static_cast<double>(v);
    }
    return v;
  }
  T v = load_as<T>(P.src, P.code & 15, r * P.width + c);
  if constexpr (NARROW) {
    if (P.code & kRoundBf16) {
      v = to_bf16(v);
    } else if (P.code & kRoundF32) {
      v = T(static_cast<float>(v));
    }
  }
  return v;
}

// Is (a, ia) before (b, ib) in an argmax (MAX) or argmin order: a NaN comes
// first, then the larger (smaller) value, then the smaller index.
template <bool MAX, typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  if (a == b) return ia < ib;
  return MAX ? a > b : a < b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // xor tree: every lane ends with the same bits (addition commutes).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A multinomial or KMeans head for one row xr[0..d) in shared memory, run
// by the whole warp: lane l takes the classes l, l + 32, ..., each a
// sequential dot over the row; wt = W^T [d][k] (then |C|^2 [k]); lg:
// the warp's k logits.
template <typename T, int HEAD>
__device__ __forceinline__ void class_head(const T* xr, const T* wt, T* lg,
                                           int64_t row, const Args<T>& a) {
  constexpr bool kMax = HEAD != kKMeans;
  const int lane = threadIdx.x & 31;
  const int d = a.d, k = a.k;
  const int rnd = a.rnd;
  T x2 = T(0);
  if constexpr (HEAD == kKMeans) {
    // Under a bf16 tier each square rounds, as the plain x * x does.
    for (int j = lane; j < d; j += 32) x2 += head_out(xr[j] * xr[j], rnd);
    x2 = head_out(warp_sum(x2), rnd);
  }
  T best = T(0);
  int bi = -1;
  for (int c = lane; c < k; c += 32) {
    T dot = T(0);
    for (int j = 0; j < d; ++j) dot += xr[j] * wt[j * k + c];
    dot = head_out(dot, rnd);
    if constexpr (HEAD == kKMeans) {
      T d2 = head_out(head_out(x2 - T(2) * dot, rnd) + wt[d * k + c], rnd);
      d2 = d2 < T(0) ? T(0) : d2;  // keeps NaN, as torch.clamp_min
      if (before<false>(d2, c, best, bi)) { best = d2; bi = c; }
    } else {
      lg[c] = dot;
      if (before<true>(dot, c, best, bi)) { best = dot; bi = c; }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (before<kMax>(ob, oi, best, bi)) { best = ob; bi = oi; }
  }
  if constexpr (HEAD == kKMeans) {
    if (lane == 0) a.ipred[row] = bi;
  } else {
    __syncwarp();
    T s = T(0);
    for (int c = lane; c < k; c += 32) {
      s += head_out(exp_t(head_out(lg[c] - best, rnd)), rnd);
    }
    s = head_out(warp_sum(s), rnd);
    for (int c = lane; c < k; c += 32) {
      const T e = head_out(exp_t(head_out(lg[c] - best, rnd)), rnd);
      put_as(a.raw, row * k + c, head_out(e / s, rnd), a.raw_ty);
    }
    if (lane == 0) put_as(a.pred, row, static_cast<T>(bi), a.pred_ty);
  }
  __syncwarp();
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

// A chunk of V row values stored at the row's width: 16 bytes of T, or
// 8 bytes of bf16 (4 values) on a bf16 row.
template <bool NARROW, typename T>
__device__ __forceinline__ void store_chunk(void* base, int64_t i,
                                            const T* v) {
  if constexpr (kBf16Row<NARROW, T>) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<unsigned*>(&lo);
    q.y = *reinterpret_cast<unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i), q);
  } else {
    Vec16<T>::store(static_cast<T*>(base) + i, v);
  }
}

// Vector route. NRUN >= 0: the NRUN stages' constants in registers (no
// head or the binomial head, one dense input of type T); NRUN < 0: a.n_run
// stages read from `stages`, the head's block from `head_block`, a class
// head's rows staged in `rowbuf` (shared memory). Lane l of a warp serves
// row (l / group) of each of the warp's row slots and columns
// [(l % group) * V, + V) of it; lanes past the row's chunks idle. NARROW
// (see the head): on a bf16 row the dense input rounds at the load, each
// op rounds, the row's outputs store bf16; on a float64 row the head's
// inputs round to the compute width.
template <typename T, int NRUN, int HEAD, bool GATHER, bool NARROW>
__device__ __forceinline__ void vector_rows(const Args<T>& a,
                                            const Src<T, GATHER>& src,
                                            const T* stages,
                                            const T* head_block, T* rowbuf) {
  using W = Vec16<T>;
  constexpr int V = W::n;
  constexpr bool kReg = NRUN >= 0;
  constexpr int R = NRUN > 0 ? NRUN : 1;
  const int d = a.d;
  const int group = a.group;
  const int lane = threadIdx.x & 31;
  const int q = lane & (group - 1);
  const int col = q * V;
  const bool active = col < d;
  const int rows_per_warp = 32 / group;
  const int stride = 2 * d + 2;
  const int n_run = kReg ? NRUN : a.n_run;

  T ra[R][V], rb[R][V], rscale[R], roffset[R], coef[V];
  if constexpr (kReg) {
#pragma unroll
    for (int s = 0; s < NRUN; ++s) {
      const T* st = a.table + s * stride;
      rscale[s] = st[2 * d];
      roffset[s] = st[2 * d + 1];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ra[s][j] = active ? st[col + j] : T(0);
        rb[s][j] = active ? st[d + col + j] : T(1);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      coef[j] = HEAD == kBinomial && active ? a.table[NRUN * stride + col + j]
                                            : T(0);
    }
  }
  // A class head's k logits (multinomial), after the warp's staged rows.
  T* lg = rowbuf + rows_per_warp * d;

  // Gathered columns: the part and the part's column of each of the lane's.
  int gpart[V], gcol[V];
  if constexpr (GATHER) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gpart[j] = 0;
      gcol[j] = 0;
      for (int p = 0; p < src.n_parts; ++p) {
        const Part& P = src.parts.p[p];
        if (P.offset >= 0 && col + j >= P.offset &&
            col + j < P.offset + P.width) {
          gpart[j] = p;
          gcol[j] = col + j - P.offset;
        }
      }
    }
  }

  const int64_t n_rows = a.n_rows;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kVecThreads +
                        threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * kVecThreads) >> 5;
  const int64_t step = n_warps * rows_per_warp;
  const int lane_row = lane / group;
  // No tier: the head's outputs at T with no rounding, stored directly.
  [[maybe_unused]] const bool plain_out =
      a.rnd == 0 && a.raw_ty == kOutT && a.pred_ty == kOutT;
  // r0: the warp's first row this pass (the same on every lane, so the
  // whole warp reaches the shuffles). A dense input's load of the next
  // pass is issued before this pass's ops, so it is in flight while they
  // run.
  int64_t r0 = warp * rows_per_warp;
  T next[V];
  if constexpr (!GATHER) {
    if (active && r0 + lane_row < n_rows) {
      W::load(src.x + (r0 + lane_row) * d + col, next);
    }
  }
  for (; r0 < n_rows; r0 += step) {
    const int64_t row = r0 + lane_row;
    const bool ok = active && row < n_rows;
    T v[V];
    if constexpr (GATHER) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = ok ? part_value<T, NARROW>(src.parts.p[gpart[j]], row, gcol[j]) : T(0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = row_round<NARROW>(next[j]);
      if (active && row + step < n_rows) W::load(src.x + (row + step) * d + col, next);
    }
    T acc = T(0);
    if (ok) {
      if (a.row_out != nullptr) store_chunk<NARROW>(a.row_out, row * d + col, v);
      if constexpr (kReg) {
#pragma unroll
        for (int s = 0; s < NRUN; ++s) {
          const unsigned op = (a.ops >> (3 * s)) & 7u;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            v[j] = apply_op<NARROW>(op, v[j], ra[s][j], rb[s][j], rscale[s],
                                roffset[s]);
          }
        }
      } else {
        for (int s = 0; s < n_run; ++s) {
          const unsigned op = (a.ops >> (3 * s)) & 7u;
          const T* st = stages + s * stride;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            v[j] = apply_op<NARROW>(op, v[j], st[col + j], st[d + col + j],
                                st[2 * d], st[2 * d + 1]);
          }
        }
      }
      if (a.out != nullptr) store_chunk<NARROW>(a.out, row * d + col, v);
      if constexpr (HEAD == kBinomial) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc += kReg ? v[j] * coef[j]
                      : head_in<NARROW>(v[j], a.rnd) * head_block[col + j];
        }
      }
      if constexpr (HEAD >= kMultinomial) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          rowbuf[lane_row * d + col + j] = head_in<NARROW>(v[j], a.rnd);
        }
      }
    }
    if constexpr (HEAD == kBinomial) {
      for (int off = group >> 1; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (q == 0 && row < n_rows) {
        if (plain_out) {
          const T p = T(1) / (T(1) + exp_t(-acc));
          static_cast<T*>(a.pred)[row] = acc >= T(0) ? T(1) : T(0);
          W::store2(static_cast<T*>(a.raw) + 2 * row, T(1) - p, p);
        } else {
          binomial_out(a, row, acc);
        }
      }
    }
    if constexpr (HEAD >= kMultinomial) {
      __syncwarp();
      for (int rr = 0; rr < rows_per_warp && r0 + rr < n_rows; ++rr) {
        class_head<T, HEAD>(rowbuf + rr * d, head_block, lg, r0 + rr, a);
      }
    }
  }
}

// The table's first n_smem elements in shared memory, the rest read from
// device memory. Where the table lies is the same for the whole grid: each
// branch inlines the body with its pointers' address spaces known (a
// pointer that may be either would make every load a generic one). An
// int8 table is dequantized segment by segment into shared memory (the
// wrapper then stages the whole table: n_smem == n_table).
template <typename T, typename Body>
__device__ __forceinline__ void with_table(const Args<T>& a, T* smem,
                                           int per_warp, Body body) {
  if (a.qseg != nullptr) {
    for (int s = 0; s < a.n_seg; ++s) {
      const int off = a.qseg[8 * s], len = a.qseg[8 * s + 1];
      for (int r = threadIdx.x; r < len; r += blockDim.x) {
        smem[off + r] = seg_value(a, s, r);
      }
    }
  } else {
    for (int i = threadIdx.x; i < a.n_smem; i += blockDim.x) smem[i] = a.table[i];
  }
  __syncthreads();
  const int n_stage = a.n_run * (2 * a.d + 2);
  T* rowbuf = smem + a.n_smem + (threadIdx.x >> 5) * per_warp;
  if (a.n_smem == a.n_table) {
    body(smem, smem + n_stage, rowbuf);
  } else if (a.n_smem > 0) {
    body(smem, a.table + n_stage, rowbuf);
  } else {
    body(a.table, a.table + n_stage, rowbuf);
  }
}

template <typename T, int NRUN, int HEAD, bool GATHER, bool NARROW>
__global__ void __launch_bounds__(kVecThreads)
fused_chain_vector_kernel(const Args<T> a,
                          const __grid_constant__ Src<T, GATHER> src) {
  if constexpr (NRUN >= 0) {
    vector_rows<T, NRUN, HEAD, GATHER, NARROW>(a, src, nullptr, nullptr, nullptr);
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int per_warp =
        HEAD >= kMultinomial
            ? 32 / a.group * a.d + (HEAD == kMultinomial ? a.k : 0)
            : 0;
    with_table<T>(a, reinterpret_cast<T*>(smem_raw), per_warp,
                  [&](const T* stages, const T* head, T* rowbuf) {
                    vector_rows<T, NRUN, HEAD, GATHER, NARROW>(a, src, stages,
                                                           head, rowbuf);
                  });
  }
}

// Scalar route: one warp per row, the parts in order, the stages read
// from `stages`, the head's block from `head_block`, a class head's row
// staged in `rowbuf`.
template <typename T, int HEAD, bool NARROW>
__device__ __forceinline__ void scalar_rows(const Args<T>& a,
                                            const Src<T, true>& src,
                                            const T* stages,
                                            const T* head_block, T* rowbuf) {
  const int d = a.d;
  const int stride = 2 * d + 2;
  T* lg = rowbuf + d;

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  // No tier: the head's outputs at T with no rounding, stored directly.
  [[maybe_unused]] const bool plain_out =
      a.rnd == 0 && a.raw_ty == kOutT && a.pred_ty == kOutT;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps +
                     (threadIdx.x >> 5);
       row < a.n_rows; row += static_cast<int64_t>(gridDim.x) * warps) {
    T acc = T(0);
    for (int p = 0; p < src.n_parts; ++p) {
      const Part& P = src.parts.p[p];
      for (int c = lane; c < P.width; c += 32) {
        T v = part_value<T, NARROW>(P, row, c);
        if (P.offset < 0) continue;
        const int j = P.offset + c;
        if (a.row_out != nullptr) put_row<NARROW>(a.row_out, row * d + j, v);
        for (int s = 0; s < a.n_run; ++s) {
          const T* st = stages + s * stride;
          v = apply_op<NARROW>((a.ops >> (3 * s)) & 7u, v, st[j], st[d + j],
                           st[2 * d], st[2 * d + 1]);
        }
        if (a.out != nullptr) put_row<NARROW>(a.out, row * d + j, v);
        if constexpr (HEAD == kBinomial) acc += head_in<NARROW>(v, a.rnd) * head_block[j];
        if constexpr (HEAD >= kMultinomial) rowbuf[j] = head_in<NARROW>(v, a.rnd);
      }
    }
    if constexpr (HEAD == kBinomial) {
      for (int offset = 16; offset > 0; offset >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, offset);
      }
      if (lane == 0) {
        if (plain_out) {
          const T p = T(1) / (T(1) + exp_t(-acc));
          static_cast<T*>(a.pred)[row] = acc >= T(0) ? T(1) : T(0);
          static_cast<T*>(a.raw)[2 * row] = T(1) - p;
          static_cast<T*>(a.raw)[2 * row + 1] = p;
        } else {
          binomial_out(a, row, acc);
        }
      }
    }
    if constexpr (HEAD >= kMultinomial) {
      __syncwarp();
      class_head<T, HEAD>(rowbuf, head_block, lg, row, a);
    }
  }
}

template <typename T, int HEAD, bool NARROW>
__global__ void __launch_bounds__(kThreads)
fused_chain_rows_kernel(const Args<T> a,
                        const __grid_constant__ Src<T, true> src) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  with_table<T>(a, reinterpret_cast<T*>(smem_raw),
                HEAD >= kMultinomial
                    ? a.d + (HEAD == kMultinomial ? a.k : 0)
                    : 0,
                [&](const T* stages, const T* head, T* rowbuf) {
                  scalar_rows<T, HEAD, NARROW>(a, src, stages, head, rowbuf);
                });
}

// Dynamic shared memory above 48 KB needs a per-kernel opt-in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem <= 48 * 1024 || smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// A persistent grid: at most the blocks the card holds at once. The
// occupancy of a kernel is kept for the last shared memory size asked.
struct Occupancy {
  size_t smem = ~size_t(0);
  int threads = 0;
  int blocks = 0;
};

template <typename K>
int64_t grid_size(K kernel, int threads, size_t smem, int64_t blocks,
                  Occupancy& occ, cudaError_t& e) {
  e = cudaSuccess;
  if (occ.smem != smem || occ.threads != threads) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ.blocks, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return 0;
    if (occ.blocks < 1) occ.blocks = 1;
    occ.smem = smem;
    occ.threads = threads;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 132) * occ.blocks;
  return blocks < resident ? blocks : resident;
}

template <typename T, int NRUN, int HEAD, bool GATHER, bool NARROW>
int launch_vector(const Args<T>& a, const Src<T, GATHER>& src, size_t smem,
                  cudaStream_t stream) {
  auto kernel = fused_chain_vector_kernel<T, NRUN, HEAD, GATHER, NARROW>;
  static size_t allowed = 0;
  static Occupancy occ;
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t rows_per_block =
      static_cast<int64_t>(kVecThreads / 32) * (32 / a.group);
  const int64_t blocks = grid_size(
      kernel, kVecThreads, smem, (a.n_rows + rows_per_block - 1) / rows_per_block,
      occ, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kVecThreads, smem, stream>>>(a, src);
  return static_cast<int>(cudaGetLastError());
}

// threads: a multiple of 32, at most kThreads (fewer when each warp's
// staged row would not fit in shared memory otherwise).
template <typename T, int HEAD, bool NARROW>
int launch_rows(const Args<T>& a, const Src<T, true>& src, int threads,
                size_t smem, cudaStream_t stream) {
  auto kernel = fused_chain_rows_kernel<T, HEAD, NARROW>;
  static size_t allowed = 0;
  static Occupancy occ;
  if (threads < 32 || threads > kThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = threads / 32;
  const int64_t blocks =
      grid_size(kernel, threads, smem, (a.n_rows + warps - 1) / warps, occ, e);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(a, src);
  return static_cast<int>(cudaGetLastError());
}

// The vector route with the constants in registers: no head or the
// binomial head over one dense input of type T.
template <typename T, int HEAD, bool NARROW>
int launch_vector_reg(const Args<T>& a, const Src<T, false>& src,
                      cudaStream_t stream) {
  switch (a.n_run) {
#define FML_CHAIN_RUN(N) \
  case N:                \
    return launch_vector<T, N, HEAD, false, NARROW>(a, src, 0, stream);
    FML_CHAIN_RUN(0) FML_CHAIN_RUN(1) FML_CHAIN_RUN(2) FML_CHAIN_RUN(3)
    FML_CHAIN_RUN(4) FML_CHAIN_RUN(5) FML_CHAIN_RUN(6) FML_CHAIN_RUN(7)
    FML_CHAIN_RUN(8)
#undef FML_CHAIN_RUN
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HEAD, bool NARROW>
int launch_head(const Args<T>& a, const PartList* parts, int n_parts,
                int gather, int threads, size_t smem, cudaStream_t stream) {
  if (a.group == 0) {
    Src<T, true> src{*parts, n_parts};
    return launch_rows<T, HEAD, NARROW>(a, src, threads, smem, stream);
  }
  if (gather) {
    Src<T, true> src{*parts, n_parts};
    return launch_vector<T, -1, HEAD, true, NARROW>(a, src, smem, stream);
  }
  if constexpr (NARROW && sizeof(T) == 8) {
    // A float64 row under a tier always gathers (its float inputs are
    // cast at the load): it has no dense route.
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const Src<T, false> src{static_cast<const T*>(parts->p[0].src)};
    if constexpr (HEAD <= kBinomial) {
      // An int8 table is staged (dequantized) in shared memory: no
      // constants in registers.
      if (a.qseg == nullptr) {
        return launch_vector_reg<T, HEAD, NARROW>(a, src, stream);
      }
    }
    return launch_vector<T, -1, HEAD, false, NARROW>(a, src, smem, stream);
  }
}

// group > 0: the vector route with lane groups of `group` lanes (kVecThreads
// a block); 0: the scalar route with `threads` a block. gather: the vector
// route reads the parts (not one dense input of type T). smem: the dynamic
// shared memory of the chains that use it (n_smem elements of the table,
// then each warp's staged rows and logits). rnd, pred_ty, raw_ty: the
// precision tier's head (see the head of this file); qseg, n_seg, qf, qc:
// an int8 table (qseg null: `table` is the working table).
template <typename T, bool NARROW>
int launch(const void* parts_, int n_parts, int gather, const void* table,
           int n_table, int n_smem, int n_run, unsigned ops, int d, int head,
           int k, int group, int threads, int64_t n_rows, long long smem,
           void* row_out, void* out, void* pred, void* raw, int rnd,
           int pred_ty, int raw_ty, const void* qseg, int n_seg,
           const void* qf, const void* qc, void* stream_) {
  const PartList* parts = static_cast<const PartList*>(parts_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (n_parts < 1 || n_parts > kMaxParts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<T> a{static_cast<const T*>(table), n_table, n_smem, n_run, ops, d,
            group, k, n_rows, row_out, out, pred, raw,
            static_cast<long long*>(pred), rnd, pred_ty, raw_ty,
            static_cast<const int*>(qseg), n_seg,
            static_cast<const double*>(qf),
            static_cast<const signed char*>(qc)};
  const size_t bytes = static_cast<size_t>(smem);
  switch (head) {
    case kNoHead: return launch_head<T, kNoHead, NARROW>(a, parts, n_parts, gather, threads, bytes, stream);
    case kBinomial: return launch_head<T, kBinomial, NARROW>(a, parts, n_parts, gather, threads, bytes, stream);
    case kMultinomial: return launch_head<T, kMultinomial, NARROW>(a, parts, n_parts, gather, threads, bytes, stream);
    case kKMeans: return launch_head<T, kKMeans, NARROW>(a, parts, n_parts, gather, threads, bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define FML_CHAIN_ENTRY(NAME, T, NARROW)                                            \
  extern "C" int NAME(const void* parts, int n_parts, int gather,              \
                      const void* table, int n_table, int n_smem, int n_run,   \
                      unsigned ops, int d, int head, int k, int group,         \
                      int threads, int64_t n_rows, long long smem,             \
                      void* row_out, void* out, void* pred, void* raw,         \
                      int rnd, int pred_ty, int raw_ty, const void* qseg,      \
                      int n_seg, const void* qf, const void* qc,               \
                      void* stream) {                                          \
    return launch<T, NARROW>(parts, n_parts, gather, table, n_table, n_smem,       \
                         n_run, ops, d, head, k, group, threads, n_rows, smem, \
                         row_out, out, pred, raw, rnd, pred_ty, raw_ty, qseg,  \
                         n_seg, qf, qc, stream);                               \
  }
FML_CHAIN_ENTRY(fml_fused_chain_f32, float, false)
FML_CHAIN_ENTRY(fml_fused_chain_f64, double, false)
FML_CHAIN_ENTRY(fml_fused_chain_bf16, float, true)
FML_CHAIN_ENTRY(fml_fused_chain_f64_tier, double, true)
#undef FML_CHAIN_ENTRY

extern "C" int fml_chain_part_bytes() { return static_cast<int>(sizeof(Part)); }

extern "C" const char* fml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
