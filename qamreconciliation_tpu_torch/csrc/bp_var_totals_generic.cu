// The variable side of two flooding decoders, for Hopper (sm_90a): each
// variable's new totals from the check->variable messages of its real edges,
// in one pass.  Replaces no Pallas kernel: the JAX package leaves this step to
// XLA's gather and sum (qamreconciliation_tpu/models/decoder.py and
// models/qc_decoder.py, the decode loops' variable totals).  Two entries share
// one kernel template:
//
// * gather 2 of the generic decoder (bp_var_totals_generic_launch; plain
//   version ops/kernels.py:bp_var_totals_generic_ref, the masked loop over
//   the dv_max padded slots);
// * the variable pass of the dense QC decoder (bp_var_pass_qc_launch; plain
//   version ops/kernels.py:bp_var_pass_qc_ref, the fold of
//   models/qc_decoder.fold_incoming plus the prior), which also writes each
//   lane's totals into the check phase's next input t, so that the loop's
//   gather of the totals runs once a decode.
//
//   prior  [V, B] f32 (generic: the decode's prior in the sum dtype) or c2v's
//          dtype (QC: the prior in storage, widened here, exactly)
//   c2v    [rows, B] f32 or bf16: the messages, any layout of flat rows
//   table  [dv_max, V] int32: row of c2v of each variable's d-th edge, in the
//          fold's order (padded slots hold 0)
//   degree [V] int32: each variable's real edges (table's first rows)
//   out    [V, B] c2v's dtype
//   t      [rows, B] c2v's dtype (QC only): row table[d, v] of t takes
//          out[v] for each real slot d; other rows are left as they are
//
//   out[v, b] = round(prior[v, b] + fold_v[b])
//
// fold_v is the left fold, in f32 with each addition rounded to nearest
// (__fadd_rn; no contraction, no fast-math, no atomics, no split sums), of
// the variable's real messages in slot order, each widened exactly to f32.
// Generic: the plain version also adds every padded slot, as c2v row 0 times
// 0.0: a +-0 (or a NaN), which can still turn a fold of -0 into +0.  Adding
// the same term again changes nothing, so a variable with fewer than dv_max
// edges adds __fmul_rn(row 0, 0.0f) once after its real slots, and a
// variable with no edge starts its fold from it.  QC: no padded-slot term; a
// variable with no edge folds to +0 (the plain version's zero accumulator,
// which turns a -0 prior into +0).  The sum with the prior rounds once to the
// storage type, to nearest even (__float2bfloat16_rn, as PyTorch's cast on
// the card).  The results are bit-identical to the plain versions, zero signs
// included.
//
// Bound: bytes.  A call reads each real edge's message row once, the prior
// and the two index arrays, and writes the totals (and, QC, each real edge's
// t row): 3.2 adds a row element at the DVB-S2 rate-1/2 degrees, far below
// the card's operation rate.  Generic at [7, 32400, 128] bf16 (226,799
// edges, V = 64,800): 58.1 MB of messages, 33.2 MB of prior, 16.6 MB of
// totals and about 1 MB of indices, 0.033 ms at 3.35 TB/s.  QC at [90, 6,
// 360, 128] bf16 (194,400 edges, V = 64,800): 49.8 MB of messages, 16.6 MB
// of prior, 16.6 MB of totals, 49.8 MB of t and 1.0 MB of indices, 0.040 ms.
// The messages are larger than half the 50 MB L2, so the rows stream from
// device memory.
// Design: a thread owns VEC consecutive frames (16 bytes of a message row:
// 8 bf16 or 4 f32) of one variable, so a row of B frames is read by B / VEC
// neighbouring lanes in one coalesced access.  It reads up to kBatch table
// entries beside its degree (one round trip, not two), then issues the rows
// of its real slots among them before it adds any, so up to 8 rows a thread
// are in flight, and only the variable's real slots' rows are read.  The QC
// pass then writes its rounded totals with one 16-byte store to out and one
// to each real slot's t row (the same row numbers as its messages, so the
// stores of neighbouring threads coalesce as the loads do).  Every variable
// of a ragged B, or of unaligned tensors, takes one frame a thread (VEC = 1)
// on the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // slots whose loads a thread keeps in flight
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ uint32_t word_of(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// VEC consecutive frames of one row of T: one 16-byte load where they fill
// 16 bytes, else one element
template <typename T, int VEC>
struct Frames {
  static constexpr bool kWide = VEC * sizeof(T) == 16;
  static_assert(kWide || VEC == 1, "VEC is 1 or fills 16 bytes");
  typename std::conditional<kWide, uint4, T>::type raw;

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWide)
      raw = __ldg(reinterpret_cast<const uint4*>(p));
    else
      raw = *p;
  }
  // frame i widened to f32 (exact)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (kWide) {
      if constexpr (std::is_same<T, float>::value) {
        return __uint_as_float(word_of(raw, i));
      } else {
        const uint32_t w = word_of(raw, i >> 1);
        return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
      }
    } else {
      if constexpr (std::is_same<T, float>::value)
        return raw;
      else
        return __bfloat162float(raw);
    }
  }
};

template <int VEC>
__device__ __forceinline__ void load_prior(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_out(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same<T, float>::value)
      *p = x[0];
    else
      *p = __float2bfloat16_rn(x[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint32_t w[VEC / 2];
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// kQC: the dense QC variable pass (a prior of type T, no padded-slot
// term, the totals mirrored into t); else gather 2 of the generic decoder
template <typename T, int VEC, bool kQC>
__global__ void __launch_bounds__(kThreads)
    var_totals_kernel(const void* __restrict__ prior,
                      const T* __restrict__ c2v,
                      const int* __restrict__ table,
                      const int* __restrict__ degree, T* __restrict__ out,
                      T* __restrict__ t, int V, int B, int dv_max,
                      int chunks) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)V * chunks) return;
  const int v = (int)(g / chunks);
  const int b0 = (int)(g - (long long)v * chunks) * VEC;
  const int dv = __ldg(degree + v);
  const size_t at = (size_t)v * B + b0;

  float pr[VEC], acc[VEC];
  if constexpr (kQC) {
    Frames<T, VEC> p;
    p.load(static_cast<const T*>(prior) + at);
#pragma unroll
    for (int i = 0; i < VEC; ++i) pr[i] = p.get(i);
  } else {
    load_prior<VEC>(static_cast<const float*>(prior) + at, pr);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

  for (int d0 = 0; d0 < dv_max; d0 += kBatch) {
    // the batch's table entries are read beside the degree, not after it
    int row[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      row[j] = d0 + j < dv_max ? __ldg(table + (size_t)(d0 + j) * V + v) : 0;
    if (d0 >= dv) break;
    Frames<T, VEC> x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (d0 + j < dv) x[j].load(c2v + (size_t)row[j] * B + b0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (d0 + j < dv) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = (d0 + j == 0) ? x[j].get(i)
                                 : __fadd_rn(acc[i], x[j].get(i));
      }
  }
  if constexpr (!kQC) {
    if (dv < dv_max) {  // the padded slots' one term: row 0 times 0.0
      Frames<T, VEC> z;
      z.load(c2v + b0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float p = __fmul_rn(z.get(i), 0.0f);
        acc[i] = dv == 0 ? p : __fadd_rn(acc[i], p);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(pr[i], acc[i]);
  store_out<T, VEC>(out + at, acc);
  if constexpr (kQC) {
    // the same totals into t's row of each real slot: the rows of the
    // messages just read (their table entries are cached)
    for (int d0 = 0; d0 < dv; d0 += kBatch) {
      int row[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        row[j] = d0 + j < dv ? __ldg(table + (size_t)(d0 + j) * V + v) : 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (d0 + j < dv) store_out<T, VEC>(t + (size_t)row[j] * B + b0, acc);
    }
  }
}

template <typename T, int VEC, bool kQC>
int launch(const void* prior, const void* c2v, const void* table,
           const void* degree, void* out, void* t, int V, int B, int dv_max,
           cudaStream_t s) {
  const int chunks = B / VEC;
  const long long threads = (long long)V * chunks;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  var_totals_kernel<T, VEC, kQC><<<(int)grid, kThreads, 0, s>>>(
      prior, static_cast<const T*>(c2v), static_cast<const int*>(table),
      static_cast<const int*>(degree), static_cast<T*>(out),
      static_cast<T*>(t), V, B, dv_max, chunks);
  return (int)cudaGetLastError();
}

// the four (dtype, VEC) instances of one entry
template <bool kQC>
int dispatch(const void* prior, const void* c2v, const void* table,
             const void* degree, void* out, void* t, int dtype, int V, int B,
             int dv_max, int vec, void* stream) {
  if (V < 1 || B < 1 || dv_max < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && vec == 1)
    return launch<float, 1, kQC>(prior, c2v, table, degree, out, t, V, B,
                                 dv_max, s);
  if (dtype == kF32 && vec == 4 && B % 4 == 0)
    return launch<float, 4, kQC>(prior, c2v, table, degree, out, t, V, B,
                                 dv_max, s);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, 1, kQC>(prior, c2v, table, degree, out, t,
                                         V, B, dv_max, s);
  if (dtype == kBF16 && vec == 8 && B % 8 == 0)
    return launch<__nv_bfloat16, 8, kQC>(prior, c2v, table, degree, out, t,
                                         V, B, dv_max, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The fold with VEC frames a thread (ops/kernels.py var_totals_vec: 1, or
// 16 bytes of the message dtype when B fills whole 16-byte units and every
// pointer is 16-byte aligned); each entry returns cudaGetLastError() after
// the launch (0 = ok), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int bp_var_totals_generic_launch(
    const void* prior, const void* c2v, const void* table, const void* degree,
    void* out, int dtype, int V, int B, int dv_max, int vec, void* stream) {
  return dispatch<false>(prior, c2v, table, degree, out, nullptr, dtype, V,
                         B, dv_max, vec, stream);
}

// The dense QC variable pass: as above with a prior of c2v's dtype, and the
// totals also written to t's rows of the real slots.
extern "C" int bp_var_pass_qc_launch(const void* prior, const void* c2v,
                                     const void* table, const void* degree,
                                     void* out, void* t, int dtype, int V,
                                     int B, int dv_max, int vec,
                                     void* stream) {
  return dispatch<true>(prior, c2v, table, degree, out, t, dtype, V, B,
                        dv_max, vec, stream);
}
