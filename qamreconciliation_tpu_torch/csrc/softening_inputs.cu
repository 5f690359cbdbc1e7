// The softening round's inputs, for Hopper (sm_90a): Bob's word and Alice's
// softening LLRs from the symbols x and samples y of one round, in one pass.
// Replaces no Pallas kernel: the JAX package leaves this step to XLA's
// elementwise ops (qamreconciliation_tpu/sims/engine.py, the softening
// inputs).  Plain version: ops/kernels.py:softening_inputs_ref with "poly"
// LLRs and the "erf" marginal CDF, which is ReconciliationEngine's
// _softening_inputs: NoiseMapper.hard_decide_index, map_noise (F_Y by the
// erf mixture, then g) and _poly_llr_bits.
//
//   y    [S, B] f32 or bf16: Bob's samples
//   x    [S, B] int32: Alice's symbols
//   tab  f32, the mapper's table (NoiseMapper._ensure_softening_tab), in
//        order: the M - 1 interior thresholds, c[M], p/2[M], F at the lower and
//        at the upper threshold of each interval [M] and [M], the interval
//        masses [M] (all rounded to the sample dtype first), the signs of g
//        [M] (0 or 1), sqrt(2) sigma (f32, as the plain path forms it), and
//        the Chebyshev coefficients [nseg * M, (deg + 1) * bps]
//   s2b  [M, bps] int32: each symbol's Gray bits
//   llr  [S * bps, B] y's dtype: row s * bps + b holds bit b of symbol s
//   word [S * bps, B] int32: the same rows of Bob's decided symbol's bits
//
// Each step rounds as the plain path's PyTorch op on the card does: every
// add, subtract, multiply and divide is an IEEE operation of its own
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn: nvcc contracts a multiply and
// an add into an FMA by default, PyTorch's separate kernels never do), a
// bf16 sample difference rounds to bf16 (__float2bfloat16_rn, PyTorch's cast
// on the card) before it widens to f32, erff and logf are the CUDA math
// library's, as PyTorch's erf and log call them, and the clamps are
// PyTorch's (a NaN passes, else fminf(fmaxf(v, lo), hi)).  The M terms of
// F sum as torch.sum reduces a short contiguous last axis on the card (found
// by experiment for M = 2, 4, 8 and 16): each term added to 0, then each of
// the lower half to its partner M / 2 above, and so on by halves, ((t0 + t2)
// + (t1 + t3)) at M = 4.  The LLR rounds to the sample dtype, then takes
// alpha as PyTorch applies a 0-dim CPU tensor: f32(alpha) * f32(llr),
// rounded once to the dtype.  Bit-identical to the plain version on the
// card (tests/test_torch_cuda.py, chip_smoke.py phase_softening).
//
// Bound: bytes.  A call reads y and x and writes the LLRs and the word: at
// [32400, 128] bf16, 8.3 + 16.6 MB in and 16.6 + 33.2 MB out, 0.022 ms at
// 3.35 TB/s; the ~120 operations an element (M erff, two logf, 10
// Clenshaw steps a bit) take 0.015 ms at the f32 rate.
// Design: a thread owns VEC consecutive frames of a sample row (16 bytes of
// y: 8 bf16 or 4 f32) and writes the same frames of its bps LLR rows and
// word rows, so the loads and stores of neighbouring lanes coalesce.  The
// table lives in shared memory: neighbouring lanes gather different
// (segment, symbol) coefficient rows, which constant memory would
// serialise.  Blocks stride over the rows (a grid of a few blocks an SM),
// so each block fills its table once.  A ragged B, or an unaligned tensor,
// takes one frame a thread (VEC = 1) on the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kNseg = 8;   // noisemapper._POLY_NSEG
constexpr int kDeg = 10;   // noisemapper._POLY_DEG
enum DType { kF32 = 0, kBF16 = 1 };

// the host's constants, each a Python float rounded to f32 as PyTorch
// rounds a scalar operand
struct Consts {
  float d;       // the LLR fit's boundary-layer offset, 1e-4
  float one_d;   // 1 + d, formed in double
  float wlo;     // log(d) - log1p(d), formed in double
  float scale;   // 1 / (-2 wlo) * nseg, formed in double
  float tmax;    // nseg * (1 - 1e-7), formed in double
  float alpha;   // the LLR scale, rounded to the sample dtype first
};

constexpr int bits_of(int M) { return M == 2 ? 1 : M == 4 ? 2 : M == 8 ? 3 : 4; }

// offsets into the table (floats)
template <int M>
struct Tab {
  static constexpr int kBps = bits_of(M);
  static constexpr int kRow = (kDeg + 1) * kBps;
  static constexpr int kThr = 0;
  static constexpr int kC = M - 1;
  static constexpr int kPh = kC + M;
  static constexpr int kLo = kPh + M;
  static constexpr int kHi = kLo + M;
  static constexpr int kDl = kHi + M;
  static constexpr int kFlip = kDl + M;
  static constexpr int kDen = kFlip + M;
  static constexpr int kCoef = kDen + 1;
  static constexpr int kSize = kCoef + kNseg * M * kRow;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

template <typename T>
__device__ __forceinline__ float in_dtype(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

template <typename T>
__device__ __forceinline__ T to_dtype(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return v;
}

template <typename T>
__device__ __forceinline__ float widen(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return v;
}

// One element: the decided symbol and the bps LLRs in the sample dtype.
template <typename T, int M>
__device__ __forceinline__ int element(const float* sm, float yv, int xs,
                                       const Consts& k, T* llr) {
  using L = Tab<M>;
  constexpr int kBps = L::kBps;
  // hard decision: the count of interior thresholds <= y
  int xh = 0;
#pragma unroll
  for (int t = 0; t < M - 1; ++t) xh += yv >= sm[L::kThr + t];
  // F_Y by the erf mixture, summed in torch.sum's order
  float term[M];
  const float den = sm[L::kDen];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const float z = __fdiv_rn(in_dtype<T>(__fsub_rn(yv, sm[L::kC + c])), den);
    term[c] = __fadd_rn(0.0f,
                        __fmul_rn(sm[L::kPh + c], __fadd_rn(1.0f, erff(z))));
  }
#pragma unroll
  for (int h = M / 2; h > 0; h >>= 1)
#pragma unroll
    for (int c = 0; c < h; ++c) term[c] = __fadd_rn(term[c], term[c + h]);
  const float F = term[0];
  // g: the metric n within the decided interval
  const float n = sm[L::kFlip + xh] != 0.0f
                      ? __fdiv_rn(__fsub_rn(sm[L::kHi + xh], F), sm[L::kDl + xh])
                      : __fdiv_rn(__fsub_rn(F, sm[L::kLo + xh]), sm[L::kDl + xh]);
  // the warped coordinate, its segment and the Chebyshev abscissa
  const float nf = clampf(n, 0.0f, 1.0f);
  const float w = __fsub_rn(logf(__fadd_rn(nf, k.d)),
                            logf(__fsub_rn(k.one_d, nf)));
  const float t = clampf(__fmul_rn(__fsub_rn(w, k.wlo), k.scale), 0.0f,
                         k.tmax);
  const float seg = floorf(t);
  const float xx = __fsub_rn(__fmul_rn(2.0f, __fsub_rn(t, seg)), 1.0f);
  const float tx = __fmul_rn(2.0f, xx);
  const int j = min(max(xs, 0), M - 1);
  const float* cf = sm + L::kCoef + ((int)seg * M + j) * L::kRow;
#pragma unroll
  for (int b = 0; b < kBps; ++b) {
    float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
    for (int d = kDeg; d > 0; --d) {
      const float nb =
          __fadd_rn(__fsub_rn(__fmul_rn(tx, b1), b2), cf[d * kBps + b]);
      b2 = b1;
      b1 = nb;
    }
    const float v = __fadd_rn(__fsub_rn(__fmul_rn(xx, b1), b2), cf[b]);
    llr[b] = to_dtype<T>(__fmul_rn(k.alpha, widen(to_dtype<T>(v))));
  }
  return xh;
}

template <typename T, int VEC>
struct alignas(16) Row {
  static_assert(VEC * sizeof(T) == 16 || VEC == 1, "16 bytes or a frame");
  T v[VEC];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VEC == 1)
      v[0] = p[0];
    else
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (VEC == 1)
      p[0] = v[0];
    else
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  }
};

template <int VEC>
struct alignas(16) Ints {
  int v[VEC];
  __device__ __forceinline__ void load(const int* p) {
    if constexpr (VEC == 1) {
      v[0] = p[0];
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        *reinterpret_cast<int4*>(v + 4 * q) =
            __ldg(reinterpret_cast<const int4*>(p) + q);
    }
  }
  __device__ __forceinline__ void store(int* p) const {
    if constexpr (VEC == 1) {
      p[0] = v[0];
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        reinterpret_cast<int4*>(p)[q] =
            *reinterpret_cast<const int4*>(v + 4 * q);
    }
  }
};

template <typename T, int M, int VEC>
__global__ void __launch_bounds__(kThreads)
    softening_kernel(const T* __restrict__ y, const int* __restrict__ x,
                     const float* __restrict__ tab,
                     const int* __restrict__ s2b, T* __restrict__ llr,
                     int* __restrict__ word, int S, int B, int chunks,
                     Consts k) {
  using L = Tab<M>;
  constexpr int kBps = L::kBps;
  __shared__ __align__(16) float sm[L::kSize];
  __shared__ int sb[M * kBps];
  for (int i = threadIdx.x; i < L::kSize; i += blockDim.x) sm[i] = tab[i];
  for (int i = threadIdx.x; i < M * kBps; i += blockDim.x) sb[i] = s2b[i];
  __syncthreads();
  const long long units = (long long)S * chunks;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(u / chunks);
    const int b0 = (int)(u - (long long)s * chunks) * VEC;
    const size_t at = (size_t)s * B + b0;
    Row<T, VEC> yr;
    Ints<VEC> xr;
    yr.load(y + at);
    xr.load(x + at);
    Row<T, VEC> out[kBps];
    int xh[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      T l[kBps];
      xh[i] = element<T, M>(sm, widen(yr.v[i]), xr.v[i], k, l);
#pragma unroll
      for (int b = 0; b < kBps; ++b) out[b].v[i] = l[b];
    }
#pragma unroll
    for (int b = 0; b < kBps; ++b) {
      const size_t row = ((size_t)s * kBps + b) * B + b0;
      out[b].store(llr + row);
      Ints<VEC> wr;
#pragma unroll
      for (int i = 0; i < VEC; ++i) wr.v[i] = sb[xh[i] * kBps + b];
      wr.store(word + row);
    }
  }
}

template <typename T, int M, int VEC>
int launch(const void* y, const void* x, const void* tab, const void* s2b,
           void* llr, void* word, int S, int B, int max_blocks, Consts k,
           cudaStream_t s) {
  const int chunks = B / VEC;
  const long long units = (long long)S * chunks;
  long long grid = (units + kThreads - 1) / kThreads;
  if (grid > max_blocks) grid = max_blocks;
  softening_kernel<T, M, VEC><<<(int)grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const int*>(x),
      static_cast<const float*>(tab), static_cast<const int*>(s2b),
      static_cast<T*>(llr), static_cast<int*>(word), S, B, chunks, k);
  return (int)cudaGetLastError();
}

template <int M>
int by_dtype(const void* y, const void* x, const void* tab, const void* s2b,
             void* llr, void* word, int dtype, int S, int B, int vec,
             int max_blocks, Consts k, cudaStream_t s) {
  if (dtype == kF32 && vec == 1)
    return launch<float, M, 1>(y, x, tab, s2b, llr, word, S, B, max_blocks,
                               k, s);
  if (dtype == kF32 && vec == 4 && B % 4 == 0)
    return launch<float, M, 4>(y, x, tab, s2b, llr, word, S, B, max_blocks,
                               k, s);
  if (dtype == kBF16 && vec == 1)
    return launch<__nv_bfloat16, M, 1>(y, x, tab, s2b, llr, word, S, B,
                                       max_blocks, k, s);
  if (dtype == kBF16 && vec == 8 && B % 8 == 0)
    return launch<__nv_bfloat16, M, 8>(y, x, tab, s2b, llr, word, S, B,
                                       max_blocks, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The softening inputs of one round, VEC frames a thread (ops/kernels.py
// var_totals_vec: 1, or 16 bytes of the sample dtype when B fills whole
// 16-byte units and every pointer is 16-byte aligned), at most max_blocks
// blocks of 256 threads.  Returns cudaGetLastError() after the launch (0 =
// ok), or cudaErrorInvalidValue for arguments the kernel does not take
// (an order M other than 2, 4, 8 or 16).
extern "C" int softening_inputs_launch(const void* y, const void* x,
                                       const void* tab, const void* s2b,
                                       void* llr, void* word, int dtype,
                                       int M, int S, int B, int vec,
                                       int max_blocks, float d, float one_d,
                                       float wlo, float scale, float tmax,
                                       float alpha, void* stream) {
  if (S < 1 || B < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const Consts k{d, one_d, wlo, scale, tmax, alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 2:
      return by_dtype<2>(y, x, tab, s2b, llr, word, dtype, S, B, vec,
                         max_blocks, k, s);
    case 4:
      return by_dtype<4>(y, x, tab, s2b, llr, word, dtype, S, B, vec,
                         max_blocks, k, s);
    case 8:
      return by_dtype<8>(y, x, tab, s2b, llr, word, dtype, S, B, vec,
                         max_blocks, k, s);
    case 16:
      return by_dtype<16>(y, x, tab, s2b, llr, word, dtype, S, B, vec,
                          max_blocks, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
