// Device math shared by the BP kernels (bp_check_phase_qc.cu,
// bp_decode_rounds_qc.cu, bp_layered_sweeps_qc.cu,
// bp_check_phase_generic.cu): loads and stores in the message dtype,
// phi(x) = -log(tanh(x/2)), and the all-but-one check-node magnitude of the
// three rules, and of phi over masked (padded) rows.  Each function follows the operation order
// of the plain PyTorch versions in ops/kernels.py and ops/boxplus.py, so
// min-sum is bit-identical to them.
//
// Numerics: expf/logf/log1pf/tanhf, no fast-math intrinsics.  Products whose
// result feeds an addition are written with __fmul_rn, so the compiler
// cannot contract them into an FMA that the plain version does not do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace bp {

enum Rule { kPhi = 0, kTanhFB = 1, kMinSum = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kMaxDc = 32;  // widest check row a thread holds in registers

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the storage type T and read back as float (round to nearest
// even for bf16): the value a store_f followed by a load_f gives.
template <typename T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// phi(x) = -log(tanh(x/2)), two regimes split at 10 (ops/boxplus.phi_llr).
__device__ __forceinline__ float phi_llr(float x, float tiny) {
  x = fmaxf(x, tiny);
  const float ex = expf(-fmaxf(x, 10.0f));
  const float big = log1pf(ex) - log1pf(-ex);
  const float small = -logf(tanhf(fminf(x, 10.0f) / 2.0f));
  return x < 10.0f ? small : big;
}

// phi_llr evaluating only the regime x takes: the same function on the same
// input, so the same bits, at about half the instructions.  The _rn
// intrinsics keep the compiler from contracting the halving or the
// difference into a neighbouring operation of the caller.
__device__ __forceinline__ float phi_llr_branch(float x, float tiny) {
  x = fmaxf(x, tiny);
  if (x < 10.0f) return -logf(tanhf(__fmul_rn(x, 0.5f)));
  const float ex = expf(-x);
  return __fsub_rn(log1pf(ex), log1pf(-ex));
}

// tanh-F/B output of a degree-1 check (empty product, u = 1), as the plain
// version computes it in float64 and rounds to f32.
inline float tanh_saturation() {
  return (float)(std::log1p(1.0 - 6e-8) - std::log1p(-(1.0 - 6e-8)));
}

// All-but-one magnitudes of v[0..dc) by `rule`, into mag[0..dc).
//   kMinSum: max(alpha * min over the other slots - beta, 0), tie-correct
//            (the unique argmin slot sees the second minimum);
//   kTanhFB: log((Q+P) / max(Q-P, 6e-8 Q)) with P, Q the all-but-one
//            products of (1 - e^-|v|) and (1 + e^-|v|) by serial
//            forward/backward chains (ops/boxplus.fb_allbutone_list);
//   kPhi:    phi(left-fold sum of phi(|v|) - phi(|v_d|)).
template <int MAXD>
__device__ __forceinline__ void check_magnitudes(const float (&v)[MAXD],
                                                 int dc, int rule, float tiny,
                                                 float alpha, float beta,
                                                 float tanh_sat,
                                                 float (&mag)[MAXD]) {
  if (rule == kMinSum) {
    float m1 = INFINITY;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < dc) m1 = fminf(m1, fabsf(v[d]));
    int cnt = 0;
    float m2 = INFINITY;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        const bool is_min = fabsf(v[d]) == m1;
        cnt += is_min;
        m2 = fminf(m2, is_min ? 1e30f : fabsf(v[d]));
      }
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        const float m = (fabsf(v[d]) == m1 && cnt == 1) ? m2 : m1;
        float scaled = __fmul_rn(alpha, m);
        if (beta != 0.0f) scaled = fmaxf(__fsub_rn(scaled, beta), 0.0f);
        mag[d] = scaled;
      }
    }
  } else if (rule == kTanhFB) {
    if (dc == 1) {
      mag[0] = tanh_sat;
      return;
    }
    float pm[MAXD], qm[MAXD], fp[MAXD], fq[MAXD], bp[MAXD], bq[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        const float e = expf(-fabsf(v[d]));
        pm[d] = 1.0f - e;
        qm[d] = 1.0f + e;
        const int dp = d > 0 ? d - 1 : 0;
        fp[d] = d == 0 ? pm[0] : __fmul_rn(fp[dp], pm[d]);
        fq[d] = d == 0 ? qm[0] : __fmul_rn(fq[dp], qm[d]);
      }
    }
#pragma unroll
    for (int d = MAXD - 1; d >= 0; --d) {
      if (d < dc) {
        const int dn = d + 1 < MAXD ? d + 1 : d;
        bp[d] = d == dc - 1 ? pm[d] : __fmul_rn(bp[dn], pm[d]);
        bq[d] = d == dc - 1 ? qm[d] : __fmul_rn(bq[dn], qm[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        const int dp = d > 0 ? d - 1 : 0;
        const int dn = d + 1 < MAXD ? d + 1 : d;
        float P, Q;
        if (d == 0) {
          P = bp[1 < MAXD ? 1 : 0];
          Q = bq[1 < MAXD ? 1 : 0];
        } else if (d == dc - 1) {
          P = fp[dp];
          Q = fq[dp];
        } else {
          P = __fmul_rn(fp[dp], bp[dn]);
          Q = __fmul_rn(fq[dp], bq[dn]);
        }
        mag[d] = logf((Q + P) / fmaxf(Q - P, __fmul_rn(6e-8f, Q)));
      }
    }
  } else {
    float sum = 0.0f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        mag[d] = phi_llr(fabsf(v[d]), tiny);
        sum += mag[d];
      }
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < dc) mag[d] = phi_llr(sum - mag[d], tiny);
  }
}

// The phi magnitudes of a padded row, slot d real when m[d] > 0 (the
// generic decoder's mask, any float): phi(|v|) * m, then the left-fold sum.
// Padded slots' magnitudes are finite, and the caller multiplies them by m.
template <int MAXD>
__device__ __forceinline__ void masked_phi_magnitudes(const float (&v)[MAXD],
                                                      const float (&m)[MAXD],
                                                      int dc, float tiny,
                                                      float (&mag)[MAXD]) {
  float sum = 0.0f;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d < dc) {
      mag[d] = __fmul_rn(phi_llr(fabsf(v[d]), tiny), m[d]);
      sum += mag[d];
    }
  }
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < dc) mag[d] = phi_llr(sum - mag[d], tiny);
}

// The signed message of slot d: (sign * prefactor) * magnitude, where the
// sign is (-1)^(parity of all v<0 xor v_d<0) and the prefactor (1 - 2 synd).
__device__ __forceinline__ float signed_message(int vpar, float v_d,
                                                float pref, float mag_d) {
  const float sg = (float)(1 - 2 * (vpar ^ (v_d < 0.0f)));
  return __fmul_rn(sg * pref, mag_d);
}

// Per-frame violation counts of a (kBT x kJT) block: each thread's count is
// summed over threadIdx.y in shared memory and added to counts[b] with one
// integer atomicAdd per (block, frame).  Integer atomics are order-free, so
// the result is deterministic.  Every thread of the block must call it.
template <int kBT, int kJT>
__device__ __forceinline__ void add_block_counts(int count, int b, int B,
                                                 int32_t* counts) {
  __shared__ int red[kJT][kBT];
  red[threadIdx.y][threadIdx.x] = count;
  __syncthreads();
  if (threadIdx.y == 0 && b < B) {
    int sum = 0;
#pragma unroll
    for (int y = 0; y < kJT; ++y) sum += red[y][threadIdx.x];
    if (sum) atomicAdd(counts + b, sum);
  }
}

// One thread per frame: a frame whose violation count is 0 has converged;
// a newly converged frame records `it` in iters; done |= converged; the
// count is reset to 0 for the next step.
__global__ void bookkeeping_kernel(int32_t* __restrict__ viol,
                                   int32_t* __restrict__ done,
                                   int32_t* __restrict__ iters, int B,
                                   int it) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (viol[b] == 0) {
    if (!done[b]) iters[b] = it;
    done[b] = 1;
  }
  viol[b] = 0;
}

inline void launch_bookkeeping(int32_t* viol, int32_t* done, int32_t* iters,
                               int B, int it, cudaStream_t stream) {
  bookkeeping_kernel<<<(B + 127) / 128, 128, 0, stream>>>(viol, done, iters,
                                                          B, it);
}

}  // namespace bp
