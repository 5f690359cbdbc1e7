// Device math shared by the BP kernels: loads and stores in the message
// dtype, rounding to the storage type, phi(x) = -log(tanh(x/2)) (both
// regimes, and the branching form that evaluates only the regime taken), the
// tanh-F/B saturation of a degree-1 check, and the masked phi magnitudes of
// kernel 5.  Users: bp_check_tile.cuh (kernels 1 and 4, through
// bp_check_phase_qc.cu and bp_check_phase_generic.cu), bp_resident.cuh
// (kernels 2 and 3, through bp_decode_rounds_qc.cu and
// bp_layered_sweeps_qc.cu) and bp_check_phase_generic.cu (kernel 5).  Each
// function follows the operation order of the plain PyTorch versions in
// ops/kernels.py and ops/boxplus.py, so the kernels are bit-identical to
// them.
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

constexpr int kMaxDc = 32;  // widest check row: its sign bits fill one word

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

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

}  // namespace bp
