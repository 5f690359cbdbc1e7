// Device math shared by the BP kernels: loads and stores in the message
// dtype, rounding to the storage type, phi(x) = -log(tanh(x/2)) (the
// branching form that evaluates only the regime taken, in float32 or with
// every operation rounded to the message dtype), and the tanh-F/B saturation
// of a degree-1 check.  Users: bp_check_tile.cuh (kernels 1 and 4, through
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

// kProbeCopy and kProbeMinSum are the attribution probe's slot maths
// (check_math_probe.cu), which no decoder offers
enum Rule { kPhi = 0, kTanhFB = 1, kMinSum = 2, kProbeCopy = 3,
            kProbeMinSum = 4 };
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

// phi(x) = -log(tanh(x/2)) as ops/boxplus.phi_llr computes it in float32
// (two regimes split at 10), evaluating only the regime x takes: the same
// function on the same input, so the same bits, at about half the
// instructions.  The _rn intrinsics keep the compiler from contracting the
// halving or the difference into a neighbouring operation of the caller.
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

// phi_llr_branch in the message dtype T, in three parts: ops/boxplus.phi_llr
// run on T tensors rounds every operation's float result to T (the clamp;
// tanh and log; exp, log1p and their difference), and so do these.  For
// float they are phi_llr_branch.  phi_small is the regime x < 10 and is
// finite for any x >= 0, so a caller can run it on several values in
// lockstep, with no branch between their chains, and replace the result by
// phi_large only where x >= 10.
template <typename T>
__device__ __forceinline__ float phi_clamp(float x, float tiny) {
  return round_as<T>(fmaxf(x, tiny));
}

template <typename T>
__device__ __forceinline__ float phi_small(float x) {
  return -round_as<T>(logf(round_as<T>(tanhf(__fmul_rn(x, 0.5f)))));
}

template <typename T>
__device__ __forceinline__ float phi_large(float x) {
  const float ex = round_as<T>(expf(-x));
  return round_as<T>(
      __fsub_rn(round_as<T>(log1pf(ex)), round_as<T>(log1pf(-ex))));
}

}  // namespace bp
