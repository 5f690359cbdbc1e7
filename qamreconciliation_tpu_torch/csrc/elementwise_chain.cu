// Kernel 7: the packed-bf16 elementwise probe, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel of scripts/probe_bf16pack.py (`make(mode,
// dtype).run`, body `kernel`): `iters * chain` elementwise steps on an array
// held on chip, in float32 or bfloat16, to tell whether the card runs bf16
// two elements an instruction.
//
//   x   [n] f32 or bf16 (any shape, contiguous), read once
//   out [n] the same dtype, written once
// Each step is, with a = 1 - 2^-8 and b = 2^-6 (both exact in bf16),
//   mac (mode 0): x = x * a + b
//   exp (mode 1): x = exp(-|x|) * a + x * b
// and every operation rounds to the dtype: a product and a sum are two
// roundings (no FMA contraction: __fmul_rn/__fadd_rn in f32, mul.rn.bf16x2
// and add.rn.bf16x2 in bf16), exp is f32 expf of the widened value, rounded
// to nearest even.  The plain version is ops/kernels.py:elementwise_chain_ref
// (one PyTorch operation at a time, each rounding to the dtype); the
// results are bit-identical to it.
//
// Bound: operations.  The array is a few MB, read and written once; the
// steps are rows * cols * iters * chain * (2 for mac, 5 for exp) operations
// at the card's f32 rate, or at its packed bf16 rate (two elements an
// instruction).
// Design: one thread owns 16 bytes of the array (4 f32, or 8 bf16 as four
// __nv_bfloat162 words) in registers for all the steps: four independent
// chains a thread, one 16-byte load and one 16-byte store.  The bf16 steps
// are written in PTX as packed bf16x2 instructions, so what the card runs is
// stated here.  Elements past the last whole 16 bytes (or every element,
// when a pointer is not 16-byte aligned) take one thread each, on the same
// instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kA = 0.99609375f;  // 1 - 2^-8
constexpr float kB = 0.015625f;    // 2^-6

enum Mode { kMac = 0, kExp = 1 };
enum DType { kF32 = 0, kBF16 = 1 };

template <int MODE>
__device__ __forceinline__ float step_f32(float x) {
  if (MODE == kMac) return __fadd_rn(__fmul_rn(x, kA), kB);
  return __fadd_rn(__fmul_rn(expf(-fabsf(x)), kA), __fmul_rn(x, kB));
}

// packed bf16x2 arithmetic on the two halves of a 32-bit word
__device__ __forceinline__ uint32_t mul2(uint32_t x, uint32_t y) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(y));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t x, uint32_t y) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(y));
  return d;
}
// exp(-|x|) of both halves: widened to f32 (exact), expf, rounded back
__device__ __forceinline__ uint32_t exp_negabs2(uint32_t x) {
  const float lo = __uint_as_float(x << 16);
  const float hi = __uint_as_float(x & 0xffff0000u);
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;"
      : "=r"(d)
      : "f"(expf(-fabsf(hi))), "f"(expf(-fabsf(lo))));
  return d;
}

constexpr uint32_t kA2 = 0x3f7f3f7fu;  // bf16x2 (a, a)
constexpr uint32_t kB2 = 0x3c803c80u;  // bf16x2 (b, b)

template <int MODE>
__device__ __forceinline__ uint32_t step_bf16x2(uint32_t x) {
  if (MODE == kMac) return add2(mul2(x, kA2), kB2);
  return add2(mul2(exp_negabs2(x), kA2), mul2(x, kB2));
}

// Threads [0, nvec) own 16 bytes each; threads [nvec, nvec + tail) one
// element each of the `tail` elements after them.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
chain_f32(const float* __restrict__ x, float* __restrict__ out,
          long long nvec, long long tail, long long steps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
#pragma unroll 4
    for (long long s = 0; s < steps; ++s) {
      v.x = step_f32<MODE>(v.x);
      v.y = step_f32<MODE>(v.y);
      v.z = step_f32<MODE>(v.z);
      v.w = step_f32<MODE>(v.w);
    }
    reinterpret_cast<float4*>(out)[i] = v;
  } else if (i < nvec + tail) {
    const long long e = 4 * nvec + (i - nvec);
    float v = x[e];
#pragma unroll 4
    for (long long s = 0; s < steps; ++s) v = step_f32<MODE>(v);
    out[e] = v;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
chain_bf16(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
           long long nvec, long long tail, long long steps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    uint4 v = reinterpret_cast<const uint4*>(x)[i];
#pragma unroll 4
    for (long long s = 0; s < steps; ++s) {
      v.x = step_bf16x2<MODE>(v.x);
      v.y = step_bf16x2<MODE>(v.y);
      v.z = step_bf16x2<MODE>(v.z);
      v.w = step_bf16x2<MODE>(v.w);
    }
    reinterpret_cast<uint4*>(out)[i] = v;
  } else if (i < nvec + tail) {
    // the element in both halves, the low half kept
    const long long e = 8 * nvec + (i - nvec);
    uint32_t v = (uint32_t)x[e] * 0x10001u;
#pragma unroll 4
    for (long long s = 0; s < steps; ++s) v = step_bf16x2<MODE>(v);
    out[e] = (uint16_t)(v & 0xffffu);
  }
}

template <int MODE>
int launch_mode(const void* x, void* out, int dtype, long long n,
                long long steps, cudaStream_t stream) {
  const int per = dtype == kF32 ? 4 : 8;  // elements in 16 bytes
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long nvec = aligned ? n / per : 0;
  const long long tail = n - nvec * per;
  const long long threads = nvec + tail;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    chain_f32<MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(out), nvec, tail,
        steps);
  else
    chain_bf16<MODE><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), nvec,
        tail, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// out = `iters * chain` steps of `mode` (0 mac, 1 exp) on the `n` elements
// of x (`dtype` 0 f32, 1 bf16), launched on `stream`.  Returns
// cudaGetLastError() after the launch (0 = ok), or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int elementwise_chain_launch(const void* x, void* out, int dtype,
                                        long long n, int mode, int iters,
                                        int chain, void* stream) {
  if (n < 1 || iters < 0 || chain < 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const long long steps = (long long)iters * chain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kMac) return launch_mode<kMac>(x, out, dtype, n, steps, s);
  if (mode == kExp) return launch_mode<kExp>(x, out, dtype, n, steps, s);
  return (int)cudaErrorInvalidValue;
}
