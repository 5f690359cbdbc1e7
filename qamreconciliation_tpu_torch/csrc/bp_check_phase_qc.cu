// Fused check phase of the dense quasi-cyclic flooding BP decoder, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// qamreconciliation_tpu/ops/pallas_kernels.py:bp_check_phase_qc
// (body _check_phase_kernel).
//
// Inputs, frames innermost:
//   t    [nb_c, dc, z, B]  gathered variable totals (f32, or bf16)
//   c2v  [nb_c, dc, z, B]  previous check->variable messages (f32 or bf16)
//   synd [nb_c, z, B]      syndrome bits, int32 0/1
// Outputs:
//   out  [nb_c, dc, z, B]  new messages, in the message dtype (round to
//                          nearest even for bf16)
//   viol [nb_c, B]         int32 count of violated checks per (block row,
//                          frame); must be zeroed by the caller.  A frame has
//                          converged when its column sums to 0.
//
// For each (cb, j, b): the parity of t<0 over the dc slots against synd (the
// convergence test), v2c = t - c2v in f32 (bf16 upcast once at load), the
// all-but-one magnitude by one of three rules (phi sum-product, tanh
// forward/backward sum-product, normalized/offset min-sum), the XOR sign
// parity and the (1 - 2*synd) prefactor.  Operation order follows the plain
// version (ops/kernels.py:bp_check_phase_qc_ref): sums are left folds over
// the slots, min-sum is bit-identical to it.
//
// Bound: memory.  Per call the kernel reads t, c2v and synd and writes out:
// at the headline shape [90, 6, 360, 128] in f32 that is ~315 MB, ~0.09 ms at
// the H100's 3.35 TB/s.  The arithmetic is ~25M slots with about two phi
// evaluations each (a few hundred MFLOP of expf/logf/tanhf), well under the
// card's rate, so the kernel should sit near the memory floor.  Design: one
// thread per (cb, j, b) with b innermost, so each warp's loads and stores are
// 128 contiguous bytes per slot; the dc slots of a check stay in registers
// (the MAXD template bounds the unrolled arrays); violation bits are summed
// in registers over the rows a thread visits and in shared memory over the
// block, then added to viol with one integer atomicAdd per (block, frame).
// Integer atomics are order-free, so the result is deterministic.
//
// The magnitude rules, loads/stores and the block reduction live in
// bp_common.cuh, shared with the multi-iteration kernels.

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kBT = 32;    // frames per block (threadIdx.x)
constexpr int kJT = 8;     // circulant rows per pass (threadIdx.y)
constexpr int kJLOOP = 8;  // passes per block: a block covers 64 rows

template <typename TT, typename TM, int MAXD>
__global__ void __launch_bounds__(kBT * kJT)
check_phase_kernel(const TT* __restrict__ t, const TM* __restrict__ c2v,
                   const int32_t* __restrict__ synd, TM* __restrict__ out,
                   int32_t* __restrict__ viol, int dc, int z, int B, int rule,
                   float tiny, float alpha, float beta, float tanh_sat) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int cb = blockIdx.z;
  const int j0 = blockIdx.y * (kJT * kJLOOP);
  const long long slot = (long long)z * B;  // stride between slots d
  int nviol = 0;

  if (b < B) {
    for (int k = 0; k < kJLOOP; ++k) {
      const int j = j0 + k * kJT + threadIdx.y;
      if (j >= z) break;
      const long long base = ((long long)cb * dc * z + j) * B + b;
      const int s = synd[((long long)cb * z + j) * B + b];

      // load: convergence parity of t, v2c = t - c2v, sign parity of v2c
      float v[MAXD];
      int tpar = 0, vpar = 0;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < dc) {
          const float td = load_f(t + base + d * slot);
          tpar ^= (td < 0.0f);
          v[d] = td - load_f(c2v + base + d * slot);
          vpar ^= (v[d] < 0.0f);
        }
      }
      nviol += (tpar != s);

      float mag[MAXD];
      check_magnitudes<MAXD>(v, dc, rule, tiny, alpha, beta, tanh_sat, mag);

      // sign, syndrome prefactor, store in the message dtype
      const float pref = (float)(1 - 2 * s);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < dc) {
          store_f(out + base + d * slot,
                  signed_message(vpar, v[d], pref, mag[d]));
        }
      }
    }
  }

  add_block_counts<kBT, kJT>(nviol, b, B, viol + (long long)cb * B);
}

template <typename TT, typename TM>
void launch_typed(const void* t, const void* c2v, const void* synd, void* out,
                  void* viol, int nb_c, int dc, int z, int B, int rule,
                  float tiny, float alpha, float beta, cudaStream_t stream) {
  const float tanh_sat = tanh_saturation();
  const dim3 block(kBT, kJT);
  const dim3 grid((B + kBT - 1) / kBT, (z + kJT * kJLOOP - 1) / (kJT * kJLOOP),
                  nb_c);
  const TT* tp = static_cast<const TT*>(t);
  const TM* cp = static_cast<const TM*>(c2v);
  const int32_t* sp = static_cast<const int32_t*>(synd);
  TM* op = static_cast<TM*>(out);
  int32_t* vp = static_cast<int32_t*>(viol);
  if (dc <= 8) {
    check_phase_kernel<TT, TM, 8><<<grid, block, 0, stream>>>(
        tp, cp, sp, op, vp, dc, z, B, rule, tiny, alpha, beta, tanh_sat);
  } else {
    check_phase_kernel<TT, TM, kMaxDc><<<grid, block, 0, stream>>>(
        tp, cp, sp, op, vp, dc, z, B, rule, tiny, alpha, beta, tanh_sat);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int bp_check_phase_qc_launch(const void* t, const void* c2v,
                                        const void* synd, void* out,
                                        void* viol, int t_dtype, int m_dtype,
                                        int nb_c, int dc, int z, int B,
                                        int rule, float tiny, float alpha,
                                        float beta, void* stream) {
  if (dc < 1 || dc > kMaxDc || nb_c < 1 || nb_c > 65535 || z < 1 || B < 1 ||
      rule < kPhi || rule > kMinSum)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == kF32 && m_dtype == kF32) {
    launch_typed<float, float>(t, c2v, synd, out, viol, nb_c, dc, z, B, rule,
                               tiny, alpha, beta, s);
  } else if (t_dtype == kBF16 && m_dtype == kBF16) {
    launch_typed<__nv_bfloat16, __nv_bfloat16>(t, c2v, synd, out, viol, nb_c,
                                               dc, z, B, rule, tiny, alpha,
                                               beta, s);
  } else if (t_dtype == kF32 && m_dtype == kBF16) {
    launch_typed<float, __nv_bfloat16>(t, c2v, synd, out, viol, nb_c, dc, z,
                                       B, rule, tiny, alpha, beta, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
