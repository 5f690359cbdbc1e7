// Check phase of the generic (expanded edge list) flooding BP decoder, for
// Hopper (sm_90a).  Replaces two Pallas TPU kernels of
// qamreconciliation_tpu/ops/pallas_kernels.py:
//   bp_check_phase_generic    the fused check phase in the slot-major
//                             [dc, C, B] layout, with padded-slot masking;
//   check_node_update_pallas  (body _kernel) the unfused phi check update
//                             in the check-major [C, dc, B] layout: run here
//                             as a mode of the same kernel (no c2v input, no
//                             convergence output, phi rule, float32).
//
// Inputs, frames innermost; element (d, c, b) of t, c2v and out lies at
// c * check_stride + d * slot_stride + b, so one body serves both layouts
// ([dc, C, B]: slot stride C*B, check stride B; [C, dc, B]: slot stride B,
// check stride dc*B):
//   t     gathered variable totals (f32 or bf16), or the v2c messages when
//         c2v is null
//   c2v   previous check->variable messages in t's dtype, or null
//   synd  [C, B] syndrome bits, int32 0/1
//   mask  float32, slot d of check c at c * mask_check_stride +
//         d * mask_slot_stride: > 0 marks a real slot (any float; the
//         kernel reads it per slot and derives no degree)
// Outputs:
//   out   new messages, in t's dtype (round to nearest even for bf16)
//   viol  [n, B] int32, n = ceil(C / 64) check blocks, or null: per (check
//         block, frame) the count of checks whose parity of t<0 over the
//         real slots ((int)mask weights, as the JAX kernel's int cast)
//         differs from synd; must be zeroed by the caller.  A frame has
//         converged when its column sums to 0.
//
// Per (c, b): v = t - c2v in f32 (bf16 upcast once at load), the
// all-but-one magnitude over the real slots by one of three rules
// (bp_common.cuh masked_check_magnitudes: phi multiplies by the mask, min-sum
// and tanh-F/B select the +1e30 sentinel), the sign parity of v<0 over the
// real slots, the (1 - 2*synd) prefactor, and the product with the mask:
// ((sign * pref) * mag) * mask, as the plain version
// (ops/kernels.py:bp_check_phase_generic_ref) rounds it.
//
// Bound: memory.  At the DVB-S2 rate-1/2 shape [7, 32400, 128] in f32 a
// call reads t and c2v and writes out, ~350 MB, ~0.1 ms at 3.35 TB/s.
// Design: one thread per (check, frame) with the frame innermost, so a
// warp reads each slot as one coalesced row of 32 frames in both layouts;
// the slots of a check stay in registers (MAXD 8, or 32 for rows up to 32
// wide); the mask is read per slot (one address per warp, a broadcast);
// violations are summed over the checks a thread visits, then over the
// block in shared memory, then added with one integer atomicAdd per
// (block, frame).

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kBT = 32;    // frames per block (threadIdx.x)
constexpr int kCT = 8;     // checks per pass (threadIdx.y)
constexpr int kCLOOP = 8;  // passes per block: a block covers 64 checks
// checks per violation block; ops/kernels.py GENERIC_BLOCK_C must match
constexpr int kChecksPerBlock = kCT * kCLOOP;

template <typename T, int MAXD>
__global__ void __launch_bounds__(kBT * kCT)
generic_check_kernel(const T* __restrict__ t, const T* __restrict__ c2v,
                     const int32_t* __restrict__ synd,
                     const float* __restrict__ mask, T* __restrict__ out,
                     int32_t* __restrict__ viol, int dc, int C, int B,
                     long long slot_stride, long long check_stride,
                     long long mask_slot_stride, long long mask_check_stride,
                     int rule, float tiny, float alpha, float beta,
                     float tanh_sat) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int c0 = blockIdx.y * kChecksPerBlock;
  int nviol = 0;

  if (b < B) {
    for (int k = 0; k < kCLOOP; ++k) {
      const int c = c0 + k * kCT + threadIdx.y;
      if (c >= C) break;
      const long long base = (long long)c * check_stride + b;
      const float* mrow = mask + (long long)c * mask_check_stride;
      const int s = synd[(long long)c * B + b];

      // load: parity of t<0 over the real slots, v = t - c2v, and the
      // sign parity of v<0 over the real slots
      float v[MAXD], m[MAXD];
      int tneg = 0, vpar = 0;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < dc) {
          m[d] = mrow[d * mask_slot_stride];
          const float td = load_f(t + base + d * slot_stride);
          tneg += (td < 0.0f) * (int)m[d];
          v[d] = c2v ? td - load_f(c2v + base + d * slot_stride) : td;
          vpar ^= (v[d] < 0.0f && m[d] > 0.0f);
        }
      }
      nviol += ((tneg & 1) != s);

      float mag[MAXD];
      masked_check_magnitudes<MAXD>(v, m, dc, rule, tiny, alpha, beta,
                                    tanh_sat, mag);

      // ((sign * prefactor) * magnitude) * mask, stored in t's dtype
      const float pref = (float)(1 - 2 * s);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < dc) {
          const int neg = v[d] < 0.0f && m[d] > 0.0f;
          const float sg = (float)(1 - 2 * (vpar ^ neg));
          store_f(out + base + d * slot_stride,
                  __fmul_rn(__fmul_rn(sg * pref, mag[d]), m[d]));
        }
      }
    }
  }

  if (viol) add_block_counts<kBT, kCT>(nviol, b, B, viol + blockIdx.y * B);
}

template <typename T>
void launch_typed(const void* t, const void* c2v, const void* synd,
                  const float* mask, void* out, void* viol, int dc, int C,
                  int B, long long ss, long long cs, long long mss,
                  long long mcs, int rule, float tiny, float alpha,
                  float beta, cudaStream_t stream) {
  const float tanh_sat = tanh_saturation();
  const dim3 block(kBT, kCT);
  const dim3 grid((B + kBT - 1) / kBT,
                  (C + kChecksPerBlock - 1) / kChecksPerBlock);
  const T* tp = static_cast<const T*>(t);
  const T* cp = static_cast<const T*>(c2v);
  const int32_t* sp = static_cast<const int32_t*>(synd);
  T* op = static_cast<T*>(out);
  int32_t* vp = static_cast<int32_t*>(viol);
  if (dc <= 8) {
    generic_check_kernel<T, 8><<<grid, block, 0, stream>>>(
        tp, cp, sp, mask, op, vp, dc, C, B, ss, cs, mss, mcs, rule, tiny,
        alpha, beta, tanh_sat);
  } else {
    generic_check_kernel<T, kMaxDc><<<grid, block, 0, stream>>>(
        tp, cp, sp, mask, op, vp, dc, C, B, ss, cs, mss, mcs, rule, tiny,
        alpha, beta, tanh_sat);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue for arguments the kernel does not take.  c2v and
// viol may be null (the check-major update mode); strides are in elements.
extern "C" int bp_check_phase_generic_launch(
    const void* t, const void* c2v, const void* synd, const void* mask,
    void* out, void* viol, int dtype, int dc, int C, int B,
    long long slot_stride, long long check_stride, long long mask_slot_stride,
    long long mask_check_stride, int rule, float tiny, float alpha,
    float beta, void* stream) {
  if (dc < 1 || dc > kMaxDc || C < 1 || B < 1 || rule < kPhi ||
      rule > kMinSum || (C + kChecksPerBlock - 1) / kChecksPerBlock > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(mask);
  if (dtype == kF32) {
    launch_typed<float>(t, c2v, synd, mp, out, viol, dc, C, B, slot_stride,
                        check_stride, mask_slot_stride, mask_check_stride,
                        rule, tiny, alpha, beta, s);
  } else if (dtype == kBF16) {
    launch_typed<__nv_bfloat16>(t, c2v, synd, mp, out, viol, dc, C, B,
                                slot_stride, check_stride, mask_slot_stride,
                                mask_check_stride, rule, tiny, alpha, beta,
                                s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
