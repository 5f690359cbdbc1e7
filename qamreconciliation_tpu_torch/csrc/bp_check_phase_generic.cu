// Check phase of the generic (expanded edge list) flooding BP decoder, for
// Hopper (sm_90a).  Replaces two Pallas TPU kernels of
// qamreconciliation_tpu/ops/pallas_kernels.py:
//   bp_check_phase_generic    the fused check phase in the slot-major
//                             [dc, C, B] layout, with padded-slot masking:
//                             bp_check_phase_generic_launch, on the
//                             staged-tile pipeline of bp_check_tile.cuh;
//   check_node_update_pallas  (body _kernel) the unfused phi check update
//                             in the check-major [C, dc, B] layout:
//                             check_node_update_launch, the per-thread
//                             body below (float32, no c2v input, no
//                             convergence output; no decode path launches
//                             it).
//
// The check phase, frames innermost:
//   t     [dc, C, B] gathered variable totals (f32 or bf16)
//   c2v   [dc, C, B] previous check->variable messages in t's dtype
//   synd  [C, B] syndrome bits, int32 0/1
//   mask  float32 [dc, C]: > 0 marks a real slot (any float; the kernel
//         reads it per slot and derives no degree)
//   out   [dc, C, B] new messages, in t's dtype (round to nearest even for
//         bf16)
//   viol  [n, B] int32, n = ceil(C / 64) check blocks: per (check block,
//         frame) the count of checks whose parity of t<0 over the real
//         slots ((int)mask weights, as the JAX kernel's int cast) differs
//         from synd; must be zeroed by the caller.  A frame has converged
//         when its column sums to 0.
// Per (c, b): v = t - c2v in f32 (bf16 upcast once at load), the
// all-but-one magnitude over the real slots by one of three rules (phi
// multiplies by the mask, min-sum and tanh-F/B select the +1e30 sentinel),
// the sign parity of v<0 over the real slots, the (1 - 2*synd) prefactor,
// and the product with the mask: ((sign * pref) * mag) * mask, as the plain
// version (ops/kernels.py:bp_check_phase_generic_ref) rounds it.
//
// The check-major update takes v2c [C, dc, B], synd [C, B] and the mask
// [C, dc], and writes out [C, dc, B]: the phi magnitudes of the same
// contract, with v = v2c.
//
// Bound: memory.  At the DVB-S2 rate-1/2 shape [7, 32400, 128] in f32 a
// check phase reads t, c2v, synd and the mask and writes out, 366 MB, 0.109
// ms at 3.35 TB/s; f32 phi adds two transcendental chains per slot.  The
// check phase runs on the staged tiles of bp_check_tile.cuh (one check
// group of C checks, violation rows of 64 checks, the mask staged per
// tile).  The check-major update keeps the first design: one thread per
// (check, frame) with the frame innermost, the slots in registers (MAXD 8,
// or 32 for rows up to 32 wide), the mask read per slot.

#include "bp_check_tile.cuh"

namespace {

using namespace bp;

constexpr int kBT = 32;    // frames per block (threadIdx.x)
constexpr int kCT = 8;     // checks per pass (threadIdx.y)
constexpr int kCLOOP = 8;  // passes per block: a block covers 64 checks
// checks per violation block; ops/kernels.py GENERIC_BLOCK_C must match
constexpr int kChecksPerBlock = kCT * kCLOOP;

template <int MAXD>
__global__ void __launch_bounds__(kBT * kCT)
check_major_phi_kernel(const float* __restrict__ v2c,
                       const int32_t* __restrict__ synd,
                       const float* __restrict__ mask, float* __restrict__ out,
                       int dc, int C, int B, float tiny) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int c0 = blockIdx.y * kChecksPerBlock;
  if (b >= B) return;
  for (int k = 0; k < kCLOOP; ++k) {
    const int c = c0 + k * kCT + threadIdx.y;
    if (c >= C) break;
    const long long base = (long long)c * dc * B + b;
    const float* mrow = mask + (long long)c * dc;
    const int s = synd[(long long)c * B + b];

    // load, and the sign parity of v<0 over the real slots
    float v[MAXD], m[MAXD];
    int vpar = 0;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        m[d] = mrow[d];
        v[d] = v2c[base + (long long)d * B];
        vpar ^= (v[d] < 0.0f && m[d] > 0.0f);
      }
    }

    float mag[MAXD];
    masked_phi_magnitudes<MAXD>(v, m, dc, tiny, mag);

    // ((sign * prefactor) * magnitude) * mask
    const float pref = (float)(1 - 2 * s);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        const int neg = v[d] < 0.0f && m[d] > 0.0f;
        const float sg = (float)(1 - 2 * (vpar ^ neg));
        out[base + (long long)d * B] =
            __fmul_rn(__fmul_rn(sg * pref, mag[d]), m[d]);
      }
    }
  }
}

}  // namespace

// The check-major update (kernel 5): launch on `stream`; returns
// cudaGetLastError() after the launch (0 = ok), or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int check_node_update_launch(const void* v2c, const void* synd,
                                        const void* mask, void* out, int dc,
                                        int C, int B, float tiny,
                                        void* stream) {
  if (dc < 1 || dc > kMaxDc || C < 1 || B < 1 ||
      (C + kChecksPerBlock - 1) / kChecksPerBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBT, kCT);
  const dim3 grid((B + kBT - 1) / kBT,
                  (C + kChecksPerBlock - 1) / kChecksPerBlock);
  const float* vp = static_cast<const float*>(v2c);
  const int32_t* sp = static_cast<const int32_t*>(synd);
  const float* mp = static_cast<const float*>(mask);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dc <= 8)
    check_major_phi_kernel<8><<<grid, block, 0, s>>>(vp, sp, mp, op, dc, C,
                                                     B, tiny);
  else
    check_major_phi_kernel<kMaxDc><<<grid, block, 0, s>>>(vp, sp, mp, op, dc,
                                                          C, B, tiny);
  return (int)cudaGetLastError();
}

// The slot-major check phase on staged tiles, with the plan of
// ops/kernels.py check_tile_plan (checks and frames per tile, stages, bulk
// path, grid, blocks an SM, shared memory); returns cudaGetLastError()
// after the launch (0 = ok), or cudaErrorInvalidValue for arguments or a
// plan the kernel does not take.  The mask is [dc, C] float32; viol
// [ceil(C / 64), B].
extern "C" int bp_check_phase_generic_launch(
    const void* t, const void* c2v, const void* synd, const void* mask,
    void* out, void* viol, int dtype, int dc, int C, int B, int rule,
    float tiny, float alpha, float beta, int kt, int bB, int stages,
    int bulk, int grid, int blocks_per_sm, int smem, void* stream) {
  if (dc < 1 || dc > kMaxDc || C < 1 || B < 1 || rule < kPhi ||
      rule > kMinSum)
    return (int)cudaErrorInvalidValue;
  const TileShape sh{1, dc, C, B, kt, bB, stages, bulk, kChecksPerBlock};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(mask);
  if (dtype == kF32)
    return launch_check_tiles<float, float, true>(
        t, c2v, synd, mp, out, viol, sh, grid, blocks_per_sm, smem, rule,
        tiny, alpha, beta, s);
  if (dtype == kBF16)
    return launch_check_tiles<__nv_bfloat16, __nv_bfloat16, true>(
        t, c2v, synd, mp, out, viol, sh, grid, blocks_per_sm, smem, rule,
        tiny, alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}
