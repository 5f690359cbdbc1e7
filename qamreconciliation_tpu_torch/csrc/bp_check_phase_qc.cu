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
// the slots, and the result is bit-identical to it.
//
// Bound: memory.  Per call the kernel reads t, c2v and synd and writes out:
// at the headline shape [90, 6, 360, 128] in f32 that is ~315 MB, ~0.094 ms
// at the H100's 3.35 TB/s; f32 phi adds two transcendental chains per slot.
// Design: the staged-tile pipeline of bp_check_tile.cuh, with the nb_c block
// rows as its check groups (R = z rows each) and one violation row per block
// row; tiles of a few circulant rows by the frames, TMA bulk copies into a
// ring of stages, slots read from shared memory, 16-byte stores.

#include "bp_check_tile.cuh"

namespace {

using namespace bp;

template <typename TT, typename TM>
int launch_typed(const void* t, const void* c2v, const void* synd, void* out,
                 void* viol, const TileShape& sh, int grid, int blocks,
                 int smem, int rule, float tiny, float alpha, float beta,
                 cudaStream_t stream) {
  return launch_check_tiles<TT, TM, false>(t, c2v, synd, nullptr, out, viol,
                                           sh, grid, blocks, smem, rule, tiny,
                                           alpha, beta, stream);
}

}  // namespace

// Launch on `stream` with the plan of ops/kernels.py check_tile_plan
// (checks and frames per tile, stages, bulk path, grid, blocks an SM,
// shared memory);
// returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments or a plan the kernel does not take.
extern "C" int bp_check_phase_qc_launch(
    const void* t, const void* c2v, const void* synd, void* out, void* viol,
    int t_dtype, int m_dtype, int nb_c, int dc, int z, int B, int rule,
    float tiny, float alpha, float beta, int kt, int bB, int stages,
    int bulk, int grid, int blocks_per_sm, int smem, void* stream) {
  if (dc < 1 || dc > kMaxDc || nb_c < 1 || z < 1 || B < 1 || rule < kPhi ||
      rule > kMinSum)
    return (int)cudaErrorInvalidValue;
  const TileShape sh{nb_c, dc, z, B, kt, bB, stages, bulk, z};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == kF32 && m_dtype == kF32)
    return launch_typed<float, float>(t, c2v, synd, out, viol, sh, grid,
                                      blocks_per_sm, smem, rule, tiny, alpha,
                                      beta, s);
  if (t_dtype == kBF16 && m_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        t, c2v, synd, out, viol, sh, grid, blocks_per_sm, smem, rule, tiny,
        alpha, beta, s);
  if (t_dtype == kF32 && m_dtype == kBF16)
    return launch_typed<float, __nv_bfloat16>(t, c2v, synd, out, viol, sh,
                                              grid, blocks_per_sm, smem, rule,
                                              tiny, alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}
