// Kernel 6: the check-math attribution probe, for Hopper (sm_90a).  Replaces
// the Pallas TPU kernel of scripts/probe_check_math.py (`phase`, body
// `kernel`), which runs the fused QC check phase's memory pattern with one
// of three slot maths to tell whether that phase is bound by its arithmetic
// or by its bytes.
//
// Inputs and outputs as kernel 1's (bp_check_phase_qc.cu), with t, c2v and
// out in one dtype (f32 or bf16):
//   t    [nb_c, dc, z, B], c2v [nb_c, dc, z, B], synd [nb_c, z, B] int32
//   out  [nb_c, dc, z, B]  the slot math's result, in t's dtype
//   viol [nb_c, B]         int32 violated checks per (block row, frame);
//                          zeroed by the caller
// For each (cb, j, b), in f32: the parity of t<0 over the dc slots against
// synd (the violation count), v = t - c2v, and then by `math`
//   phi (kPhi):      kernel 1's phi sum-product (tiny 1e-30),
//   copy (kProbeCopy): out = v, with no sign and no prefactor,
//   minsum (kProbeMinSum): 0.8125 * (min2 for a slot at the minimum |v|,
//                    ties included, else the minimum), min2 the least |v|
//                    strictly above the minimum (1e30 if none), times the
//                    XOR sign parity and (1 - 2*synd).
// The result is stored in t's dtype (round to nearest even for bf16).  The
// plain version is ops/kernels.py:check_math_probe_ref; the results are
// bit-identical to it.
//
// Bound: memory.  Each call reads t, c2v and synd and writes out and viol:
// at the probe's shape [18, 6, 1800, 128] about 166 MB in bf16 and 315 MB in
// f32, 0.050 / 0.094 ms at the H100's 3.35 TB/s.  copy does no arithmetic
// beyond the subtraction, so its time is the floor of kernel 1's access
// pattern on this card.
// Design: kernel 1's own staged-tile loop (bp_check_tile.cuh: TMA bulk copies
// into a ring of stages, persistent blocks, 16-byte stores) and its launch
// plan (ops/kernels.py check_tile_plan), with the two extra maths as rules
// of that loop; neither needs scratch.

#include "bp_check_tile.cuh"

namespace {

using namespace bp;

template <typename T>
int launch_typed(const void* t, const void* c2v, const void* synd, void* out,
                 void* viol, const TileShape& sh, int grid, int blocks,
                 int smem, int math, cudaStream_t stream) {
  if (const int err = check_tile_plan_error<T, T, false>(
          t, c2v, synd, out, sh, grid, blocks, smem, math))
    return err;
  const float tiny = 1e-30f;
  if (math == kPhi)
    return launch_rule<T, T, false, kPhi>(t, c2v, synd, nullptr, out, viol,
                                          sh, grid, smem, tiny, 0.0f, 0.0f,
                                          stream);
  if (math == kProbeCopy)
    return launch_rule<T, T, false, kProbeCopy>(t, c2v, synd, nullptr, out,
                                                viol, sh, grid, smem, tiny,
                                                0.0f, 0.0f, stream);
  return launch_rule<T, T, false, kProbeMinSum>(t, c2v, synd, nullptr, out,
                                                viol, sh, grid, smem, tiny,
                                                0.0f, 0.0f, stream);
}

}  // namespace

// Launch on `stream` with the plan of ops/kernels.py check_tile_plan;
// `math` is kPhi, kProbeCopy or kProbeMinSum.  Returns cudaGetLastError()
// after the launch (0 = ok), or cudaErrorInvalidValue for arguments or a
// plan the kernel does not take.
extern "C" int check_math_probe_launch(
    const void* t, const void* c2v, const void* synd, void* out, void* viol,
    int dtype, int nb_c, int dc, int z, int B, int math, int kt, int bB,
    int stages, int bulk, int grid, int blocks_per_sm, int smem,
    void* stream) {
  if (dc < 1 || dc > kMaxDc || nb_c < 1 || z < 1 || B < 1 ||
      (math != kPhi && math != kProbeCopy && math != kProbeMinSum))
    return (int)cudaErrorInvalidValue;
  const TileShape sh{nb_c, dc, z, B, kt, bB, stages, bulk, z};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_typed<float>(t, c2v, synd, out, viol, sh, grid,
                               blocks_per_sm, smem, math, s);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16>(t, c2v, synd, out, viol, sh, grid,
                                       blocks_per_sm, smem, math, s);
  return (int)cudaErrorInvalidValue;
}
