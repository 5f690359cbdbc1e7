// Kernel 9: the resident bookkeeping probe, for Hopper (sm_90a).  Replaces
// the Pallas TPU kernel of scripts/probe_resident_vmem.py (`build(...)`,
// body `kernel`, called by `step`): K normalized min-sum flooding
// iterations (alpha 0.8125) of a QC code in bf16, in four cumulative
// bookkeeping variants, so that the cost of each piece of the resident
// decoder's bookkeeping shows on its own:
//   nobook    (0) the check pass and the variable pass only;
//   violonly  (1) + the per-frame violation count (the parity of t < 0
//                 against synd), which nothing reads: the kernel stores it
//                 into viol[b] every iteration, or nvcc would delete it and
//                 the variant would time nobook again;
//   nocapture (2) + conv = viol == 0, newly = conv && !done, iters = it for
//                 a newly converged frame (it = it0 + k, 0-based), done |=
//                 conv;
//   full      (3) + in a newly converged frame, final = the totals before
//                 this iteration's variable pass.
//
// State, frames innermost, updated in place (all bf16 but the integers):
//   total [nb_v, z, B], c2v [E, z, B] (base edges flat in row order),
//   final [nb_v, z, B] (full only), done, iters, viol [B] int32.
// Read only: prior [nb_v, z, B] bf16, synd [nb_c, z, B] int8, and the tables
// of kernel 2 (row_off, edge_v, edge_s, col_off, col_e, col_s).
//
// Iteration it = it0 + k, k < n (the host computes n = max(min(K, maxiter -
// it0), 0)), per frame:
//   check pass: kernel 2's check_update<kMinSum> (bp_resident.cuh): the
//     rolled totals in f32, v2c = t - c2v, 0.8125 times the all-but-one
//     minimum (the unique argmin sees the others' minimum and its own 1e30
//     stand-in), (sign * prefactor) * magnitude rounded to bf16;
//   bookkeeping by variant, as above;
//   variable pass in EVERY frame (the probe has no freeze of converged
//     frames, unlike kernel 2): acc = bf16(c2v_0 + c2v_1), acc = bf16(acc +
//     c2v_2), ... over the block's edges in (row, slot) order, then total =
//     bf16(prior + acc): a bf16 left fold, each sum rounded, where kernel 2
//     folds in f32 and rounds once.
// The plain version is ops/kernels.py:resident_bookkeeping_probe_ref; every
// variant is bit-identical to it.
//
// Bound: at the probe's shape (nb_v 36, E 108, z 1800, B 128) a call must
// read totals, c2v, prior and synd and write totals and c2v once, 153 MB,
// and each iteration runs 12 f32 operations a slot (24.9 million slots), so
// a K = 8 call is bound by its operations (0.0089 ms an iteration at the
// f32 rate) over its bytes (0.0057 ms an iteration); an iteration that
// streams the state from device memory takes 0.046 ms.  Design: kernel 2's
// (bp_resident.cuh): the state copied once per call into frame-major
// scratch, one launch running the K iterations with a persistent block
// owning a frame, the frame's totals in shared memory where the launch plan
// (ops/kernels.py resident_plan, min-sum) fits them, the slots in a
// shared-memory scratch column per thread, the violation count a block
// reduction.  The variant is a template argument, so each instance holds
// only its own bookkeeping.

#include "bp_resident.cuh"

namespace {

using namespace bp;
using bf16 = __nv_bfloat16;

enum Variant { kNoBook = 0, kViolOnly = 1, kNoCapture = 2, kFull = 3 };

template <int VARIANT, bool TSH>
__global__ void __launch_bounds__(kResThreadsMax, 1)
bookkeeping_kernel(bf16* __restrict__ tot, bf16* __restrict__ c2v,
                   const bf16* __restrict__ prior,
                   const int8_t* __restrict__ synd, bf16* __restrict__ fin,
                   int32_t* __restrict__ done, int32_t* __restrict__ iters,
                   int32_t* __restrict__ viol, Rows rw, Cols cl, ResShape sh,
                   int it0, int n, float alpha) {
  extern __shared__ __align__(16) char smem[];
  const int nthr = blockDim.x, tid = threadIdx.x, z = sh.z;
  const ResLayout L = res_layout(sh, 2, res_scratch(kMinSum, false), nthr);
  float* sc = reinterpret_cast<float*>(smem + L.scr) + tid;
  const int qs = sh.dc_max * nthr;
  // violations, done, newly converged this iteration
  int* red = reinterpret_cast<int*>(smem + L.red);
  const long long NV = (long long)sh.nb_v * z, NE = (long long)sh.E * z,
                  NC = (long long)sh.nb_c * z;

  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    bf16* T = TSH ? reinterpret_cast<bf16*>(smem + L.tot) : tot + b * NV;
    bf16* C = c2v + b * NE;
    const bf16* P = prior + b * NV;
    const int8_t* S = synd + b * NC;
    bf16* F = VARIANT == kFull ? fin + b * NV : nullptr;
    if (TSH) block_copy(T, tot + b * NV, NV * sizeof(bf16));
    int it_b = 0;
    if (tid == 0) {
      red[0] = 0;
      red[1] = done[b];
      red[2] = 0;
      it_b = iters[b];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      int nviol = 0;
      for (PairCursor p(tid, nthr, z); p.r < sh.nb_c; p.next(z))
        nviol += check_update<kMinSum>(T, C, S[p.r * z + p.j], p.r, p.j, rw,
                                       z, sc, nthr, qs, 0.0f, alpha, 0.0f,
                                       0.0f);
      if (VARIANT >= kViolOnly) {
        block_add(nviol, red);
        __syncthreads();
        if (tid == 0) {
          const int v = red[0];
          viol[b] = v;
          if (VARIANT >= kNoCapture) {
            red[2] = v == 0 && !red[1];
            if (red[2]) it_b = it0 + k;
            red[1] |= v == 0;
          }
          red[0] = 0;
        }
      }
      __syncthreads();  // the messages complete before the variable pass
      // a thread writes the totals of the pairs it captures, so the
      // capture needs no barrier of its own
      const bool capture = VARIANT == kFull && red[2];
      for (PairCursor p(tid, nthr, z); p.r < sh.nb_v; p.next(z)) {
        const int c0 = __ldg(cl.col_off + p.r);
        const int c1 = __ldg(cl.col_off + p.r + 1);
        float acc = 0.0f;
        for (int i = c0; i < c1; ++i) {
          int src = p.j + __ldg(cl.col_s + i);
          if (src >= z) src -= z;
          const float x = load_f(C + __ldg(cl.col_e + i) * z + src);
          acc = i == c0 ? x : round_as<bf16>(__fadd_rn(acc, x));
        }
        const int at = p.r * z + p.j;
        if (capture) F[at] = T[at];
        const float pr = load_f(P + at);
        store_f(T + at, c1 > c0 ? __fadd_rn(pr, acc) : pr);
      }
      __syncthreads();
    }
    if (TSH) block_copy(tot + b * NV, T, NV * sizeof(bf16));
    if (VARIANT >= kNoCapture && tid == 0) {
      done[b] = red[1];
      iters[b] = it_b;
    }
    __syncthreads();  // before the next frame reuses the shared memory
  }
}

template <int VARIANT>
int launch_variant(void* t_fm, void* c_fm, const void* p_fm,
                   const void* s_fm, void* f_fm, void* done, void* iters,
                   void* viol, const Rows& rw, const Cols& cl,
                   const ResShape& sh, int it0, int n, float alpha,
                   int threads, int smem, int grid, cudaStream_t stream) {
  auto kern = sh.totals_shared ? bookkeeping_kernel<VARIANT, true>
                               : bookkeeping_kernel<VARIANT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<bf16*>(t_fm), static_cast<bf16*>(c_fm),
      static_cast<const bf16*>(p_fm), static_cast<const int8_t*>(s_fm),
      static_cast<bf16*>(f_fm), static_cast<int32_t*>(done),
      static_cast<int32_t*>(iters), static_cast<int32_t*>(viol), rw, cl, sh,
      it0, n, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// Run n iterations of `variant` on `stream` with the launch plan (threads,
// totals in shared memory or not, smem bytes, blocks an SM, grid, cluster,
// frames a block) of ops/kernels.py resident_plan for min-sum over bf16
// totals: copy the state into the frame-major scratch t_fm/c_fm/p_fm/s_fm
// (and final into f_fm for the full variant), run the K-step kernel, copy
// total and c2v (and final) back.  *launches gets the number of kernels
// launched.  Returns the first non-zero cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for arguments or a plan the kernel does not take.
extern "C" int resident_bookkeeping_probe_launch(
    void* total, void* c2v, const void* prior, const void* synd, void* fin,
    void* done, void* iters, void* viol, void* t_fm, void* c_fm, void* p_fm,
    void* s_fm, void* f_fm, const void* row_off, const void* edge_v,
    const void* edge_s, const void* col_off, const void* col_e,
    const void* col_s, int nb_c, int nb_v, int E, int dc_max, int z, int B,
    int variant, int it0, int n, float alpha, int threads, int totals_shared,
    int smem, int blocks_per_sm, int grid, int cluster, int frames,
    void* launches, void* stream) {
  int* nl = static_cast<int*>(launches);
  *nl = 0;
  if (dc_max < 1 || dc_max > kMaxDc || nb_c < 1 || nb_v < 1 || E < 1 ||
      z < 1 || B < 1 || n < 0 || variant < kNoBook || variant > kFull ||
      (long long)E * z >= (1LL << 31) || (long long)nb_v * z >= (1LL << 31) ||
      (long long)nb_c * z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const ResShape sh{nb_c, nb_v, E, z, B, dc_max, totals_shared ? 1 : 0, 0};
  if (!res_plan_ok(sh, 2, res_scratch(kMinSum, false), threads, smem,
                   blocks_per_sm, grid, cluster, frames))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NV = (long long)nb_v * z, NE = (long long)E * z,
                  NC = (long long)nb_c * z;
  const bool full = variant == kFull;

  TransposeJobs in{{static_cast<const char*>(total),
                    static_cast<const char*>(c2v),
                    static_cast<const char*>(prior),
                    static_cast<const char*>(synd)},
                   {static_cast<char*>(t_fm), static_cast<char*>(c_fm),
                    static_cast<char*>(p_fm), static_cast<char*>(s_fm)},
                   {NV, NE, NV, NC},
                   {2, 2, 2, 1},
                   4,
                   B,
                   1};
  int err = res_transpose(in, s);
  if (err) return err;
  ++*nl;
  if (full) {
    TransposeJobs fin_in{{static_cast<const char*>(fin)},
                         {static_cast<char*>(f_fm)},
                         {NV},
                         {2},
                         1,
                         B,
                         1};
    err = res_transpose(fin_in, s);
    if (err) return err;
    ++*nl;
  }

  const Rows rw{static_cast<const int*>(row_off),
                static_cast<const int*>(edge_v),
                static_cast<const int*>(edge_s)};
  const Cols cl{static_cast<const int*>(col_off),
                static_cast<const int*>(col_e),
                static_cast<const int*>(col_s)};
  switch (variant) {
    case kNoBook:
      err = launch_variant<kNoBook>(t_fm, c_fm, p_fm, s_fm, f_fm, done, iters,
                                    viol, rw, cl, sh, it0, n, alpha, threads,
                                    smem, grid, s);
      break;
    case kViolOnly:
      err = launch_variant<kViolOnly>(t_fm, c_fm, p_fm, s_fm, f_fm, done,
                                      iters, viol, rw, cl, sh, it0, n, alpha,
                                      threads, smem, grid, s);
      break;
    case kNoCapture:
      err = launch_variant<kNoCapture>(t_fm, c_fm, p_fm, s_fm, f_fm, done,
                                       iters, viol, rw, cl, sh, it0, n,
                                       alpha, threads, smem, grid, s);
      break;
    default:
      err = launch_variant<kFull>(t_fm, c_fm, p_fm, s_fm, f_fm, done, iters,
                                  viol, rw, cl, sh, it0, n, alpha, threads,
                                  smem, grid, s);
  }
  if (err) return err;
  ++*nl;

  TransposeJobs out{{static_cast<const char*>(t_fm),
                     static_cast<const char*>(c_fm),
                     static_cast<const char*>(f_fm)},
                    {static_cast<char*>(total), static_cast<char*>(c2v),
                     static_cast<char*>(fin)},
                    {NV, NE, NV},
                    {2, 2, 2},
                    full ? 3 : 2,
                    B,
                    0};
  err = res_transpose(out, s);
  if (err) return err;
  ++*nl;
  return 0;
}
