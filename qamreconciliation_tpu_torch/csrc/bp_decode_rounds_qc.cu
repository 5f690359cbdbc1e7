// K flooding BP iterations of the quasi-cyclic decoder per call, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// qamreconciliation_tpu/ops/pallas_kernels.py:bp_decode_rounds_qc (the
// VMEM-resident flooding loop).
//
// State, frames innermost, updated in place:
//   total [nb_v, z, B]  running totals (f32, or bf16 with bf16 messages)
//   c2v   [E, z, B]     check->variable messages, base edges flat in row
//                       order (edge e = row_off[cb] + d), f32 or bf16
//   done, iters [B]     int32 per-frame convergence flag and iteration
// Read only: prior [nb_v, z, B] (message dtype), synd [nb_c, z, B] int8.
// Tables (device int32): row_off [nb_c+1], edge_v/edge_s [E] (the rows'
// variable blocks and shifts in [0, z)), col_off [nb_v+1], col_e/col_s [E]
// (each variable block's edges in (row ascending, slot ascending) order).
//
// Iteration it = it0 + k, k < n (the host computes n = max(min(K, maxiter -
// it0), 0), so iterations past maxiter never run), per frame:
//   pass 1, per (cb, j): t_d = total[v_d][(j - s_d) mod z] in f32, the
//     parity of t < 0 against synd counted for the convergence test, v2c =
//     t - c2v, the rule's all-but-one magnitude, sign and (1 - 2 synd)
//     prefactor, c2v stored in place in the message dtype (every frame);
//   the frame's violation count: none converges (iters = it for a newly
//     converged frame, done = 1);
//   pass 2, per (vb, k), only in a frame not done: total = round_once(
//     f32(prior) + left fold of c2v[e][(k + s_e) mod z] over the block's
//     edges), so a converged frame keeps the totals of its convergence
//     iteration.  No atomics on the totals.
// Operation order follows the plain version, ops/kernels.py:
// bp_decode_rounds_qc_ref; every rule is bit-identical to it.
//
// Bound: memory and the check rule's instruction latency.  One iteration at
// the headline shape (nb_v 180, E 540, z 360, B 128, bf16) must read the
// totals, prior, synd and c2v and write c2v and the totals: 153 MB, 0.046 ms
// at 3.35 TB/s.  The first design (0.354-0.389 ms per bf16 tanh-F/B
// iteration, PERF.md) issued three launches per iteration (check pass,
// bookkeeping, variable pass), each draining the card, held a row's slots in
// MAXD register arrays (~125 registers, 16 warps an SM) and read 2-byte
// values at a stride of B.  This design (bp_resident.cuh): one launch runs
// all K iterations, a block owning a frame with the passes and steps
// separated by block barriers and the convergence test a block reduction;
// the state is copied once per call into frame-major scratch (one launch
// each way), so a row's rolled reads run along consecutive addresses; the
// frame's totals stay in shared memory for the call where the plan fits
// them (bf16 at the headline); the slots live in a shared-memory scratch,
// not in registers, at up to 1024 threads a block.

#include "bp_resident.cuh"

namespace {

using namespace bp;

// TSH: the frame's totals in shared memory (the plan's choice); a template
// argument, so that every access to them compiles to its own memory space
// rather than to generic loads.
template <typename TT, typename TM, int RULE, bool TSH>
__global__ void __launch_bounds__(kResThreadsMax, 1)
rounds_kernel(TT* __restrict__ tot, TM* __restrict__ c2v,
              const TM* __restrict__ prior, const int8_t* __restrict__ synd,
              int32_t* __restrict__ done, int32_t* __restrict__ iters,
              Rows rw, Cols cl, ResShape sh, int it0, int n, float tiny,
              float alpha, float beta, float tanh_sat) {
  extern __shared__ __align__(16) char smem[];
  const int nthr = blockDim.x, tid = threadIdx.x, z = sh.z;
  const ResLayout L =
      res_layout(sh, sizeof(TT), res_scratch(RULE, false), nthr);
  float* sc = reinterpret_cast<float*>(smem + L.scr) + tid;
  const int qs = sh.dc_max * nthr;
  int* red = reinterpret_cast<int*>(smem + L.red);  // violations, done
  const long long NV = (long long)sh.nb_v * z, NE = (long long)sh.E * z,
                  NC = (long long)sh.nb_c * z;

  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    TT* T = TSH ? reinterpret_cast<TT*>(smem + L.tot) : tot + b * NV;
    TM* C = c2v + b * NE;
    const TM* P = prior + b * NV;
    const int8_t* S = synd + b * NC;
    if (TSH) block_copy(T, tot + b * NV, NV * sizeof(TT));
    int it_b = 0;
    if (tid == 0) {
      red[0] = 0;
      red[1] = done[b];
      it_b = iters[b];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      int nviol = 0;
      for (PairCursor p(tid, nthr, z); p.r < sh.nb_c; p.next(z))
        nviol += check_update<RULE>(T, C, S[p.r * z + p.j], p.r, p.j, rw, z,
                                    sc, nthr, qs, tiny, alpha, beta,
                                    tanh_sat);
      block_add(nviol, red);
      __syncthreads();
      if (tid == 0) {
        if (red[0] == 0) {
          if (!red[1]) it_b = it0 + k;
          red[1] = 1;
        }
        red[0] = 0;
      }
      __syncthreads();
      if (!red[1]) {  // a done frame keeps its totals
        for (PairCursor p(tid, nthr, z); p.r < sh.nb_v; p.next(z)) {
          const int c0 = __ldg(cl.col_off + p.r);
          const int c1 = __ldg(cl.col_off + p.r + 1);
          float acc = 0.0f;
          for (int i = c0; i < c1; ++i) {
            int src = p.j + __ldg(cl.col_s + i);
            if (src >= z) src -= z;
            const float x = load_f(C + __ldg(cl.col_e + i) * z + src);
            acc = i == c0 ? x : acc + x;
          }
          const int at = p.r * z + p.j;
          const float pr = load_f(P + at);
          store_f(T + at, c1 > c0 ? pr + acc : pr);
        }
      }
      __syncthreads();
    }
    if (TSH) block_copy(tot + b * NV, T, NV * sizeof(TT));
    if (tid == 0) {
      done[b] = red[1];
      iters[b] = it_b;
    }
    __syncthreads();  // before the next frame reuses the shared memory
  }
}

template <typename TT, typename TM, int RULE>
int launch_rule(void* t_fm, void* c_fm, const void* p_fm, const void* s_fm,
                void* done, void* iters, const Rows& rw, const Cols& cl,
                const ResShape& sh, int it0, int n, float tiny, float alpha,
                float beta, int threads, int smem, int grid,
                cudaStream_t stream) {
  auto kern = sh.totals_shared ? rounds_kernel<TT, TM, RULE, true>
                               : rounds_kernel<TT, TM, RULE, false>;
  // the limit is per function and device; setting it is a host call
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<TT*>(t_fm), static_cast<TM*>(c_fm),
      static_cast<const TM*>(p_fm), static_cast<const int8_t*>(s_fm),
      static_cast<int32_t*>(done), static_cast<int32_t*>(iters), rw, cl, sh,
      it0, n, tiny, alpha, beta, tanh_saturation());
  return (int)cudaGetLastError();
}

template <typename TT, typename TM>
int launch_typed(int rule, void* t_fm, void* c_fm, const void* p_fm,
                 const void* s_fm, void* done, void* iters, const Rows& rw,
                 const Cols& cl, const ResShape& sh, int it0, int n,
                 float tiny, float alpha, float beta, int threads, int smem,
                 int grid, cudaStream_t stream) {
  if (rule == kPhi)
    return launch_rule<TT, TM, kPhi>(t_fm, c_fm, p_fm, s_fm, done, iters, rw,
                                     cl, sh, it0, n, tiny, alpha, beta,
                                     threads, smem, grid, stream);
  if (rule == kTanhFB)
    return launch_rule<TT, TM, kTanhFB>(t_fm, c_fm, p_fm, s_fm, done, iters,
                                        rw, cl, sh, it0, n, tiny, alpha,
                                        beta, threads, smem, grid, stream);
  return launch_rule<TT, TM, kMinSum>(t_fm, c_fm, p_fm, s_fm, done, iters,
                                      rw, cl, sh, it0, n, tiny, alpha, beta,
                                      threads, smem, grid, stream);
}

}  // namespace

// Run n iterations on `stream` with the launch plan (threads, totals in
// shared memory or not, smem bytes, blocks an SM, grid, cluster, frames a
// block) of ops/kernels.py resident_plan: copy the state into the
// frame-major scratch t_fm/c_fm/p_fm/s_fm, run the K-step kernel, copy
// total and c2v back.  *launches gets the number of kernels launched.
// Returns the first non-zero cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for arguments or a plan the kernel does not take.
extern "C" int bp_decode_rounds_qc_launch(
    void* total, void* c2v, const void* prior, const void* synd, void* done,
    void* iters, void* t_fm, void* c_fm, void* p_fm, void* s_fm,
    const void* row_off, const void* edge_v, const void* edge_s,
    const void* col_off, const void* col_e, const void* col_s, int t_dtype,
    int m_dtype, int nb_c, int nb_v, int E, int dc_max, int z, int B,
    int rule, int it0, int n, float tiny, float alpha, float beta,
    int threads, int totals_shared, int smem, int blocks_per_sm, int grid,
    int cluster, int frames, void* launches, void* stream) {
  int* nl = static_cast<int*>(launches);
  *nl = 0;
  const bool pair_ok = (t_dtype == kF32 && m_dtype == kF32) ||
                       (t_dtype == kBF16 && m_dtype == kBF16) ||
                       (t_dtype == kF32 && m_dtype == kBF16);
  if (!pair_ok || dc_max < 1 || dc_max > kMaxDc || nb_c < 1 || nb_v < 1 ||
      E < 1 || z < 1 || B < 1 || n < 0 || rule < kPhi || rule > kMinSum ||
      (long long)E * z >= (1LL << 31) || (long long)nb_v * z >= (1LL << 31) ||
      (long long)nb_c * z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int tsz = t_dtype == kF32 ? 4 : 2, msz = m_dtype == kF32 ? 4 : 2;
  const ResShape sh{nb_c, nb_v, E, z, B, dc_max, totals_shared ? 1 : 0, 0};
  if (!res_plan_ok(sh, tsz, res_scratch(rule, false), threads, smem,
                   blocks_per_sm, grid, cluster, frames))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NV = (long long)nb_v * z, NE = (long long)E * z,
                  NC = (long long)nb_c * z;

  TransposeJobs in{{static_cast<const char*>(total),
                    static_cast<const char*>(c2v),
                    static_cast<const char*>(prior),
                    static_cast<const char*>(synd)},
                   {static_cast<char*>(t_fm), static_cast<char*>(c_fm),
                    static_cast<char*>(p_fm), static_cast<char*>(s_fm)},
                   {NV, NE, NV, NC},
                   {tsz, msz, msz, 1},
                   4,
                   B,
                   1};
  int err = res_transpose(in, s);
  if (err) return err;
  ++*nl;

  const Rows rw{static_cast<const int*>(row_off),
                static_cast<const int*>(edge_v),
                static_cast<const int*>(edge_s)};
  const Cols cl{static_cast<const int*>(col_off),
                static_cast<const int*>(col_e),
                static_cast<const int*>(col_s)};
  if (t_dtype == kF32 && m_dtype == kF32)
    err = launch_typed<float, float>(rule, t_fm, c_fm, p_fm, s_fm, done,
                                     iters, rw, cl, sh, it0, n, tiny, alpha,
                                     beta, threads, smem, grid, s);
  else if (t_dtype == kBF16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        rule, t_fm, c_fm, p_fm, s_fm, done, iters, rw, cl, sh, it0, n, tiny,
        alpha, beta, threads, smem, grid, s);
  else
    err = launch_typed<float, __nv_bfloat16>(
        rule, t_fm, c_fm, p_fm, s_fm, done, iters, rw, cl, sh, it0, n, tiny,
        alpha, beta, threads, smem, grid, s);
  if (err) return err;
  ++*nl;

  TransposeJobs out{{static_cast<const char*>(t_fm),
                     static_cast<const char*>(c_fm)},
                    {static_cast<char*>(total), static_cast<char*>(c2v)},
                    {NV, NE},
                    {tsz, msz},
                    2,
                    B,
                    0};
  err = res_transpose(out, s);
  if (err) return err;
  ++*nl;
  return 0;
}
