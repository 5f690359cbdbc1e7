// K serial-C layered BP sweeps of the quasi-cyclic decoder per call, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel
// qamreconciliation_tpu/ops/pallas_kernels.py:bp_layered_sweeps_qc (the
// VMEM-resident layered sweep).
//
// State, frames innermost, updated in place:
//   total [nb_v, z, B]  f32 running totals, prior included
//   c2v   [E, z, B]     check->variable messages, base edges flat in row
//                       order (edge e = row_off[cb] + d), f32 or bf16
//   done, iters [B]     int32 per-frame convergence flag and sweep
// Read only: synd [nb_c, z, B] int8.
//
// Sweep swp = it0 + k + 1 (1-based), k < n (the host computes n =
// max(min(K, maxiter - it0), 0)).  A frame is frozen for the sweep when it
// was done at its start.  For each block row cb, in serial order: t_d =
// total[v_d][(j - s_d) mod z], old = c2v[e0 + d], v2c = t - old, the rule's
// magnitude, sign and prefactor give `stored` in the message dtype, c2v =
// stored for every frame, and total[v_d][(j - s_d) mod z] += f32(stored) -
// old in slot order, except in frozen frames.  After the sweep, the parity
// of total < 0 over each check against synd counts violations; a frame with
// none converges (iters = swp for a new one, done = 1).
//
// Rows depend on each other across z through the rolls, so rows are serial
// while the lanes j of one row are independent.  Two exact devices keep
// that cheap (host tables of ops/kernels.py QCTables):
//  * Dependency levels: a row's level is 1 + the highest level of the
//    earlier rows sharing a variable block with it.  Rows of one level touch
//    disjoint variable blocks, and every variable block still sees its rows
//    in serial order, so running the levels in order is bit-identical to
//    the serial sweep (17 levels for 90 rows at the headline code; the z =
//    360 IRA code's staircase serialises its 60 rows).
//  * A row with a repeated variable block (two base edges in one (cb, vb)
//    cell) would race: one lane's read of total[v] can land on another
//    lane's write.  Such rows are deferred: their deltas go to shared memory
//    ([slots of the level's deferred rows, z] f32), and after a block
//    barrier each of the row's variable blocks adds them in slot order.
//    Every other row updates its totals in place: each (v_d, k) element is
//    read and written by exactly one thread of the row.
// Operation order follows the plain version, ops/kernels.py:
// bp_layered_sweeps_qc_ref; every rule is bit-identical to it.
//
// Bound: the levels' latency, then memory.  One sweep at the headline shape
// (E 540, z 360, B 128, bf16 messages) must read and write the f32 totals
// and c2v: 170 MB, 0.051 ms at 3.35 TB/s.  The first design (0.379-0.431 ms
// per bf16 min-sum sweep, PERF.md) launched one kernel per level, one per
// level with deferred rows, a parity pass and a bookkeeping kernel: ~20-25
// launches a sweep (60+ on the IRA code), each covering a few rows and
// paying its ramp and drain; the parity pass re-read ~100 MB of totals, and
// the deferred deltas took a round trip through device memory.  This design
// (bp_resident.cuh): one launch runs all K sweeps, a block owning a frame;
// levels are block barriers, the deltas stay in shared memory, the parity
// and the convergence test run in the block on its frame's totals (shared
// memory where the plan fits them, else the frame-major scratch, L2
// resident at 259 KB a frame); the state is copied once per call into
// frame-major scratch, so a row's rolled reads run along consecutive
// addresses.

#include "bp_resident.cuh"

namespace {

using namespace bp;

struct Levels {
  const int* level_off;      // [n_levels + 1], into level_rows
  const int* level_rows;     // rows of each level, ascending
  const int* defer_base;     // [nb_c] a deferred row's first delta slot in
                             // its level, -1 for the other rows
  const int* app_level_off;  // [n_levels + 1], into app_vb
  const int* app_vb;         // per level, per deferred row, each distinct
  const int* app_off;        // variable block and its slots (app_e, in
  const int* app_e;          // slot order, with shifts app_s)
  const int* app_s;
  int n_levels;
};

// Row cb, lane j: new messages, and the deltas into the totals (in place)
// or into the level's delta rows (a deferred row).
template <int RULE, typename TM>
__device__ __forceinline__ void layer_update(float* T, TM* C, int s, int cb,
                                             int j, int dbase, bool frozen,
                                             float* dl, const Rows& rw, int z,
                                             float* sc, int nthr, int qs,
                                             float tiny, float alpha,
                                             float beta, float tanh_sat) {
  constexpr int QT = RuleChain<RULE>::kScratch, QO = QT + 1;
  const int e0 = __ldg(rw.row_off + cb);
  const int dc = __ldg(rw.row_off + cb + 1) - e0;
  RuleChain<RULE> ch;
  ch.init();
  uint32_t negbits = 0;
  for (int d = 0; d < dc; ++d) {
    int src = j - __ldg(rw.edge_s + e0 + d);
    if (src < 0) src += z;
    const float t = T[__ldg(rw.edge_v + e0 + d) * z + src];
    const float old = load_f(C + (e0 + d) * z + j);
    const float v = __fsub_rn(t, old);
    negbits |= (uint32_t)(v < 0.0f) << d;
    float* col = sc + d * nthr;
    ch.push(d, fabsf(v), col, qs, tiny);
    col[QT * qs] = t;
    col[QO * qs] = old;
  }
  const int vpar = __popc(negbits) & 1;
  const float pref = (float)(1 - 2 * s);
  ch.emit_all(
      dc, sc, nthr, qs, tiny, alpha, beta, tanh_sat, [&](int d, float mag) {
        const float* col = sc + d * nthr;
        const float stored =
            round_as<TM>(signed_message(negbits, vpar, pref, d, mag));
        store_f(C + (e0 + d) * z + j, stored);
        const float delta = stored - col[QO * qs];
        if (dbase >= 0) {
          dl[(dbase + d) * z + j] = delta;
        } else if (!frozen) {
          int src = j - __ldg(rw.edge_s + e0 + d);
          if (src < 0) src += z;
          T[__ldg(rw.edge_v + e0 + d) * z + src] = col[QT * qs] + delta;
        }
      });
}

// TSH: the frame's totals in shared memory (the plan's choice); a template
// argument, so that every access to them compiles to its own memory space
// rather than to generic loads.
template <typename TM, int RULE, bool TSH>
__global__ void __launch_bounds__(kResThreadsMax, 1)
sweeps_kernel(float* __restrict__ tot, TM* __restrict__ c2v,
              const int8_t* __restrict__ synd, int32_t* __restrict__ done,
              int32_t* __restrict__ iters, Rows rw, Levels lv, ResShape sh,
              int it0, int n, float tiny, float alpha, float beta,
              float tanh_sat) {
  extern __shared__ __align__(16) char smem[];
  const int nthr = blockDim.x, tid = threadIdx.x, z = sh.z;
  const ResLayout L = res_layout(sh, 4, res_scratch(RULE, true), nthr);
  float* sc = reinterpret_cast<float*>(smem + L.scr) + tid;
  const int qs = sh.dc_max * nthr;
  float* dl = reinterpret_cast<float*>(smem + L.dl);
  int* red = reinterpret_cast<int*>(smem + L.red);  // violations, done
  const long long NV = (long long)sh.nb_v * z, NE = (long long)sh.E * z,
                  NC = (long long)sh.nb_c * z;

  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    float* T = TSH ? reinterpret_cast<float*>(smem + L.tot) : tot + b * NV;
    TM* C = c2v + b * NE;
    const int8_t* S = synd + b * NC;
    if (TSH) block_copy(T, tot + b * NV, NV * 4);
    int it_b = 0;
    if (tid == 0) {
      red[0] = 0;
      red[1] = done[b];
      it_b = iters[b];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const bool frozen = red[1] != 0;  // done at the sweep's start
      for (int lev = 0; lev < lv.n_levels; ++lev) {
        const int r0 = __ldg(lv.level_off + lev);
        const int nr = __ldg(lv.level_off + lev + 1) - r0;
        for (PairCursor p(tid, nthr, z); p.r < nr; p.next(z)) {
          const int cb = __ldg(lv.level_rows + r0 + p.r);
          layer_update<RULE>(T, C, S[cb * z + p.j], cb, p.j,
                             __ldg(lv.defer_base + cb), frozen, dl, rw, z,
                             sc, nthr, qs, tiny, alpha, beta, tanh_sat);
        }
        __syncthreads();  // the level's totals and deltas are in
        const int a0 = __ldg(lv.app_level_off + lev);
        const int na = __ldg(lv.app_level_off + lev + 1) - a0;
        if (na > 0) {
          if (!frozen) {
            for (PairCursor p(tid, nthr, z); p.r < na; p.next(z)) {
              const int i = a0 + p.r;
              const int at = __ldg(lv.app_vb + i) * z + p.j;
              float tv = T[at];
              for (int a = __ldg(lv.app_off + i); a < __ldg(lv.app_off + i + 1);
                   ++a) {
                int src = p.j + __ldg(lv.app_s + a);
                if (src >= z) src -= z;
                tv = tv + dl[__ldg(lv.app_e + a) * z + src];
              }
              T[at] = tv;
            }
          }
          __syncthreads();
        }
      }
      // the syndrome test of the sweep's totals
      int nviol = 0;
      for (PairCursor p(tid, nthr, z); p.r < sh.nb_c; p.next(z)) {
        const int e0 = __ldg(rw.row_off + p.r);
        const int e1 = __ldg(rw.row_off + p.r + 1);
        int par = 0;
        for (int e = e0; e < e1; ++e) {
          int src = p.j - __ldg(rw.edge_s + e);
          if (src < 0) src += z;
          par ^= T[__ldg(rw.edge_v + e) * z + src] < 0.0f;
        }
        nviol += par != S[p.r * z + p.j];
      }
      block_add(nviol, red);
      __syncthreads();
      if (tid == 0) {
        if (red[0] == 0) {
          if (!red[1]) it_b = it0 + k + 1;
          red[1] = 1;
        }
        red[0] = 0;
      }
      __syncthreads();
    }
    if (TSH) block_copy(tot + b * NV, T, NV * 4);
    if (tid == 0) {
      done[b] = red[1];
      iters[b] = it_b;
    }
    __syncthreads();  // before the next frame reuses the shared memory
  }
}

template <typename TM, int RULE>
int launch_rule(void* t_fm, void* c_fm, const void* s_fm, void* done,
                void* iters, const Rows& rw, const Levels& lv,
                const ResShape& sh, int it0, int n, float tiny, float alpha,
                float beta, int threads, int smem, int grid,
                cudaStream_t stream) {
  auto kern = sh.totals_shared ? sweeps_kernel<TM, RULE, true>
                               : sweeps_kernel<TM, RULE, false>;
  // the limit is per function and device; setting it is a host call
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<float*>(t_fm), static_cast<TM*>(c_fm),
      static_cast<const int8_t*>(s_fm), static_cast<int32_t*>(done),
      static_cast<int32_t*>(iters), rw, lv, sh, it0, n, tiny, alpha, beta,
      tanh_saturation());
  return (int)cudaGetLastError();
}

template <typename TM>
int launch_typed(int rule, void* t_fm, void* c_fm, const void* s_fm,
                 void* done, void* iters, const Rows& rw, const Levels& lv,
                 const ResShape& sh, int it0, int n, float tiny, float alpha,
                 float beta, int threads, int smem, int grid,
                 cudaStream_t stream) {
  if (rule == kPhi)
    return launch_rule<TM, kPhi>(t_fm, c_fm, s_fm, done, iters, rw, lv, sh,
                                 it0, n, tiny, alpha, beta, threads, smem,
                                 grid, stream);
  if (rule == kTanhFB)
    return launch_rule<TM, kTanhFB>(t_fm, c_fm, s_fm, done, iters, rw, lv,
                                    sh, it0, n, tiny, alpha, beta, threads,
                                    smem, grid, stream);
  return launch_rule<TM, kMinSum>(t_fm, c_fm, s_fm, done, iters, rw, lv, sh,
                                  it0, n, tiny, alpha, beta, threads, smem,
                                  grid, stream);
}

}  // namespace

// Run n sweeps on `stream` with the launch plan (threads, totals in shared
// memory or not, smem bytes, blocks an SM, grid, cluster, frames a block) of
// ops/kernels.py resident_plan: copy the state into the frame-major scratch
// t_fm/c_fm/s_fm, run the K-sweep kernel, copy total and c2v back.
// defer_slots is the most deferred slots of any level.  *launches gets the
// number of kernels launched.  Returns the first non-zero
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for arguments or a
// plan the kernel does not take.
extern "C" int bp_layered_sweeps_qc_launch(
    void* total, void* c2v, const void* synd, void* done, void* iters,
    void* t_fm, void* c_fm, void* s_fm, const void* row_off,
    const void* edge_v, const void* edge_s, const void* level_off,
    const void* level_rows, const void* defer_base,
    const void* app_level_off, const void* app_vb, const void* app_off,
    const void* app_e, const void* app_s, int n_levels, int m_dtype,
    int nb_c, int nb_v, int E, int dc_max, int z, int B, int rule, int it0,
    int n, int defer_slots, float tiny, float alpha, float beta, int threads,
    int totals_shared, int smem, int blocks_per_sm, int grid, int cluster,
    int frames, void* launches, void* stream) {
  int* nl = static_cast<int*>(launches);
  *nl = 0;
  if ((m_dtype != kF32 && m_dtype != kBF16) || dc_max < 1 ||
      dc_max > kMaxDc || nb_c < 1 || nb_v < 1 || E < 1 || n_levels < 1 ||
      z < 1 || B < 1 || n < 0 || rule < kPhi || rule > kMinSum ||
      (long long)E * z >= (1LL << 31) || (long long)nb_v * z >= (1LL << 31) ||
      (long long)nb_c * z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int msz = m_dtype == kF32 ? 4 : 2;
  const ResShape sh{nb_c, nb_v, E, z, B, dc_max, totals_shared ? 1 : 0,
                    defer_slots};
  if (!res_plan_ok(sh, 4, res_scratch(rule, true), threads, smem,
                   blocks_per_sm, grid, cluster, frames))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NV = (long long)nb_v * z, NE = (long long)E * z,
                  NC = (long long)nb_c * z;

  TransposeJobs in{{static_cast<const char*>(total),
                    static_cast<const char*>(c2v),
                    static_cast<const char*>(synd)},
                   {static_cast<char*>(t_fm), static_cast<char*>(c_fm),
                    static_cast<char*>(s_fm)},
                   {NV, NE, NC},
                   {4, msz, 1},
                   3,
                   B,
                   1};
  int err = res_transpose(in, s);
  if (err) return err;
  ++*nl;

  const Rows rw{static_cast<const int*>(row_off),
                static_cast<const int*>(edge_v),
                static_cast<const int*>(edge_s)};
  const Levels lv{static_cast<const int*>(level_off),
                  static_cast<const int*>(level_rows),
                  static_cast<const int*>(defer_base),
                  static_cast<const int*>(app_level_off),
                  static_cast<const int*>(app_vb),
                  static_cast<const int*>(app_off),
                  static_cast<const int*>(app_e),
                  static_cast<const int*>(app_s),
                  n_levels};
  if (m_dtype == kF32)
    err = launch_typed<float>(rule, t_fm, c_fm, s_fm, done, iters, rw, lv,
                              sh, it0, n, tiny, alpha, beta, threads, smem,
                              grid, s);
  else
    err = launch_typed<__nv_bfloat16>(rule, t_fm, c_fm, s_fm, done, iters,
                                      rw, lv, sh, it0, n, tiny, alpha, beta,
                                      threads, smem, grid, s);
  if (err) return err;
  ++*nl;

  TransposeJobs out{{static_cast<const char*>(t_fm),
                     static_cast<const char*>(c_fm)},
                    {static_cast<char*>(total), static_cast<char*>(c2v)},
                    {NV, NE},
                    {4, msz},
                    2,
                    B,
                    0};
  err = res_transpose(out, s);
  if (err) return err;
  ++*nl;
  return 0;
}
