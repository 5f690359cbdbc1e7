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
// viol [B] int32 scratch, zero on entry and on return.
//
// Iteration it = it0 + k, k < n (the host computes n = max(min(K, maxiter -
// it0), 0), so iterations past maxiter never run):
//   pass 1 (check_pass_kernel), per (cb, j, b): t_d = total[v_d][(j - s_d)
//     mod z] in f32, the parity of t<0 against synd counted into viol[b],
//     v2c = t - c2v, the rule's all-but-one magnitude, sign and (1 - 2 synd)
//     prefactor, c2v stored in place in the message dtype for every frame;
//   bookkeeping (bp::bookkeeping_kernel), per frame: viol[b] == 0 converges,
//     a newly converged frame records iters = it, done |= converged;
//   pass 2 (var_pass_kernel), per (vb, k, b) of a frame not done: total =
//     round_once(f32(prior) + left fold of c2v[e][(k + s_e) mod z] over the
//     block's edges), so a converged frame keeps the totals of its
//     convergence iteration.  No atomics on the totals.
// Operation order follows the plain version, ops/kernels.py:
// bp_decode_rounds_qc_ref; min-sum is bit-identical to it.
//
// Bound: memory.  At the headline shape (nb_v 180, E 540, z 360, B 128) with
// bf16 messages one iteration moves ~250 MB: pass 1 reads the rolled totals
// (540 x 360 x 128 x 2 B ~ 50 MB) and reads and writes c2v (~100 MB); pass 2
// reads c2v, prior and the totals and writes the totals (~100 MB).  That is
// ~75 us at 3.35 TB/s.  The TPU kernel kept the whole state in VMEM across
// the K iterations; the state (~87 MB) does not fit an SM's shared memory or
// the 50 MB L2, so this design keeps the contract (K iterations per call,
// in-kernel convergence test, iteration-exact iters, freeze at convergence)
// and drops the residency: three launches per iteration, all queued on the
// caller's stream by one C entry with no host synchronisation.  Threads map
// to (row, b) with b innermost, so each warp reads 32 consecutive frames of
// one slab; a row's slots stay in registers (MAXD template).  No early exit
// inside the call: the caller checks "all done?" once per call.

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kBT = 32;    // frames per block (threadIdx.x)
constexpr int kJT = 8;     // circulant rows per pass (threadIdx.y)
constexpr int kJLOOP = 8;  // passes per block: a block covers 64 rows

template <typename TT, typename TM, int MAXD>
__global__ void __launch_bounds__(kBT * kJT)
check_pass_kernel(const TT* __restrict__ total, TM* __restrict__ c2v,
                  const int8_t* __restrict__ synd, int32_t* __restrict__ viol,
                  const int* __restrict__ row_off,
                  const int* __restrict__ edge_v,
                  const int* __restrict__ edge_s, int z, int B, int rule,
                  float tiny, float alpha, float beta, float tanh_sat) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int cb = blockIdx.z;
  const int j0 = blockIdx.y * (kJT * kJLOOP);
  const int e0 = row_off[cb];
  const int dc = row_off[cb + 1] - e0;
  int nviol = 0;

  if (b < B) {
    long long vbase[MAXD];  // offset of (v_d, 0, b) in total
    int sh[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < dc) {
        vbase[d] = (long long)edge_v[e0 + d] * z * B + b;
        sh[d] = edge_s[e0 + d];
      }
    }
    for (int k = 0; k < kJLOOP; ++k) {
      const int j = j0 + k * kJT + threadIdx.y;
      if (j >= z) break;
      const int s = synd[((long long)cb * z + j) * B + b];

      float v[MAXD];
      int tpar = 0, vpar = 0;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < dc) {
          int src = j - sh[d];
          if (src < 0) src += z;
          const float td = load_f(total + vbase[d] + (long long)src * B);
          tpar ^= (td < 0.0f);
          v[d] = td - load_f(c2v + ((long long)(e0 + d) * z + j) * B + b);
          vpar ^= (v[d] < 0.0f);
        }
      }
      nviol += (tpar != s);

      float mag[MAXD];
      check_magnitudes<MAXD>(v, dc, rule, tiny, alpha, beta, tanh_sat, mag);

      const float pref = (float)(1 - 2 * s);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < dc) {
          store_f(c2v + ((long long)(e0 + d) * z + j) * B + b,
                  signed_message(vpar, v[d], pref, mag[d]));
        }
      }
    }
  }

  add_block_counts<kBT, kJT>(nviol, b, B, viol);
}

template <typename TT, typename TM>
__global__ void __launch_bounds__(kBT * kJT)
var_pass_kernel(TT* __restrict__ total, const TM* __restrict__ c2v,
                const TM* __restrict__ prior,
                const int32_t* __restrict__ done,
                const int* __restrict__ col_off,
                const int* __restrict__ col_e,
                const int* __restrict__ col_s, int z, int B) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int vb = blockIdx.z;
  const int k0 = blockIdx.y * (kJT * kJLOOP);
  if (b >= B || done[b]) return;  // a done frame keeps its totals
  const int c0 = col_off[vb], c1 = col_off[vb + 1];
  for (int kk = 0; kk < kJLOOP; ++kk) {
    const int k = k0 + kk * kJT + threadIdx.y;
    if (k >= z) break;
    const long long at = ((long long)vb * z + k) * B + b;
    float acc = 0.0f;
    for (int i = c0; i < c1; ++i) {
      int src = k + col_s[i];
      if (src >= z) src -= z;
      const float x = load_f(c2v + ((long long)col_e[i] * z + src) * B + b);
      acc = i == c0 ? x : acc + x;
    }
    const float pr = load_f(prior + at);
    store_f(total + at, c1 > c0 ? pr + acc : pr);
  }
}

template <typename TT, typename TM>
int launch_typed(void* total, void* c2v, const void* prior, const void* synd,
                 void* done, void* iters, void* viol, const int* row_off,
                 const int* edge_v, const int* edge_s, const int* col_off,
                 const int* col_e, const int* col_s, int nb_c, int nb_v,
                 int dc_max, int z, int B, int rule, int it0, int n,
                 float tiny, float alpha, float beta, cudaStream_t stream) {
  const float tanh_sat = tanh_saturation();
  const dim3 block(kBT, kJT);
  const int bx = (B + kBT - 1) / kBT;
  const int by = (z + kJT * kJLOOP - 1) / (kJT * kJLOOP);
  TT* tp = static_cast<TT*>(total);
  TM* cp = static_cast<TM*>(c2v);
  const TM* pp = static_cast<const TM*>(prior);
  const int8_t* sp = static_cast<const int8_t*>(synd);
  int32_t* dp = static_cast<int32_t*>(done);
  int32_t* ip = static_cast<int32_t*>(iters);
  int32_t* vp = static_cast<int32_t*>(viol);
  for (int k = 0; k < n; ++k) {
    if (dc_max <= 8) {
      check_pass_kernel<TT, TM, 8><<<dim3(bx, by, nb_c), block, 0, stream>>>(
          tp, cp, sp, vp, row_off, edge_v, edge_s, z, B, rule, tiny, alpha,
          beta, tanh_sat);
    } else {
      check_pass_kernel<TT, TM, kMaxDc>
          <<<dim3(bx, by, nb_c), block, 0, stream>>>(
              tp, cp, sp, vp, row_off, edge_v, edge_s, z, B, rule, tiny,
              alpha, beta, tanh_sat);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_bookkeeping(vp, dp, ip, B, it0 + k, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    var_pass_kernel<TT, TM><<<dim3(bx, by, nb_v), block, 0, stream>>>(
        tp, cp, pp, dp, col_off, col_e, col_s, z, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Launch n iterations on `stream`; returns the first non-zero
// cudaGetLastError() after a launch (0 = ok), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int bp_decode_rounds_qc_launch(
    void* total, void* c2v, const void* prior, const void* synd, void* done,
    void* iters, void* viol, const void* row_off, const void* edge_v,
    const void* edge_s, const void* col_off, const void* col_e,
    const void* col_s, int t_dtype, int m_dtype, int nb_c, int nb_v,
    int dc_max, int z, int B, int rule, int it0, int n, float tiny,
    float alpha, float beta, void* stream) {
  if (dc_max < 1 || dc_max > kMaxDc || nb_c < 1 || nb_c > 65535 ||
      nb_v < 1 || nb_v > 65535 || z < 1 || B < 1 || n < 0 || rule < kPhi ||
      rule > kMinSum)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ro = static_cast<const int*>(row_off);
  const int* ev = static_cast<const int*>(edge_v);
  const int* es = static_cast<const int*>(edge_s);
  const int* co = static_cast<const int*>(col_off);
  const int* ce = static_cast<const int*>(col_e);
  const int* cs = static_cast<const int*>(col_s);
  if (t_dtype == kF32 && m_dtype == kF32) {
    return launch_typed<float, float>(total, c2v, prior, synd, done, iters,
                                      viol, ro, ev, es, co, ce, cs, nb_c,
                                      nb_v, dc_max, z, B, rule, it0, n, tiny,
                                      alpha, beta, s);
  } else if (t_dtype == kBF16 && m_dtype == kBF16) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        total, c2v, prior, synd, done, iters, viol, ro, ev, es, co, ce, cs,
        nb_c, nb_v, dc_max, z, B, rule, it0, n, tiny, alpha, beta, s);
  } else if (t_dtype == kF32 && m_dtype == kBF16) {
    return launch_typed<float, __nv_bfloat16>(
        total, c2v, prior, synd, done, iters, viol, ro, ev, es, co, ce, cs,
        nb_c, nb_v, dc_max, z, B, rule, it0, n, tiny, alpha, beta, s);
  }
  return (int)cudaErrorInvalidValue;
}
