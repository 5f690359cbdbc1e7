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
// Read only: synd [nb_c, z, B] int8.  viol [B] int32 scratch, zero on entry
// and on return; delta [n_deferred_slots, z, B] f32 scratch.
//
// Sweep swp = it0 + k + 1 (1-based), k < n (the host computes n =
// max(min(K, maxiter - it0), 0)).  A frame is frozen for the sweep when it
// was done at its start.  For each block row cb, in serial order: t_d =
// total[v_d][(j - s_d) mod z], old = c2v[e0 + d], v2c = t - old, the rule's
// magnitude, sign and prefactor give `stored` in the message dtype, c2v =
// stored for every frame, and total[v_d][(j - s_d) mod z] += f32(stored) -
// old in slot order, except in frozen frames.  After the sweep, the parity
// of total<0 over each check against synd counts violations; a frame with
// none converges (iters = swp for a new one, done |= converged).
//
// The trap: rows depend on each other across z through the rolls, so rows
// are serial while the (j, b) lanes of one row are independent.  Two exact
// devices keep that cheap:
//  * Dependency levels (host tables level_off/level_rows): a row's level is
//    1 + the highest level of the earlier rows sharing a variable block with
//    it.  Rows of one level touch disjoint variable blocks, and every
//    variable block still sees its rows in serial order, so one launch per
//    level is bit-identical to the serial sweep (17 levels instead of 90
//    launches at the headline code).
//  * A row with a repeated variable block (two base edges in one (cb, vb)
//    cell with different shifts) would race: one lane's read of total[v] can
//    land on another lane's write.  Such rows are "deferred": the level
//    kernel writes their deltas to scratch, and a second launch adds them to
//    each of the row's variable blocks in slot order (apply_kernel).  Every
//    other row updates its totals in place: each (v_d, k) element is read
//    and written by exactly one thread of the row.
// Operation order follows the plain version, ops/kernels.py:
// bp_layered_sweeps_qc_ref; min-sum is bit-identical to it.
//
// Bound: memory and launch count.  One sweep at the headline shape (E 540,
// z 360, B 128, bf16 messages) reads the rolled f32 totals and c2v and
// writes both (~2 x (100 + 50) MB), plus the end-of-sweep parity read of
// the totals (~100 MB): ~400 MB, ~0.12 ms at 3.35 TB/s.  Each level kernel
// covers only a few rows (~5 of 90), so ~25 small launches per sweep are
// the other cost; they are queued by one C entry on the caller's stream
// with no host synchronisation.

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kBT = 32;    // frames per block (threadIdx.x)
constexpr int kJT = 8;     // circulant rows per block (threadIdx.y)
constexpr int kJLOOP = 8;  // parity kernel: passes per block

template <typename TM, int MAXD>
__global__ void __launch_bounds__(kBT * kJT)
layer_kernel(float* __restrict__ total, TM* __restrict__ c2v,
             float* __restrict__ delta, const int8_t* __restrict__ synd,
             const int32_t* __restrict__ done,
             const int* __restrict__ rows, const int* __restrict__ row_off,
             const int* __restrict__ edge_v, const int* __restrict__ edge_s,
             const int* __restrict__ defer_base, int z, int B, int rule,
             float tiny, float alpha, float beta, float tanh_sat) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int j = blockIdx.y * kJT + threadIdx.y;
  if (b >= B || j >= z) return;
  const int cb = rows[blockIdx.z];
  const int e0 = row_off[cb];
  const int dc = row_off[cb + 1] - e0;
  const int dbase = defer_base[cb];
  const bool frozen = done[b] != 0;
  const int s = synd[((long long)cb * z + j) * B + b];

  float t[MAXD], old[MAXD], v[MAXD];
  int vpar = 0;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d < dc) {
      int src = j - edge_s[e0 + d];
      if (src < 0) src += z;
      t[d] = total[((long long)edge_v[e0 + d] * z + src) * B + b];
      old[d] = load_f(c2v + ((long long)(e0 + d) * z + j) * B + b);
      v[d] = t[d] - old[d];
      vpar ^= (v[d] < 0.0f);
    }
  }

  float mag[MAXD];
  check_magnitudes<MAXD>(v, dc, rule, tiny, alpha, beta, tanh_sat, mag);

  const float pref = (float)(1 - 2 * s);
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d < dc) {
      const float stored =
          round_as<TM>(signed_message(vpar, v[d], pref, mag[d]));
      store_f(c2v + ((long long)(e0 + d) * z + j) * B + b, stored);
      const float dl = stored - old[d];
      if (dbase >= 0) {
        delta[((long long)(dbase + d) * z + j) * B + b] = dl;
      } else if (!frozen) {
        int src = j - edge_s[e0 + d];
        if (src < 0) src += z;
        total[((long long)edge_v[e0 + d] * z + src) * B + b] = t[d] + dl;
      }
    }
  }
}

// Deferred rows of one level: entry i adds, to variable block app_vb[i],
// the deltas of its slots (compact slots app_e, shifts app_s, in slot
// order) rolled back by their shifts, in frames that are not frozen.
__global__ void __launch_bounds__(kBT * kJT)
apply_kernel(float* __restrict__ total, const float* __restrict__ delta,
             const int32_t* __restrict__ done,
             const int* __restrict__ app_vb, const int* __restrict__ app_off,
             const int* __restrict__ app_e, const int* __restrict__ app_s,
             int z, int B) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int k = blockIdx.y * kJT + threadIdx.y;
  if (b >= B || k >= z || done[b]) return;
  const int i = blockIdx.z;
  const long long at = ((long long)app_vb[i] * z + k) * B + b;
  float tv = total[at];
  for (int a = app_off[i]; a < app_off[i + 1]; ++a) {
    int src = k + app_s[a];
    if (src >= z) src -= z;
    tv = tv + delta[((long long)app_e[a] * z + src) * B + b];
  }
  total[at] = tv;
}

// End-of-sweep syndrome test: per (cb, j, b) the parity of total<0 over the
// row's slots against synd, counted per frame into viol.
__global__ void __launch_bounds__(kBT * kJT)
parity_kernel(const float* __restrict__ total,
              const int8_t* __restrict__ synd, int32_t* __restrict__ viol,
              const int* __restrict__ row_off, const int* __restrict__ edge_v,
              const int* __restrict__ edge_s, int z, int B) {
  const int b = blockIdx.x * kBT + threadIdx.x;
  const int cb = blockIdx.z;
  const int j0 = blockIdx.y * (kJT * kJLOOP);
  const int e0 = row_off[cb], e1 = row_off[cb + 1];
  int nviol = 0;
  if (b < B) {
    for (int k = 0; k < kJLOOP; ++k) {
      const int j = j0 + k * kJT + threadIdx.y;
      if (j >= z) break;
      int par = 0;
      for (int e = e0; e < e1; ++e) {
        int src = j - edge_s[e];
        if (src < 0) src += z;
        par ^= total[((long long)edge_v[e] * z + src) * B + b] < 0.0f;
      }
      nviol += par != synd[((long long)cb * z + j) * B + b];
    }
  }
  add_block_counts<kBT, kJT>(nviol, b, B, viol);
}

struct Tables {
  const int* row_off;
  const int* edge_v;
  const int* edge_s;
  const int* level_rows;
  const int* defer_base;
  const int* app_vb;
  const int* app_off;
  const int* app_e;
  const int* app_s;
  const int* h_level_off;      // host [n_levels + 1], into level_rows
  const int* h_app_level_off;  // host [n_levels + 1], into app_vb
  int n_levels;
};

template <typename TM>
int launch_typed(float* total, void* c2v, const int8_t* synd, int32_t* done,
                 int32_t* iters, int32_t* viol, float* delta,
                 const Tables& tb, int nb_c, int dc_max, int z, int B,
                 int rule, int it0, int n, float tiny, float alpha,
                 float beta, cudaStream_t stream) {
  const float tanh_sat = tanh_saturation();
  const dim3 block(kBT, kJT);
  const int bx = (B + kBT - 1) / kBT;
  const int by = (z + kJT - 1) / kJT;
  TM* cp = static_cast<TM*>(c2v);
  for (int k = 0; k < n; ++k) {
    for (int L = 0; L < tb.n_levels; ++L) {
      const int r0 = tb.h_level_off[L], nr = tb.h_level_off[L + 1] - r0;
      if (dc_max <= 8) {
        layer_kernel<TM, 8><<<dim3(bx, by, nr), block, 0, stream>>>(
            total, cp, delta, synd, done, tb.level_rows + r0, tb.row_off,
            tb.edge_v, tb.edge_s, tb.defer_base, z, B, rule, tiny, alpha,
            beta, tanh_sat);
      } else {
        layer_kernel<TM, kMaxDc><<<dim3(bx, by, nr), block, 0, stream>>>(
            total, cp, delta, synd, done, tb.level_rows + r0, tb.row_off,
            tb.edge_v, tb.edge_s, tb.defer_base, z, B, rule, tiny, alpha,
            beta, tanh_sat);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int a0 = tb.h_app_level_off[L];
      const int na = tb.h_app_level_off[L + 1] - a0;
      if (na > 0) {
        apply_kernel<<<dim3(bx, by, na), block, 0, stream>>>(
            total, delta, done, tb.app_vb + a0, tb.app_off + a0, tb.app_e,
            tb.app_s, z, B);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
    }
    parity_kernel<<<dim3(bx, (z + kJT * kJLOOP - 1) / (kJT * kJLOOP), nb_c),
                    block, 0, stream>>>(total, synd, viol, tb.row_off,
                                        tb.edge_v, tb.edge_s, z, B);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch_bookkeeping(viol, done, iters, B, it0 + k + 1, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Launch n sweeps on `stream`; returns the first non-zero cudaGetLastError()
// after a launch (0 = ok), or cudaErrorInvalidValue for arguments the
// kernels do not take.  h_level_off and h_app_level_off are host arrays.
extern "C" int bp_layered_sweeps_qc_launch(
    void* total, void* c2v, const void* synd, void* done, void* iters,
    void* viol, void* delta, const void* row_off, const void* edge_v,
    const void* edge_s, const void* level_rows, const void* defer_base,
    const void* app_vb, const void* app_off, const void* app_e,
    const void* app_s, const void* h_level_off, const void* h_app_level_off,
    int n_levels, int m_dtype, int nb_c, int dc_max, int z, int B, int rule,
    int it0, int n, float tiny, float alpha, float beta, void* stream) {
  if (dc_max < 1 || dc_max > kMaxDc || nb_c < 1 || nb_c > 65535 ||
      n_levels < 1 || z < 1 || (z + kJT - 1) / kJT > 65535 || B < 1 ||
      n < 0 || rule < kPhi || rule > kMinSum)
    return (int)cudaErrorInvalidValue;
  const Tables tb{static_cast<const int*>(row_off),
                  static_cast<const int*>(edge_v),
                  static_cast<const int*>(edge_s),
                  static_cast<const int*>(level_rows),
                  static_cast<const int*>(defer_base),
                  static_cast<const int*>(app_vb),
                  static_cast<const int*>(app_off),
                  static_cast<const int*>(app_e),
                  static_cast<const int*>(app_s),
                  static_cast<const int*>(h_level_off),
                  static_cast<const int*>(h_app_level_off),
                  n_levels};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tp = static_cast<float*>(total);
  const int8_t* sp = static_cast<const int8_t*>(synd);
  int32_t* dp = static_cast<int32_t*>(done);
  int32_t* ip = static_cast<int32_t*>(iters);
  int32_t* vp = static_cast<int32_t*>(viol);
  float* dl = static_cast<float*>(delta);
  if (m_dtype == kF32) {
    return launch_typed<float>(tp, c2v, sp, dp, ip, vp, dl, tb, nb_c, dc_max,
                               z, B, rule, it0, n, tiny, alpha, beta, s);
  } else if (m_dtype == kBF16) {
    return launch_typed<__nv_bfloat16>(tp, c2v, sp, dp, ip, vp, dl, tb, nb_c,
                                       dc_max, z, B, rule, it0, n, tiny,
                                       alpha, beta, s);
  }
  return (int)cudaErrorInvalidValue;
}
