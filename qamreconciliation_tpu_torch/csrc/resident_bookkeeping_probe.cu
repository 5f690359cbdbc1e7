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
// streams the state from device memory takes 0.046 ms.  A frame's c2v (389
// KB) does not fit in shared memory, so every pass streams it: 149 MB an
// iteration over the 128 frames.
//
// Design: kernel 2's frame ownership (bp_resident.cuh): the state copied
// once per call into frame-major scratch, one launch running the K
// iterations with a persistent block owning a frame, the frame's totals in
// shared memory where the launch plan fits them, the violation count a
// block reduction.  The variant is a template argument, so each instance
// holds only its own bookkeeping.  The launch plan (ops/kernels.py
// staged_rows_plan) picks one of two paths, and the launch checks it
// against the kernel's own layout and limits:
//   * bulk (z a multiple of 8, so that a c2v row of z bf16 values is a
//     16-byte multiple): the c2v rows reach the threads through a ring of
//     `stages` stages in shared memory.  The work of a frame is a sequence
//     of items, per iteration the nb_c check blocks and then the nb_v
//     variable blocks; a stage holds one item's rows.  One producer warp
//     (its lane 0) loads each item with TMA bulk copies (cp.async.bulk,
//     complete_tx on the stage's full mbarrier with the exact bytes): a
//     check block's dc rows are one contiguous run of the frame's c2v, a
//     variable block's dv rows are one copy each in (row, slot) order,
//     followed by its prior row.  The consumer warps compute item n from
//     its stage while items n+1 .. n+stages-1 are in flight, a thread on
//     a pair of adjacent lanes (one 32-bit word of a staged row), two
//     slots at a time, with the code's tables in shared memory.  The check
//     pass reads the rolled totals and the staged row once, keeps the
//     minima, the argmin and the sign word of each lane in registers (no
//     scratch column), and writes the new messages into the staged row in
//     place; every consumer fences the async proxy, each consumer warp
//     arrives once on the stage's empty mbarrier, and the producer then
//     stores the rows back with one bulk copy
//     (cp.async.bulk.global.shared::cta) and refills the stage only after
//     cp.async.bulk.wait_group.read.  Before the first variable block's
//     loads, which read rows this pass stored, the producer retires every
//     check block and waits for its stores to complete
//     (cp.async.bulk.wait_group 0): .read alone would let the loads see old
//     messages.  The consumers separate the passes with a named barrier of
//     their own, so the next iteration's check blocks load while the
//     variable pass runs.
//   * thread (z not a multiple of 8, a variable block of more than 32
//     edges, or no two-stage ring fits): kernel 2's direct loads, one (row,
//     lane) pair a thread with the slots in a shared-memory scratch column
//     (resident_plan's min-sum layout).
// Both paths keep each pair's slot order, the all-but-one minimum, the
// bf16 rounding of each message and the variable pass's bf16 left fold in
// (row, slot) order, and use no atomics on the state.
//
// Measured on the H100 (PERF.md): the check pass's slot arithmetic on
// shared memory, not the stream, takes most of a bulk-path iteration.

#include "bp_check_tile.cuh"
#include "bp_resident.cuh"

namespace {

using namespace bp;
using bf16 = __nv_bfloat16;

enum Variant { kNoBook = 0, kViolOnly = 1, kNoCapture = 2, kFull = 3 };

constexpr int kRowStagesMax = 4;  // stages of the bulk path's ring at most
constexpr int kProducer = 32;     // threads of the producer warp

// Byte offsets of the bulk path's dynamic shared memory: the frame's totals
// (when the plan keeps them there), `stages` stages of `rows` rows of z
// bf16 values, a full and an empty mbarrier per stage, the block's counts
// and the code's tables (RowTabs).  ops/kernels.py staged_rows_smem
// mirrors it.
struct RowsLayout {
  long long ring, stage, bar, red, rt, ce, cs, ro, co, total;
};

__host__ __device__ inline RowsLayout rows_layout(const ResShape& sh,
                                                  int rows, int stages) {
  auto up = [](long long x) { return (x + 15) & ~15LL; };
  RowsLayout L;
  L.ring = sh.totals_shared ? up((long long)sh.nb_v * sh.z * 2) : 0;
  L.stage = up((long long)rows * sh.z * 2);
  L.bar = L.ring + stages * L.stage;
  L.red = L.bar + 16 * stages;
  L.rt = L.red + 16;
  L.ce = L.rt + up(8LL * sh.E);
  L.cs = L.ce + up(4LL * sh.E);
  L.ro = L.cs + up(4LL * sh.E);
  L.co = L.ro + up(4LL * (sh.nb_c + 1));
  L.total = L.co + up(4LL * (sh.nb_v + 1));
  return L;
}

// The code's tables in shared memory, filled once a launch: per edge e
// (row order) its totals row less its shift, edge_v * z - s, and the shift
// s; per edge i of the column order col_e and col_s; row_off and col_off.
struct RowTabs {
  const int2* rt;
  const int *ce, *cs, *ro, *co;
};

// Check a bulk-path plan (ops/kernels.py staged_rows_plan) against the
// layout and limits: z a multiple of 8 and 16-byte aligned scratch, one
// producer warp beside at least one consumer warp, lanes = ceil(z /
// consumers), 2..kRowStagesMax stages of rows that hold a check block and a
// variable block (at most kMaxDc edges) with its prior row, the shared
// memory of its layout, and no more blocks an SM than threads, registers
// and shared memory allow.
inline bool rows_plan_ok(const ResShape& sh, int dv_max, int threads,
                         int smem, int blocks_per_sm, int grid, int stages,
                         int rows, int lanes, const void* t_fm,
                         const void* c_fm, const void* p_fm) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int nc = threads - kProducer;
  if (sh.z % 8 || !al(t_fm) || !al(c_fm) || !al(p_fm) || threads % 32 ||
      nc < 32 || threads > kResThreadsMax || lanes != (sh.z + nc - 1) / nc ||
      stages < 2 || stages > kRowStagesMax || dv_max < 0 ||
      dv_max > kMaxDc || rows < sh.dc_max || rows < dv_max + 1 || grid < 1 ||
      blocks_per_sm < 1 || blocks_per_sm * threads > kThreadsSm ||
      (long long)blocks_per_sm * threads * kResRegs > kRegsSm ||
      (long long)blocks_per_sm * (smem + 1024) > kResSmemSm ||
      (sh.totals_shared && (long long)sh.nb_v * sh.z * 2 > kResSmemMax))
    return false;
  return rows_layout(sh, rows, stages).total == smem && smem <= kResSmemMax;
}

__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` of the mbarrier at `bar` to
// complete.  A ring that stalls for 2^34 clocks (about 9 s) traps, so that
// a fault fails the launch instead of holding the card.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 == 0)
      t0 = t;
    else if (t - t0 > (1LL << 34))
      __trap();
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from shared memory to global memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// This thread's bulk stores are complete in global memory.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The consumer warps' barrier (named barrier 1; the producer warp is not in
// it).
__device__ __forceinline__ void consumer_sync(int nc) {
  asm volatile("bar.sync 1, %0;" ::"r"(nc) : "memory");
}

// Steps through a block's items: per frame b (blockIdx.x, then gridDim.x
// further), per iteration k < n, the nb_c check blocks w < nb_c and then
// the nb_v variable blocks w - nb_c; each item takes the next stage s of
// the ring, whose mbarriers complete their phase of parity ph for it.
struct ItemCursor {
  int b, k = 0, w = 0, s = 0;
  uint32_t ph = 0;
  __device__ explicit ItemCursor(int b0) : b(b0) {}
  __device__ void next(int n, int per, int S) {
    if (++s == S) {
      s = 0;
      ph ^= 1u;
    }
    if (++w == per) {
      w = 0;
      if (++k == n) {
        k = 0;
        b += gridDim.x;
      }
    }
  }
};

// The producer (lane 0 of the last warp): loads every item of the block
// into the ring in order, and stores each check block's new messages back
// once its consumers are done with the stage.
__device__ void produce(bf16* c2v, const bf16* prior, const RowTabs& tb,
                        const ResShape& sh, int n, char* ring, int st_bytes,
                        int S, uint32_t bars) {
  if (n == 0) return;
  const int z = sh.z, per = sh.nb_c + sh.nb_v;
  const uint32_t row = (uint32_t)z * 2;
  const long long NV = (long long)sh.nb_v * z, NE = (long long)sh.E * z;
  auto full = [&](int s) { return bars + 16 * s; };
  auto stage = [&](int s) { return smem_u32(ring + s * st_bytes); };
  ItemCursor ci(blockIdx.x), cr(blockIdx.x);
  int loaded = 0, retired = 0;
  // wait until the consumers are done with the oldest item; a check block
  // leaves with one bulk store of its rows
  auto retire = [&]() {
    ring_wait(bars + 16 * cr.s + 8, cr.ph);
    if (cr.w < sh.nb_c) {
      const int e0 = tb.ro[cr.w], dc = tb.ro[cr.w + 1] - e0;
      bulk_s2g(c2v + cr.b * NE + e0 * z, stage(cr.s), dc * row);
      bulk_commit();
    }
    cr.next(n, per, S);
    ++retired;
  };
  for (; ci.b < sh.B; ci.next(n, per, S), ++loaded) {
    if (ci.w == sh.nb_c) {
      // the variable pass loads rows this check pass stored
      while (retired < loaded) retire();
      bulk_wait_all();
    }
    if (loaded >= S) {
      while (retired + S <= loaded) retire();
      bulk_wait_read();
    }
    const uint32_t st = stage(ci.s), bar = full(ci.s);
    if (ci.w < sh.nb_c) {
      const int e0 = tb.ro[ci.w];
      const uint32_t bytes = (tb.ro[ci.w + 1] - e0) * row;
      mbar_expect_tx(bar, bytes);
      bulk_g2s(st, c2v + ci.b * NE + e0 * z, bytes, bar);
    } else {
      const int v = ci.w - sh.nb_c;
      const int c0 = tb.co[v], c1 = tb.co[v + 1];
      mbar_expect_tx(bar, (c1 - c0 + 1) * row);
      for (int i = c0; i < c1; ++i)
        bulk_g2s(st + (i - c0) * row, c2v + ci.b * NE + tb.ce[i] * z, row,
                 bar);
      bulk_g2s(st + (c1 - c0) * row, prior + ci.b * NV + v * z, row, bar);
    }
  }
  while (retired < loaded) retire();
  bulk_wait_all();
}

// Two bf16 values of one 32-bit word as floats: the lower address first.
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The new messages of check block cb for the consumer's lane pairs (j0, j0
// + 1) = (2p, 2p + 1), p = c, c + nc, ..., from the rolled totals T and
// the block's c2v rows staged at st, written into st in place.
// check_update<kMinSum>'s values (bp_resident.cuh), from the same
// operations in the same slot order, with a leaner running state: the
// minimum m1, the multiplicity cnt, the slot arg that last made cnt one
// (the unique argmin whenever cnt ends at one) and m2, which takes
// min(m2, |v|) where check_update keeps m2 on a tie with m1; the two agree
// wherever m2 is read, that is where cnt ends at one.  So pass 2 needs no
// load.  The sign word holds slot d at bit dc - 1 - d, and the sign
// (-1)^(parity ^ neg_d) is the exact float +-1.0f that signed_message
// converts from an int.  A pair's staged values, syndrome bits and new
// messages move as one 32-bit word (16 bits for the syndrome); its rolled
// totals are two loads, since the shift's parity sets their alignment.
// Lane l of each warp loads slot l's
// totals offset and shift (dc <= 32) and the slots take them by shuffle,
// two slots at a time; a warp's lanes run the same pair groups, those past
// the row on the clamped last pair without storing.  Returns the lanes
// whose totals violate the check.
__device__ __forceinline__ int check_rows(const bf16* T, bf16* st,
                                          const int8_t* S, int cb,
                                          const RowTabs& tb, int z, int c,
                                          int nc, float alpha) {
  const int e0 = tb.ro[cb], dc = tb.ro[cb + 1] - e0;
  const int l = c & 31, pairs = z / 2;
  // slot l's totals row less its shift, and the shift
  const int2 t_l = l < dc ? tb.rt[e0 + l] : make_int2(0, 0);
  const int off_l = t_l.x, s_l = t_l.y;
  int nviol = 0;
  for (int base = c - l; base < pairs; base += nc) {
    const int p = min(base + l, pairs - 1), j0 = 2 * p;
    // the syndrome bits, loaded while pass 1 runs
    const uint32_t sw =
        *reinterpret_cast<const uint16_t*>(S + cb * z + j0);
    int tneg[2] = {0, 0}, cnt[2] = {0, 0}, arg[2] = {-1, -1};
    float m1[2] = {INFINITY, INFINITY}, m2[2] = {INFINITY, INFINITY};
    uint32_t neg[2] = {0u, 0u};
    const uint32_t* row32 = reinterpret_cast<const uint32_t*>(st) + p;
    auto slot = [&](int d) {
      const int sd = __shfl_sync(0xffffffffu, s_l, d);
      const int off = __shfl_sync(0xffffffffu, off_l, d);
      // the totals at (j - s) mod z
      const int ta = off + j0 + (j0 < sd ? z : 0);
      float td[2], v[2];
      td[0] = load_f(T + ta);
      td[1] = load_f(T + (j0 + 1 == sd ? ta + 1 - z : ta + 1));
      const uint32_t cw = row32[d * pairs];
      v[0] = __fsub_rn(td[0], lo_f(cw));
      v[1] = __fsub_rn(td[1], hi_f(cw));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        tneg[q] ^= (td[q] < 0.0f);
        neg[q] = neg[q] * 2u + (uint32_t)(v[q] < 0.0f);
        const float a = fabsf(v[q]);
        const bool lt = a < m1[q], eq = a == m1[q];
        arg[q] = lt || (eq && cnt[q] == 0) ? d : arg[q];
        cnt[q] = lt ? 1 : cnt[q] + (int)eq;
        m2[q] = lt ? m1[q] : fminf(m2[q], a);
        m1[q] = fminf(m1[q], a);
      }
    };
    int d = 0;
    for (; d + 2 <= dc; d += 2) {
      slot(d);
      slot(d + 1);
    }
    if (d < dc) slot(d);
    float lo[2], hi[2], pref[2];
    int at[2];
    uint32_t flip[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = (int)(int8_t)(sw >> (8 * q));
      nviol += base + l < pairs && tneg[q] != s;
      // the unique argmin sees the minimum of the others and of its own
      // +1e30 stand-in, every other slot the minimum
      lo[q] = __fmul_rn(alpha, m1[q]);
      hi[q] = __fmul_rn(alpha, fminf(m2[q], 1e30f));
      at[q] = cnt[q] == 1 ? arg[q] : -1;
      pref[q] = (float)(1 - 2 * s);
      // slot k's sign is -1 where (parity of all v < 0) ^ (v_k < 0)
      flip[q] = (neg[q] ^ (__popc(neg[q]) & 1 ? 0xffffffffu : 0u))
                << (32 - dc);
    }
    if (base + l >= pairs) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(st) + p;
    for (int k = 0; k < dc; ++k) {
      float msg[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float sg =
            __uint_as_float(0x3f800000u | ((flip[q] << k) & 0x80000000u));
        msg[q] = __fmul_rn(sg * pref[q], k == at[q] ? hi[q] : lo[q]);
      }
      const __nv_bfloat162 m2v = __floats2bfloat162_rn(msg[0], msg[1]);
      out[k * pairs] = *reinterpret_cast<const uint32_t*>(&m2v);
    }
  }
  return nviol;
}

// The totals of variable block v for the consumer's lane pairs: the bf16
// left fold of its dv staged c2v rows read at (j + s_i) mod z, in (row,
// slot) order, added to the staged prior row (row dv) and rounded; in a
// frame converging now (`capture`), final = the totals first.  Lane l of
// each warp loads edge l's shift (dv <= 32); a pair's prior and totals
// move as one word, its rolled messages as two loads, as in check_rows.
__device__ __forceinline__ void var_rows(bf16* T, const bf16* st, bf16* F,
                                         int v, const RowTabs& tb, int z,
                                         int c, int nc, bool capture) {
  const int c0 = tb.co[v], dv = tb.co[v + 1] - c0;
  const int l = c & 31, pairs = z / 2;
  // edge l's shift
  const int s_l = l < dv ? tb.cs[c0 + l] : 0;
  for (int base = c - l; base < pairs; base += nc) {
    const int p = min(base + l, pairs - 1), j0 = 2 * p;
    float acc[2] = {0.0f, 0.0f};
    auto edge = [&](int i) {
      const int si = __shfl_sync(0xffffffffu, s_l, i);
      // c2v row i at (j + s) mod z
      const int a = i * z + j0 + si - (j0 >= z - si ? z : 0);
      const float x[2] = {load_f(st + a),
                          load_f(st + (j0 + 1 == z - si ? a + 1 - z : a + 1))};
#pragma unroll
      for (int q = 0; q < 2; ++q)
        acc[q] = i == 0 ? x[q] : round_as<bf16>(__fadd_rn(acc[q], x[q]));
    };
    int i = 0;
    for (; i + 2 <= dv; i += 2) {
      edge(i);
      edge(i + 1);
    }
    if (i < dv) edge(i);
    if (base + l >= pairs) continue;
    const int at = v * pairs + p;
    uint32_t* T32 = reinterpret_cast<uint32_t*>(T);
    if (capture) reinterpret_cast<uint32_t*>(F)[at] = T32[at];
    const uint32_t pw = reinterpret_cast<const uint32_t*>(st)[dv * pairs + p];
    const float p0 = lo_f(pw), p1 = hi_f(pw);
    const __nv_bfloat162 t2 = __floats2bfloat162_rn(
        dv > 0 ? __fadd_rn(p0, acc[0]) : p0,
        dv > 0 ? __fadd_rn(p1, acc[1]) : p1);
    T32[at] = *reinterpret_cast<const uint32_t*>(&t2);
  }
}

// The bulk path (see the head of this file).
template <int VARIANT, bool TSH>
__device__ void bulk_body(bf16* __restrict__ tot, bf16* __restrict__ c2v,
                          const bf16* __restrict__ prior,
                          const int8_t* __restrict__ synd,
                          bf16* __restrict__ fin, int32_t* __restrict__ done,
                          int32_t* __restrict__ iters,
                          int32_t* __restrict__ viol, const Rows& rw,
                          const Cols& cl, const ResShape& sh, int it0, int n,
                          float alpha, int S, int rows, char* smem) {
  const int tid = threadIdx.x, z = sh.z;
  const int nc = blockDim.x - kProducer;
  const RowsLayout L = rows_layout(sh, rows, S);
  char* ring = smem + L.ring;
  const uint32_t bars = smem_u32(smem + L.bar);
  int* red = reinterpret_cast<int*>(smem + L.red);
  int2* rt = reinterpret_cast<int2*>(smem + L.rt);
  int* ce = reinterpret_cast<int*>(smem + L.ce);
  int* cs = reinterpret_cast<int*>(smem + L.cs);
  int* ro = reinterpret_cast<int*>(smem + L.ro);
  int* co = reinterpret_cast<int*>(smem + L.co);
  for (int e = tid; e < sh.E; e += blockDim.x) {
    const int s = __ldg(rw.edge_s + e);
    rt[e] = make_int2(__ldg(rw.edge_v + e) * z - s, s);
    ce[e] = __ldg(cl.col_e + e);
    cs[e] = __ldg(cl.col_s + e);
  }
  for (int r = tid; r <= sh.nb_c; r += blockDim.x)
    ro[r] = __ldg(rw.row_off + r);
  for (int v = tid; v <= sh.nb_v; v += blockDim.x)
    co[v] = __ldg(cl.col_off + v);
  const RowTabs tb{rt, ce, cs, ro, co};
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 16 * s);
      mbar_init_count(bars + 16 * s + 8, nc / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= nc) {
    if (tid == nc)
      produce(c2v, prior, tb, sh, n, ring, (int)L.stage, S, bars);
    return;
  }

  const long long NV = (long long)sh.nb_v * z, NE = (long long)sh.E * z,
                  NC = (long long)sh.nb_c * z;
  int stg = 0;       // the consumers' stage
  uint32_t ph = 0;   // the parity of its current use
  auto take = [&]() {
    ring_wait(bars + 16 * stg, ph);
    return reinterpret_cast<bf16*>(ring + stg * (int)L.stage);
  };
  // one arrival a consumer warp, after every lane of it is done
  auto give = [&]() {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(bars + 16 * stg + 8);
    if (++stg == S) {
      stg = 0;
      ph ^= 1u;
    }
  };
  for (int b = blockIdx.x; b < sh.B; b += gridDim.x) {
    bf16* T = TSH ? reinterpret_cast<bf16*>(smem) : tot + b * NV;
    const int8_t* Sb = synd + b * NC;
    bf16* F = VARIANT == kFull ? fin + b * NV : nullptr;
    // the frame's totals are 16-byte units in both (z a multiple of 8)
    const int units = TSH ? sh.nb_v * z / 8 : 0;
    for (int i = tid; i < units; i += nc)
      reinterpret_cast<int4*>(T)[i] =
          reinterpret_cast<const int4*>(tot + b * NV)[i];
    int it_b = 0;
    if (tid == 0) {
      red[0] = 0;
      red[1] = done[b];
      red[2] = 0;
      it_b = iters[b];
    }
    consumer_sync(nc);
    for (int k = 0; k < n; ++k) {
      int nviol = 0;
      for (int cb = 0; cb < sh.nb_c; ++cb) {
        nviol += check_rows(T, take(), Sb, cb, tb, z, tid, nc, alpha);
        // the new messages, written through the generic proxy, come
        // before the producer's bulk store of the stage
        fence_proxy_async();
        give();
      }
      if (VARIANT >= kViolOnly) {
        block_add(nviol, red);
        consumer_sync(nc);
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
      consumer_sync(nc);  // every check block has read the totals
      const bool capture = VARIANT == kFull && red[2];
      for (int v = 0; v < sh.nb_v; ++v) {
        var_rows(T, take(), F, v, tb, z, tid, nc, capture);
        give();
      }
      consumer_sync(nc);  // the totals complete before the next check pass
    }
    for (int i = tid; i < units; i += nc)
      reinterpret_cast<int4*>(tot + b * NV)[i] =
          reinterpret_cast<const int4*>(T)[i];
    if (VARIANT >= kNoCapture && tid == 0) {
      done[b] = red[1];
      iters[b] = it_b;
    }
    consumer_sync(nc);  // before the next frame reuses the shared memory
  }
}

// The thread path: kernel 2's direct loads (see the head of this file).
template <int VARIANT, bool TSH>
__device__ void thread_body(bf16* __restrict__ tot, bf16* __restrict__ c2v,
                            const bf16* __restrict__ prior,
                            const int8_t* __restrict__ synd,
                            bf16* __restrict__ fin,
                            int32_t* __restrict__ done,
                            int32_t* __restrict__ iters,
                            int32_t* __restrict__ viol, const Rows& rw,
                            const Cols& cl, const ResShape& sh, int it0,
                            int n, float alpha, char* smem) {
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

template <int VARIANT, bool TSH, bool BULK>
__global__ void __launch_bounds__(kResThreadsMax, 1)
bookkeeping_kernel(bf16* __restrict__ tot, bf16* __restrict__ c2v,
                   const bf16* __restrict__ prior,
                   const int8_t* __restrict__ synd, bf16* __restrict__ fin,
                   int32_t* __restrict__ done, int32_t* __restrict__ iters,
                   int32_t* __restrict__ viol, Rows rw, Cols cl, ResShape sh,
                   int it0, int n, float alpha, int stages, int rows) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (BULK)
    bulk_body<VARIANT, TSH>(tot, c2v, prior, synd, fin, done, iters, viol,
                            rw, cl, sh, it0, n, alpha, stages, rows, smem);
  else
    thread_body<VARIANT, TSH>(tot, c2v, prior, synd, fin, done, iters, viol,
                              rw, cl, sh, it0, n, alpha, smem);
}

struct Launch {
  int bulk, threads, smem, grid, stages, rows;
};

template <int VARIANT, bool TSH, bool BULK>
int launch_instance(void* t_fm, void* c_fm, const void* p_fm,
                    const void* s_fm, void* f_fm, void* done, void* iters,
                    void* viol, const Rows& rw, const Cols& cl,
                    const ResShape& sh, int it0, int n, float alpha,
                    const Launch& ln, cudaStream_t stream) {
  auto kern = bookkeeping_kernel<VARIANT, TSH, BULK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ln.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<ln.grid, ln.threads, ln.smem, stream>>>(
      static_cast<bf16*>(t_fm), static_cast<bf16*>(c_fm),
      static_cast<const bf16*>(p_fm), static_cast<const int8_t*>(s_fm),
      static_cast<bf16*>(f_fm), static_cast<int32_t*>(done),
      static_cast<int32_t*>(iters), static_cast<int32_t*>(viol), rw, cl, sh,
      it0, n, alpha, ln.stages, ln.rows);
  return (int)cudaGetLastError();
}

template <int VARIANT>
int launch_variant(void* t_fm, void* c_fm, const void* p_fm,
                   const void* s_fm, void* f_fm, void* done, void* iters,
                   void* viol, const Rows& rw, const Cols& cl,
                   const ResShape& sh, int it0, int n, float alpha,
                   const Launch& ln, cudaStream_t stream) {
  auto kern = sh.totals_shared
                  ? (ln.bulk ? launch_instance<VARIANT, true, true>
                             : launch_instance<VARIANT, true, false>)
                  : (ln.bulk ? launch_instance<VARIANT, false, true>
                             : launch_instance<VARIANT, false, false>);
  return kern(t_fm, c_fm, p_fm, s_fm, f_fm, done, iters, viol, rw, cl, sh,
              it0, n, alpha, ln, stream);
}

}  // namespace

// Run n iterations of `variant` on `stream` with the launch plan of
// ops/kernels.py staged_rows_plan (path: bulk 1 or thread 0; threads, the
// totals in shared memory or not, smem bytes, blocks an SM, grid; on the
// bulk path stages, rows a stage and lanes a consumer thread, on the thread
// path 0, 0 and 1 with resident_plan's min-sum layout): copy the state into
// the frame-major scratch t_fm/c_fm/p_fm/s_fm (and final into f_fm for the
// full variant), run the K-step kernel, copy total and c2v (and final)
// back.  dv_max is the most edges of a variable block.  *launches gets the
// number of kernels launched.  Returns the first non-zero
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for arguments or a
// plan the kernel does not take.
extern "C" int resident_bookkeeping_probe_launch(
    void* total, void* c2v, const void* prior, const void* synd, void* fin,
    void* done, void* iters, void* viol, void* t_fm, void* c_fm, void* p_fm,
    void* s_fm, void* f_fm, const void* row_off, const void* edge_v,
    const void* edge_s, const void* col_off, const void* col_e,
    const void* col_s, int nb_c, int nb_v, int E, int dc_max, int dv_max,
    int z, int B, int variant, int it0, int n, float alpha, int bulk,
    int threads, int totals_shared, int smem, int blocks_per_sm, int grid,
    int stages, int rows, int lanes, void* launches, void* stream) {
  int* nl = static_cast<int*>(launches);
  *nl = 0;
  if (dc_max < 1 || dc_max > kMaxDc || nb_c < 1 || nb_v < 1 || E < 1 ||
      z < 1 || B < 1 || n < 0 || variant < kNoBook || variant > kFull ||
      (long long)E * z >= (1LL << 31) || (long long)nb_v * z >= (1LL << 31) ||
      (long long)nb_c * z >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const ResShape sh{nb_c, nb_v, E, z, B, dc_max, totals_shared ? 1 : 0, 0};
  const bool ok =
      bulk ? rows_plan_ok(sh, dv_max, threads, smem, blocks_per_sm, grid,
                          stages, rows, lanes, t_fm, c_fm, p_fm)
           : stages == 0 && rows == 0 && lanes == 1 &&
                 res_plan_ok(sh, 2, res_scratch(kMinSum, false), threads,
                             smem, blocks_per_sm, grid, 1, 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  const Launch ln{bulk ? 1 : 0, threads, smem, grid, stages, rows};
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
                                    viol, rw, cl, sh, it0, n, alpha, ln, s);
      break;
    case kViolOnly:
      err = launch_variant<kViolOnly>(t_fm, c_fm, p_fm, s_fm, f_fm, done,
                                      iters, viol, rw, cl, sh, it0, n, alpha,
                                      ln, s);
      break;
    case kNoCapture:
      err = launch_variant<kNoCapture>(t_fm, c_fm, p_fm, s_fm, f_fm, done,
                                       iters, viol, rw, cl, sh, it0, n,
                                       alpha, ln, s);
      break;
    default:
      err = launch_variant<kFull>(t_fm, c_fm, p_fm, s_fm, f_fm, done, iters,
                                  viol, rw, cl, sh, it0, n, alpha, ln, s);
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
