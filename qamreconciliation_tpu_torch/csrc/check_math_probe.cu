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
// f32, 0.050 / 0.094 ms at the H100's 3.35 TB/s.  Phi adds two precise
// tanhf/logf chains a slot, a few hundred instructions a check, which the
// card issues only with enough independent chains in flight.
//
// Design (launch plan: ops/kernels.py probe_tile_plan; the launch checks it
// against the layout and limits below and does not choose it):
//   * tiles of `kt` checks of one block row by `bB` frames (all B up to
//     256); each of the 256 consumer threads owns one frame b of a tile and
//     every R-th check of it (R = 256 / bB), the same number of pairs for
//     every thread, so that warp-wide steps stay converged; persistent
//     blocks, each a contiguous run of tiles, up to 4 an SM (36 warps with
//     the producer warps);
//   * bulk path (B * element size a multiple of 16, aligned pointers): a
//     ring of `stages` stages in shared memory, one producer warp beside
//     eight consumer warps.  The producer keeps the TMA bulk loads of t,
//     c2v and synd in flight, one copy a slot when the tile holds all B
//     frames, else one a (slot, row), on the stage's full mbarrier (exact
//     bytes).  The consumers write the new messages over the stage's c2v
//     tile, fence the async proxy and arrive once a warp on the stage's
//     empty mbarrier; the producer then stores the tile with bulk copies
//     (cp.async.bulk.global.shared::cta) and refills the stage only after
//     cp.async.bulk.wait_group.read, so consumer threads issue no global
//     stores.  Thread path: no ring, each thread loads and stores its
//     pairs' slots itself, neighbouring threads on neighbouring frames;
//   * slot values in registers: for dc <= 8 each dc has its own instance,
//     and phi(|v_d|) (phi) or |v_d| (min-sum) and the sign word stay in
//     registers from pass 1 to pass 2, so pass 2 reads nothing.  The other
//     rows, and the thread path, keep them in a shared-memory column a
//     thread (the plan's "scratch" slots); copy keeps none: one pass;
//   * lockstep phi: phi_small on a group of a pair's slots at once (three
//     on register rows, two from the scratch), no branch between the
//     chains, then phi_large only where x >= 10: the bits of
//     phi_llr_branch.  Groups of 2, 4 and 6 register slots spilled in
//     some instance at the 56 registers a thread that four blocks of 288
//     threads leave (ptxas for sm_90a), groups of 3 did not, and all timed
//     alike on the H100: the SM's 36 warps hide the chains' latency;
//   * violations count in a register a thread, flushed by one integer
//     atomicAdd when the thread's run of tiles leaves a (block row, frame
//     tile);
//   * the shared-memory attribute is set by the caller's request only
//     (ops/kernels.py SmemGrants: once per instance, device and size).
// The operation order is that of the plain version, so the results are
// bit-identical to it.
//
// Measured on the H100 (PERF.md): phi runs about 0.7x kernel 1's phi on
// the same tiles and under twice the issue floor of its SASS, which lies
// above the bytes bound; copy and min-sum stream at 56-79% of it.

#include "bp_check_tile.cuh"

namespace {

using namespace bp;

constexpr int kConsumers = 256;   // consumer threads a block
constexpr int kProducer = 32;     // the bulk path's producer warp
constexpr int kBulkThreads = kConsumers + kProducer;
constexpr int kBlocksPerSm = 4;   // the register budget: 56 a thread
constexpr int kRegDc = 8;         // widest row with slot values in registers
constexpr int kPairsMax = 8;      // pairs a consumer thread takes a tile
constexpr int kStagesMax = 4;     // stages of the bulk path's ring
constexpr int kRegLock = 3;       // register slots whose phi runs in lockstep
constexpr int kLock = 2;          // scratch slots whose phi runs in lockstep
constexpr float kTiny = 1e-30f;   // phi's clamp, as kernel 1's

enum Slots { kNone = 0, kRegisters = 1, kScratch = 2 };

// Byte offsets of the dynamic shared memory: `stages` stages of [t tile,
// c2v tile, synd tile] ([dc][kt][bB] and [kt][bB]), a full and an empty
// mbarrier a stage, and on scratch slots one f32 column of dc values a
// consumer thread.  ops/kernels.py probe_tile_smem mirrors it.
struct ProbeLayout {
  int t, c, s, stage, bar, scr, total;
};

__host__ __device__ inline ProbeLayout probe_layout(int dc, int kt, int bB,
                                                    int stages, int tsz,
                                                    bool scratch) {
  const int P = kt * bB;
  ProbeLayout L;
  L.t = 0;
  L.c = up16(dc * P * tsz);
  L.s = 2 * L.c;
  L.stage = L.s + up16(P * 4);
  L.bar = stages * L.stage;
  L.scr = L.bar + 16 * stages;
  L.total = L.scr + (scratch ? dc * kConsumers * 4 : 0);
  return L;
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

// Wait for the phase of parity `parity` of the mbarrier at `bar`.  A ring
// that stalls for 2^34 clocks (about 9 s) traps, so that a fault fails the
// launch instead of holding the card.
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

// phi of the N values x in place: phi_small on all of them with no branch
// between the chains, then phi_large where x >= 10 (phi_llr_branch's bits;
// the values come clamped).
template <int N>
__device__ __forceinline__ void phi_lock(float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) y[k] = phi_small<float>(x[k]);
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (x[k] >= 10.0f) y[k] = phi_large<float>(x[k]);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = y[k];
}

// A pair's slot values from pass 1 to pass 2: in registers (DC > 0; every
// index is a compile-time constant once the slot loops unroll) or in the
// thread's column of the scratch (DC == 0, slot d at col[d * kConsumers]).
template <int DC>
struct Kept {
  float v[DC];
  __device__ __forceinline__ float get(int d) const { return v[d]; }
  __device__ __forceinline__ void set(int d, float x) { v[d] = x; }
};

template <>
struct Kept<0> {
  float* col;
  __device__ __forceinline__ float get(int d) const {
    return col[d * kConsumers];
  }
  __device__ __forceinline__ void set(int d, float x) {
    col[d * kConsumers] = x;
  }
};

// The slot math of one (check, frame) pair whose slot d lies at tp/cp + d *
// stride (t, c2v) and goes to op + d * stride; s its syndrome bit.  Writes
// only where `ok`; a pair that is not ok reads a valid pair and counts
// nothing.  Returns 1 where the pair's t signs violate s.  DC > 0: dc ==
// DC, the slot values in registers; DC == 0: any dc, the values in `col`
// (copy needs none).
template <typename T, int MATH, int DC, typename I>
__device__ __forceinline__ int pair_math(const T* tp, const T* cp, T* op,
                                         I stride, int s, int dc, float* col,
                                         bool ok) {
  int tneg = 0;
  if constexpr (MATH == kProbeCopy) {
    for (int d = 0; d < dc; ++d) {
      const float td = load_f(tp + d * stride);
      const float v = __fsub_rn(td, load_f(cp + d * stride));
      tneg ^= td < 0.0f;
      if (ok) store_f(op + d * stride, v);
    }
    return ok && tneg != s;
  } else {
    // the slots in groups of G whose phi chains run in lockstep: kRegLock
    // at a time on register rows, kLock from the scratch (the last group's
    // extra lanes repeat the last slot and keep nothing)
    constexpr int G = DC > 0 ? (DC < kRegLock ? DC : kRegLock) : kLock;
    const int n = DC > 0 ? DC : dc;
    Kept<DC> kept;
    if constexpr (DC == 0) kept.col = col;
    uint32_t neg = 0;
    float acc = 0.0f, m1 = INFINITY, m2 = INFINITY;
    // pass 1: t's parity, v's sign bits, and phi(|v|) or |v| with the
    // rule's running quantity
    auto gather = [&](int d0) {
      float x[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int d = min(d0 + k, n - 1);
        const float td = load_f(tp + d * stride);
        const float v = __fsub_rn(td, load_f(cp + d * stride));
        if (d0 + k < n) {
          tneg ^= td < 0.0f;
          neg |= (uint32_t)(v < 0.0f) << d;
        }
        x[k] = MATH == kPhi ? phi_clamp<float>(fabsf(v), kTiny) : fabsf(v);
      }
      if constexpr (MATH == kPhi) phi_lock(x);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (d0 + k < n) {
          if constexpr (MATH == kPhi) {
            acc = __fadd_rn(acc, x[k]);
          } else {
            // m1 the minimum, m2 the least value strictly above it (1e30
            // caps it in pass 2)
            const float a = x[k];
            const bool lt = a < m1;
            m2 = lt ? m1 : (a > m1 ? fminf(m2, a) : m2);
            m1 = lt ? a : m1;
          }
          kept.set(d0 + k, x[k]);
        }
      }
    };
    // pass 2: magnitudes, sign, (1 - 2 synd) prefactor
    int vpar = 0;
    float pref = 0.0f;
    auto emit = [&](int d0) {
      float y[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float a = kept.get(min(d0 + k, n - 1));
        if constexpr (MATH == kPhi) {
          y[k] = phi_clamp<float>(__fsub_rn(acc, a), kTiny);
        } else {
          // a slot at the minimum (ties included) sees min2, every other
          // slot the minimum; 0.8125 times that
          y[k] = __fmul_rn(0.8125f, a <= m1 ? fminf(m2, 1e30f) : m1);
        }
      }
      if constexpr (MATH == kPhi) phi_lock(y);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int d = d0 + k;
        if (d < n && ok) {
          const int nd = (int)((neg >> d) & 1u);
          const float sg = (float)(1 - 2 * (vpar ^ nd));
          store_f(op + d * stride, __fmul_rn(sg * pref, y[k]));
        }
      }
    };
    // register rows: every group index a compile-time constant
    if constexpr (DC > 0) {
#pragma unroll
      for (int d0 = 0; d0 < DC; d0 += G) gather(d0);
    } else {
      for (int d0 = 0; d0 < dc; d0 += G) gather(d0);
    }
    vpar = __popc(neg) & 1;
    pref = (float)(1 - 2 * s);
    if constexpr (DC > 0) {
#pragma unroll
      for (int d0 = 0; d0 < DC; d0 += G) emit(d0);
    } else {
      for (int d0 = 0; d0 < dc; d0 += G) emit(d0);
    }
    return ok && tneg != s;
  }
}

// Tile tau of a call: tau = (ft * G + g) * nct_g + ri, the check tile ri
// of block row g by the frame tile ft (ops/kernels.py probe_tile_plan's
// order); a block's run of tiles walks each row's check tiles in turn.
struct ProbeTile {
  int g, r0, nr, b0, nf;
  bool row_end;  // the last check tile of its (block row, frame tile)
};

__device__ __forceinline__ ProbeTile probe_tile(const TileShape& sh,
                                                int nct_g, int tau) {
  const int key = tau / nct_g, ri = tau - key * nct_g;
  const int ft = key / sh.G;
  ProbeTile tl;
  tl.g = key - ft * sh.G;
  tl.r0 = ri * sh.kt;
  tl.nr = min(sh.kt, sh.R - tl.r0);
  tl.b0 = ft * sh.bB;
  tl.nf = min(sh.bB, sh.B - tl.b0);
  tl.row_end = ri == nct_g - 1;
  return tl;
}

// The consumer side of one call: the thread's pairs of each tile of the
// block's run [first, end), from the ring's stages (BULK) or from global
// memory, and the violation counts.  On the bulk path each consumer warp
// gives every stage back once it is done with it.
template <typename T, int MATH, int DC, bool BULK>
__device__ void consume(const T* __restrict__ t, const T* __restrict__ c2v,
                        const int32_t* __restrict__ synd, T* __restrict__ out,
                        int32_t* __restrict__ viol, const TileShape& sh,
                        const ProbeLayout& L, char* smem, int first, int end,
                        int nct_g) {
  const int tid = threadIdx.x, bB = sh.bB, R = kConsumers / bB;
  // a thread past the R rows of frames takes row 0's checks and counts
  // nothing, so that every thread runs the same pairs
  const bool lane_ok = tid < R * bB;
  const int b = tid % bB, i0 = lane_ok ? tid / bB : 0;
  float* col = reinterpret_cast<float*>(smem + L.scr) + tid;
  const uint32_t bars = smem_u32(smem + L.bar);
  int stg = 0;      // the consumers' stage
  uint32_t ph = 0;  // the parity of its current use
  int vc = 0;
  for (int tau = first; tau < end; ++tau) {
    const ProbeTile tl = probe_tile(sh, nct_g, tau);
    // the checks of the tile this thread runs (none past the frames), and
    // where its count goes once the run leaves the (block row, frame
    // tile), else -1: two values live across the pairs, not five
    const int nr = lane_ok && b < tl.nf ? tl.nr : 0;
    const int flush =
        tl.row_end || tau + 1 == end ? tl.g * sh.B + tl.b0 + b : -1;
    if constexpr (BULK) {
      ring_wait(bars + 16 * stg, ph);
      char* st = smem + stg * L.stage;
      const T* ts = reinterpret_cast<const T*>(st + L.t);
      T* cs = reinterpret_cast<T*>(st + L.c);
      const int32_t* ss = reinterpret_cast<const int32_t*>(st + L.s);
      const int P = sh.kt * bB;
      // one pair an iteration (its slots are the lockstep chains)
#pragma unroll 1
      for (int i = i0; i < sh.kt; i += R) {
        const bool ok = i < nr;
        const int p = ok ? i * bB + b : 0;
        vc += pair_math<T, MATH, DC>(ts + p, cs + p, cs + p, P, ss[p], sh.dc,
                                     col, ok);
      }
      // the new messages, written through the generic proxy, come before
      // the producer's bulk store of the stage
      fence_proxy_async();
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(bars + 16 * stg + 8);
      if (++stg == sh.stages) {
        stg = 0;
        ph ^= 1u;
      }
    } else {
      const long long zB = (long long)sh.R * sh.B;
#pragma unroll 1
      for (int i = i0; i < sh.kt; i += R) {
        const bool ok = i < nr;
        const long long row = (long long)tl.g * sh.R + tl.r0 + i;
        const long long e =
            ok ? (row + (long long)tl.g * (sh.dc - 1) * sh.R) * sh.B + tl.b0 +
                     b
               : 0;
        const long long se = ok ? row * sh.B + tl.b0 + b : 0;
        vc += pair_math<T, MATH, DC>(t + e, c2v + e, out + e, zB, synd[se],
                                     sh.dc, col, ok);
      }
    }
    if (flush >= 0) {
      if (vc) atomicAdd(viol + flush, vc);
      vc = 0;
    }
  }
}

// The producer warp of the bulk path: loads the block's tiles [first, end)
// into the ring in order, and stores each tile's new messages once its
// consumers are done with the stage, before the stage takes the tile
// `stages` further.  Each lane issues a share of the copies and waits for
// its own bulk groups.
template <typename T>
__device__ void produce(const T* t, const T* c2v, const int32_t* synd,
                        T* out, const TileShape& sh, const ProbeLayout& L,
                        char* smem, int first, int end, int nct_g) {
  constexpr int kTsz = sizeof(T);
  const int lane = threadIdx.x - kConsumers, S = sh.stages;
  const bool whole = sh.bB == sh.B;
  const uint32_t bars = smem_u32(smem + L.bar);
  int rtau = first;  // the oldest tile not yet stored
  int rs = 0;        // its stage
  uint32_t rph = 0;  // the parity of the stage's use
  auto slot_at = [&](const ProbeTile& tl, int d, int i) {
    return (((long long)tl.g * sh.dc + d) * sh.R + tl.r0 + i) * sh.B + tl.b0;
  };
  // store the oldest tile's new messages (the c2v tile) once the consumers
  // gave its stage back
  auto retire = [&]() {
    const ProbeTile tl = probe_tile(sh, nct_g, rtau++);
    ring_wait(bars + 16 * rs + 8, rph);
    const int rows = whole ? 1 : tl.nr;
    const uint32_t span = (uint32_t)(whole ? tl.nr * sh.B : tl.nf) * kTsz;
    const uint32_t st = smem_u32(smem + rs * L.stage + L.c);
    for (int q = lane; q < sh.dc * rows; q += 32) {
      const int d = q / rows, i = q - d * rows;
      bulk_s2g(out + slot_at(tl, d, i),
               st + (uint32_t)((d * sh.kt + i) * sh.bB * kTsz), span);
    }
    bulk_commit();
    if (++rs == S) {
      rs = 0;
      rph ^= 1u;
    }
  };
  int s = 0;
  for (int tau = first; tau < end; ++tau) {
    if (tau - first >= S) {
      retire();
      bulk_wait_read();  // the stage's stores have read it
    }
    __syncwarp();
    const ProbeTile tl = probe_tile(sh, nct_g, tau);
    const uint32_t bar = bars + 16 * s;
    const char* st = smem + s * L.stage;
    if (lane == 0)
      mbar_expect_tx(bar, (uint32_t)tl.nr * tl.nf * (2 * sh.dc * kTsz + 4));
    __syncwarp();
    const int rows = whole ? 1 : tl.nr;             // copies per slot
    const int span = whole ? tl.nr * sh.B : tl.nf;  // elements per copy
    for (int q = lane; q < (2 * sh.dc + 1) * rows; q += 32) {
      // a: slot a of t, slot a - dc of c2v, or (a == 2 dc) synd
      const int a = q / rows, i = q - a * rows;
      if (a < 2 * sh.dc) {
        const bool is_t = a < sh.dc;
        const int d = is_t ? a : a - sh.dc;
        const int se = (d * sh.kt + i) * sh.bB * kTsz;
        bulk_g2s(smem_u32(st + (is_t ? L.t : L.c) + se),
                 (is_t ? t : c2v) + slot_at(tl, d, i), span * kTsz, bar);
      } else {
        bulk_g2s(smem_u32(st + L.s + i * sh.bB * 4),
                 synd + ((long long)tl.g * sh.R + tl.r0 + i) * sh.B + tl.b0,
                 span * 4, bar);
      }
    }
    if (++s == S) s = 0;
  }
  while (rtau < end) retire();
  bulk_wait_all();
}

template <typename T, int MATH, int DC, bool BULK>
__global__ void __launch_bounds__(kBulkThreads, kBlocksPerSm)
check_math_kernel(const T* __restrict__ t, const T* __restrict__ c2v,
                  const int32_t* __restrict__ synd, T* __restrict__ out,
                  int32_t* __restrict__ viol, TileShape sh) {
  extern __shared__ __align__(16) char smem[];
  const ProbeLayout L =
      probe_layout(sh.dc, sh.kt, sh.bB, sh.stages, sizeof(T),
                   MATH != kProbeCopy && (DC == 0));
  // this block's contiguous run of tiles
  const int nct_g = (sh.R + sh.kt - 1) / sh.kt;
  const int tiles = sh.G * nct_g * ((sh.B + sh.bB - 1) / sh.bB);
  const int each = tiles / gridDim.x, extra = tiles % gridDim.x;
  const int bid = blockIdx.x;
  const int first = bid * each + min(bid, extra);
  const int end = first + each + (bid < extra);
  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < sh.stages; ++s) {
        mbar_init(smem_u32(smem + L.bar + 16 * s));
        mbar_init_count(smem_u32(smem + L.bar + 16 * s + 8), kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kConsumers) {
      produce<T>(t, c2v, synd, out, sh, L, smem, first, end, nct_g);
      return;
    }
  }
  consume<T, MATH, DC, BULK>(t, c2v, synd, out, viol, sh, L, smem, first,
                             end, nct_g);
}

struct Launch {
  int grid, threads, smem, set_attr;
};

template <typename T, int MATH, int DC, bool BULK>
int launch(const void* t, const void* c2v, const void* synd, void* out,
           void* viol, const TileShape& sh, const Launch& ln,
           cudaStream_t stream) {
  auto kern = check_math_kernel<T, MATH, DC, BULK>;
  if (ln.set_attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ln.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<ln.grid, ln.threads, ln.smem, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(c2v),
      static_cast<const int32_t*>(synd), static_cast<T*>(out),
      static_cast<int32_t*>(viol), sh);
  return (int)cudaGetLastError();
}

// The instance of `math` and the register slots' dc (0: scratch or none).
template <typename T, int MATH, bool BULK>
int launch_dc(int dc, const void* t, const void* c2v, const void* synd,
              void* out, void* viol, const TileShape& sh, const Launch& ln,
              cudaStream_t s) {
  if constexpr (BULK && MATH != kProbeCopy) {
    switch (dc) {
      case 1: return launch<T, MATH, 1, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 2: return launch<T, MATH, 2, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 3: return launch<T, MATH, 3, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 4: return launch<T, MATH, 4, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 5: return launch<T, MATH, 5, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 6: return launch<T, MATH, 6, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 7: return launch<T, MATH, 7, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      case 8: return launch<T, MATH, 8, BULK>(t, c2v, synd, out, viol, sh, ln, s);
      default: break;
    }
  }
  return launch<T, MATH, 0, BULK>(t, c2v, synd, out, viol, sh, ln, s);
}

template <typename T, bool BULK>
int launch_math(int math, int dc, const void* t, const void* c2v,
                const void* synd, void* out, void* viol, const TileShape& sh,
                const Launch& ln, cudaStream_t s) {
  if (math == kPhi)
    return launch_dc<T, kPhi, BULK>(dc, t, c2v, synd, out, viol, sh, ln, s);
  if (math == kProbeCopy)
    return launch_dc<T, kProbeCopy, BULK>(dc, t, c2v, synd, out, viol, sh,
                                          ln, s);
  return launch_dc<T, kProbeMinSum, BULK>(dc, t, c2v, synd, out, viol, sh,
                                          ln, s);
}

// Whether a plan fits the kernel's layout, alignment rules and limits: a
// consumer thread a frame of the tile and the same number (1..kPairsMax) of
// its checks; on the bulk path one producer warp, 2..kStagesMax stages and
// 16-byte units, on the thread path neither; the slots the math and dc
// call for; the layout's shared memory; no more blocks an SM than the
// register budget and shared memory allow.
inline bool plan_ok(const void* t, const void* c2v, const void* synd,
                    const void* out, const TileShape& sh, int tsz, int math,
                    int slots, int threads, int blocks_per_sm, int grid,
                    int smem) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (sh.bB < 1 || sh.bB > sh.B || sh.bB > kConsumers) return false;
  const int R = kConsumers / sh.bB;
  const int want_slots = math == kProbeCopy
                             ? kNone
                             : (sh.bulk && sh.dc <= kRegDc ? kRegisters
                                                           : kScratch);
  if (sh.kt < R || sh.kt % R || sh.kt / R > kPairsMax || grid < 1 ||
      slots != want_slots || blocks_per_sm < 1 ||
      blocks_per_sm > kBlocksPerSm || smem > kTileSmemMax ||
      blocks_per_sm * (smem + 1024) > kSmemPerSm)
    return false;
  if (sh.bulk) {
    if (threads != kBulkThreads || sh.stages < 2 ||
        sh.stages > kStagesMax || (sh.B * tsz) % 16 || (sh.bB * tsz) % 16 ||
        !al(t) || !al(c2v) || !al(synd) || !al(out))
      return false;
  } else if (threads != kConsumers || sh.stages != 0) {
    return false;
  }
  return probe_layout(sh.dc, sh.kt, sh.bB, sh.stages, tsz,
                      slots == kScratch)
             .total == smem;
}

}  // namespace

// Launch on `stream` with the plan of ops/kernels.py probe_tile_plan (path:
// bulk 1 or thread 0; slots 0 none, 1 registers, 2 scratch; threads,
// checks and frames a tile, stages, shared memory, blocks an SM, grid);
// `math` is kPhi, kProbeCopy or kProbeMinSum.  With set_attr the launch
// first sets the instance's shared-memory limit to `smem`.  Returns
// cudaGetLastError() after the launch (0 = ok), the attribute call's error,
// or cudaErrorInvalidValue for arguments or a plan the kernel does not
// take.
extern "C" int check_math_probe_launch(
    const void* t, const void* c2v, const void* synd, void* out, void* viol,
    int dtype, int nb_c, int dc, int z, int B, int math, int bulk, int slots,
    int threads, int kt, int bB, int stages, int smem, int blocks_per_sm,
    int grid, int set_attr, void* stream) {
  if (dc < 1 || dc > kMaxDc || nb_c < 1 || z < 1 || B < 1 ||
      (long long)nb_c * z * B >= (1LL << 31) ||
      (math != kPhi && math != kProbeCopy && math != kProbeMinSum) ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const TileShape sh{nb_c, dc, z, B, kt, bB, stages, bulk ? 1 : 0, z};
  const int tsz = dtype == kF32 ? 4 : 2;
  if (!plan_ok(t, c2v, synd, out, sh, tsz, math, slots, threads,
               blocks_per_sm, grid, smem))
    return (int)cudaErrorInvalidValue;
  const Launch ln{grid, threads, smem, set_attr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return bulk ? launch_math<float, true>(math, dc, t, c2v, synd, out, viol,
                                           sh, ln, s)
                : launch_math<float, false>(math, dc, t, c2v, synd, out,
                                            viol, sh, ln, s);
  return bulk ? launch_math<__nv_bfloat16, true>(math, dc, t, c2v, synd, out,
                                                 viol, sh, ln, s)
              : launch_math<__nv_bfloat16, false>(math, dc, t, c2v, synd,
                                                  out, viol, sh, ln, s);
}
