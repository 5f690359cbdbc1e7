// The frame-owning design shared by the two multi-step QC kernels,
// bp_decode_rounds_qc.cu (kernel 2, K flooding iterations a call) and
// bp_layered_sweeps_qc.cu (kernel 3, K layered sweeps a call), and by the
// bookkeeping probe resident_bookkeeping_probe.cu (kernel 9, kernel 2's
// check pass in four bookkeeping variants).
//
// Every dependency of those loops stays inside one frame: the rows of a
// layered sweep through the circulant rolls, a flooding iteration's check
// pass -> variable pass -> next check pass, and the convergence test.  So a
// persistent block owns one frame at a time for all K steps and separates
// levels, passes and steps with __syncthreads(), never with a kernel
// boundary: one launch runs the K steps of every frame.  The block's own
// reduction is the convergence test, and the block writes its frame's done
// and iters itself (no violation scratch, no atomics in device memory, no
// bookkeeping launch).
//
// Layout (a): the state [R, B] (frames innermost) is copied once per call
// into frame-major scratch [B, R] by a transposing kernel issued from the
// same C entry, and back at the end: a rolled read of one circulant row is
// then one contiguous run of z elements with at most one wrap, so a warp's
// lanes (consecutive lanes j of one row) read consecutive addresses.  Where
// the launch plan says so (ops/kernels.py resident_plan), the frame's totals
// live in shared memory for the whole call (bf16 totals of the headline
// code: 130 KB); else they stay in the scratch in device memory, 259 KB a
// frame in f32, 33 MB at B = 128, which L2 (50 MB) can hold.
//
// Check rows are computed one (row, lane) pair per thread.  The slots are
// never held in register arrays: pass 1 over the slots keeps what pass 2
// needs in an f32 shared-memory scratch column per thread (RuleChain: phi
// keeps phi(|v|); tanh-F/B its forward products and e^-|v|; min-sum |v|;
// the layered kernel also the slot's total and old message), the signs of a
// row are one 32-bit word, and each rule is its own instance.  The rule
// chains are the operations of the staged-tile check phase
// (bp_check_tile.cuh) in the same order, so both kernels are bit-identical
// to their plain versions in ops/kernels.py.

#pragma once

#include "bp_common.cuh"

namespace bp {

constexpr int kResThreadsMax = 1024;  // threads a block at most
// registers a thread at most: __launch_bounds__(kResThreadsMax, 1)
constexpr int kResRegs = 64;
constexpr int kResSmemMax = 232448;  // 227 KB, the most a block may use
constexpr int kResSmemSm = 233472;   // 228 KB an SM, 1 KB more a block
constexpr int kRegsSm = 65536;
constexpr int kThreadsSm = 2048;

// f32 scratch values per slot and thread: the rule's pass-1 values, and
// for the layered kernel the slot's total and old message.
__host__ __device__ inline int res_scratch(int rule, bool layered) {
  return (rule == kTanhFB ? 3 : 1) + (layered ? 2 : 0);
}

// What a launch covers, and where the frame's totals live.
struct ResShape {
  int nb_c, nb_v, E, z, B, dc_max;
  int totals_shared;  // 1: the frame's totals in shared memory
  int defer_slots;    // deferred slots of one level at most (layered)
};

// Byte offsets in the dynamic shared memory: the frame's totals (when the
// plan keeps them there), the scratch of `nscr` f32 values per slot and
// thread, one level's deferred deltas [defer_slots, z] (layered) and two
// ints for the block's violation count and done flag.  ops/kernels.py
// resident_smem mirrors it.
struct ResLayout {
  int tot, scr, dl, red, total;
};

__host__ __device__ inline ResLayout res_layout(const ResShape& sh, int tsz,
                                                int nscr, int threads) {
  ResLayout L;
  L.tot = 0;
  L.scr = sh.totals_shared ? up16(sh.nb_v * sh.z * tsz) : 0;
  L.dl = L.scr + up16(nscr * sh.dc_max * threads * 4);
  L.red = L.dl + up16(sh.defer_slots * sh.z * 4);
  L.total = L.red + 16;
  return L;
}

// Check a launch plan (ops/kernels.py resident_plan) against the kernel's
// own layout and limits: threads a multiple of 32 up to kResThreadsMax, one
// frame a block, no cluster, the shared memory of its layout, and no more
// blocks an SM than threads, registers and shared memory allow.
inline bool res_plan_ok(const ResShape& sh, int tsz, int nscr, int threads,
                        int smem, int blocks_per_sm, int grid, int cluster,
                        int frames) {
  if (threads < 32 || threads > kResThreadsMax || threads % 32 ||
      frames != 1 || cluster != 1 || grid < 1 || blocks_per_sm < 1 ||
      blocks_per_sm * threads > kThreadsSm ||
      (long long)blocks_per_sm * threads * kResRegs > kRegsSm ||
      (long long)blocks_per_sm * (smem + 1024) > kResSmemSm ||
      sh.defer_slots < 0 ||
      (long long)sh.defer_slots * sh.z * 4 > kResSmemMax ||
      (sh.totals_shared &&
       (long long)sh.nb_v * sh.z * tsz > kResSmemMax))
    return false;
  return res_layout(sh, tsz, nscr, threads).total == smem &&
         smem <= kResSmemMax;
}

// ------------------------------------------------------------------------
// Copies between the [R, B] state and the frame-major [B, R] scratch

struct TransposeJobs {
  const char* src[4];
  char* dst[4];
  long long rows[4];  // R of each array
  int esz[4];         // element size, bytes (1, 2 or 4)
  int n;              // arrays
  int B;
  int to_frames;      // 1: [R, B] -> [B, R]; 0: [B, R] -> [R, B]
};

// Rows r of a copy tile; a tile is kTrRows rows by 32 frames b, and each
// of a block's 256 threads moves kTrRows / 8 elements with its loads
// issued together: the copies are bound by the bytes in flight.
constexpr int kTrRows = 128;

// One tile of elements E between src and dst through shared memory, so
// that both the reads and the writes run along consecutive addresses.
// Element q of a thread is tile row rl, frame bl of one of two mappings:
// along b (rl = ty + 8 q, bl = tx) for [R, B], along r (rl = tx + 32 (q /
// 4), bl = ty + 8 (q % 4)) for [B, R]; each covers the tile once.
template <typename E>
__device__ __forceinline__ void transpose_tile(
    const char* src_, char* dst_, long long R, int B, long long r0, int b0,
    bool to_frames, uint32_t (&tile)[kTrRows][33]) {
  constexpr int Q = kTrRows / 8;
  const E* src = reinterpret_cast<const E*>(src_);
  E* dst = reinterpret_cast<E*>(dst_);
  const int tx = threadIdx.x, ty = threadIdx.y;
  auto along_b = [&](int q, int& rl, int& bl) {
    rl = ty + 8 * q;
    bl = tx;
  };
  auto along_r = [&](int q, int& rl, int& bl) {
    rl = tx + 32 * (q >> 2);
    bl = ty + 8 * (q & 3);
  };
  uint32_t v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int rl, bl;
    to_frames ? along_b(q, rl, bl) : along_r(q, rl, bl);
    const long long r = r0 + rl;
    const int b = b0 + bl;
    v[q] = r < R && b < B ? src[to_frames ? r * B + b : b * R + r] : 0u;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int rl, bl;
    to_frames ? along_b(q, rl, bl) : along_r(q, rl, bl);
    tile[rl][bl] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int rl, bl;
    to_frames ? along_r(q, rl, bl) : along_b(q, rl, bl);
    const long long r = r0 + rl;
    const int b = b0 + bl;
    if (r < R && b < B)
      dst[to_frames ? b * R + r : r * B + b] = (E)tile[rl][bl];
  }
}

// Tile (blockIdx.x, blockIdx.y) of array blockIdx.z.
__global__ void __launch_bounds__(256) transpose_kernel(TransposeJobs jb) {
  __shared__ uint32_t tile[kTrRows][33];
  // the fields of array blockIdx.z, selected without indexing the
  // parameter arrays at run time (which would copy them to the stack)
  const int a = blockIdx.z;
  auto pick = [a](auto x0, auto x1, auto x2, auto x3) {
    return a == 0 ? x0 : a == 1 ? x1 : a == 2 ? x2 : x3;
  };
  const long long R = pick(jb.rows[0], jb.rows[1], jb.rows[2], jb.rows[3]);
  const int esz = pick(jb.esz[0], jb.esz[1], jb.esz[2], jb.esz[3]);
  const char* src = pick(jb.src[0], jb.src[1], jb.src[2], jb.src[3]);
  char* dst = pick(jb.dst[0], jb.dst[1], jb.dst[2], jb.dst[3]);
  const long long r0 = (long long)blockIdx.x * kTrRows;
  const int b0 = blockIdx.y * 32;
  if (r0 >= R) return;
  const bool to_frames = jb.to_frames != 0;
  if (esz == 4)
    transpose_tile<uint32_t>(src, dst, R, jb.B, r0, b0, to_frames, tile);
  else if (esz == 2)
    transpose_tile<uint16_t>(src, dst, R, jb.B, r0, b0, to_frames, tile);
  else
    transpose_tile<uint8_t>(src, dst, R, jb.B, r0, b0, to_frames, tile);
}

inline int res_transpose(const TransposeJobs& jb, cudaStream_t stream) {
  long long rmax = 0;
  for (int a = 0; a < jb.n; ++a) rmax = jb.rows[a] > rmax ? jb.rows[a] : rmax;
  const dim3 grid((unsigned)((rmax + kTrRows - 1) / kTrRows),
                  (jb.B + 31) / 32, jb.n);
  transpose_kernel<<<grid, dim3(32, 8), 0, stream>>>(jb);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// Block-level helpers

// Steps a thread through the pairs (row r, lane j) of rows of z lanes,
// nthr pairs apart, without dividing in the loop.
struct PairCursor {
  int r, j, dr, dj;
  __device__ PairCursor(int tid, int nthr, int z)
      : r(tid / z), j(tid % z), dr(nthr / z), dj(nthr % z) {}
  __device__ void next(int z) {
    r += dr;
    j += dj;
    if (j >= z) {
      j -= z;
      ++r;
    }
  }
};

// Add every thread's count into *acc (shared memory): a warp sum by
// shuffles, then one shared integer atomicAdd per warp, which is
// order-free.  Every thread of the block calls it (full warps).
__device__ __forceinline__ void block_add(int count, int* acc) {
  for (int o = 16; o > 0; o >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, o);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(acc, count);
}

// Copy `bytes` (a multiple of 2) between the frame's totals in shared
// memory and its scratch in device memory, 16 bytes a thread where both
// line up.
__device__ __forceinline__ void block_copy(void* dst, const void* src,
                                           long long bytes) {
  const bool wide = bytes % 16 == 0 &&
                    ((reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  if (wide) {
    for (long long i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      static_cast<int4*>(dst)[i] = static_cast<const int4*>(src)[i];
  } else {
    for (long long i = threadIdx.x; i < bytes / 2; i += blockDim.x)
      static_cast<uint16_t*>(dst)[i] = static_cast<const uint16_t*>(src)[i];
  }
}

struct Rows {
  const int* row_off;  // [nb_c + 1], edges e = row_off[cb] + d
  const int* edge_v;   // [E] variable block of each edge
  const int* edge_s;   // [E] its shift in [0, z)
};

// ------------------------------------------------------------------------
// The rules' all-but-one magnitudes in two passes over a row's slots.
// push(d, |v_d|, col) runs for d ascending and keeps what pass 2 needs in
// the thread's scratch column `col` (value q of slot d at col[q * qs]);
// emit_all calls emit(d, magnitude) for every slot, reading the column of
// slot d at sc + d * nthr.  The operations are bp_check_tile.cuh's, in
// its order.

template <int RULE>
struct RuleChain;

template <>
struct RuleChain<kPhi> {
  static constexpr int kScratch = 1;  // phi(|v_d|)
  float acc;
  __device__ void init() { acc = 0.0f; }
  __device__ void push(int d, float a, float* col, int qs, float tiny) {
    const float x = phi_llr_branch(a, tiny);
    acc = __fadd_rn(acc, x);
    col[0] = x;
  }
  template <class F>
  __device__ void emit_all(int dc, const float* sc, int nthr, int qs,
                           float tiny, float alpha, float beta,
                           float tanh_sat, F&& emit) {
    for (int d = 0; d < dc; ++d)
      emit(d, phi_llr_branch(__fsub_rn(acc, sc[d * nthr]), tiny));
  }
};

template <>
struct RuleChain<kMinSum> {
  static constexpr int kScratch = 1;  // |v_d|
  float m1, m2;  // the minimum; the minimum of the other values
  int cnt;       // the minimum's multiplicity
  __device__ void init() {
    m1 = m2 = INFINITY;
    cnt = 0;
  }
  __device__ void push(int d, float a, float* col, int qs, float tiny) {
    const bool lt = a < m1, eq = a == m1;
    const float other = a < m2 ? a : m2;
    m2 = lt ? m1 : (eq ? m2 : other);
    cnt = lt ? 1 : cnt + (int)eq;
    m1 = lt ? a : m1;
    col[0] = a;
  }
  // the unique argmin sees the minimum of the others and of its own +1e30
  // stand-in, every other slot the minimum
  template <class F>
  __device__ void emit_all(int dc, const float* sc, int nthr, int qs,
                           float tiny, float alpha, float beta,
                           float tanh_sat, F&& emit) {
    for (int d = 0; d < dc; ++d) {
      const float a = sc[d * nthr];
      const float mv = (a == m1 && cnt == 1) ? fminf(m2, 1e30f) : m1;
      float scaled = __fmul_rn(alpha, mv);
      if (beta != 0.0f) scaled = fmaxf(__fsub_rn(scaled, beta), 0.0f);
      emit(d, scaled);
    }
  }
};

template <>
struct RuleChain<kTanhFB> {
  // the forward products of (1 - e) and (1 + e) over slots 0..d, and e
  static constexpr int kScratch = 3;
  float fp, fq;
  __device__ void init() { fp = fq = 0.0f; }
  __device__ void push(int d, float a, float* col, int qs, float tiny) {
    const float e = expf(-a);
    const float pm = __fsub_rn(1.0f, e), qm = __fadd_rn(1.0f, e);
    fp = d == 0 ? pm : __fmul_rn(fp, pm);
    fq = d == 0 ? qm : __fmul_rn(fq, qm);
    col[0] = fp;
    col[qs] = fq;
    col[2 * qs] = e;
  }
  // backward over the slots with the running products of slots d+1..dc-1;
  // the forward products of slots 0..d-1 and e from the scratch
  template <class F>
  __device__ void emit_all(int dc, const float* sc, int nthr, int qs,
                           float tiny, float alpha, float beta,
                           float tanh_sat, F&& emit) {
    if (dc == 1) {
      emit(0, tanh_sat);
      return;
    }
    float bp = 0.0f, bq = 0.0f;
    for (int d = dc - 1; d >= 0; --d) {
      const float e = sc[d * nthr + 2 * qs];
      const float pm = __fsub_rn(1.0f, e), qm = __fadd_rn(1.0f, e);
      float Pa, Qa;
      if (d == dc - 1) {
        Pa = sc[(d - 1) * nthr];
        Qa = sc[(d - 1) * nthr + qs];
      } else if (d == 0) {
        Pa = bp;
        Qa = bq;
      } else {
        Pa = __fmul_rn(sc[(d - 1) * nthr], bp);
        Qa = __fmul_rn(sc[(d - 1) * nthr + qs], bq);
      }
      emit(d, logf(__fdiv_rn(__fadd_rn(Qa, Pa),
                             fmaxf(__fsub_rn(Qa, Pa), __fmul_rn(6e-8f, Qa)))));
      bp = d == dc - 1 ? pm : __fmul_rn(bp, pm);
      bq = d == dc - 1 ? qm : __fmul_rn(bq, qm);
    }
  }
};

// The signed message of slot d: (sign * prefactor) * magnitude, with the
// sign (-1)^(parity of all v < 0 xor v_d < 0) and the prefactor 1 - 2 synd.
__device__ __forceinline__ float signed_message(uint32_t negbits, int vpar,
                                                float pref, int d,
                                                float mag) {
  const float sg = (float)(1 - 2 * (vpar ^ (int)((negbits >> d) & 1u)));
  return __fmul_rn(sg * pref, mag);
}

// ------------------------------------------------------------------------
// The flooding check pass of one (row, lane) pair, shared by kernel 2 and
// the bookkeeping probe (resident_bookkeeping_probe.cu)

struct Cols {
  const int* col_off;  // [nb_v + 1]
  const int* col_e;    // [E] edges of each block, (row, slot) order
  const int* col_s;    // [E] their shifts
};

// Pass 1 of row cb, lane j: returns 1 when the totals violate the check.
template <int RULE, typename TT, typename TM>
__device__ __forceinline__ int check_update(const TT* T, TM* C, int s, int cb,
                                            int j, const Rows& rw, int z,
                                            float* sc, int nthr, int qs,
                                            float tiny, float alpha,
                                            float beta, float tanh_sat) {
  const int e0 = __ldg(rw.row_off + cb);
  const int dc = __ldg(rw.row_off + cb + 1) - e0;
  RuleChain<RULE> ch;
  ch.init();
  int tneg = 0;
  uint32_t negbits = 0;
  for (int d = 0; d < dc; ++d) {
    int src = j - __ldg(rw.edge_s + e0 + d);
    if (src < 0) src += z;
    const float td = load_f(T + __ldg(rw.edge_v + e0 + d) * z + src);
    const float v = __fsub_rn(td, load_f(C + (e0 + d) * z + j));
    tneg ^= (td < 0.0f);
    negbits |= (uint32_t)(v < 0.0f) << d;
    ch.push(d, fabsf(v), sc + d * nthr, qs, tiny);
  }
  const int vpar = __popc(negbits) & 1;
  const float pref = (float)(1 - 2 * s);
  ch.emit_all(dc, sc, nthr, qs, tiny, alpha, beta, tanh_sat,
              [&](int d, float mag) {
                store_f(C + (e0 + d) * z + j,
                        signed_message(negbits, vpar, pref, d, mag));
              });
  return tneg != s;
}

}  // namespace bp
