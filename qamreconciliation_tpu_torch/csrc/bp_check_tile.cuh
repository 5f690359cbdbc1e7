// The staged-tile check phase shared by bp_check_phase_qc.cu (kernel 1, the
// dense QC layout [nb_c, dc, z, B]) and bp_check_phase_generic.cu (kernel 4,
// the generic slot-major layout [dc, C, B] with a float mask [dc, C]).  Its
// TMA and mbarrier helpers also serve check_math_probe.cu (kernel 6, with
// TileShape) and resident_bookkeeping_probe.cu (kernel 9).
//
// Both layouts are one: element (g, d, r, b) of t, c2v and out lies at
// ((g * dc + d) * R + r) * B + b, with G check groups of R checks (kernel 1:
// G = nb_c, R = z; kernel 4: G = 1, R = C) and the frame b innermost; the
// syndrome (g, r, b) at (g * R + r) * B + b; the mask (kernel 4) (d, r) at
// d * R + r.  So the slot-d span of a run of checks is contiguous.
//
// Work is cut into tiles of `kt` checks of one group by `bB` frames (kt a
// power of two dividing 64, so that a tile never straddles a 64-check
// violation block of kernel 4).  Tile tau = ftile * (G * ceil(R / kt)) +
// ctile; each persistent block walks a contiguous run of tiles, up to three
// blocks an SM.  The launch plan (tile, frames, stages, load path, grid,
// blocks an SM, shared memory) comes from ops/kernels.py check_tile_plan;
// the launch checks it against the kernel's own layout and limits and does
// not choose it.
//
// Bound: memory.  Each call must read t and c2v and write out (at kernel 4's
// DVB-S2 rate-1/2 shape [7, 32400, 128] in f32, 366 MB with synd and mask:
// 0.109 ms at 3.35 TB/s).  The sum-product rules add one or two
// transcendental chains a slot, which the card issues at a few hundred
// instructions per check; there the compute, not the bytes, sets the time.
// Design:
//   * a ring of `stages` tiles in shared memory, filled by TMA bulk copies
//     (cp.async.bulk on one mbarrier per stage; t, c2v and synd, one copy
//     per slot when the tile's frames are all of B, else one per row) that
//     warp 0 issues for tile n + stages - 1 while tile n is computed; the
//     mask goes in by 4-byte cp.async, one group a tile;
//   * where 16-byte bulk copies do not line up (B * element size not a
//     multiple of 16, or an unaligned pointer), the plan takes the
//     per-thread path: one stage, filled by plain loads, same body;
//   * one thread per (check, frame) pair of the tile, kTileIlp pairs in
//     lockstep; the slots are read from the tile as needed, never held in
//     MAXD-sized register arrays: phi keeps phi(|v_d|) and tanh-F/B e^-|v_d|
//     and the forward products in an f32 scratch, min-sum recomputes |v_d|;
//     the sign bits of a check are one 32-bit word; each rule is its own
//     instance, so that no rule pays for another's registers;
//   * new messages overwrite the c2v slots of the tile, in the message
//     dtype, and leave in 16-byte stores (element stores on the per-thread
//     path);
//   * violations count in shared memory per frame with integer atomics and
//     go to viol with one integer atomicAdd per (frame, violation row) that
//     the block's run of tiles touches;
//   * no integer division on the per-tile path: a cursor steps through the
//     block's tiles, and each thread steps through its pairs.
// phi evaluates only the regime taken (phi_llr_branch).  The operation order
// is that of the plain versions in ops/kernels.py, so the results are
// bit-identical to them.

#pragma once

#include "bp_common.cuh"

namespace bp {

constexpr int kTileThreads = 256;
// blocks an SM at most (the register budget of __launch_bounds__); a plan
// of ops/kernels.py check_tile_plan asking for more is refused at launch
constexpr int kTileBlocksPerSm = 3;
constexpr int kTileIlp = 2;  // (check, frame) pairs a thread runs in lockstep
constexpr int kTileSmemMax = 232448;  // 227 KB, the most a block may use
constexpr int kSmemPerSm = 233472;    // 228 KB an SM, 1 KB more a block

// Byte offsets in the dynamic shared memory: `stages` stages of [t tile,
// c2v tile, synd tile, mask tile], the scratch, the per-frame violation
// counts and one mbarrier per stage.  ops/kernels.py tile_smem mirrors it.
struct TileLayout {
  int t, c, s, m, stage, scr, vc, bar, total;
};

__host__ __device__ inline TileLayout tile_layout(int dc, int kt, int bB,
                                                  int stages, int tsz,
                                                  int msz, bool masked,
                                                  int nscr) {
  const int P = kt * bB;
  TileLayout L;
  L.t = 0;
  L.c = up16(dc * P * tsz);
  L.s = L.c + up16(dc * P * msz);
  L.m = L.s + up16(P * 4);
  L.stage = L.m + (masked ? up16(dc * kt * 4) : 0);
  L.scr = stages * L.stage;
  L.vc = L.scr + up16(nscr * dc * P * 4);
  L.bar = L.vc + up16(bB * 4);
  L.total = L.bar + 16 * stages;
  return L;
}

// f32 scratch values per slot: phi(|v_d|) for phi; the forward products of
// (1 - e) and (1 + e) and e = e^-|v_d| itself for tanh-F/B; none for
// min-sum.
__host__ __device__ inline int tile_scratch(int rule) {
  return rule == kPhi ? 1 : rule == kTanhFB ? 3 : 0;
}

struct TileShape {
  int G, dc, R, B;  // check groups, slots, checks per group, frames
  int kt, bB;       // checks and frames per tile
  int stages;       // ring depth; 1 on the per-thread path
  int bulk;         // 1: TMA bulk copies, 0: per-thread loads
  int vblock;       // checks per violation row (64 for kernel 4, R for 1)
};

struct Tile {
  int g, r0, nr, b0, nf, vrow, ft;
};

// Steps through consecutive tiles without dividing: ft the frame tile, g
// the group, ri the check tile in the group, vr and vo the violation row in
// the group and r0's offset in it.
struct TileCursor {
  int ft, g, ri, vr, vo;

  __device__ TileCursor(const TileShape& sh, int tau) {
    const int nct_g = (sh.R + sh.kt - 1) / sh.kt;
    const int nct = sh.G * nct_g;
    ft = tau / nct;
    const int ct = tau - ft * nct;
    g = ct / nct_g;
    ri = ct - g * nct_g;
    vr = ri * sh.kt / sh.vblock;
    vo = ri * sh.kt - vr * sh.vblock;
  }

  __device__ void advance(const TileShape& sh, int nct_g) {
    vo += sh.kt;
    if (vo >= sh.vblock) {
      vo -= sh.vblock;
      ++vr;
    }
    if (++ri == nct_g) {
      ri = vr = vo = 0;
      if (++g == sh.G) {
        g = 0;
        ++ft;
      }
    }
  }

  __device__ Tile tile(const TileShape& sh, int vrows_g) const {
    Tile tl;
    tl.g = g;
    tl.r0 = ri * sh.kt;
    tl.nr = min(sh.kt, sh.R - tl.r0);
    tl.ft = ft;
    tl.b0 = ft * sh.bB;
    tl.nf = min(sh.bB, sh.B - tl.b0);
    tl.vrow = g * vrows_g + vr;
    return tl;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;" ::: "memory");
}

// Order this thread's generic-proxy accesses of shared memory before later
// async-proxy (TMA) ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy one unit (16, 4 or 2 bytes) between two addresses.
__device__ __forceinline__ void copy_unit(void* dst, const void* src,
                                          int unit) {
  if (unit == 16)
    *static_cast<int4*>(dst) = *static_cast<const int4*>(src);
  else if (unit == 4)
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

// Copy tile tl of an array of element size esz between global memory (base
// `g`, the layout above) and a tile [dc][kt][bB] at `s`, in units of `unit`
// bytes, spread over the block's threads.  When the tile holds all B
// frames its rows are contiguous in both, and each slot is one span; else
// each row is one.
template <bool TO_SMEM>
__device__ __forceinline__ void walk_tile(const TileShape& sh, const Tile& tl,
                                          char* g, char* s, int esz,
                                          int unit) {
  const bool whole = sh.bB == sh.B;
  const int rows = whole ? 1 : tl.nr;
  const int units = (whole ? tl.nr * sh.B : tl.nf) * esz / unit;
  for (int d = 0; d < sh.dc; ++d) {
    for (int i = 0; i < rows; ++i) {
      char* gr = g + ((((long long)tl.g * sh.dc + d) * sh.R + tl.r0 + i) *
                          sh.B +
                      tl.b0) *
                         esz;
      char* sr = s + ((long long)d * sh.kt + i) * sh.bB * esz;
      for (int k = threadIdx.x; k < units; k += kTileThreads) {
        if (TO_SMEM)
          copy_unit(sr + (long long)k * unit, gr + (long long)k * unit, unit);
        else
          copy_unit(gr + (long long)k * unit, sr + (long long)k * unit, unit);
      }
    }
  }
}

template <typename TT, typename TM, bool MASKED>
struct TileKernel {
  static constexpr int kTsz = sizeof(TT), kMsz = sizeof(TM);

  // Start tile tl's loads into stage `st` (bulk path): warp 0 issues the
  // TMA copies of t, c2v and synd; the first nr threads the 4-byte mask
  // copies.  Every thread commits one cp.async group.
  static __device__ void issue(const TileShape& sh, const Tile& tl,
                               const TT* t, const TM* c2v,
                               const int32_t* synd, const float* mask,
                               char* st, uint32_t bar, const TileLayout& L) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32) {
      const bool whole = sh.bB == sh.B;
      const int rows = whole ? 1 : tl.nr;             // copies per array slot
      const int span = whole ? tl.nr * sh.B : tl.nf;  // elements per copy
      const int ncopy = (2 * sh.dc + 1) * rows;
      if (lane == 0)
        mbar_expect_tx(bar, (uint32_t)tl.nr * tl.nf *
                                (sh.dc * (kTsz + kMsz) + 4));
      __syncwarp();
      for (int q = lane; q < ncopy; q += 32) {
        // a: slot a of t, slot a - dc of c2v, or (a == 2 dc) synd
        const int a = whole ? q : q / rows, i = q - a * rows;
        const long long row = (long long)tl.r0 + i;
        if (a < 2 * sh.dc) {
          const bool is_t = a < sh.dc;
          const int d = is_t ? a : a - sh.dc;
          const long long ge =
              ((long long)tl.g * sh.dc + d) * sh.R * sh.B + row * sh.B +
              tl.b0;
          const int se = (d * sh.kt + i) * sh.bB;
          if (is_t)
            bulk_g2s(smem_u32(st + L.t + se * kTsz), t + ge, span * kTsz,
                     bar);
          else
            bulk_g2s(smem_u32(st + L.c + se * kMsz), c2v + ge, span * kMsz,
                     bar);
        } else {
          const long long ge = ((long long)tl.g * sh.R + row) * sh.B + tl.b0;
          bulk_g2s(smem_u32(st + L.s + i * sh.bB * 4), synd + ge, span * 4,
                   bar);
        }
      }
    }
    if (MASKED && (int)threadIdx.x < tl.nr) {
      for (int d = 0; d < sh.dc; ++d)
        cp_async4(smem_u32(st + L.m + (d * sh.kt + threadIdx.x) * 4),
                  mask + (long long)d * sh.R + tl.r0 + threadIdx.x);
    }
    cp_async_commit();
  }

  // Fill stage `st` with tile tl by plain loads (per-thread path).
  static __device__ void load(const TileShape& sh, const Tile& tl,
                              const TT* t, const TM* c2v,
                              const int32_t* synd, const float* mask,
                              char* st, const TileLayout& L) {
    walk_tile<true>(sh, tl, (char*)t, st + L.t, kTsz, kTsz);
    walk_tile<true>(sh, tl, (char*)c2v, st + L.c, kMsz, kMsz);
    for (int i = 0; i < tl.nr; ++i) {
      for (int b = threadIdx.x; b < tl.nf; b += kTileThreads)
        reinterpret_cast<int32_t*>(st + L.s)[i * sh.bB + b] =
            synd[((long long)tl.g * sh.R + tl.r0 + i) * sh.B + tl.b0 + b];
    }
    if (MASKED && (int)threadIdx.x < tl.nr) {
      for (int d = 0; d < sh.dc; ++d)
        reinterpret_cast<float*>(st + L.m)[d * sh.kt + threadIdx.x] =
            mask[(long long)d * sh.R + tl.r0 + threadIdx.x];
    }
  }

  // The check update of every valid (check, frame) pair of the tile in
  // stage `st` by rule RULE; new messages overwrite the tile's c2v slots.
  // A thread runs kTileIlp pairs in lockstep, so that their dependent
  // chains overlap; a pair past the tile's edge reads pair 0 and writes
  // nothing.  (i0, b0) is the thread's first pair, (di, db) the step to
  // the pair kTileThreads further.
  template <int RULE>
  static __device__ void compute(const TileShape& sh, const Tile& tl,
                                 char* st, float* scr, int* vcount,
                                 const TileLayout& L, int i0, int b0, int di,
                                 int db, float tiny, float alpha, float beta,
                                 float tanh_sat) {
    constexpr int W = kTileIlp;
    const int dc = sh.dc, P = sh.kt * sh.bB;
    const TT* ts = reinterpret_cast<const TT*>(st + L.t);
    TM* cs = reinterpret_cast<TM*>(st + L.c);
    const int32_t* ss = reinterpret_cast<const int32_t*>(st + L.s);
    const float* ms = reinterpret_cast<const float*>(st + L.m);

    int pi = i0, pb = b0;
    for (int p0 = threadIdx.x; p0 < P; p0 += W * kTileThreads) {
      int pp[W], ii[W], bb[W];
      bool ok[W], any = false;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int p = p0 + k * kTileThreads;
        ok[k] = p < P && pi < tl.nr && pb < tl.nf;
        any = any || ok[k];
        pp[k] = ok[k] ? p : 0;
        ii[k] = ok[k] ? pi : 0;
        bb[k] = pb;
        pi += di;
        pb += db;
        if (pb >= sh.bB) {
          pb -= sh.bB;
          ++pi;
        }
      }
      if (!any) continue;
      // slot d of pair k: the mask, v = t - c2v as the tile holds them, and
      // the magnitude over the real slots (+1e30 for padded ones)
      auto mask_at = [&](int k, int d) {
        return MASKED ? ms[d * sh.kt + ii[k]] : 1.0f;
      };
      auto a_of = [&](int k, int d, float v) {
        if (MASKED) return mask_at(k, d) > 0.0f ? fabsf(v) : 1e30f;
        return fabsf(v);
      };

      // pass 1: convergence parity of t, sign bits of v, and the rule's
      // running quantity
      int s[W], tneg[W], cnt[W];
      uint32_t negbits[W];
      float acc[W], m1[W], m2[W], fp[W], fq[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        s[k] = ss[pp[k]];
        tneg[k] = cnt[k] = 0;
        negbits[k] = 0;
        acc[k] = fp[k] = fq[k] = 0.0f;
        m1[k] = m2[k] = INFINITY;
      }
      for (int d = 0; d < dc; ++d) {
        float td[W], v[W], m[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          td[k] = load_f(ts + d * P + pp[k]);
          v[k] = __fsub_rn(td[k], load_f(cs + d * P + pp[k]));
          m[k] = mask_at(k, d);
        }
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (MASKED)
            tneg[k] += (td[k] < 0.0f) * (int)m[k];
          else
            tneg[k] ^= (td[k] < 0.0f);
          negbits[k] |= (uint32_t)(v[k] < 0.0f && m[k] > 0.0f) << d;
          if constexpr (RULE == kPhi) {
            float x = phi_llr_branch(fabsf(v[k]), tiny);
            if (MASKED) x = __fmul_rn(x, m[k]);
            acc[k] = __fadd_rn(acc[k], x);
            if (ok[k]) scr[d * P + pp[k]] = x;
          } else if constexpr (RULE == kMinSum) {
            // m1 the minimum, cnt its multiplicity, m2 the minimum of the
            // other values, in one pass without branches (the plain
            // version's tie-correct selection; bp_resident.cuh the same)
            const float a = a_of(k, d, v[k]);
            const bool lt = a < m1[k], eq = a == m1[k];
            const float other = a < m2[k] ? a : m2[k];
            m2[k] = lt ? m1[k] : (eq ? m2[k] : other);
            cnt[k] = lt ? 1 : cnt[k] + (int)eq;
            m1[k] = lt ? a : m1[k];
          } else {
            const float e = expf(-a_of(k, d, v[k]));
            const float pm = __fsub_rn(1.0f, e), qm = __fadd_rn(1.0f, e);
            fp[k] = d == 0 ? pm : __fmul_rn(fp[k], pm);
            fq[k] = d == 0 ? qm : __fmul_rn(fq[k], qm);
            if (ok[k]) {
              scr[d * P + pp[k]] = fp[k];
              scr[(dc + d) * P + pp[k]] = fq[k];
              scr[(2 * dc + d) * P + pp[k]] = e;
            }
          }
        }
      }
      int vpar[W];
      float pref[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (ok[k] && (tneg[k] & 1) != s[k]) atomicAdd(vcount + bb[k], 1);
        vpar[k] = __popc(negbits[k]) & 1;
        pref[k] = (float)(1 - 2 * s[k]);
      }

      // pass 2: magnitudes, sign, (1 - 2 synd) prefactor, times the mask,
      // stored over the c2v slot in the message dtype
      auto emit = [&](int k, int d, float mag) {
        const int neg = (int)((negbits[k] >> d) & 1u);
        const float sg = (float)(1 - 2 * (vpar[k] ^ neg));
        float o = __fmul_rn(sg * pref[k], mag);
        if (MASKED) o = __fmul_rn(o, mask_at(k, d));
        if (ok[k]) store_f(cs + d * P + pp[k], o);
      };
      if constexpr (RULE == kPhi) {
        for (int d = 0; d < dc; ++d) {
#pragma unroll
          for (int k = 0; k < W; ++k)
            emit(k, d, phi_llr_branch(__fsub_rn(acc[k], scr[d * P + pp[k]]),
                                      tiny));
        }
      } else if constexpr (RULE == kMinSum) {
        // the unique argmin sees the minimum of the others and of its own
        // +1e30 stand-in, every other slot the minimum
        for (int d = 0; d < dc; ++d) {
          float a[W];
#pragma unroll
          for (int k = 0; k < W; ++k)
            a[k] = a_of(k, d,
                        __fsub_rn(load_f(ts + d * P + pp[k]),
                                  load_f(cs + d * P + pp[k])));
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const float mv =
                (a[k] == m1[k] && cnt[k] == 1) ? fminf(m2[k], 1e30f) : m1[k];
            float scaled = __fmul_rn(alpha, mv);
            if (beta != 0.0f) scaled = fmaxf(__fsub_rn(scaled, beta), 0.0f);
            emit(k, d, scaled);
          }
        }
      } else if (dc == 1) {
#pragma unroll
        for (int k = 0; k < W; ++k) emit(k, 0, tanh_sat);
      } else {
        // backward over the slots with the running products of slots
        // d+1..dc-1; the forward products of slots 0..d-1 and e from the
        // scratch
        float bp[W], bq[W];
        for (int d = dc - 1; d >= 0; --d) {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const float e = scr[(2 * dc + d) * P + pp[k]];
            const float pm = __fsub_rn(1.0f, e), qm = __fadd_rn(1.0f, e);
            float Pa, Qa;
            if (d == dc - 1) {
              Pa = scr[(d - 1) * P + pp[k]];
              Qa = scr[(dc + d - 1) * P + pp[k]];
            } else if (d == 0) {
              Pa = bp[k];
              Qa = bq[k];
            } else {
              Pa = __fmul_rn(scr[(d - 1) * P + pp[k]], bp[k]);
              Qa = __fmul_rn(scr[(dc + d - 1) * P + pp[k]], bq[k]);
            }
            emit(k, d, logf(__fdiv_rn(__fadd_rn(Qa, Pa),
                                      fmaxf(__fsub_rn(Qa, Pa),
                                            __fmul_rn(6e-8f, Qa)))));
            bp[k] = d == dc - 1 ? pm : __fmul_rn(bp[k], pm);
            bq[k] = d == dc - 1 ? qm : __fmul_rn(bq[k], qm);
          }
        }
      }
    }
  }
};

template <typename TT, typename TM, bool MASKED, int RULE>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
check_tile_kernel(const TT* __restrict__ t, const TM* __restrict__ c2v,
                  const int32_t* __restrict__ synd,
                  const float* __restrict__ mask, TM* __restrict__ out,
                  int32_t* __restrict__ viol, TileShape sh, float tiny,
                  float alpha, float beta, float tanh_sat) {
  using K = TileKernel<TT, TM, MASKED>;
  extern __shared__ __align__(16) char smem[];
  const TileLayout L = tile_layout(sh.dc, sh.kt, sh.bB, sh.stages, K::kTsz,
                                   K::kMsz, MASKED, tile_scratch(RULE));
  float* scr = reinterpret_cast<float*>(smem + L.scr);
  int* vcount = reinterpret_cast<int*>(smem + L.vc);
  const int S = sh.stages;

  // this block's contiguous run of tiles
  const int nct_g = (sh.R + sh.kt - 1) / sh.kt;
  const int vrows_g = (sh.R + sh.vblock - 1) / sh.vblock;
  const int T = sh.G * nct_g * ((sh.B + sh.bB - 1) / sh.bB);
  const int per = T / gridDim.x, extra = T % gridDim.x;
  const int bid = blockIdx.x;
  const int first = bid * per + min(bid, extra);
  const int cnt = per + (bid < extra);
  // the thread's first pair and the step to the pair kTileThreads further
  const int i0 = threadIdx.x / sh.bB, b0 = threadIdx.x - i0 * sh.bB;
  const int di = kTileThreads / sh.bB, db = kTileThreads - di * sh.bB;

  for (int b = threadIdx.x; b < sh.bB; b += kTileThreads) vcount[b] = 0;
  auto bar = [&](int s) { return smem_u32(smem + L.bar + 16 * s); };
  auto stage = [&](int s) { return smem + (long long)s * L.stage; };
  TileCursor cur(sh, first), ahead(sh, first);
  if (sh.bulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bar(s));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    for (int n = 0; n < S - 1; ++n) {
      if (n < cnt) {
        K::issue(sh, ahead.tile(sh, vrows_g), t, c2v, synd, mask, stage(n),
                 bar(n), L);
        ahead.advance(sh, nct_g);
      } else {
        cp_async_commit();
      }
    }
  }

  for (int n = 0; n < cnt; ++n) {
    const int s = n % S;
    const Tile tl = cur.tile(sh, vrows_g);
    if (sh.bulk) {
      cp_async_wait(S - 2);
      mbar_wait(bar(s), (uint32_t)((n / S) & 1));
    } else {
      __syncthreads();  // the previous tile's stores have read the stage
      K::load(sh, tl, t, c2v, synd, mask, stage(s), L);
    }
    __syncthreads();  // tile n is in; the last flush of vcount is done
    if (sh.bulk) {
      const int nx = n + S - 1;
      if (nx < cnt) {
        K::issue(sh, ahead.tile(sh, vrows_g), t, c2v, synd, mask,
                 stage(nx % S), bar(nx % S), L);
        ahead.advance(sh, nct_g);
      } else {
        cp_async_commit();
      }
    }
    K::template compute<RULE>(sh, tl, stage(s), scr, vcount, L, i0, b0, di,
                              db, tiny, alpha, beta, tanh_sat);
    // the new messages, written through the generic proxy, come before the
    // TMA copy that refills the stage (the writers fence, then the barrier)
    if (sh.bulk) fence_proxy_async();
    __syncthreads();  // every new message is in the tile
    walk_tile<false>(sh, tl, (char*)out, stage(s) + L.c, K::kMsz,
                     sh.bulk ? 16 : K::kMsz);
    // flush the counts when the next tile has another violation row
    cur.advance(sh, nct_g);
    const Tile nt = cur.tile(sh, vrows_g);
    if (n + 1 == cnt || nt.vrow != tl.vrow || nt.ft != tl.ft) {
      for (int b = threadIdx.x; b < tl.nf; b += kTileThreads) {
        const int c = vcount[b];
        if (c) atomicAdd(viol + (long long)tl.vrow * sh.B + tl.b0 + b, c);
        vcount[b] = 0;
      }
    }
  }
  if (sh.bulk) cp_async_wait(0);
}

template <typename TT, typename TM, bool MASKED, int RULE>
int launch_rule(const void* t, const void* c2v, const void* synd,
                const float* mask, void* out, void* viol, const TileShape& sh,
                int grid, int smem, float tiny, float alpha, float beta,
                cudaStream_t stream) {
  auto kern = check_tile_kernel<TT, TM, MASKED, RULE>;
  // the limit is per function and device; setting it is a host call
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kTileThreads, smem, stream>>>(
      static_cast<const TT*>(t), static_cast<const TM*>(c2v),
      static_cast<const int32_t*>(synd), mask, static_cast<TM*>(out),
      static_cast<int32_t*>(viol), sh, tiny, alpha, beta, tanh_saturation());
  return (int)cudaGetLastError();
}

// cudaErrorInvalidValue unless the plan fits the kernel's own layout,
// alignment rules and limits for `rule`'s scratch; else 0.
template <typename TT, typename TM, bool MASKED>
int check_tile_plan_error(const void* t, const void* c2v, const void* synd,
                          const void* out, const TileShape& sh, int grid,
                          int blocks_per_sm, int smem, int rule) {
  const int tsz = sizeof(TT), msz = sizeof(TM);
  const bool pow2 = sh.kt >= 1 && sh.kt <= 64 && (sh.kt & (sh.kt - 1)) == 0;
  if (!pow2 || sh.bB < 1 || sh.bB > sh.B || sh.stages < 1 ||
      sh.stages > 4 || grid < 1 || sh.vblock < 1 ||
      (sh.vblock != sh.R && sh.vblock % sh.kt != 0) || blocks_per_sm < 1 ||
      blocks_per_sm > kTileBlocksPerSm ||
      blocks_per_sm * (smem + 1024) > kSmemPerSm)
    return (int)cudaErrorInvalidValue;
  if (sh.bulk) {
    auto al = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    if (sh.stages < 2 || (sh.B * tsz) % 16 || (sh.B * msz) % 16 ||
        (sh.bB * tsz) % 16 || (sh.bB * msz) % 16 || !al(t) || !al(c2v) ||
        !al(synd) || !al(out))
      return (int)cudaErrorInvalidValue;
  } else if (sh.stages != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const TileLayout L = tile_layout(sh.dc, sh.kt, sh.bB, sh.stages, tsz, msz,
                                   MASKED, tile_scratch(rule));
  if (L.total != smem || smem > kTileSmemMax)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Check the plan (check_tile_plan_error), set the shared-memory limit and
// launch the rule's instance on `stream`.  Returns the CUDA error (0 = ok),
// or cudaErrorInvalidValue for a plan the kernel does not take.
template <typename TT, typename TM, bool MASKED>
int launch_check_tiles(const void* t, const void* c2v, const void* synd,
                       const float* mask, void* out, void* viol,
                       const TileShape& sh, int grid, int blocks_per_sm,
                       int smem, int rule, float tiny, float alpha,
                       float beta, cudaStream_t stream) {
  if (const int err = check_tile_plan_error<TT, TM, MASKED>(
          t, c2v, synd, out, sh, grid, blocks_per_sm, smem, rule))
    return err;
  if (rule == kPhi)
    return launch_rule<TT, TM, MASKED, kPhi>(t, c2v, synd, mask, out, viol,
                                             sh, grid, smem, tiny, alpha,
                                             beta, stream);
  if (rule == kTanhFB)
    return launch_rule<TT, TM, MASKED, kTanhFB>(t, c2v, synd, mask, out,
                                                viol, sh, grid, smem, tiny,
                                                alpha, beta, stream);
  return launch_rule<TT, TM, MASKED, kMinSum>(t, c2v, synd, mask, out, viol,
                                              sh, grid, smem, tiny, alpha,
                                              beta, stream);
}

}  // namespace bp
