// Check phase of the generic (expanded edge list) flooding BP decoder, for
// Hopper (sm_90a).  Replaces two Pallas TPU kernels of
// qamreconciliation_tpu/ops/pallas_kernels.py:
//   bp_check_phase_generic    the fused check phase in the slot-major
//                             [dc, C, B] layout, with padded-slot masking:
//                             bp_check_phase_generic_launch, on the
//                             staged-tile pipeline of bp_check_tile.cuh;
//   check_node_update_pallas  (body _kernel) the unfused phi check update
//                             in the check-major [C, dc, B] layout, in the
//                             messages' dtype (float32 or bfloat16), no
//                             c2v input, no convergence output:
//                             check_node_update_launch, below.
//
// The check phase, frames innermost:
//   t     [dc, C, B] gathered variable totals (f32 or bf16)
//   c2v   [dc, C, B] previous check->variable messages in t's dtype
//   synd  [C, B] syndrome bits, int32 0/1
//   mask  float32 [dc, C]: > 0 marks a real slot (any float; the kernel
//         reads it per slot and derives no degree)
//   out   [dc, C, B] new messages, in t's dtype (round to nearest even for
//         bf16)
//   viol  [n, B] int32, n = ceil(C / 64) check blocks: per (check block,
//         frame) the count of checks whose parity of t<0 over the real
//         slots ((int)mask weights, as the JAX kernel's int cast) differs
//         from synd; must be zeroed by the caller.  A frame has converged
//         when its column sums to 0.
// Per (c, b): v = t - c2v in f32 (bf16 upcast once at load), the
// all-but-one magnitude over the real slots by one of three rules (phi
// multiplies by the mask, min-sum and tanh-F/B select the +1e30 sentinel),
// the sign parity of v<0 over the real slots, the (1 - 2*synd) prefactor,
// and the product with the mask: ((sign * pref) * mag) * mask, as the plain
// version (ops/kernels.py:bp_check_phase_generic_ref) rounds it.
//
// The check-major update (kernel 5) takes v2c [C, dc, B] (f32 or bf16),
// synd [C, B] int32 and the mask [C, dc] (float32, holding the values the
// mask takes in the messages' dtype), and writes out [C, dc, B] in v2c's
// dtype: per (c, b), phim_d = phi(|v_d|) * m_d, their left-fold sum S,
// phi(S - phim_d), the sign parity of v<0 over the real slots, the
// (1 - 2*synd) prefactor and the mask.  As in the JAX kernel every
// operation runs in the messages' dtype: in bf16 each float result is
// rounded to bf16 in the order of the plain version
// (ops/kernels.py:check_node_update_fused_ref, ops/boxplus.py:phi_llr),
// except S, which accumulates in float32 and rounds once, as jnp.sum
// accumulates bf16; so the kernel is bit-identical to the plain version in
// both dtypes.
//
// Bound.  Kernel 4: memory; at the DVB-S2 rate-1/2 shape [7, 32400, 128] in
// f32 a check phase reads t, c2v, synd and the mask and writes out, 366 MB,
// 0.109 ms at 3.35 TB/s; f32 phi adds two transcendental chains per slot.
// Kernel 5 moves v2c, synd, the mask and out: 250 MB at [32400, 7, 128] in
// f32 (0.075 ms), 133 MB in bf16 (0.040 ms).  Its two phi chains a slot
// cost the same issue slots as kernel 4's, whose SASS puts their floor near
// 0.13 ms at that element count: compute latency and issue, not the bytes,
// set its time.
//
// Kernel 4 runs on the staged tiles of bp_check_tile.cuh (one check group of
// C checks, violation rows of 64 checks, the mask staged per tile).  Kernel
// 5 runs its own staged tiles, check-major: a tile is `kt` consecutive
// checks by `bB` frames, and with all B frames its slab [kt, dc, B], its
// syndrome rows [kt, B] and its mask rows [kt, dc] are each one contiguous
// run in device memory.
//   * persistent blocks (the plan's blocks an SM, up to kCmBlocksPerSm)
//     each walk a contiguous run of tiles, so no tail wave is left;
//   * a ring of `stages` tiles in shared memory: warp 0 issues the TMA bulk
//     copies (cp.async.bulk on one mbarrier a stage; one copy of the slab
//     and one of the syndrome when the tile holds all B frames, else one a
//     row) of tile n + stages - 1 while tile n is computed; the mask goes
//     in by 4-byte cp.async, one group a tile.  Where 16-byte bulk copies
//     do not line up (B times the element size not a multiple of 16, or an
//     unaligned pointer), the plan takes the per-thread path: one stage,
//     plain loads, the same body;
//   * one thread per (check, frame) pair, kCmIlp pairs in lockstep, the
//     block as wide as the tile needs (64-256 threads);
//   * the slots are read from the tile, never held in MAXD-sized register
//     arrays: pass 1 computes phim_d and the left-fold sum S, writing phim_d
//     over v_d in place (exact: phim_d is a value of the messages' dtype)
//     and keeping the sign bits of a check in one 32-bit word; pass 2
//     computes phi(S - phim_d), the sign and the mask, and writes the
//     message over phim_d.  One instance a dtype serves every dc up to
//     kMaxDc;
//   * phi's common regime (x < 10) runs on a thread's pairs in lockstep,
//     its chains free of branches so that they interleave; the large
//     regime runs only where a value takes it;
//   * the tile leaves in 16-byte stores (element stores on the per-thread
//     path).
// The launch plan (tile, frames, stages, load path, threads, grid, blocks
// an SM, shared memory) comes from ops/kernels.py check_major_plan; the
// launch checks it against the kernel's own layout and limits and does not
// choose it.

#include "bp_check_tile.cuh"

namespace {

using namespace bp;

// checks per violation block of kernel 4; ops/kernels.py GENERIC_BLOCK_C
// must match
constexpr int kChecksPerBlock = 64;

// ------------------------------------------------------------------------
// Kernel 5: the check-major phi update on staged tiles

constexpr int kCmThreadsMax = 256;  // threads a block at most
// threads an SM at most: the register budget of the launch bounds (64 a
// thread); a plan asking for more blocks an SM is refused at launch
constexpr int kCmThreadsPerSm = 1024;
constexpr int kCmBlocksPerSm = kCmThreadsPerSm / kCmThreadsMax;
constexpr int kCmIlp = 2;  // (check, frame) pairs a thread runs in lockstep

struct CmShape {
  int C, dc, B;     // checks, slots, frames
  int kt, bB;       // checks and frames per tile
  int stages;       // ring depth; 1 on the per-thread path
  int bulk;         // 1: TMA bulk copies, 0: per-thread loads
};

// Byte offsets in the dynamic shared memory: `stages` stages of [slab
// [kt][dc][bB] in the messages' dtype, syndrome [kt][bB] int32, mask
// [kt][dc] float32], then one mbarrier a stage.  ops/kernels.py
// check_major_smem mirrors it.
struct CmLayout {
  int v, s, m, stage, bar, total;
};

__host__ __device__ inline CmLayout cm_layout(int dc, int kt, int bB,
                                              int stages, int esz) {
  CmLayout L;
  L.v = 0;
  L.s = up16(kt * dc * bB * esz);
  L.m = L.s + up16(kt * bB * 4);
  L.stage = L.m + up16(kt * dc * 4);
  L.bar = stages * L.stage;
  L.total = L.bar + 16 * stages;
  return L;
}

struct CmTile {
  int c0, nr, b0, nf;
};

// Steps through consecutive tiles (check tiles inner, frame tiles outer)
// without dividing.
struct CmCursor {
  int ct, ft;

  __device__ CmCursor(int nct, int tau) : ct(tau % nct), ft(tau / nct) {}

  __device__ void advance(int nct) {
    if (++ct == nct) {
      ct = 0;
      ++ft;
    }
  }

  __device__ CmTile tile(const CmShape& sh) const {
    CmTile tl;
    tl.c0 = ct * sh.kt;
    tl.nr = min(sh.kt, sh.C - tl.c0);
    tl.b0 = ft * sh.bB;
    tl.nf = min(sh.bB, sh.B - tl.b0);
    return tl;
  }
};

// Copy the slab part of tile tl between device memory (base g, [C, dc, B])
// and the stage (base s, [kt][dc][bB]) in units of `unit` bytes, spread
// over the block's threads: one span when the tile holds all B frames, else
// one per (check, slot) row.
template <bool TO_SMEM>
__device__ __forceinline__ void cm_walk(const CmShape& sh, const CmTile& tl,
                                        char* g, char* s, int esz,
                                        int unit) {
  const bool whole = sh.bB == sh.B;
  const int rows = whole ? 1 : tl.nr * sh.dc;
  const int units = (whole ? tl.nr * sh.dc * sh.B : tl.nf) * esz / unit;
  for (int r = 0; r < rows; ++r) {
    const long long gel =
        whole ? (long long)tl.c0 * sh.dc * sh.B
              : ((long long)tl.c0 * sh.dc + r) * sh.B + tl.b0;
    char* gr = g + gel * esz;
    char* sr = s + (long long)r * sh.bB * esz;
    for (int k = threadIdx.x; k < units; k += blockDim.x) {
      if (TO_SMEM)
        copy_unit(sr + (long long)k * unit, gr + (long long)k * unit, unit);
      else
        copy_unit(gr + (long long)k * unit, sr + (long long)k * unit, unit);
    }
  }
}

// phi (in the messages' dtype T) of W values, of |in| when `absolute`:
// the common regime's chains in lockstep with no branch between them, the
// rare large-argument regime only where a value takes it.  out may alias
// in.
template <typename T, int W>
__device__ __forceinline__ void phi_lockstep(const float (&in)[W],
                                             float (&out)[W], float tiny,
                                             bool absolute) {
  float x[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    x[k] = phi_clamp<T>(absolute ? fabsf(in[k]) : in[k], tiny);
#pragma unroll
  for (int k = 0; k < W; ++k) out[k] = phi_small<T>(x[k]);
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (x[k] >= 10.0f) out[k] = phi_large<T>(x[k]);
}

template <typename T>
struct CmKernel {
  static constexpr int kEsz = sizeof(T);

  // Start tile tl's loads into stage `st` (bulk path): warp 0 issues the TMA
  // copies of the slab and the syndrome; the mask goes by 4-byte cp.async.
  // Every thread commits one cp.async group.
  static __device__ void issue(const CmShape& sh, const CmTile& tl,
                               const T* v2c, const int32_t* synd,
                               const float* mask, char* st, uint32_t bar,
                               const CmLayout& L) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0)
        mbar_expect_tx(bar, (uint32_t)tl.nr * tl.nf * (sh.dc * kEsz + 4));
      __syncwarp();
      if (sh.bB == sh.B) {
        if (lane == 0)
          bulk_g2s(smem_u32(st + L.v), v2c + (long long)tl.c0 * sh.dc * sh.B,
                   (uint32_t)tl.nr * sh.dc * sh.B * kEsz, bar);
        else if (lane == 1)
          bulk_g2s(smem_u32(st + L.s), synd + (long long)tl.c0 * sh.B,
                   (uint32_t)tl.nr * sh.B * 4, bar);
      } else {
        // one copy a (check, slot) row of the slab, then one a syndrome row
        const int nv = tl.nr * sh.dc;
        for (int q = lane; q < nv + tl.nr; q += 32) {
          if (q < nv)
            bulk_g2s(smem_u32(st + L.v + q * sh.bB * kEsz),
                     v2c + ((long long)tl.c0 * sh.dc + q) * sh.B + tl.b0,
                     tl.nf * kEsz, bar);
          else
            bulk_g2s(smem_u32(st + L.s + (q - nv) * sh.bB * 4),
                     synd + ((long long)tl.c0 + q - nv) * sh.B + tl.b0,
                     tl.nf * 4, bar);
        }
      }
    }
    for (int q = threadIdx.x; q < tl.nr * sh.dc; q += blockDim.x)
      cp_async4(smem_u32(st + L.m + q * 4),
                mask + (long long)tl.c0 * sh.dc + q);
    cp_async_commit();
  }

  // Fill stage `st` with tile tl by plain loads (per-thread path).
  static __device__ void load(const CmShape& sh, const CmTile& tl,
                              const T* v2c, const int32_t* synd,
                              const float* mask, char* st,
                              const CmLayout& L) {
    cm_walk<true>(sh, tl, (char*)v2c, st + L.v, kEsz, kEsz);
    for (int i = 0; i < tl.nr; ++i) {
      for (int b = threadIdx.x; b < tl.nf; b += blockDim.x)
        reinterpret_cast<int32_t*>(st + L.s)[i * sh.bB + b] =
            synd[((long long)tl.c0 + i) * sh.B + tl.b0 + b];
    }
    for (int q = threadIdx.x; q < tl.nr * sh.dc; q += blockDim.x)
      reinterpret_cast<float*>(st + L.m)[q] =
          mask[(long long)tl.c0 * sh.dc + q];
  }

  // The update of every valid (check, frame) pair of the tile in stage
  // `st`; the messages overwrite the slab.  A thread runs kCmIlp pairs in
  // lockstep, so that their dependent chains overlap; a pair past the
  // tile's edge reads pair 0 and writes nothing.
  static __device__ void compute(const CmShape& sh, const CmTile& tl,
                                 char* st, const CmLayout& L, float tiny) {
    constexpr int W = kCmIlp;
    const int dc = sh.dc, bB = sh.bB, P = sh.kt * bB;
    T* vs = reinterpret_cast<T*>(st + L.v);
    const int32_t* ss = reinterpret_cast<const int32_t*>(st + L.s);
    const float* ms = reinterpret_cast<const float*>(st + L.m);

    for (int p0 = threadIdx.x; p0 < P; p0 += W * blockDim.x) {
      int e0[W], m0[W], s[W];
      bool ok[W], any = false;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int p = p0 + k * blockDim.x;
        const int i = p / bB, b = p - i * bB;
        ok[k] = p < P && i < tl.nr && b < tl.nf;
        any = any || ok[k];
        e0[k] = ok[k] ? i * dc * bB + b : 0;  // slot 0 of the pair's check
        m0[k] = ok[k] ? i * dc : 0;
        s[k] = ss[ok[k] ? i * bB + b : 0];
      }
      if (!any) continue;

      // pass 1: sign bits, phim_d = phi(|v_d|) * m_d over v_d, the
      // left-fold sum S
      uint32_t negbits[W];
      float acc[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        negbits[k] = 0;
        acc[k] = 0.0f;
      }
      for (int d = 0; d < dc; ++d) {
        float v[W], m[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          v[k] = load_f(vs + e0[k] + d * bB);
          m[k] = ms[m0[k] + d];
        }
        float ph[W];
        phi_lockstep<T, W>(v, ph, tiny, true);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          negbits[k] |= (uint32_t)(v[k] < 0.0f && m[k] > 0.0f) << d;
          const float x = round_as<T>(__fmul_rn(ph[k], m[k]));
          acc[k] = d == 0 ? x : __fadd_rn(acc[k], x);
          if (ok[k]) store_f(vs + e0[k] + d * bB, x);
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = round_as<T>(acc[k]);

      // pass 2: phi(S - phim_d), ((sign * prefactor) * magnitude) * mask
      int vpar[W];
      float pref[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        vpar[k] = __popc(negbits[k]) & 1;
        pref[k] = (float)(1 - 2 * s[k]);
      }
      for (int d = 0; d < dc; ++d) {
        float x[W], m[W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          x[k] = load_f(vs + e0[k] + d * bB);
          m[k] = ms[m0[k] + d];
        }
        float mag[W];
#pragma unroll
        for (int k = 0; k < W; ++k)
          mag[k] = round_as<T>(__fsub_rn(acc[k], x[k]));
        phi_lockstep<T, W>(mag, mag, tiny, false);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int neg = (int)((negbits[k] >> d) & 1u);
          const float sg = (float)(1 - 2 * (vpar[k] ^ neg));
          const float o = __fmul_rn(__fmul_rn(sg * pref[k], mag[k]), m[k]);
          if (ok[k]) store_f(vs + e0[k] + d * bB, o);
        }
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kCmThreadsMax, kCmBlocksPerSm)
check_major_tile_kernel(const T* __restrict__ v2c,
                        const int32_t* __restrict__ synd,
                        const float* __restrict__ mask, T* __restrict__ out,
                        CmShape sh, float tiny) {
  using K = CmKernel<T>;
  extern __shared__ __align__(16) char smem[];
  const CmLayout L = cm_layout(sh.dc, sh.kt, sh.bB, sh.stages, K::kEsz);
  const int S = sh.stages;

  // this block's contiguous run of tiles
  const int nct = (sh.C + sh.kt - 1) / sh.kt;
  const int T_ = nct * ((sh.B + sh.bB - 1) / sh.bB);
  const int per = T_ / gridDim.x, extra = T_ % gridDim.x;
  const int bid = blockIdx.x;
  const int first = bid * per + min(bid, extra);
  const int cnt = per + (bid < extra);
  if (cnt == 0) return;

  auto bar = [&](int s) { return smem_u32(smem + L.bar + 16 * s); };
  auto stage = [&](int s) { return smem + (long long)s * L.stage; };
  CmCursor cur(nct, first), ahead(nct, first);
  if (sh.bulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bar(s));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    for (int n = 0; n < S - 1; ++n) {
      if (n < cnt) {
        K::issue(sh, ahead.tile(sh), v2c, synd, mask, stage(n), bar(n), L);
        ahead.advance(nct);
      } else {
        cp_async_commit();
      }
    }
  }

  for (int n = 0; n < cnt; ++n) {
    const int s = n % S;
    const CmTile tl = cur.tile(sh);
    if (sh.bulk) {
      cp_async_wait(S - 2);
      mbar_wait(bar(s), (uint32_t)((n / S) & 1));
    } else {
      __syncthreads();  // the previous tile's stores have read the stage
      K::load(sh, tl, v2c, synd, mask, stage(s), L);
    }
    __syncthreads();  // tile n is in; every read of tile n - 1's stage done
    if (sh.bulk) {
      const int nx = n + S - 1;
      if (nx < cnt) {
        K::issue(sh, ahead.tile(sh), v2c, synd, mask, stage(nx % S),
                 bar(nx % S), L);
        ahead.advance(nct);
      } else {
        cp_async_commit();
      }
    }
    K::compute(sh, tl, stage(s), L, tiny);
    // the messages, written through the generic proxy, come before the TMA
    // copy that refills the stage (the writers fence, then the barrier)
    if (sh.bulk) fence_proxy_async();
    __syncthreads();  // every message is in the tile
    cm_walk<false>(sh, tl, (char*)out, stage(s) + L.v, K::kEsz,
                   sh.bulk ? 16 : K::kEsz);
    cur.advance(nct);
  }
  if (sh.bulk) cp_async_wait(0);
}

template <typename T>
int launch_check_major(const void* v2c, const void* synd, const float* mask,
                       void* out, const CmShape& sh, int threads, int grid,
                       int blocks_per_sm, int smem, float tiny,
                       cudaStream_t stream) {
  constexpr int esz = sizeof(T);
  const bool pow2 = sh.kt >= 1 && sh.kt <= 64 && (sh.kt & (sh.kt - 1)) == 0;
  if (!pow2 || sh.bB < 1 || sh.bB > sh.B || sh.stages < 1 ||
      sh.stages > 4 || grid < 1 || threads < 32 || threads % 32 ||
      threads > kCmThreadsMax || blocks_per_sm < 1 ||
      blocks_per_sm * threads > kCmThreadsPerSm ||
      blocks_per_sm * (smem + 1024) > kSmemPerSm)
    return (int)cudaErrorInvalidValue;
  if (sh.bulk) {
    auto al = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    if (sh.stages < 2 || (sh.B * esz) % 16 || (sh.bB * esz) % 16 ||
        !al(v2c) || !al(synd) || !al(out))
      return (int)cudaErrorInvalidValue;
  } else if (sh.stages != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const CmLayout L = cm_layout(sh.dc, sh.kt, sh.bB, sh.stages, esz);
  if (L.total != smem || smem > kTileSmemMax)
    return (int)cudaErrorInvalidValue;
  auto kern = check_major_tile_kernel<T>;
  // the limit is per function and device; setting it is a host call
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the plan's blocks an SM need the whole of the SM's shared memory
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(v2c), static_cast<const int32_t*>(synd), mask,
      static_cast<T*>(out), sh, tiny);
  return (int)cudaGetLastError();
}

}  // namespace

// The check-major update (kernel 5) on staged tiles, with the plan of
// ops/kernels.py check_major_plan (checks and frames per tile, stages, bulk
// path, threads, grid, blocks an SM, shared memory); launch on `stream`.
// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments or a plan the kernel does not take.
extern "C" int check_node_update_launch(
    const void* v2c, const void* synd, const void* mask, void* out,
    int dtype, int dc, int C, int B, float tiny, int kt, int bB, int stages,
    int bulk, int threads, int grid, int blocks_per_sm, int smem,
    void* stream) {
  if (dc < 1 || dc > kMaxDc || C < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const CmShape sh{C, dc, B, kt, bB, stages, bulk};
  const float* mp = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_check_major<float>(v2c, synd, mp, out, sh, threads, grid,
                                     blocks_per_sm, smem, tiny, s);
  if (dtype == kBF16)
    return launch_check_major<__nv_bfloat16>(v2c, synd, mp, out, sh,
                                             threads, grid, blocks_per_sm,
                                             smem, tiny, s);
  return (int)cudaErrorInvalidValue;
}

// The slot-major check phase on staged tiles, with the plan of
// ops/kernels.py check_tile_plan (checks and frames per tile, stages, bulk
// path, grid, blocks an SM, shared memory); returns cudaGetLastError()
// after the launch (0 = ok), or cudaErrorInvalidValue for arguments or a
// plan the kernel does not take.  The mask is [dc, C] float32; viol
// [ceil(C / 64), B].
extern "C" int bp_check_phase_generic_launch(
    const void* t, const void* c2v, const void* synd, const void* mask,
    void* out, void* viol, int dtype, int dc, int C, int B, int rule,
    float tiny, float alpha, float beta, int kt, int bB, int stages,
    int bulk, int grid, int blocks_per_sm, int smem, void* stream) {
  if (dc < 1 || dc > kMaxDc || C < 1 || B < 1 || rule < kPhi ||
      rule > kMinSum)
    return (int)cudaErrorInvalidValue;
  const TileShape sh{1, dc, C, B, kt, bB, stages, bulk, kChecksPerBlock};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(mask);
  if (dtype == kF32)
    return launch_check_tiles<float, float, true>(
        t, c2v, synd, mp, out, viol, sh, grid, blocks_per_sm, smem, rule,
        tiny, alpha, beta, s);
  if (dtype == kBF16)
    return launch_check_tiles<__nv_bfloat16, __nv_bfloat16, true>(
        t, c2v, synd, mp, out, viol, sh, grid, blocks_per_sm, smem, rule,
        tiny, alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}
