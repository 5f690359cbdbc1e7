// Kernel 8: the shared-memory ceiling probe, for Hopper (sm_90a).  Replaces
// the Pallas TPU kernel of scripts/probe_vmem.py (`probe(mib)`, body
// `kernel`), which asks for an N-MiB VMEM scratch to find the largest
// residency a TPU kernel can hold.  On Hopper a block's fast scratch is its
// shared memory, and the largest a block can have is what it may opt into
// as dynamic shared memory (227 KB, 232,448 bytes, on the H100), above 48 KB
// only after cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, bytes).
//
// One block of 1024 threads takes `nbytes` of dynamic shared memory as a
// [rows, 128] f32 scratch (rows = nbytes / 512) and, as the TPU kernel does,
//   scratch[0:8]         = 2 x
//   scratch[rows-8:rows] = x + 1   (the far end, so the allocation is real)
//   out = scratch[0:8] + scratch[rows-8:rows]
// with x and out [8, 128] f32: out = 2x + (x + 1), 4.0 where x = 1.  Each
// thread writes one element of each region and, after a barrier, reads the
// element of another thread (the reversed order), so the values go through
// shared memory.  The plain version is ops/kernels.py:
// smem_ceiling_probe_ref; the result is bit-identical to it (2x is exact,
// each sum rounds once).
//
// Bound: 8 KB in and out and 3072 operations, far below a launch: the
// probe measures whether the launch is taken, not a rate.  So the call's
// own cost is what it adds to a launch: the shared-memory attribute is a
// host call, and the caller asks for it only when a request exceeds what
// the device already granted the kernel (ops/kernels.py SmemGrants), not
// on every call.  An empty kernel beside it gives the launch floor.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128, kRows = 8, kElems = kRows * kCols;

__global__ void __launch_bounds__(kElems, 1)
smem_ceiling_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int rows) {
  extern __shared__ __align__(16) float scratch[];
  const int t = threadIdx.x;
  const float v = x[t];
  float* far = scratch + (rows - kRows) * kCols;
  scratch[t] = __fmul_rn(2.0f, v);
  far[t] = __fadd_rn(v, 1.0f);
  __syncthreads();
  const int u = kElems - 1 - t;
  out[u] = __fadd_rn(scratch[u], far[u]);
}

// No work: the launch floor that kernel 8's call is timed against.
__global__ void empty_kernel() {}

}  // namespace

// Launch on `stream` with `nbytes` of dynamic shared memory (a multiple of
// 512 and at least 8 KB), first setting the kernel's shared-memory limit
// to `nbytes` when `set_attr` is not 0.  *stage gets 1 when the attribute
// call fails and 2 when the launch does.  Returns the CUDA error (0 = ok),
// or cudaErrorInvalidValue for arguments the kernel does not take.  A
// refused call's error is cleared, so that it does not surface at the next
// launch on this thread.
extern "C" int smem_ceiling_probe_launch(const void* x, void* out,
                                         long long nbytes, int set_attr,
                                         void* stage, void* stream) {
  int* st = static_cast<int*>(stage);
  *st = 0;
  if (nbytes < 2 * kRows * kCols * 4 || nbytes % (kCols * 4) ||
      nbytes > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int rows = (int)(nbytes / (kCols * 4));
  cudaError_t err;
  if (set_attr) {
    err = cudaFuncSetAttribute(smem_ceiling_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)nbytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      *st = 1;
      return (int)err;
    }
  }
  smem_ceiling_kernel<<<1, kElems, (size_t)nbytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) *st = 2;
  return (int)err;
}

// Launch the empty kernel (one thread) on `stream`; returns
// cudaGetLastError().
extern "C" int smem_ceiling_probe_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// cudaGetErrorName of a code the launch returned.
extern "C" const char* smem_ceiling_probe_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
