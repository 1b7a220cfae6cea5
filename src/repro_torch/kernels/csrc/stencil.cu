// PRK 3-point stencil on a 1-D array (paper Fig. 3 workload):
//   y[i] = 0.5 * x[i-1] + x[i] + 0.5 * x[i+1], with x = 0 past either end.
//
// Replaces the TPU kernel src/repro/kernels/stencil/kernel.py:stencil
// (_stencil_kernel), which bound the same array three times with shifted
// BlockSpecs to hand each tile its two halo elements.
//
// Bound on the H100: bytes.  It reads each element once and writes it
// once (8 B per element in f32), about 3 flops per 8 B, far below the
// card's balance point.  Design: one thread per output, a grid-stride loop
// so that any Dim3 grid the caller gives covers the array.  Each thread
// reads x[i-1], x[i], x[i+1] straight from device memory; neighbouring
// threads read neighbouring addresses, so the halo reads hit the same
// cache lines and L1/L2 absorb the threefold re-read.  The sum is computed
// in f32 with each operation rounded on its own (no FMA contraction), the
// same order as the plain PyTorch version, and stored as f32 or as bf16
// through __float2bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void stencil_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float left = i > 0 ? load(x, i - 1) : 0.0f;
    const float mid = load(x, i);
    const float right = i + 1 < n ? load(x, i + 1) : 0.0f;
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, left), mid), __fmul_rn(0.5f, right));
    store(y, i, v);
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, int blocks, int threads, void* stream) {
  stencil_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stencil_f32(const void* x, void* y, long long n, int blocks, int threads, void* stream) {
  return launch<float>(x, y, n, blocks, threads, stream);
}

int stencil_bf16(const void* x, void* y, long long n, int blocks, int threads, void* stream) {
  return launch<__nv_bfloat16>(x, y, n, blocks, threads, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
