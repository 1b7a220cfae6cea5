// Partition benchmark map (paper Figs. 4 and 6):  y = sqrt(sin(x)^2 + cos(x)^2).
//
// Replaces the TPU kernel src/repro/kernels/partition_map/kernel.py:
// partition_map (_map_kernel), an elementwise VPU pass over 8192-element
// blocks.
//
// Bound on the H100: bytes (4 B read and 4 B written per f32 element);
// the precise sinf/cosf cost a few dozen instructions per element, still
// below the card's balance point at this width.  Design: one thread per
// element in a grid-stride loop.  sinf/cosf are the precise libdevice
// forms: the reference feeds |x| in the hundreds and asks |y - 1| <= 1e-5,
// which the approximate __sinf/__cosf (and --use_fast_math) lose at such
// arguments.  The sum of squares is rounded per operation, and sqrtf is
// IEEE-rounded (nvcc's default -prec-sqrt=true).
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
__global__ void map_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = load(x, i);
    const float s = sinf(v);
    const float c = cosf(v);
    store(y, i, sqrtf(__fadd_rn(__fmul_rn(s, s), __fmul_rn(c, c))));
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, int blocks, int threads, void* stream) {
  map_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int partition_map_f32(const void* x, void* y, long long n, int blocks, int threads, void* stream) {
  return launch<float>(x, y, n, blocks, threads, stream);
}

int partition_map_bf16(const void* x, void* y, long long n, int blocks, int threads, void* stream) {
  return launch<__nv_bfloat16>(x, y, n, blocks, threads, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
