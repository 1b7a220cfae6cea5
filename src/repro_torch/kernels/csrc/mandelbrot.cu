// Mandelbrot escape iterations (paper Fig. 5 workload).
//
// Replaces the TPU kernel src/repro/kernels/mandelbrot/kernel.py:mandelbrot
// (_mandel_kernel): no inputs; for each pixel of [-2, 1] x [-1.5, 1.5] it
// counts the int32 iterations, up to max_iter, for which |z|^2 <= 4.
//
// Bound on the H100: f32 arithmetic (8 flops per live iteration, one
// 4-byte store per pixel).  Design: one thread per pixel in a 2-D
// grid-stride loop; the Dim3 block is (threads along a row, rows).
//
// Numerics are pinned to the reference, bit for bit:
//  * the pixel coordinates are x0 + col * dx and y0 + row * dy with
//    dx = f32(3 / (W - 1)) and dy = f32(3 / (H - 1)) passed in from the
//    host, exactly as kernel.py computes them (not a linspace);
//  * every operation is rounded on its own (__fmul_rn, __fadd_rn,
//    __fsub_rn), so nvcc cannot contract a multiply-add into an FMA;
//  * an escaped z is frozen and its count stops.  Once |z|^2 > 4 with z
//    frozen, no later iteration is live, so the loop may stop there: the
//    count and z are the same as running all max_iter steps.
#include <cuda_runtime.h>

namespace {

__global__ void mandelbrot_kernel(int* __restrict__ out, int height, int width, int max_iter,
                                  float x0, float y0, float dx, float dy) {
  const int row_stride = gridDim.y * blockDim.y;
  const int col_stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < height; row += row_stride) {
    const float ci = __fadd_rn(y0, __fmul_rn(static_cast<float>(row), dy));
    for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < width; col += col_stride) {
      const float cr = __fadd_rn(x0, __fmul_rn(static_cast<float>(col), dx));
      float zr = 0.0f, zi = 0.0f;
      int it = 0;
      for (; it < max_iter; ++it) {
        const float zr2 = __fmul_rn(zr, zr);
        const float zi2 = __fmul_rn(zi, zi);
        if (!(__fadd_rn(zr2, zi2) <= 4.0f)) break;
        const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
        const float nzi = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zr), zi), ci);
        zr = nzr;
        zi = nzi;
      }
      out[static_cast<long long>(row) * width + col] = it;
    }
  }
}

}  // namespace

extern "C" {

int mandelbrot_i32(void* out, int height, int width, int max_iter, float x0, float y0,
                   float dx, float dy, int grid_x, int grid_y, int block_x, int block_y,
                   void* stream) {
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  mandelbrot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), height, width, max_iter, x0, y0, dx, dy);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
