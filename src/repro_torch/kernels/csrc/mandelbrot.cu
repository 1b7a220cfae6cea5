// Mandelbrot escape iterations (paper Fig. 5 workload).
//
// Replaces the TPU kernel src/repro/kernels/mandelbrot/kernel.py:mandelbrot
// (_mandel_kernel): no inputs; for each pixel of [-2, 1] x [-1.5, 1.5] it
// counts the int32 iterations, up to max_iter, for which |z|^2 <= 4.
//
// Bound on the H100: f32 arithmetic, 8 operations per live iteration and
// one 4-byte store per pixel.  Each operation is rounded on its own (see
// below), so none fuses into an FMA: every one takes an FP32 lane's slot,
// and a warp scheduler starts one instruction a cycle.  The design spends
// those slots on the 8 operations of each live step and on little else:
//
//  * warm-up: the first K0 steps are tested one at a time (most escaping
//    pixels end there);
//  * then branch-free blocks of K steps: each step's test sum is kept in a
//    register and folded into one predicate, so a block costs 9
//    instruction slots a step plus one counter, one compare and two
//    branches.  When a block's predicate shows an escape (a NaN or an inf
//    counts as one), the count goes back to the block's start and the
//    kept sums give the first step that failed: the same step, and count,
//    as testing every step;
//  * a max_iter that is not a whole number of blocks ends with single steps;
//  * each thread takes several pixels, one after another: the 2-D
//    grid-stride loop of the caller's Dim3 geometry (the wrapper's default
//    grid gives each thread up to 8 x 4 pixels spread over the whole
//    image, so blocks do about the same work and block setup is paid once
//    for several pixels).  Where the block is a whole number of 8 x 4 tiles, each warp
//    takes one 8-column x 4-row tile of the block's rectangle (not 32
//    pixels of one row): its pixels escape at closer counts, so fewer
//    lanes idle while the warp's slowest runs on.
//
// No live iteration is skipped (no cardioid, bulb or periodicity test):
// the work is what chip_smoke.mandelbrot_flops counts.
//
// Numerics are pinned to the reference, bit for bit:
//  * the pixel coordinates are x0 + col * dx and y0 + row * dy with
//    dx = f32(3 / (W - 1)) and dy = f32(3 / (H - 1)) passed in from the
//    host, exactly as kernel.py computes them (not a linspace);
//  * every operation is rounded on its own (__fmul_rn, __fadd_rn,
//    __fsub_rn), so nvcc cannot contract a multiply-add into an FMA;
//  * an escaped z is frozen and its count stops.  Once |z|^2 > 4 with z
//    frozen, no later iteration is live, so the count is that of the
//    first failing test; the steps a block runs past it change nothing.
#include <cuda_runtime.h>

namespace {

constexpr int K0 = 8;  // warm-up steps, tested one at a time
constexpr int K = 8;   // steps in a branch-free block

// One step from z: z becomes z^2 + c; returns the step's test sum
// |z|^2 = zr^2 + zi^2 of the old z (the step is live iff it is <= 4).
__device__ __forceinline__ float step(float& zr, float& zi, float cr, float ci) {
  const float zr2 = __fmul_rn(zr, zr);
  const float zi2 = __fmul_rn(zi, zi);
  const float sum = __fadd_rn(zr2, zi2);
  const float nzi = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zr), zi), ci);
  zr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
  zi = nzi;
  return sum;
}

// The count of one pixel.  kBlocks: max_iter >= K0, so the warm-up and the
// blocks run (decided once a launch, not once a pixel); else single steps.
template <bool kBlocks>
__device__ __forceinline__ int escape_count(float cr, float ci, int max_iter) {
  float zr = 0.0f, zi = 0.0f;
  int n = 0;
  if (kBlocks) {
#pragma unroll
    for (int j = 0; j < K0; ++j) {
      if (!(step(zr, zi, cr, ci) <= 4.0f)) return j;
    }
    for (n = K0; n <= max_iter - K; n += K) {
      float sums[K];
      bool live = true;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        sums[j] = step(zr, zi, cr, ci);
        live &= sums[j] <= 4.0f;
      }
      if (!live) {  // back to the block's start: the first failing step
        int first = K - 1;
#pragma unroll
        for (int j = K - 2; j >= 0; --j) {
          if (!(sums[j] <= 4.0f)) first = j;
        }
        return n + first;
      }
    }
  }
  for (; n < max_iter; ++n) {
    if (!(step(zr, zi, cr, ci) <= 4.0f)) return n;
  }
  return max_iter;
}

// This thread's first pixel and the strides to its next ones: the 2-D
// grid-stride loop of the launch's Dim3 geometry.  The thread's place in
// its block's blockDim.x x blockDim.y rectangle of pixels is as given, or,
// where the block is a whole number of 8 x 4 tiles, in its warp's tile.
struct Place {
  int row0, col0, row_stride, col_stride;
};

__device__ __forceinline__ Place place() {
  int tx = threadIdx.x, ty = threadIdx.y;
  if (blockDim.x % 8 == 0 && blockDim.y % 4 == 0) {
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    const int lane = t % 32, warp = t / 32, tiles_x = blockDim.x / 8;
    tx = warp % tiles_x * 8 + lane % 8;
    ty = warp / tiles_x * 4 + lane / 8;
  }
  return {static_cast<int>(blockIdx.y * blockDim.y) + ty,
          static_cast<int>(blockIdx.x * blockDim.x) + tx,
          static_cast<int>(gridDim.y * blockDim.y), static_cast<int>(gridDim.x * blockDim.x)};
}

// Calls at(row, col, pass) for each of this thread's pixels, in the order
// it computes them: rows row0, row0 + row_stride, ... and in each the
// columns col0, col0 + col_stride, ...; pass numbers them from 0.
template <class At>
__device__ __forceinline__ void walk(int height, int width, At at) {
  const Place p = place();
  int pass = 0;
  for (int row = p.row0; row < height; row += p.row_stride) {
    for (int col = p.col0; col < width; col += p.col_stride) at(row, col, pass++);
  }
}

template <bool kBlocks>
__device__ __forceinline__ void counts(int* __restrict__ out, int height, int width,
                                       int max_iter, float x0, float y0, float dx, float dy) {
  walk(height, width, [&](int row, int col, int) {
    const float ci = __fadd_rn(y0, __fmul_rn(static_cast<float>(row), dy));
    const float cr = __fadd_rn(x0, __fmul_rn(static_cast<float>(col), dx));
    out[static_cast<long long>(row) * width + col] = escape_count<kBlocks>(cr, ci, max_iter);
  });
}

__global__ void mandelbrot_kernel(int* __restrict__ out, int height, int width, int max_iter,
                                  float x0, float y0, float dx, float dy) {
  if (max_iter >= K0) {
    counts<true>(out, height, width, max_iter, x0, y0, dx, dy);
  } else {
    counts<false>(out, height, width, max_iter, x0, y0, dx, dy);
  }
}

// For each pixel, the warp round of a launch of mandelbrot_kernel at this
// grid and block that computes it: the warp (the block's index times its
// warps plus the warp's index in the block, 32 threads of
// threadIdx.y * blockDim.x + threadIdx.x each) in the high 32 bits, the
// thread's pass of walk() in the low.  The same place() and walk() as the
// kernel, so the ids are the kernel's own placement.
__global__ void warp_rounds_kernel(long long* __restrict__ out, int height, int width) {
  const long long warps = (blockDim.x * blockDim.y + 31) / 32;
  const long long warp = (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * warps +
                         (threadIdx.y * blockDim.x + threadIdx.x) / 32;
  walk(height, width, [&](int row, int col, int pass) {
    out[static_cast<long long>(row) * width + col] = warp << 32 | pass;
  });
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

// The ids of warp_rounds_kernel, int64 (height, width) at out.
int mandelbrot_warp_rounds(void* out, int height, int width, int grid_x, int grid_y,
                           int block_x, int block_y, void* stream) {
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  warp_rounds_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), height, width);
  return static_cast<int>(cudaGetLastError());
}

// The warm-up's steps, tested one at a time, and a block's steps.
int mandelbrot_warm_up_steps() { return K0; }
int mandelbrot_block_steps() { return K; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
