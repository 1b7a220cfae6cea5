// Mamba-2 SSD scan, forward: the chunked state-space recurrence, with the
// final state.
//   x (Bz, S, H, P), dt (Bz, S, H), A (H,), B/C (Bz, S, G, N), H % G == 0
//   ->  y (Bz, S, H, P) and state (Bz, H, N, P), both f32, state from 0:
//   y_i   = sum_{j<=i in chunk} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . state
//   state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// where cum is the within-chunk inclusive sum of dt*A.  Head h reads group
// h / (H / G) of B and C, so grouped B/C are never expanded.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:ssd_scan
// (_ssd_kernel), which carries the (N, P) state in VMEM scratch across its
// sequential chunk grid axis.  Blocks on the card run in no order, so here
// one block walks the whole sequence itself, chunk after chunk, with its
// state in shared memory.  Only Bz*H rows exist (96 at the serve shape for
// 132 SMs), but the P columns of the state are independent (y[:, p] needs
// only x[:, p] and state[:, p]), so the grid is (Bz*H, P/16): each block
// keeps an (N, 16) slice of the state.
//
// Bound on the H100: operations.  In the chunked form a row and chunk of
// length l take (N+P) l(l+1) + 4 l N P flops, least at l = 1: 4 N P +
// 2 (N+P) a token.  At the serve shape (Bz 4, H 24, S 4000, P 64, N 128)
// that is 12.7 GFLOP, 0.190 ms at 67 TFLOP/s f32 (at this kernel's own
// l = 32, 15.0 GFLOP), against 218 MB of x, y, dt, B, C and state, 0.065 ms
// at 3.35 TB/s.  Design for a simple first kernel on the CUDA
// cores in f32: the block walks the sequence in sub-chunks of its own
// length (32 tokens; the recurrence is exact for any chunk length, only the
// rounding differs, and a short chunk does less of the quadratic part per
// token).  Per sub-chunk, 128 threads (4 warps, warp w owning rows 8w..8w+7)
// load B, C, x and dt into shared memory (48 KB at N 128: dynamic, set with
// cudaFuncSetAttribute), each thread with 16 loads of B and of C in flight
// before it stores any (one at a time, the L2 latency set the kernel's
// time: 3.2 ms against 1.95 ms at the serve shape on an H100 at 700 W);
// warp 0 scans dt*A with shuffles; each thread computes 2 x 4 entries of
// C.B^T, visiting only the column groups at or below its warp's diagonal;
// then 4 outputs y[i, 4q..4q+3] over att and the incoming state; then a
// 4 x 4 patch of the (N, 16) state update from float4 reads of B and x.
//
// Overflow: cum reaches hundreds within a chunk (dt*A down to -2.4 a token
// at A = -24), so exp(-cum_j) is never formed: only exp(cum_i - cum_j) for
// j <= i and exp(cum_last - cum_j), both <= 1.  Entries above the diagonal
// are selected to 0, never multiplied by a mask.  Ragged tail: rows past S
// read nothing (zero B, C, x and dt in shared memory, which leave the state
// and cum unchanged) and write nothing, so any S is taken without padding.
// Sums stay in f32, with the precise expf (no --use_fast_math).
//
// Later PRs will redesign this: C.B^T is recomputed for every one of the
// P/16 column tiles, B and C are re-read from L2 by every head and tile,
// the products run on the CUDA cores (no mma.sync or wgmma, no tensor
// cores), the loads are plain (no TMA, no prefetch of the next chunk),
// and shared-memory loads, not flops, bound the inner loops (about one
// load per two FMAs).
#include <cuda_runtime.h>

namespace {

constexpr int L = 32;          // tokens per sub-chunk: one per lane of warp 0
constexpr int PT = 16;         // state columns per block
constexpr int THREADS = 128;   // 4 warps; warp w owns chunk rows 8w..8w+7
constexpr int LS = L + 1;      // row stride of the att tile, in floats
constexpr int DEPTH = 16;      // B and C loads in flight per thread

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* state;
  int Bz, S, H, G, P, N;
  int NS, NR;  // B/C row stride in shared memory; N rounded up to 4
  long long xsb, xss, xsh, dsb, dss, dsh, as, bsb, bss, bsg, csb, css, csg;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(THREADS) ssd_fwd(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int NS = p.NS, NR = p.NR;
  float* Bs = smem;             // (L, NS)
  float* Cs = Bs + L * NS;      // (L, NS)
  float* att = Cs + L * NS;     // (L, LS)
  float* xs = att + L * LS;     // (L, PT)
  float* st = xs + L * PT;      // (NR, PT)
  float* cum = st + NR * PT;    // (L,)
  float* dts = cum + L;         // (L,)
  float* wts = dts + L;         // (L,) exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.y * PT;
  const float a = p.A[h * p.as];
  const float* xg = p.x + b * p.xsb + h * p.xsh + p0;
  const float* dg = p.dt + b * p.dsb + h * p.dsh;
  const float* Bg = p.B + b * p.bsb + g * p.bsg;
  const float* Cg = p.C + b * p.csb + g * p.csg;
  const long long yss = static_cast<long long>(p.H) * p.P;  // y is contiguous
  float* yg = p.y + static_cast<long long>(b) * p.S * yss + static_cast<long long>(h) * p.P + p0;

  for (int k = tid; k < NR * PT; k += THREADS) st[k] = 0.f;

  const int q = (tid % 4) * 4;  // y and state: columns q..q+3 of the tile
  for (int s0 = 0; s0 < p.S; s0 += L) {
    const int len = min(L, p.S - s0);
    // B and C: DEPTH loads of each in flight per thread before any store,
    // so the block waits for L2 a few times per sub-chunk, not 2 L NR /
    // THREADS times.
    for (int k0 = tid; k0 < L * NR; k0 += DEPTH * THREADS) {
      float vb[DEPTH], vc[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int k = k0 + u * THREADS, j = k / NR, n = k % NR;
        const bool ok = k < L * NR && j < len && n < p.N;
        vb[u] = ok ? Bg[(s0 + j) * p.bss + n] : 0.f;
        vc[u] = ok ? Cg[(s0 + j) * p.css + n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int k = k0 + u * THREADS, j = k / NR, n = k % NR;
        if (k < L * NR) {
          Bs[j * NS + n] = vb[u];
          Cs[j * NS + n] = vc[u];
        }
      }
    }
    {
      constexpr int XPT = L * PT / THREADS;  // x values per thread
      float vx[XPT];
#pragma unroll
      for (int u = 0; u < XPT; ++u) {
        const int k = tid + u * THREADS, j = k / PT, c = k % PT;
        vx[u] = (j < len && p0 + c < p.P) ? xg[(s0 + j) * p.xss + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < XPT; ++u) xs[tid + u * THREADS] = vx[u];
    }
    if (warp == 0) {  // inclusive scan of dt*A, one token per lane
      const float d = lane < len ? dg[(s0 + lane) * p.dss] : 0.f;
      float c = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, c, off);
        if (lane >= off) c += u;
      }
      const float last = __shfl_sync(0xffffffffu, c, 31);
      dts[lane] = d;
      cum[lane] = c;
      wts[lane] = expf(last - c) * d;
    }
    __syncthreads();

    {  // att[i][j] = (C_i.B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
      const int i0 = 2 * (tid / 8), cg = tid % 8;
      float acc[2][4] = {};
      const float* c0 = Cs + i0 * NS;
      const float* c1 = c0 + NS;
      for (int n = 0; n < p.N; ++n) {
        const float u0 = c0[n], u1 = c1[n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c <= warp) {  // columns cg + 8c <= 8w + 7, the warp's last row
            const float v = Bs[(cg + 8 * c) * NS + n];
            acc[0][c] = fmaf(u0, v, acc[0][c]);
            acc[1][c] = fmaf(u1, v, acc[1][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = cg + 8 * c;
          att[i * LS + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    {  // y[i][q..q+3] = att[i] . x[:, q..] + exp(cum_i) C_i . state[:, q..]
      const int i = tid / 4;
      float intra[4] = {}, inter[4] = {};
      const float* ai = att + i * LS;
      for (int j = 0; j < 8 * warp + 8; ++j) {
        const float u = ai[j];
        const float4 v = ld4(xs + j * PT + q);
        intra[0] = fmaf(u, v.x, intra[0]);
        intra[1] = fmaf(u, v.y, intra[1]);
        intra[2] = fmaf(u, v.z, intra[2]);
        intra[3] = fmaf(u, v.w, intra[3]);
      }
      const float* ci = Cs + i * NS;
      for (int n = 0; n < p.N; ++n) {
        const float u = ci[n];
        const float4 v = ld4(st + n * PT + q);
        inter[0] = fmaf(u, v.x, inter[0]);
        inter[1] = fmaf(u, v.y, inter[1]);
        inter[2] = fmaf(u, v.z, inter[2]);
        inter[3] = fmaf(u, v.w, inter[3]);
      }
      if (i < len) {
        const float e = expf(cum[i]);
        float* yo = yg + (s0 + i) * yss + q;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (p0 + q + c < p.P) yo[c] = intra[c] + e * inter[c];
      }
    }
    __syncthreads();

    {  // state[n][q..] <- exp(cum_last) state + sum_j wts_j B_j[n] x_j[q..]
      const float decay = expf(cum[L - 1]);
      for (int nb = tid / 4; 4 * nb < NR; nb += THREADS / 4) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 s = ld4(st + (4 * nb + r) * PT + q);
          acc[r][0] = decay * s.x, acc[r][1] = decay * s.y;
          acc[r][2] = decay * s.z, acc[r][3] = decay * s.w;
        }
        for (int j = 0; j < len; ++j) {
          const float w = wts[j];
          const float4 bv = ld4(Bs + j * NS + 4 * nb);
          const float4 xv = ld4(xs + j * PT + q);
          const float bw[4] = {bv.x * w, bv.y * w, bv.z * w, bv.w * w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(bw[r], xv.x, acc[r][0]);
            acc[r][1] = fmaf(bw[r], xv.y, acc[r][1]);
            acc[r][2] = fmaf(bw[r], xv.z, acc[r][2]);
            acc[r][3] = fmaf(bw[r], xv.w, acc[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(st + (4 * nb + r) * PT + q) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();
  }

  float* so = p.state + (static_cast<long long>(b) * p.H + h) * p.N * p.P + p0;
  for (int k = tid; k < p.N * PT; k += THREADS) {
    const int n = k / PT, c = k % PT;
    if (p0 + c < p.P) so[static_cast<long long>(n) * p.P + c] = st[n * PT + c];
  }
}

}  // namespace

extern "C" {

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 void* y, void* state, int Bz, int S, int H, int G, int P, int N,
                 long long xsb, long long xss, long long xsh, long long dsb, long long dss,
                 long long dsh, long long as, long long bsb, long long bss, long long bsg,
                 long long csb, long long css, long long csg, void* stream) {
  if (Bz < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > 128 || N < 1 || N > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(state),
           Bz, S, H, G, P, N, (N + 31) / 32 * 32 + 4, (N + 3) / 4 * 4,
           xsb, xss, xsh, dsb, dss, dsh, as, bsb, bss, bsg, csb, css, csg};
  const int smem = static_cast<int>(sizeof(float) *
                                    (2 * L * p.NS + L * LS + L * PT + p.NR * PT + 3 * L));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Bz * H, (P + PT - 1) / PT);
  ssd_fwd<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
