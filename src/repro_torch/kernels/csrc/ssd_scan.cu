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
// sequential chunk grid axis.  Blocks on the card run in no order, and a
// walk of that axis by one block per row would leave most of the card
// idle: Bz*H is 96 rows at the serve shape for 132 SMs, each with a chain
// of dependent chunks as long as the sequence.
//
// Bound on the H100: operations, at f32 accuracy by the faster route.  On
// the CUDA cores the least flops are the chunked count at chunk length 1,
// 4 N P + 2 (N + P) a token and row: 12.7 GFLOP at the serve shape (Bz 4,
// H 24, S 4000, P 64, N 128), 0.190 ms at 67 TFLOP/s.  On the tensor cores
// by 3xTF32 (165 TFLOP/s) the least is the count at chunk 16, one m16
// tile: 13.8 GFLOP, 0.084 ms, the bound.  The 218 MB of x, y, dt, B, C
// and state take 0.065 ms at 3.35 TB/s.
//
// Design: the chunked form is exact for any chunk length, and only the
// state hand-off between chunks is sequential, so the scan is three
// kernels launched back to back, each over every chunk of every row at
// once (L tokens a chunk, nc = ceil(S / L) chunks a row;
// 6,048 chunk tiles at the serve shape):
//   1. ssd_chunk_states, grid Bz*H*nc, 128 threads: the chunk's own state
//      S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T (an (N x L) (L x P)
//      product in 8 x 8 register tiles), and cum_last, into a workspace
//      the wrapper allocates (ssd_scan_f32_workspace bytes).  The chunk
//      comes in as two halves in two cp.async groups; the first half's
//      product runs while the second lands;
//   2. ssd_state_pass: each thread walks the chunks of 4 (row, n, p)
//      entries in order, s_in = s; s = exp(cum_last) s + S_c, overwriting
//      S_c with s_in, and writes the final state.  Reads and writes are
//      coalesced, with 8 chunks of loads in flight; the pass is bound by
//      memory (the workspace's 4 nc Bz H N P bytes, read and written once);
//   3. ssd_chunk_outputs, grid Bz*H*nc, 256 threads: per (row, chunk), once
//      for all P columns, y = exp(cum_i) C_i . s_in + att . x with the
//      masked att = (C.B^T) exp(cum_i - cum_j) dt_j, j <= i.  C.B^T and
//      C.s_in contract over n together, in 32-column tiles through two
//      cp.async stages (~70 KB of shared memory: 3 blocks an SM at the
//      serve shape).  Warp w owns rows [w L/8, (w+1) L/8) and skips the
//      column groups of att and the rows of x above its band.
// Products run on the CUDA cores in f32, from shared memory, with float4
// reads along the contraction.  Every tile comes in by cp.async (16-byte
// copies where the views are 16-byte aligned, 4-byte ones otherwise), rows
// past S zero-filled without a read.  The design adds flops over the bound
// (the quadratic part at L, 17.4 GFLOP at the serve shape against 12.7)
// and the workspace traffic (198 MB written, read, written and read at the
// serve shape); neither enters the bound.  At the serve shape on an H100
// (700 W) the three take about 0.25, 0.14 and 0.55 ms: the products reach
// about a third of the f32 rate, the pass about 2.8 TB/s.  L = 128 halves
// the pass but the outputs kernel, at one block an SM, doubles.
//
// Overflow: cum reaches hundreds within a chunk (dt*A down to -2.4 a token
// at A = -24), so exp(-cum_j) is never formed: only exp(cum_i - cum_j) for
// j <= i, exp(cum_last - cum_j) and exp(cum_i), all <= 1.  Entries above
// the diagonal are selected to 0, never multiplied by a mask.  Ragged tail:
// rows past S read nothing (zero B, C, x and dt in shared memory, which
// leave the state and cum unchanged) and write nothing, so any S is taken
// without padding.  Sums stay in f32, with the precise expf (no
// --use_fast_math).  No atomics: two calls give the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;          // tokens a chunk: 64 or 128 (ssd_chunk_outputs' tiling)
static_assert(L == 64 || L == 128, "the chunk length must be 64 or 128");
constexpr int STATES_THREADS = 128;
constexpr int THREADS = 256;   // chunk_outputs: 8 warps
constexpr int RT = L / 16;     // chunk_outputs: rows a thread
constexpr int CT = L / 16;     // chunk_outputs: att columns a thread
constexpr int LS = L + 4;      // row stride of att in shared memory, in floats
constexpr int KT = 32;         // chunk_outputs: n columns a tile
constexpr int KS = KT + 4;     // chunk_outputs: row stride of the C and B tiles, in floats
constexpr int PASS_THREADS = 256;
constexpr int PASS_E = 4;       // state pass: entries a thread, PASS_THREADS apart
constexpr int PASS_UNROLL = 8;  // state pass: chunks whose loads are in flight at once
constexpr int SMEM_MAX = 232448;

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* state;
  float* states;  // workspace: (Bz*H, nc, N, P) chunk states, then incoming states
  float* last;    // workspace: (Bz*H, nc) cum_last of each chunk
  int Bz, S, H, G, P, N, nc;
  int NR, NS, PR;      // N rounded up to 4; row stride of B/C in shared memory; P rounded up
                       // to 4, the row stride of x and s_in in shared memory
  int SF;              // chunk_outputs: floats of one stage, C and B tiles and s_in rows
  bool vec;            // 16-byte copies: every row of x, B, C starts 16-byte aligned
  long long xsb, xss, xsh, dsb, dss, dsh, as, bsb, bss, bsg, csb, css, csg;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; `bytes` 0 zero-fills without a read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols floats from src (row stride `stride`) into dst (row stride
// dstride, cols padded with zeros to `padded`); rows >= valid are zeros.
// Copies of 16 bytes (vec: cols == padded, a multiple of 4) or 4 bytes,
// walked as (row, col) with the block's stride carried, not divided.
__device__ void load_rows(float* dst, int dstride, const float* src, long long stride, int rows,
                          int valid, int cols, int padded, bool vec) {
  const int w = vec ? 4 : 1, q = padded / w;
  const int dr = blockDim.x / q, dc = blockDim.x % q;
  for (int r = threadIdx.x / q, c = threadIdx.x % q; r < rows; r += dr, c += dc) {
    if (c >= q) c -= q, ++r;
    if (r >= rows) break;
    const bool ok = r < valid && w * c < cols;
    const float* from = src + (ok ? r * stride + w * c : 0);
    if (vec)
      cp_async16(dst + r * dstride + w * c, from, ok ? 16 : 0);
    else
      cp_async4(dst + r * dstride + c, from, ok ? 4 : 0);
  }
}

// dt of the chunk's L tokens into dts (0 past `len`), by 4-byte copies.
__device__ void load_dt(float* dts, const float* dg, long long dss, int len) {
  for (int t = threadIdx.x; t < L; t += blockDim.x)
    cp_async4(dts + t, dg + (t < len ? t * dss : 0), t < len ? 4 : 0);
}

// cum[i] = sum_{k<=i} dts[k] a: each of the first L/32 warps scans its 32
// tokens with shuffles, then adds the totals of the warps before it.
__device__ void chunk_cum(const float* dts, float a, float* cum, float* tot) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float c = 0.f;
  if (tid < L) {
    c = dts[tid] * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= off) c += u;
    }
    if (lane == 31) tot[warp] = c;
  }
  __syncthreads();
  if (tid < L) {
    float base = 0.f;
    for (int k = 0; k < warp; ++k) base += tot[k];
    cum[tid] = base + c;
  }
  __syncthreads();
}

struct Row {
  int b, h, g, c, s0, len;
  __device__ Row(const Params& p) {
    const int row = blockIdx.x / p.nc;
    c = blockIdx.x % p.nc;
    b = row / p.H;
    h = row % p.H;
    g = h / (p.H / p.G);
    s0 = c * L;
    len = min(L, p.S - s0);
  }
};

// 1. The chunk's own state, S_c[n][p] = sum_j w_j B_j[n] x_j[p] with
// w_j = exp(cum_last - cum_j) dt_j, in (128 n x 64 p) passes.  Thread:
// n = n0 + 4 nb + 64 k + r, p = p0 + 4 pc + 32 m + q (k, m < 2; r, q < 4),
// an 8 x 8 tile from two float4 of B and two of x a token.
__global__ void __launch_bounds__(STATES_THREADS, 4) ssd_chunk_states(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;               // (L, NS)
  float* xs = Bs + L * p.NS;      // (L, PR)
  float* dts = xs + L * p.PR;     // (L,)
  float* cum = dts + L;           // (L,)
  float* wts = cum + L;           // (L,)
  float* tot = wts + L;           // (L / 32,)
  const Row r(p);
  const int tid = threadIdx.x, pc = tid % 8, nb = tid / 8;

  // two halves of the chunk in two groups: the first half's product runs
  // while the second half lands
  constexpr int HALF = L / 2;
  const float* Bg = p.B + r.b * p.bsb + r.s0 * p.bss + r.g * p.bsg;
  const float* xg = p.x + r.b * p.xsb + r.s0 * p.xss + r.h * p.xsh;
  load_dt(dts, p.dt + r.b * p.dsb + r.s0 * p.dss + r.h * p.dsh, p.dss, r.len);
  load_rows(Bs, p.NS, Bg, p.bss, HALF, r.len, p.N, p.NR, p.vec);
  load_rows(xs, p.PR, xg, p.xss, HALF, r.len, p.P, p.PR, p.vec);
  cp_async_commit();
  if (r.len > HALF) {
    load_rows(Bs + HALF * p.NS, p.NS, Bg + HALF * p.bss, p.bss, HALF, r.len - HALF, p.N, p.NR,
              p.vec);
    load_rows(xs + HALF * p.PR, p.PR, xg + HALF * p.xss, p.xss, HALF, r.len - HALF, p.P, p.PR,
              p.vec);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  chunk_cum(dts, p.A[r.h * p.as], cum, tot);
  if (tid < L) wts[tid] = expf(cum[L - 1] - cum[tid]) * dts[tid];
  if (tid == 0) p.last[blockIdx.x] = cum[L - 1];
  __syncthreads();

  float* out = p.states + static_cast<long long>(blockIdx.x) * p.N * p.P;
  bool waited = false;
  for (int n0 = 0; n0 < p.N; n0 += 128)
    for (int p0 = 0; p0 < p.P; p0 += 64) {
      bool nok[2], pok[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        nok[k] = n0 + 4 * nb + 64 * k < p.NR, pok[k] = p0 + 4 * pc + 32 * k < p.PR;
      float acc[2][4][2][4] = {};  // [k][r][m][q]
      auto step = [&](int j) {
        const float w = wts[j];
        float xw[2][4], bv[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float4 v = pok[m] ? ld4(xs + j * p.PR + p0 + 4 * pc + 32 * m)
                                  : make_float4(0, 0, 0, 0);
          xw[m][0] = v.x * w, xw[m][1] = v.y * w, xw[m][2] = v.z * w, xw[m][3] = v.w * w;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float4 v = nok[k] ? ld4(Bs + j * p.NS + n0 + 4 * nb + 64 * k)
                                  : make_float4(0, 0, 0, 0);
          bv[k][0] = v.x, bv[k][1] = v.y, bv[k][2] = v.z, bv[k][3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[k][rr][m][q] = fmaf(bv[k][rr], xw[m][q], acc[k][rr][m][q]);
      };
#pragma unroll 4
      for (int j = 0; j < min(r.len, HALF); ++j) step(j);
      if (!waited) {  // the second half
        cp_async_wait<0>();
        __syncthreads();
        waited = true;
      }
#pragma unroll 4
      for (int j = HALF; j < r.len; ++j) step(j);
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int n = n0 + 4 * nb + 64 * k + rr;
          if (n >= p.N) continue;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int pp = p0 + 4 * pc + 32 * m;
            float* o = out + static_cast<long long>(n) * p.P + pp;
            if (p.P % 4 == 0 && pp < p.P) {
              *reinterpret_cast<float4*>(o) = make_float4(acc[k][rr][m][0], acc[k][rr][m][1],
                                                          acc[k][rr][m][2], acc[k][rr][m][3]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (pp + q < p.P) o[q] = acc[k][rr][m][q];
            }
          }
        }
    }
}

// 2. The hand-off: each thread walks the chunks of PASS_E entries in order,
// with PASS_UNROLL chunks of loads in flight.  Rows go in reverse: the
// last rows' chunk states, written last by ssd_chunk_states, are still in
// L2, and the first rows' incoming states, written last here, are the
// first ssd_chunk_outputs reads.
__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass(const Params p) {
  constexpr int SPAN = PASS_THREADS * PASS_E;
  const long long np = static_cast<long long>(p.N) * p.P;
  const int tiles = static_cast<int>((np + SPAN - 1) / SPAN);
  const int row = p.Bz * p.H - 1 - static_cast<int>(blockIdx.x / tiles);
  const long long e0 = static_cast<long long>(blockIdx.x % tiles) * SPAN + threadIdx.x;
  float* w = p.states + static_cast<long long>(row) * p.nc * np + e0;
  const float* last = p.last + static_cast<long long>(row) * p.nc;
  bool ok[PASS_E];
  float s[PASS_E];
#pragma unroll
  for (int k = 0; k < PASS_E; ++k) ok[k] = e0 + k * PASS_THREADS < np, s[k] = 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += PASS_UNROLL) {
    float v[PASS_UNROLL][PASS_E], d[PASS_UNROLL];
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      if (c0 + u >= p.nc) break;
      d[u] = last[c0 + u];
#pragma unroll
      for (int k = 0; k < PASS_E; ++k)
        if (ok[k]) v[u][k] = w[(c0 + u) * np + k * PASS_THREADS];
    }
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      if (c0 + u >= p.nc) break;
      const float a = expf(d[u]);
#pragma unroll
      for (int k = 0; k < PASS_E; ++k)
        if (ok[k]) {
          w[(c0 + u) * np + k * PASS_THREADS] = s[k];
          s[k] = fmaf(a, s[k], v[u][k]);
        }
    }
  }
  float* so = p.state + static_cast<long long>(row) * np + e0;
#pragma unroll
  for (int k = 0; k < PASS_E; ++k)
    if (ok[k]) so[k * PASS_THREADS] = s[k];
}

// 3. The chunk's outputs.  Thread: rows i = w L/8 + (lane / 16) RT + r
// (r < RT); att columns j = lane % 16 + 16 c (c < CT); y columns
// p = 4 (lane % 16) + 64 gp + q.  C . B^T and C . s_in contract over n
// together, in tiles of KT columns through two cp.async stages (C, B and
// s_in rows), so each C float4 read feeds both; x lands during the loop,
// and att takes the stage area once the loop is done.
template <int PG>
__global__ void __launch_bounds__(THREADS, L == 128 ? 1 : PG == 1 ? 3 : 2)
    ssd_chunk_outputs(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;            // 2 x [C (L, KS), B (L, KS), s_in (KT, PR)]; then att (L, LS)
  float* Xs = stage + 2 * p.SF;   // (L, PR)
  float* dts = Xs + L * p.PR;     // (L,)
  float* cum = dts + L;           // (L,)
  float* tot = cum + L;           // (L / 32,)
  const Row r(p);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = warp * (L / 8) + (lane / 16) * RT, cc = lane % 16;
  const int band = (warp + 1) * (L / 8);  // rows of the warp end here
  const float* Cg = p.C + r.b * p.csb + r.s0 * p.css + r.g * p.csg;
  const float* Bg = p.B + r.b * p.bsb + r.s0 * p.bss + r.g * p.bsg;
  const float* s_in = p.states + static_cast<long long>(blockIdx.x) * p.N * p.P;
  auto load_tile = [&](int n0, float* st) {
    const int kt = min(KT, p.NR - n0);
    load_rows(st, KS, Cg + n0, p.css, L, r.len, min(KT, p.N - n0), kt, p.vec);
    load_rows(st + L * KS, KS, Bg + n0, p.bss, L, r.len, min(KT, p.N - n0), kt, p.vec);
    load_rows(st + 2 * L * KS, p.PR, s_in + static_cast<long long>(n0) * p.P, p.P, kt, p.N - n0,
              p.P, p.PR, p.vec);
  };

  load_dt(dts, p.dt + r.b * p.dsb + r.s0 * p.dss + r.h * p.dsh, p.dss, r.len);
  load_rows(Xs, p.PR, p.x + r.b * p.xsb + r.s0 * p.xss + r.h * p.xsh, p.xss, L, r.len, p.P,
            p.PR, p.vec);
  load_tile(0, stage);
  cp_async_commit();

  bool pok[PG];
#pragma unroll
  for (int gp = 0; gp < PG; ++gp) pok[gp] = 4 * cc + 64 * gp < p.P;
  float yacc[RT][PG][4] = {};  // C . s_in
  float aacc[RT][CT] = {};     // C . B^T, over the column groups at or below the band
  for (int n0 = 0, t = 0; n0 < p.NR; n0 += KT, ++t) {
    if (n0 + KT < p.NR) {  // the next tile lands during this one
      load_tile(n0 + KT, stage + ((t + 1) & 1) * p.SF);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) chunk_cum(dts, p.A[r.h * p.as], cum, tot);
    const float* Ct = stage + (t & 1) * p.SF;
    const float* Bt = Ct + L * KS;
    const float* St = Bt + L * KS;
    const int kt = min(KT, p.NR - n0);
    for (int n = 0; n < kt; n += 4) {
      float4 cv[RT];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) cv[rr] = ld4(Ct + (i0 + rr) * KS + n);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if (16 * c >= band) continue;
        const float4 bv = ld4(Bt + (cc + 16 * c) * KS + n);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          float a = aacc[rr][c];
          a = fmaf(cv[rr].x, bv.x, a);
          a = fmaf(cv[rr].y, bv.y, a);
          a = fmaf(cv[rr].z, bv.z, a);
          aacc[rr][c] = fmaf(cv[rr].w, bv.w, a);
        }
      }
#pragma unroll
      for (int gp = 0; gp < PG; ++gp) {
        if (!pok[gp]) continue;
        const float* sp = St + n * p.PR + 4 * cc + 64 * gp;
        const float4 s0 = ld4(sp), s1 = ld4(sp + p.PR), s2 = ld4(sp + 2 * p.PR),
                     s3 = ld4(sp + 3 * p.PR);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          float* a = yacc[rr][gp];
          a[0] = fmaf(cv[rr].x, s0.x, a[0]), a[1] = fmaf(cv[rr].x, s0.y, a[1]);
          a[2] = fmaf(cv[rr].x, s0.z, a[2]), a[3] = fmaf(cv[rr].x, s0.w, a[3]);
          a[0] = fmaf(cv[rr].y, s1.x, a[0]), a[1] = fmaf(cv[rr].y, s1.y, a[1]);
          a[2] = fmaf(cv[rr].y, s1.z, a[2]), a[3] = fmaf(cv[rr].y, s1.w, a[3]);
          a[0] = fmaf(cv[rr].z, s2.x, a[0]), a[1] = fmaf(cv[rr].z, s2.y, a[1]);
          a[2] = fmaf(cv[rr].z, s2.z, a[2]), a[3] = fmaf(cv[rr].z, s2.w, a[3]);
          a[0] = fmaf(cv[rr].w, s3.x, a[0]), a[1] = fmaf(cv[rr].w, s3.y, a[1]);
          a[2] = fmaf(cv[rr].w, s3.z, a[2]), a[3] = fmaf(cv[rr].w, s3.w, a[3]);
        }
      }
    }
    __syncthreads();  // this stage is read: the next-but-one tile may land here
  }

  // att into the stage area (every copy has landed)
  float* att = stage;
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    const int i = i0 + rr;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int j = cc + 16 * c;
      float v = 0.f;  // above the diagonal: selected, never multiplied by a mask
      if (j <= i) v = aacc[rr][c] * expf(cum[i] - cum[j]) * dts[j];
      att[i * LS + j] = v;
    }
  }
  __syncthreads();

  // y = exp(cum_i) (C . s_in) + att . x, over the rows j < band
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    const float e = expf(cum[i0 + rr]);
#pragma unroll
    for (int gp = 0; gp < PG; ++gp)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[rr][gp][q] *= e;
  }
  for (int j = 0; j < band; j += 4) {
    float4 av[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) av[rr] = ld4(att + (i0 + rr) * LS + j);
#pragma unroll
    for (int gp = 0; gp < PG; ++gp) {
      if (!pok[gp]) continue;
      const float* xp = Xs + j * p.PR + 4 * cc + 64 * gp;
      const float4 x0 = ld4(xp), x1 = ld4(xp + p.PR), x2 = ld4(xp + 2 * p.PR),
                   x3 = ld4(xp + 3 * p.PR);
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        float* a = yacc[rr][gp];
        a[0] = fmaf(av[rr].x, x0.x, a[0]), a[1] = fmaf(av[rr].x, x0.y, a[1]);
        a[2] = fmaf(av[rr].x, x0.z, a[2]), a[3] = fmaf(av[rr].x, x0.w, a[3]);
        a[0] = fmaf(av[rr].y, x1.x, a[0]), a[1] = fmaf(av[rr].y, x1.y, a[1]);
        a[2] = fmaf(av[rr].y, x1.z, a[2]), a[3] = fmaf(av[rr].y, x1.w, a[3]);
        a[0] = fmaf(av[rr].z, x2.x, a[0]), a[1] = fmaf(av[rr].z, x2.y, a[1]);
        a[2] = fmaf(av[rr].z, x2.z, a[2]), a[3] = fmaf(av[rr].z, x2.w, a[3]);
        a[0] = fmaf(av[rr].w, x3.x, a[0]), a[1] = fmaf(av[rr].w, x3.y, a[1]);
        a[2] = fmaf(av[rr].w, x3.z, a[2]), a[3] = fmaf(av[rr].w, x3.w, a[3]);
      }
    }
  }

  const long long yss = static_cast<long long>(p.H) * p.P;  // y is contiguous
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    const int i = i0 + rr;
    if (i >= r.len) continue;
    float* yo = p.y + (static_cast<long long>(r.b) * p.S + r.s0 + i) * yss +
                static_cast<long long>(r.h) * p.P;
#pragma unroll
    for (int gp = 0; gp < PG; ++gp) {
      const int p0 = 4 * cc + 64 * gp;
      if (p.P % 4 == 0 && p0 < p.P) {
        *reinterpret_cast<float4*>(yo + p0) = make_float4(yacc[rr][gp][0], yacc[rr][gp][1],
                                                          yacc[rr][gp][2], yacc[rr][gp][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p0 + q < p.P) yo[p0 + q] = yacc[rr][gp][q];
      }
    }
  }
}

long long chunks(int S) { return (static_cast<long long>(S) + L - 1) / L; }

bool aligned16(const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; }

// Kernels the calling thread's last ssd_scan_f32 launched.
thread_local int launched = 0;

template <int PG>
cudaError_t launch(const Params& p, int smem_states, int smem_outputs, cudaStream_t stream) {
  const int blocks = p.Bz * p.H * p.nc;
  cudaError_t err = cudaSuccess;
  if (smem_states > 48 * 1024)
    err = cudaFuncSetAttribute(ssd_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_states);
  if (err == cudaSuccess && smem_outputs > 48 * 1024)
    err = cudaFuncSetAttribute(ssd_chunk_outputs<PG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_outputs);
  if (err != cudaSuccess) return err;
  ssd_chunk_states<<<blocks, STATES_THREADS, smem_states, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched;
  const long long np = static_cast<long long>(p.N) * p.P;
  const int tiles = static_cast<int>((np + PASS_THREADS * PASS_E - 1) / (PASS_THREADS * PASS_E));
  ssd_state_pass<<<p.Bz * p.H * tiles, PASS_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched;
  ssd_chunk_outputs<PG><<<blocks, THREADS, smem_outputs, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++launched;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The chunk length the kernels were built with.
int ssd_scan_f32_chunk() { return L; }

// Kernels the calling thread's last ssd_scan_f32 launched (3 once it
// succeeds), counted in launch() after each launch that CUDA took.
int ssd_scan_f32_launched() { return launched; }

// Bytes of the workspace ssd_scan_f32 needs: each chunk's (N, P) state
// and its cum_last, for every row.
long long ssd_scan_f32_workspace(int Bz, int S, int H, int N, int P) {
  return 4LL * Bz * H * chunks(S) * (static_cast<long long>(N) * P + 1);
}

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 void* y, void* state, int Bz, int S, int H, int G, int P, int N,
                 long long xsb, long long xss, long long xsh, long long dsb, long long dss,
                 long long dsh, long long as, long long bsb, long long bss, long long bsg,
                 long long csb, long long css, long long csg, void* work, void* stream) {
  launched = 0;
  if (Bz < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > 128 || N < 1 || N > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nc = chunks(S);
  const long long tiles =
      (static_cast<long long>(N) * P + PASS_THREADS * PASS_E - 1) / (PASS_THREADS * PASS_E);
  if (static_cast<long long>(Bz) * H * nc > 0x7fffffff ||
      static_cast<long long>(Bz) * H * tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NR = (N + 3) / 4 * 4, NS = (N + 31) / 32 * 32 + 4, PR = (P + 3) / 4 * 4;
  const bool vec = N % 4 == 0 && P % 4 == 0 && aligned16(x) && aligned16(B) && aligned16(C) &&
                   (xsb | xss | xsh | bsb | bss | bsg | csb | css | csg) % 4 == 0;
  const int SF = 2 * L * KS + KT * PR;  // 2 SF >= L LS: att fits in the stages
  float* ws = static_cast<float*>(work);
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(state),
           ws, ws + static_cast<long long>(Bz) * H * nc * N * P,
           Bz, S, H, G, P, N, static_cast<int>(nc), NR, NS, PR, SF, vec,
           xsb, xss, xsh, dsb, dss, dsh, as, bsb, bss, bsg, csb, css, csg};
  const int smem_states = static_cast<int>(sizeof(float)) * (L * NS + L * PR + 3 * L + L / 32);
  const int smem_outputs = static_cast<int>(sizeof(float)) * (2 * SF + L * PR + 2 * L + L / 32);
  if (smem_states > SMEM_MAX || smem_outputs > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(P > 64 ? launch<2>(p, smem_states, smem_outputs, s)
                                 : launch<1>(p, smem_states, smem_outputs, s));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
