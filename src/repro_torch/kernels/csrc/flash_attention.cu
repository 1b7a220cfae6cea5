// Flash attention, forward: blocked online-softmax GQA attention, causal or
// not, with f32 statistics, on Hopper's tensor cores.
//   q (B, Sq, H, D), k/v (B, Skv, K, D), H % K == 0  ->  o (B, Sq, H, D)
//   o = softmax(q k^T / sqrt(D), masked to kpos <= qpos if causal) v
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (_flash_kernel), which walks kv blocks on the
// sequential 4th grid axis and carries (m, l, acc) in VMEM scratch.  Here
// one thread block takes one (query tile, query head, batch) and loops over
// the kv tiles itself; blocks run in parallel in any order, so nothing
// carries between them.  The grid is 1-D with the query tile slowest and
// the longest causal tiles first, so the first wave holds the longest work
// and blocks of one kv head run side by side (GQA reuse in L2).
//
// Bound on the H100: operations.  At the serving shape (B 4, H 16,
// S 2000, D 128, causal) the kernel does 4*D flops per unmasked (q, k)
// pair, about 66 GFLOP, against 66 MB of q, k, v and o: some 1000 flops per
// byte, far above the card's balance point.  So both products run on the
// tensor cores, in the FlashAttention-2 warp tiling:
//
// - Each warp owns MT = 2 row tiles of 16 query rows, so each K or V
//   fragment it loads feeds both.  Its S = Q K^T strip (32 x BK) and its
//   O accumulator (32 x D) live in registers in the mma.sync accumulator
//   layout: in each row tile, thread (g = lane / 4, t = lane % 4) holds
//   rows g and g + 8, columns 8j + 2t and 8j + 2t + 1.  The softmax max over
//   a row reduces across the 4 threads of a quad (__shfl_xor_sync by 1 and
//   2); the row sum stays per thread until the end.  No P tile goes to
//   shared memory.
// - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate).  Q, K and V stay
//   bf16 in shared memory; Q and K fragments come in by ldmatrix.x4, V's by
//   ldmatrix.x4.trans.  P is rounded to bf16 in registers: the accumulator
//   layout of two adjacent n8 tiles is exactly the m16n8k16 A-fragment
//   layout, so P feeds the P V mma with no shuffle.
// - f32: 3xTF32 on mma.sync m16n8k8.  Each f32 operand splits into
//   hi = tf32(a) and lo = tf32(a - hi), tf32() rounding to nearest with
//   ties away from zero as cvt.rna.tf32.f32 does, and each product is
//   lo*hi + hi*lo + hi*hi, accumulated in f32: about 2^-22 relative error a
//   product, at the level of f32 summation-order noise.  Every element of
//   the Q, K and V fragments is split once per kv tile, as it is loaded (Q
//   once per kv tile, reused over the tile's columns).  The split takes
//   more instruction slots than the mma: it rounds by an integer add and a
//   mask, which give the values of cvt.rna.tf32.f32 in fewer instructions.
//   The
//   m16n8k8 accumulator holds columns 2t, 2t + 1 where the tf32 A fragment
//   wants t, t + 4; since P V contracts over the kv index, the kernel
//   relabels instead of shuffling: accumulator column 2t is contraction
//   index t and 2t + 1 is t + 4, and V's B fragment is read from kv rows
//   2t and 2t + 1 to match.  3xTF32 peaks at 495 / 3 = 165 TFLOP/s, 2.5x
//   the 67 TFLOP/s of the CUDA cores.
// - K and V tiles come in by cp.async.cg 16-byte copies into a ring of
//   STAGES tiles: tile t + STAGES - 1 is in flight while tile t's QK^T,
//   softmax and PV run.  Rows past Sq or Skv are zero-filled by the copy's
//   src-size operand (0 bytes read), never read from memory, so a view of a
//   larger tensor holding NaN past Skv cannot reach the output.  Shared
//   rows are padded by 16 bytes: the 8 row addresses of an ldmatrix, and
//   the f32 fragment loads (stride D + 4 floats: banks 4g + t and 8t + g),
//   hit distinct banks.
// - Under `causal` the kv tiles wholly above the block's diagonal are never
//   loaded, and a warp skips a tile wholly above its own 32 rows.  Only the
//   diagonal tiles and the ragged last tile take the per-element mask (a
//   warp-uniform branch to a masked instantiation); the others run without.
//
// Tiles, shared memory (Q tile + STAGES x (K + V) tiles) and blocks per SM,
// chosen by measurement at the serving shape on an H100: one row tile a
// warp, BK 64, BQ 256 and a third stage ran slower (tools/sweep_torch_flash.py):
//   bf16  BQ 128 (4 warps of 32 rows), BK 32, 2 stages: 2 (BQ + 4 BK)(D + 8)
//         bytes, 69,632 / 36,864 / 20,480 / 12,288 at D 128 / 64 / 32 / 16;
//         246 / 178 / 120 / 114 registers as built on the card, so 2 / 2 /
//         4 / 4 blocks per SM, the registers bounding each.
//   f32   BQ 128 (4 warps of 32 rows), BK 16, 2 stages: 4 (BQ + 4 BK)(D + 4)
//         bytes, 101,376 / 52,224 / 27,648 / 15,360; 239 / 152 / 112 / 99
//         registers, so 2 / 3 / 4 / 4 blocks per SM.
//
// Numerics follow the Pallas kernel: scores accumulate in f32, masked
// scores are -1e30 (never -inf: exp(-inf - -inf) is NaN) and get weight 0,
// the softmax weights are rounded to v's type before P*V, the row sum uses
// the unrounded weights, and the result is acc * (1 / max(l, 1e-30)) (one
// division a row, not one an element: a precise division is a dozen
// instructions).  The exponentials are exp2f(s * c - m * c) with
// c = log2(e) / sqrt(D), the running max m taken over the unscaled
// scores.  Strides are passed in elements for q, k and v, whose last
// dimension is contiguous; base pointers and the strides of dimensions
// longer than 1 must be multiples of 16 bytes (the wrapper checks); o is
// written contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG = -1e30f;

template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int BQ = 128, BK = 32, STAGES = 2, MIN_BLOCKS = 2, MT = 2;
};
template <>
struct Tiles<float> {
  static constexpr int BQ = 128, BK = 16, STAGES = 2, MIN_BLOCKS = 2, MT = 2;
};

// Shared-memory row stride in elements: D plus 16 bytes of padding.
template <typename T, int D>
__host__ __device__ constexpr int smem_stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, K, Sq, Skv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal;
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 zero-fills the
// destination without reading `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b for one 16 x 8 tile: bf16 m16n8k16, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for one 16 x 8 tile: tf32 m16n8k8, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, as one integer add and
// one mask (half a tf32 ulp added to the magnitude, the 13 low bits cut).
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both tf32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ROWS x D tile of x (rows from `row0`, valid below `nrows`) into shared
// memory with row stride S elements, by 16-byte cp.async; rows past the
// end are zero-filled.
template <typename T, int ROWS, int D, int S, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride, int row0,
                                          int nrows) {
  constexpr int E = 16 / sizeof(T);  // elements per copy
  constexpr int CPR = D / E;         // copies per row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
    const int i = k * THREADS + static_cast<int>(threadIdx.x);
    if (N % THREADS == 0 || i < N) {
      const int r = i / CPR, c = (i % CPR) * E, row = row0 + r;
      const bool ok = row < nrows;
      cp_async16(dst + r * S + c, ok ? src + row * row_stride + c : src, ok ? 16 : 0);
    }
  }
}

// s = Q K^T for the warp's 16 MT rows (Qw) and the BK rows of the tile
// (Kt); each K fragment feeds the MT row tiles.
template <int MT, int D, int BK, int S>
__device__ __forceinline__ void qk(float (&s)[MT][BK / 8][4], const __nv_bfloat16* Qw,
                                   const __nv_bfloat16* Kt, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], Qw + (mt * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      unsigned b[4];  // b0, b1 of n8 tile 2jj, then of 2jj + 1
      ldsm_x4(b, Kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * jj], a[mt], b[0], b[1]);
        mma_bf16(s[mt][2 * jj + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int MT, int D, int BK, int S>
__device__ __forceinline__ void qk(float (&s)[MT][BK / 8][4], const float* Qw, const float* Kt,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* q = Qw + (mt * 16 + g) * S + kk * 8 + t;
      split(q[0], ah[mt][0], al[mt][0]);
      split(q[8 * S], ah[mt][1], al[mt][1]);
      split(q[4], ah[mt][2], al[mt][2]);
      split(q[8 * S + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* k = Kt + (j * 8 + g) * S + kk * 8 + t;
      unsigned bh0, bl0, bh1, bl1;
      split(k[0], bh0, bl0);
      split(k[4], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_3xtf32(s[mt][j], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// o += P V for the warp's 16 MT rows; p holds the softmax weights in the
// accumulator layout of qk.  Each V fragment feeds the MT row tiles.
template <int MT, int D, int BK, int S>
__device__ __forceinline__ void pv(float (&o)[MT][D / 8][4], const float (&p)[MT][BK / 8][4],
                                   const __nv_bfloat16* Vt, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      unsigned b[4];  // b0, b1 of d tile 2dd, then of 2dd + 1
      ldsm_x4_trans(b, Vt + (kk * 16 + (lane & 15)) * S + dd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * dd], a[mt], b[0], b[1]);
        mma_bf16(o[mt][2 * dd + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int MT, int D, int BK, int S>
__device__ __forceinline__ void pv(float (&o)[MT][D / 8][4], const float (&p)[MT][BK / 8][4],
                                   const float* Vt, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    // accumulator (row, 2t) / (row, 2t + 1) as contraction index t / t + 4
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split(p[mt][kk][0], ah[mt][0], al[mt][0]);
      split(p[mt][kk][2], ah[mt][1], al[mt][1]);
      split(p[mt][kk][1], ah[mt][2], al[mt][2]);
      split(p[mt][kk][3], ah[mt][3], al[mt][3]);
    }
    const float* v = Vt + (kk * 8 + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      unsigned bh0, bl0, bh1, bl1;
      split(v[n * 8], bh0, bl0);
      split(v[S + n * 8], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_3xtf32(o[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
}

// One kv tile's online softmax for the warp's rows g and g + 8: s (raw
// scores) becomes p, m / l / o are rescaled.  MASK: mask to col < Skv and,
// if causal, col <= row.
template <bool MASK, int BK, int ND>
__device__ __forceinline__ void softmax(float (&s)[BK / 8][4], float (&m)[2], float (&l)[2],
                                        float (&o)[ND][4], int row, int col, int Skv,
                                        bool causal, float c) {
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cj = col + 8 * j + (e & 1), rj = row + 8 * (e >> 1);
        if (cj >= Skv || (causal && cj > rj)) s[j][e] = NEG;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f((m[h] - mx) * c), mc = mx * c;
    m[h] = mx;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        float pj = exp2f(fmaf(s[j][e], c, -mc));
        if constexpr (MASK) pj = s[j][e] == NEG ? 0.0f : pj;
        s[j][e] = pj;
        rs += pj;
      }
    l[h] = alpha * l[h] + rs;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * h] *= alpha;
      o[n][2 * h + 1] *= alpha;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T>::BQ * 2 / Tiles<T>::MT, Tiles<T>::MIN_BLOCKS)
    flash_fwd(const Params p) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK, STAGES = Tiles<T>::STAGES;
  constexpr int MT = Tiles<T>::MT, WR = 16 * MT;  // m16 row tiles and rows a warp
  constexpr int THREADS = BQ / WR * 32;
  constexpr int S = smem_stride<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * S;
  T* Vs = Ks + STAGES * BK * S;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int heads = p.H * p.B;
  const int tile = gridDim.x / heads - 1 - blockIdx.x / heads;  // longest causal tiles first
  const int h = blockIdx.x % p.H, b = blockIdx.x % heads / p.H;
  const int q0 = tile * BQ;
  const int kh = h / (p.H / p.K);
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kh * p.vsh;

  // kv positions below `kv_end` are seen by some row of this tile
  const int kv_end = p.causal ? min(p.Skv, min(q0 + BQ, p.Sq)) : p.Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_tile<T, BQ, D, S, THREADS>(Qs, qg, p.qss, q0, p.Sq);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile<T, BK, D, S, THREADS>(Ks + st * BK * S, kg, p.kss, st * BK, p.Skv);
      load_tile<T, BK, D, S, THREADS>(Vs + st * BK * S, vg, p.vss, st * BK, p.Skv);
    }
    cp_async_commit();  // one group per stage, empty or not
  }

  const int r0 = q0 + WR * warp;  // the warp's first query row
  float m[MT][2], l[MT][2], o[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG;
    l[mt][0] = l[mt][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + STAGES - 1;
    if (nxt < n_tiles) {
      load_tile<T, BK, D, S, THREADS>(Ks + nxt % STAGES * BK * S, kg, p.kss, nxt * BK, p.Skv);
      load_tile<T, BK, D, S, THREADS>(Vs + nxt % STAGES * BK * S, vg, p.vss, nxt * BK, p.Skv);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // Q and tile `it` have landed
    __syncthreads();

    const int k0 = it * BK;
    const bool skip = r0 >= p.Sq || (p.causal && k0 > r0 + WR - 1);
    if (!skip) {
      const T* Kt = Ks + it % STAGES * BK * S;
      const T* Vt = Vs + it % STAGES * BK * S;
      float s[MT][BK / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
      qk<MT, D, BK, S>(s, Qs + WR * warp * S, Kt, lane);
      const float c = p.scale_log2;
      if (k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > r0)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          softmax<true, BK>(s[mt], m[mt], l[mt], o[mt], r0 + 16 * mt + g, k0 + 2 * t, p.Skv,
                            p.causal, c);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          softmax<false, BK>(s[mt], m[mt], l[mt], o[mt], r0 + 16 * mt + g, k0 + 2 * t, p.Skv,
                             p.causal, c);
      }
      pv<MT, D, BK, S>(o, s, Vt, lane);
    }
    __syncthreads();  // every read of this stage is done before it is refilled
  }
  cp_async_wait<0>();

  if (r0 >= p.Sq) return;
  T* og = static_cast<T*>(p.o) + ((long long)b * p.Sq * p.H + h) * D;
  const long long oss = (long long)p.H * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[mt][hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.0f / fmaxf(lt, 1e-30f);
      const int row = r0 + 16 * mt + g + 8 * hh;
      if (row < p.Sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          store2<T>(og + row * oss + n * 8 + 2 * t, o[mt][n][2 * hh] * inv,
                    o[mt][n][2 * hh + 1] * inv);
      }
    }
}

template <typename T, int D>
int launch_d(const Params& p, cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK, S = smem_stride<T, D>();
  const int smem = static_cast<int>(sizeof(T) * S * (BQ + 2 * Tiles<T>::STAGES * BK));
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((p.Sq + BQ - 1) / BQ) * p.H * p.B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_fwd<T, D><<<static_cast<unsigned>(blocks), BQ * 2 / Tiles<T>::MT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int K, int Sq,
           int Skv, int D, long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss, long long vsh, int causal,
           void* stream) {
  const Params p{q,   k,   v,   o,   B,   H,   K,   Sq,     Skv,
                 qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
                 static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(p, s);
    case 32: return launch_d<T, 32>(p, s);
    case 64: return launch_d<T, 64>(p, s);
    case 128: return launch_d<T, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
                        int Sq, int Skv, int D, long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                        long long vsh, int causal, void* stream) {
  return launch<float>(q, k, v, o, B, H, K, Sq, Skv, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                       vsh, causal, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int K, int Sq, int Skv, int D, long long qsb, long long qss,
                         long long qsh, long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Skv, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
                               vss, vsh, causal, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
