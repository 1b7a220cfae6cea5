// Flash attention, forward: blocked online-softmax GQA attention, causal or
// not, with f32 statistics.
//   q (B, Sq, H, D), k/v (B, Skv, K, D), H % K == 0  ->  o (B, Sq, H, D)
//   o = softmax(q k^T / sqrt(D), masked to kpos <= qpos if causal) v
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd (_flash_kernel), which walks kv blocks on the
// sequential 4th grid axis and carries (m, l, acc) in VMEM scratch.  Here
// one thread block takes one (query tile, query head, batch) and loops over
// the kv tiles itself, keeping (m, l, acc) in registers; blocks run in
// parallel in any order, so nothing carries between them.
//
// Bound on the H100: operations.  At the serving shape (B 4, H 16,
// S 2000, D 128, causal) the kernel does 4*D flops per unmasked (q, k)
// pair, about 66 GFLOP, against 66 MB of q, k, v and o: some 1000 flops
// per byte, far above the card's balance point.  This first version
// computes on the CUDA cores in f32 (no mma.sync or wgmma, no TMA), so
// its ceiling is the 67 TFLOP/s f32 rate, and in bf16 it stays far from the
// 989 TFLOP/s tensor-core bound.  Design for that ceiling: 256 threads
// as a 16 x 16 grid, each thread owning 4 query rows x 4 kv columns of the
// 64 x 64 score tile and 4 rows x D/16 columns of the output, so every
// shared-memory value loaded feeds 4 FMAs; Q and K rows are read as
// float4 from tiles padded to D + 4 floats (no bank conflicts); K and V
// share one tile buffer (85 KB of dynamic shared memory at D = 128, two
// blocks per SM).  Under `causal` the kv tiles wholly above the diagonal
// are never visited and the grid starts with the longest query tiles.
//
// Numerics follow the Pallas kernel: scores accumulate in f32, masked
// scores are -1e30 (never -inf: exp(-inf - -inf) is NaN), the softmax
// weights are rounded to v's type before P*V, the row sum uses the
// unrounded weights, and the result is acc / max(l, 1e-30).  Rows past
// Sq and columns past Skv are masked here (zero tiles, zero weights, no
// stores), so any Sq and Skv are taken without padding.  Strides are
// passed in elements for q, k and v, whose last dimension is contiguous;
// o is written contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // tx = tid % 16, ty = tid / 16
constexpr int RPT = BQ / 16;  // query rows per thread: ty + 16 i
constexpr int CPT = BK / 16;  // score columns per thread: tx + 16 j
constexpr int PS = BK + 4;    // row stride of the P tile, in floats
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, K, Sq, Skv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N consecutive floats from aligned shared memory.
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = p[0];
  }
}

// rows x D tile of x (rows from `row0`, valid below `nrows`) into shared
// memory as f32 with row stride S; rows past the end read as 0.
template <typename T, int D, int ROWS, int S>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int nrows) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D, row = row0 + r;
    dst[r * S + d] = row < nrows ? to_f(src[row * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd(const Params p) {
  constexpr int S = D + 4;                    // row stride of the Q and K/V tiles
  constexpr int VEC = D >= 64 ? 4 : D / 16;   // output columns per vector
  constexpr int NJ = D / (16 * VEC);          // vectors per row and thread
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KVs = Qs + BQ * S;
  float* Ps = KVs + BK * S;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kh * p.vsh;

  load_tile<T, D, BQ, S>(Qs, qg, p.qss, q0, p.Sq);

  float m[RPT], l[RPT], acc[RPT][NJ * VEC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < NJ * VEC; ++e) acc[i][e] = 0.0f;
  }

  // kv positions below `kv_end` are seen by some row of this tile
  const int kv_end = p.causal ? min(p.Skv, min(q0 + BQ, p.Sq)) : p.Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P and V reads are done
    load_tile<T, D, BK, S>(KVs, kg, p.kss, k0, p.Skv);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[RPT][4], kv[CPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) lds<4>(qv[i], &Qs[(ty + 16 * i) * S + d]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) lds<4>(kv[j], &KVs[(tx + 16 * j) * S + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][j] = fmaf(qv[i][c], kv[j][c], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[CPT];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < p.Skv && (!p.causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += pj;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = to_f(from_f<T>(pj));
      }
      l[i] = alpha * l[i] + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NJ * VEC; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();  // P is written and every K read is done
    load_tile<T, D, BK, S>(KVs, vg, p.vss, k0, p.Skv);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pv[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) lds<4>(pv[i], &Ps[(ty + 16 * i) * PS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NJ][VEC];
#pragma unroll
        for (int j = 0; j < NJ; ++j) lds<VEC>(vv[j], &KVs[(c + cc) * S + (16 * j + tx) * VEC]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][j * VEC + e] = fmaf(pv[i][cc], vv[j][e], acc[i][j * VEC + e]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + ((long long)b * p.Sq * p.H + h) * D;
  const long long oss = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        og[row * oss + (16 * j + tx) * VEC + e] = from_f<T>(acc[i][j * VEC + e] / den);
  }
}

template <typename T, int D>
int launch_d(const Params& p, cudaStream_t stream) {
  constexpr int S = D + 4;
  const int smem = static_cast<int>(sizeof(float) * (BQ * S + BK * S + BQ * PS));
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int K, int Sq,
           int Skv, int D, long long qsb, long long qss, long long qsh, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss, long long vsh, int causal,
           void* stream) {
  const Params p{q,   k,   v,   o,   B,   H,   K,   Sq,     Skv,
                 qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
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
