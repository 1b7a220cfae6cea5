// Paged attention, decode: one query per sequence against its KV pages,
// GQA, f32 softmax statistics, over one layer or a folded stack of layers.
//   q (L, B, H, D); k/v pages (L, N, P, K, D), H % K == 0;
//   table (B, M) int32; lengths (B,) int32  ->  o (L, B, H, D)
//   o[l, b, h] = softmax(q k^T / sqrt(D)) v over tokens t < lengths[b] of
//   head h / (H / K), token t at pages[l, table[b, t / P], t % P]
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention_bhd (_paged_kernel), whose index map fetches page
// table[b, j] on the sequential third grid axis and carries (m, l, acc) in
// VMEM scratch, and ops.paged_attention_layers, which calls it once per
// layer.  Here one thread block takes one (head, sequence, layer) and walks
// the sequence's tokens itself; blocks run in parallel in any order.  The
// fold is one launch with the layer as the grid's z axis, and the block's
// arithmetic does not depend on L, so it equals L single-layer launches bit
// for bit.
//
// Bound on the H100: bytes.  Each token's K and V rows are read once and
// used for 4 D flops per query head, under one flop per byte.  At the
// serving shape (B 8, H = K = 16, D 128, P 16, f32, lengths 4 x 1000 and
// 4 x 2000) a launch reads about 197 MB of pages, 0.059 ms at 3.35 TB/s.
// Design for that bound, kept simple: 8 warps a block; warp w takes tokens
// w*4 .. w*4+3 of every 32, and each lane reads elements lane + 32 i of the
// K and V rows of all four before it reduces, so a block keeps 32 KB of
// loads in flight (f32, D 128) and neighbouring lanes read neighbouring
// addresses.  Each warp keeps its own (m, l, acc) in registers; the eight
// are merged through shared memory at the end.  Known slow spot: B * H is
// the whole grid, 128 blocks at the serving shape, under one wave of 132
// SMs, and each block streams its sequence's 1-2 MB alone.  Splitting a
// sequence's tokens over several blocks (split-K with a merge) is the
// redesign.
//
// Numerics follow the Pallas kernel: scores in f32, scaled by 1/sqrt(D)
// after the dot product; softmax weights rounded to the pages' type before
// P*V, the row sum kept unrounded; o = acc / max(l, 1e-30), so a length-0
// row gives 0.  Only tokens t < min(length, M * P) are read: whole pages
// past ceil(length / P) cost nothing, and the slots past the length in the
// last page are never loaded, so whatever they hold (even inf or NaN)
// cannot reach the result.  Padding table slots are never read.  Strides
// are in elements; the last dimension of q and of the pages is contiguous,
// o is written contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;   // tokens a warp loads before it reduces
constexpr int MAX_D = 256;  // 8 elements a lane
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lengths;
  void* o;
  int B, H, K, P, M, D;
  long long qsl, qsb, qsh;       // q: layer, sequence, head
  long long ksl, ksn, ksp, ksh;  // k pages: layer, page, slot, head
  long long vsl, vsn, vsp, vsh;  // v pages
  long long tsb, lsb;            // table row, lengths
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

// NPL elements per lane: lane + 32 i for i < NPL covers D <= 32 NPL.
template <typename T, int NPL>
__global__ void __launch_bounds__(THREADS) paged_decode(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kvh = h / (p.H / p.K);
  const int len = max(0, min(p.lengths[b * p.lsb], p.M * p.P));

  const T* q = static_cast<const T*>(p.q) + l * p.qsl + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + l * p.ksl + kvh * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + l * p.vsl + kvh * p.vsh;
  const int* tbl = p.table + b * p.tsb;

  float qr[NPL], acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < p.D ? to_f(q[d]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = NEG, sum = 0.0f;

  for (int t0 = warp * UNROLL; t0 < len; t0 += WARPS * UNROLL) {
    float kr[UNROLL][NPL], vr[UNROLL][NPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      const bool ok = t < len;
      const int page = ok ? __ldg(tbl + t / p.P) : 0;
      const int slot = t % p.P;
      const T* kt = kb + page * p.ksn + slot * p.ksp;
      const T* vt = vb + page * p.vsn + slot * p.vsp;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        const bool in = ok && d < p.D;
        kr[u][i] = in ? to_f(kt[d]) : 0.0f;
        vr[u][i] = in ? to_f(vt[d]) : 0.0f;
      }
    }
    float s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) s[u] = fmaf(qr[i], kr[u][i], s[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s[u] += __shfl_xor_sync(FULL, s[u], off);
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = t0 + u < len ? s[u] * p.scale : NEG;  // a select, never a multiply
      mx = fmaxf(mx, s[u]);
    }
    const float alpha = expf(m - mx);
    sum *= alpha;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float w = expf(s[u] - mx);
      sum += w;
      const float wv = to_f(from_f<T>(w));  // rounded to the pages' type for P*V
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] = fmaf(wv, vr[u][i], acc[i]);
    }
    m = mx;
  }

  // Merge the warps' (m, l, acc); a warp that saw no token holds (-1e30, 0, 0).
  __shared__ float sm[WARPS], ssum[WARPS], sacc[WARPS][MAX_D];
  if (lane == 0) sm[warp] = m, ssum[warp] = sum;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) sacc[warp][d] = acc[i];
  }
  __syncthreads();
  float mall = NEG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mall = fmaxf(mall, sm[w]);
  float c[WARPS], den = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    c[w] = expf(sm[w] - mall);
    den += ssum[w] * c[w];
  }
  den = fmaxf(den, 1e-30f);
  T* o = static_cast<T*>(p.o) + ((static_cast<long long>(l) * p.B + b) * p.H + h) * p.D;
  for (int d = threadIdx.x; d < p.D; d += THREADS) {
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) x = fmaf(sacc[w][d], c[w], x);
    o[d] = from_f<T>(x / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table, const void* lengths,
           void* o, int L, int B, int H, int K, int P, int M, int D, long long qsl, long long qsb,
           long long qsh, long long ksl, long long ksn, long long ksp, long long ksh,
           long long vsl, long long vsn, long long vsp, long long vsh, long long tsb,
           long long lsb, void* stream) {
  if (L < 1 || B < 1 || H < 1 || K < 1 || H % K || P < 1 || M < 1 || D < 1 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   static_cast<const int*>(table), static_cast<const int*>(lengths),
                 o,   B,   H,   K,   P,   M,   D,   qsl, qsb, qsh, ksl, ksn, ksp, ksh,
                 vsl, vsn, vsp, vsh, tsb, lsb,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B, L);
  if (D <= 32) {
    paged_decode<T, 1><<<grid, THREADS, 0, s>>>(p);
  } else if (D <= 64) {
    paged_decode<T, 2><<<grid, THREADS, 0, s>>>(p);
  } else if (D <= 128) {
    paged_decode<T, 4><<<grid, THREADS, 0, s>>>(p);
  } else {
    paged_decode<T, 8><<<grid, THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int paged_attention_f32(const void* q, const void* k, const void* v, const void* table,
                        const void* lengths, void* o, int L, int B, int H, int K, int P, int M,
                        int D, long long qsl, long long qsb, long long qsh, long long ksl,
                        long long ksn, long long ksp, long long ksh, long long vsl, long long vsn,
                        long long vsp, long long vsh, long long tsb, long long lsb, void* stream) {
  return launch<float>(q, k, v, table, lengths, o, L, B, H, K, P, M, D, qsl, qsb, qsh, ksl, ksn,
                       ksp, ksh, vsl, vsn, vsp, vsh, tsb, lsb, stream);
}

int paged_attention_bf16(const void* q, const void* k, const void* v, const void* table,
                         const void* lengths, void* o, int L, int B, int H, int K, int P, int M,
                         int D, long long qsl, long long qsb, long long qsh, long long ksl,
                         long long ksn, long long ksp, long long ksh, long long vsl,
                         long long vsn, long long vsp, long long vsh, long long tsb,
                         long long lsb, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, table, lengths, o, L, B, H, K, P, M, D, qsl, qsb, qsh,
                               ksl, ksn, ksp, ksh, vsl, vsn, vsp, vsh, tsb, lsb, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
