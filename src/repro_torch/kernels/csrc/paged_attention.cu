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
// layer.
//
// Bound on the H100: bytes.  Each token's K and V rows are read once per
// kv head and used for 4 D flops per query head, under one flop per byte.
// At the serving shape (B 8, H = K = 16, D 128, P 16, f32, lengths 4 x 1000
// and 4 x 2000) a launch reads about 197 MB of pages, 0.059 ms at 3.35 TB/s.
//
// Design for that bound: split-K over a row's pages, merged inside a
// thread-block cluster.
//  - One cluster of SPLITS blocks takes one (kv head, row, layer); block s
//    of it takes the row's pages [s pps, min(np, (s + 1) pps)), np =
//    ceil(len / P), pps = ceil(np / SPLITS).  The split depends on the
//    row's length only, never on L or B, so the fold (layer = the grid's z
//    axis) equals L single-layer launches bit for bit.  At the serving
//    shape the grid is 16 kv heads x 8 splits x 8 rows = 1,024 blocks,
//    about 7.8 for each of the 132 SMs; one block streams 128-256 KB.
//  - A block computes every query head of its kv head (R = H / K), spread
//    over its 8 warps: heads are taken 8 at a time, and the warps of one
//    head share its tokens (R = 1: all 8 warps on one head; R = 9: one
//    warp a head, then all 8 on the ninth).  A warp holds q and (m, l,
//    acc) of one head in registers, 4-8 elements a lane.  Each warp loads
//    the K/V rows of its own head's tokens, so at R > 1 the block reads a
//    row once per query head (from L1 or L2 after the first), not once
//    per kv head.
//  - Loads: a warp reads a K or V row with one instruction (lane i takes
//    elements 4i .. 4i + 3: 16 bytes a lane in f32, 8 in bf16) where the
//    bases and the strides allow it (the vector instantiation, W = 4),
//    else element by element (W = 1).  Each warp loads a batch of U tokens
//    (16 registers of K and 16 of V a lane: U = 4 in f32 and 8 in bf16 at
//    D 128, 64 bytes of each a lane, 4 KB a warp), then reduces it.  Three
//    blocks an SM (at most 80 registers a thread) keep 24 warps' batches,
//    up to 96 KB, in flight on each SM while others reduce or merge.  A
//    register double buffer (the next batch loaded before the current one
//    is reduced) needs 127 registers, two blocks an SM, and was slower
//    on the H100 at the serving shape, in bf16 and in the fold.
//  - Merge: the warps of a head merge through shared memory into the
//    block's (m, l, acc[D]); after cluster.sync() block s reads the
//    partials of all SPLITS blocks through distributed shared memory,
//    combines them in rank order and writes its slice of D; a second
//    cluster.sync() keeps every block's partials alive until all are read.
//    One launch, no workspace, no atomics, a fixed order: two runs are
//    equal bit for bit.  A block whose split holds no token still reaches
//    both syncs, with the partial (-1e30, 0, 0).
//
// Numerics follow the Pallas kernel: scores in f32, scaled by 1/sqrt(D)
// after the dot product; masking by a select to -1e30, never a multiply;
// softmax weights rounded to the pages' type before P*V (at the warp's
// running max), the row sum kept unrounded; o = acc / max(l, 1e-30), so a
// length-0 row gives 0.  Only tokens t < min(length, M * P) are read:
// whole pages past ceil(length / P) cost nothing, and the slots past the
// length in the last page are never loaded, so whatever they hold (even
// inf or NaN) cannot reach the result.  Padding table slots are never
// read.  Strides are in elements; the last dimension of q and of the pages
// is contiguous, o is written contiguous.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int SPLITS = 8;  // blocks a (kv head, row, layer): one cluster, the portable size
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_D = 256;
constexpr int BATCH_REGS = 16;  // registers of K (and as many of V) a lane loads per batch
constexpr int MAX_BATCH = 8;   // tokens a warp loads per batch, at most
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

// What one lane loads at once: W elements of T.
template <typename T, int W>
struct Chunk;
template <>
struct Chunk<float, 4> { using type = float4; };
template <>
struct Chunk<float, 1> { using type = float; };
template <>
struct Chunk<__nv_bfloat16, 4> { using type = uint2; };
template <>
struct Chunk<__nv_bfloat16, 1> { using type = unsigned short; };

__device__ __forceinline__ void unpack(float4 c, float* f) {
  f[0] = c.x, f[1] = c.y, f[2] = c.z, f[3] = c.w;
}
__device__ __forceinline__ void unpack(float c, float* f) { f[0] = c; }
// bf16 -> f32 is exact: the 16 bits become the high half.
__device__ __forceinline__ void unpack(uint2 c, float* f) {
  f[0] = __uint_as_float(c.x << 16), f[1] = __uint_as_float(c.x & 0xffff0000u);
  f[2] = __uint_as_float(c.y << 16), f[3] = __uint_as_float(c.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack(unsigned short c, float* f) {
  f[0] = __uint_as_float(static_cast<unsigned>(c) << 16);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);  // x rounded to T, back in f32
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The K and V chunks of tokens t0 .. t0 + U - 1 (those below end) that
// this lane holds; the rest are zero and never loaded.
template <typename T, int W, int NPL, int U>
__device__ __forceinline__ void load_batch(const Params& p, const T* kb, const T* vb,
                                           const int* tbl, int t0, int end, int lane,
                                           typename Chunk<T, W>::type (&kr)[U][NPL],
                                           typename Chunk<T, W>::type (&vr)[U][NPL]) {
  using C = typename Chunk<T, W>::type;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    const bool ok = t < end;
    const int page = ok ? __ldg(tbl + t / p.P) : 0;
    const int slot = t % p.P;
    const C* kt = reinterpret_cast<const C*>(kb + page * p.ksn + slot * p.ksp);
    const C* vt = reinterpret_cast<const C*>(vb + page * p.vsn + slot * p.vsp);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = i * 32 + lane;  // chunk index: elements c W .. c W + W - 1
      const bool in = ok && c * W < p.D;
      kr[u][i] = in ? __ldg(kt + c) : C{};
      vr[u][i] = in ? __ldg(vt + c) : C{};
    }
  }
}

// One batch into the warp's online softmax (m, sum, acc).
template <typename T, int W, int NPL, int U>
__device__ __forceinline__ void reduce_batch(const Params& p, int t0, int end, const float* qf,
                                             const typename Chunk<T, W>::type (&kr)[U][NPL],
                                             const typename Chunk<T, W>::type (&vr)[U][NPL],
                                             float& m, float& sum, float* acc) {
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    s[u] = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      float kf[W];
      unpack(kr[u][i], kf);
#pragma unroll
      for (int j = 0; j < W; ++j) s[u] = fmaf(qf[i * W + j], kf[j], s[u]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(FULL, s[u], off);
  }
  float mx = m;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    s[u] = t0 + u < end ? s[u] * p.scale : NEG;  // a select, never a multiply
    mx = fmaxf(mx, s[u]);
  }
  const float alpha = expf(m - mx);
  sum *= alpha;
#pragma unroll
  for (int e = 0; e < W * NPL; ++e) acc[e] *= alpha;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float w = expf(s[u] - mx);
    sum += w;
    const float wv = round_to<T>(w);  // rounded to the pages' type for P*V
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      float vf[W];
      unpack(vr[u][i], vf);
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i * W + j] = fmaf(wv, vf[j], acc[i * W + j]);
    }
  }
  m = mx;
}

// W elements a lane loads at once (4: the vector instantiation, 1: scalar);
// NPL chunks a lane, so D <= 32 W NPL.  The vector instantiations keep three
// blocks an SM (at most 80 registers); the scalar ones, a fallback for odd
// views, may take more registers instead of spilling.
template <typename T, int W, int NPL>
__global__ void __cluster_dims__(SPLITS, 1, 1) __launch_bounds__(THREADS, W == 4 ? 3 : 1)
    paged_decode(const Params p) {
  using C = typename Chunk<T, W>::type;
  constexpr int E = W * NPL;  // elements of a row a lane holds
  constexpr int REGS = NPL * ((W * static_cast<int>(sizeof(T)) + 3) / 4);  // a token's K chunks
  constexpr int U = BATCH_REGS / REGS < 1 ? 1
                    : BATCH_REGS / REGS > MAX_BATCH ? MAX_BATCH
                                                    : BATCH_REGS / REGS;  // tokens a batch
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.x / SPLITS, b = blockIdx.y, layer = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int R = p.H / p.K;
  const int len = max(0, min(p.lengths[b * p.lsb], p.M * p.P));
  const int pps = ((len + p.P - 1) / p.P + SPLITS - 1) / SPLITS;  // pages a split
  const int begin = min(len, split * pps * p.P);
  const int end = min(len, (split + 1) * pps * p.P);

  const T* kb = static_cast<const T*>(p.k) + layer * p.ksl + kvh * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + layer * p.vsl + kvh * p.vsh;
  const int* tbl = p.table + b * p.tsb;

  __shared__ float wm[WARPS], wl[WARPS], wacc[WARPS][MAX_D];  // each warp's partial
  __shared__ float bm[WARPS], bl[WARPS], bacc[WARPS][MAX_D];  // the block's, per head

  for (int r0 = 0; r0 < R; r0 += WARPS) {  // up to 8 query heads a pass
    const int hp = min(WARPS, R - r0);     // heads in this pass
    const int per = WARPS / hp;            // warps a head
    const int hr = warp / per, slot = warp % per;
    float m = NEG, sum = 0.0f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    if (hr < hp) {  // warp-uniform: the last WARPS % hp warps sit out
      const T* q = static_cast<const T*>(p.q) + layer * p.qsl + b * p.qsb +
                   (kvh * R + r0 + hr) * p.qsh;
      float qf[E];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int c = i * 32 + lane;
        const C qc = c * W < p.D ? __ldg(reinterpret_cast<const C*>(q) + c) : C{};
        unpack(qc, qf + i * W);
      }
      const int step = per * U;
      C kr[U][NPL], vr[U][NPL];
      for (int t0 = begin + slot * U; t0 < end; t0 += step) {
        load_batch<T, W, NPL, U>(p, kb, vb, tbl, t0, end, lane, kr, vr);
        reduce_batch<T, W, NPL, U>(p, t0, end, qf, kr, vr, m, sum, acc);
      }
    }

    // The warps of each head into the block's partial; a warp that saw no
    // token holds (-1e30, 0, 0).
    if (lane == 0) wm[warp] = m, wl[warp] = sum;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int d = (i * 32 + lane) * W + j;
        if (d < p.D) wacc[warp][d] = acc[i * W + j];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < hp * p.D; idx += THREADS) {
      const int r = idx / p.D, d = idx % p.D, w0 = r * per;
      float mall = NEG;
      for (int w = w0; w < w0 + per; ++w) mall = fmaxf(mall, wm[w]);
      float den = 0.0f, x = 0.0f;
      for (int w = w0; w < w0 + per; ++w) {
        const float c = expf(wm[w] - mall);
        den += wl[w] * c;
        x = fmaf(wacc[w][d], c, x);
      }
      bacc[r][d] = x;
      if (d == 0) bm[r] = mall, bl[r] = den;
    }

    // The SPLITS blocks' partials, in rank order; block `split` writes its
    // slice of D.
    cluster.sync();
    const int width = (p.D + SPLITS - 1) / SPLITS;
    const int d0 = split * width, nd = max(0, min(p.D, d0 + width) - d0);
    for (int idx = threadIdx.x; idx < hp * nd; idx += THREADS) {
      const int r = idx / nd, d = d0 + idx % nd;
      float ms[SPLITS], mall = NEG;
#pragma unroll
      for (int s = 0; s < SPLITS; ++s) {
        ms[s] = *cluster.map_shared_rank(&bm[r], s);
        mall = fmaxf(mall, ms[s]);
      }
      float den = 0.0f, x = 0.0f;
#pragma unroll
      for (int s = 0; s < SPLITS; ++s) {
        const float c = expf(ms[s] - mall);
        den += *cluster.map_shared_rank(&bl[r], s) * c;
        x = fmaf(*cluster.map_shared_rank(&bacc[r][d], s), c, x);
      }
      T* o = static_cast<T*>(p.o) +
             ((static_cast<long long>(layer) * p.B + b) * p.H + kvh * R + r0 + r) * p.D;
      o[d] = from_f<T>(x / fmaxf(den, 1e-30f));
    }
    cluster.sync();  // every block's partials stay until all are read
  }
}

// Of the calling thread's last call: the kernels it launched, the elements
// a lane loaded at once (4: the vector instantiation, 1: scalar), the
// blocks of its grid and the blocks of the cluster the kernel was built
// with, as the runtime reports it.
thread_local int launched = 0;
thread_local int load_width = 0;
thread_local long long blocks = 0;
thread_local int cluster = 0;

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<std::uintptr_t>(ptr) % bytes == 0;
}

// A stride matters only where its dimension holds more than one index.
bool whole(long long stride, int extent, int w) { return extent == 1 || stride % w == 0; }

// Blocks a cluster of `kernel` holds, as its build fixed them (0 if the
// runtime cannot say; the error then stays for cudaGetLastError).
template <typename F>
int cluster_of(F* kernel) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return 0;
  return a.requiredClusterWidth * a.requiredClusterHeight * a.requiredClusterDepth;
}

template <typename T, int W, int NPL>
void start(const Params& p, dim3 grid, cudaStream_t s) {
  static const int built_cluster = cluster_of(paged_decode<T, W, NPL>);
  paged_decode<T, W, NPL><<<grid, THREADS, 0, s>>>(p);
  launched = 1;
  load_width = W;
  blocks = static_cast<long long>(grid.x) * grid.y * grid.z;
  cluster = built_cluster;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table, const void* lengths,
           void* o, int L, int B, int H, int K, int P, int M, int D, long long qsl, long long qsb,
           long long qsh, long long ksl, long long ksn, long long ksp, long long ksh,
           long long vsl, long long vsn, long long vsp, long long vsh, long long tsb,
           long long lsb, void* stream) {
  launched = 0;
  load_width = 0;
  blocks = 0;
  cluster = 0;
  if (L < 1 || B < 1 || H < 1 || K < 1 || H % K || P < 1 || M < 1 || D < 1 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   static_cast<const int*>(table), static_cast<const int*>(lengths),
                 o,   B,   H,   K,   P,   M,   D,   qsl, qsb, qsh, ksl, ksn, ksp, ksh,
                 vsl, vsn, vsp, vsh, tsb, lsb,
                 static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(SPLITS * K, B, L);
  constexpr int W = 4;
  const bool vec = D % W == 0 && aligned(q, W * sizeof(T)) && aligned(k, W * sizeof(T)) &&
                   aligned(v, W * sizeof(T)) && whole(qsl, L, W) && whole(qsb, B, W) &&
                   whole(qsh, H, W) && whole(ksl, L, W) && ksn % W == 0 && whole(ksp, P, W) &&
                   whole(ksh, K, W) && whole(vsl, L, W) && vsn % W == 0 && whole(vsp, P, W) &&
                   whole(vsh, K, W);
  if (vec) {
    if (D <= 32 * W) start<T, W, 1>(p, grid, s);
    else start<T, W, 2>(p, grid, s);
  } else if (D <= 32) {
    start<T, 1, 1>(p, grid, s);
  } else if (D <= 64) {
    start<T, 1, 2>(p, grid, s);
  } else if (D <= 128) {
    start<T, 1, 4>(p, grid, s);
  } else {
    start<T, 1, 8>(p, grid, s);
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

// Kernels the calling thread's last paged_attention_{f32,bf16} launched (1).
int paged_attention_launched() { return launched; }

// Elements a lane loaded at once in that launch: 4 where the bases and the
// strides allow it (16 bytes in f32, 8 in bf16), else 1.
int paged_attention_load_width() { return load_width; }

// Blocks a (kv head, row, layer) is split over: the cluster's size.
int paged_attention_splits() { return SPLITS; }

// Blocks of that launch's grid, and of each cluster of it.
long long paged_attention_blocks() { return blocks; }
int paged_attention_cluster() { return cluster; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
