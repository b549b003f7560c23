// Exact k-nearest-neighbour search (K <= 32) for Hopper, three entries:
//
//   o4d_knn_brute  replaces occlusions4d_tpu/ops/pallas_knn.py::_knn_kernel
//                  (:88) and ops/pallas_attention.py::_knnidx_kernel (:1367);
//   o4d_knn_pruned replaces ops/pallas_knn.py::_knn_spatial_scalar_kernel
//                  (:209): the same search over Hilbert-sorted point sets,
//                  skipping key blocks whose bounding box cannot reach the
//                  query tile's current K-th distance;
//   o4d_nn1_bidir  replaces ops/pallas_knn.py::_nn1_bidir_kernel (:521): both
//                  exact 1-NN directions between two clouds in one pass
//                  (design notes at the kernel);
//   o4d_nn1_direct the eval engine's ground-truth 1-NN, the counterpart of the
//                  JAX engine's host op nn1_host (not a Pallas kernel; design
//                  notes at the kernel).
//
// Function: for each query q and key k (rows of x, y, z), the ranking value is
//   d = |k|^2 - 2 q.k        (f32; |k|^2 = +inf marks a masked/padded key)
// and the result is the K smallest (d, key index) pairs in lexicographic
// order: ascending d, ties to the lower key index. The caller adds |q|^2.
// Arithmetic is written with __fmul_rn/__fadd_rn (and the file is built with
// -fmad=false) so every d rounds exactly like the plain PyTorch version's
// elementwise ops: selections agree index for index, ties included.
//
// What bounds it on the H100: neither bytes nor tensor-core FLOPs. The work is
// N*M distance evaluations (7 FLOP each) plus a compare per candidate, on the
// f32 CUDA cores; the inputs are a few MB. Design: one thread per query keeps
// its running top-K sorted in registers (unrolled insertion, K is a template
// parameter), keys stream through shared memory as float4 (x, y, z, |k|^2).
// A candidate that does not beat the current K-th costs one compare, which is
// the common case after the first few hundred keys. The pruned entry adds a
// per-tile bound: a CUDA block is a tile of 64 Hilbert-consecutive queries,
// keys come in blocks of 256 Hilbert-consecutive keys; the seed block (the
// tile's own curve position) goes first, then every other block whose bbox
// gap^2 is within the tile's worst K-th distance (+ a rounding slack) is
// processed. Since ties compare on the ORIGINAL key index, the pruned result
// equals the brute-force one exactly. Tiling for tensor cores (q.k as an MMA)
// and multi-thread-per-query splits are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBruteThreads = 128;
constexpr int kBruteKeyTile = 512;
constexpr int kPruneTile = 64;     // queries per CUDA block (one per thread).
constexpr int kPruneBlockK = 256;  // keys per bbox block.

__device__ __forceinline__ bool better(float d, int i, float D, int I) {
  return d < D || (d == D && i < I);
}

template <int K>
__device__ __forceinline__ void insert(float (&ad)[K], int (&ai)[K], float d,
                                       int i) {
  if (!better(d, i, ad[K - 1], ai[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool before_prev = better(d, i, ad[s - 1], ai[s - 1]);
    const bool before_cur = better(d, i, ad[s], ai[s]);
    const float nd = before_prev ? ad[s - 1] : (before_cur ? d : ad[s]);
    const int ni = before_prev ? ai[s - 1] : (before_cur ? i : ai[s]);
    ad[s] = nd;
    ai[s] = ni;
  }
  if (better(d, i, ad[0], ai[0])) {
    ad[0] = d;
    ai[0] = i;
  }
}

__device__ __forceinline__ float rank_value(float qx, float qy, float qz,
                                            float4 k) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, k.x), __fmul_rn(qy, k.y)),
                              __fmul_rn(qz, k.z));
  return __fsub_rn(k.w, __fmul_rn(2.0f, dot));
}

template <int K>
__global__ void knn_brute_kernel(const float* __restrict__ q,
                                 const float4* __restrict__ keys,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i, int N, int M) {
  __shared__ float4 tile[kBruteKeyTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n < N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * N + n) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float ad[K];
  int ai[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ad[s] = CUDART_INF_F;
    ai[s] = 0;
  }
  const float4* kb = keys + (size_t)b * M;
  for (int t0 = 0; t0 < M; t0 += kBruteKeyTile) {
    const int cnt = min(kBruteKeyTile, M - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) tile[j] = kb[t0 + j];
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j)
        insert<K>(ad, ai, rank_value(qx, qy, qz, tile[j]), t0 + j);
    }
  }
  if (active) {
    float* od = out_d + ((size_t)b * N + n) * K;
    int* oi = out_i + ((size_t)b * N + n) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      od[s] = ad[s];
      oi[s] = ai[s];
    }
  }
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

template <int K>
__global__ void knn_pruned_kernel(const float* __restrict__ q,
                                  const float* __restrict__ qn,
                                  const float4* __restrict__ keys,
                                  const int* __restrict__ korig,
                                  const float* __restrict__ kbox,
                                  const float* __restrict__ tbox,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_i, int Npad, int Mpad,
                                  const float* __restrict__ slack_p) {
  __shared__ float4 blk[kPruneBlockK];
  __shared__ int blk_i[kPruneBlockK];
  __shared__ float red[kPruneTile / 32];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int nt = gridDim.x;
  const int nb = Mpad / kPruneBlockK;
  const int n = t * kPruneTile + threadIdx.x;  // Npad is a tile multiple.
  const size_t row = (size_t)b * Npad + n;
  const float qx = q[row * 3], qy = q[row * 3 + 1], qz = q[row * 3 + 2];
  const float qnv = qn[row];
  const float* tb = tbox + ((size_t)b * nt + t) * 6;
  const float tlo0 = tb[0], tlo1 = tb[1], tlo2 = tb[2];
  const float thi0 = tb[3], thi1 = tb[4], thi2 = tb[5];
  const float slack = *slack_p;

  float ad[K];
  int ai[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ad[s] = CUDART_INF_F;
    ai[s] = 0;
  }
  const float4* kb = keys + (size_t)b * Mpad;
  const int* ko = korig + (size_t)b * Mpad;

  // Block order: the tile's seed block first, then every other block in
  // curve order that passes the bbox test. The test reads only block-uniform
  // values, so every thread takes the same branch around the barriers.
  const int seed = (int)(((long long)t * nb) / max(nt, 1));
  const float* bb = kbox + (size_t)b * nb * 6;
  float bound = CUDART_INF_F;
  for (int it = 0; it <= nb; ++it) {
    const int j = it == 0 ? seed : it - 1;
    if (it > 0) {
      if (j == seed) continue;
      const float* bx = bb + (size_t)j * 6;
      const float g0 = fmaxf(fmaxf(bx[0] - thi0, tlo0 - bx[3]), 0.f);
      const float g1 = fmaxf(fmaxf(bx[1] - thi1, tlo1 - bx[4]), 0.f);
      const float g2 = fmaxf(fmaxf(bx[2] - thi2, tlo2 - bx[5]), 0.f);
      if (g0 * g0 + g1 * g1 + g2 * g2 > bound + slack) continue;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kPruneBlockK; c += blockDim.x) {
      blk[c] = kb[(size_t)j * kPruneBlockK + c];
      blk_i[c] = ko[(size_t)j * kPruneBlockK + c];
    }
    __syncthreads();
    for (int c = 0; c < kPruneBlockK; ++c)
      insert<K>(ad, ai, rank_value(qx, qy, qz, blk[c]), blk_i[c]);
    bound = block_max(__fadd_rn(ad[K - 1], qnv), red);
  }
  float* od = out_d + row * K;
  int* oi = out_i + row * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    od[s] = ad[s];
    oi[s] = ai[s];
  }
}

// Bidirectional exact 1-NN. With a rows (x, y, z, |a|^2) and b rows
// (x, y, z, |b|^2), +inf marking a masked point, t = 2 a.b and
//   out_a[i] = min_j (|b_j|^2 - t_ij),   out_b[j] = min_i (|a_i|^2 - t_ij);
// the caller adds |a_i|^2 (|b_j|^2) and takes the square root. The products
// round like the plain version's elementwise ops (this file builds with
// -fmad=false), and min is exact in any order, so the result equals the
// plain version bit for bit.
// What bounds it on the H100: operations (about 10 f32 instructions per
// pair, 2.5e9 pairs per gv1 sampler frame); the inputs are 1.4 MB. Design:
// every lane of a warp holds the same kNN1Rows a-points in registers and the
// lanes take different keys, so a key's minimum over the warp's rows is a
// register reduction; the block's 8 warps combine through shared memory and
// one float atomic-min per key and block lands in out_b. Each row's minimum
// over its lane's keys is reduced by warp shuffles at the end and lands by one
// atomic-min per row and block. Atomic min is exact and order-free, so the
// result is deterministic.
constexpr int kNN1Warps = 8;
constexpr int kNN1Rows = 16;
constexpr int kNN1Chunk = 512;
constexpr int kNN1KeysPerBlock = 4096;

__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  // Non-negative floats order like ints, negative ones inversely like uints.
  if (!(__float_as_uint(v) >> 31))
    atomicMin((int*)addr, __float_as_int(v));
  else
    atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__global__ void __launch_bounds__(kNN1Warps * 32)
    nn1_bidir_kernel(const float4* __restrict__ a4, const float4* __restrict__ b4,
                     float* __restrict__ out_a, float* __restrict__ out_b, int N,
                     int M) {
  __shared__ float4 kt[kNN1Chunk];
  __shared__ float cm[kNN1Warps][kNN1Chunk];
  const int b = blockIdx.z, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kNN1Warps + warp) * kNN1Rows;
  float ax[kNN1Rows], ay[kNN1Rows], az[kNN1Rows], aq[kNN1Rows], rmin[kNN1Rows];
#pragma unroll
  for (int i = 0; i < kNN1Rows; ++i) {
    const int n = row0 + i;
    float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    if (n < N) v = a4[(size_t)b * N + n];
    ax[i] = v.x;
    ay[i] = v.y;
    az[i] = v.z;
    aq[i] = v.w;
    rmin[i] = CUDART_INF_F;
  }
  const int key_lo = blockIdx.y * kNN1KeysPerBlock;
  const int key_hi = min(M, key_lo + kNN1KeysPerBlock);
  for (int c0 = key_lo; c0 < key_hi; c0 += kNN1Chunk) {
    const int cnt = min(kNN1Chunk, key_hi - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x)
      kt[j] = b4[(size_t)b * M + c0 + j];
    __syncthreads();
    for (int j = lane; j < cnt; j += 32) {
      const float4 kk = kt[j];
      float cmin = CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kNN1Rows; ++i) {
        const float dot = __fadd_rn(
            __fadd_rn(__fmul_rn(ax[i], kk.x), __fmul_rn(ay[i], kk.y)),
            __fmul_rn(az[i], kk.z));
        const float t = __fmul_rn(2.0f, dot);
        rmin[i] = fminf(rmin[i], __fsub_rn(kk.w, t));
        cmin = fminf(cmin, __fsub_rn(aq[i], t));
      }
      cm[warp][j] = cmin;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      float v = cm[0][j];
      for (int w = 1; w < kNN1Warps; ++w) v = fminf(v, cm[w][j]);
      atomic_min_float(out_b + (size_t)b * M + c0 + j, v);
    }
  }
#pragma unroll
  for (int i = 0; i < kNN1Rows; ++i) {
    float v = rmin[i];
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0 && row0 + i < N) atomic_min_float(out_a + (size_t)b * N + row0 + i, v);
  }
}

// Direct-difference exact 1-NN for the eval engine's ground-truth labels:
// the counterpart of occlusions4d_tpu/native/host_ops.cpp::o4d_nn1
// (:240-263), which the JAX engine calls through nn1_host. Per pair
//   d2 = (dx dx + dy dy) + dz dz,   dx = key.x - q.x, ...
// in that order, each product and sum rounded on its own (__fmul_rn /
// __fadd_rn, and this file builds with -fmad=false); the winner is the first
// key in ascending order with d2 < best (best starts at FLT_MAX, index 0), so
// the lowest index wins a tie; the distance is sqrt(best). Unlike the kNN
// ranking value |k|^2 - 2 q.k, the differences keep the low bits of d2 at
// CARLA's coordinate scale, where labels are read against a 0.2 radius.
// What bounds it on the H100: operations (8 f32 operations and a compare per
// pair: 541314 grid queries x 1e5 target points is 5.4e10 pairs); the
// inputs are a few MB. Design: one thread per query keeps (best, index) in
// registers; the keys stream through shared memory in tiles of float4
// (x, y, z, 0) that every thread of the block reads as broadcasts.
constexpr int kNN1DThreads = 128;
constexpr int kNN1DTile = 1024;
constexpr float kFltMax = 3.402823466e+38f;

__global__ void __launch_bounds__(kNN1DThreads)
    nn1_direct_kernel(const float* __restrict__ q, const float4* __restrict__ keys,
                      float* __restrict__ out_d, int* __restrict__ out_i, int N,
                      int M) {
  __shared__ float4 tile[kNN1DTile];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n < N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[(size_t)n * 3];
    qy = q[(size_t)n * 3 + 1];
    qz = q[(size_t)n * 3 + 2];
  }
  float best = kFltMax;
  int bi = 0;
  for (int t0 = 0; t0 < M; t0 += kNN1DTile) {
    const int cnt = min(kNN1DTile, M - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) tile[j] = keys[t0 + j];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 k = tile[j];
      const float dx = __fsub_rn(k.x, qx), dy = __fsub_rn(k.y, qy),
                  dz = __fsub_rn(k.z, qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        bi = t0 + j;
      }
    }
  }
  if (active) {
    out_d[n] = __fsqrt_rn(best);
    out_i[n] = bi;
  }
}

#define O4D_K_CASES(X)                                                       \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) \
  X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26)    \
  X(27) X(28) X(29) X(30) X(31) X(32)

}  // namespace

extern "C" int o4d_knn_prune_tile() { return kPruneTile; }
extern "C" int o4d_knn_prune_block() { return kPruneBlockK; }

// q (B, N, 3) f32; keys (B, M, 4) f32 rows (x, y, z, |k|^2 or +inf);
// out_d (B, N, K) f32 ranking values; out_i (B, N, K) int32 key rows.
extern "C" int o4d_knn_brute(const void* q, const void* keys, void* out_d,
                             void* out_i, int B, int N, int M, int K,
                             void* stream) {
  if (N <= 0 || B <= 0) return 0;
  dim3 grid((N + kBruteThreads - 1) / kBruteThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* qp = (const float*)q;
  const float4* kp = (const float4*)keys;
  float* dp = (float*)out_d;
  int* ip = (int*)out_i;
  switch (K) {
#define O4D_BRUTE(KK)                                                  \
  case KK:                                                             \
    knn_brute_kernel<KK><<<grid, kBruteThreads, 0, s>>>(qp, kp, dp, ip, \
                                                        N, M);         \
    break;
    O4D_K_CASES(O4D_BRUTE)
#undef O4D_BRUTE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// q (B, Npad, 3) Hilbert-sorted, Npad a multiple of the tile; qn (B, Npad);
// keys (B, Mpad, 4) sorted, Mpad a multiple of the block; korig (B, Mpad)
// original key index of each sorted row; kbox (B, Mpad/block, 6) and
// tbox (B, Npad/tile, 6) rows (lo xyz, hi xyz); slack (1,) f32 on the device
// (the bbox test's rounding slack, read there so the host never waits for
// it); out_d/out_i (B, Npad, K) with ORIGINAL key indices.
extern "C" int o4d_knn_pruned(const void* q, const void* qn, const void* keys,
                              const void* korig, const void* kbox,
                              const void* tbox, void* out_d, void* out_i,
                              int B, int Npad, int Mpad, int K,
                              const void* slack, void* stream) {
  if (Npad <= 0 || B <= 0) return 0;
  if (Npad % kPruneTile || Mpad % kPruneBlockK || Mpad <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Npad / kPruneTile, B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
#define O4D_PRUNED(KK)                                                     \
  case KK:                                                                 \
    knn_pruned_kernel<KK><<<grid, kPruneTile, 0, s>>>(                     \
        (const float*)q, (const float*)qn, (const float4*)keys,            \
        (const int*)korig, (const float*)kbox, (const float*)tbox,         \
        (float*)out_d, (int*)out_i, Npad, Mpad, (const float*)slack);      \
    break;
    O4D_K_CASES(O4D_PRUNED)
#undef O4D_PRUNED
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a (B, N, 4) f32 rows (x, y, z, |a|^2 or +inf); b (B, M, 4) likewise;
// out_a (B, N) and out_b (B, M) f32, filled with +inf by the caller.
extern "C" int o4d_nn1_bidir(const void* a, const void* b, void* out_a,
                             void* out_b, int B, int N, int M, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return 0;
  dim3 grid((N + kNN1Warps * kNN1Rows - 1) / (kNN1Warps * kNN1Rows),
            (M + kNN1KeysPerBlock - 1) / kNN1KeysPerBlock, B);
  nn1_bidir_kernel<<<grid, kNN1Warps * 32, 0, (cudaStream_t)stream>>>(
      (const float4*)a, (const float4*)b, (float*)out_a, (float*)out_b, N, M);
  return (int)cudaGetLastError();
}

// q (N, 3) f32; keys (M, 4) f32 rows (x, y, z, unused); out_d (N) f32
// Euclidean distances, out_i (N) int32 key rows.
extern "C" int o4d_nn1_direct(const void* q, const void* keys, void* out_d,
                              void* out_i, int N, int M, void* stream) {
  if (N <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  nn1_direct_kernel<<<(N + kNN1DThreads - 1) / kNN1DThreads, kNN1DThreads, 0,
                      (cudaStream_t)stream>>>((const float*)q, (const float4*)keys,
                                              (float*)out_d, (int*)out_i, N, M);
  return (int)cudaGetLastError();
}
