// Two designs of the exact brute-force kNN timed beside o4d_knn_brute
// (occlusions4d_torch/csrc/knn.cu) on the same lines, and used by no path.
// Built by tools/profile_knn_interp.py --variants with knn.cu's flags
// (sm_90a, -O3, -fmad=false), which includes knn.cu for its helpers
// (rank_value, better, insert, load_stage) and constants, so every ranking
// value rounds as the production kernel's does. Same arguments and result
// as o4d_knn_brute: q (B, N, 3) f32, keys (B, M, 4) f32 rows (x, y, z,
// |k|^2 or +inf), out_d / out_i (B, N, K) in (d, index) order with filler
// rows (+inf, 0).
//
//   probe_knn_lane_topk  each of a query's L lanes keeps the top K of its
//                        share of the keys (key c to lane c mod L) in
//                        registers; a key enters only if it beats the bound
//                        the lanes share, the (d, index) minimum of their
//                        K-th entries (each lane's K-th bounds the query's
//                        K-th from above), refreshed by shuffles every 32
//                        keys of the query; the lists are merged by
//                        shuffles in (d, index) order as knn_pruned_kernel
//                        merges its lanes. K 12, 14 or 16; L 4, 8, 16, 32.
//   probe_knn_warpq      the ballot-filtered warp queue: a warp per query,
//                        lane s holding its s-th entry; a round's 32 keys
//                        are filtered against the K-th entry by a ballot and
//                        each survivor shifts into the list by shuffles.

#include "../occlusions4d_torch/csrc/knn.cu"

namespace {

template <int K, int L>
__global__ void __launch_bounds__(kBruteThreads)
    knn_lane_topk_kernel(const float* __restrict__ q, const float4* __restrict__ keys,
                         float* __restrict__ out_d, int* __restrict__ out_i, int N, int M) {
  extern __shared__ float4 smb[];
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int Q = kBruteThreads / L;
  constexpr int kRound = 32;  // keys of the query between refreshes of the bound
  const int tid = threadIdx.x, g = tid & (L - 1), b = blockIdx.y;
  const int ntiles = (N + Q - 1) / Q;
  const float4* kb = keys + (size_t)b * M;
  const bool streamed = M > kBruteStage;
  if (!streamed) load_stage(smb, kb, 0, M);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile * Q + tid / L;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (n < N) {
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
    float bd = CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int t0 = 0; t0 < M; t0 += kBruteStage) {
      const int tc = min(kBruteStage, M - t0);
      if (streamed) {
        __syncthreads();
        load_stage(smb, kb, t0, tc);
      }
      for (int c0 = 0; c0 < tc; c0 += kRound) {
        const int c1 = min(tc, c0 + kRound);
        for (int c = c0 + g; c < c1; c += L) {
          const float d = rank_value(qx, qy, qz, smb[c]);
          if (better(d, t0 + c, bd, bi)) insert<K>(ad, ai, d, t0 + c);
        }
        float vd = ad[K - 1];
        int vi = ai[K - 1];
#pragma unroll
        for (int off = 1; off < L; off <<= 1) {
          const float od = __shfl_xor_sync(kAll, vd, off);
          const int oi = __shfl_xor_sync(kAll, vi, off);
          if (better(od, oi, vd, vi)) {
            vd = od;
            vi = oi;
          }
        }
        bd = vd;
        bi = vi;
      }
    }
#pragma unroll 1
    for (int off = 1; off < L; off <<= 1) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(kAll, ad[s], off);
        oi[s] = __shfl_xor_sync(kAll, ai[s], off);
      }
#pragma unroll 1
      for (int s = 0; s < K; ++s) insert<K>(ad, ai, od[s], oi[s]);
    }
    if (g == 0 && n < N) {
      float* od = out_d + ((size_t)b * N + n) * K;
      int* oi = out_i + ((size_t)b * N + n) * K;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = ad[s];
        oi[s] = ai[s];
      }
    }
  }
}

__global__ void __launch_bounds__(kBruteThreads)
    knn_warpq_kernel(const float* __restrict__ q, const float4* __restrict__ keys,
                     float* __restrict__ out_d, int* __restrict__ out_i, int N, int M, int K) {
  extern __shared__ float4 smb[];
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  const int n = blockIdx.x * (kBruteThreads / 32) + (threadIdx.x >> 5);
  const bool active = n < N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * N + n) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float4* kb = keys + (size_t)b * M;
  float my_d = CUDART_INF_F, thr_d = CUDART_INF_F;
  int my_i = 0, thr_i = 0;
  for (int t0 = 0; t0 < M; t0 += kBruteStage) {
    const int cnt = min(kBruteStage, M - t0);
    if (t0 > 0) __syncthreads();
    load_stage(smb, kb, t0, cnt);
    for (int c0 = 0; c0 < cnt; c0 += 32) {
      const int c = c0 + lane;
      float d = CUDART_INF_F;
      bool pass = false;
      if (c < cnt) {
        d = rank_value(qx, qy, qz, smb[c]);
        pass = better(d, t0 + c, thr_d, thr_i);
      }
      unsigned bal = __ballot_sync(0xffffffffu, pass);
      while (bal) {
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        const float cd = __shfl_sync(0xffffffffu, d, src);
        const int ci = t0 + c0 + src;
        const float pd = __shfl_up_sync(0xffffffffu, my_d, 1);
        const int pi = __shfl_up_sync(0xffffffffu, my_i, 1);
        const bool here = better(cd, ci, my_d, my_i);
        const bool prev = lane > 0 && better(cd, ci, pd, pi);
        my_d = prev ? pd : (here ? cd : my_d);
        my_i = prev ? pi : (here ? ci : my_i);
      }
      thr_d = __shfl_sync(0xffffffffu, my_d, K - 1);
      thr_i = __shfl_sync(0xffffffffu, my_i, K - 1);
    }
  }
  if (active && lane < K) {
    out_d[((size_t)b * N + n) * K + lane] = my_d;
    out_i[((size_t)b * N + n) * K + lane] = my_i;
  }
}

// One resident wave of blocks per example, as brute_launch (single device).
template <int K, int L>
int lane_topk_launch(const void* q, const void* keys, void* out_d, void* out_i, int B, int N,
                     int M, cudaStream_t s) {
  static int occ = 0, sms = 0;
  static size_t last_smem = 0;
  const size_t smem = brute_stage_bytes(M);
  cudaError_t e = cudaSuccess;
  if (sms == 0) {
    e = cudaFuncSetAttribute(knn_lane_topk_kernel<K, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBruteStage * 16);
    if (e != cudaSuccess) return (int)e;
    int dev = 0;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem != last_smem || occ <= 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, knn_lane_topk_kernel<K, L>,
                                                      kBruteThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ <= 0) occ = 1;
    last_smem = smem;
  }
  const int ntiles = (N + kBruteThreads / L - 1) / (kBruteThreads / L);
  const int per_b = (sms * occ + B - 1) / B;
  const dim3 grid(ntiles < per_b ? ntiles : per_b, B);
  knn_lane_topk_kernel<K, L><<<grid, kBruteThreads, smem, s>>>(
      (const float*)q, (const float4*)keys, (float*)out_d, (int*)out_i, N, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_knn_lane_topk(const void* q, const void* keys, void* out_d, void* out_i,
                                   int B, int N, int M, int K, int L, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  if (M < K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define O4D_LT(KK, LL) lane_topk_launch<KK, LL>(q, keys, out_d, out_i, B, N, M, s)
  switch (K * 100 + L) {
    case 1204: return O4D_LT(12, 4);
    case 1208: return O4D_LT(12, 8);
    case 1216: return O4D_LT(12, 16);
    case 1232: return O4D_LT(12, 32);
    case 1404: return O4D_LT(14, 4);
    case 1408: return O4D_LT(14, 8);
    case 1416: return O4D_LT(14, 16);
    case 1432: return O4D_LT(14, 32);
    case 1604: return O4D_LT(16, 4);
    case 1608: return O4D_LT(16, 8);
    case 1616: return O4D_LT(16, 16);
    case 1632: return O4D_LT(16, 32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef O4D_LT
}

extern "C" int probe_knn_warpq(const void* q, const void* keys, void* out_d, void* out_i, int B,
                               int N, int M, int K, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  if (M < K || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_warpq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBruteStage * 16);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const dim3 grid((N + kBruteThreads / 32 - 1) / (kBruteThreads / 32), B);
  knn_warpq_kernel<<<grid, kBruteThreads, brute_stage_bytes(M), (cudaStream_t)stream>>>(
      (const float*)q, (const float4*)keys, (float*)out_d, (int*)out_i, N, M, K);
  return (int)cudaGetLastError();
}
