// Inverse-distance kNN feature interpolation for Hopper, two entries:
//   o4d_interp   replaces occlusions4d_tpu/ops/pallas_attention.py::
//                _interp_kernel (:554), in its use_idx form: the neighbours
//                come from the kNN kernel (knn_extract) and the rows from the
//                key features;
//   o4d_interp_g replaces _interp_g_kernel (:1254): the rows come from the
//                shared gather's g (B, K_ext, N, E + 3) (csrc/gather.cu),
//                first E columns;
//   o4d_interp_g_bwd replaces _interp_g_bwd_kernel (:1294): the cotangent of
//                those rows, dg (B, K_ext, N, E + 3).
//
// Function, per query n over its first k neighbours j (ascending):
//   w_j   = 1 / (sqrt(max(kd_j, 0)) + eps)          (kd: squared distance)
//   out_n = (sum_j w_j f_j) / (sum_j w_j)
// Both entries run the same arithmetic on the same rows, so they give the
// same bits. The backward, with go = d(out):
//   dg[b, j, n, :E] = (w_j / sum_i w_i) go_n   for j < k;  0 in the position
//   columns and in the rows k <= j < K_ext
// (the scatter of csrc/gather.cu then adds dg to the key rows).
//
// What bounds it on the H100: bytes. Each query reads k index/distance pairs
// and k feature rows and writes one E-wide row. From the small key set (L2)
// the output write dominates (37.7 MB per 32768 x 288 chunk); from g the k
// rows read do (302 MB per cv1 chunk at k 8). Design: one thread block per
// query; the k weights and row addresses are formed once in shared memory,
// then the threads stride over the E channels so that both the row reads and
// the output write are coalesced. The backward is a pure write pass, bound by
// its 841 MB of dg at one cv1 train frame (0.27 ms): one block per query forms
// the k normalised weights once in shared memory and writes all K_ext rows of
// the query, zeros included, its threads striding each row's E + 3 floats.
// (Two variants that wrote 8 queries' rows, or whole (b, j) planes, as
// contiguous runs measured no faster on the H100; see PERF.md.)
//
// The bf16 compute mode, o4d_interp_bf16 and o4d_interp_g_bf16 (the TPU
// kernels' compute_dtype=bfloat16, precision='fast'): the features are read
// as bf16 (the TPU wrapper's cast of the features before its one-hot
// gather): each value of the f32 features (or of g) is rounded as it is
// loaded. A bf16 copy made once per call, which halves the L2 reads of the
// k rows per query, measured no faster on the H100 (PERF.md). The weights,
// their sum and every output stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// RND: the bf16 mode (every feature value rounded to bf16 as it is read).
template <bool GATHERED, bool RND>
__global__ void interp_kernel(const int* __restrict__ ki,
                              const float* __restrict__ kd,
                              const float* __restrict__ src,
                              float* __restrict__ out, int N, int M, int E,
                              int KS, int KE, int k, float eps) {
  __shared__ float w[32];
  __shared__ const float* rowp[32];
  __shared__ float den;
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t row = (size_t)b * N + n;
  if (threadIdx.x < k) {
    const int j = threadIdx.x;
    w[j] = 1.0f / (sqrtf(fmaxf(kd[row * KS + j], 0.f)) + eps);
    // src: key features (B, M, E), or g (B, KE, N, E + 3).
    rowp[j] = GATHERED ? src + (((size_t)b * KE + j) * N + n) * (E + 3)
                       : src + ((size_t)b * M + ki[row * KS + j]) * E;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s += w[j];
    den = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float f = rowp[j][e];
      acc += w[j] * (RND ? __bfloat162float(__float2bfloat16_rn(f)) : f);
    }
    out[row * E + e] = acc / den;
  }
}

__global__ void interp_g_bwd_kernel(const float* __restrict__ kd,
                                    const float* __restrict__ go,
                                    float* __restrict__ dg, int N, int E, int KS,
                                    int KE, int k, float eps) {
  __shared__ float wn[32];
  const int n = blockIdx.x, b = blockIdx.y, C = E + 3;
  const size_t row = (size_t)b * N + n;
  if (threadIdx.x == 0) {
    float w[32], den = 0.f;
    for (int j = 0; j < k; ++j) {
      w[j] = 1.0f / (sqrtf(fmaxf(kd[row * KS + j], 0.f)) + eps);
      den += w[j];
    }
    for (int j = 0; j < k; ++j) wn[j] = w[j] / den;
  }
  __syncthreads();
  const float* g = go + row * E;
  for (int j = 0; j < KE; ++j) {
    float* out = dg + (((size_t)b * KE + j) * N + n) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      out[c] = (j < k && c < E) ? wn[j] * g[c] : 0.f;
  }
}

template <bool RND>
int interp_index(const void* ki, const void* kd, const void* feats, void* out, int B, int N,
                 int M, int E, int KS, int k, float eps, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS) return (int)cudaErrorInvalidValue;
  dim3 grid(N, B);
  interp_kernel<false, RND><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ki, (const float*)kd, (const float*)feats, (float*)out, N, M,
      E, KS, 0, k, eps);
  return (int)cudaGetLastError();
}

template <bool RND>
int interp_gathered(const void* kd, const void* g, void* out, int B, int N, int E, int KS,
                    int KE, int k, float eps, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || k > KE) return (int)cudaErrorInvalidValue;
  dim3 grid(N, B);
  interp_kernel<true, RND><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, (const float*)kd, (const float*)g, (float*)out, N, 0, E, KS, KE,
      k, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// ki (B, N, KS) int32, kd (B, N, KS) f32 (first k columns used);
// feats (B, M, E) f32; out (B, N, E) f32.
extern "C" int o4d_interp(const void* ki, const void* kd, const void* feats,
                          void* out, int B, int N, int M, int E, int KS, int k,
                          float eps, void* stream) {
  return interp_index<false>(ki, kd, feats, out, B, N, M, E, KS, k, eps, stream);
}

// o4d_interp in the bf16 mode (the same arguments; each value of feats
// rounded to bf16 as it is read).
extern "C" int o4d_interp_bf16(const void* ki, const void* kd, const void* feats,
                               void* out, int B, int N, int M, int E, int KS, int k,
                               float eps, void* stream) {
  return interp_index<true>(ki, kd, feats, out, B, N, M, E, KS, k, eps, stream);
}

// kd (B, N, KS) f32 (first k columns used); g (B, KE, N, E + 3) f32 (first k
// rows used); out (B, N, E) f32.
extern "C" int o4d_interp_g(const void* kd, const void* g, void* out, int B,
                            int N, int E, int KS, int KE, int k, float eps,
                            void* stream) {
  return interp_gathered<false>(kd, g, out, B, N, E, KS, KE, k, eps, stream);
}

// o4d_interp_g in the bf16 mode (the same arguments).
extern "C" int o4d_interp_g_bf16(const void* kd, const void* g, void* out, int B,
                                 int N, int E, int KS, int KE, int k, float eps,
                                 void* stream) {
  return interp_gathered<true>(kd, g, out, B, N, E, KS, KE, k, eps, stream);
}

// kd (B, N, KS) f32 (first k columns used); go (B, N, E) f32;
// dg (B, KE, N, E + 3) f32, every element written.
extern "C" int o4d_interp_g_bwd(const void* kd, const void* go, void* dg, int B,
                                int N, int E, int KS, int KE, int k, float eps,
                                void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || k > KE) return (int)cudaErrorInvalidValue;
  dim3 grid(N, B);
  interp_g_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)kd, (const float*)go, (float*)dg, N, E, KS, KE, k, eps);
  return (int)cudaGetLastError();
}
