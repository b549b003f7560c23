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
// rows read do (302 MB per cv1 chunk at k 8).
// o4d_interp (interp_index_kernel): a first version ran one 128-thread block
// per query (two barriers, a serial denominator, 4-byte loads and stores
// over E, no row shared between queries; 0.058-0.072 ms at the gv1 chunk,
// the output written at about 0.6 TB/s). Now a 256-thread block takes
// kIdxQ = 8 consecutive queries of one example (the engine streams them in
// grid order, so they share most of their k rows, which then come from L1,
// not L2): one warp per query forms its k weights in lanes j < k, the
// denominator by shuffles in j order and each row's offset, one barrier for
// the block, then the block's threads stride over the (query, 4-column
// group) items: the k rows read 16 bytes at a time through the read-only
// path (L1), acc += w_j f_j in j order (fused multiply-adds), acc / den,
// written with 16-byte streaming stores. When E is not a multiple of 4 the
// rows are not 16-byte aligned and every column is loaded and stored on its
// own. The same arithmetic in the same order as o4d_interp_g's, so the two
// routes give the same bits. Measured on an H100 (PERF.md): 8 queries a
// block beat 2, 4, 16 and 32; row offsets formed once per query (not a
// 64-bit row address per use) and the bf16 mode's roundings two values a
// conversion (__floats2bfloat162_rn) took the gv1 chunk from 0.040 / 0.048
// ms (f32 / bf16, 32 queries a block) to 0.032 / 0.037.
// o4d_interp_g (interp_g_kernel) keeps one block per query: its rows, E + 3
// floats apart, are not 16-byte aligned either.
//
// The backward is a pure write pass, bound by its 841 MB of dg at one cv1
// train frame (0.27 ms at 3.35 TB/s; chip_smoke.py times the card's own write
// ceiling for this buffer beside it: dg.zero_() and o4d_fill16, a bare
// 16-byte store loop). Design (a block per query, whose thread 0 formed
// the weights behind a barrier before the block wrote 14 rows of 1164 bytes
// in planes 20 MB apart with 4-byte stores, 3 of 4 rows off a 16-byte
// boundary, wrote at 1.1 TB/s): a block of 1024 threads takes kBwdQ = 32
// consecutive queries of one example, whose rows in each plane (b, j) form
// one contiguous run of 32 (E + 3) floats. One warp per query forms its k
// weights, one lane per neighbour, and the denominator by shuffles in j
// order (the arithmetic of the first port and of the TPU kernel:
// 1 / (sqrt(max(kd, 0)) + eps), summed from zero in j order, w_j / den
// times go, so the same bits); then the block writes the 14 planes' runs,
// zero planes j >= k included, as evict-first 16-byte stores (st.global.cs:
// the buffer is 17 times the L2; plain stores measured 13% slower), scalar
// stores only at a run's unaligned head and ragged tail; go comes from L1
// after the first plane. Measured at the cv1 frame
// (tools/profile_interp_g_bwd.py, PERF.md): 4, 8, 16 and 32 queries a block
// took 0.42, 0.39, 0.37 and 0.36 ms, 64 0.38; a block per (query group,
// plane), which rereads go from L2 for each plane, 0.43; staging each run
// through shared memory 0.47.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIdxQ = 8;  // queries per interp_index_kernel block
constexpr int kIdxThreads = 256;

__device__ __forceinline__ float feature(float f, bool rnd) {
  return rnd ? __bfloat162float(__float2bfloat16_rn(f)) : f;
}

// o4d_interp_g's body: one block per query. RND: the bf16 mode (every
// feature value rounded to bf16 as it is read).
template <bool RND>
__global__ void interp_g_kernel(const float* __restrict__ kd, const float* __restrict__ g,
                                float* __restrict__ out, int N, int E, int KS, int KE, int k,
                                float eps) {
  __shared__ float w[32];
  __shared__ const float* rowp[32];
  __shared__ float den;
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t row = (size_t)b * N + n;
  if (threadIdx.x < k) {
    const int j = threadIdx.x;
    w[j] = 1.0f / (sqrtf(fmaxf(kd[row * KS + j], 0.f)) + eps);
    rowp[j] = g + (((size_t)b * KE + j) * N + n) * (E + 3);  // g (B, KE, N, E + 3)
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
    for (int j = 0; j < k; ++j) acc = __fmaf_rn(w[j], feature(rowp[j][e], RND), acc);
    out[row * E + e] = acc / den;
  }
}

// o4d_interp's body (design notes at the top of the file); VEC: E % 4 == 0
// and 16-byte aligned feats and out.
template <bool VEC, bool RND>
__global__ void __launch_bounds__(kIdxThreads)
    interp_index_kernel(const int* __restrict__ ki, const float* __restrict__ kd,
                        const float* __restrict__ feats, float* __restrict__ out, int N, int M,
                        int E, int KS, int k, float eps) {
  __shared__ float w[kIdxQ][33];
  __shared__ int rows[kIdxQ][33];
  __shared__ float den[kIdxQ];
  const int b = blockIdx.y, n0 = blockIdx.x * kIdxQ, nq = min(kIdxQ, N - n0);
  const int lane = threadIdx.x & 31;
  for (int qi = threadIdx.x >> 5; qi < nq; qi += kIdxThreads / 32) {
    const size_t row = (size_t)b * N + n0 + qi;
    const float wj = lane < k ? 1.0f / (sqrtf(fmaxf(kd[row * KS + lane], 0.f)) + eps) : 0.f;
    float s = 0.f;
    for (int j = 0; j < k; ++j) s += __shfl_sync(0xffffffffu, wj, j);
    if (lane < k) {  // the row's offset in the example's features, in float4s if VEC
      w[qi][lane] = wj;
      rows[qi][lane] = ki[row * KS + lane] * (VEC ? E >> 2 : E);
    }
    if (lane == 0) den[qi] = s;
  }
  __syncthreads();
  const float* fb = feats + (size_t)b * M * E;
  float* ob = out + ((size_t)b * N + n0) * E;
  if (VEC) {
    const int E4 = E >> 2;
    const float4* fb4 = reinterpret_cast<const float4*>(fb);
    for (int it = threadIdx.x; it < nq * E4; it += kIdxThreads) {
      const int qi = it / E4, c = it - qi * E4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < k; ++j) {
        float4 f = __ldg(fb4 + (rows[qi][j] + c));
        if (RND) {  // two values a conversion
          const __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
          f = make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
        }
        const float wj = w[qi][j];
        acc.x = __fmaf_rn(wj, f.x, acc.x);
        acc.y = __fmaf_rn(wj, f.y, acc.y);
        acc.z = __fmaf_rn(wj, f.z, acc.z);
        acc.w = __fmaf_rn(wj, f.w, acc.w);
      }
      const float dn = den[qi];
      __stcs(reinterpret_cast<float4*>(ob + (size_t)qi * E) + c,
             make_float4(acc.x / dn, acc.y / dn, acc.z / dn, acc.w / dn));
    }
  } else {
    for (int it = threadIdx.x; it < nq * E; it += kIdxThreads) {
      const int qi = it / E, e = it - qi * E;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < k; ++j)
        acc = __fmaf_rn(w[qi][j], feature(__ldg(fb + (rows[qi][j] + e)), RND), acc);
      __stcs(ob + (size_t)qi * E + e, acc / den[qi]);
    }
  }
}

constexpr int kBwdQ = 32;  // queries per interp_g_bwd block: one warp each
constexpr int kBwdThreads = 32 * kBwdQ;

__global__ void __launch_bounds__(kBwdThreads) interp_g_bwd_kernel(
    const float* __restrict__ kd, const float* __restrict__ go, float* __restrict__ dg, int N,
    int E, int KS, int KE, int k, float eps) {
  __shared__ float wn[kBwdQ][32];  // wn[q][j] = w_j / den of query n0 + q
  const int b = blockIdx.y, n0 = blockIdx.x * kBwdQ, nq = min(kBwdQ, N - n0), C = E + 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nq) {
    const size_t row = (size_t)b * N + n0 + warp;
    const float w = lane < k ? 1.0f / (sqrtf(fmaxf(kd[row * KS + lane], 0.f)) + eps) : 0.f;
    float den = 0.f;
    for (int j = 0; j < k; ++j) den += __shfl_sync(0xffffffffu, w, j);
    if (lane < k) wn[warp][lane] = w / den;
  }
  __syncthreads();
  const float* g = go + ((size_t)b * N + n0) * E;  // the block's go rows (nq, E).
  const int L = nq * C;                              // floats of one plane's run.
  for (int j = 0; j < KE; ++j) {
    float* run = dg + (((size_t)b * KE + j) * N + n0) * C;
    const int head = min(L, (int)((4 - (((uintptr_t)run >> 2) & 3)) & 3));
    const int body = (L - head) >> 2, tail = head + 4 * body;
    float4* run4 = reinterpret_cast<float4*>(run + head);  // 16-byte aligned.
    if (j >= k) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = threadIdx.x; i < body; i += kBwdThreads) __stcs(run4 + i, z);
      if (threadIdx.x < head) __stcs(run + threadIdx.x, 0.f);
      if (threadIdx.x < L - tail) __stcs(run + tail + threadIdx.x, 0.f);
      continue;
    }
    // The value at query q, column c of the run.
    auto value = [&](int q, int c) {
      return c < E ? wn[q][j] * __ldg(g + (size_t)q * E + c) : 0.f;
    };
    for (int i = threadIdx.x; i < body; i += kBwdThreads) {
      const int pos = head + 4 * i;
      int q = pos / C, c = pos - q * C;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = value(q, c);
        if (++c == C) c = 0, ++q;
      }
      __stcs(run4 + i, make_float4(v[0], v[1], v[2], v[3]));
    }
    if (threadIdx.x < head) __stcs(run + threadIdx.x, value(0, threadIdx.x));
    if (threadIdx.x < L - tail) {
      const int pos = tail + threadIdx.x, q = pos / C;
      __stcs(run + pos, value(q, pos - q * C));
    }
  }
}

// A bare write pass: out[0 .. n) = v, 16-byte stores (evict-first with CS)
// over the aligned body, 4-byte stores at the ends. The card's write
// ceiling for a buffer of o4d_interp_g_bwd's size (chip_smoke.py); no model
// path runs it.
template <bool CS>
__global__ void fill16_kernel(float* __restrict__ out, long long n, float v) {
  const long long a = (4 - (((uintptr_t)out >> 2) & 3)) & 3;
  const int head = (int)(a < n ? a : n);
  const long long n4 = (n - head) >> 2;
  float4* out4 = reinterpret_cast<float4*>(out + head);
  const float4 x = make_float4(v, v, v, v);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += step) {
    if (CS)
      __stcs(out4 + i, x);
    else
      out4[i] = x;
  }
  if (blockIdx.x == 0 && threadIdx.x < head) out[threadIdx.x] = v;
  const long long tail = head + 4 * n4;
  if (blockIdx.x == 0 && threadIdx.x < n - tail) out[tail + threadIdx.x] = v;
}

template <bool RND>
int interp_index(const void* ki, const void* kd, const void* feats, void* out, int B, int N,
                 int M, int E, int KS, int k, float eps, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || (long long)M * E >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kIdxQ - 1) / kIdxQ, B);
  const bool vec = E % 4 == 0 && (((uintptr_t)feats | (uintptr_t)out) & 15) == 0;
  (vec ? interp_index_kernel<true, RND> : interp_index_kernel<false, RND>)
      <<<grid, kIdxThreads, 0, (cudaStream_t)stream>>>((const int*)ki, (const float*)kd,
                                                       (const float*)feats, (float*)out, N, M,
                                                       E, KS, k, eps);
  return (int)cudaGetLastError();
}

template <bool RND>
int interp_gathered(const void* kd, const void* g, void* out, int B, int N, int E, int KS,
                    int KE, int k, float eps, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || k > KE) return (int)cudaErrorInvalidValue;
  dim3 grid(N, B);
  interp_g_kernel<RND><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)kd, (const float*)g, (float*)out, N, E, KS, KE, k, eps);
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
  dim3 grid((N + kBwdQ - 1) / kBwdQ, B);
  interp_g_bwd_kernel<<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)kd, (const float*)go, (float*)dg, N, E, KS, KE, k, eps);
  return (int)cudaGetLastError();
}

// out (n floats, 4-byte aligned) = v; evict_first: st.global.cs stores.
extern "C" int o4d_fill16(void* out, long long n, float v, int evict_first, void* stream) {
  if (n <= 0) return 0;
  const long long n4 = n / 4 + 1;
  const unsigned blocks = (unsigned)(n4 < 132LL * 64 * 256 ? (n4 + 255) / 256 : 132LL * 64);
  if (evict_first)
    fill16_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, n, v);
  else
    fill16_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, n, v);
  return (int)cudaGetLastError();
}
