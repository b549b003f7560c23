// Fused kNN vector attention for Hopper, three entries:
//   o4d_attn   replaces occlusions4d_tpu/ops/pallas_attention.py::_attn_kernel
//              (:78), in its use_idx form (neighbours from the kNN kernel), in
//              both projection modes:
//                premul  - the key set arrives projected,
//                          kv = [feats2 Wk | feats2 Wv];
//                per-row - kv = feats2 (E wide) and Wk/Wv are applied per
//                          gathered row;
//   o4d_attn_g replaces _attn_g_kernel (:934): per-row mode over the rows of
//              the shared gather, g (B, K_ext, N, E + 3) = [feats | pos] per
//              (neighbour, query) (csrc/gather.cu);
//   o4d_sattn  replaces occlusions4d_tpu/ops/pallas_self_attention.py::
//              _fwd_kernel (:56), the encoder's fused gathered self-attention:
//              per-row mode over gf (B, N, K, E), the raw features of each
//              query's K neighbours (n-major), with the coordinate deltas
//              rel (B, N, K, 3) read as given instead of qpos - kpos.
// Only the row loader differs (template parameter MODE), so on the same rows
// the three entries give the same bits.
//
// Function, per query n with neighbours j = ki[n, :k] (f32 throughout):
//   theta_j = W2 relu(W1 (qpos_n - kpos_j) + b1) + b2           (3 -> P -> D)
//   a_j     = (qproj_n - k_j) + theta_j
//   l_j     = (A2 relu(A1 a_j + c1) + c2) / sqrt(D)             (D -> H -> D)
//   out_n   = sum_j softmax_j(l_j) * (v_j + theta_j)   (softmax per channel)
//
// What bounds it on the H100: operations. Per (query, neighbour) row the
// gamma MLP is 2*D*H multiply-adds (692k at D = 416, H = 832), against a few
// KB of inputs; the whole decode is ~2e13 FLOP per dense scene. This first
// kernel runs them on the f32 CUDA cores, far from the tensor-core bound.
// In the encoder (o4d_sattn, D 36 ... 288, H = 2D) the same count is about
// 12 D^2 + 64 D FLOP per row: 98 GFLOP over the four blocks of an n57344
// train step. The narrow widths leave most of a 128-column weight tile idle
// (D 36 uses 36 of 128 columns); that is later work.
// Design: a thread block owns 32 rows = floor(32 / k) queries x k neighbours,
// so the softmax over j closes inside the block. The rows' theta, a and
// logits stay in shared memory; the gamma MLP's hidden layer is produced and
// consumed in chunks of 128 columns (relu(a A1) chunk -> accumulate chunk A2
// into the logits), so the (rows, H) activation never exists whole. Every
// product is a register-tiled loop (256 threads, 4 x 4 outputs each) over
// weight tiles staged through shared memory. wgmma/TMA tiles and bf16 are
// later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kColTile = 128;
constexpr int kKTile = 32;

// C[r][c] (+)= act(sum_kk A[r][kk] W[kk][c] + bias[c]) for r < 32, c < Nc.
// A and C in shared memory, W (Kd x Nc, row stride ldw) in global memory.
template <bool RELU, bool ACCUM>
__device__ void gemm_rows(const float* A, int lda, const float* __restrict__ W,
                          int ldw, const float* __restrict__ bias, int Kd,
                          int Nc, float* C, int ldc, float* ws) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int cb = 0; cb < Nc; cb += kColTile) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][t] = 0.f;
    for (int k0 = 0; k0 < Kd; k0 += kKTile) {
      const int kc = min(kKTile, Kd - k0);
      __syncthreads();
      for (int idx = tid; idx < kKTile * kColTile; idx += kThreads) {
        const int kk = idx / kColTile, c = idx % kColTile;
        ws[idx] = (kk < kc && cb + c < Nc) ? W[(size_t)(k0 + kk) * ldw + cb + c]
                                           : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * lda + k0 + kk];
#pragma unroll
        for (int t = 0; t < 4; ++t) w[t] = ws[kk * kColTile + tx + 32 * t];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(a[i], w[t], acc[i][t]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = cb + tx + 32 * t;
        if (c < Nc) {
          float v = acc[i][t];
          if (bias != nullptr) v += bias[c];
          if (RELU) v = fmaxf(v, 0.f);
          float* dst = C + (ty * 4 + i) * ldc + c;
          if (ACCUM)
            *dst += v;
          else
            *dst = v;
        }
      }
    }
  }
  __syncthreads();
}

struct AttnArgs {
  const float* qpos;   // (B, N, 3)
  const float* qproj;  // (B, N, D)
  const int* ki;       // (B, N, KS)
  const float* kpos;   // (B, M, 3)
  const float* kv;     // premul (B, M, 2D) [k | v]; per-row (B, M, E)
  const float* g;      // gathered only: (B, KE, N, E + 3)
  const float* gf;     // self only: (B, N, k, E)
  const float* rel;    // self only: (B, N, k, 3)
  const float* wk;     // (E, D), per-row only
  const float* wv;     // (E, D), per-row only
  const float* wp1;    // (3, P)
  const float* bp1;    // (P)
  const float* wp2;    // (P, D)
  const float* bp2;    // (D)
  const float* wa1;    // (D, H)
  const float* ba1;    // (H)
  const float* wa2;    // (H, D)
  const float* ba2;    // (D)
  float* out;          // (B, N, D)
  int N, M, D, E, H, P, KS, KE, k, premul;
  float inv_sqrt_d;
};

size_t smem_floats(int D, int E, int P) {
  const int LD = D > E ? D : E;
  return (size_t)kRows * D * 2 + (size_t)kRows * LD + (size_t)kRows * kColTile +
         (size_t)kKTile * kColTile + (size_t)kRows * P + (size_t)kRows * 3;
}

// Row loaders: neighbour indices into kv, the shared gather's rows, or the
// self-attention's n-major gathered features.
enum { kIndex = 0, kGathered = 1, kSelf = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads) attn_kernel(AttnArgs p) {
  extern __shared__ float sm[];
  const int D = p.D, E = p.E, H = p.H, P = p.P, k = p.k;
  const int LD = D > E ? D : E;
  float* PE = sm;                        // theta, then v + theta
  float* A = PE + kRows * D;             // (q - k) + theta
  float* LG = A + kRows * D;             // raw features (per-row), then logits
  float* HC = LG + kRows * LD;           // gamma hidden-layer chunk
  float* WS = HC + kRows * kColTile;     // staged weight tile
  float* PH = WS + kKTile * kColTile;    // theta hidden layer
  float* REL = PH + kRows * P;           // qpos - kpos
  __shared__ int rq[kRows], ridx[kRows];
  __shared__ const float* rrow[kRows];  // gathered / self: the row's features.

  const int b = blockIdx.y, tid = threadIdx.x;
  const int tq_per = kRows / k;
  const int n0 = blockIdx.x * tq_per;
  if (tid < kRows) {
    const int tq = tid / k, j = tid % k, n = n0 + tq;
    const bool valid = tq < tq_per && n < p.N;
    rq[tid] = valid ? n : -1;
    if (MODE == kSelf) {
      const size_t row = ((size_t)b * p.N + (valid ? n : 0)) * k + j;
      rrow[tid] = p.gf + row * E;
      for (int c = 0; c < 3; ++c) REL[tid * 3 + c] = valid ? p.rel[row * 3 + c] : 0.f;
    } else {
      const float* kp;
      if (MODE == kGathered) {
        const float* row =
            p.g + (((size_t)b * p.KE + j) * p.N + (valid ? n : 0)) * (E + 3);
        rrow[tid] = row;
        kp = row + E;
      } else {
        const int idx = valid ? p.ki[((size_t)b * p.N + n) * p.KS + j] : 0;
        ridx[tid] = idx;
        kp = p.kpos + ((size_t)b * p.M + idx) * 3;
      }
      for (int c = 0; c < 3; ++c)
        REL[tid * 3 + c] =
            valid ? p.qpos[((size_t)b * p.N + n) * 3 + c] - kp[c] : 0.f;
    }
  }
  __syncthreads();

  gemm_rows<true, false>(REL, 3, p.wp1, P, p.bp1, 3, P, PH, P, WS);
  gemm_rows<false, false>(PH, P, p.wp2, D, p.bp2, P, D, PE, D, WS);

  const float* kvb = MODE == kIndex ? p.kv + (size_t)b * p.M * (p.premul ? 2 * D : E)
                                    : nullptr;
  if (MODE == kIndex && p.premul) {
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      A[idx] = rq[r] >= 0 ? kvb[(size_t)ridx[r] * 2 * D + c] : 0.f;
    }
  } else {
    for (int idx = tid; idx < kRows * E; idx += kThreads) {
      const int r = idx / E, c = idx % E;
      LG[r * LD + c] = rq[r] < 0         ? 0.f
                       : MODE != kIndex ? rrow[r][c]
                                        : kvb[(size_t)ridx[r] * E + c];
    }
    gemm_rows<false, false>(LG, LD, p.wk, D, nullptr, E, D, A, D, WS);
  }
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const float q = rq[r] >= 0 ? p.qproj[((size_t)b * p.N + rq[r]) * D + c] : 0.f;
    A[idx] = (q - A[idx]) + PE[idx];
    if (p.premul)  // same thread, same idx: PE[idx] was read just above.
      PE[idx] = (rq[r] >= 0 ? kvb[(size_t)ridx[r] * 2 * D + D + c] : 0.f) + PE[idx];
  }
  if (!p.premul)  // PE += F Wv (its first barrier orders the loop above).
    gemm_rows<false, true>(LG, LD, p.wv, D, nullptr, E, D, PE, D, WS);
  __syncthreads();
  for (int idx = tid; idx < kRows * D; idx += kThreads) LG[idx] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kColTile) {
    const int hc = min(kColTile, H - h0);
    gemm_rows<true, false>(A, D, p.wa1 + h0, H, p.ba1 + h0, D, hc, HC, kColTile,
                           WS);
    gemm_rows<false, true>(HC, kColTile, p.wa2 + (size_t)h0 * D, D, nullptr, hc,
                           D, LG, D, WS);
  }

  for (int idx = tid; idx < tq_per * D; idx += kThreads) {
    const int tq = idx / D, c = idx % D, r0 = tq * k;
    if (rq[r0] < 0) continue;
    const float bias = p.ba2[c];
    float mx = -CUDART_INF_F;
    for (int j = 0; j < k; ++j)
      mx = fmaxf(mx, (LG[(r0 + j) * D + c] + bias) * p.inv_sqrt_d);
    float den = 0.f, acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float e = expf((LG[(r0 + j) * D + c] + bias) * p.inv_sqrt_d - mx);
      den += e;
      acc += e * PE[(r0 + j) * D + c];
    }
    p.out[((size_t)b * p.N + rq[r0]) * D + c] = acc / den;
  }
}

template <int MODE>
int launch(AttnArgs& a, int B, void* stream) {
  a.inv_sqrt_d = 1.0f / sqrtf((float)a.D);
  const size_t smem = smem_floats(a.D, a.E, a.P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tq_per = kRows / a.k;
  dim3 grid((a.N + tq_per - 1) / tq_per, B);
  attn_kernel<MODE><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long o4d_attn_smem_bytes(int D, int E, int P) {
  return (long long)(smem_floats(D, E, P) * sizeof(float));
}

extern "C" int o4d_attn(const void* qpos, const void* qproj, const void* ki,
                        const void* kpos, const void* kv, const void* wk,
                        const void* wv, const void* wp1, const void* bp1,
                        const void* wp2, const void* bp2, const void* wa1,
                        const void* ba1, const void* wa2, const void* ba2,
                        void* out, int B, int N, int M, int D, int E, int H,
                        int P, int KS, int k, int premul, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > kRows || k > KS) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qpos = (const float*)qpos;
  a.qproj = (const float*)qproj;
  a.ki = (const int*)ki;
  a.kpos = (const float*)kpos;
  a.kv = (const float*)kv;
  a.wk = (const float*)wk;
  a.wv = (const float*)wv;
  a.wp1 = (const float*)wp1;
  a.bp1 = (const float*)bp1;
  a.wp2 = (const float*)wp2;
  a.bp2 = (const float*)bp2;
  a.wa1 = (const float*)wa1;
  a.ba1 = (const float*)ba1;
  a.wa2 = (const float*)wa2;
  a.ba2 = (const float*)ba2;
  a.out = (float*)out;
  a.N = N;
  a.M = M;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.KS = KS;
  a.k = k;
  a.premul = premul;
  return launch<kIndex>(a, B, stream);
}

// o4d_attn over the shared gather's rows: g (B, KE, N, E + 3) replaces ki,
// kpos and kv; per-row mode only.
extern "C" int o4d_attn_g(const void* qpos, const void* qproj, const void* g,
                          const void* wk, const void* wv, const void* wp1,
                          const void* bp1, const void* wp2, const void* bp2,
                          const void* wa1, const void* ba1, const void* wa2,
                          const void* ba2, void* out, int B, int N, int D,
                          int E, int H, int P, int KE, int k, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > kRows || k > KE) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qpos = (const float*)qpos;
  a.qproj = (const float*)qproj;
  a.g = (const float*)g;
  a.wk = (const float*)wk;
  a.wv = (const float*)wv;
  a.wp1 = (const float*)wp1;
  a.bp1 = (const float*)bp1;
  a.wp2 = (const float*)wp2;
  a.bp2 = (const float*)bp2;
  a.wa1 = (const float*)wa1;
  a.ba1 = (const float*)ba1;
  a.wa2 = (const float*)wa2;
  a.ba2 = (const float*)ba2;
  a.out = (float*)out;
  a.N = N;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.KE = KE;
  a.k = k;
  a.premul = 0;
  return launch<kGathered>(a, B, stream);
}

// The encoder's fused self-attention: q (B, N, D) projected queries, gf
// (B, N, k, E) raw neighbour features (row n k + j is query n's j-th
// neighbour), rel (B, N, k, 3) coordinate deltas; out (B, N, D).
extern "C" int o4d_sattn(const void* q, const void* gf, const void* rel, const void* wk,
                         const void* wv, const void* wp1, const void* bp1,
                         const void* wp2, const void* bp2, const void* wa1,
                         const void* ba1, const void* wa2, const void* ba2, void* out,
                         int B, int N, int D, int E, int H, int P, int k, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > kRows) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qproj = (const float*)q;
  a.gf = (const float*)gf;
  a.rel = (const float*)rel;
  a.wk = (const float*)wk;
  a.wv = (const float*)wv;
  a.wp1 = (const float*)wp1;
  a.bp1 = (const float*)bp1;
  a.wp2 = (const float*)wp2;
  a.bp2 = (const float*)bp2;
  a.wa1 = (const float*)wa1;
  a.ba1 = (const float*)ba1;
  a.wa2 = (const float*)wa2;
  a.ba2 = (const float*)ba2;
  a.out = (float*)out;
  a.N = N;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.k = k;
  a.premul = 0;
  return launch<kSelf>(a, B, stream);
}
