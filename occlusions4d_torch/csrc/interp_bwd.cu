// Backward of the inverse-distance kNN interpolation for Hopper. Replaces
// occlusions4d_tpu/ops/pallas_attention.py::_interp_bwd_kernel (:661), in its
// use_idx form (neighbours and squared distances from knn_extract).
//
// Function: the gradient of out_n = sum_j w_nj f[ki_nj] / sum_j w_nj with
// respect to the key features only (the weights are functions of positions,
// which carry no gradient):
//   w_nj      = 1 / (sqrt(max(kd_nj, 0)) + eps)
//   dfeats[m] = sum_n sum_{j<k} [ki_nj = m] (w_nj / sum_i w_ni) g_n
//
// What bounds it on the H100: bytes. It reads g (N x E) and k index/distance
// pairs per query and writes M x E; at the gv1 train shapes (3 x 17920
// queries, E 288, k 8, M 531) that is about 64 MB, 19 us at 3.35 TB/s. The
// pull design below reads each g row once per neighbour (k times), mostly
// from L2, in exchange for needing no atomics.
//
// Design, deterministic by construction (no float atomics, the same bits on
// every call), in two stages that share nothing with M's size in shared
// memory (no cap on M):
//  1. An inverse index of the flat (B, N, k) neighbour list: for every key
//     b M + m, its entries e = (b N + n) k + j in ascending order, by the
//     stable counting sort of csrc/inverse_index.cuh.
//  2. Summing: the sorted entries are cut into chunks; a block forms its
//     chunk's normalised weights from kd once per entry, then adds w * g_n
//     per run of one key, threads over the E channels, with the chunk
//     partials of a key cut across chunks added in chunk order
//     (o4d_index::sum). A key held by many queries is spread over many
//     blocks instead of making one block long.
//
// o4d_interp_bwd_bf16 is the bf16 compute mode (the train step's
// fused_decoder_dtype='bf16'; the TPU kernel with compute_dtype bf16, whose
// VJP casts d(feats) to the features' bf16): each entry's row
// (w_nj / sum_i w_ni) g_n is rounded to bf16 before the per-key sum, the
// sum to bf16 after it (stored as f32). The same stages, the same bytes.

#include <cuda_runtime.h>

#include "inverse_index.cuh"

namespace {

// Entry e of the neighbour list: its query's g row, weighted by the
// normalised w_nj / sum_i w_ni.
struct InterpRows {
  static constexpr bool kWeighted = true;
  struct Entry {
    const float* row;
  };
  const float* kd;
  const float* g;
  int E, KS, k;
  float eps;
  __device__ Entry entry(int e, float* wn) const {
    const int bn = e / k, j = e - bn * k;
    const float* d = kd + (size_t)bn * KS;
    float den = 0.f, wj = 0.f;
    for (int i = 0; i < k; ++i) {
      const float w = 1.0f / (sqrtf(fmaxf(d[i], 0.f)) + eps);
      den += w;
      if (i == j) wj = w;
    }
    *wn = wj / den;
    return Entry{g + (size_t)bn * E};
  }
  __device__ float value(const Entry& en, int col) const { return __ldg(en.row + col); }
};

}  // namespace

// Workspace of o4d_interp_bwd: int32 and f32 element counts. The int32
// workspace starts with offsets (B M + 1) and perm (B N k): the inverse index.
extern "C" void o4d_interp_bwd_workspace(int B, int N, int M, int E, int k,
                                         long long* ints, long long* floats) {
  const long long total = (long long)B * N * k, keys = (long long)B * M;
  *ints = o4d_index::index_ints(total, keys);
  *floats = o4d_index::sum_floats(total, E);
}

namespace {

template <bool RND>
int interp_bwd(const void* ki, const void* kd, const void* g, void* iws, void* fws,
               void* dfeats, int B, int N, int M, int E, int KS, int k, float eps,
               void* stream) {
  if (B <= 0 || M <= 0 || E <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || N < 0) return (int)cudaErrorInvalidValue;
  const long long total_ll = (long long)B * N * k;
  if (total_ll >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int total = (int)total_ll, keys = B * M;
  cudaStream_t s = (cudaStream_t)stream;
  const o4d_index::Entries x{(const int*)ki, N, M, KS, k, false};
  cudaError_t err = o4d_index::build(x, total, keys, (int*)iws, s);
  if (err != cudaSuccess) return (int)err;
  const InterpRows rows{(const float*)kd, (const float*)g, E, KS, k, eps};
  return (int)o4d_index::sum<InterpRows, false, RND>(rows, x, (const int*)iws, (float*)fws,
                                                     (float*)dfeats, total, keys, E, s);
}

}  // namespace

// ki (B, N, KS) int32, kd (B, N, KS) f32 (first k columns used); g (B, N, E)
// f32; iws / fws: the workspace (o4d_interp_bwd_workspace); dfeats (B, M, E)
// f32, every element written. B N k must stay below 2^31.
extern "C" int o4d_interp_bwd(const void* ki, const void* kd, const void* g,
                              void* iws, void* fws, void* dfeats, int B, int N,
                              int M, int E, int KS, int k, float eps,
                              void* stream) {
  return interp_bwd<false>(ki, kd, g, iws, fws, dfeats, B, N, M, E, KS, k, eps, stream);
}

// o4d_interp_bwd in the bf16 mode (the same arguments; dfeats holds bf16
// values).
extern "C" int o4d_interp_bwd_bf16(const void* ki, const void* kd, const void* g,
                                   void* iws, void* fws, void* dfeats, int B, int N,
                                   int M, int E, int KS, int k, float eps,
                                   void* stream) {
  return interp_bwd<true>(ki, kd, g, iws, fws, dfeats, B, N, M, E, KS, k, eps, stream);
}
