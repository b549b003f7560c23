// Backward of the fused kNN vector attention for Hopper, five entries on one
// body:
//   o4d_attn_bwd   replaces occlusions4d_tpu/ops/pallas_attention.py::
//                  _attn_bwd_kernel (:246), in its use_idx form, in both
//                  projection modes of the forward (csrc/attn.cu):
//     premul  - kv = [feats2 Wk | feats2 Wv] (B, M, 2D); d(kv) holds [dk | dv];
//     per-row - kv = feats2 (B, M, E); d(kv) = d(feats2), plus dWk and dWv;
//   o4d_attn_g_bwd replaces _attn_g_bwd_kernel (:1030): per-row mode over the
//                  shared gather's rows g (B, K_ext, N, E + 3) (csrc/gather.cu):
//                  the rows' gradients dv Wv^T - dhpre Wk^T are WRITTEN to
//                  dg[b, j, n, :E], its position columns and rows j >= k
//                  zeroed; the scatter of csrc/gather.cu takes dg to the keys;
//   o4d_sattn_bwd  replaces occlusions4d_tpu/ops/pallas_self_attention.py::
//                  _bwd_kernel (:132), the encoder's fused self-attention: the
//                  rows come from gf (B, N, k, E) and rel (B, N, k, 3), their
//                  gradients go to dgf (B, N, k, E);
//   o4d_attn_bwd_bf16, o4d_attn_g_bwd_bf16: the first two in the bf16
//                  compute mode (the train step's fused_decoder_dtype='bf16';
//                  the TPU kernels with compute_dtype bf16), below;
//   o4d_sattn_bwd_bf16: the third in the bf16 compute mode (the encoder's
//                  fused self-attention under mixed_precision).
// The MODE template parameter picks only how a chunk's rows are found
// (load_rows_kernel) and where their gradients go; BF16 the arithmetic.
//
// Function: with the forward of csrc/attn.cu recomputed per row
// (theta = W2 relu(W1 rel + b1) + b2, hpre = q - k + theta,
// h1 = A1 hpre + c1, logits = (A2 relu(h1) + c2) / sqrt(D), a = softmax_K,
// out = sum_K a (v + theta)) and g = d(out):
//   dvpe  = a g;  s = sum_K a g (v + theta);  dlog = a (g (v + theta) - s) / sqrt(D)
//   dh1 = [h1 > 0] dlog A2^T;  dhpre = dh1 A1^T;  dq = sum_K dhpre
//   dk = -dhpre, dv = dvpe;  dtheta = dhpre + dvpe
//   dtheta_h = [theta_h > 0] dtheta W2^T
//   dA2 = sum relu(h1)^T dlog;  dA1 = sum hpre^T dh1;  dW2 = sum relu(theta_h)^T dtheta
//   dW1 = sum rel^T dtheta_h;  dc2, dc1, db2, db1 = column sums of dlog, dh1,
//   dtheta, dtheta_h;  per-row: dWk = -sum F^T dhpre, dWv = sum F^T dvpe,
//   d(feats2) rows = dvpe Wv^T - dhpre Wk^T.
// Positions carry no gradient.
//
// What bounds it on the H100: operations. Per (query, neighbour) row the
// recomputed gamma MLP is 2 D H multiply-adds and its backward 4 D H more:
// about 2.1 M per row at D 416, H 832, 4.1 TFLOP for one cv1 train frame
// (3 x 17203 queries, K 14, R = 722526 rows). f32 accuracy on the tensor
// cores takes three TF32 products per product (3xTF32: a = a_big + a_small,
// each a TF32 value; a b ~ a_small b_big + a_big b_small + a_big b_big,
// summed in f32), the counterpart of the TPU kernel's f32 products at
// Precision.HIGHEST: 3 x 4.1 TFLOP / 495 TFLOP/s = 25 ms at the cv1 frame.
//
// Design (the previous kernel ran every product on the f32 CUDA cores inside
// one 32-row tile per block, restaged every weight from L2 for each 32 rows
// and added rank-32 updates of every weight gradient into a private global
// slot per block after each tile: about 7.5 MB of read-modify-writes per
// tile, 150-190 GB per cv1 launch, at one block of 8 warps per SM):
//   * phases: the rows are processed in chunks of whole queries (QC queries
//     of one example, at most about 1 GiB of per-row operands); per chunk a
//     row phase recomputes the forward and runs the softmax backward, every
//     per-row operand (rel, F, relu(theta_h), theta / dtheta, hpre, relu(h1),
//     dlog, dvpe, dh1, dhpre, dtheta_h) going through device memory;
//   * every product is one GEMM launch over 128 x 128 output tiles with the
//     same epilogue (the bias, the ReLU, the [x > 0] mask, the sign, the
//     destination row map of dg's (j, n) layout; in the row phase a weight
//     tile is staged once per 128 rows). The f32 tensor-core products whose
//     output is at least 64 wide on both sides run on the wgmma engine
//     (gemm3_wgmma_kernel, csrc/attn_common.cuh): a persistent block per SM;
//     a producer warpgroup stages each 32-deep k-step's raw f32 tiles by TMA
//     (cp.async where an operand's pointer or row stride is not a 16-byte
//     multiple, or a K slice not whole k-steps) and splits the B tile once
//     into TF32 big and small planes (K-major, 128-byte swizzle: the layout
//     tf32 wgmma reads, transposing an MN-major B in the same pass); two
//     consumer warpgroups split their A fragments in registers and issue
//     three wgmma m64n128k8 products per 8-deep step (small a big b, big a
//     small b, big a big b) into a fragment that starts from zero every 64
//     k and is then added to the f32 sum in registers (the promotion: the
//     tensor core's truncating accumulation never carries a row slice's
//     long sum). Bounded by the tensor cores' TF32 rate and the shared
//     memory's bandwidth (wgmma's B reads, the split, the TMA's writes).
//     The narrow products (dW1's 3 rows, dW2's and dtheta_h's P = 32) keep
//     gemm3_kernel's mma.sync m16n8k8 in 3xTF32 (each warp splitting its
//     fragments, each 8-deep step's three products added to the f32 sum),
//     2 blocks (16 warps) per SM; the shapes alone choose;
//   * the weight gradients are long-K products over the chunk's rows: each
//     (128 x 128 output tile, fixed slice of the rows) is summed by one
//     block in registers and its partial written once; a reduce adds
//     the slices in slice order and the chunks in chunk order. No atomics:
//     the result is bit-reproducible from call to call, and the gathered
//     and index routes, which see the same rows in the same chunks, give the
//     same bits for d(q_proj) and the weight gradients;
//   * the index route's d(kv) rows are summed per key by the inverse index
//     and chunked sums of csrc/inverse_index.cuh, chunk after chunk.
//
// The bf16 mode (BF16), the TPU kernels' _mm2 (pallas_attention.py:368-405,
// 1107-1134): every product above rounds both operands to bf16 and sums the
// exact products in f32, the forward recompute's (theta's two layers, k, v,
// h1) included. Here every product is gemm3_kernel's bf16 mode (each
// staged tile rounded once, fragments by ldmatrix, one mma.sync m16n8k16
// per 16-deep step: a sixth of the mma instructions of 3xTF32, no FMA
// chains on the CUDA cores); the key rows and positions
// are rounded as they are loaded (load_rows_kernel's RND) and rel once
// after (theta's first layer on the CUDA cores reads it). Masks, softmax,
// d(q_proj), the biases' gradients (column sums) and the rows' gradients
// stay f32. The weight kernels' gradients are reduced in the same slice and
// chunk order, then rounded to bf16 once (the VJP's cast to the kernels'
// bf16); the index route's d(kv) rounds each row before its per-key sum
// and the finished sum after the last chunk; the gathered route's dg rows
// stay f32 (the gather's rows are f32; its scatter rounds them). Both
// routes' properties hold: the same bits on every call, and the same bits
// for d(q_proj) and the weight gradients from the gathered and index routes
// on the same rows (the gathered rows are bf16 values already; rounding
// them again changes nothing). A ReLU mask may flip against a plain bf16
// version where h1 or theta_h lies within an f32 rounding of zero
// (the products' sums run in another order), so the kernels are held to a
// bf16 tolerance, not the f32 mode's 5e-6. The self-attention in bf16
// (run<kSelf, true>) reads rel and gf as given: rel is copied into the
// chunk's buffer and rounded there (theta's first layer on the CUDA cores
// reads it), gf is rounded as each GEMM stages it; its rows' gradients dgf
// are rounded to bf16 after the last chunk (the custom VJP's cast to gf's
// bf16, pallas_self_attention.py:317-368), d(q_proj) stays f32 (the
// module's cast of its bf16 q projection rounds it).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "inverse_index.cuh"

namespace {

// The GEMM kernels (gemm3_wgmma_kernel, gemm3_kernel), their helpers, the
// row loader and theta's hidden layer: csrc/attn_common.cuh.
constexpr int kSplitBlocks = 264;  // 2 blocks on each of the 132 SMs.

// ----------------------------------------------------- weight-gradient phase --
// Slices of the rows for a long-K product with `tiles` output tiles: about
// kSplitBlocks (tile, slice) pairs (one wave of gemm3_kernel's two blocks
// per SM, two rounds of the wgmma engine's one), each slice a multiple of
// kBK rows.
int row_slice(int R, int tiles) {
  const int want = tiles < kSplitBlocks ? kSplitBlocks / tiles : 1;
  int slice = (R + want - 1) / want;
  slice = ((slice + kBK - 1) / kBK) * kBK;
  return slice < kBK ? kBK : slice;
}

int out_tiles(int K1, int N) { return ((K1 + kBM - 1) / kBM) * ((N + kBN - 1) / kBN); }

int n_slices(int R, int slice) { return (R + slice - 1) / slice; }

// Column sums of X (R x N, row stride ldx) over row slices: part[z * N + c].
__global__ void colsum_kernel(const float* __restrict__ X, long long ldx, int R, int N,
                              int slice, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * slice, r1 = min(R, r0 + slice);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += X[(size_t)r * ldx + c];
  part[(size_t)blockIdx.y * N + c] = s;
}

// out[i] = (first ? 0 : out[i]) + (sum over the slices z, in order, of
// part[z * cnt + i]).
__global__ void reduce_kernel(const float* __restrict__ part, int S, long long cnt,
                              int first, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cnt;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += part[(size_t)z * cnt + i];
    out[i] = first ? s : out[i] + s;
  }
}

cudaError_t reduce(const float* part, int S, long long cnt, int first, float* out,
                   cudaStream_t s) {
  const long long want = (cnt + 255) / 256;
  reduce_kernel<<<(int)(want < 4096 ? want : 4096), 256, 0, s>>>(part, S, cnt, first, out);
  return cudaGetLastError();
}

// out (K1 x N) (+)= alpha X^T Y over R rows (X: R x K1, Y: R x N, row-major);
// BF16: the operands rounded to bf16.
template <bool BF16>
cudaError_t wgrad(const float* X, int K1, const float* Y, int N, int R, float alpha,
                  float* part, float* out, int first, cudaStream_t s) {
  const int slice = row_slice(R, out_tiles(K1, N)), S = n_slices(R, slice);
  GemmArgs a = gemm_args(X, K1, Y, N, part, N, K1, N, R);
  a.kslice = slice;
  a.zstride = (long long)K1 * N;
  a.alpha = alpha;
  cudaError_t e = gemm<true, false, false, BF16>(a, S, s);
  if (e != cudaSuccess) return e;
  return reduce(part, S, (long long)K1 * N, first, out, s);
}

// Row slices of a column sum: about eight blocks of 128 columns per SM, so
// enough loads are in flight (a thread sums its column down its slice).
int colsum_slice(int R, int N) { return row_slice(R, ((N + kBN - 1) / kBN + 7) / 8); }

// out (N) (+)= the column sums of X (R x N).
cudaError_t bias_grad(const float* X, int N, int R, float* part, float* out, int first,
                      cudaStream_t s) {
  const int slice = colsum_slice(R, N), S = n_slices(R, slice);
  colsum_kernel<<<dim3((N + 127) / 128, S), 128, 0, s>>>(X, N, R, N, slice, part);
  return reduce(part, S, N, first, out, s);
}

// x[i] rounded to bf16 (stored as f32) for i < n.
__global__ void round_bf16_kernel(float* __restrict__ x, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    x[i] = round_bf16(x[i]);
}

cudaError_t round_all(float* x, long long n, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long want = (n + 255) / 256;
  round_bf16_kernel<<<(int)(want < 4096 ? want : 4096), 256, 0, s>>>(x, n);
  return cudaGetLastError();
}

// A row-phase product (one split): bf16 tensor cores in the bf16 mode, else
// f32 FMA chains where FMA (the products that decide a ReLU mask), else
// 3xTF32.
template <bool TB, bool FMA, bool BF16>
cudaError_t row_gemm(const GemmArgs& a, cudaStream_t s) {
  if constexpr (BF16)
    return gemm<false, TB, false, true>(a, 1, s);
  else
    return gemm<false, TB, FMA>(a, 1, s);
}

long long part_floats(int R, int K1, int N) {
  return (long long)n_slices(R, row_slice(R, out_tiles(K1, N))) * K1 * N;
}

// --------------------------------------------------------------- row phase --

struct BwdArgs {
  const float* qpos;   // (B, N, 3)
  const float* qproj;  // (B, N, D)
  const int* ki;       // (B, N, KS)
  const float* kpos;   // (B, M, 3)
  const float* kv;     // premul (B, M, 2D); per-row (B, M, E)
  const float* gin;    // gathered only: (B, KE, N, E + 3)
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
  const float* g;      // (B, N, D)
  float* dqproj;       // (B, N, D)
  float* dw;           // the weight-gradient block (weight_floats)
  float* dkv;          // index route: (B, M, 2D | E)
  float* dg;           // gathered: (B, KE, N, E + 3); self: dgf (B, N, k, E)
  float* ws;           // workspace floats (plan)
  int* iws;            // index route: inverse-index ints (plan)
  int N, M, D, E, H, P, KS, KE, k, premul, QC;
  float inv_sqrt_d;
};

// Weight-gradient block, in order: dA1 (D, H), dA2 (H, D), dW2 (P, D),
// dW1 (3, P), dc1 (H), dc2 (D), db2 (D), db1 (P), then per-row dWk (E, D),
// dWv (E, D).
long long weight_floats(int D, int E, int H, int P, int premul) {
  return 2LL * D * H + (long long)P * D + 3LL * P + H + 2LL * D + P +
         (premul ? 0LL : 2LL * E * D);
}

// Floats of one row's operands (the same for every mode, so that the
// gathered and index routes cut their rows into the same chunks).
long long row_floats(int D, int E, int H, int P) {
  return 3LL + 2LL * E + 2LL * P + 6LL * D + 2LL * H;
}

struct Chunk {  // per-row operand buffers of one chunk, R rows at most.
  float *rel, *f, *ph, *th, *kk, *vv, *hp, *r1, *lg, *dh, *dhp, *dph, *drow, *part;
};

// The chunk's buffers in ws, each 16-byte aligned; *used: their floats.
Chunk carve(float* ws, long long R, int D, int E, int H, int P, long long* used) {
  Chunk c;
  long long off = 0;
  auto take = [&](long long n) {
    float* r = ws == nullptr ? nullptr : ws + off;
    off += (n + 3) / 4 * 4;
    return r;
  };
  c.rel = take(R * 3);
  c.f = take(R * E);
  c.ph = take(R * P);
  c.th = take(R * D);   // theta, then dtheta.
  c.kk = take(R * D);   // k rows, then dvpe.
  c.vv = take(R * D);   // v rows, then v + theta.
  c.hp = take(R * D);
  c.r1 = take(R * H);
  c.lg = take(R * D);   // logits, then dlog.
  c.dh = take(R * H);
  c.dhp = take(R * D);
  c.dph = take(R * P);
  c.drow = take(R * E);
  c.part = take(0);  // then the weight partials, then the index route's sums.
  *used = off;
  return c;
}

long long part_max(int R, int D, int E, int H, int P) {
  const int dims[][2] = {{D, H}, {H, D}, {P, D}, {3, P}, {E, D}};
  long long m = 0;
  for (auto& d : dims) {
    const long long v = part_floats(R, d[0], d[1]);
    if (v > m) m = v;
  }
  const int cols[] = {H, D, P};
  for (int c : cols) {
    const long long v = (long long)n_slices(R, colsum_slice(R, c)) * c;
    if (v > m) m = v;
  }
  return m;
}


// hpre = (q - k) + theta; v + theta (in place of v).
__global__ void hpre_kernel(const float* __restrict__ qproj, const float* __restrict__ kk,
                            const float* __restrict__ th, float* __restrict__ hp,
                            float* __restrict__ vv, int R, int D, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * D) return;
  const int r = (int)(i / D), c = (int)(i % D);
  hp[i] = (qproj[(size_t)(r / k) * D + c] - kk[i]) + th[i];
  vv[i] = vv[i] + th[i];
}

// The softmax over a query's k rows and its backward, per (query, channel):
// lg (logits without c2) -> dlog in place, dvpe into dv.
__global__ void softmax_bwd_kernel(float* __restrict__ lg, const float* __restrict__ vpe,
                                   const float* __restrict__ g, const float* __restrict__ c2,
                                   float* __restrict__ dv, int nq, int D, int k,
                                   float inv_sqrt_d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nq * D) return;
  const int nl = (int)(i / D), c = (int)(i % D);
  const size_t o0 = (size_t)nl * k * D + c;
  const float bias = c2[c];
  float mx = -CUDART_INF_F;
  for (int j = 0; j < k; ++j) mx = fmaxf(mx, (lg[o0 + (size_t)j * D] + bias) * inv_sqrt_d);
  float den = 0.f;
  for (int j = 0; j < k; ++j) {
    const size_t o = o0 + (size_t)j * D;
    const float e = expf((lg[o] + bias) * inv_sqrt_d - mx);
    lg[o] = e;
    den += e;
  }
  const float gc = g[(size_t)nl * D + c];
  float s = 0.f;
  for (int j = 0; j < k; ++j) {
    const size_t o = o0 + (size_t)j * D;
    s += (lg[o] / den) * (gc * vpe[o]);
  }
  for (int j = 0; j < k; ++j) {
    const size_t o = o0 + (size_t)j * D;
    const float a = lg[o] / den;
    lg[o] = a * (gc * vpe[o] - s) * inv_sqrt_d;
    dv[o] = a * gc;
  }
}

// dq = sum over the query's k rows of dhpre (in row order); dtheta = dhpre +
// dvpe (in place of theta).
__global__ void dq_dtheta_kernel(const float* __restrict__ dhp, const float* __restrict__ dv,
                                 float* __restrict__ th, float* __restrict__ dq, int nq,
                                 int D, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nq * D) return;
  const int nl = (int)(i / D), c = (int)(i % D);
  const size_t o0 = (size_t)nl * k * D + c;
  float s = 0.f;
  for (int j = 0; j < k; ++j) {
    const size_t o = o0 + (size_t)j * D;
    s += dhp[o];
    th[o] = dhp[o] + dv[o];
  }
  dq[i] = s;
}

// The index route's row gradients, entry e = row e of the chunk: premul
// [-dhpre | dvpe] (2D), per-row the d(feats2) rows (E).
struct KvRows {
  static constexpr bool kWeighted = false;
  struct Entry {
    int r;
  };
  const float* dhp;
  const float* dv;
  const float* drow;
  int D, E, premul;
  __device__ Entry entry(int e, float*) const { return Entry{e}; }
  __device__ float value(const Entry& x, int c) const {
    if (!premul) return __ldg(drow + (size_t)x.r * E + c);
    return c < D ? -__ldg(dhp + (size_t)x.r * D + c) : __ldg(dv + (size_t)x.r * D + c - D);
  }
};


template <int MODE, bool BF16>
int run(BwdArgs& p, int B, cudaStream_t s) {
  const int D = p.D, E = p.E, H = p.H, P = p.P, k = p.k;
  const bool premul = MODE == kIndex && p.premul;
  const int CW = premul ? 2 * D : E;
  const long long Rmax = (long long)p.QC * k;
  long long used;
  Chunk c = carve(p.ws, Rmax, D, E, H, P, &used);
  float* sumf = p.ws + used + part_max((int)Rmax, D, E, H, P);
  float* dw = p.dw;
  float* dA1 = dw;
  float* dA2 = dA1 + (size_t)D * H;
  float* dW2 = dA2 + (size_t)H * D;
  float* dW1 = dW2 + (size_t)P * D;
  float* dc1 = dW1 + 3 * P;
  float* dc2 = dc1 + H;
  float* db2 = dc2 + D;
  float* db1 = db2 + D;
  float* dWk = db1 + P;
  float* dWv = dWk + (size_t)E * D;
  if (MODE == kIndex)
    O4D_TRY(cudaMemsetAsync(p.dkv, 0, sizeof(float) * (size_t)B * p.M * CW, s));
  int first = 1;
  for (int b = 0; b < B; ++b) {
    for (int n0 = 0; n0 < p.N; n0 += p.QC, first = 0) {
      const int nq = min(p.QC, p.N - n0), R = nq * k;
      const size_t q0 = (size_t)b * p.N + n0;  // the chunk's first query.
      const float* rel = c.rel;
      const float* F = c.f;
      if (MODE == kSelf) {
        F = p.gf + q0 * k * E;
        if (BF16) {  // rel is an operand of theta's first layer and of dW1 only.
          O4D_TRY(cudaMemcpyAsync(c.rel, p.rel + q0 * k * 3, sizeof(float) * (size_t)R * 3,
                                  cudaMemcpyDeviceToDevice, s));
          O4D_TRY(round_all(c.rel, (long long)R * 3, s));
        } else {
          rel = p.rel + q0 * k * 3;
        }
      } else {
        const RowSrc src{p.qpos, p.ki, p.kpos, p.kv, p.gin, p.dg,
                         p.N, p.M, D, E, p.KS, p.KE, k, p.premul};
        load_rows_kernel<MODE, BF16><<<blocks_for(R, 8), 256, 0, s>>>(
            src, RowDst{c.rel, c.f, c.kk, c.vv}, b, n0, R);
        // rel is an operand of theta's first layer and of dW1 only.
        if (BF16) O4D_TRY(round_all(c.rel, (long long)R * 3, s));
      }
      // ---- Forward recompute ----
      pos_hidden_kernel<<<blocks_for((long long)R * P, 256), 256, 0, s>>>(rel, p.wp1, p.bp1,
                                                                         c.ph, R, P);
      // f32: theta, k, v and h1 on the CUDA cores (FMA chains, the rounding
      // of the plain f32 products): h1's sign is the ReLU mask of dh1, and a
      // mask that flips where h1 is within rounding of zero moves d(q_proj)
      // and dA1 far past the f32 tolerance. bf16: on the tensor cores.
      GemmArgs a = gemm_args(c.ph, P, p.wp2, D, c.th, D, R, D, P);
      a.bias = p.bp2;
      O4D_TRY((row_gemm<false, true, BF16>(a, s)));
      if (!premul) {
        O4D_TRY((row_gemm<false, true, BF16>(gemm_args(F, E, p.wk, D, c.kk, D, R, D, E), s)));
        O4D_TRY((row_gemm<false, true, BF16>(gemm_args(F, E, p.wv, D, c.vv, D, R, D, E), s)));
      }
      hpre_kernel<<<blocks_for((long long)R * D, 256), 256, 0, s>>>(
          p.qproj + q0 * D, c.kk, c.th, c.hp, c.vv, R, D, k);
      a = gemm_args(c.hp, D, p.wa1, H, c.r1, H, R, H, D);
      a.bias = p.ba1;
      a.relu = 1;
      O4D_TRY((row_gemm<false, true, BF16>(a, s)));
      O4D_TRY((row_gemm<false, false, BF16>(gemm_args(c.r1, H, p.wa2, D, c.lg, D, R, D, H),
                                            s)));
      // ---- Softmax backward: dlog (in lg), dvpe (in kk) ----
      float* dv = c.kk;
      softmax_bwd_kernel<<<blocks_for((long long)nq * D, 256), 256, 0, s>>>(
          c.lg, c.vv, p.g + q0 * D, p.ba2, dv, nq, D, k, p.inv_sqrt_d);
      // ---- dh1 = [relu(h1) > 0] dlog A2^T; dhpre = dh1 A1^T ----
      a = gemm_args(c.lg, D, p.wa2, D, c.dh, H, R, H, D);
      a.mask = c.r1;
      a.ldm = H;
      O4D_TRY((row_gemm<true, false, BF16>(a, s)));
      O4D_TRY((row_gemm<true, false, BF16>(gemm_args(c.dh, H, p.wa1, H, c.dhp, D, R, D, H),
                                           s)));
      dq_dtheta_kernel<<<blocks_for((long long)nq * D, 256), 256, 0, s>>>(
          c.dhp, dv, c.th, p.dqproj + q0 * D, nq, D, k);
      // dtheta_h = [relu(theta_h) > 0] dtheta W2^T.
      a = gemm_args(c.th, D, p.wp2, D, c.dph, P, R, P, D);
      a.mask = c.ph;
      a.ldm = P;
      O4D_TRY((row_gemm<true, false, BF16>(a, s)));
      // ---- The rows' gradients: dvpe Wv^T - dhpre Wk^T ----
      if (!premul) {
        GemmArgs r1 = gemm_args(dv, D, p.wv, D, c.drow, E, R, E, D);
        if (MODE == kGathered) {
          r1.C = p.dg + ((size_t)b * p.KE * p.N + n0) * (E + 3);
          r1.map = RowMap{E + 3, (long long)p.N * (E + 3), k};
        } else if (MODE == kSelf) {
          r1.C = p.dg + q0 * k * E;
        }
        O4D_TRY((row_gemm<true, false, BF16>(r1, s)));
        GemmArgs r2 = r1;
        r2.A = c.dhp;
        r2.B = p.wk;
        r2.alpha = -1.f;
        r2.accum = 1;
        O4D_TRY((row_gemm<true, false, BF16>(r2, s)));
      }
      if (MODE == kIndex) {
        const o4d_index::Entries x{p.ki + q0 * p.KS, nq, p.M, p.KS, k, false};
        O4D_TRY(o4d_index::build(x, R, p.M, p.iws, s));
        const KvRows rows{c.dhp, dv, c.drow, D, E, premul ? 1 : 0};
        O4D_TRY((o4d_index::sum<KvRows, true, BF16>(rows, x, p.iws, sumf,
                                                    p.dkv + (size_t)b * p.M * CW, R, p.M,
                                                    CW, s)));
      }
      // ---- Weight gradients over the chunk's rows ----
      O4D_TRY(wgrad<BF16>(c.hp, D, c.dh, H, R, 1.f, c.part, dA1, first, s));
      O4D_TRY(wgrad<BF16>(c.r1, H, c.lg, D, R, 1.f, c.part, dA2, first, s));
      O4D_TRY(wgrad<BF16>(c.ph, P, c.th, D, R, 1.f, c.part, dW2, first, s));
      O4D_TRY(wgrad<BF16>(rel, 3, c.dph, P, R, 1.f, c.part, dW1, first, s));
      O4D_TRY(bias_grad(c.dh, H, R, c.part, dc1, first, s));
      O4D_TRY(bias_grad(c.lg, D, R, c.part, dc2, first, s));
      O4D_TRY(bias_grad(c.th, D, R, c.part, db2, first, s));
      O4D_TRY(bias_grad(c.dph, P, R, c.part, db1, first, s));
      if (!premul) {
        O4D_TRY(wgrad<BF16>(F, E, c.dhp, D, R, -1.f, c.part, dWk, first, s));
        O4D_TRY(wgrad<BF16>(F, E, dv, D, R, 1.f, c.part, dWv, first, s));
      }
    }
  }
  if (BF16) {  // the finished sums: the weight kernels' gradients, d(kv), dgf.
    O4D_TRY(round_all(dA1, 2LL * D * H + (long long)P * D + 3LL * P, s));
    if (!premul) O4D_TRY(round_all(dWk, 2LL * E * D, s));
    if (MODE == kIndex) O4D_TRY(round_all(p.dkv, (long long)B * p.M * CW, s));
    if (MODE == kSelf) O4D_TRY(round_all(p.dg, (long long)B * p.N * k * E, s));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the reduced weight-gradient block (layout at weight_floats).
extern "C" long long o4d_attn_bwd_weight_floats(int D, int E, int H, int P,
                                                int premul) {
  return weight_floats(D, E, H, P, premul);
}

// The chunking of a launch: QC, queries per chunk (whole queries of one
// example; at most N; the largest whose per-row operands fit budget bytes,
// the same for every mode), and the workspace it needs: f32 floats and, for
// the index route, int32 ints.
extern "C" void o4d_attn_bwd_plan(int N, int M, int D, int E, int H, int P, int k,
                                  int premul, long long budget, int* QC,
                                  long long* floats, long long* ints) {
  long long qc = budget / ((long long)sizeof(float) * k * row_floats(D, E, H, P));
  if (qc > N) qc = N;
  if (qc < 1) qc = 1;
  const long long R = qc * k;
  const int CW = premul ? 2 * D : E;
  *QC = (int)qc;
  long long used;
  carve(nullptr, R, D, E, H, P, &used);
  *floats = used + part_max((int)R, D, E, H, P) + o4d_index::sum_floats(R, CW);
  *ints = M > 0 ? o4d_index::index_ints(R, M) : 0;
}

// The GEMM launches of this library since the last call, by path: out[0]
// the wgmma engine (f32), out[1] mma.sync f32, out[2] mma.sync bf16,
// out[3] the f32 FMA chains; the counts restart from zero.
extern "C" void o4d_gemm_launches(long long* out) {
  for (int i = 0; i < kPaths; ++i) out[i] = g_gemm_launches[i].exchange(0);
}

// One f32 tensor-core product as the backward launches it, for the card
// tests and tools: C (+)= alpha op(A) op(B) with GemmArgs' epilogue over
// `splits` K slices of kslice (slice z at C + z zstride), op(A) = A^T with
// ta, op(B) = B^T with tb (the three pairs the backward uses: (0, 0),
// (0, 1), (1, 0)); the path follows from the shapes as in the backward.
extern "C" int o4d_gemm_f32(int ta, int tb, const void* A, long long lda, const void* B,
                            long long ldb, void* C, long long map_q, long long map_j,
                            int map_rk, long long zstride, const void* bias, const void* mask,
                            long long ldm, int M, int N, int K, int kslice, int splits,
                            float alpha, int relu, int accum, void* stream) {
  GemmArgs a = gemm_args((const float*)A, lda, (const float*)B, ldb, (float*)C, map_q, M, N, K);
  a.map = RowMap{map_q, map_j, map_rk};
  a.zstride = zstride;
  a.bias = (const float*)bias;
  a.mask = (const float*)mask;
  a.ldm = ldm;
  a.kslice = kslice;
  a.alpha = alpha;
  a.relu = relu;
  a.accum = accum;
  const cudaStream_t s = (cudaStream_t)stream;
  if (map_rk < 1 || splits < 1 || kslice < 1) return (int)cudaErrorInvalidValue;
  if (!ta && !tb) return (int)gemm<false, false>(a, splits, s);
  if (!ta && tb) return (int)gemm<false, true>(a, splits, s);
  if (ta && !tb) return (int)gemm<true, false>(a, splits, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

BwdArgs weights_args(const void* wk, const void* wv, const void* wp1, const void* bp1,
                     const void* wp2, const void* bp2, const void* wa1, const void* ba1,
                     const void* wa2, const void* ba2, const void* g, void* dqproj,
                     void* dw, void* ws, int N, int D, int E, int H, int P, int k,
                     int QC) {
  BwdArgs a = {};
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
  a.g = (const float*)g;
  a.dqproj = (float*)dqproj;
  a.dw = (float*)dw;
  a.ws = (float*)ws;
  a.N = N;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.k = k;
  a.QC = QC;
  a.inv_sqrt_d = 1.0f / sqrtf((float)D);
  return a;
}

template <bool BF16>
int attn_bwd(const void* qpos, const void* qproj, const void* ki, const void* kpos,
             const void* kv, const void* wk, const void* wv, const void* wp1,
             const void* bp1, const void* wp2, const void* bp2, const void* wa1,
             const void* ba1, const void* wa2, const void* ba2, const void* g, void* dqproj,
             void* dw, void* dkv, void* ws, void* iws, int B, int N, int M, int D, int E,
             int H, int P, int KS, int k, int premul, int QC, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || QC < 1 || (long long)QC * k >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = weights_args(wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, g, dqproj, dw,
                           ws, N, D, E, H, P, k, QC);
  a.qpos = (const float*)qpos;
  a.qproj = (const float*)qproj;
  a.ki = (const int*)ki;
  a.kpos = (const float*)kpos;
  a.kv = (const float*)kv;
  a.dkv = (float*)dkv;
  a.iws = (int*)iws;
  a.M = M;
  a.KS = KS;
  a.premul = premul;
  return run<kIndex, BF16>(a, B, (cudaStream_t)stream);
}

template <bool BF16>
int attn_g_bwd(const void* qpos, const void* qproj, const void* gin, const void* wk,
               const void* wv, const void* wp1, const void* bp1, const void* wp2,
               const void* bp2, const void* wa1, const void* ba1, const void* wa2,
               const void* ba2, const void* go, void* dqproj, void* dw, void* dg, void* ws,
               int B, int N, int D, int E, int H, int P, int KE, int k, int QC,
               void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KE || QC < 1) return (int)cudaErrorInvalidValue;
  BwdArgs a = weights_args(wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, go, dqproj, dw,
                           ws, N, D, E, H, P, k, QC);
  a.qpos = (const float*)qpos;
  a.qproj = (const float*)qproj;
  a.gin = (const float*)gin;
  a.dg = (float*)dg;
  a.KE = KE;
  return run<kGathered, BF16>(a, B, (cudaStream_t)stream);
}

}  // namespace

// Inputs as o4d_attn (csrc/attn.cu) plus g (B, N, D). Outputs: dqproj
// (B, N, D); dw, the weight-gradient block; dkv (B, M, 2D | E). ws / iws:
// the workspace of o4d_attn_bwd_plan for QC.
extern "C" int o4d_attn_bwd(const void* qpos, const void* qproj, const void* ki,
                            const void* kpos, const void* kv, const void* wk,
                            const void* wv, const void* wp1, const void* bp1,
                            const void* wp2, const void* bp2, const void* wa1,
                            const void* ba1, const void* wa2, const void* ba2,
                            const void* g, void* dqproj, void* dw, void* dkv, void* ws,
                            void* iws, int B, int N, int M, int D, int E, int H, int P,
                            int KS, int k, int premul, int QC, void* stream) {
  return attn_bwd<false>(qpos, qproj, ki, kpos, kv, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1,
                         wa2, ba2, g, dqproj, dw, dkv, ws, iws, B, N, M, D, E, H, P, KS, k,
                         premul, QC, stream);
}

// o4d_attn_bwd in the bf16 mode (the same arguments; the weights rounded to
// bf16 by the caller or not, the kernel rounds every product's operands):
// dw's weight kernels and dkv hold bf16 values, dqproj and dw's biases f32.
extern "C" int o4d_attn_bwd_bf16(const void* qpos, const void* qproj, const void* ki,
                                 const void* kpos, const void* kv, const void* wk,
                                 const void* wv, const void* wp1, const void* bp1,
                                 const void* wp2, const void* bp2, const void* wa1,
                                 const void* ba1, const void* wa2, const void* ba2,
                                 const void* g, void* dqproj, void* dw, void* dkv, void* ws,
                                 void* iws, int B, int N, int M, int D, int E, int H, int P,
                                 int KS, int k, int premul, int QC, void* stream) {
  return attn_bwd<true>(qpos, qproj, ki, kpos, kv, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1,
                        wa2, ba2, g, dqproj, dw, dkv, ws, iws, B, N, M, D, E, H, P, KS, k,
                        premul, QC, stream);
}

// The gathered form: gin (B, KE, N, E + 3) replaces ki, kpos and kv (per-row
// mode); go (B, N, D) is d(out). Outputs: dqproj (B, N, D); dw, the
// weight-gradient block (premul = 0 layout); dg (B, KE, N, E + 3), every
// element written. ws: the workspace of o4d_attn_bwd_plan for QC.
extern "C" int o4d_attn_g_bwd(const void* qpos, const void* qproj, const void* gin,
                              const void* wk, const void* wv, const void* wp1,
                              const void* bp1, const void* wp2, const void* bp2,
                              const void* wa1, const void* ba1, const void* wa2,
                              const void* ba2, const void* go, void* dqproj, void* dw,
                              void* dg, void* ws, int B, int N, int D, int E, int H,
                              int P, int KE, int k, int QC, void* stream) {
  return attn_g_bwd<false>(qpos, qproj, gin, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2,
                           ba2, go, dqproj, dw, dg, ws, B, N, D, E, H, P, KE, k, QC, stream);
}

// o4d_attn_g_bwd in the bf16 mode (the same arguments): dw's weight kernels
// hold bf16 values; dqproj, dw's biases and dg f32.
extern "C" int o4d_attn_g_bwd_bf16(const void* qpos, const void* qproj, const void* gin,
                                   const void* wk, const void* wv, const void* wp1,
                                   const void* bp1, const void* wp2, const void* bp2,
                                   const void* wa1, const void* ba1, const void* wa2,
                                   const void* ba2, const void* go, void* dqproj, void* dw,
                                   void* dg, void* ws, int B, int N, int D, int E, int H,
                                   int P, int KE, int k, int QC, void* stream) {
  return attn_g_bwd<true>(qpos, qproj, gin, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2,
                          ba2, go, dqproj, dw, dg, ws, B, N, D, E, H, P, KE, k, QC, stream);
}

namespace {

template <bool BF16>
int sattn_bwd(const void* q, const void* gf, const void* rel, const void* wk, const void* wv,
              const void* wp1, const void* bp1, const void* wp2, const void* bp2,
              const void* wa1, const void* ba1, const void* wa2, const void* ba2,
              const void* go, void* dq, void* dw, void* dgf, void* ws, int B, int N, int D,
              int E, int H, int P, int k, int QC, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || QC < 1) return (int)cudaErrorInvalidValue;
  BwdArgs a = weights_args(wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, go, dq, dw,
                           ws, N, D, E, H, P, k, QC);
  a.qproj = (const float*)q;
  a.gf = (const float*)gf;
  a.rel = (const float*)rel;
  a.dg = (float*)dgf;
  return run<kSelf, BF16>(a, B, (cudaStream_t)stream);
}

}  // namespace

// The encoder's fused self-attention backward: inputs as o4d_sattn
// (csrc/attn.cu) plus go (B, N, D) = d(out). Outputs: dq (B, N, D); dw, the
// weight-gradient block (premul = 0 layout); dgf (B, N, k, E), every element
// written. ws: the workspace of o4d_attn_bwd_plan for QC.
extern "C" int o4d_sattn_bwd(const void* q, const void* gf, const void* rel,
                             const void* wk, const void* wv, const void* wp1,
                             const void* bp1, const void* wp2, const void* bp2,
                             const void* wa1, const void* ba1, const void* wa2,
                             const void* ba2, const void* go, void* dq, void* dw,
                             void* dgf, void* ws, int B, int N, int D, int E, int H,
                             int P, int k, int QC, void* stream) {
  return sattn_bwd<false>(q, gf, rel, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, go, dq,
                          dw, dgf, ws, B, N, D, E, H, P, k, QC, stream);
}

// o4d_sattn_bwd in the bf16 compute mode (the same arguments; the weight
// kernels rounded to bf16 by the caller, since theta's first layer reads W1
// as given): _bwd_kernel at compute_dtype=bfloat16. dgf and dw's weight
// kernels hold bf16 values; dq and dw's biases f32.
extern "C" int o4d_sattn_bwd_bf16(const void* q, const void* gf, const void* rel,
                                  const void* wk, const void* wv, const void* wp1,
                                  const void* bp1, const void* wp2, const void* bp2,
                                  const void* wa1, const void* ba1, const void* wa2,
                                  const void* ba2, const void* go, void* dq, void* dw,
                                  void* dgf, void* ws, int B, int N, int D, int E, int H,
                                  int P, int k, int QC, void* stream) {
  return sattn_bwd<true>(q, gf, rel, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, go, dq,
                         dw, dgf, ws, B, N, D, E, H, P, k, QC, stream);
}
