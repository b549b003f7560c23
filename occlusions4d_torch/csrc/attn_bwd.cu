// Backward of the fused kNN vector attention for Hopper, three entries:
//   o4d_attn_bwd   replaces occlusions4d_tpu/ops/pallas_attention.py::
//                  _attn_bwd_kernel (:246), in its use_idx form, in both
//                  projection modes of the forward (csrc/attn.cu):
//     premul  - kv = [feats2 Wk | feats2 Wv] (B, M, 2D); d(kv) holds [dk | dv];
//     per-row - kv = feats2 (B, M, E); d(kv) = d(feats2), plus dWk and dWv;
//   o4d_attn_g_bwd replaces _attn_g_bwd_kernel (:1030): per-row mode over the
//                  shared gather's rows g (B, K_ext, N, E + 3) (csrc/gather.cu).
//                  Only the row loader and the row gradients' destination
//                  differ: the rows' gradients
//                  dk Wk^T + dv Wv^T are WRITTEN to dg[b, j, n, :E] (the first
//                  pass stores, the second adds; exactly one block owns each
//                  (j, n) row), the position columns and the rows j >= k of
//                  dg are zeroed, and the scatter of csrc/gather.cu takes dg
//                  to the key rows. The slots then hold the weight block only;
//   o4d_sattn_bwd  replaces occlusions4d_tpu/ops/pallas_self_attention.py::
//                  _bwd_kernel (:132), the encoder's fused self-attention
//                  (o4d_sattn of csrc/attn.cu): the rows come from gf
//                  (B, N, k, E) and rel (B, N, k, 3), and their gradients are
//                  written to dgf (B, N, k, E) as the gathered form writes dg
//                  (one block owns each row; no position columns, no rows past
//                  k). The kernel at pallas_self_attention.py:182-214 computes
//                  the same chain.
// The three entries share one body; the template parameter MODE picks the
// row loader and where the rows' gradients go.
//
// Function: with the forward of csrc/attn.cu recomputed per row tile
// (theta = W2 relu(W1 rel + b1) + b2, hpre = q - k + theta,
// h1 = A1 hpre + c1, logits = (A2 relu(h1) + c2) / sqrt(D), a = softmax_K,
// out = sum_K a (v + theta)) and g = d(out), in the order of :358-405:
//   dvpe  = a g;  s = sum_K a g (v + theta);  dlog = a (g (v + theta) - s) / sqrt(D)
//   dA2 += relu(h1)^T dlog;  dc2 += sum dlog;  dh1 = [h1 > 0] dlog A2^T
//   dA1 += hpre^T dh1;  dc1 += sum dh1;  dhpre = dh1 A1^T;  dq = sum_K dhpre
//   dk = -dhpre, dv = dvpe (scattered to their key rows);  dtheta = dhpre + dvpe
//   dW2 += relu(W1 rel + b1)^T dtheta;  db2 += sum dtheta
//   dtheta_h = [theta_h > 0] dtheta W2^T;  dW1 += rel^T dtheta_h;  db1 += sum dtheta_h
// (per-row: dWk += F^T dk, dWv += F^T dv, d(feats2) rows = dk Wk^T + dv Wv^T).
// Positions carry no gradient.
//
// What bounds it on the H100: operations. Per (query, neighbour) row the
// recomputed gamma MLP is 2 D H multiply-adds and its backward 4 D H more
// (dh1, dhpre and the two weight-gradient products): about 2.1 M per row at
// D 416, H 832, 3.1 TFLOP for one gv1 train frame (3 x 17920 queries, K 14),
// against tens of MB of inputs. This first kernel runs them on the f32 CUDA
// cores, like the forward. In the encoder (o4d_sattn_bwd, D 36 ... 288) the
// weight block is small (under 10 k floats at D 36, about 0.5 M at D 288), so
// the slots' read-modify-writes cost little beside the products.
//
// Design:
//   * a block owns 32 rows = floor(32 / k) queries x k neighbours, so the
//     full-K softmax of a query closes inside the block, and holds its rows'
//     per-channel tensors in 213 KB of shared memory, reusing three (32, D)
//     buffers as the chain proceeds; the (rows, H) hidden layer is recomputed
//     and consumed in 128-column chunks and never stored whole;
//   * the weight gradients and d(kv) are summed over all rows: a grid of
//     (G, B) persistent blocks walks the example's row tiles (tile = x, x + G,
//     ...), and each block adds into its own slot of a scratch array (one
//     partial copy of every weight gradient and of the example's d(kv)) with
//     plain read-modify-writes. No two threads ever add to one address, so
//     there are no atomics; a second kernel sums the slots in a fixed order.
//     The result is bitwise reproducible from call to call;
//   * every product is a register-tiled loop (256 threads, 4 x 4 outputs
//     each) over 32 x 128 weight tiles staged through shared memory (padded
//     rows, so transposed staging is free of bank conflicts).
// wgmma/TMA tiles, bf16 and a smaller scratch are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kColTile = 128;
constexpr int kKTile = 32;
constexpr int kWS = kColTile + 1;  // staged tile row stride.

// C[r][c] (+)= act(sum_kk A[r][kk] W(kk, c) + bias[c]) for r < 32, c < Nc,
// where W(kk, c) = W[kk * ldw + c], or W[c * ldw + kk] when TRANS (A W^T).
// A and C in shared memory, W in global memory.
template <bool TRANS, bool RELU, bool ACCUM>
__device__ void gemm_rows(const float* A, int lda, const float* __restrict__ W,
                          int ldw, const float* __restrict__ bias, int Kd, int Nc,
                          float* C, int ldc, float* ws) {
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
        const int kk = TRANS ? idx % kKTile : idx / kColTile;
        const int c = TRANS ? idx / kKTile : idx % kColTile;
        float v = 0.f;
        if (kk < kc && cb + c < Nc)
          v = TRANS ? W[(size_t)(cb + c) * ldw + k0 + kk]
                    : W[(size_t)(k0 + kk) * ldw + cb + c];
        ws[kk * kWS + c] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * lda + k0 + kk];
#pragma unroll
        for (int t = 0; t < 4; ++t) w[t] = ws[kk * kWS + tx + 32 * t];
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

// out[i * ldo + c] += scale * sum_{r < 32} L(r, i) Rm[r * ldr + c] for
// i < Kd, c < Nc: a weight-gradient product added into a global partial.
// L(r, i) = L[r * ldl + i] in shared memory, or with GATHER the row
// lrow[r][i] in global memory (a key row, or a row of the shared gather; 0
// for an invalid row).
template <bool GATHER>
__device__ void outer_acc(const float* L, int ldl, const float* const* lrow,
                          const int* rvalid, const float* Rm, int ldr, int Kd,
                          int Nc, float scale, float* __restrict__ out, int ldo) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  __syncthreads();
  for (int ib = 0; ib < Kd; ib += 32) {
    for (int cb = 0; cb < Nc; cb += kColTile) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][t] = 0.f;
      for (int r = 0; r < kRows; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ii = ib + ty * 4 + i;
          if (GATHER)
            a[i] = (rvalid[r] && ii < Kd) ? lrow[r][ii] : 0.f;
          else
            a[i] = ii < Kd ? L[r * ldl + ii] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = cb + tx + 32 * t;
          b[t] = c < Nc ? Rm[r * ldr + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = ib + ty * 4 + i;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = cb + tx + 32 * t;
          if (ii < Kd && c < Nc) out[(size_t)ii * ldo + c] += scale * acc[i][t];
        }
      }
    }
  }
}

// out[ridx[r] * ldo + c] += scale * V[r * ldv + c] for valid rows r, in row
// order; thread c owns column c, so repeated keys add in a fixed order.
__device__ void scatter_rows(const float* V, int ldv, const int* ridx,
                             const int* rvalid, float* __restrict__ out, int ldo,
                             int Nc, float scale) {
  __syncthreads();
  for (int r = 0; r < kRows; ++r) {
    if (!rvalid[r]) continue;
    float* o = out + (size_t)ridx[r] * ldo;
    for (int c = threadIdx.x; c < Nc; c += kThreads) o[c] += scale * V[r * ldv + c];
  }
}

// drow[r][c0 + c] (+)= scale * V[r * ldv + c] for valid rows r, c < Nc: the
// gathered form's row gradients, each (j, n) row owned by one block.
template <bool ACCUM>
__device__ void write_rows(const float* V, int ldv, float* const* drow,
                           const int* rvalid, int c0, int Nc, float scale) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * Nc; idx += kThreads) {
    const int r = idx / Nc, c = idx % Nc;
    if (!rvalid[r]) continue;
    float* o = drow[r] + c0 + c;
    const float v = scale * V[r * ldv + c];
    *o = ACCUM ? *o + v : v;
  }
}

// out[c] += sum over valid rows of V[r * ldv + c].
__device__ void colsum(const float* V, int ldv, int Nc, const int* rvalid,
                       float* __restrict__ out) {
  __syncthreads();
  for (int c = threadIdx.x; c < Nc; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r)
      if (rvalid[r]) s += V[r * ldv + c];
    out[c] += s;
  }
}

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
  float* dg;           // gathered only: (B, KE, N, E + 3); self: dgf (B, N, k, E)
  float* part;         // (B * G) slots of slot_floats
  long long slot;
  int N, M, D, E, H, P, KS, KE, k, premul, G;
  float inv_sqrt_d;
};

// Weight-gradient block of a slot (and of the reduced output), in order:
// dA1 (D, H), dA2 (H, D), dW2 (P, D), dW1 (3, P), dc1 (H), dc2 (D), db2 (D),
// db1 (P), then per-row dWk (E, D), dWv (E, D); the example's d(kv) follows.
long long weight_floats(int D, int E, int H, int P, int premul) {
  return 2LL * D * H + (long long)P * D + 3LL * P + H + 2LL * D + P +
         (premul ? 0LL : 2LL * E * D);
}

size_t smem_floats(int D, int E, int P) {
  const int LD = D > E ? D : E;
  return (size_t)kRows * D * 2 + (size_t)kRows * LD + 2 * (size_t)kRows * kColTile +
         (size_t)kKTile * kWS + 2 * (size_t)kRows * P + (size_t)kRows * 3;
}

// Row loaders: neighbour indices into kv, the shared gather's rows, or the
// self-attention's n-major gathered features.
enum { kIndex = 0, kGathered = 1, kSelf = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(BwdArgs p) {
  constexpr bool GATHERED = MODE != kIndex;  // rows read from g / gf, dg written.
  extern __shared__ float sm[];
  const int D = p.D, E = p.E, H = p.H, P = p.P, k = p.k;
  const int LD = D > E ? D : E;
  float* B0 = sm;                     // theta -> v + theta -> d(v + theta) -> d(hpre)
  float* B1 = B0 + kRows * D;         // k -> hpre
  float* B2 = B1 + kRows * D;         // F (per-row) -> logits -> softmax -> d(logits)
  float* HC = B2 + kRows * LD;        // relu(h1) chunk; d(feats2) row chunk
  float* DH = HC + kRows * kColTile;  // d(h1) chunk
  float* WS = DH + kRows * kColTile;  // staged weight tile
  float* PH = WS + kKTile * kWS;      // relu(theta hidden layer)
  float* DPH = PH + kRows * P;        // its gradient
  float* REL = DPH + kRows * P;       // qpos - kpos
  __shared__ int rq[kRows], ridx[kRows], rvalid[kRows];
  __shared__ const float* rrow[kRows];  // the row's features (key or gather row)
  __shared__ float* drow[kRows];        // gathered / self: the row's gradient

  const int b = blockIdx.y, tid = threadIdx.x;
  const int tq_per = kRows / k;
  const int tiles = (p.N + tq_per - 1) / tq_per;
  const int CW = p.premul ? 2 * D : E;
  float* part = p.part + ((size_t)b * p.G + blockIdx.x) * p.slot;
  float* dwa1 = part;
  float* dwa2 = dwa1 + (size_t)D * H;
  float* dwp2 = dwa2 + (size_t)H * D;
  float* dwp1 = dwp2 + (size_t)P * D;
  float* dba1 = dwp1 + 3 * P;
  float* dba2 = dba1 + H;
  float* dbp2 = dba2 + D;
  float* dbp1 = dbp2 + D;
  float* dwk = dbp1 + P;
  float* dwv = dwk + (p.premul ? 0 : (size_t)E * D);
  float* dkv = dwv + (p.premul ? 0 : (size_t)E * D);
  const float* kvb = GATHERED ? nullptr : p.kv + (size_t)b * p.M * CW;

  for (int tile = blockIdx.x; tile < tiles; tile += p.G) {
    const int n0 = tile * tq_per;
    __syncthreads();
    if (tid < kRows) {
      const int tq = tid / k, j = tid % k, n = n0 + tq;
      const bool valid = tq < tq_per && n < p.N;
      rq[tid] = valid ? n : -1;
      rvalid[tid] = valid ? 1 : 0;
      if (MODE == kSelf) {
        const size_t row = ((size_t)b * p.N + (valid ? n : 0)) * k + j;
        rrow[tid] = p.gf + row * E;
        drow[tid] = p.dg + row * E;
        for (int c = 0; c < 3; ++c) REL[tid * 3 + c] = valid ? p.rel[row * 3 + c] : 0.f;
      } else {
        const float* kp;
        if (MODE == kGathered) {
          const size_t row = ((size_t)b * p.KE + j) * p.N + (valid ? n : 0);
          rrow[tid] = p.gin + row * (E + 3);
          drow[tid] = p.dg + row * (E + 3);
          kp = rrow[tid] + E;
        } else {
          const int idx = valid ? p.ki[((size_t)b * p.N + n) * p.KS + j] : 0;
          ridx[tid] = idx;
          rrow[tid] = kvb + (size_t)idx * CW;
          kp = p.kpos + ((size_t)b * p.M + idx) * 3;
        }
        for (int c = 0; c < 3; ++c)
          REL[tid * 3 + c] = valid ? p.qpos[((size_t)b * p.N + n) * 3 + c] - kp[c] : 0.f;
      }
    }
    __syncthreads();
    if (MODE == kGathered) {
      // dg's position columns and the rows j >= k of the tile's queries are
      // zero; the feature columns of the rows j < k are written below.
      const int C = E + 3, extra = (p.KE - k) * C;
      for (int idx = tid; idx < kRows * 3; idx += kThreads)
        if (rvalid[idx / 3]) drow[idx / 3][E + idx % 3] = 0.f;
      for (int idx = tid; idx < tq_per * extra; idx += kThreads) {
        const int tq = idx / extra, j = k + (idx % extra) / C, c = idx % C;
        if (rvalid[tq * k])
          p.dg[(((size_t)b * p.KE + j) * p.N + rq[tq * k]) * C + c] = 0.f;
      }
    }

    // ---- Forward recompute (the arithmetic of csrc/attn.cu) ----
    gemm_rows<false, true, false>(REL, 3, p.wp1, P, p.bp1, 3, P, PH, P, WS);
    gemm_rows<false, false, false>(PH, P, p.wp2, D, p.bp2, P, D, B0, D, WS);
    if (!GATHERED && p.premul) {
      for (int idx = tid; idx < kRows * D; idx += kThreads) {
        const int r = idx / D, c = idx % D;
        B1[idx] = rvalid[r] ? kvb[(size_t)ridx[r] * 2 * D + c] : 0.f;
      }
    } else {
      for (int idx = tid; idx < kRows * E; idx += kThreads) {
        const int r = idx / E, c = idx % E;
        B2[r * LD + c] = rvalid[r] ? rrow[r][c] : 0.f;
      }
      gemm_rows<false, false, false>(B2, LD, p.wk, D, nullptr, E, D, B1, D, WS);
    }
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const float q = rvalid[r] ? p.qproj[((size_t)b * p.N + rq[r]) * D + c] : 0.f;
      B1[idx] = (q - B1[idx]) + B0[idx];
      if (!GATHERED && p.premul)
        B0[idx] = (rvalid[r] ? kvb[(size_t)ridx[r] * 2 * D + D + c] : 0.f) + B0[idx];
    }
    if (GATHERED || !p.premul)
      gemm_rows<false, false, true>(B2, LD, p.wv, D, nullptr, E, D, B0, D, WS);
    __syncthreads();
    for (int idx = tid; idx < kRows * D; idx += kThreads) B2[idx] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kColTile) {
      const int hc = min(kColTile, H - h0);
      gemm_rows<false, true, false>(B1, D, p.wa1 + h0, H, p.ba1 + h0, D, hc, HC,
                                    kColTile, WS);
      gemm_rows<false, false, true>(HC, kColTile, p.wa2 + (size_t)h0 * D, D, nullptr,
                                    hc, D, B2, D, WS);
    }

    // ---- Softmax over K and its backward, per (query, channel) ----
    // Rows of no query (the ragged tile, the padding rows) get zero
    // gradients; they are disjoint from the rows written below.
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D;
      if (!rvalid[r]) {
        B0[idx] = 0.f;
        B2[idx] = 0.f;
      }
    }
    for (int idx = tid; idx < tq_per * D; idx += kThreads) {
      const int tq = idx / D, c = idx % D, r0 = tq * k;
      if (!rvalid[r0]) continue;
      const float bias = p.ba2[c];
      float mx = -CUDART_INF_F;
      for (int j = 0; j < k; ++j)
        mx = fmaxf(mx, (B2[(r0 + j) * D + c] + bias) * p.inv_sqrt_d);
      float den = 0.f;
      for (int j = 0; j < k; ++j) {
        const float e = expf((B2[(r0 + j) * D + c] + bias) * p.inv_sqrt_d - mx);
        B2[(r0 + j) * D + c] = e;
        den += e;
      }
      const float gc = p.g[((size_t)b * p.N + rq[r0]) * D + c];
      float s = 0.f;
      for (int j = 0; j < k; ++j) {
        const float a = B2[(r0 + j) * D + c] / den;
        s += a * (gc * B0[(r0 + j) * D + c]);
      }
      for (int j = 0; j < k; ++j) {
        const int o = (r0 + j) * D + c;
        const float a = B2[o] / den;
        const float da = gc * B0[o];
        B2[o] = a * (da - s) * p.inv_sqrt_d;  // d(logits)
        B0[o] = a * gc;                        // d(v + theta)
      }
    }

    // ---- Everything d(v + theta) feeds, then B0 is free ----
    if (!GATHERED && p.premul) {
      scatter_rows(B0, D, ridx, rvalid, dkv + D, CW, D, 1.f);
    } else {
      outer_acc<true>(nullptr, 0, rrow, rvalid, B0, D, E, D, 1.f, dwv, D);
      for (int e0 = 0; e0 < E; e0 += kColTile) {
        const int ec = min(kColTile, E - e0);
        gemm_rows<true, false, false>(B0, D, p.wv + (size_t)e0 * D, D, nullptr, D,
                                      ec, HC, kColTile, WS);
        if (GATHERED)
          write_rows<false>(HC, kColTile, drow, rvalid, e0, ec, 1.f);
        else
          scatter_rows(HC, kColTile, ridx, rvalid, dkv + e0, CW, ec, 1.f);
      }
    }
    outer_acc<false>(PH, P, nullptr, rvalid, B0, D, P, D, 1.f, dwp2, D);
    colsum(B0, D, D, rvalid, dbp2);
    gemm_rows<true, false, false>(B0, D, p.wp2, D, nullptr, D, P, DPH, P, WS);

    // ---- The gamma MLP backward, in hidden-layer chunks ----
    for (int idx = tid; idx < kRows * D; idx += kThreads) B0[idx] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kColTile) {
      const int hc = min(kColTile, H - h0);
      gemm_rows<false, true, false>(B1, D, p.wa1 + h0, H, p.ba1 + h0, D, hc, HC,
                                    kColTile, WS);
      gemm_rows<true, false, false>(B2, D, p.wa2 + (size_t)h0 * D, D, nullptr, D, hc,
                                    DH, kColTile, WS);
      for (int idx = tid; idx < kRows * kColTile; idx += kThreads) {
        const int c = idx % kColTile;
        if (c < hc && !(HC[idx] > 0.f)) DH[idx] = 0.f;
      }
      outer_acc<false>(HC, kColTile, nullptr, rvalid, B2, D, hc, D, 1.f,
                       dwa2 + (size_t)h0 * D, D);
      outer_acc<false>(B1, D, nullptr, rvalid, DH, kColTile, D, hc, 1.f, dwa1 + h0, H);
      colsum(DH, kColTile, hc, rvalid, dba1 + h0);
      gemm_rows<true, false, true>(DH, kColTile, p.wa1 + h0, H, nullptr, hc, D, B0, D,
                                   WS);
    }
    colsum(B2, D, D, rvalid, dba2);

    // ---- d(q_proj) = sum over the query's k rows of d(hpre) ----
    for (int idx = tid; idx < tq_per * D; idx += kThreads) {
      const int tq = idx / D, c = idx % D, r0 = tq * k;
      if (!rvalid[r0]) continue;
      float s = B0[r0 * D + c];
      for (int j = 1; j < k; ++j) s += B0[(r0 + j) * D + c];
      p.dqproj[((size_t)b * p.N + rq[r0]) * D + c] = s;
    }

    // ---- Everything d(hpre) feeds: dk = -d(hpre), d(theta) ----
    if (!GATHERED && p.premul) {
      scatter_rows(B0, D, ridx, rvalid, dkv, CW, D, -1.f);
    } else {
      outer_acc<true>(nullptr, 0, rrow, rvalid, B0, D, E, D, -1.f, dwk, D);
      for (int e0 = 0; e0 < E; e0 += kColTile) {
        const int ec = min(kColTile, E - e0);
        gemm_rows<true, false, false>(B0, D, p.wk + (size_t)e0 * D, D, nullptr, D,
                                      ec, HC, kColTile, WS);
        if (GATHERED)
          write_rows<true>(HC, kColTile, drow, rvalid, e0, ec, -1.f);
        else
          scatter_rows(HC, kColTile, ridx, rvalid, dkv + e0, CW, ec, -1.f);
      }
    }
    outer_acc<false>(PH, P, nullptr, rvalid, B0, D, P, D, 1.f, dwp2, D);
    colsum(B0, D, D, rvalid, dbp2);
    gemm_rows<true, false, true>(B0, D, p.wp2, D, nullptr, D, P, DPH, P, WS);
    for (int idx = tid; idx < kRows * P; idx += kThreads)
      if (!(PH[idx] > 0.f)) DPH[idx] = 0.f;
    outer_acc<false>(REL, 3, nullptr, rvalid, DPH, P, 3, P, 1.f, dwp1, P);
    colsum(DPH, P, P, rvalid, dbp1);
  }
}

// Sums the slots in a fixed order: the weight block over all B * G slots,
// each example's d(kv) over its own G slots (none in the gathered form,
// MCW = 0).
__global__ void attn_bwd_reduce(const float* __restrict__ part, long long slot,
                                long long W, long long MCW, int B, int G,
                                float* __restrict__ dw, float* __restrict__ dkv) {
  const long long total = W + (long long)B * MCW;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < W) {
      for (int x = 0; x < B * G; ++x) s += part[x * slot + i];
      dw[i] = s;
    } else {
      const long long j = i - W;
      const long long b = j / MCW, o = j % MCW;
      for (int x = 0; x < G; ++x) s += part[(b * G + x) * slot + W + o];
      dkv[j] = s;
    }
  }
}

}  // namespace

extern "C" long long o4d_attn_bwd_smem_bytes(int D, int E, int P) {
  return (long long)(smem_floats(D, E, P) * sizeof(float));
}

// Floats of the reduced weight-gradient block (layout at weight_floats).
extern "C" long long o4d_attn_bwd_weight_floats(int D, int E, int H, int P,
                                                int premul) {
  return weight_floats(D, E, H, P, premul);
}

// Floats of one scratch slot: the weight block plus one example's d(kv).
extern "C" long long o4d_attn_bwd_slot_floats(int M, int D, int E, int H, int P,
                                              int premul) {
  return weight_floats(D, E, H, P, premul) + (long long)M * (premul ? 2 * D : E);
}

// Zeroes the slots, runs the kernel over (G, B) persistent blocks and sums
// the slots into dw (and dkv, index route only).
template <int MODE>
int launch(BwdArgs& a, int B, float* dw, float* dkv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  a.inv_sqrt_d = 1.0f / sqrtf((float)a.D);
  cudaError_t e = cudaMemsetAsync(a.part, 0, (size_t)B * a.G * a.slot * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_floats(a.D, a.E, a.P) * sizeof(float);
  e = cudaFuncSetAttribute(attn_bwd_kernel<MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.G, B);
  attn_bwd_kernel<MODE><<<grid, kThreads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long W = weight_floats(a.D, a.E, a.H, a.P, a.premul);
  const long long MCW = a.slot - W;
  const long long total = W + (long long)B * MCW;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  attn_bwd_reduce<<<(int)(want < 8192 ? want : 8192), threads, 0, s>>>(
      a.part, a.slot, W, MCW, B, a.G, dw, dkv);
  return (int)cudaGetLastError();
}

// Inputs as o4d_attn (csrc/attn.cu) plus g (B, N, D). Outputs: dqproj
// (B, N, D); dw, the weight-gradient block; dkv (B, M, 2D | E). scratch holds
// B * G slots of o4d_attn_bwd_slot_floats(...) floats (zeroed here).
extern "C" int o4d_attn_bwd(const void* qpos, const void* qproj, const void* ki,
                            const void* kpos, const void* kv, const void* wk,
                            const void* wv, const void* wp1, const void* bp1,
                            const void* wp2, const void* bp2, const void* wa1,
                            const void* ba1, const void* wa2, const void* ba2,
                            const void* g, void* dqproj, void* dw, void* dkv,
                            void* scratch, int B, int N, int M, int D, int E,
                            int H, int P, int KS, int k, int premul, int G,
                            void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > kRows || k > KS || G < 1) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
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
  a.g = (const float*)g;
  a.dqproj = (float*)dqproj;
  a.part = (float*)scratch;
  a.slot = o4d_attn_bwd_slot_floats(M, D, E, H, P, premul);
  a.N = N;
  a.M = M;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.KS = KS;
  a.k = k;
  a.premul = premul;
  a.G = G;
  return launch<kIndex>(a, B, (float*)dw, (float*)dkv, stream);
}

// The gathered form: gin (B, KE, N, E + 3) replaces ki, kpos and kv (per-row
// mode); go (B, N, D) is d(out). Outputs: dqproj (B, N, D); dw, the
// weight-gradient block (premul = 0 layout); dg (B, KE, N, E + 3), every
// element written. scratch holds B * G slots of
// o4d_attn_bwd_weight_floats(D, E, H, P, 0) floats (zeroed here).
extern "C" int o4d_attn_g_bwd(const void* qpos, const void* qproj, const void* gin,
                              const void* wk, const void* wv, const void* wp1,
                              const void* bp1, const void* wp2, const void* bp2,
                              const void* wa1, const void* ba1, const void* wa2,
                              const void* ba2, const void* go, void* dqproj,
                              void* dw, void* dg, void* scratch, int B, int N,
                              int D, int E, int H, int P, int KE, int k, int G,
                              void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > kRows || k > KE || G < 1) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.qpos = (const float*)qpos;
  a.qproj = (const float*)qproj;
  a.gin = (const float*)gin;
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
  a.g = (const float*)go;
  a.dqproj = (float*)dqproj;
  a.dg = (float*)dg;
  a.part = (float*)scratch;
  a.slot = weight_floats(D, E, H, P, 0);
  a.N = N;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.KE = KE;
  a.k = k;
  a.premul = 0;
  a.G = G;
  return launch<kGathered>(a, B, (float*)dw, nullptr, stream);
}

// The encoder's fused self-attention backward: inputs as o4d_sattn
// (csrc/attn.cu) plus go (B, N, D) = d(out). Outputs: dq (B, N, D); dw, the
// weight-gradient block (premul = 0 layout); dgf (B, N, k, E), every element
// written. scratch holds B * G slots of o4d_attn_bwd_weight_floats(D, E, H,
// P, 0) floats (zeroed here).
extern "C" int o4d_sattn_bwd(const void* q, const void* gf, const void* rel,
                             const void* wk, const void* wv, const void* wp1,
                             const void* bp1, const void* wp2, const void* bp2,
                             const void* wa1, const void* ba1, const void* wa2,
                             const void* ba2, const void* go, void* dq, void* dw,
                             void* dgf, void* scratch, int B, int N, int D, int E,
                             int H, int P, int k, int G, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > kRows || G < 1) return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
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
  a.g = (const float*)go;
  a.dqproj = (float*)dq;
  a.dg = (float*)dgf;
  a.part = (float*)scratch;
  a.slot = weight_floats(D, E, H, P, 0);
  a.N = N;
  a.D = D;
  a.E = E;
  a.H = H;
  a.P = P;
  a.k = k;
  a.premul = 0;
  a.G = G;
  return launch<kSelf>(a, B, (float*)dw, nullptr, stream);
}
