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
//              rel (B, N, K, 3) read as given instead of qpos - kpos; the
//              same body as o4d_attn (see below).
//
// Function, per query n with neighbours j = ki[n, :k] (f32 throughout):
//   theta_j = W2 relu(W1 (qpos_n - kpos_j) + b1) + b2           (3 -> P -> D)
//   a_j     = (qproj_n - k_j) + theta_j
//   l_j     = (A2 relu(A1 a_j + c1) + c2) / sqrt(D)             (D -> H -> D)
//   out_n   = sum_j softmax_j(l_j) * (v_j + theta_j)   (softmax per channel)
//
// What bounds it on the H100: operations. Per (query, neighbour) row the
// gamma MLP is 2 D H multiply-adds (692k at D = 416, H = 832), plus 2 E D for
// k and v in per-row mode, against a few KB of inputs: 6.5e11 FLOP per
// 32768-query premul chunk, 8.7e11 per gathered cv1 chunk. f32 accuracy on
// the tensor cores takes three TF32 products per product (3xTF32, the
// counterpart of the TPU kernel's Precision.HIGHEST): 3.9 / 5.3 ms at 495
// TFLOP/s.
//
// Design of o4d_attn and o4d_attn_g (PR 1's kernel ran every product on the
// f32 CUDA cores in 32-row tiles, restaging every weight from L2 for each
// 28 useful rows):
//   * the rows go in chunks of whole queries of one example (QC queries, the
//     per-row operands within a budget; o4d_attn_plan), per chunk:
//     load_rows_kernel (rel and F, or premul's k and v rows; shared with the
//     backward), theta's hidden layer and theta on the CUDA cores (FMA chains
//     in k order, the rounding of PR 1's kernel), attn_tile_kernel, then
//     combine_kernel (the softmax over each query's k rows, per channel, in
//     j order, as PR 1's kernel);
//   * the weights are laid out once per call in mma fragment order
//     (frag_b_kernel, frag_a1_kernel), in f32, so that a tile's B operands
//     stream as contiguous slabs and a lane reads its fragment with one 8- or
//     16-byte shared load;
//   * attn_tile_kernel: 64 rows per block of 8 warps. The rows' hpre =
//     (q - k) + theta sit in shared memory (per-row mode: k = F Wk and
//     v = F Wv first, on the tensor cores, v written for the combine); gamma
//     runs in chunks of 128 hidden columns: h^T = relu(A1^T hpre^T + c1)
//     (32 x 32 per warp), h into shared memory, then logits += h A2 with the
//     64 x D logits in registers (2 x 13 n-tiles of 16 x 8 per warp at
//     D 416). h never reaches device memory. Wider decoders (the JAX CLI's
//     --pt_feat_dim and --global_size reach D 448 and 544) run the wide
//     products in column blocks of 416: per-row mode stages each block's
//     hpre in device memory (F stays in shared memory for the next block),
//     and gamma's first layer is recomputed per block, since h (64 x H)
//     does not fit beside the rows; above 448 the ring has two stages.
//     The rows' 64 x max(D, E) floats bound the width at 560. Every
//     product is mma.sync m16n8k8 TF32 in 3xTF32, both operands split into
//     (big, small) TF32 parts as they are read, the tensor core accumulating
//     across the product's whole K (the forward's longest sum is 832 deep at
//     D 416, 1088 at 544, and its gate rtol 1e-3; the backward's per-step
//     f32 sums serve its long weight-gradient sums);
//   * the B operands stream through a 3-stage ring of 26 KB slabs (two
//     above D 448), each one bulk copy by the tensor memory accelerator
//     completing an mbarrier, one block barrier per slab. Splitting the
//     weights once into (big, small) pairs in device memory doubled the
//     bytes every tile streams from L2 (5.5 MB per 64 rows), and the stream
//     then set the pace; in f32 it hides under the products (the same time
//     with the copies left out);
//   * ReLU masks may flip where h is within rounding of zero; in the forward
//     such a flip moves an output by about that rounding.
// Every kernel is row-local, so the index route and the gathered route give
// the same bits on the same rows, and no sum uses atomics.
//
// The bf16 compute mode, o4d_attn_bf16 and o4d_attn_g_bf16 (the TPU
// kernels' compute_dtype=bfloat16, which the engine's precision='fast' runs):
// _mm2 (pallas_attention.py:66) rounds both operands of every product to
// bf16 and sums in f32. Here: the weights are rounded once per call (W1 and
// W2 by the caller, the rest as the fragment kernels lay them out); the row
// loader rounds every value of the key rows, positions included (the TPU
// wrapper rounds its whole value matrix before the gather); theta_kernel<true>
// rounds rel and theta's hidden layer as operands (products of two bf16
// values are exact in f32, so its FMA chains are the plain version's sums);
// the tile rounds F, hpre and h once, as it writes them into shared memory,
// and runs every product as one mma.sync m16n8k16 bf16 per 16-deep step,
// f32 accumulation in the tensor core, no split: six times fewer mma
// instructions than 3xTF32 and a 32-bit fragment register holding two
// operands. The chunking, workspace, slab order and combine are the f32
// mode's; the slabs are 52 KB (half as many barriers per tile), the row
// loader reads 16 bytes a load and the epilogues store column pairs (the
// f32 tile keeps its own). The logits, v, theta, the softmax and every
// output stay f32. Bound: the same operations on the bf16 tensor cores (989
// TFLOP/s): 0.66 ms per premul gv1 chunk; the tile is held back by its
// unhidden row loads and per-slab synchronisation (PERF.md).
//
// o4d_sattn and o4d_sattn_bf16 (the encoder's fused self-attention, f32
// and the bf16 mode that mixed_precision runs) take the same pipeline
// (run_fwd<kSelf, BF16>): no row loader, since gf and rel are already the
// chunk's rows in order (the tile reads F from gf, theta reads rel, each
// rounded where _mm2 rounds it in the bf16 mode); theta in one kernel
// (theta_kernel, which repeats the f32 mode's FMA chains without the ph
// round trip); then the tile and the combine. The encoder's widths (D = E
// = 36 / 72 / 144 / 288 at K 16, H = 2 D, P 32) are far below the
// decoder's 416 columns, so the tile's column block is a template
// parameter (NTW n-tiles of 8 columns a warp, 32 NTW columns a block): 64
// columns at D 36, 96 at 72, 160 at 144, 288 at 288 (320 at 320); the
// decoder keeps its 416-column instantiation and its instruction stream.
// A narrow block's slab holds more k8 steps of a wide product (26 KB, 52 KB
// in bf16, from 160 columns up); the 64- and 96-column blocks, whose short
// tiles were latency-bound at one block per SM, take 16 KB slabs (one or two
// per product at D 36) and run two blocks per SM. theta's
// kernel widens its row groups at narrow D to keep its threads busy. The
// hidden chunk stays 128 (gamma's first layer, 4 x 32 hidden columns by
// warp): at H 72 a quarter of its warps idle in it (PERF.md). Bound at the
// gv1 blocks: operations, 73 GFLOP over the four blocks (0.105 ms on the
// bf16 tensor cores, 0.44 ms in 3xTF32); the rows' round trips through
// the chunk workspace (th, v and the logits, about 0.8 GB at D 36) come
// beside it. (A body of its own, 32-row tiles with every product an f32
// CUDA-core loop over weight tiles restaged from L2, 128 columns at every
// width, took 9.8 ms over the four blocks; PERF.md.)

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

// ================================================= o4d_attn / o4d_attn_g ==
constexpr int kFwdThreads = 256;  // 8 warps: 2 (rows or hidden columns) x 4
constexpr int kTileRows = 64;
constexpr int kHC = 128;          // gamma's hidden columns per chunk
constexpr int kHK8 = kHC / 8;     // k8 steps of gamma's second layer per chunk
constexpr int kWarpsM = kFwdThreads / 32 / 4;  // warps along the rows in a wide product (2)
constexpr int kMT = kTileRows / 16 / kWarpsM;  // a warp's m-tiles in a wide product (2)
// Gamma's first layer: 4 warps along the hidden columns x 2 along the rows,
// each warp 32 x 32 (2 hidden m-tiles x 4 row n-tiles).
constexpr int kMT1 = 2, kNT1 = 4;
// The wide products (k, v and the logits) run in column blocks of 32 NTW
// columns: 4 warps along the columns, each with NTW n-tiles of 8 columns,
// keep a block's 64 x 32 NTW sums in registers (the tile's template
// parameter NTW; tile_ntw picks it from D). The decoder's block is 416
// columns (NTW 13); wider decoders loop over such blocks (see
// attn_tile_kernel), narrower widths (the encoder's self-attention, D 36 to
// 320) take the narrowest block that holds D.
constexpr int kDecoderNTW = 13;
constexpr int kColBlock = 32 * kDecoderNTW;  // 416: the widest column block
constexpr int kSlab = kColBlock / 8 * 32 * 4;  // floats per ring stage, every width: two
                                                // k8 steps of a 416-column block
constexpr int kA1Step = (kHC / 16) * 32 * 4;  // floats of one k8 step of an A1 chunk
constexpr int kA1Steps = kSlab / kA1Step;     // A1 k8 steps per slab (6)
constexpr int kLdH = kHC + 4;  // the h chunk [row][column]; 4 mod 32: no conflicts
// Shared memory one block may use (the H100's opt-in limit), less room for
// the static mbarriers.
constexpr int kSmemOptin = 232448;
constexpr int kSmemDynMax = kSmemOptin - 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared floats of attn_tile_kernel with a ring of `stages` slabs: the rows
// (F, then hpre), the h chunk, the ring. Row strides are 4 mod 8, so
// fragment reads hit 32 distinct banks.
size_t tile_smem_floats(int D, int E, int stages) {
  const int W = 8 * max(cdiv(D, 8), cdiv(E, 8));
  return (size_t)kTileRows * (W + 4) + (size_t)kTileRows * kLdH + (size_t)stages * kSlab;
}

// Three ring stages where they fit (every width up to 448), else two.
int tile_stages(int D, int E) {
  return tile_smem_floats(D, E, 3) * sizeof(float) <= (size_t)kSmemDynMax ? 3 : 2;
}

// The widest D or E the tile takes: the rows of 64 x max(D, E) floats beside
// the h chunk and a two-stage ring fill the shared memory at 560.
constexpr int kMaxWidth =
    ((kSmemDynMax / 4 - kTileRows * kLdH - 2 * kSlab) / kTileRows - 4) / 8 * 8;
static_assert(kMaxWidth == 560, "the shared-memory width limit moved");

// The column blocks narrower than 416 (NTW n-tiles a warp), each an
// instantiation of the tile: 64, 96, 160, 288 and 320 columns, the
// encoder's widths at feature sizes 36 and 40 (D 36 / 72 / 144 / 288 and
// 40 / 80 / 160 / 320). Every other D up to 416 takes the next wider block.
constexpr int kNarrowNTW[] = {2, 3, 5, 9, 10};

int tile_ntw(int D) {
  for (const int w : kNarrowNTW)
    if (32 * w >= D) return w;
  return kDecoderNTW;
}

// The bf16 mode (o4d_attn_bf16 / o4d_attn_g_bf16): the rows and the h chunk
// in shared memory as bf16, row strides 8 mod 16 elements (4 mod 8 words),
// so that a lane's 32-bit fragment reads hit 32 distinct banks; the same
// slab ring, each slab holding twice the depth (16-deep steps).
// A bf16 slab is twice the f32 one (52 KB: four 16-deep steps of a wide B,
// thirteen of A1): the per-slab barrier, wait and bookkeeping weigh more
// against a bf16 step's few instructions (PERF.md).
constexpr int kLdHB = kHC + 8;  // the bf16 h chunk [row][column]
constexpr int kSlabBf16 = 2 * kSlab;
// The smallest column blocks (64 and 96 columns: the encoder's first two
// levels, whose tiles are short and latency-bound) take 16 KB slabs in both
// modes (every product of a D 36 tile still fits one or two of them) and
// two blocks per SM, whose row loads and slab waits then hide each other.
constexpr int kSmallNTW = 3;
constexpr int kSlabSmall = 4096;

__host__ __device__ constexpr int slab_floats(int ntw, bool bf16) {
  return ntw <= kSmallNTW ? kSlabSmall : bf16 ? kSlabBf16 : kSlab;
}

size_t tile_smem_bytes(int D, int E, int stages, bool bf16, int slab) {
  if (!bf16) {
    const int W = 8 * max(cdiv(D, 8), cdiv(E, 8));
    return sizeof(float) * ((size_t)kTileRows * (W + 4) + (size_t)kTileRows * kLdH +
                            (size_t)stages * slab);
  }
  const int W = 16 * max(cdiv(D, 16), cdiv(E, 16));
  return 2 * ((size_t)kTileRows * (W + 8) + (size_t)kTileRows * kLdHB) +
         sizeof(float) * (size_t)stages * slab;
}

// The bf16 ring: three stages where they fit (every width up to 416), else
// two (the depth measured within 4% either way; PERF.md).
int tile_stages_bf16(int D, int E) {
  return tile_smem_bytes(D, E, 3, true, kSlabBf16) <= (size_t)kSmemDynMax ? 3 : 2;
}

// B (K x N, row-major) in mma B-fragment order per column block of 8 NT
// columns, zero past K and N: float2 ((cb KB + kb) NT + nt) 32 + lane,
// lane = 4 gq + tq, holds b0 = B[8 kb + tq][n] and b1 = B[8 kb + tq + 4][n],
// n = 8 (cb NT + nt) + gq.
__global__ void frag_b_kernel(const float* __restrict__ B, int K, int N, int KB, int NT,
                              int NCB, float2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)NCB * KB * NT * 32) return;
  const int lane = (int)(i & 31), t = (int)(i >> 5), nt = t % NT, kb = (t / NT) % KB;
  const int cb = t / NT / KB;
  const int n = 8 * (cb * NT + nt) + (lane >> 2), k0 = 8 * kb + (lane & 3), k1 = k0 + 4;
  out[i] = make_float2(k0 < K && n < N ? B[(size_t)k0 * N + n] : 0.f,
                       k1 < K && n < N ? B[(size_t)k1 * N + n] : 0.f);
}

// A1 (D x H) transposed, in chunks of kHC hidden columns, in mma A-fragment
// order, zero past D and H: for chunk c, k8 step kb and m-tile mt (hidden
// columns h = kHC c + 16 mt + gq and h + 8), float4 ((c D8 + kb) kHC / 16 +
// mt) 32 + lane holds a0 = A1[8 kb + tq][h], a1 = A1[8 kb + tq][h + 8],
// a2 = A1[8 kb + tq + 4][h], a3 = A1[8 kb + tq + 4][h + 8].
__global__ void frag_a1_kernel(const float* __restrict__ A1, int D, int H, int D8, int NC,
                               float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int MT = kHC / 16;  // m-tiles of a chunk
  if (i >= (long long)NC * D8 * MT * 32) return;
  const int lane = (int)(i & 31), u = (int)(i >> 5);  // u = (c D8 + kb) MT + mt
  const int mt = u % MT, kb = (u / MT) % D8, c = (u / MT) / D8;
  const int h = c * kHC + 16 * mt + (lane >> 2), d = 8 * kb + (lane & 3);
  float v[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int hh = h + 8 * (x & 1), dd = d + 4 * (x >> 1);
    v[x] = dd < D && hh < H ? A1[(size_t)dd * H + hh] : 0.f;
  }
  out[i] = make_float4(v[0], v[1], v[2], v[3]);
}

// Two f32 values rounded to bf16 in one 32-bit register, lo in the low half
// (the lower k or column index of an mma fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// frag_b_kernel's counterpart for mma.sync m16n8k16 bf16, 16-deep steps:
// uint2 ((cb KB + kb) NT + nt) 32 + lane holds {B[k][n], B[k + 1][n]} and
// {B[k + 8][n], B[k + 9][n]}, k = 16 kb + 2 tq, n = 8 (cb NT + nt) + gq,
// rounded to bf16 (the weights' one rounding), zero past K and N.
__global__ void frag_b_bf16_kernel(const float* __restrict__ B, int K, int N, int KB, int NT,
                                   int NCB, uint2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)NCB * KB * NT * 32) return;
  const int lane = (int)(i & 31), t = (int)(i >> 5), nt = t % NT, kb = (t / NT) % KB;
  const int cb = t / NT / KB;
  const int n = 8 * (cb * NT + nt) + (lane >> 2), k = 16 * kb + 2 * (lane & 3);
  auto at = [&](int kk) { return kk < K && n < N ? B[(size_t)kk * N + n] : 0.f; };
  out[i] = make_uint2(pack_bf16(at(k), at(k + 1)), pack_bf16(at(k + 8), at(k + 9)));
}

// frag_a1_kernel's counterpart for m16n8k16 bf16: A1^T per chunk of kHC
// hidden columns, 16-deep steps; uint4 ((c D16 + kb) kHC / 16 + mt) 32 + lane
// holds a0 = {A1[d][h], A1[d + 1][h]}, a1 = the same at h + 8, a2 = at d + 8,
// a3 = at d + 8 and h + 8, with h = kHC c + 16 mt + gq, d = 16 kb + 2 tq;
// rounded to bf16, zero past D and H.
__global__ void frag_a1_bf16_kernel(const float* __restrict__ A1, int D, int H, int D16, int NC,
                                    uint4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int MT = kHC / 16;
  if (i >= (long long)NC * D16 * MT * 32) return;
  const int lane = (int)(i & 31), u = (int)(i >> 5);
  const int mt = u % MT, kb = (u / MT) % D16, c = (u / MT) / D16;
  const int h = c * kHC + 16 * mt + (lane >> 2), d = 16 * kb + 2 * (lane & 3);
  auto at = [&](int dd, int hh) { return dd < D && hh < H ? A1[(size_t)dd * H + hh] : 0.f; };
  out[i] = make_uint4(pack_bf16(at(d, h), at(d + 1, h)), pack_bf16(at(d, h + 8), at(d + 1, h + 8)),
                      pack_bf16(at(d + 8, h), at(d + 9, h)),
                      pack_bf16(at(d + 8, h + 8), at(d + 9, h + 8)));
}

// The ring's bulk copies (TMA, cp.async.bulk) and their mbarriers.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// dst <- bytes from src by the tensor memory accelerator; the mbarrier
// completes its phase once they have landed.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the mbarrier's phase of the given parity; a copy that never
// lands fails the launch (trap) instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (spin > (1LL << 26)) __trap();
  }
}

struct TileArgs {
  const float* q;   // (nq, D): the chunk's projected queries
  const float* th;  // (R, D) theta
  const float* kk;  // premul: (R, D) the rows' k
  const float* f;   // per-row: (R, E) the rows' features
  float* vv;        // per-row: (R, D) v = F Wv, written here
  float* lg;        // (R, D) the logits before c2 and 1 / sqrt(D), written here
  const float* wv;  // per-row: Wv and Wk in fragment order (frag_b_kernel, per column block)
  const float* wk;
  const float* a1;  // A1 in fragment order (frag_a1_kernel)
  const float* a2;  // A2 in fragment order (frag_b_kernel, K padded to whole chunks, per
                    // column block)
  const float* c1;  // (H)
  int R, D, E, H, k, premul;
};

template <int NTW>
__device__ __forceinline__ void zero_acc(float (&acc)[kMT][NTW][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;
}

// acc (the warp's rows 16 kMT wm + [0, 16 kMT) x its NTW n-tiles nt0 + i) +=
// A (the tile's rows, row stride lda; k8 steps k8 ... k8 + steps - 1) times
// `steps` k8 steps of a B slab (4 NTW n-tiles a step), both split into TF32
// (big, small) as they are read.
// The mma order is pass-major within groups of n-tiles (all small_a big_b
// products of the group, then big_a small_b, then big_a big_b), so that an
// accumulator's next product is 2 x group instructions away: the tensor
// core's latency is hidden by independent products, not by other warps.
template <int NTW>
__device__ __forceinline__ void wide_steps(float (&acc)[kMT][NTW][4], const float* A, int lda,
                                           int k8, const float* slab, int steps, int nt0,
                                           int wm, int lane) {
  constexpr int G = 7;  // n-tiles whose fragments are held at once
  const int gq = lane >> 2, tq = lane & 3;
  for (int kb = 0; kb < steps; ++kb) {
    uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = (wm * kMT + mt) * 16 + gq + 8 * (h & 1);
        const int kx = 8 * (k8 + kb) + tq + 4 * (h >> 1);
        split_tf32(A[m * lda + kx], ab[mt][h], as[mt][h]);
      }
    const float2* bs =
        reinterpret_cast<const float2*>(slab) + ((size_t)kb * 4 * NTW + nt0) * 32 + lane;
#pragma unroll
    for (int g0 = 0; g0 < NTW; g0 += G) {
      uint32_t bb[G][2], bsm[G][2];
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (g0 + i < NTW) {
          const float2 w = bs[(g0 + i) * 32];
          split_tf32(w.x, bb[i][0], bsm[i][0]);
          split_tf32(w.y, bb[i][1], bsm[i][1]);
        }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (g0 + i < NTW)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_tf32<false>(acc[mt][g0 + i], pass == 0 ? as[mt] : ab[mt],
                              pass == 1 ? bsm[i] : bb[i]);
    }
  }
}

// acc (the warp's hidden columns 32 wm + [0, 32) x rows 32 wn + [0, 32)) +=
// A1^T (a slab of `steps` k8 steps) times hpre^T (the tile's rows X, row
// stride ldx, k8 steps from k8), both split as they are read; pass-major
// mma order as in wide_steps.
__device__ __forceinline__ void g1_steps(float (&acc)[kMT1][kNT1][4], const float* slab, int steps,
                                         const float* X, int ldx, int k8, int wm, int wn,
                                         int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kb = 0; kb < kA1Steps; ++kb) {  // unrolled: loads run ahead of products
    if (kb >= steps) break;
    uint32_t ab[kMT1][4], as[kMT1][4];
#pragma unroll
    for (int mt = 0; mt < kMT1; ++mt) {
      const float4 a =
          reinterpret_cast<const float4*>(slab)[((size_t)kb * (kHC / 16) + wm * kMT1 + mt) * 32 +
                                                lane];
      split_tf32(a.x, ab[mt][0], as[mt][0]);
      split_tf32(a.y, ab[mt][1], as[mt][1]);
      split_tf32(a.z, ab[mt][2], as[mt][2]);
      split_tf32(a.w, ab[mt][3], as[mt][3]);
    }
    uint32_t bb[kNT1][2], bsm[kNT1][2];
#pragma unroll
    for (int nt = 0; nt < kNT1; ++nt) {
      const float* row = X + (wn * 8 * kNT1 + nt * 8 + gq) * ldx + 8 * (k8 + kb) + tq;
      split_tf32(row[0], bb[nt][0], bsm[nt][0]);
      split_tf32(row[4], bb[nt][1], bsm[nt][1]);
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int mt = 0; mt < kMT1; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT1; ++nt)
          mma_tf32<false>(acc[mt][nt], pass == 0 ? as[mt] : ab[mt],
                          pass == 1 ? bsm[nt] : bb[nt]);
  }
}

// c += a b, one m16n8k16 bf16 tensor-core product with f32 accumulation:
// one instruction per 16-deep step, no split.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wide_steps in the bf16 mode: A (the tile's bf16 rows, row stride lda
// elements) times `steps` 16-deep steps of a bf16 B slab, from step k16; a
// lane's A and B fragments are 32-bit and 64-bit shared loads.
template <int NTW>
__device__ __forceinline__ void wide_steps_bf16(float (&acc)[kMT][NTW][4],
                                                const __nv_bfloat16* A, int lda, int k16,
                                                const float* slab, int steps, int nt0, int wm,
                                                int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  for (int kb = 0; kb < steps; ++kb) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = (wm * kMT + mt) * 16 + gq + 8 * (h & 1);
        const int kx = 16 * (k16 + kb) + 2 * tq + 8 * (h >> 1);
        a[mt][h] = *reinterpret_cast<const uint32_t*>(A + m * lda + kx);
      }
    const uint2* bs =
        reinterpret_cast<const uint2*>(slab) + ((size_t)kb * 4 * NTW + nt0) * 32 + lane;
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const uint2 w = bs[i * 32];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][i], a[mt], w.x, w.y);
    }
  }
}

// g1_steps in the bf16 mode: A1^T from a bf16 slab (one 16-byte load per
// m-tile) times hpre^T (the tile's bf16 rows X, row stride ldx elements).
template <int kMaxSteps>
__device__ __forceinline__ void g1_steps_bf16(float (&acc)[kMT1][kNT1][4], const float* slab,
                                              int steps, const __nv_bfloat16* X, int ldx, int k16,
                                              int wm, int wn, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kb = 0; kb < kMaxSteps; ++kb) {
    if (kb >= steps) break;
    uint32_t a[kMT1][4];
#pragma unroll
    for (int mt = 0; mt < kMT1; ++mt) {
      const uint4 v =
          reinterpret_cast<const uint4*>(slab)[((size_t)kb * (kHC / 16) + wm * kMT1 + mt) * 32 +
                                               lane];
      a[mt][0] = v.x, a[mt][1] = v.y, a[mt][2] = v.z, a[mt][3] = v.w;
    }
    uint32_t b[kNT1][2];
#pragma unroll
    for (int nt = 0; nt < kNT1; ++nt) {
      const __nv_bfloat16* row = X + (wn * 8 * kNT1 + nt * 8 + gq) * ldx + 16 * (k16 + kb) + 2 * tq;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(row);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(row + 8);
    }
#pragma unroll
    for (int mt = 0; mt < kMT1; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT1; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// A value into the tile's rows: f32 as is, or rounded once to bf16.
template <typename T>
__device__ __forceinline__ T to_row(float v) {
  if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// d[0] = a and d[1] = b for the columns n, n + 1 below `limit`, as one
// 8-byte store where both are (d 8-byte aligned when `even`).
__device__ __forceinline__ void store_pair(float* d, int n, int limit, bool even, float a,
                                           float b) {
  if (even && n + 1 < limit) {
    *reinterpret_cast<float2*>(d) = make_float2(a, b);
  } else {
    if (n < limit) d[0] = a;
    if (n + 1 < limit) d[1] = b;
  }
}

// One B slab of the tile's stream: its source, k8 steps and bytes.
struct Slab {
  const float* src;
  int steps;
  uint32_t bytes;
};

// The tile's rows r0 ... r0 + 63 of the chunk: per-row mode k and v on the
// tensor cores, hpre, gamma, the logits (the design at the top of the file).
// The wide products run per column block of 32 NTW columns (zero past D;
// the narrow blocks hold all of D). Above one block (D > 416), per-row mode stages each block's hpre in the tile's
// own rows of lg (F must stay in shared memory for the next block's k and v)
// and reloads it whole, and gamma's first layer is recomputed per column
// block: the softmax is per channel, so the blocks' logits are independent
// once h is known, and h (64 x H) does not fit beside the rows.
// BF16: the bf16 compute mode. F, hpre and h are rounded to bf16 once, as
// they are written into shared memory (where the TPU kernel casts each
// product's operand), every product is one m16n8k16 bf16 mma per 16-deep
// step with f32 accumulation, and the slabs hold the weights rounded to
// bf16 in that mma's fragment order (frag_b_bf16_kernel,
// frag_a1_bf16_kernel). The variables named for 8-deep steps (D8, k8, ...)
// count 16-deep steps there; the slab stream is otherwise the same.
template <int kFwdStages, bool BF16, int NTW>
__global__ void __launch_bounds__(kFwdThreads, NTW <= kSmallNTW ? 2 : 1)
    attn_tile_kernel(TileArgs p) {
  using T = std::conditional_t<BF16, __nv_bfloat16, float>;  // the rows' type
  constexpr int KD = BF16 ? 16 : 8;                          // depth of one step
  constexpr int kLdHT = BF16 ? kLdHB : kLdH;
  constexpr int kHK = kHC / KD;  // steps of gamma's second layer per chunk
  constexpr int kSlabT = slab_floats(NTW, BF16);  // floats per ring stage
  // Four-column row loads and column-pair epilogues: the bf16 mode's, and
  // the narrow blocks' in f32 too (the decoder's f32 tile keeps its own).
  constexpr bool kPairs = BF16 || NTW != kDecoderNTW;
  constexpr int kA1S = kSlabT / kA1Step;            // A1 steps per slab
  extern __shared__ __align__(16) float smf[];
  __shared__ __align__(8) uint64_t full[kFwdStages];  // a slab has landed in the stage
  constexpr int NT = 4 * NTW;  // n-tiles of a column block
  constexpr int kCB = 8 * NT;  // its columns
  const int D = p.D, E = p.E, H = p.H;
  const int D8 = cdiv(D, KD), E8 = cdiv(E, KD), NC = cdiv(H, kHC), NCB = cdiv(D, kCB);
  const int W8 = KD * max(D8, E8), ldx = W8 + (BF16 ? 8 : 4);
  T* X = reinterpret_cast<T*>(smf);    // F (per-row mode), then hpre
  T* Hs = X + kTileRows * ldx;         // h chunk [row][hidden column]
  float* ring = reinterpret_cast<float*>(Hs + kTileRows * kLdHT);  // kFwdStages B slabs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3, nt0 = wn * NTW;
  const int r0 = blockIdx.x * kTileRows, rows = min(kTileRows, p.R - r0);
  const bool perrow = !p.premul;

  // The B slabs in stream order: per-row mode's Wv then Wk (nw each) per
  // column block, then per column block and hidden chunk A1's (n1) and A2's
  // (n2; the last chunk's K8L k8 steps in n2l).
  constexpr int kbw = kSlabT / (NT * 64);  // k8 steps per slab of a wide B
  const int nw = perrow ? cdiv(E8, kbw) : 0;
  const int K8L = cdiv(H - (NC - 1) * kHC, KD);
  const int n1 = cdiv(D8, kA1S), n2 = cdiv(kHK, kbw), n2l = cdiv(K8L, kbw);
  const int per_cb = (NC - 1) * (n1 + n2) + n1 + n2l;  // gamma's slabs per column block
  const int total = NCB * (2 * nw + per_cb);
  auto slab = [&](int s) {
    Slab x;
    if (s < NCB * 2 * nw) {
      const int cb = s / (2 * nw), r = s - cb * 2 * nw;
      const int i = r < nw ? r : r - nw;
      x.steps = min(kbw, E8 - i * kbw);
      x.src = (r < nw ? p.wv : p.wk) + ((size_t)cb * E8 + (size_t)i * kbw) * NT * 64;
      x.bytes = x.steps * NT * 64 * 4;
      return x;
    }
    s -= NCB * 2 * nw;
    const int cb = s / per_cb;
    s -= cb * per_cb;
    const int c = min(s / (n1 + n2), NC - 1), i = s - c * (n1 + n2);
    if (i < n1) {
      x.steps = min(kA1S, D8 - i * kA1S);
      x.src = p.a1 + ((size_t)c * D8 + i * kA1S) * kA1Step;
      x.bytes = x.steps * kA1Step * 4;
    } else {
      const int j = i - n1;
      x.steps = min(kbw, (c < NC - 1 ? kHK : K8L) - j * kbw);
      x.src = p.a2 + ((size_t)(cb * NC + c) * kHK + j * kbw) * NT * 64;
      x.bytes = x.steps * NT * 64 * 4;
    }
    return x;
  };
  // Thread 0 issues slab s into its stage as one bulk copy.
  auto load = [&](int s) {
    const Slab x = slab(s);
    bulk_load(ring + (s % kFwdStages) * kSlabT, x.src, x.bytes, &full[s % kFwdStages]);
  };
  int s_next = 0;  // the next slab to consume
  // One barrier (every warp is done with the stage the refill overwrites),
  // the refill, then the wait for the next slab, which it returns.
  auto acquire = [&](int& steps) {
    __syncthreads();
    if (tid == 0 && s_next + kFwdStages - 1 < total) load(s_next + kFwdStages - 1);
    mbar_wait(&full[s_next % kFwdStages], (s_next / kFwdStages) & 1);
    steps = slab(s_next).steps;
    const float* r = ring + (s_next % kFwdStages) * kSlabT;
    ++s_next;
    return r;
  };

  if (tid == 0) {
    for (int i = 0; i < kFwdStages; ++i) mbar_init(&full[i]);
    fence_mbar_init();
    for (int i = 0; i < kFwdStages - 1 && i < total; ++i) load(i);
  }

  // The tile's rows: F (per-row), or hpre = (q - k) + theta (premul); zero
  // past the widths and past the chunk's rows.
  if constexpr (kPairs) {
    // Four columns a thread, 16-byte loads where aligned, the query row
    // once per four (32-bit: a chunk has fewer than 2^31 rows); one 8-byte
    // store of the four rounded values. (The f32 mode's per-element loop
    // with its 64-bit division took a third of this tile's time.)
    const int W4 = W8 / 4;
    const bool vec = perrow ? E % 4 == 0 && ((uintptr_t)p.f & 15) == 0
                            : D % 4 == 0 && (((uintptr_t)p.q | (uintptr_t)p.kk |
                                              (uintptr_t)p.th) & 15) == 0;
    for (int idx = tid; idx < kTileRows * W4; idx += kFwdThreads) {
      const int r = idx / W4, c = 4 * (idx - r * W4);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) {
        const int row = r0 + r;
        if (perrow) {
          const float* f = p.f + (size_t)row * E + c;
          if (vec && c + 4 <= E) {
            const float4 x = *reinterpret_cast<const float4*>(f);
            v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
          } else {
            for (int u = 0; u < 4; ++u)
              if (c + u < E) v[u] = f[u];
          }
        } else {
          const float* q = p.q + (size_t)(row / p.k) * D + c;
          const float* kk = p.kk + (size_t)row * D + c;
          const float* th = p.th + (size_t)row * D + c;
          if (vec && c + 4 <= D) {
            const float4 a = *reinterpret_cast<const float4*>(q);
            const float4 b = *reinterpret_cast<const float4*>(kk);
            const float4 t = *reinterpret_cast<const float4*>(th);
            v[0] = (a.x - b.x) + t.x, v[1] = (a.y - b.y) + t.y;
            v[2] = (a.z - b.z) + t.z, v[3] = (a.w - b.w) + t.w;
          } else {
            for (int u = 0; u < 4; ++u)
              if (c + u < D) v[u] = (q[u] - kk[u]) + th[u];
          }
        }
      }
      if constexpr (BF16)
        *reinterpret_cast<uint2*>(X + r * ldx + c) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      else
        *reinterpret_cast<float4*>(X + r * ldx + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int idx = tid; idx < kTileRows * W8; idx += kFwdThreads) {
      const int r = idx / W8, c = idx - r * W8;
      float v = 0.f;
      if (r < rows) {
        const size_t row = (size_t)(r0 + r);
        if (perrow) {
          if (c < E) v = p.f[row * E + c];
        } else if (c < D) {
          v = (p.q[(row / p.k) * D + c] - p.kk[row * D + c]) + p.th[row * D + c];
        }
      }
      X[r * ldx + c] = to_row<T>(v);
    }
  }
  // The pair epilogues (kPairs): a thread's accumulator pairs (c, c + 1) are columns n,
  // n + 1 of one row, stored as 8-byte pairs; hpre's query row in 32 bits.
  const bool evenD = (D & 1) == 0;
  auto hpre_pair = [&](int m, int n, float a0, float a1, float& v0, float& v1) {
    const int row = r0 + m;
    const float* q = p.q + (size_t)(row / p.k) * D;
    const float* th = p.th + (size_t)row * D;
    v0 = n < D ? (q[n] - a0) + th[n] : 0.f;
    v1 = n + 1 < D ? (q[n + 1] - a1) + th[n + 1] : 0.f;
  };

  float acc[kMT][NTW][4];
  // The wide product of the tile's rows A (row stride lda) with `steps`
  // steps of slab b from step k8.
  auto wide = [&](const T* A, int lda, int k8, const float* b, int steps) {
    if constexpr (BF16)
      wide_steps_bf16(acc, A, lda, k8, b, steps, nt0, wm, lane);
    else
      wide_steps(acc, A, lda, k8, b, steps, nt0, wm, lane);
  };
  int steps;
  if (perrow) {
    for (int cb = 0; cb < NCB; ++cb) {
      const int col0 = cb * kCB;
      for (int which = 0; which < 2; ++which) {  // 0: v = F Wv; 1: k = F Wk.
        zero_acc(acc);
        for (int i = 0, k8 = 0; i < nw; ++i, k8 += steps) {
          const float* b = acquire(steps);
          wide(X, ldx, k8, b, steps);
        }
        if (which == 0 && kPairs) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int i = 0; i < NTW; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int m = (wm * kMT + mt) * 16 + gq + 8 * h;
                const int n = col0 + 8 * (nt0 + i) + 2 * tq;
                if (m < rows)
                  store_pair(p.vv + (size_t)(r0 + m) * D + n, n, D, evenD, acc[mt][i][2 * h],
                             acc[mt][i][2 * h + 1]);
              }
        } else if (which == 0) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int i = 0; i < NTW; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int m = (wm * kMT + mt) * 16 + gq + 8 * (c >> 1);
                const int n = col0 + 8 * (nt0 + i) + 2 * tq + (c & 1);
                if (m < rows && n < D) p.vv[(size_t)(r0 + m) * D + n] = acc[mt][i][c];
              }
        }
      }
      if (NCB > 1 && kPairs) {  // this block's hpre into the tile's rows of lg.
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < NTW; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = (wm * kMT + mt) * 16 + gq + 8 * h;
              const int n = col0 + 8 * (nt0 + i) + 2 * tq;
              if (m < rows) {
                float v0, v1;
                hpre_pair(m, n, acc[mt][i][2 * h], acc[mt][i][2 * h + 1], v0, v1);
                store_pair(p.lg + (size_t)(r0 + m) * D + n, n, D, evenD, v0, v1);
              }
            }
      } else if (NCB > 1) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < NTW; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int m = (wm * kMT + mt) * 16 + gq + 8 * (c >> 1);
              const int n = col0 + 8 * (nt0 + i) + 2 * tq + (c & 1);
              if (m < rows && n < D) {
                const size_t row = (size_t)(r0 + m);
                p.lg[row * D + n] = (p.q[(row / p.k) * D + n] - acc[mt][i][c]) + p.th[row * D + n];
              }
            }
      }
    }
    __syncthreads();  // every warp is done reading F (and its hpre stores are visible).
    if (NCB > 1) {
      for (int idx = tid; idx < kTileRows * KD * D8; idx += kFwdThreads) {
        const int m = idx / (KD * D8), n = idx - m * KD * D8;
        X[m * ldx + n] = to_row<T>(m < rows && n < D ? p.lg[(size_t)(r0 + m) * D + n] : 0.f);
      }
    } else if constexpr (kPairs) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (wm * kMT + mt) * 16 + gq + 8 * h;
            const int n = 8 * (nt0 + i) + 2 * tq;
            if (n < KD * D8) {  // GEMM1 reads hpre's D8 steps (n even: n + 1 too).
              float v0 = 0.f, v1 = 0.f;
              if (m < rows) hpre_pair(m, n, acc[mt][i][2 * h], acc[mt][i][2 * h + 1], v0, v1);
              if constexpr (BF16)
                *reinterpret_cast<uint32_t*>(X + m * ldx + n) = pack_bf16(v0, v1);
              else
                *reinterpret_cast<float2*>(X + m * ldx + n) = make_float2(v0, v1);
            }
          }
    } else {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = (wm * kMT + mt) * 16 + gq + 8 * (c >> 1);
            const int n = 8 * (nt0 + i) + 2 * tq + (c & 1);
            if (n < KD * D8) {  // GEMM1 reads hpre's D8 steps.
              float v = 0.f;
              if (m < rows && n < D) {
                const size_t row = (size_t)(r0 + m);
                v = (p.q[(row / p.k) * D + n] - acc[mt][i][c]) + p.th[row * D + n];
              }
              X[m * ldx + n] = to_row<T>(v);
            }
          }
    }
  }

  // gamma, per column block: per chunk of kHC hidden columns, h = relu(hpre
  // A1 + c1) into Hs, then the block's logits += h A2 over the chunk's valid
  // columns. A warp whose hidden columns all lie past H in the last chunk
  // skips its products.
  const int w1m = warp >> 1, w1n = warp & 1;  // gamma's first layer: 4 x 2 warps
  for (int cb = 0; cb < NCB; ++cb) {
    const int col0 = cb * kCB;
    zero_acc(acc);
    for (int c = 0; c < NC; ++c) {
      const bool live = c * kHC + w1m * 16 * kMT1 < H;
      float acc1[kMT1][kNT1][4];
#pragma unroll
      for (int mt = 0; mt < kMT1; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT1; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc1[mt][nt][x] = 0.f;
      for (int i = 0, k8 = 0; i < n1; ++i, k8 += steps) {
        const float* a = acquire(steps);
        if (live) {
          if constexpr (BF16)
            g1_steps_bf16<kA1S>(acc1, a, steps, X, ldx, k8, w1m, w1n, lane);
          else
            g1_steps(acc1, a, steps, X, ldx, k8, w1m, w1n, lane);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT1; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT1; ++nt) {
          const int hc = (w1m * kMT1 + mt) * 16 + gq, row = w1n * 8 * kNT1 + nt * 8 + 2 * tq;
          const int h = c * kHC + hc;
          const float b0 = h < H ? p.c1[h] : 0.f, b1 = h + 8 < H ? p.c1[h + 8] : 0.f;
          Hs[row * kLdHT + hc] = to_row<T>(fmaxf(acc1[mt][nt][0] + b0, 0.f));
          Hs[(row + 1) * kLdHT + hc] = to_row<T>(fmaxf(acc1[mt][nt][1] + b0, 0.f));
          Hs[row * kLdHT + hc + 8] = to_row<T>(fmaxf(acc1[mt][nt][2] + b1, 0.f));
          Hs[(row + 1) * kLdHT + hc + 8] = to_row<T>(fmaxf(acc1[mt][nt][3] + b1, 0.f));
        }
      for (int i = 0, k8 = 0; i < (c < NC - 1 ? n2 : n2l); ++i, k8 += steps) {
        const float* b = acquire(steps);
        wide(Hs, kLdHT, k8, b, steps);
      }
    }
    if constexpr (kPairs) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (wm * kMT + mt) * 16 + gq + 8 * h;
            const int n = col0 + 8 * (nt0 + i) + 2 * tq;
            if (m < rows)
              store_pair(p.lg + (size_t)(r0 + m) * D + n, n, D, evenD, acc[mt][i][2 * h],
                         acc[mt][i][2 * h + 1]);
          }
    } else {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = (wm * kMT + mt) * 16 + gq + 8 * (c >> 1);
            const int n = col0 + 8 * (nt0 + i) + 2 * tq + (c & 1);
            if (m < rows && n < D) p.lg[(size_t)(r0 + m) * D + n] = acc[mt][i][c];
          }
    }
  }
}

// theta, both layers in one pass: ph = relu(rel W1 + b1) and th = ph W2 +
// b2 (RND, the bf16 mode: ph = bf16(relu(bf16(rel) W1 + b1))), W2 (P x D)
// in shared memory, each block
// walking G-row groups of its rows; a thread's outputs are four
// consecutive columns of eight rows (each W2 load serves 32 FMAs), each an
// FMA chain over k = 0 ... P - 1 from zero, then + b2: the f32 mode's
// sums (pos_hidden_kernel, then the FMA GEMM) on the rounded operands,
// without the ph round trip and with 16-byte stores (the GEMM's stores of
// this thin product ran at a quarter of their width: 1.3 ms per gv1 chunk
// against 0.23 of bound). The bf16 mode of every entry runs it, and the f32
// mode of o4d_sattn (the decoder's f32 entries keep their two kernels,
// pos_hidden_kernel and the FMA GEMM, whose bits it repeats).
// A block walks RPB rows in groups of G. The decoder's tile (ntw 13) keeps
// 64-row groups and 512 rows a block. Narrower tiles widen the groups so that
// a group's (G / 8) x D / 4 outputs occupy the block's 256 threads (at D 36,
// 64 rows kept 72 of them busy) and take about eight blocks per SM; the
// groups stop at 512 rows (reached at D 16; below it fewer threads are busy)
// and where W2 and the group's ph would outgrow shared memory.
struct ThetaShape {
  int G, RPB;
};

size_t theta_smem_bytes(int P, int D, int G) {
  return sizeof(float) * ((size_t)P * D + (size_t)G * P);
}

ThetaShape theta_shape(long long R, int P, int D, int ntw) {
  if (ntw == kDecoderNTW) return ThetaShape{64, 512};
  const int d4 = (D + 3) / 4;
  int g = 64;
  while (g < 512 && (g / 8) * d4 < 256 &&
         theta_smem_bytes(P, D, g + 64) <= (size_t)kSmemDynMax)
    g += 64;
  const long long per = (R + (long long)g * 1056 - 1) / ((long long)g * 1056);
  return ThetaShape{g, g * (int)(per < 1 ? 1 : per > 8 ? 8 : per)};
}

template <bool RND>
__global__ void __launch_bounds__(256) theta_kernel(const float* __restrict__ rel,
                                                    const float* __restrict__ w1,
                                                    const float* __restrict__ b1,
                                                    const float* __restrict__ w2,
                                                    const float* __restrict__ b2,
                                                    float* __restrict__ th, int R, int P, int D,
                                                    int G, int RPB) {
  extern __shared__ __align__(16) float sth[];
  auto rnd = [](float x) { return RND ? round_bf16(x) : x; };
  float* W2 = sth;                 // (P, D)
  float* ph = sth + (size_t)P * D;  // (G, P)
  for (int i = threadIdx.x; i < P * D; i += blockDim.x) W2[i] = w2[i];
  const int D4 = (D + 3) / 4;
  const bool vec = D % 4 == 0;
  const int row_end = min(R, (blockIdx.x + 1) * RPB);
  for (int g0 = blockIdx.x * RPB; g0 < row_end; g0 += G) {
    const int nr = min(G, row_end - g0);
    __syncthreads();  // W2 is in, and the last group's ph is read.
    for (int i = threadIdx.x; i < nr * P; i += blockDim.x) {
      const int r = i / P, c = i - r * P;
      float acc = 0.f;
      for (int kk = 0; kk < 3; ++kk)
        acc = fmaf(rnd(rel[(size_t)(g0 + r) * 3 + kk]), w1[kk * P + c], acc);
      ph[i] = rnd(fmaxf(acc + b1[c], 0.f));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (G / 8) * D4; i += blockDim.x) {
      const int rb = 8 * (i / D4), c = 4 * (i - (rb / 8) * D4);
      if (rb >= nr) continue;
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;
      for (int kk = 0; kk < P; ++kk) {
        float w[4];
        if (vec) {
          const float4 x = *reinterpret_cast<const float4*>(W2 + kk * D + c);
          w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = c + u < D ? W2[kk * D + c + u] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = ph[(rb + r) * P + kk];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(a, w[u], acc[r][u]);
        }
      }
      for (int r = 0; r < 8 && rb + r < nr; ++r) {
        float* out = th + (size_t)(g0 + rb + r) * D + c;
        if (vec) {
          *reinterpret_cast<float4*>(out) = make_float4(acc[r][0] + b2[c], acc[r][1] + b2[c + 1],
                                                        acc[r][2] + b2[c + 2],
                                                        acc[r][3] + b2[c + 3]);
        } else {
          for (int u = 0; u < 4 && c + u < D; ++u) out[u] = acc[r][u] + b2[c + u];
        }
      }
    }
  }
}

// The softmax over each query's k rows and the weighted sum, per (query,
// channel), in j order: out = sum_j e_j (v_j + theta_j) / sum_j e_j with
// e_j = exp((lg_j + c2) / sqrt(D) - max).
__global__ void combine_kernel(const float* __restrict__ lg, const float* __restrict__ vv,
                               const float* __restrict__ th, const float* __restrict__ c2,
                               float* __restrict__ out, int nq, int D, int k,
                               float inv_sqrt_d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nq * D) return;
  const int nl = (int)(i / D), c = (int)(i % D);
  const size_t o0 = (size_t)nl * k * D + c;
  const float bias = c2[c];
  float mx = -CUDART_INF_F;
  for (int j = 0; j < k; ++j) mx = fmaxf(mx, (lg[o0 + (size_t)j * D] + bias) * inv_sqrt_d);
  float den = 0.f, acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const size_t o = o0 + (size_t)j * D;
    const float e = expf((lg[o] + bias) * inv_sqrt_d - mx);
    den += e;
    acc += e * (vv[o] + th[o]);
  }
  out[i] = acc / den;
}

// The launch's workspace: the weights in fragment order (sized for the
// widest column block, 416 columns), then one chunk's per-row operands (R
// rows), each 16-byte aligned. The self-attention (self) reads rel and F
// from its inputs and forms theta in one kernel: only th, vv and lg.
struct FwdWs {
  float *wv, *wk, *a1, *a2;  // the weights in fragment order
  float *rel, *f, *kk, *ph, *th, *vv, *lg;
};

FwdWs carve_fwd(float* ws, long long R, int D, int E, int H, int P, bool premul, bool self,
                long long* used) {
  FwdWs w = {};
  long long off = 0;
  auto take = [&](long long n) {
    float* r = ws == nullptr ? nullptr : ws + off;
    off += (n + 3) / 4 * 4;
    return r;
  };
  const long long D8 = cdiv(D, 8), E8 = cdiv(E, 8), NC = cdiv(H, kHC), NT = kColBlock / 8;
  const long long NCB = cdiv(D, kColBlock);
  if (!premul) {
    w.wv = take(NCB * E8 * NT * 64);
    w.wk = take(NCB * E8 * NT * 64);
  }
  w.a1 = take(NC * D8 * kA1Step);
  w.a2 = take(NCB * NC * kHK8 * NT * 64);
  if (!self) {
    w.rel = take(R * 3);
    if (premul)
      w.kk = take(R * D);
    else
      w.f = take(R * E);
    w.ph = take(R * P);
  }
  w.th = take(R * D);
  w.vv = take(R * D);
  w.lg = take(R * D);
  *used = off;
  return w;
}

// Floats of one row's operands (the same for the index route's per-row mode
// and the gathered form, so that they cut their rows into the same chunks).
long long fwd_row_floats(int D, int E, int P, bool premul, bool self) {
  return self ? 3LL * D : 3LL + P + 3LL * D + (premul ? D : E);
}

// The chunking of one launch: QC queries per chunk (whole queries of one
// example, the chunks of an example as equal as the budget allows; at most
// N; the per-row operands of a chunk within budget bytes), and the
// workspace it needs in f32 floats.
void fwd_plan(int N, int D, int E, int H, int P, int k, bool premul, bool self, long long budget,
              int* QC, long long* floats) {
  long long qmax = budget / ((long long)sizeof(float) * k * fwd_row_floats(D, E, P, premul, self));
  if (qmax > N) qmax = N;
  if (qmax < 1) qmax = 1;
  const long long chunks = (N + qmax - 1) / qmax;
  const long long qc = (N + chunks - 1) / chunks;
  *QC = (int)qc;
  carve_fwd(nullptr, qc * k, D, E, H, P, premul, self, floats);
}

struct FwdCall {
  RowSrc src;  // N, D, E, k, premul and the rows' sources
  const float *rel, *gf;  // kSelf: (B, N, k, 3) and (B, N, k, E), read as given
  const float *qproj, *wk, *wv, *wp1, *bp1, *wp2, *bp2, *wa1, *ba1, *wa2, *ba2;
  float* out;  // (B, N, D)
  float* ws;   // o4d_attn_plan's workspace for QC
  int B, H, P, QC;
};

using TileKernel = void (*)(TileArgs);

// The tile's instantiation for a column block of 32 ntw columns and a ring
// of `stages` slabs (the narrow blocks fit three stages at every width they
// are picked for; run_fwd takes the 416-column block where they do not).
template <bool BF16>
TileKernel tile_kernel(int ntw, int stages) {
  switch (ntw) {
    case 2: return attn_tile_kernel<3, BF16, 2>;
    case 3: return attn_tile_kernel<3, BF16, 3>;
    case 5: return attn_tile_kernel<3, BF16, 5>;
    case 9: return attn_tile_kernel<3, BF16, 9>;
    case 10: return attn_tile_kernel<3, BF16, 10>;
    default:
      return stages == 3 ? attn_tile_kernel<3, BF16, kDecoderNTW>
                         : attn_tile_kernel<2, BF16, kDecoderNTW>;
  }
}

// BF16: the bf16 compute mode (o4d_attn_bf16 / o4d_attn_g_bf16 /
// o4d_sattn_bf16). The caller passes W1 and W2 already rounded to bf16;
// the row loader rounds the key rows, theta's hidden layer its operands,
// the fragment kernels the other weights, the tile its rows. theta, v, the
// logits, the softmax and every sum stay f32, and the workspace and
// chunking are the f32 mode's.
// MODE kSelf (o4d_sattn): no row loader; the tile reads F from gf and theta
// reads rel where they lie (both are chunk-contiguous), and theta runs in
// one kernel in both modes.
template <int MODE, bool BF16>
int run_fwd(const FwdCall& p, cudaStream_t s) {
  const int N = p.src.N, D = p.src.D, E = p.src.E, k = p.src.k, H = p.H, P = p.P;
  const bool premul = MODE == kIndex && p.src.premul;
  constexpr bool kFusedTheta = BF16 || MODE == kSelf;
  long long used;
  const FwdWs w = carve_fwd(p.ws, (long long)p.QC * k, D, E, H, P, premul, MODE == kSelf, &used);
  const int stages = BF16 ? tile_stages_bf16(D, E) : tile_stages(D, E);
  const int ntw = stages == 3 ? tile_ntw(D) : kDecoderNTW;
  const size_t smem = tile_smem_bytes(D, E, stages, BF16, slab_floats(ntw, BF16));
  if (smem > (size_t)kSmemDynMax) return (int)cudaErrorInvalidValue;
  const int NC = cdiv(H, kHC), NT = 4 * ntw;
  const int NCB = cdiv(D, 8 * NT);
  const TileKernel tile = tile_kernel<BF16>(ntw, stages);
  // theta's launch shape at the largest chunk (a smaller last chunk takes
  // the same groups; each output's sum does not depend on them).
  const ThetaShape tsh = theta_shape((long long)p.QC * k, P, D, ntw);
  const size_t theta_smem = theta_smem_bytes(P, D, tsh.G);
  if (kFusedTheta) {
    if (theta_smem > (size_t)kSmemDynMax) return (int)cudaErrorInvalidValue;
    O4D_TRY(cudaFuncSetAttribute(theta_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)theta_smem));
  }
  O4D_TRY(cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  // The weights in fragment order, once per call.
  if constexpr (BF16) {
    const int D16 = cdiv(D, 16), E16 = cdiv(E, 16), HK = kHC / 16;
    if (!premul) {
      frag_b_bf16_kernel<<<blocks_for((long long)NCB * E16 * NT * 32, 256), 256, 0, s>>>(
          p.wv, E, D, E16, NT, NCB, reinterpret_cast<uint2*>(w.wv));
      frag_b_bf16_kernel<<<blocks_for((long long)NCB * E16 * NT * 32, 256), 256, 0, s>>>(
          p.wk, E, D, E16, NT, NCB, reinterpret_cast<uint2*>(w.wk));
    }
    frag_a1_bf16_kernel<<<blocks_for((long long)NC * D16 * (kHC / 16) * 32, 256), 256, 0, s>>>(
        p.wa1, D, H, D16, NC, reinterpret_cast<uint4*>(w.a1));
    frag_b_bf16_kernel<<<blocks_for((long long)NCB * NC * HK * NT * 32, 256), 256, 0, s>>>(
        p.wa2, H, D, NC * HK, NT, NCB, reinterpret_cast<uint2*>(w.a2));
  } else {
    const int D8 = cdiv(D, 8), E8 = cdiv(E, 8);
    if (!premul) {
      frag_b_kernel<<<blocks_for((long long)NCB * E8 * NT * 32, 256), 256, 0, s>>>(
          p.wv, E, D, E8, NT, NCB, reinterpret_cast<float2*>(w.wv));
      frag_b_kernel<<<blocks_for((long long)NCB * E8 * NT * 32, 256), 256, 0, s>>>(
          p.wk, E, D, E8, NT, NCB, reinterpret_cast<float2*>(w.wk));
    }
    frag_a1_kernel<<<blocks_for((long long)NC * D8 * (kHC / 16) * 32, 256), 256, 0, s>>>(
        p.wa1, D, H, D8, NC, reinterpret_cast<float4*>(w.a1));
    frag_b_kernel<<<blocks_for((long long)NCB * NC * kHK8 * NT * 32, 256), 256, 0, s>>>(
        p.wa2, H, D, NC * kHK8, NT, NCB, reinterpret_cast<float2*>(w.a2));
  }
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  for (int b = 0; b < p.B; ++b) {
    for (int n0 = 0; n0 < N; n0 += p.QC) {
      const int nq = min(p.QC, N - n0), R = nq * k;
      const size_t q0 = (size_t)b * N + n0;  // the chunk's first query.
      const float* rel = w.rel;
      const float* F = w.f;
      if constexpr (MODE == kSelf) {
        rel = p.rel + q0 * k * 3;
        F = p.gf + q0 * k * E;
      } else {
        load_rows_kernel<MODE, BF16><<<blocks_for(R, 8), 256, 0, s>>>(
            p.src, RowDst{w.rel, w.f, w.kk, w.vv}, b, n0, R);
      }
      if constexpr (kFusedTheta) {
        theta_kernel<BF16><<<blocks_for(R, tsh.RPB), 256, theta_smem, s>>>(
            rel, p.wp1, p.bp1, p.wp2, p.bp2, w.th, R, P, D, tsh.G, tsh.RPB);
      } else {
        pos_hidden_kernel<<<blocks_for((long long)R * P, 256), 256, 0, s>>>(
            rel, p.wp1, p.bp1, w.ph, R, P);
        // theta = ph W2 + b2 as FMA chains in k order.
        GemmArgs a = gemm_args(w.ph, P, p.wp2, D, w.th, D, R, D, P);
        a.bias = p.bp2;
        O4D_TRY((gemm<false, false, true>(a, 1, s)));
      }
      const TileArgs t{p.qproj + q0 * D, w.th, w.kk, F, w.vv, w.lg, w.wv, w.wk, w.a1, w.a2,
                       p.ba1, R, D, E, H, k, premul ? 1 : 0};
      tile<<<cdiv(R, kTileRows), kFwdThreads, smem, s>>>(t);
      combine_kernel<<<blocks_for((long long)nq * D, 256), 256, 0, s>>>(
          w.lg, w.vv, w.th, p.ba2, p.out + q0 * D, nq, D, k, inv_sqrt_d);
    }
  }
  return (int)cudaGetLastError();
}

FwdCall fwd_call(const void* qproj, const void* wk, const void* wv, const void* wp1,
                 const void* bp1, const void* wp2, const void* bp2, const void* wa1,
                 const void* ba1, const void* wa2, const void* ba2, void* out, void* ws,
                 int B, int N, int D, int E, int H, int P, int k, int QC) {
  FwdCall c = {};
  c.qproj = (const float*)qproj;
  c.wk = (const float*)wk;
  c.wv = (const float*)wv;
  c.wp1 = (const float*)wp1;
  c.bp1 = (const float*)bp1;
  c.wp2 = (const float*)wp2;
  c.bp2 = (const float*)bp2;
  c.wa1 = (const float*)wa1;
  c.ba1 = (const float*)ba1;
  c.wa2 = (const float*)wa2;
  c.ba2 = (const float*)ba2;
  c.out = (float*)out;
  c.ws = (float*)ws;
  c.B = B;
  c.H = H;
  c.P = P;
  c.QC = QC;
  c.src.N = N;
  c.src.D = D;
  c.src.E = E;
  c.src.k = k;
  return c;
}

bool fwd_shape_ok(int B, int N, int D, int E, int k, int QC) {
  return B > 0 && N > 0 && k >= 1 && k <= 32 && D <= kMaxWidth && E <= kMaxWidth &&
         QC >= 1 && (long long)QC * k < (1LL << 31);
}

}  // namespace

// Shared memory of one o4d_attn / o4d_attn_g block at widths D and E (P plays
// no part), and the widest D or E the tile takes: 560, where the 64 rows of
// max(D, E) floats, the h chunk and a two-stage ring of weight slabs fill the
// block's 232,448 bytes of shared memory (D above 416 runs in column blocks).
extern "C" long long o4d_attn_smem_bytes(int D, int E, int P) {
  (void)P;
  return (long long)(tile_smem_floats(D, E, tile_stages(D, E)) * sizeof(float));
}

extern "C" int o4d_attn_max_width() { return kMaxWidth; }

// The chunking of one o4d_attn / o4d_attn_g launch (fwd_plan; the same
// chunks for the index route's per-row mode and the gathered form), and the
// workspace it needs in f32 floats.
extern "C" void o4d_attn_plan(int N, int D, int E, int H, int P, int k, int premul,
                              long long budget, int* QC, long long* floats) {
  fwd_plan(N, D, E, H, P, k, premul != 0, false, budget, QC, floats);
}

// The chunking and workspace of one o4d_sattn / o4d_sattn_bf16 launch.
extern "C" void o4d_sattn_plan(int N, int D, int E, int H, int P, int k, long long budget,
                               int* QC, long long* floats) {
  fwd_plan(N, D, E, H, P, k, false, true, budget, QC, floats);
}

namespace {

template <bool BF16>
int attn_index(const void* qpos, const void* qproj, const void* ki, const void* kpos,
               const void* kv, const void* wk, const void* wv, const void* wp1, const void* bp1,
               const void* wp2, const void* bp2, const void* wa1, const void* ba1, const void* wa2,
               const void* ba2, void* out, void* ws, int B, int N, int M, int D, int E, int H,
               int P, int KS, int k, int premul, int QC, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (!fwd_shape_ok(B, N, D, E, k, QC) || k > KS) return (int)cudaErrorInvalidValue;
  FwdCall c = fwd_call(qproj, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out, ws, B, N,
                       D, E, H, P, k, QC);
  c.src.qpos = (const float*)qpos;
  c.src.ki = (const int*)ki;
  c.src.kpos = (const float*)kpos;
  c.src.kv = (const float*)kv;
  c.src.M = M;
  c.src.KS = KS;
  c.src.premul = premul;
  return run_fwd<kIndex, BF16>(c, (cudaStream_t)stream);
}

template <bool BF16>
int attn_gathered(const void* qpos, const void* qproj, const void* g, const void* wk,
                  const void* wv, const void* wp1, const void* bp1, const void* wp2,
                  const void* bp2, const void* wa1, const void* ba1, const void* wa2,
                  const void* ba2, void* out, void* ws, int B, int N, int D, int E, int H, int P,
                  int KE, int k, int QC, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (!fwd_shape_ok(B, N, D, E, k, QC) || k > KE) return (int)cudaErrorInvalidValue;
  FwdCall c = fwd_call(qproj, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out, ws, B, N,
                       D, E, H, P, k, QC);
  c.src.qpos = (const float*)qpos;
  c.src.gin = (const float*)g;
  c.src.KE = KE;
  return run_fwd<kGathered, BF16>(c, (cudaStream_t)stream);
}

}  // namespace

// Inputs: qpos (B, N, 3), qproj (B, N, D), ki (B, N, KS) int32, kpos (B, M, 3),
// kv (premul: (B, M, 2D) [k | v]; per-row: (B, M, E)), wk / wv (E, D, per-row
// only), the MLP weights; out (B, N, D); ws: o4d_attn_plan's workspace for QC.
extern "C" int o4d_attn(const void* qpos, const void* qproj, const void* ki, const void* kpos,
                        const void* kv, const void* wk, const void* wv, const void* wp1,
                        const void* bp1, const void* wp2, const void* bp2, const void* wa1,
                        const void* ba1, const void* wa2, const void* ba2, void* out, void* ws,
                        int B, int N, int M, int D, int E, int H, int P, int KS, int k, int premul,
                        int QC, void* stream) {
  return attn_index<false>(qpos, qproj, ki, kpos, kv, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2,
                           ba2, out, ws, B, N, M, D, E, H, P, KS, k, premul, QC, stream);
}

// o4d_attn in the bf16 compute mode (the same arguments, all f32; wp1 and
// wp2 rounded to bf16 by the caller): the function of _attn_kernel at
// compute_dtype=bfloat16.
extern "C" int o4d_attn_bf16(const void* qpos, const void* qproj, const void* ki, const void* kpos,
                             const void* kv, const void* wk, const void* wv, const void* wp1,
                             const void* bp1, const void* wp2, const void* bp2, const void* wa1,
                             const void* ba1, const void* wa2, const void* ba2, void* out,
                             void* ws, int B, int N, int M, int D, int E, int H, int P, int KS,
                             int k, int premul, int QC, void* stream) {
  return attn_index<true>(qpos, qproj, ki, kpos, kv, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2,
                          ba2, out, ws, B, N, M, D, E, H, P, KS, k, premul, QC, stream);
}

// o4d_attn over the shared gather's rows: g (B, KE, N, E + 3) replaces ki,
// kpos and kv; per-row mode only.
extern "C" int o4d_attn_g(const void* qpos, const void* qproj, const void* g, const void* wk,
                          const void* wv, const void* wp1, const void* bp1, const void* wp2,
                          const void* bp2, const void* wa1, const void* ba1, const void* wa2,
                          const void* ba2, void* out, void* ws, int B, int N, int D, int E, int H,
                          int P, int KE, int k, int QC, void* stream) {
  return attn_gathered<false>(qpos, qproj, g, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out,
                              ws, B, N, D, E, H, P, KE, k, QC, stream);
}

// o4d_attn_g in the bf16 compute mode (as o4d_attn_bf16): _attn_g_kernel at
// compute_dtype=bfloat16.
extern "C" int o4d_attn_g_bf16(const void* qpos, const void* qproj, const void* g, const void* wk,
                               const void* wv, const void* wp1, const void* bp1, const void* wp2,
                               const void* bp2, const void* wa1, const void* ba1, const void* wa2,
                               const void* ba2, void* out, void* ws, int B, int N, int D, int E,
                               int H, int P, int KE, int k, int QC, void* stream) {
  return attn_gathered<true>(qpos, qproj, g, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out,
                             ws, B, N, D, E, H, P, KE, k, QC, stream);
}

namespace {

template <bool BF16>
int sattn(const void* q, const void* gf, const void* rel, const void* wk, const void* wv,
          const void* wp1, const void* bp1, const void* wp2, const void* bp2, const void* wa1,
          const void* ba1, const void* wa2, const void* ba2, void* out, void* ws, int B, int N,
          int D, int E, int H, int P, int k, int QC, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (!fwd_shape_ok(B, N, D, E, k, QC)) return (int)cudaErrorInvalidValue;
  FwdCall c = fwd_call(q, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out, ws, B, N, D, E,
                       H, P, k, QC);
  c.rel = (const float*)rel;
  c.gf = (const float*)gf;
  return run_fwd<kSelf, BF16>(c, (cudaStream_t)stream);
}

}  // namespace

// The encoder's fused self-attention: q (B, N, D) projected queries, gf
// (B, N, k, E) raw neighbour features (row n k + j is query n's j-th
// neighbour), rel (B, N, k, 3) coordinate deltas, the weights as o4d_attn's
// per-row mode; out (B, N, D); ws: o4d_sattn_plan's workspace for QC.
extern "C" int o4d_sattn(const void* q, const void* gf, const void* rel, const void* wk,
                         const void* wv, const void* wp1, const void* bp1, const void* wp2,
                         const void* bp2, const void* wa1, const void* ba1, const void* wa2,
                         const void* ba2, void* out, void* ws, int B, int N, int D, int E, int H,
                         int P, int k, int QC, void* stream) {
  return sattn<false>(q, gf, rel, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out, ws, B, N,
                      D, E, H, P, k, QC, stream);
}

// o4d_sattn in the bf16 compute mode (the same arguments; wp1 and wp2
// rounded to bf16 by the caller): _fwd_kernel at compute_dtype=bfloat16.
extern "C" int o4d_sattn_bf16(const void* q, const void* gf, const void* rel, const void* wk,
                              const void* wv, const void* wp1, const void* bp1, const void* wp2,
                              const void* bp2, const void* wa1, const void* ba1, const void* wa2,
                              const void* ba2, void* out, void* ws, int B, int N, int D, int E,
                              int H, int P, int k, int QC, void* stream) {
  return sattn<true>(q, gf, rel, wk, wv, wp1, bp1, wp2, bp2, wa1, ba1, wa2, ba2, out, ws, B, N,
                     D, E, H, P, k, QC, stream);
}
