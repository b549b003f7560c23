// Shared by the attention forward (csrc/attn.cu) and backward
// (csrc/attn_bwd.cu): the cp.async helpers, the 3xTF32 split and the TF32
// tensor-core product (mma.sync m16n8k8), the 128 x 128 tiled GEMMs of the
// backward's phases with their epilogue, and the row phase's first kernels:
// the row loader of the three entry modes (with the forward's bf16 rounding
// of the key rows as an option) and theta's hidden layer. The GEMMs: f32
// products of both sides at least kWgMin on the wgmma engine (3xTF32 on
// wgmma, gemm3_wgmma_kernel); the narrower f32 products on mma.sync m16n8k8
// in 3xTF32 (gemm3_kernel); f32 FMA chains (gemm3_kernel's FMA); or, in the
// bf16 compute mode, bf16 tensor-core products (mma.sync m16n8k16) on
// operands rounded to bf16 (gemm3_kernel's BF16). Everything sits in an
// unnamed namespace, as it did inside each source: each .cu is its own
// library.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ------------------------------------------------------------ 3xTF32 GEMM --
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kGemmThreads = 256;
constexpr int kLdMK = kBK + 4;  // tiles kept [row][k]: 36 floats per row.
constexpr int kLdKN = kBN + 8;  // tiles kept [k][col]: 136 floats per row.
constexpr int kTileFloats = kBM * kLdMK;  // >= kBK * kLdKN.
constexpr int kGemmSmem = kStages * 2 * kTileFloats * (int)sizeof(float);
// The bf16 mode: a 2-stage f32 ring, each landed stage rounded once into
// bf16 tiles kept [row][k] (40 elements a row: the 16-byte rows of an
// ldmatrix 8 x 8 fall in distinct banks), from which ldmatrix reads the
// fragments.
constexpr int kStagesBf16 = 2, kLdB = kBK + 8;
constexpr int kGemmSmemBf16 =
    kStagesBf16 * 2 * kTileFloats * (int)sizeof(float) + 2 * kBM * kLdB * 2;

// Destination row of output row r: (r / rk) * q + (r % rk) * j floats.
struct RowMap {
  long long q, j;
  int rk;
};

// C (M x N) (+)= alpha op(A) op(B) over the K range of blockIdx.z's slice,
// where op(A)(m, k) = A[m lda + k], or A[k lda + m] with TA; op(B)(k, n) =
// B[k ldb + n], or B[n ldb + k] with TB. Epilogue: + bias[n], ReLU, zero
// where mask[m ldm + n] <= 0, store or add at C + map(m) + n; slice z writes
// at C + z zstride.
struct GemmArgs {
  const float* A;
  long long lda;
  const float* B;
  long long ldb;
  float* C;
  RowMap map;
  long long zstride;
  const float* bias;
  const float* mask;
  long long ldm;
  int M, N, K, kslice;
  float alpha;
  int relu, accum;
};

// x rounded to bf16 (to nearest, ties to even) and back: the operand
// rounding of the bf16 compute mode (pallas_attention.py::_mm2 casts every
// product's operands to bf16).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// lo and hi rounded to bf16 (to nearest even) in one 32-bit register, lo in
// the low half: an operand pair of mma.sync m16n8k16 bf16.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The four 8 x 8 bf16 matrices whose rows lanes 0-7, 8-15, 16-23 and 24-31
// address, one per register, each lane holding (row lane / 4, columns
// 2 (lane % 4) + {0, 1}) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A staged f32 tile of 128 rows (m or n) x 32 k, kept [row][k] (stride
// kLdMK) or, with KR, [k][row] (stride kLdKN), rounded to bf16 into dst
// [row][k] (stride kLdB); all kGemmThreads threads take part.
template <bool KR>
__device__ __forceinline__ void round_tile(const float* __restrict__ src,
                                           __nv_bfloat16* __restrict__ dst, int tid) {
  if (!KR) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kGemmThreads; ++i) {
      const int u = tid + i * kGemmThreads, r = u / (kBK / 4), k = 4 * (u % (kBK / 4));
      const float4 v = *reinterpret_cast<const float4*>(src + r * kLdMK + k);
      *reinterpret_cast<uint2*>(dst + r * kLdB + k) =
          make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 8 / kGemmThreads; ++i) {
      // Lanes along k: their 32-bit stores fill consecutive words of a row.
      const int u = tid + i * kGemmThreads, k = 2 * (u % (kBK / 2)), r = 4 * (u / (kBK / 2));
      const float4 a = *reinterpret_cast<const float4*>(src + k * kLdKN + r);
      const float4 b = *reinterpret_cast<const float4*>(src + (k + 1) * kLdKN + r);
      *reinterpret_cast<uint32_t*>(dst + (r + 0) * kLdB + k) = bf16x2(a.x, b.x);
      *reinterpret_cast<uint32_t*>(dst + (r + 1) * kLdB + k) = bf16x2(a.y, b.y);
      *reinterpret_cast<uint32_t*>(dst + (r + 2) * kLdB + k) = bf16x2(a.z, b.z);
      *reinterpret_cast<uint32_t*>(dst + (r + 3) * kLdB + k) = bf16x2(a.w, b.w);
    }
  }
}

// c += a b, one m16n8k16 bf16 tensor-core product with f32 accumulators.
// A fragment: a[h] holds row gq + 8 (h & 1), columns 2 tq + 8 (h >> 1) +
// {0, 1}; B: b[h] holds rows 2 tq + 8 h + {0, 1}, column gq; C as
// m16n8k8's.
__device__ __forceinline__ void mma_bf16_acc(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// its 13 low bits cleared, so that the f32 residual below is exact.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 values (x - big is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// c = a b (ZERO) or c += a b, one m16n8k8 TF32 tensor-core product.
template <bool ZERO>
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  if (ZERO)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// gemm3_kernel: the f32 tensor-core products narrower than kWgMin on a side,
// the FMA chains and the bf16 mode (the wide f32 products run on
// gemm3_wgmma_kernel, below). The product of a block's 128 x 128 tile, in
// registers: on the tensor cores (3xTF32 on mma.sync m16n8k8; the thread's
// fragments of its warp's 64 x 32, each 8-deep step's three products added
// to the f32 sum), or with FMA on the CUDA cores (the thread's 8 x 8
// outputs, rows ty + 16 i, columns 4 tx + {0..3} and 64 + 4 tx + {0..3}):
// every output a sequential chain acc = fma(a_k, b_k, acc) over k = 0, 1,
// ... from zero, the rounding of a plain f32 matrix product. BF16 (the bf16 compute mode, the TPU kernels'
// _mm2): each landed f32 stage rounded once into bf16 [row][k] tiles (both
// operands), the fragments read from them by ldmatrix, one m16n8k16 bf16
// product per 16-deep step (each product exact in f32), accumulated by the
// tensor core across the block's K range. (Rounding as each fragment was
// read from the f32 tiles took twice the shared-memory loads and ran the
// GEMMs at the rate of those loads, PERF.md.) Its
// f32 accumulation truncates: over a weight gradient's row slice (a few
// thousand rows) that moves a sum by about 1e-5 relative, far inside the
// bf16 mode's tolerance; adding each step's sum in registers instead (as
// the 3xTF32 steps do, for the f32 gate) made the bf16 attention backward
// 9% slower on the H100 (PERF.md).
template <bool TA, bool TB, bool FMA, bool BF16 = false>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm3_kernel(GemmArgs p) {
  static_assert(!FMA || (!TA && !TB), "the FMA product takes row-major operands");
  static_assert(!(FMA && BF16), "the bf16 mode runs on the tensor cores");
  constexpr int S = BF16 ? kStagesBf16 : kStages;  // f32 stages in the ring.
  extern __shared__ float smg[];
  float* As = smg;
  float* Bs = smg + S * kTileFloats;
  __nv_bfloat16* Ab = reinterpret_cast<__nv_bfloat16*>(smg + 2 * S * kTileFloats);
  __nv_bfloat16* Bb = Ab + kBM * kLdB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;          // mma group and thread in group.
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // the warp's 64 x 32.
  const int tx = tid & 15, ty = tid >> 4;           // FMA: the thread's 8 x 8.
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * p.kslice, ke = min(p.K, kb + p.kslice);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  // 16-byte copies where the whole tile is in range and aligned (the
  // operand's row stride a multiple of 4 floats), 4-byte copies elsewhere.
  const bool a_vec = m0 + kBM <= p.M && p.lda % 4 == 0 && ((size_t)p.A & 15) == 0;
  const bool b_vec = n0 + kBN <= p.N && p.ldb % 4 == 0 && ((size_t)p.B & 15) == 0;
  auto load = [&](int stage, int kt) {
    const int k0 = kb + kt * kBK;
    float* as = As + stage * kTileFloats;
    float* bs = Bs + stage * kTileFloats;
    const bool k_full = k0 + kBK <= ke;
    if (a_vec && k_full) {
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kGemmThreads; ++i) {
        const int idx = tid + i * kGemmThreads;
        if (TA) {
          const int m4 = idx & (kBM / 4 - 1), k = idx / (kBM / 4);
          cp_async16(as + k * kLdKN + 4 * m4, p.A + (size_t)(k0 + k) * p.lda + m0 + 4 * m4);
        } else {
          const int k4 = idx & (kBK / 4 - 1), m = idx / (kBK / 4);
          cp_async16(as + m * kLdMK + 4 * k4, p.A + (size_t)(m0 + m) * p.lda + k0 + 4 * k4);
        }
      }
    } else {
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kGemmThreads; ++i) {
      const int idx = tid + i * kGemmThreads;
      int m, k;
      float* dst;
      if (TA) {
        m = idx & (kBM - 1), k = idx / kBM;
        dst = as + k * kLdKN + m;
      } else {
        k = idx & (kBK - 1), m = idx / kBK;
        dst = as + m * kLdMK + k;
      }
      const int gm = m0 + m, gk = k0 + k;
      const bool ok = gm < p.M && gk < ke;
      const float* src = !ok ? p.A
                         : TA ? p.A + (size_t)gk * p.lda + gm
                              : p.A + (size_t)gm * p.lda + gk;
      cp_async4(dst, src, ok);
    }
    }
    if (b_vec && k_full) {
#pragma unroll
      for (int i = 0; i < kBN * kBK / 4 / kGemmThreads; ++i) {
        const int idx = tid + i * kGemmThreads;
        if (TB) {
          const int k4 = idx & (kBK / 4 - 1), n = idx / (kBK / 4);
          cp_async16(bs + n * kLdMK + 4 * k4, p.B + (size_t)(n0 + n) * p.ldb + k0 + 4 * k4);
        } else {
          const int n4 = idx & (kBN / 4 - 1), k = idx / (kBN / 4);
          cp_async16(bs + k * kLdKN + 4 * n4, p.B + (size_t)(k0 + k) * p.ldb + n0 + 4 * n4);
        }
      }
      return;
    }
#pragma unroll 4
    for (int i = 0; i < kBN * kBK / kGemmThreads; ++i) {
      const int idx = tid + i * kGemmThreads;
      int n, k;
      float* dst;
      if (TB) {
        k = idx & (kBK - 1), n = idx / kBK;
        dst = bs + n * kLdMK + k;
      } else {
        n = idx & (kBN - 1), k = idx / kBN;
        dst = bs + k * kLdKN + n;
      }
      const int gn = n0 + n, gk = k0 + k;
      const bool ok = gn < p.N && gk < ke;
      const float* src = !ok ? p.B
                         : TB ? p.B + (size_t)gn * p.ldb + gk
                              : p.B + (size_t)gk * p.ldb + gn;
      cp_async4(dst, src, ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < nk) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    const float* as = As + (kt % S) * kTileFloats;
    const float* bs = Bs + (kt % S) * kTileFloats;
    if constexpr (FMA) {
      // Zero-filled k past the end add exact zeros: the chain is unchanged.
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = as[(ty + 16 * i) * kLdMK + k];
        const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kLdKN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kLdKN + 64 + 4 * tx);
        bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
        bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
      }
    } else if constexpr (BF16) {
      // The stage rounded into the bf16 tiles (the previous tile's reads
      // ended at the barrier above), then the fragments. ldmatrix: A's four
      // matrices are rows +0 / +8 at k +0, then at k +8 (a0-a3); B's, for
      // two n-tiles, k +0 / +8 of n +0, then of n +8.
      round_tile<TA>(as, Ab, tid);
      round_tile<!TB>(bs, Bb, tid);
      __syncthreads();
#pragma unroll
      for (int k16 = 0; k16 < kBK; k16 += 16) {
        uint32_t bb[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, Bb + (wn + 16 * np + (lane & 7) + 8 * (lane >> 4)) * kLdB + k16 +
                             8 * ((lane >> 3) & 1));
          bb[2 * np][0] = r[0], bb[2 * np][1] = r[1];
          bb[2 * np + 1][0] = r[2], bb[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t ab[4];
          ldmatrix_x4(ab, Ab + (wm + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLdB +
                              k16 + 8 * (lane >> 4));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_acc(acc + (mt * 4 + nt) * 4, ab, bb[nt]);
        }
      }
    } else {
#pragma unroll
      for (int k8 = 0; k8 < kBK; k8 += 8) {
        uint32_t bb[4][2], bsm[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = wn + nt * 8 + gq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = k8 + tq + 4 * h;
            const float v = TB ? bs[n * kLdMK + k] : bs[k * kLdKN + n];
            split_tf32(v, bb[nt][h], bsm[nt][h]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t ab[4], asm_[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int m = wm + mt * 16 + gq + 8 * (h & 1);
            const int k = k8 + tq + 4 * (h >> 1);
            const float v = TA ? as[k * kLdKN + m] : as[m * kLdMK + k];
            split_tf32(v, ab[h], asm_[h]);
          }
          // The three products of one 8-deep step summed by the tensor core,
          // then added to the f32 sum with one rounding: the tensor core's own
          // accumulation rounds toward zero, which over hundreds of steps
          // drifts a long sum past the f32 tolerance.
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float t[4];
            mma_tf32<true>(t, asm_, bb[nt]);
            mma_tf32<false>(t, ab, bsm[nt]);
            mma_tf32<false>(t, ab, bb[nt]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[(mt * 4 + nt) * 4 + c] += t[c];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* C = p.C + (size_t)blockIdx.z * p.zstride;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // tensor cores: i = (mt 4 + nt) 4 + c; FMA: i = 8 row + col.
    const int m = FMA ? m0 + ty + 16 * (i >> 3)
                      : m0 + wm + (i >> 4) * 16 + gq + 8 * ((i & 3) >> 1);
    const int n = FMA ? n0 + 4 * tx + (i & 3) + 64 * ((i >> 2) & 1)
                      : n0 + wn + ((i >> 2) & 3) * 8 + 2 * tq + (i & 1);
    if (m >= p.M || n >= p.N) continue;
    float* row = C + (size_t)(m / p.map.rk) * p.map.q + (size_t)(m % p.map.rk) * p.map.j;
    float v = p.alpha * acc[i];
    if (p.bias != nullptr) v += p.bias[n];
    if (p.relu) v = fmaxf(v, 0.f);
    if (p.mask != nullptr && !(p.mask[(size_t)m * p.ldm + n] > 0.f)) v = 0.f;
    row[n] = p.accum ? row[n] + v : v;
  }
}

// ------------------------------------------------- 3xTF32 GEMM on wgmma --
// gemm3_wgmma_kernel: the f32 tensor-core products whose output is at least
// kWgMin wide on both sides (the row phase's wide products and the long-K
// weight gradients; gemm() decides from the shapes alone). The 128 x 128
// output tiles, the K ranges, the z slices and the epilogue are
// gemm3_kernel's; a persistent block per SM walks over the tiles. Three
// warpgroups:
//   * the producer warpgroup stages each 32-deep k-step's raw f32 A and B
//     tiles into a ring of kWgStages stages, kWgStages - 1 k-steps ahead:
//     by TMA (one thread, an mbarrier's transaction count) where the
//     operand's pointer and row stride are 16-byte multiples and the K
//     slices are whole k-steps, else by cp.async (4-byte copies at any
//     stride, 16-byte where the tile is whole and aligned) whose completion
//     arrives on the same mbarrier (cp.async.mbarrier.arrive.noinc). A
//     K-major operand (A without TA, B with TB) lands as rows x 32 k with
//     the 128-byte swizzle, an MN-major one as 32 k x rows. It then splits
//     each landed B tile once into TF32 big and small planes (x = big +
//     small, tf32_bits: cvt.rna), written K-major with the 128-byte swizzle,
//     the layout tf32 wgmma reads (it takes no transposed operand: the split
//     transposes an MN-major tile), into kWgBuffers plane buffers;
//   * each of the two consumer warpgroups owns 64 rows of the tile: per
//     8-deep step its threads read their A fragment from the raw tile and
//     split it in registers (A from registers ran faster than a split A
//     plane in shared memory, PERF.md), then issue three wgmma m64n128k8
//     tf32 products with B from the planes: small a big b, big a small b,
//     big a big b, summed by the tensor core in a fragment that starts from
//     zero every kWgPromote k-steps (the promotion depth: 64 deep, 24
//     products) and is then added to the f32 sum in registers, rounded to
//     nearest. The tensor core's own accumulation truncates; over a weight
//     gradient's row slice (tens of thousands of rows) that would drift
//     past the f32 tolerance, over one fragment it does not.
//   The roles meet only at mbarriers (raw stage landed / read, planes
//   written / read), so the split and the loads run while the tensor cores
//   multiply.
// What bounds it on the H100: the tensor cores' TF32 rate (three products
// per product) and the shared memory's bandwidth, which carries wgmma's B
// reads (4 bytes a row of B per 64 multiply-adds: half the bandwidth at
// the full TF32 rate), the split (a B tile read, two planes written), the
// A fragments' reads and the TMA's writes.
constexpr int kWgStages = 3;   // raw f32 stages (A and B tiles) in the ring.
constexpr int kWgBuffers = 4;  // B plane buffers (big, small).
constexpr int kWgPromote = 2;  // k-steps a fragment sums before promotion: 64 deep.
// A fragment holds its k-steps' plane buffers until promoted; the producer
// needs one more to split ahead.
static_assert(kWgPromote < kWgBuffers, "plane buffers for the promotion depth");
constexpr int kWgThreads = 384;       // the producer warpgroup, then two consumers.
constexpr int kWgMin = 64;            // M and N at least this: the wgmma engine.
constexpr int kWgTile = kBM * kBK;    // floats of a raw tile or a plane (128 x 32).
constexpr int kWgBytes = kWgTile * (int)sizeof(float);
// The raw ring, the plane buffers, the mbarriers (full and empty of each),
// and room to align the base to 1024 bytes.
constexpr int kWgSmem = (2 * kWgStages + 2 * kWgBuffers) * kWgBytes +
                        2 * (kWgStages + kWgBuffers) * 8 + 1024;

// GEMM launches of this library by path, for the wrappers' counters.
enum { kPathWgmma = 0, kPathMmaF32 = 1, kPathMmaBf16 = 2, kPathFma = 3, kPaths = 4 };
std::atomic<long long> g_gemm_launches[kPaths];

__device__ __forceinline__ uint32_t wg_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long wg_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the mbarrier's phase of the given parity; a copy or an arrival
// that has not come within two seconds fails the launch (trap) instead of
// hanging it.
__device__ __forceinline__ void wg_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = wg_smem(bar);
  uint32_t done = 0;
  unsigned long long t0 = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && (spin & 1023) == 1023) {
      if (t0 == 0)
        t0 = wg_ns();
      else if (wg_ns() - t0 > 2000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ void wg_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(wg_smem(bar)) : "memory");
}

// Arrives on bar once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void wg_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(wg_smem(bar))
               : "memory");
}

__device__ __forceinline__ void wg_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(wg_smem(bar)),
               "r"(bytes)
               : "memory");
}

// The box of map at (c0 innermost, c1) into dst; out-of-range elements are
// zeros. The mbarrier's transaction count takes the box's bytes.
__device__ __forceinline__ void wg_tma(float* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(wg_smem(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(wg_smem(bar))
      : "memory");
}

// Float offset of (row r, k) in a K-major tile of 32 k a row, 128-byte
// swizzle: the 16-byte chunk k / 4 of row r sits at chunk (k / 4) ^ (r % 8)
// (the tile based at a multiple of 1024 bytes).
__device__ __forceinline__ int wg_kmajor(int r, int k) {
  return r * kBK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// The producer's cp.async copy of one operand's raw tile (t: its thread,
// 0-127): rows [r0, r0 + 128) of `rows` and k in [k0, k0 + 32) below ke;
// K-major: element (r, k) = src[r ld + k] at wg_kmajor(r, k); MN-major:
// element (k, r) = src[k ld + r] at k 128 + r. Zeros outside.
template <bool KMAJ>
__device__ __forceinline__ void wg_load(float* dst, const float* src, long long ld, int rows,
                                        int r0, int k0, int ke, int t) {
  if (r0 + kBM <= rows && k0 + kBK <= ke && ld % 4 == 0 && ((size_t)src & 15) == 0) {
#pragma unroll
    for (int i = 0; i < kWgTile / 4 / 128; ++i) {
      const int u = t + 128 * i;
      if (KMAJ) {
        const int r = u >> 3, c = u & 7;
        cp_async16(dst + wg_kmajor(r, 4 * c), src + (size_t)(r0 + r) * ld + k0 + 4 * c);
      } else {
        const int k = u >> 5, c = u & 31;
        cp_async16(dst + k * kBM + 4 * c, src + (size_t)(k0 + k) * ld + r0 + 4 * c);
      }
    }
    return;
  }
#pragma unroll 4
  for (int i = 0; i < kWgTile / 128; ++i) {
    const int u = t + 128 * i;
    const int r = KMAJ ? u >> 5 : u & (kBM - 1), k = KMAJ ? u & (kBK - 1) : u >> 7;
    const bool ok = r0 + r < rows && k0 + k < ke;
    const float* s = !ok ? src
                     : KMAJ ? src + (size_t)(r0 + r) * ld + k0 + k
                            : src + (size_t)(k0 + k) * ld + r0 + r;
    cp_async4(dst + (KMAJ ? wg_kmajor(r, k) : k * kBM + r), s, ok);
  }
}

// x (4 floats) split into its TF32 big and small parts, stored at big and
// small (16 bytes each).
__device__ __forceinline__ void wg_split4(float4 x, float* big, float* small) {
  uint4 b, s;
  split_tf32(x.x, b.x, s.x);
  split_tf32(x.y, b.y, s.y);
  split_tf32(x.z, b.z, s.z);
  split_tf32(x.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(small) = s;
}

// A raw B tile split into the K-major swizzled planes by the producer
// warpgroup (t: its thread, 0-127).
template <bool KMAJ>
__device__ __forceinline__ void wg_split(const float* raw, float* big, float* small, int t) {
#pragma unroll
  for (int i = 0; i < kWgTile / 4 / 128; ++i) {
    if (KMAJ) {  // the raw tile is in the planes' layout already.
      const int o = 4 * (t + 128 * i);
      wg_split4(*reinterpret_cast<const float4*>(raw + o), big + o, small + o);
    } else {  // lanes along the rows: conflict-free reads and swizzled writes.
      const float4 x = make_float4(raw[(4 * i) * kBM + t], raw[(4 * i + 1) * kBM + t],
                                   raw[(4 * i + 2) * kBM + t], raw[(4 * i + 3) * kBM + t]);
      const int o = wg_kmajor(t, 4 * i);
      wg_split4(x, big + o, small + o);
    }
  }
}

// The shared-memory matrix descriptor of a K-major plane with the 128-byte
// swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart). The k8 step
// j of a 32-deep stage starts 32 j bytes on: descriptor + 2 j.
__device__ __forceinline__ uint64_t wg_desc(const float* plane) {
  return (uint64_t)((wg_smem(plane) >> 4) & 0x3fff) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (+)= a b, one wgmma m64n128k8 tf32 product of the warpgroup, a from
// registers, b a plane descriptor (acc: 0 starts d from zero). The thread
// (warp q, lane l) gives a[4] = A at (row 16 q + l / 4, k l % 4), (row + 8,
// k), (row, k + 4), (row + 8, k + 4) (mma.sync m16n8k8's A fragment) and
// holds d[4 j + c] = row 16 q + l / 4 + 8 (c / 2), column 8 j + 2 (l % 4) +
// c % 2.
__device__ __forceinline__ void wg_mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// Keeps the compiler from moving register reads or writes of d across the
// asynchronous products' issue and wait.
__device__ __forceinline__ void wg_fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Output tile `tile` of the walk: slice z, then rows, then columns.
struct WgTile {
  int m0, n0, kb, ke, nk, z;
};

__device__ __forceinline__ WgTile wg_tile(const GemmArgs& p, int tile) {
  const int nt = (p.N + kBN - 1) / kBN, mt = (p.M + kBM - 1) / kBM;
  WgTile t;
  t.z = tile / (nt * mt);
  const int r = tile - t.z * nt * mt;
  t.m0 = (r / nt) * kBM;
  t.n0 = (r % nt) * kBN;
  t.kb = t.z * p.kslice;
  t.ke = min(p.K, t.kb + p.kslice);
  t.nk = t.ke > t.kb ? (t.ke - t.kb + kBK - 1) / kBK : 0;
  return t;
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm3_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, const GemmArgs p,
                       const int splits, const int a_tma, const int b_tma) {
  extern __shared__ unsigned char wg_raw[];
  float* base = reinterpret_cast<float*>(((size_t)wg_raw + 1023) & ~(size_t)1023);
  float* raw_a = base;                                 // kWgStages tiles
  float* raw_b = base + kWgStages * kWgTile;           // kWgStages tiles
  float* planes = base + 2 * kWgStages * kWgTile;      // kWgBuffers x (B big, B small)
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + 2 * kWgBuffers * kWgTile);
  uint64_t* empty = full + kWgStages;     // a raw stage read (A by the consumers, B split)
  uint64_t* pfull = empty + kWgStages;    // a plane buffer written
  uint64_t* pempty = pfull + kWgBuffers;  // a plane buffer read by both consumers' wgmma
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform role.
  const int ntiles = ((p.N + kBN - 1) / kBN) * ((p.M + kBM - 1) / kBM) * splits;
  const bool all_tma = a_tma && b_tma;
  // full: the producer's arrivals (thread 0 alone where TMA loads both
  // operands, else its 128 threads' cp.async arrivals); empty: one lane of
  // each of the 4 producer and 8 consumer warps; pfull: the 4 producer
  // warps; pempty: the 8 consumer warps.
  if (tid == 0) {
    auto init = [](uint64_t* bar, int n) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg_smem(bar)), "r"(n));
    };
    for (int s = 0; s < kWgStages; ++s) {
      init(full + s, all_tma ? 1 : 128);
      init(empty + s, 12);
    }
    for (int b = 0; b < kWgBuffers; ++b) {
      init(pfull + b, 4);
      init(pempty + b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: loads kWgStages - 1 k-steps ahead, splits B ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const uint32_t tx = (a_tma ? kWgBytes : 0) + (b_tma ? kWgBytes : 0);
    int tile = blockIdx.x, kt = 0;  // the next k-step to load
    WgTile lt = wg_tile(p, tile < ntiles ? tile : 0);
    int nl = 0;  // k-steps loaded
    auto skip = [&]() {  // on to a k-step that exists, or past the last tile
      while (tile < ntiles && kt >= lt.nk) {
        tile += gridDim.x;
        kt = 0;
        if (tile < ntiles) lt = wg_tile(p, tile);
      }
    };
    auto load = [&]() {
      const int s = nl % kWgStages, f = nl / kWgStages, k0 = lt.kb + kt * kBK;
      if (f > 0) wg_wait(empty + s, (f - 1) & 1);
      float* ra = raw_a + s * kWgTile;
      float* rb = raw_b + s * kWgTile;
      if (tid == 0 && tx != 0) {
        wg_expect_tx(full + s, tx);
        if (a_tma) wg_tma(ra, &map_a, TA ? lt.m0 : k0, TA ? k0 : lt.m0, full + s);
        if (b_tma) wg_tma(rb, &map_b, TB ? k0 : lt.n0, TB ? lt.n0 : k0, full + s);
      }
      if (!a_tma) wg_load<!TA>(ra, p.A, p.lda, p.M, lt.m0, k0, lt.ke, tid);
      if (!b_tma) wg_load<TB>(rb, p.B, p.ldb, p.N, lt.n0, k0, lt.ke, tid);
      if (!all_tma)
        wg_arrive_cp_async(full + s);
      else if (tid == 0)
        wg_arrive(full + s);
      ++nl;
      ++kt;
      skip();
    };
    skip();
    for (int i = 0; i < kWgStages - 1 && tile < ntiles; ++i) load();
    for (int st = 0; st < nl; ++st) {
      const int s = st % kWgStages, b = st % kWgBuffers;
      wg_wait(full + s, (st / kWgStages) & 1);
      if (st >= kWgBuffers) wg_wait(pempty + b, (st / kWgBuffers - 1) & 1);
      float* pl = planes + b * 2 * kWgTile;
      wg_split<TB>(raw_b + s * kWgTile, pl, pl + kWgTile, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        wg_arrive(pfull + b);
        wg_arrive(empty + s);
      }
      if (tile < ntiles) load();  // into the slot of k-step st - 1.
    }
  } else {
    // ---- consumers: warpgroup w owns rows [64 w, 64 w + 64) of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int w = wg - 1, wt = tid - 128 * wg;
    const int wq = wt >> 5, gq = lane >> 2, tq = lane & 3;
    const int r0 = 64 * w + 16 * wq + gq;  // the thread's rows r0, r0 + 8 of the tile
    float acc[64], f[64];                  // the f32 sum; the fragment
#pragma unroll
    for (int i = 0; i < 64; ++i) f[i] = 0.f;  // (each fragment's first product ignores it)
    int st = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const WgTile t = wg_tile(p, tile);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < t.nk;) {
        const int n = min(kWgPromote, t.nk - kt);  // k-steps into this fragment
        for (int q = 0; q < n; ++q) {
          const int sq = st + q, s = sq % kWgStages, b = sq % kWgBuffers;
          const float* ra = raw_a + s * kWgTile;
          const float* pl = planes + b * 2 * kWgTile;
          const uint64_t bb = wg_desc(pl), bs = wg_desc(pl + kWgTile);
          wg_wait(pfull + b, (sq / kWgBuffers) & 1);  // (after the raw stage's full)
          // Per 8-deep step the thread's A fragment read from the raw tile
          // and split in registers (two sets: a set is refilled once its
          // step's products are done), then small a big b, big a small b,
          // big a big b.
          uint32_t ab[2][4], as[2][4];
          wg_fence_regs(f);
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
            if (j >= 2) asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int r = r0 + 8 * (h & 1), k = 8 * j + tq + 4 * (h >> 1);
              split_tf32(TA ? ra[k * kBM + r] : ra[wg_kmajor(r, k)], ab[j & 1][h],
                         as[j & 1][h]);
            }
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            wg_mma_rs(f, as[j & 1], bb + 2 * j, q > 0 || j > 0);
            wg_mma_rs(f, ab[j & 1], bs + 2 * j, 1);
            wg_mma_rs(f, ab[j & 1], bb + 2 * j, 1);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          }
          __syncwarp();
          if (lane == 0) wg_arrive(empty + s);  // the warp's reads of raw A done
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg_fence_regs(f);
        __syncwarp();
        if (lane == 0)
          for (int q = 0; q < n; ++q) wg_arrive(pempty + (st + q) % kWgBuffers);
        // Promotion: the fragment added to the f32 sum.
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += f[i];
        kt += n;
        st += n;
      }
      // The epilogue: the thread's two rows (r = 0, 1: 8 apart) mapped once;
      // per group of four column pairs, the loads (bias, mask, accumulated
      // values) issued before the stores. acc[4 j + 2 r + c] is (row r,
      // column n0 + 8 j + 2 tq + c).
      float* C = p.C + (size_t)t.z * p.zstride;
      const int n_t = t.n0 + 2 * tq;
      float* crow[2];
      const float* mrow[2];
      bool rok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = t.m0 + r0 + 8 * r;
        rok[r] = m < p.M;
        crow[r] = C + (rok[r] ? (size_t)(m / p.map.rk) * p.map.q +
                                    (size_t)(m % p.map.rk) * p.map.j
                              : 0);
        mrow[r] = p.mask + (rok[r] && p.mask != nullptr ? (size_t)m * p.ldm : 0);
      }
#pragma unroll
      for (int j0 = 0; j0 < kBN / 8; j0 += 4) {
        float bv[8], mv[16], ov[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int jj = u >> 2, r = (u >> 1) & 1, c = u & 1;
          const int n = n_t + 8 * (j0 + jj) + c;
          const bool ok = rok[r] && n < p.N;
          if (r == 0) bv[2 * jj + c] = ok && p.bias != nullptr ? p.bias[n] : 0.f;
          mv[u] = ok && p.mask != nullptr ? mrow[r][n] : 1.f;
          ov[u] = ok && p.accum ? crow[r][n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int jj = u >> 2, r = (u >> 1) & 1, c = u & 1;
          const int n = n_t + 8 * (j0 + jj) + c;
          if (!rok[r] || n >= p.N) continue;
          float v = p.alpha * acc[4 * (j0 + jj) + 2 * r + c];
          if (p.bias != nullptr) v += bv[2 * jj + c];
          if (p.relu) v = fmaxf(v, 0.f);
          if (!(mv[u] > 0.f)) v = 0.f;
          crow[r][n] = p.accum ? ov[u] + v : v;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no link to the driver
// library); nullptr where the driver lacks it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
        cudaSuccess)
#endif
      return (EncodeTiledFn) nullptr;
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)f : (EncodeTiledFn) nullptr;
  }();
  return fn;
}

// The TMA map of an operand's raw tiles, or false where TMA cannot load it
// (pointer or row stride not a 16-byte multiple). K-major (`rows` rows of K
// floats, stride ld): boxes of 128 rows x 32 k with the 128-byte swizzle;
// MN-major (K rows of `rows` floats): boxes of 32 k x 128, unswizzled.
bool wg_map(CUtensorMap* map, const float* src, long long ld, int rows, int K, bool kmajor) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ((size_t)src & 15) != 0 || ld % 4 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)(kmajor ? K : rows), (cuuint64_t)(kmajor ? rows : K)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t boxes[2] = {(cuuint32_t)(kmajor ? kBK : kBM), (cuuint32_t)(kmajor ? kBM : kBK)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)src, dims, strides, boxes, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            kmajor ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool TA, bool TB>
cudaError_t gemm_wgmma(const GemmArgs& a, int splits, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm3_wgmma_kernel<TA, TB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e != cudaSuccess) return e;
  // TMA boxes stop only at the operand's end: every K slice must be whole
  // k-steps, or its last box would read the next slice's rows.
  const bool whole = splits == 1 || a.kslice % kBK == 0;
  CUtensorMap ma = {}, mb = {};
  const int a_tma = whole && wg_map(&ma, a.A, a.lda, a.M, a.K, !TA);
  const int b_tma = whole && wg_map(&mb, a.B, a.ldb, a.N, a.K, TB);
  const long long tiles = (long long)((a.N + kBN - 1) / kBN) * ((a.M + kBM - 1) / kBM) * splits;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm3_wgmma_kernel<TA, TB><<<grid, kWgThreads, kWgSmem, s>>>(ma, mb, a, splits, a_tma,
                                                                  b_tma);
  return cudaGetLastError();
}

// C = alpha op(A) op(B) (see GemmArgs) on the path its shapes choose: the
// f32 tensor-core products with M and N both at least kWgMin on the wgmma
// engine, the narrower ones (dW1's 3 rows, dW2's and dtheta_h's P = 32) on
// gemm3_kernel's mma.sync; FMA and BF16 on gemm3_kernel.
template <bool TA, bool TB, bool FMA = false, bool BF16 = false>
cudaError_t gemm(const GemmArgs& a, int splits, cudaStream_t s) {
  if (a.M <= 0 || a.N <= 0) return cudaSuccess;
  if constexpr (!FMA && !BF16) {
    if (a.M >= kWgMin && a.N >= kWgMin) {
      ++g_gemm_launches[kPathWgmma];
      return gemm_wgmma<TA, TB>(a, splits, s);
    }
  }
  ++g_gemm_launches[FMA ? kPathFma : BF16 ? kPathMmaBf16 : kPathMmaF32];
  constexpr int smem = BF16 ? kGemmSmemBf16 : kGemmSmem;
  cudaError_t e = cudaFuncSetAttribute(gemm3_kernel<TA, TB, FMA, BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, splits);
  gemm3_kernel<TA, TB, FMA, BF16><<<grid, kGemmThreads, smem, s>>>(a);
  return cudaGetLastError();
}

GemmArgs gemm_args(const float* A, long long lda, const float* B, long long ldb,
                   float* C, long long ldc, int M, int N, int K) {
  GemmArgs a = {};
  a.A = A;
  a.lda = lda;
  a.B = B;
  a.ldb = ldb;
  a.C = C;
  a.map = RowMap{ldc, 0, 1};
  a.M = M;
  a.N = N;
  a.K = K;
  a.kslice = K;
  a.alpha = 1.f;
  return a;
}

// ---------------------------------------------------------------- row phase --
enum { kIndex = 0, kGathered = 1, kSelf = 2 };

// Where a chunk's rows come from: the index route (ki into kpos and kv; kv
// is premul [k | v] (B, M, 2D) or per-row features (B, M, E)) or the shared
// gather's rows gin (B, KE, N, E + 3). dg: the gathered backward's row
// cotangents, whose position columns and rows j >= k the loader zeroes
// (nullptr in the forward).
struct RowSrc {
  const float* qpos;  // (B, N, 3)
  const int* ki;      // (B, N, KS)
  const float* kpos;  // (B, M, 3)
  const float* kv;
  const float* gin;
  float* dg;
  int N, M, D, E, KS, KE, k, premul;
};

// The chunk's per-row outputs: rel (R, 3), and F (R, E) or, in premul mode,
// kk and vv (R, D).
struct RowDst {
  float *rel, *f, *kk, *vv;
};

// One warp per row r = nl k + j of the chunk (query n0 + nl of example b):
// rel = qpos - the key's position, and the row's features (F), or in
// premul mode its projected [k | v] (kk, vv). The gathered backward also
// zeroes the row's position columns of dg and, once per query, dg's rows
// j >= k. RND (the forward's bf16 mode): every value read from the key
// rows, positions included, is rounded to bf16 first, as the TPU kernel
// rounds its whole value matrix before the gather.
template <int MODE, bool RND = false>
__global__ void load_rows_kernel(RowSrc p, RowDst c, int b, int n0, int R) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const int k = p.k, nl = r / k, j = r - nl * k, n = n0 + nl;
  const int D = p.D, E = p.E;
  const float* qp = p.qpos + ((size_t)b * p.N + n) * 3;
  const float* kp;
  const float* src;
  if (MODE == kGathered) {
    src = p.gin + (((size_t)b * p.KE + j) * p.N + n) * (E + 3);
    kp = src + E;
    if (p.dg != nullptr) {
      float* drow = p.dg + (((size_t)b * p.KE + j) * p.N + n) * (E + 3);
      if (lane < 3) drow[E + lane] = 0.f;
      if (j == 0)
        for (int jj = k; jj < p.KE; ++jj) {
          float* z = p.dg + (((size_t)b * p.KE + jj) * p.N + n) * (E + 3);
          for (int col = lane; col < E + 3; col += 32) z[col] = 0.f;
        }
    }
  } else {
    const int idx = p.ki[((size_t)b * p.N + n) * p.KS + j];
    src = p.kv + ((size_t)b * p.M + idx) * (p.premul ? 2 * D : E);
    kp = p.kpos + ((size_t)b * p.M + idx) * 3;
  }
  auto key = [&](const float* x, int col) { return RND ? round_bf16(x[col]) : x[col]; };
  if (lane < 3) c.rel[(size_t)r * 3 + lane] = qp[lane] - key(kp, lane);
  if (MODE == kIndex && p.premul) {
    for (int col = lane; col < D; col += 32) {
      c.kk[(size_t)r * D + col] = key(src, col);
      c.vv[(size_t)r * D + col] = key(src, D + col);
    }
  } else {
    for (int col = lane; col < E; col += 32) c.f[(size_t)r * E + col] = key(src, col);
  }
}

// ph = relu(rel W1 + b1), one thread per (row, hidden unit).
__global__ void pos_hidden_kernel(const float* __restrict__ rel,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ b1, float* __restrict__ ph,
                                  int R, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * P) return;
  const int r = (int)(i / P), c = (int)(i % P);
  float acc = 0.f;
  for (int kk = 0; kk < 3; ++kk) acc = fmaf(rel[(size_t)r * 3 + kk], w1[kk * P + c], acc);
  ph[i] = fmaxf(acc + b1[c], 0.f);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

#define O4D_TRY(x)                          \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

}  // namespace
