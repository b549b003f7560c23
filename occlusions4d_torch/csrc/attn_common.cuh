// Shared by the attention forward (csrc/attn.cu) and backward
// (csrc/attn_bwd.cu): the cp.async helpers, the 3xTF32 split and the TF32
// tensor-core product (mma.sync m16n8k8), the 128 x 128 tiled GEMM of the
// backward's phases (tensor cores in 3xTF32, f32 FMA chains, or, in the bf16
// compute mode, bf16 tensor-core products (mma.sync m16n8k16) on operands
// rounded to bf16; with its epilogue), and the row phase's first kernels:
// the row loader of the
// three entry modes (with the forward's bf16 rounding of the key rows as an
// option) and theta's hidden layer. Everything sits in an unnamed
// namespace, as it did inside each source: each .cu is its own library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The product of a block's 128 x 128 tile, in registers: on the tensor cores
// (3xTF32; the thread's fragments of its warp's 64 x 32), or with FMA on
// the CUDA cores (the thread's 8 x 8 outputs, rows ty + 16 i, columns
// 4 tx + {0..3} and 64 + 4 tx + {0..3}): every output a sequential chain
// acc = fma(a_k, b_k, acc) over k = 0, 1, ... from zero, the rounding of a
// plain f32 matrix product. BF16 (the bf16 compute mode, the TPU kernels'
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

template <bool TA, bool TB, bool FMA = false, bool BF16 = false>
cudaError_t gemm(const GemmArgs& a, int splits, cudaStream_t s) {
  if (a.M <= 0 || a.N <= 0) return cudaSuccess;
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
