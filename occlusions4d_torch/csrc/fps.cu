// Farthest point sampling for Hopper. Replaces
// occlusions4d_tpu/ops/pallas_fps.py::_fps_kernel (:39).
//
// Function (per example): sel[0] = start; then for i = 1 .. n_out-1
//   d      = (x - px)^2 + (y - py)^2 + (z - pz)^2   (distance to the last pick)
//   min_d  = min(min_d, d)                          (running field, init +inf)
//   score  = min_d + penalty                        (penalty -inf at invalid)
//   sel[i] = first index attaining max(score)
// Picks are returned in pick order; the wrapper sorts them. The file is built
// with -fmad=false and the squares are summed in the plain version's order,
// so every pick equals the plain PyTorch loop's, duplicate points included
// (one divergent pick would shift every later one). An invalid point starts
// its field at -inf instead of +inf: min(-inf, d) stays -inf, which is the
// bits of min_d + penalty for both kinds of point, so score is the field.
//
// What bounds it on the H100: the chain of n_out dependent argmax steps, not
// bytes or FLOPs (14336 points x 4779 picks is 0.5 GFLOP). A pick costs a
// scan of the example's points (about 12 instructions a point: one SM's 128
// lanes take about 0.8 us at 14336 points) plus a fixed cost for the
// reduction and its barriers (about 0.78 us with one block of 1024 threads
// and two block barriers a pick).
//
// Design: one thread-block cluster of C blocks per example (the speed rule
// choosing C and the block size stands at o4d_fps_plan). Block r
// owns points [r S, (r + 1) S), S = ceil(N / C). Per pick:
//   * each thread scans its points (point i on thread i mod T), updates
//     their fields and keeps the first index of its largest score;
//   * each warp reduces its lanes with two redux.sync on a packed key: the
//     order-preserving bits of the score (float_key) and the complement of
//     the index, so that the lexicographic max is the largest score at the
//     lowest index; the winning lane supplies the point's coordinates;
//   * lanes 0 .. C-1 of every warp push (key, coordinates) into the slot of
//     that warp in every block of the cluster with st.async (Hopper's
//     distributed shared memory), which completes 24 bytes of the receiving
//     block's mbarrier; the slots are double-buffered by the pick's parity;
//   * every warp waits on its own block's mbarrier for the C x T / 32 pushes
//     of this pick (no barrier across the cluster, no remote read), then
//     reduces the slots the same way and so knows the pick and its
//     coordinates.
// A warp pushes pick i + 1 only after it has read pick i's slots, and no
// block can finish pick i + 1 before every warp has pushed it, so a push for
// pick i + 2 never lands in a buffer a warp still reads for pick i. Waiting
// for the pushes instead of a barrier.cluster took 0.87 us a pick at 14336
// points (8 x 256) against 1.37 on an H100 80GB HBM3 at 700 W. Integer maxima
// decide every pick: the result is deterministic.
// Where the points live (MODE): in registers (256 threads, up to 28 points a
// thread), or, for larger slices, in a device-memory workspace of
// (x, y, z, min_d) rows (1024 threads), 16 B read and 4 B written per point
// and pick, L2-resident: no cap on N.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kRegThreads = 256;     // MODE kRegs block
constexpr int kRegMaxPPT = 28;
constexpr int kDevThreads = 1024;    // MODE kDevice block

enum { kRegs = 0, kDevice = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Unsigned comparison of keys orders as the floats do (-inf lowest, -0 below
// +0, denormals in place); 0 is below every score: the empty candidate.
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The lexicographic max of (key, nidx) over the warp, nidx the complement of
// a point's index; returns the lane holding it (the first one on a tie of
// empty candidates).
__device__ __forceinline__ int warp_winner(uint32_t key, uint32_t nidx, uint32_t& wk,
                                           uint32_t& wn) {
  wk = __reduce_max_sync(0xffffffffu, key);
  wn = __reduce_max_sync(0xffffffffu, key == wk ? nidx : 0u);
  return __ffs(__ballot_sync(0xffffffffu, key == wk && nidx == wn)) - 1;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of the same shared-memory variable in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// The slot buffers' mbarriers: one arrival (thread 0's, with the phase's
// byte count) plus the bytes every block's st.async pushes complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity; a push that never lands fails
// the launch (trap) instead of hanging it.
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

// The slot's record into block `rank`, completing 24 bytes of that block's
// mbarrier.
__device__ __forceinline__ void push(uint2* key_slot, float4* crd_slot, uint64_t* bar,
                                            int rank, uint2 k, float4 c) {
  const uint32_t rb = remote(bar, rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          remote(key_slot, rank)),
      "r"(k.x), "r"(k.y), "r"(rb)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote(crd_slot, rank)),
      "r"(__float_as_uint(c.x)), "r"(__float_as_uint(c.y)), "r"(__float_as_uint(c.z)),
      "r"(__float_as_uint(c.w)), "r"(rb)
      : "memory");
}

__device__ __forceinline__ float sqdist(float x, float y, float z, float px, float py,
                                        float pz) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py), dz = __fsub_rn(z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

struct FpsArgs {
  const float* xyz;      // (B, N, 3)
  const uint8_t* valid;  // (B, N) bool
  const int* start;      // (B)
  int* out;              // (B, n_out) picks in pick order
  float4* ws;            // (B, N) rows (x, y, z, min_d): MODE kDevice only
  int N, n_out, S;       // S points per block
};

// Bytes of the pick slots: 2 buffers of C x T / 32 (uint2 key, float4 point).
constexpr size_t slot_bytes(int C, int T) { return (size_t)2 * C * (T / 32) * (8 + 16); }

template <int T, int PPT, int MODE>
__global__ void __launch_bounds__(T, 1) fps_kernel(FpsArgs p) {
  constexpr int W = T / 32;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int C = gridDim.x, r = blockIdx.x, b = blockIdx.y;  // grid x is the cluster
  const int nslot = C * W;
  float4* crd = reinterpret_cast<float4*>(smraw);                   // [2][nslot]
  uint2* keys = reinterpret_cast<uint2*>(crd + 2 * nslot);          // [2][nslot]
  __shared__ __align__(8) uint64_t full[2];  // the slot buffers' pushes have landed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = r * p.S, n_loc = max(0, min(p.S, p.N - base));
  const float* xb = p.xyz + (size_t)b * p.N * 3;
  const uint8_t* vb = p.valid + (size_t)b * p.N;
  float4* wb = p.ws + (size_t)b * p.N + base;

  float mind[PPT], px[PPT], py[PPT], pz[PPT];
  if constexpr (MODE == kDevice) {
    for (int i = tid; i < n_loc; i += T) {
      const size_t g = (size_t)(base + i);
      wb[i] = make_float4(xb[3 * g], xb[3 * g + 1], xb[3 * g + 2],
                          vb[g] ? CUDART_INF_F : -CUDART_INF_F);
    }
  } else {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int i = tid + q * T;
      mind[q] = -CUDART_INF_F;
      if (i < n_loc) {
        const size_t g = (size_t)(base + i);
        px[q] = xb[3 * g];
        py[q] = xb[3 * g + 1];
        pz[q] = xb[3 * g + 2];
        mind[q] = vb[g] ? CUDART_INF_F : -CUDART_INF_F;
      }
    }
  }
  const int s0 = p.start[b];
  float wx = xb[3 * (size_t)s0], wy = xb[3 * (size_t)s0 + 1], wz = xb[3 * (size_t)s0 + 2];
  int* ob = p.out + (size_t)b * p.n_out;
  if (r == 0 && tid == 0) ob[0] = s0;
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block of the cluster has started (its slots and mbarriers exist)
  // and this block's points are in place.
  cluster_barrier();

  for (int it = 1; it < p.n_out; ++it) {
    const int j = it - 1, buf = j & 1;  // buffer buf's (j / 2)-th use
    if (tid == 0) mbar_expect(&full[buf], (uint32_t)nslot * 24u);
    // The thread's first largest score: its first point is taken as is (an
    // invalid one too), later ones only when strictly larger.
    float best = -CUDART_INF_F, cx = 0.f, cy = 0.f, cz = 0.f;
    int bi = -1;
    if constexpr (MODE == kDevice) {
      for (int i = tid; i < n_loc; i += T) {
        const float4 v = wb[i];
        const float m = fminf(v.w, sqdist(v.x, v.y, v.z, wx, wy, wz));
        wb[i].w = m;
        if (bi < 0 || m > best) {
          best = m;
          bi = i;
          cx = v.x;
          cy = v.y;
          cz = v.z;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int i = tid + q * T;
        if (i < n_loc) {
          const float m = fminf(mind[q], sqdist(px[q], py[q], pz[q], wx, wy, wz));
          mind[q] = m;
          if (q == 0 || m > best) {
            best = m;
            bi = i;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < PPT; ++q)  // the candidate's coordinates, by selects.
        if (bi == tid + q * T) {
          cx = px[q];
          cy = py[q];
          cz = pz[q];
        }
    }
    uint32_t wk, wn;
    const int wl = warp_winner(bi >= 0 ? float_key(best) : 0u,
                               bi >= 0 ? ~(uint32_t)(base + bi) : 0u, wk, wn);
    cx = __shfl_sync(0xffffffffu, cx, wl);
    cy = __shfl_sync(0xffffffffu, cy, wl);
    cz = __shfl_sync(0xffffffffu, cz, wl);
    const int slot = buf * nslot + r * W + warp;
    if (lane < C)
      push(keys + slot, crd + slot, full + buf, lane, make_uint2(wk, wn),
           make_float4(cx, cy, cz, 0.f));
    mbar_wait(&full[buf], (j >> 1) & 1);
    // Every warp: the pick over the C x W slots of this buffer.
    uint32_t k = 0, n = 0;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = lane; s < nslot; s += 32) {
      const uint2 v = keys[buf * nslot + s];
      const float4 c = crd[buf * nslot + s];
      if (v.x > k || (v.x == k && v.y > n)) {
        k = v.x;
        n = v.y;
        w = c;
      }
    }
    const int wl2 = warp_winner(k, n, wk, wn);
    wx = __shfl_sync(0xffffffffu, w.x, wl2);
    wy = __shfl_sync(0xffffffffu, w.y, wl2);
    wz = __shfl_sync(0xffffffffu, w.z, wl2);
    if (r == 0 && tid == 0) ob[it] = (int)~wn;
  }
  // No block leaves while a peer's last pushes into it may be in flight.
  if (C > 1) cluster_barrier();
}

template <int T, int PPT, int MODE>
cudaError_t launch(const FpsArgs& a, int B, int C, size_t smem, cudaStream_t s) {
  auto kern = fps_kernel<T, PPT, MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// MODE of a block of T threads holding S points; -1 when T is neither block
// size or S exceeds MODE kRegs' registers.
int mode_of(int S, int T) {
  if (T == kRegThreads) return S <= kRegThreads * kRegMaxPPT ? kRegs : -1;
  if (T == kDevThreads) return kDevice;
  return -1;
}

int run(const void* xyz, const void* valid, const void* start, void* out, void* ws, int B,
        int N, int n_out, int C, int T, void* stream) {
  if (B <= 0 || n_out <= 0) return 0;
  if (N <= 0 || C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  const int S = (N + C - 1) / C;
  const int mode = mode_of(S, T);
  if (mode < 0 || (mode == kDevice && ws == nullptr)) return (int)cudaErrorInvalidValue;
  FpsArgs a;
  a.xyz = (const float*)xyz;
  a.valid = (const uint8_t*)valid;
  a.start = (const int*)start;
  a.out = (int*)out;
  a.ws = (float4*)ws;
  a.N = N;
  a.n_out = n_out;
  a.S = S;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t slots = slot_bytes(C, T);
  const int ppt = (S + T - 1) / T;
  cudaError_t e;
  if (mode == kRegs) {
    if (ppt <= 1) e = launch<kRegThreads, 1, kRegs>(a, B, C, slots, s);
    else if (ppt <= 2) e = launch<kRegThreads, 2, kRegs>(a, B, C, slots, s);
    else if (ppt <= 4) e = launch<kRegThreads, 4, kRegs>(a, B, C, slots, s);
    else if (ppt <= 8) e = launch<kRegThreads, 8, kRegs>(a, B, C, slots, s);
    else if (ppt <= 12) e = launch<kRegThreads, 12, kRegs>(a, B, C, slots, s);
    else if (ppt <= 16) e = launch<kRegThreads, 16, kRegs>(a, B, C, slots, s);
    else if (ppt <= 20) e = launch<kRegThreads, 20, kRegs>(a, B, C, slots, s);
    else if (ppt <= 24) e = launch<kRegThreads, 24, kRegs>(a, B, C, slots, s);
    else e = launch<kRegThreads, kRegMaxPPT, kRegs>(a, B, C, slots, s);
  } else {
    e = launch<kDevThreads, 1, kDevice>(a, B, C, slots, s);
  }
  return (int)e;
}

}  // namespace

// The speed rule: the cluster size C and block size T for B examples of N
// points. Measured on an NVIDIA H100 80GB HBM3 at 700 W (the sweep in
// PERF.md; B 1 and 3 alike, examples run on their own SMs): a pick costs
// about 0.6 us of pushes, waits and reductions whatever C, and the scan
// about 0.1 us per 1000 points a block holds in registers, so C grows until
// a block holds about 512 points (1593 points: 4 x 256 at 0.61 us a pick,
// one block 0.82; 14336: 8 x 256 at 0.87). Blocks of 256 threads keep their
// points in registers up to 7168 a block (57344 points: 1.75 us a pick);
// larger slices take 1024 threads with the points in device memory.
extern "C" void o4d_fps_plan(int B, int N, int* C, int* T) {
  (void)B;
  int c = (N + 511) / 512;
  if (c > kMaxCluster) c = kMaxCluster;
  if (c < 1) c = 1;
  const int S = (N + c - 1) / c;
  *C = c;
  *T = S <= kRegThreads * kRegMaxPPT ? kRegThreads : kDevThreads;
}

// Floats of the device-memory workspace a launch with T threads a block
// needs (0 when the points stay in registers).
extern "C" long long o4d_fps_ws_floats(int B, int N, int T) {
  return T == kDevThreads ? 4LL * B * N : 0;
}

// xyz (B, N, 3) f32; valid (B, N) bool; start (B) int32; out (B, n_out)
// int32 picks in pick order; ws: o4d_fps_ws_floats floats or null; one
// cluster of C (1 .. 8) blocks of T threads per example.
extern "C" int o4d_fps(const void* xyz, const void* valid, const void* start, void* out,
                       void* ws, int B, int N, int n_out, int C, int T, void* stream) {
  return run(xyz, valid, start, out, ws, B, N, n_out, C, T, stream);
}
