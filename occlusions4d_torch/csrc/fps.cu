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
// (one divergent pick would shift every later one).
//
// What bounds it on the H100: the chain of n_out dependent argmax steps, not
// bytes or FLOPs (14336 points x 4779 picks is 0.5 GFLOP). Each step is a
// block-wide reduction, so the design is one thread block of 1024 threads per
// example: coordinates live in shared memory (12 B per point, 172 KB at
// 14336 points), the running min-distance field and the penalty in registers
// (PPT points per thread, point i on thread i % 1024, so shared-memory reads
// are conflict-free), and each step is a per-thread scan, a warp shuffle
// argmax and one cross-warp pass, two __syncthreads per pick. One example per
// SM leaves the rest of the card idle at B = 1.
//
// Clouds larger than one SM's shared memory (N > 19200: the n57344 encoder's
// first level, 57344 -> 19115) take the second entry, o4d_fps_cluster: one
// thread-block cluster of kCluster blocks per example (Hopper's distributed
// shared memory). Block r holds points [r S, (r + 1) S), S = ceil(N / 8), in
// its shared memory (86 KB at 57344) and their running minima in registers.
// Per pick: each block takes the (max, first index) of its slice as above and
// posts it in its shared memory; one cluster barrier; then every block reads
// the kCluster candidates through map_shared_rank, reduces them with the lower
// global index winning ties (so the pick is the first index of the global
// max), and reads the winner's coordinates from its owner's shared memory.
// The candidate slots alternate between two buffers, so a block posting pick
// i + 1 never overwrites a slot another block still reads for pick i, and one
// cluster barrier per pick suffices. The arithmetic is the one-block kernel's,
// so both entries pick the same indices.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 8;
constexpr int kMaxPoints = 19200;  // per block: 3 floats each in shared memory.

__device__ __forceinline__ bool wins(float s, int i, float S, int I) {
  return s > S || (s == S && i < I);
}

// Block-local (max score, first index) over this thread's points and then
// the block: the one-block kernel's scan and reductions, on global indices
// base + local. Every lane of warp 0 holds the result after the call.
template <int PPT>
__device__ __forceinline__ void block_argmax(const float* sx, const float* sy,
                                             const float* sz, float* mind,
                                             const float* pen, int n_loc, int base,
                                             float px, float py, float pz,
                                             float* red_s, int* red_i, float& best,
                                             int& bi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  best = -CUDART_INF_F;
  bi = 0x7fffffff;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = tid + p * kThreads;
    if (i < n_loc) {
      const float dx = __fsub_rn(sx[i], px);
      const float dy = __fsub_rn(sy[i], py);
      const float dz = __fsub_rn(sz[i], pz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      mind[p] = fminf(mind[p], d);
      const float s = __fadd_rn(mind[p], pen[p]);
      if (wins(s, base + i, best, bi)) {
        best = s;
        bi = base + i;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (wins(os, oi, best, bi)) {
      best = os;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_s[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = red_s[lane];
    bi = red_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (wins(os, oi, best, bi)) {
        best = os;
        bi = oi;
      }
    }
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1) fps_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ penalty,
                           const int* __restrict__ start, int* __restrict__ out,
                           int N, int n_out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  __shared__ float red_s[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xb = xyz + (size_t)b * N * 3;
  for (int i = tid; i < N; i += kThreads) {
    sx[i] = xb[3 * i];
    sy[i] = xb[3 * i + 1];
    sz[i] = xb[3 * i + 2];
  }
  float mind[PPT], pen[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = tid + p * kThreads;
    mind[p] = CUDART_INF_F;
    pen[p] = i < N ? penalty[(size_t)b * N + i] : 0.f;
  }
  int* ob = out + (size_t)b * n_out;
  if (tid == 0) {
    s_last = start[b];
    ob[0] = start[b];
  }
  __syncthreads();

  for (int it = 1; it < n_out; ++it) {
    const int last = s_last;
    float best;
    int bi;
    block_argmax<PPT>(sx, sy, sz, mind, pen, N, 0, sx[last], sy[last], sz[last], red_s,
                      red_i, best, bi);
    if (tid == 0) {
      s_last = bi;
      ob[it] = bi;
    }
    __syncthreads();
  }
}

template <int PPT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, const float* __restrict__ penalty,
                       const int* __restrict__ start, int* __restrict__ out, int N,
                       int n_out, int S) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + S;
  float* sz = smem + 2 * S;
  __shared__ float red_s[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ float cand_s[2];  // this block's candidate, double-buffered.
  __shared__ int cand_i[2];
  __shared__ float s_p[3];     // the last pick's coordinates.

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = r * S;
  const int n_loc = max(0, min(S, N - base));
  const float* xb = xyz + ((size_t)b * N + base) * 3;
  for (int i = tid; i < n_loc; i += kThreads) {
    sx[i] = xb[3 * i];
    sy[i] = xb[3 * i + 1];
    sz[i] = xb[3 * i + 2];
  }
  float mind[PPT], pen[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = tid + p * kThreads;
    mind[p] = CUDART_INF_F;
    pen[p] = i < n_loc ? penalty[(size_t)b * N + base + i] : 0.f;
  }
  int* ob = out + (size_t)b * n_out;
  const int s0 = start[b];
  if (tid == 0 && r == 0) ob[0] = s0;
  cluster.sync();  // every block's coordinates are in place.
  if (tid == 0) {
    const int owner = s0 / S, li = s0 - owner * S;
    s_p[0] = *cluster.map_shared_rank(sx + li, owner);
    s_p[1] = *cluster.map_shared_rank(sy + li, owner);
    s_p[2] = *cluster.map_shared_rank(sz + li, owner);
  }
  __syncthreads();

  for (int it = 1; it < n_out; ++it) {
    const int buf = it & 1;
    float best;
    int bi;
    block_argmax<PPT>(sx, sy, sz, mind, pen, n_loc, base, s_p[0], s_p[1], s_p[2],
                      red_s, red_i, best, bi);
    if (tid == 0) {
      cand_s[buf] = best;
      cand_i[buf] = bi;
    }
    cluster.sync();  // every block's candidate for this pick is posted.
    if (warp == 0) {
      best = -CUDART_INF_F;
      bi = 0x7fffffff;
      if (lane < kCluster) {
        best = *cluster.map_shared_rank(cand_s + buf, lane);
        bi = *cluster.map_shared_rank(cand_i + buf, lane);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (wins(os, oi, best, bi)) {
          best = os;
          bi = oi;
        }
      }
      if (lane == 0) {
        const int owner = bi / S, li = bi - owner * S;
        s_p[0] = *cluster.map_shared_rank(sx + li, owner);
        s_p[1] = *cluster.map_shared_rank(sy + li, owner);
        s_p[2] = *cluster.map_shared_rank(sz + li, owner);
        if (r == 0) ob[it] = bi;
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may read its shared memory.
}

}  // namespace

// Coordinates must fit one block's dynamic shared memory (227 KB less the
// static reduction buffers).
extern "C" int o4d_fps_max_points() { return kMaxPoints; }

// The cluster entry's limit: kCluster blocks of kMaxPoints points.
extern "C" int o4d_fps_cluster_max_points() { return kCluster * kMaxPoints; }

// xyz (B, N, 3) f32; penalty (B, N) f32 (0 valid, -inf invalid); start (B)
// int32; out (B, n_out) int32 picks in pick order.
extern "C" int o4d_fps(const void* xyz, const void* penalty, const void* start,
                       void* out, int B, int N, int n_out, void* stream) {
  if (B <= 0 || n_out <= 0) return 0;
  if (N <= 0 || N > o4d_fps_max_points()) return (int)cudaErrorInvalidValue;
  const int ppt = (N + kThreads - 1) / kThreads;
  const size_t smem = (size_t)N * 3 * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define O4D_FPS(P)                                                            \
  {                                                                           \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
    if (e != cudaSuccess) return (int)e;                                      \
    fps_kernel<P><<<B, kThreads, smem, s>>>(                                  \
        (const float*)xyz, (const float*)penalty, (const int*)start,          \
        (int*)out, N, n_out);                                                 \
  }
  if (ppt <= 1) O4D_FPS(1)
  else if (ppt <= 2) O4D_FPS(2)
  else if (ppt <= 4) O4D_FPS(4)
  else if (ppt <= 8) O4D_FPS(8)
  else if (ppt <= 12) O4D_FPS(12)
  else if (ppt <= 16) O4D_FPS(16)
  else O4D_FPS(19)
#undef O4D_FPS
  return (int)cudaGetLastError();
}

// As o4d_fps, for kCluster * o4d_fps_max_points() >= N > o4d_fps_max_points():
// one cluster of kCluster blocks per example.
extern "C" int o4d_fps_cluster(const void* xyz, const void* penalty, const void* start,
                               void* out, int B, int N, int n_out, void* stream) {
  if (B <= 0 || n_out <= 0) return 0;
  if (N <= 0 || N > o4d_fps_cluster_max_points()) return (int)cudaErrorInvalidValue;
  const int S = (N + kCluster - 1) / kCluster;
  const int ppt = (S + kThreads - 1) / kThreads;
  const size_t smem = (size_t)S * 3 * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(kCluster, B);
#define O4D_FPS_CLUSTER(P)                                                     \
  {                                                                            \
    cudaError_t e = cudaFuncSetAttribute(fps_cluster_kernel<P>,                \
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                         (int)smem);                           \
    if (e != cudaSuccess) return (int)e;                                       \
    fps_cluster_kernel<P><<<grid, kThreads, smem, s>>>(                        \
        (const float*)xyz, (const float*)penalty, (const int*)start, (int*)out, \
        N, n_out, S);                                                          \
  }
  if (ppt <= 1) O4D_FPS_CLUSTER(1)
  else if (ppt <= 2) O4D_FPS_CLUSTER(2)
  else if (ppt <= 4) O4D_FPS_CLUSTER(4)
  else if (ppt <= 8) O4D_FPS_CLUSTER(8)
  else if (ppt <= 12) O4D_FPS_CLUSTER(12)
  else if (ppt <= 16) O4D_FPS_CLUSTER(16)
  else O4D_FPS_CLUSTER(19)
#undef O4D_FPS_CLUSTER
  return (int)cudaGetLastError();
}
