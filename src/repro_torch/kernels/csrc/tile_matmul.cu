// Tile GEMM with an epilogue for Hopper (sm_90a):
//
//     out = beta * C + alpha * A . op(B),   op(B) = B or B^T
//
// A is (M, K), B is (K, N) or, with trans_b, (N, K); C and out are (M, N).
// All are row-major with leading dimensions lda/ldb/ldc/ldo.  Instantiated
// for float64 (accumulates in float64), float32 and bfloat16 (accumulate in
// float32, store in the input type, as the TPU kernel does).
//
// Replaces: repro/kernels/tile_matmul.py::tile_matmul (the Pallas kernel
// `_mm_kernel`), C = A @ B with an f32 accumulator carried across a
// sequential K grid axis.  Here blocks run in parallel and carry nothing
// between them; the epilogue adds the `+ C` of the reference oracle and the
// `C - A B^T` of the Cholesky trailing update (`tile_gemm_sub`: alpha = -1,
// beta = 1, trans_b) or the `C - A B` of LU and QR (`tile_gemm_nn_sub`), and
// ragged M, N, K are masked, so the paper's b = 192 tile and any other
// shape are taken without padding.
//
// In place: `out` may be `C` itself.  Each output element is read from C
// and written to out by one thread, once, after every partial product of
// it is summed, so the update is safe; the task graph's edges give a
// trailing-update task exclusive access to its C tile.  A and B must not
// overlap out.
//
// What bounds it on an H100: at the main path's shape (192 x 192 x 192,
// float64) one update moves 4 tiles of 295 KB (A, B, C read, out written),
// 0.35 us at 3.35 TB/s, against 14.2 MFLOP, 0.21 us at the 67 TFLOP/s
// float64 tensor-core rate: bytes bound it, and both are far below a
// launch's own cost of a few microseconds.  What a 192^3 tile needs is
// many SMs working at once, each with little serial work and every load
// in flight together.
//
// float64 design (dmma_kernel): 32 x 32 output blocks of 4 warps, each warp
// a 16 x 16 patch of 2 x 2 `mma.sync.m8n8k4` f64 products (DMMA, the
// float64 tensor cores).  Their row.col layout is the trailing update's
// trans_b case as it lies in memory: A rows and B rows are both K-major.
// Non-transposed B is staged transposed in shared memory by the copies
// themselves.  K is cut into 16-deep slices, and the slices into `splits`
// contiguous ranges (the wrapper's gemm_splits, a function of M, N and K
// only): 4 at 192^3, so 36 output blocks become 144.  A block's slices
// stream in through 8-byte cp.async copies (zero-filled past the ragged
// edge) into a ring of 3 stages, so a range of up to 3 slices arrives in
// one shot.  The splits of one output block form a thread-block cluster:
// each leaves its partial sums in shared memory, and after a cluster
// barrier block z sums rows [z r, z r + r) of all partials in split order
// through distributed shared memory and applies the epilogue.  No scratch,
// no atomics: the same shapes sum in the same order on every launch, so the
// Cholesky's factors are bit-identical across schedules.
//
// float32 and bfloat16 (simt_kernel, off every main path): 32 x 32 output
// blocks of 256 threads, each a 2 x 2 patch, with A and op(B) passing
// through shared memory in 32-deep K slices and plain float32 FMAs (float32
// keeps full float32 products: no TF32).
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- float64
constexpr int kDBM = 32;           // output rows per block
constexpr int kDBN = 32;           // output columns per block
constexpr int kDKS = 16;           // depth of one K slice
constexpr int kDPitch = kDKS + 4;  // row pitch in shared memory (doubles)
constexpr int kDStages = 3;        // slices in flight
constexpr int kDThreads = 128;     // 4 warps, a 16 x 16 patch each
constexpr int kMaxSplits = 8;      // the largest portable cluster

struct DmmaSmem {
  double a[kDStages][kDBM][kDPitch];   // a[s][m][k] = A[m0 + m][k0 + k]
  double b[kDStages][kDBN][kDPitch];   // b[s][n][k] = op(B)[k0 + k][n0 + n]
  double part[kDBM][kDBN + 1];         // this split's partial sums
};

// one K slice [k0, k0 + kDKS) of A and op(B) into ring stage `s`
__device__ __forceinline__ void load_slice(DmmaSmem& sm, int s,
                                           const double* a, const double* b,
                                           int M, int N, int K, int lda,
                                           int ldb, bool trans_b, int m0,
                                           int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kDBM * kDKS / kDThreads; ++u) {
    // neighbouring threads copy neighbouring k of one row of A
    const int e = tid + u * kDThreads;
    const int r = e / kDKS, kk = e % kDKS;
    const int gm = m0 + r, gk = k0 + kk;
    const bool ok = gm < M && gk < K;
    hopper::cp_async<8>(&sm.a[s][r][kk], ok ? a + int64_t(gm) * lda + gk : a,
                        ok);
  }
#pragma unroll
  for (int u = 0; u < kDBN * kDKS / kDThreads; ++u) {
    const int e = tid + u * kDThreads;
    int col, kk;
    if (trans_b) {                     // op(B)[k][n] = B[n][k]: along k
      col = e / kDKS;
      kk = e % kDKS;
    } else {                           // B[k][n]: along n, stored transposed
      kk = e / kDBN;
      col = e % kDBN;
    }
    const int gn = n0 + col, gk = k0 + kk;
    const bool ok = gn < N && gk < K;
    const double* src = trans_b ? b + int64_t(gn) * ldb + gk
                                : b + int64_t(gk) * ldb + gn;
    hopper::cp_async<8>(&sm.b[s][col][kk], ok ? src : b, ok);
  }
}

__global__ void __launch_bounds__(kDThreads)
dmma_kernel(const double* __restrict__ a, const double* __restrict__ b,
            const double* c, double* out, int M, int N, int K, int lda,
            int ldb, int ldc, int ldo, bool trans_b, double alpha,
            double beta, int per) {
  __shared__ DmmaSmem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kDBM;
  const int n0 = blockIdx.x * kDBN;
  const int split = blockIdx.z;        // = the block's rank in its cluster
  const int splits = gridDim.z;
  const int slices = (K + kDKS - 1) / kDKS;
  const int s_begin = split * per;
  const int s_count = max(0, min(s_begin + per, slices) - s_begin);
  const int wm = (warp >> 1) * 16;     // the warp's patch
  const int wn = (warp & 1) * 16;

  double acc[2][2][2] = {};
  // the ring: slices i .. i + kDStages - 2 are in flight when slice i is
  // computed; every iteration commits one group (empty past the end), so
  // waiting for all but kDStages - 2 groups means slice i has landed
#pragma unroll
  for (int i = 0; i < kDStages - 1; ++i) {
    if (i < s_count)
      load_slice(sm, i, a, b, M, N, K, lda, ldb, trans_b, m0, n0,
                 (s_begin + i) * kDKS);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < s_count; ++i) {
    hopper::cp_async_wait<kDStages - 2>();
    __syncthreads();                   // slice i is visible; slice i - 1 done
    const int next = i + kDStages - 1;
    if (next < s_count)
      load_slice(sm, next % kDStages, a, b, M, N, K, lda, ldb, trans_b, m0,
                 n0, (s_begin + next) * kDKS);
    hopper::cp_async_commit();
    const int s = i % kDStages;
#pragma unroll
    for (int kk = 0; kk < kDKS; kk += 4) {
      double fa[2], fb[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        fa[x] = sm.a[s][wm + 8 * x + g][kk + t];
        fb[x] = sm.b[s][wn + 8 * x + g][kk + t];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y) hopper::mma_f64_m8n8k4(acc[x][y], fa[x], fb[y]);
    }
  }
  hopper::cp_async_wait<0>();

  if (splits == 1) {                   // no partner: the epilogue in place
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int gm = m0 + wm + 8 * x + g, gn = n0 + wn + 8 * y + 2 * t + v;
          if (gm < M && gn < N) {
            double r = alpha * acc[x][y][v];
            if (c != nullptr) r += beta * c[int64_t(gm) * ldc + gn];
            out[int64_t(gm) * ldo + gn] = r;
          }
        }
    return;
  }

#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        sm.part[wm + 8 * x + g][wn + 8 * y + 2 * t + v] = acc[x][y][v];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every split's partials are written
  const int rows = (kDBM + splits - 1) / splits;
  const int r0 = split * rows;
  for (int e = tid; e < rows * kDBN; e += kDThreads) {
    const int r = r0 + e / kDBN, col = e % kDBN;
    const int gm = m0 + r, gn = n0 + col;
    if (r >= kDBM || gm >= M || gn >= N) continue;
    double sum = 0.0;
    for (int q = 0; q < splits; ++q)   // in split order: the same bits always
      sum += *cluster.map_shared_rank(&sm.part[r][col], q);
    double v = alpha * sum;
    if (c != nullptr) v += beta * c[int64_t(gm) * ldc + gn];
    out[int64_t(gm) * ldo + gn] = v;
  }
  cluster.sync();                      // peers' shared memory stays until read
}

int launch_f64(const void* a, const void* b, const void* c, void* out, int M,
               int N, int K, int lda, int ldb, int ldc, int ldo, int trans_b,
               double alpha, double beta, int splits, int per,
               cudaStream_t stream) {
  const int slices = (K + kDKS - 1) / kDKS;
  if (splits < 1 || splits > kMaxSplits || per < 1 ||
      int64_t(splits) * per < slices)
    return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kDBN - 1) / kDBN, (M + kDBM - 1) / kDBM, splits);
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(
      &cfg, dmma_kernel, static_cast<const double*>(a),
      static_cast<const double*>(b), static_cast<const double*>(c),
      static_cast<double*>(out), M, N, K, lda, ldb, ldc, ldo, trans_b != 0,
      alpha, beta, per));
}

// ---------------------------------------------------- float32 and bfloat16
constexpr int kBM = 32;           // output rows per block
constexpr int kBN = 32;           // output columns per block
constexpr int kBK = 32;           // depth of one shared-memory K slice
constexpr int kThreads = 256;     // 16 x 16 threads, a 2 x 2 patch each

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* c,
            T* out, int M, int N, int K, int lda, int ldb, int ldc, int ldo,
            bool trans_b, float alpha, float beta) {
  __shared__ float as[kBK][kBM + 1];   // as[k][m] = A[m0 + m][k0 + k]
  __shared__ float bs[kBK][kBN + 1];   // bs[k][n] = op(B)[k0 + k][n0 + n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // neighbouring threads read neighbouring k of one row of A: coalesced
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < M && gk < K) ? to_acc(a[int64_t(gm) * lda + gk]) : 0.f;
    }
    if (trans_b) {
      // op(B)[k][n] = B[n][k]: read along k, as for A
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int col = i / kBK, kk = i % kBK;
        const int gn = n0 + col, gk = k0 + kk;
        bs[kk][col] = (gn < N && gk < K) ? to_acc(b[int64_t(gn) * ldb + gk]) : 0.f;
      }
    } else {
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int kk = i / kBN, col = i % kBN;
        const int gn = n0 + col, gk = k0 + kk;
        bs[kk][col] = (gn < N && gk < K) ? to_acc(b[int64_t(gk) * ldb + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float a0 = as[kk][ty], a1 = as[kk][ty + 16];
      const float b0 = bs[kk][tx], b1 = bs[kk][tx + 16];
      acc[0][0] += a0 * b0;
      acc[0][1] += a0 * b1;
      acc[1][0] += a1 * b0;
      acc[1][1] += a1 * b1;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        float v = alpha * acc[i][j];
        if (c != nullptr) v += beta * to_acc(c[int64_t(gm) * ldc + gn]);
        store(out + int64_t(gm) * ldo + gn, v);
      }
    }
  }
}

template <typename T>
int launch_simt(const void* a, const void* b, const void* c, void* out,
                int M, int N, int K, int lda, int ldb, int ldc, int ldo,
                int trans_b, double alpha, double beta, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  simt_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(out), M, N, K, lda, ldb, ldc,
      ldo, trans_b != 0, static_cast<float>(alpha), static_cast<float>(beta));
  return 0;
}

}  // namespace

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  `c` may be null (no C
// term).  float64 cuts K into `splits` ranges of `per` 16-deep slices
// (gemm_splits; splits <= 8 and splits * per covering K); the other types
// ignore both.  Returns a cudaError_t as int: 0 when the launch was
// accepted.
extern "C" int tile_matmul_launch(int dtype, const void* a, const void* b,
                                  const void* c, void* out, int M, int N,
                                  int K, int lda, int ldb, int ldc, int ldo,
                                  int trans_b, double alpha, double beta,
                                  int splits, int per, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 0:
      err = launch_f64(a, b, c, out, M, N, K, lda, ldb, ldc, ldo, trans_b,
                       alpha, beta, splits, per, s);
      break;
    case 1:
      err = launch_simt<float>(a, b, c, out, M, N, K, lda, ldb, ldc, ldo,
                               trans_b, alpha, beta, s);
      break;
    case 2:
      err = launch_simt<__nv_bfloat16>(a, b, c, out, M, N, K, lda, ldb, ldc,
                                       ldo, trans_b, alpha, beta, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
