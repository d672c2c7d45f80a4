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
// sequential K grid axis.  Here the K loop runs inside the block (blocks
// run in parallel, in no order, and carry nothing between them), the
// epilogue adds the `+ C` of the reference oracle and the `C - A B^T` of the
// Cholesky trailing update (`tile_gemm_sub`: alpha = -1, beta = 1,
// trans_b), and ragged M, N, K are masked, so the paper's b = 192 tile and
// any other shape are taken without padding.
//
// In place: `out` may be `C` itself.  Each output element is read from C
// and written to out by one thread, once, after its whole K loop, so the
// update is safe; the task graph's edges give a trailing-update task
// exclusive access to its C tile.  A and B must not overlap out.
//
// What bounds it on an H100: at the main path's shape (192 x 192 x 192,
// float64) one update moves 4 tiles of 295 KB (A, B, C read, out written),
// 0.35 us at 3.35 TB/s, against 14.2 MFLOP, 0.21 us at the 67 TFLOP/s
// float64 tensor-core rate: bytes bound it, and both are far below a
// launch's own cost of a few microseconds.  The design therefore aims at
// spreading one small tile over many SMs rather than at peak FLOP/s:
// 32 x 32 output blocks give 36 blocks for a 192 x 192 tile (64 x 64 would
// give 9), 256 threads each own a 2 x 2 patch, and A and op(B) pass through
// shared memory in 32-deep K slices (padded by one column against bank
// conflicts) with plain FMAs.  wgmma, TMA and double buffering are later
// work.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 32;           // output rows per block
constexpr int kBN = 32;           // output columns per block
constexpr int kBK = 32;           // depth of one shared-memory K slice
constexpr int kThreads = 256;     // 16 x 16 threads, a 2 x 2 patch each

template <typename T> struct AccumOf { using type = T; };
template <> struct AccumOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* c, T* out, int M, int N, int K,
                   int lda, int ldb, int ldc, int ldo, bool trans_b,
                   typename AccumOf<T>::type alpha,
                   typename AccumOf<T>::type beta) {
  using Acc = typename AccumOf<T>::type;
  __shared__ Acc as[kBK][kBM + 1];   // as[k][m] = A[m0 + m][k0 + k]
  __shared__ Acc bs[kBK][kBN + 1];   // bs[k][n] = op(B)[k0 + k][n0 + n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  Acc acc[2][2] = {{Acc(0), Acc(0)}, {Acc(0), Acc(0)}};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // neighbouring threads read neighbouring k of one row of A: coalesced
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < M && gk < K) ? to_acc(a[int64_t(gm) * lda + gk]) : Acc(0);
    }
    if (trans_b) {
      // op(B)[k][n] = B[n][k]: read along k, as for A
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int col = i / kBK, kk = i % kBK;
        const int gn = n0 + col, gk = k0 + kk;
        bs[kk][col] = (gn < N && gk < K) ? to_acc(b[int64_t(gn) * ldb + gk]) : Acc(0);
      }
    } else {
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int kk = i / kBN, col = i % kBN;
        const int gn = n0 + col, gk = k0 + kk;
        bs[kk][col] = (gn < N && gk < K) ? to_acc(b[int64_t(gk) * ldb + gn]) : Acc(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const Acc a0 = as[kk][ty], a1 = as[kk][ty + 16];
      const Acc b0 = bs[kk][tx], b1 = bs[kk][tx + 16];
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
        Acc v = alpha * acc[i][j];
        if (c != nullptr) v += beta * to_acc(c[int64_t(gm) * ldc + gn]);
        store(out + int64_t(gm) * ldo + gn, v);
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, const void* c, void* out, int M,
            int N, int K, int lda, int ldb, int ldc, int ldo, int trans_b,
            double alpha, double beta, cudaStream_t stream) {
  using Acc = typename AccumOf<T>::type;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tile_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(out), M, N, K, lda, ldb, ldc,
      ldo, trans_b != 0, static_cast<Acc>(alpha), static_cast<Acc>(beta));
}

}  // namespace

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  `c` may be null (no C
// term).  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int tile_matmul_launch(int dtype, const void* a, const void* b,
                                  const void* c, void* out, int M, int N,
                                  int K, int lda, int ldb, int ldc, int ldo,
                                  int trans_b, double alpha, double beta,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<double>(a, b, c, out, M, N, K, lda, ldb, ldc, ldo, trans_b, alpha, beta, s);
      break;
    case 1:
      launch<float>(a, b, c, out, M, N, K, lda, ldb, ldc, ldo, trans_b, alpha, beta, s);
      break;
    case 2:
      launch<__nv_bfloat16>(a, b, c, out, M, N, K, lda, ldb, ldc, ldo, trans_b, alpha, beta, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
