// Mamba2 SSD chunk scan for Hopper (sm_90a).  For each batch row b and head
// h, over the chunks c = 0 .. nc-1 in order, with a float32 state s (N, P)
// that starts at zero:
//
//     y[i]  = exp(cs_i) C_i . s  +  sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) xdt_j
//     s    <- s exp(cs_L) + sum_j B_j exp(cs_L - cs_j) xdt_j
//
// where i, j run over the chunk's L steps, cs is the chunk's cumulative
// log-decay of head h and cs_L its last step.  xdt is (B, nc, L, H, P), cs
// (B, nc, L, H) float32, B and C (B, nc, L, N), all contiguous; y is (B, nc,
// L, H, P) in xdt's type and the final state (B, H, N, P) float32.  xdt, B
// and C are float32 or bfloat16 (the same type); every product and sum is
// float32.
//
// Replaces: repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel
// `_ssd_kernel`), whose grid is (B, nc) with the chunk axis sequential: one
// grid step takes a whole chunk for all heads and carries the (H, N, P)
// state to the next step in VMEM scratch.
//
// Design: CUDA blocks run in parallel and carry nothing, so the sequential
// chunk axis becomes a loop inside one block of 256 threads per (b, h),
// whose state stays in shared memory from the first chunk to the last.  Per
// chunk the block loads its head's xdt and the chunk's B and C into shared
// memory as float32, then
//   1. walks the chunk's rows in tiles of 32: for each tile it forms the
//      masked decay weights W[i][j] = (C_i . B_j) exp(cs_i - cs_j) for the
//      keys j < the tile's end, and then y[i] = exp(cs_i) (C_i . s) + sum_j
//      W[i][j] xdt_j from the *incoming* state;
//   2. scales B_j by exp(cs_L - cs_j) in place and updates the state.
// The upper triangle j > i is set to zero *without* computing its exp: with
// the model's step sizes cs falls by ~100 across a 128-step chunk, so
// exp(cs_i - cs_j) for j > i is ~e^100, inf in float32, and a 0/1 mask
// multiplied in would give inf * 0 = NaN.  Each warp owns 4 rows (or state
// rows) and each lane 1 or 2 columns (P = 32 or 64), so the operand that
// differs across a warp comes from consecutive addresses and the other is a
// broadcast; B and C rows are padded by one word against bank conflicts.
// Every sum runs in a fixed order and nothing is atomic, so the same inputs
// give the same bits on every run.
//
// What bounds it on an H100: at zamba2's prefill (B = 1, T = 512, H = 112,
// N = P = 64, L = 128) the scan needs ~1.4 GFLOP of float32 products
// (C . s and the state update L N P each per chunk and head, the lower
// triangle's W . xdt L (L+1) P, C . B^T once per chunk) against ~32 MB of
// input and output: operations bound it.  This kernel multiplies with plain
// float32 FMAs from shared memory, and recomputes C . B^T in every head's
// block (it does not depend on the head): sharing it across heads, and
// tensor-core products (wgmma) with TMA-fed tiles, are the later steps.
// One block per (b, h) gives 112 blocks at B = 1 on 132 SMs.  Shared memory:
// 4 (N P + L P + 2 L (N + 1) + 32 L + 2 L) bytes, 133 KB at zamba2's shape,
// 215 KB at mamba2-2.7b's N = 128; more than 227 KB is refused.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                  // rows per warp in a tile
constexpr int kRT = kWarps * kRows;       // 32 rows per tile
constexpr size_t kMaxSmem = 232448;       // what a block may opt into

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) *
         (size_t(N) * P + size_t(L) * P + 2 * size_t(L) * (N + 1) +
          size_t(kRT) * L + 2 * size_t(L));
}

// PC: columns per lane, P = 32 * PC
template <typename T, int PC>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ cs,
                const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, float* __restrict__ final_state, int nc,
                int L, int H, int N) {
  constexpr int P = 32 * PC;
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* sS = smem;                  // [N][P] the carried state
  float* sX = sS + N * P;            // [L][P] this head's xdt
  float* sB = sX + L * P;            // [L][ldn] B, then B_j exp(cs_L - cs_j)
  float* sC = sB + L * ldn;          // [L][ldn] C
  float* sW = sC + L * ldn;          // [kRT][L] a row tile's weights
  float* sCs = sW + kRT * L;         // [L] cs of this head
  float* sE = sCs + L;               // [L] exp(cs_L - cs_j)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < N * P; i += kThreads) sS[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t row0 = (int64_t(b) * nc + c) * L;   // the chunk's first step
    for (int i = tid; i < L * P; i += kThreads) {
      const int l = i / P;
      sX[i] = to_f(xdt[((row0 + l) * H + h) * P + (i - l * P)]);
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int l = i / N;
      const int n = i - l * N;
      sB[l * ldn + n] = to_f(bm[(row0 + l) * N + n]);
      sC[l * ldn + n] = to_f(cm[(row0 + l) * N + n]);
    }
    for (int i = tid; i < L; i += kThreads) sCs[i] = cs[(row0 + i) * H + h];
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += kRT) {
      const int jmax = min(r0 + kRT, L);   // the tile needs keys j < jmax
      int ri[kRows];                       // this warp's rows, clamped in range
#pragma unroll
      for (int r = 0; r < kRows; ++r) ri[r] = min(r0 + warp + kWarps * r, L - 1);

      // 1a. W[i][j] for j < jmax: the lanes take consecutive keys, two each
      for (int jb = 0; jb < jmax; jb += 64) {
        float acc[kRows][2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
        const int ja = min(jb + lane, L - 1);
        const int jc = min(jb + 32 + lane, L - 1);
        for (int n = 0; n < N; ++n) {
          const float b0 = sB[ja * ldn + n];
          const float b1 = sB[jc * ldn + n];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float cv = sC[ri[r] * ldn + n];
            acc[r][0] += cv * b0;
            acc[r][1] += cv * b1;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int ii = warp + kWarps * r;
          const int i = r0 + ii;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = jb + 32 * q + lane;
            if (j < jmax)      // the mask comes before the exp: no inf, no NaN
              sW[ii * L + j] = (i < L && j <= i)
                                   ? acc[r][q] * expf(sCs[i] - sCs[j])
                                   : 0.f;
          }
        }
      }
      __syncthreads();

      // 1b. y[i] = exp(cs_i) (C_i . s) + sum_{j < jmax} W[i][j] xdt_j
      float acc[kRows][PC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float sv[PC];
#pragma unroll
        for (int q = 0; q < PC; ++q) sv[q] = sS[n * P + lane + 32 * q];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float cv = sC[ri[r] * ldn + n];
#pragma unroll
          for (int q = 0; q < PC; ++q) acc[r][q] += cv * sv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e = expf(sCs[ri[r]]);
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[r][q] *= e;
      }
      for (int j = 0; j < jmax; ++j) {
        float xv[PC];
#pragma unroll
        for (int q = 0; q < PC; ++q) xv[q] = sX[j * P + lane + 32 * q];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float w = sW[(warp + kWarps * r) * L + j];
#pragma unroll
          for (int q = 0; q < PC; ++q) acc[r][q] += w * xv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = r0 + warp + kWarps * r;
        if (i < L) {
          T* yp = y + ((row0 + i) * H + h) * P + lane;
#pragma unroll
          for (int q = 0; q < PC; ++q) store(yp + 32 * q, acc[r][q]);
        }
      }
      __syncthreads();                     // sW and sS are read no more
    }

    // 2. s <- s exp(cs_L) + sum_j (B_j exp(cs_L - cs_j)) xdt_j
    const float cl = sCs[L - 1];
    for (int j = tid; j < L; j += kThreads) sE[j] = expf(cl - sCs[j]);
    __syncthreads();
    for (int i = tid; i < L * N; i += kThreads) {
      const int l = i / N;
      sB[l * ldn + (i - l * N)] *= sE[l];
    }
    __syncthreads();
    const float dec = expf(cl);
    for (int n0 = 0; n0 < N; n0 += kRT) {
      int nr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) nr[r] = min(n0 + warp + kWarps * r, N - 1);
      float acc[kRows][PC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;
      for (int j = 0; j < L; ++j) {
        float xv[PC];
#pragma unroll
        for (int q = 0; q < PC; ++q) xv[q] = sX[j * P + lane + 32 * q];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float bv = sB[j * ldn + nr[r]];
#pragma unroll
          for (int q = 0; q < PC; ++q) acc[r][q] += bv * xv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = n0 + warp + kWarps * r;
        if (n < N) {
#pragma unroll
          for (int q = 0; q < PC; ++q) {
            float* sp = sS + n * P + lane + 32 * q;
            *sp = *sp * dec + acc[r][q];
          }
        }
      }
    }
    __syncthreads();                       // the next chunk overwrites sX, sB
  }

  float* fp = final_state + (int64_t(b) * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) fp[i] = sS[i];
}

// opt the kernel into more than 48 KB of dynamic shared memory, once per
// device
template <typename T, int PC>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_scan_kernel<T, PC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kMaxSmem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int PC>
int launch(const void* xdt, const void* cs, const void* bm, const void* cm,
           void* y, void* final_state, int B, int nc, int L, int H, int N,
           cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, PC>();
  if (err != cudaSuccess) return int(err);
  const dim3 grid(H, B);
  ssd_scan_kernel<T, PC><<<grid, kThreads, smem_bytes(L, N, 32 * PC), stream>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(cs),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), static_cast<float*>(final_state), nc, L, H, N);
  return 0;
}

template <typename T>
int dispatch_p(const void* xdt, const void* cs, const void* bm,
               const void* cm, void* y, void* fs, int B, int nc, int L,
               int H, int N, int P, cudaStream_t s) {
  if (P == 32) return launch<T, 1>(xdt, cs, bm, cm, y, fs, B, nc, L, H, N, s);
  if (P == 64) return launch<T, 2>(xdt, cs, bm, cm, y, fs, B, nc, L, H, N, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (tile_matmul's codes), the type of xdt,
// B, C and y; cs and the final state are float32.  Every tensor is
// contiguous.  Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int ssd_scan_launch(int dtype, const void* xdt, const void* cs,
                               const void* bm, const void* cm, void* y,
                               void* final_state, int B, int nc, int L,
                               int H, int N, int P, void* stream) {
  if (B <= 0 || nc <= 0 || L <= 0 || H <= 0 || N <= 0 ||
      smem_bytes(L, N, P) > kMaxSmem)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 1:
      err = dispatch_p<float>(xdt, cs, bm, cm, y, final_state, B, nc, L, H, N, P, s);
      break;
    case 2:
      err = dispatch_p<__nv_bfloat16>(xdt, cs, bm, cm, y, final_state, B, nc, L, H, N, P, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
