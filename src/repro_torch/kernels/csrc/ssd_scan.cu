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
// What bounds it on an H100: at zamba2's prefill (B = 1, T = 512, H = 112,
// N = P = 64, L = 128) the scan needs ~1.4 GFLOP of float32 products
// against ~32 MB of input and output: operations bound it, 21 us at the 67
// TFLOP/s float32 rate.
//
// Design: only the (N x P) state recurrence is sequential over chunks, so
// the work is cut into three launches on the caller's stream, every other
// part parallel.  A chunk's H heads are cut into `groups` contiguous
// ranges (the wrapper's chunk_groups: about one block per SM over a batch
// row), a block each, which loads the chunk's head-independent operands
// once and streams each next head's xdt in while the current one is
// multiplied:
//   1. state_kernel: one block per (b, c), scheduled first, forms G = C
//      B^T, which does not depend on the head, once for all heads, into the
//      scratch `cb` (B, nc, Lp + Np, LR): the rows k < Lp hold G^T and the
//      rows Lp + n hold C^T, each column the output row that one thread of
//      output_kernel owns (below); the other blocks form each head's own
//      state increment dS_c = sum_j B_j^T (exp(cs_L - cs_j) xdt_j) into the
//      scratch `st` (B, nc, H, N, P), B staged once per group;
//   2. carry_kernel, a thread per (b, h, four state elements): walks the
//      chunks in order, s_c = s_{c-1} exp(cs_L) + dS_c, overwriting dS_c
//      with the incoming state s_{c-1}, and writes the final state; the
//      output pass is launched behind it as a programmatic dependent, so
//      its blocks load and build all they can before they wait for it (a
//      profile then counts that wait, at most the carry's own time, in the
//      output pass's duration);
//   3. output_kernel: for each head of a group y = diag(e^cs) (C . s_{c-1})
//      + W . xdt, where W[i][j] = G[i][j] exp(cs_i - cs_j) for j <= i, C^T
//      staged once per group.  The block builds the head's W^T in shared
//      memory from `cb` (L2-resident, read with 16-byte loads) while the
//      head's xdt and state stream in, then every thread accumulates a
//      4-column strip of R rows i = rg + RS r (RS = 512 / (P / 4), R = LR /
//      RS): rows RS apart, so each thread owns rows in every part of the
//      causal triangle, and keys [q RS, (q + 1) RS) update only rows r >=
//      q.  Every thread runs the same loops: no warp waits on another.
// Products are float32 FMAs on registers: per key a thread loads its R row
// weights (adjacent in the layout: 16-byte loads) and 4 columns of xdt,
// broadcast or conflict-free across the warp, for 4 R FMAs.  The tensor
// cores' 3xTF32 products (a TF32 high part and residual per operand) were
// tried and left out: each operand keeps ~2^-22 of relative error against
// float32's 2^-24, and a slow head's decay, whose state carries across
// chunks and makes large terms cancel, took them past the float32
// tolerance.  The upper triangle j > i is set to zero *without* computing
// its exp: with the model's step sizes cs falls by ~100 across a 128-step
// chunk, so exp(cs_i - cs_j) for j > i is ~e^100, inf in float32, and a 0/1
// mask multiplied in would give inf * 0 = NaN.  Every sum runs in a fixed
// order and nothing is atomic, so the same inputs give the same bits on
// every run, and a head's bits depend neither on its group nor on the other
// batch rows.  The wrapper's `launches` counter counts one per scan, i.e.
// per three device launches.
//
// Shared memory (4-byte words; Lp, Np: L, N rounded up to 16):
// state_kernel max(Lp Np + 2 Lp P + Lp, Lp (Np + 1) + 2 Np (Lp + 4));
// output_kernel (Lp + Np) (LR + P) + 2 LR + Lp: 149 KB at zamba2's shape,
// 194 KB at mamba2-2.7b's N = 128; more than 227 KB is refused.
//
// The launches allocate nothing (the wrapper allocates the two scratch
// tensors) and the call returns cudaGetLastError(), so a refused launch
// reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;             // output_kernel
constexpr int kStateThreads = 256;        // state_kernel
constexpr size_t kMaxSmem = 232448;       // what a block may opt into

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// output_kernel's rows: a thread per (row group rg, 4 columns); rows RS
// apart, R of them, R the least of 2, 4, 8 that covers Lp (0 if none)
__host__ __device__ constexpr int row_stride(int P) { return kThreads / (P / 4); }
__host__ __device__ constexpr int rows_per_thread(int Lp, int P) {
  return Lp <= 2 * row_stride(P) ? 2 : Lp <= 4 * row_stride(P) ? 4
         : Lp <= 8 * row_stride(P) ? 8 : 0;
}
// the heads [g H / groups, (g + 1) H / groups) of a chunk's head group g
__device__ __forceinline__ int group_head(int g, int H, int groups) {
  return int(int64_t(g) * H / groups);
}
// the column of output row i in the A^T layout: a thread's R rows adjacent
__host__ __device__ constexpr int slot(int i, int RS, int R) {
  return (i % RS) * R + i / RS;
}

size_t state_smem(int Lp, int Np, int P) {
  const size_t inc = size_t(Lp) * Np + 2 * size_t(Lp) * P + Lp;
  const size_t cb = size_t(Lp) * (Np + 1) + 2 * size_t(Np) * (Lp + 4);
  return sizeof(float) * (inc > cb ? inc : cb);
}

size_t output_smem(int Lp, int Np, int P) {
  const size_t LR = size_t(rows_per_thread(Lp, P)) * row_stride(P);
  return sizeof(float) * ((Lp + Np) * (LR + P) + 2 * LR + Lp);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// rows x cols of a row-major source (row stride ld elements) into shared
// float32 at row pitch `pitch`, zeros in rows [rows, rows_pad) and columns
// [cols, cols_pad).  float32 goes through cp.async (commit and wait after);
// bfloat16 is widened through registers, eight loads in flight a thread.
template <int NT>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src,
                                      int64_t ld, int rows, int cols,
                                      int rows_pad, int cols_pad) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   ld % 4 == 0 && cols % 4 == 0 && pitch % 4 == 0;
  if (vec) {
    const int per_row = cols_pad / 4;
    for (int e = threadIdx.x; e < rows_pad * per_row; e += NT) {
      const int r = e / per_row, q = 4 * (e - r * per_row);
      const bool ok = r < rows && q < cols;
      hopper::cp_async<16>(dst + r * pitch + q, ok ? src + r * ld + q : src,
                           ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * cols_pad; e += NT) {
      const int r = e / cols_pad, q = e - r * cols_pad;
      const bool ok = r < rows && q < cols;
      hopper::cp_async<4>(dst + r * pitch + q, ok ? src + r * ld + q : src,
                          ok);
    }
  }
}

template <int NT>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const __nv_bfloat16* src, int64_t ld,
                                      int rows, int cols, int rows_pad,
                                      int cols_pad) {
  constexpr int kU = 8;
  const int total = rows_pad * cols_pad;
  for (int e0 = threadIdx.x; e0 < total; e0 += kU * NT) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * NT;
      const int r = e / cols_pad, q = e - r * cols_pad;
      v[u] = (e < total && r < rows && q < cols) ? to_f(src[r * ld + q]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * NT;
      const int r = e / cols_pad, q = e - r * cols_pad;
      if (e < total) dst[r * pitch + q] = v[u];
    }
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

// 1. the chunk's C B^T (blockIdx.x = 0, scheduled first), or the state
// increments of the chunk's head group blockIdx.x - 1
template <typename T, int P>
__global__ void __launch_bounds__(kStateThreads)
state_kernel(const T* __restrict__ xdt, const float* __restrict__ cs,
             const T* __restrict__ bm, const T* __restrict__ cm,
             float* __restrict__ cb, float* __restrict__ st, int nc, int L,
             int H, int N, int groups) {
  constexpr int NT = kStateThreads;
  extern __shared__ __align__(16) float smem[];
  const int Lp = round16(L), Np = round16(N);
  const int c = blockIdx.y, b = blockIdx.z;
  const int64_t bc = int64_t(b) * nc + c;
  const int64_t row0 = bc * L;             // the chunk's first step
  const int tid = threadIdx.x;

  if (blockIdx.x == 0) {
    // G = C B^T, and C^T, in output_kernel's A^T layout.  C and B arrive
    // row-major through cp.async and are turned n-major in shared memory
    // (odd pitch: both sides conflict-free); a thread takes 4 x 4 tiles
    // (rows i, columns j <= i)
    const int pn = Np + 1, pt = Lp + 4;
    float* sN = smem;                      // [Lp][pn] C, then B, row-major
    float* sCT = sN + Lp * pn;             // [Np][pt] C^T
    float* sBT = sCT + Np * pt;            // [Np][pt] B^T
    for (int which = 0; which < 2; ++which) {
      stage<NT>(sN, pn, (which ? bm : cm) + row0 * N, N, L, N, Lp, Np);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
      float* dst = which ? sBT : sCT;
      for (int e = tid; e < Np * Lp; e += NT) {
        const int n = e / Lp, i = e - n * Lp;
        dst[n * pt + i] = sN[i * pn + n];
      }
      __syncthreads();
    }
    constexpr int RS = row_stride(P);
    const int R = rows_per_thread(Lp, P), LR = R * RS;
    float* out = cb + bc * int64_t(Lp + Np) * LR;
    const int tiles = Lp / 4;
    for (int e = tid; e < tiles * (tiles + 1) / 2; e += NT) {
      int ti = 0;                          // the e-th lower tile, row-major
      while ((ti + 1) * (ti + 2) / 2 <= e) ++ti;
      const int tj = e - ti * (ti + 1) / 2;
      float acc[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < Np; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(sCT + n * pt + 4 * ti);
        const float4 bv = *reinterpret_cast<const float4*>(sBT + n * pt + 4 * tj);
        fma4(acc[0], cv.x, bv);
        fma4(acc[1], cv.y, bv);
        fma4(acc[2], cv.z, bv);
        fma4(acc[3], cv.w, bv);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)          // G^T[j][slot(i)] = G[i][j]
#pragma unroll
        for (int v = 0; v < 4; ++v)
          out[int64_t(4 * tj + v) * LR + slot(4 * ti + u, RS, R)] = acc[u][v];
    }
    for (int e = tid; e < Np * LR; e += NT) {   // C^T[n][slot(i)] = C[i][n]
      const int n = e / LR, s = e - n * LR;
      const int i = (s % R) * RS + s / R;
      out[int64_t(Lp + n) * LR + s] = i < Lp ? sCT[n * pt + i] : 0.f;
    }
    return;
  }

  // dS (N x P) = sum_j B_j^T (e_j xdt_j) for each head of the group: B is
  // staged once, each head's xdt scaled by e_j = exp(cs_L - cs_j) in place;
  // the next head's xdt streams into the other buffer meanwhile
  const int h0 = group_head(blockIdx.x - 1, H, groups);
  const int h1 = group_head(blockIdx.x, H, groups);
  float* sB = smem;                        // [Lp][Np]
  float* sX = sB + Lp * Np;                // [2][Lp][P]
  float* sE = sX + 2 * Lp * P;             // [Lp]
  stage<NT>(sB, Np, bm + row0 * N, N, L, N, Lp, Np);
  stage<NT>(sX, P, xdt + (row0 * H + h0) * P, int64_t(H) * P, L, P, Lp, P);
  hopper::cp_async_commit();
  constexpr int CG = P / 4;                // a thread: 4 columns, 4 rows a pass
  const int cg = tid % CG;
  for (int hh = h0; hh < h1; ++hh) {
    float* x = sX + ((hh - h0) & 1) * Lp * P;
    const float cl = cs[(row0 + L - 1) * H + hh];
    for (int j = tid; j < Lp; j += NT)
      sE[j] = j < L ? expf(cl - cs[(row0 + j) * H + hh]) : 0.f;
    hopper::cp_async_wait<0>();
    __syncthreads();                       // this head's xdt and sE are in
    for (int e = tid; e < Lp * P; e += NT) x[e] *= sE[e / P];
    if (hh + 1 < h1)
      stage<NT>(sX + ((hh + 1 - h0) & 1) * Lp * P, P,
                xdt + (row0 * H + hh + 1) * P, int64_t(H) * P, L, P, Lp, P);
    hopper::cp_async_commit();
    __syncthreads();                       // the scaled xdt is visible
    float* out = st + (bc * H + hh) * int64_t(N) * P;
    for (int rb = tid / CG; rb < Np / 4; rb += NT / CG) {
      float acc[4][4] = {};
#pragma unroll 4
      for (int j = 0; j < Lp; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(sB + j * Np + 4 * rb);
        const float4 xv = *reinterpret_cast<const float4*>(x + j * P + 4 * cg);
        fma4(acc[0], bv.x, xv);
        fma4(acc[1], bv.y, xv);
        fma4(acc[2], bv.z, xv);
        fma4(acc[3], bv.w, xv);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = 4 * rb + u;
        if (n < N)
          *reinterpret_cast<float4*>(out + int64_t(n) * P + 4 * cg) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
    }
    __syncthreads();                       // sE and this buffer are free
  }
}

// 2. the state recurrence over the chunks, one thread per four state
// elements: st[c] becomes the state entering chunk c
constexpr int kCarryThreads = 256;
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const float* __restrict__ cs, float4* __restrict__ st,
             float4* __restrict__ final_state, int nc, int L, int H,
             int NP4) {
  hopper::launch_dependents();            // output_kernel may start loading
  const int e = blockIdx.x * kCarryThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= NP4) return;
  constexpr int kU = 8;                    // chunks whose loads fly together
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kU) {
    float4 d[kU];
    float dec[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t bc = int64_t(b) * nc + c0 + u;
      if (c0 + u < nc) {
        d[u] = st[(bc * H + h) * NP4 + e];
        dec[u] = expf(cs[((bc + 1) * L - 1) * H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u < nc) {
        st[((int64_t(b) * nc + c0 + u) * H + h) * NP4 + e] = s;
        s.x = s.x * dec[u] + d[u].x;
        s.y = s.y * dec[u] + d[u].y;
        s.z = s.z * dec[u] + d[u].z;
        s.w = s.w * dec[u] + d[u].w;
      }
    }
  }
  final_state[(int64_t(b) * H + h) * NP4 + e] = s;
}

// a thread's R row weights of one key, adjacent: 8- or 16-byte loads
template <int R>
__device__ __forceinline__ void load_rows(float (&w)[R], const float* a) {
  if constexpr (R == 2) {
    const float2 wv = *reinterpret_cast<const float2*>(a);
    w[0] = wv.x;
    w[1] = wv.y;
  } else {
#pragma unroll
    for (int v = 0; v < R; v += 4)
      *reinterpret_cast<float4*>(w + v) = *reinterpret_cast<const float4*>(a + v);
  }
}

// keys [k0, k1) of A^T [R rows] x B [4 columns] into rows Q.. R-1
template <int Q, int R>
__device__ __forceinline__ void keys(float (&acc)[R][4], const float* a,
                                     const float* x, int LR, int P, int k0,
                                     int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(x + k * P);
    float w[R];
    load_rows<R>(w, a + k * LR);
#pragma unroll
    for (int r = Q; r < R; ++r) fma4(acc[r], w[r], xv);
  }
}

// the causal part, segment by segment: keys [q RS, (q + 1) RS) reach rows
// r >= q only
template <int Q, int R>
__device__ __forceinline__ void causal(float (&acc)[R][4], const float* a,
                                       const float* x, int LR, int P, int RS,
                                       int Lp) {
  if constexpr (Q < R) {
    keys<Q, R>(acc, a, x, LR, P, min(Q * RS, Lp), min((Q + 1) * RS, Lp));
    causal<Q + 1, R>(acc, a, x, LR, P, RS, Lp);
  }
}

// 3. y = diag(e^cs) C s_in + W xdt, for each head of the chunk's head
// group blockIdx.x
template <typename T, int P, int R>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ xdt, const float* __restrict__ cs,
              const float* __restrict__ cb, const float* __restrict__ st,
              T* __restrict__ y, int nc, int L, int H, int N, int groups) {
  constexpr int CG = P / 4, RS = row_stride(P), LR = R * RS;
  extern __shared__ __align__(16) float smem[];
  const int Lp = round16(L), Np = round16(N), K = Lp + Np;
  const int c = blockIdx.y, b = blockIdx.z;
  const int h0 = group_head(blockIdx.x, H, groups);
  const int h1 = group_head(blockIdx.x + 1, H, groups);
  const int64_t bc = int64_t(b) * nc + c;
  const int64_t row0 = bc * L;
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  float* sA = smem;                        // [Lp][LR] W^T of the head
  float* sCT = sA + Lp * LR;               // [Np][LR] C^T of the chunk
  float* sX = sCT + Np * LR;               // [K][P] xdt, then s_in
  float* sCsP = sX + K * P;                // [LR] cs of each column's row
  float* sEcP = sCsP + LR;                 // [LR] exp of it (0 past L)
  float* sCs = sEcP + LR;                  // [Lp] cs by key
  const float* g = cb + bc * int64_t(K) * LR;
  // a head's xdt, and its incoming state
  auto stage_x = [&](int hh) {
    stage<kThreads>(sX, P, xdt + (row0 * H + hh) * P, int64_t(H) * P, L, P,
                    Lp, P);
  };
  auto stage_s = [&](int hh) {
    stage<kThreads>(sX + Lp * P, P, st + (bc * H + hh) * int64_t(N) * P, P,
                    N, P, Np, P);
  };
  // launched while carry_kernel runs: everything but the incoming states
  // (C^T, the first head's xdt and W^T) is read before waiting for it
  stage<kThreads>(sCT, LR, g + int64_t(Lp) * LR, LR, Np, LR, Np, LR);
  stage_x(h0);
  hopper::cp_async_commit();
  for (int hh = h0; hh < h1; ++hh) {
    for (int s = tid; s < LR; s += kThreads) {
      const int i = (s % R) * RS + s / R;
      const float v = i < L ? cs[(row0 + i) * H + hh] : 0.f;
      sCsP[s] = v;
      sEcP[s] = i < L ? expf(v) : 0.f;
    }
    for (int k = tid; k < Lp; k += kThreads)
      sCs[k] = k < L ? cs[(row0 + k) * H + hh] : 0.f;
    __syncthreads();
    // W^T: the decay-weighted G^T, masked before its exp; four columns a
    // thread, four loads in flight
    constexpr int kU = 4;
    for (int e0 = 4 * tid; e0 < Lp * LR; e0 += 4 * kU * kThreads) {
      float4 gv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + 4 * u * kThreads;
        if (e < Lp * LR) gv[u] = *reinterpret_cast<const float4*>(g + e);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + 4 * u * kThreads;
        if (e >= Lp * LR) break;
        const int k = e / LR, s = e - k * LR;
        float w[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ((s + v) % R) * RS + (s + v) / R;
          w[v] = (k <= i && i < L) ? w[v] * __expf(sCsP[s + v] - sCs[k]) : 0.f;
        }
        *reinterpret_cast<float4*>(sA + e) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    if (hh == h0) {                        // the states are carried
      hopper::grid_dependency_wait();
      stage_s(h0);
      hopper::cp_async_commit();
    }
    hopper::cp_async_wait<0>();
    __syncthreads();                       // W^T, C^T, xdt and s_in are in
    float acc[R][4] = {};
    const float* x = sX + 4 * cg;
    // the carried state e^{cs_i} C_i . s_in, then the chunk's own keys
    keys<0, R>(acc, sCT + rg * R, x + Lp * P, LR, P, 0, Np);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float e = sEcP[rg * R + r];
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[r][v] *= e;
    }
    causal<0, R>(acc, sA + rg * R, x, LR, P, RS, Lp);
    __syncthreads();                       // sA and sX are free
    if (hh + 1 < h1) {                     // the next head streams in
      stage_x(hh + 1);
      stage_s(hh + 1);
    }
    hopper::cp_async_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rg + RS * r;
      if (i < L) {
        T* o = y + ((row0 + i) * H + hh) * P + 4 * cg;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
          __nv_bfloat162 lo = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(acc[r][2], acc[r][3]);
          reinterpret_cast<__nv_bfloat162*>(o)[0] = lo;
          reinterpret_cast<__nv_bfloat162*>(o)[1] = hi;
        }
      }
    }
  }
}

// opt a kernel into more than 48 KB of dynamic shared memory, once per
// device
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kMaxSmem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int P, int R>
int launch_output(const void* xdt, const void* cs, const void* cb,
                  const void* st, void* y, int B, int nc, int L, int H,
                  int N, int groups, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t err = allow_smem(output_kernel<T, P, R>, done);
  if (err != cudaSuccess) return int(err);
  // launched while carry_kernel still runs (programmatic dependent launch)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, nc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = output_smem(round16(L), round16(N), P);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(
      &cfg, output_kernel<T, P, R>, static_cast<const T*>(xdt),
      static_cast<const float*>(cs), static_cast<const float*>(cb),
      static_cast<const float*>(st), static_cast<T*>(y), nc, L, H, N,
      groups));
}

template <typename T, int P>
int launch(const void* xdt, const void* cs, const void* bm, const void* cm,
           void* y, void* final_state, void* cb, void* st, int B, int nc,
           int L, int H, int N, int groups, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(state_kernel<T, P>, done);
  if (err != cudaSuccess) return int(err);
  const int Lp = round16(L), Np = round16(N);
  state_kernel<T, P><<<dim3(1 + groups, nc, B), kStateThreads,
                       state_smem(Lp, Np, P), stream>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(cs),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(cb), static_cast<float*>(st), nc, L, H, N, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int NP4 = N * P / 4;               // P is 32 or 64
  carry_kernel<<<dim3((NP4 + kCarryThreads - 1) / kCarryThreads, H, B),
                 kCarryThreads, 0, stream>>>(
      static_cast<const float*>(cs), static_cast<float4*>(st),
      static_cast<float4*>(final_state), nc, L, H, NP4);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  switch (rows_per_thread(Lp, P)) {
    case 2:
      return launch_output<T, P, 2>(xdt, cs, cb, st, y, B, nc, L, H, N, groups, stream);
    case 4:
      return launch_output<T, P, 4>(xdt, cs, cb, st, y, B, nc, L, H, N, groups, stream);
    case 8:
      return launch_output<T, P, 8>(xdt, cs, cb, st, y, B, nc, L, H, N, groups, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_p(const void* xdt, const void* cs, const void* bm,
               const void* cm, void* y, void* fs, void* cb, void* st, int B,
               int nc, int L, int H, int N, int P, int groups,
               cudaStream_t s) {
  if (P == 32)
    return launch<T, 32>(xdt, cs, bm, cm, y, fs, cb, st, B, nc, L, H, N, groups, s);
  if (P == 64)
    return launch<T, 64>(xdt, cs, bm, cm, y, fs, cb, st, B, nc, L, H, N, groups, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (tile_matmul's codes), the type of xdt,
// B, C and y; cs and the final state are float32.  Every tensor is
// contiguous.  `cb` (B, nc, Lp + Np, LR) and `st` (B, nc, H, N, P) are
// float32 scratch of the wrapper's (Lp, Np: L, N rounded up to 16; LR =
// R * 512 / (P / 4) with R the least of 2, 4, 8 for which LR >= Lp); a
// chunk's H heads are cut into `groups` contiguous ranges, a block each
// (chunk_groups).  Returns a cudaError_t as int: 0 when all three
// launches were accepted.
extern "C" int ssd_scan_launch(int dtype, const void* xdt, const void* cs,
                               const void* bm, const void* cm, void* y,
                               void* final_state, void* cb, void* st, int B,
                               int nc, int L, int H, int N, int P,
                               int groups, void* stream) {
  if (B <= 0 || nc <= 0 || L <= 0 || H <= 0 || N <= 0 || groups <= 0 ||
      groups > H ||
      (P != 32 && P != 64))
    return int(cudaErrorInvalidValue);
  const int Lp = round16(L), Np = round16(N);
  if (rows_per_thread(Lp, P) == 0 || state_smem(Lp, Np, P) > kMaxSmem ||
      output_smem(Lp, Np, P) > kMaxSmem)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 1:
      err = dispatch_p<float>(xdt, cs, bm, cm, y, final_state, cb, st, B, nc, L, H, N, P, groups, s);
      break;
    case 2:
      err = dispatch_p<__nv_bfloat16>(xdt, cs, bm, cm, y, final_state, cb, st, B, nc, L, H, N, P, groups, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
