// Forward flash attention for Hopper (sm_90a): causal and sliding-window
// self-attention, and full attention over another sequence (the encoder's
// self-attention, cross-attention),
//
//     out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, g, j] / sqrt(d)) v[b, g, j]
//
// over the keys j < Sk with j <= i (causal) and i - j < window (window > 0),
// where g = h / (H / KV) is the query head's KV head (grouped-query
// attention read in place, the mapping of jnp.repeat in the reference).
// q and out are (B, H, Sq, d), k and v (B, KV, Sk, d), each read or written
// through its (b, head, position) strides with the innermost dimension
// contiguous, so a transposed view of the projections is taken without a
// copy.  The two lengths differ only without the causal mask (the wrapper
// refuses the rest): query tiles run over Sq, the key loop over Sk, and
// `kpos < Sk` masks the ragged last key tile.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel `_flash_kernel`), which keeps a bq = 128 query block in VMEM and
// sweeps bk = 128 key blocks along the grid's sequential minor axis with an
// (m, l, acc) online softmax in f32 scratch, and needs S % 128 == 0.  It
// also takes the body of the reference's layers._chunked_attn as prefill,
// the encoder and cross-attention call it (q_offset = 0; Sq = Sk, or
// causal = False), which adds GQA and pads ragged lengths: here any Sq and
// Sk are taken and the ragged edges are masked inside the kernel.
//
// What bounds it on an H100: causal prefill does 2 * S^2 * d * H flops (half
// the square, QK and PV) and moves 2 * S * d * (2 * H + 2 * KV) bytes in
// bf16; at qwen3-14b's heads (H = 40, KV = 8, d = 128) the two bounds meet
// near S = 700 (3.35 TB/s against the bf16 tensor cores' 989 TFLOP/s), so a
// 512-token prompt is bound by bytes and longer ones by operations.
// Without the mask the work is the whole Sq x Sk rectangle: 4 * Sq * Sk * d
// * H flops against 2 * d * (2 * Sq * H + 2 * Sk * KV) bytes, so a
// cross-attention prefill of 512 queries over 1,600 patches (H = 32, KV =
// 8) is bound by operations.
//
// Two kernels, chosen by the dtype (not a fallback: each type has one):
//
// bfloat16 -- tensor cores fed by TMA (the FlashAttention-3 shape).  One
// block per (64-query tile, head, batch); under the causal mask the blocks
// of every head's last query tile (the heaviest) are numbered first, so
// they start first and the light ones fill in behind them; without it every
// tile sweeps all Sk keys and the tiles run in plain order.  The key sweep
// is a loop inside the block, since CUDA blocks carry nothing between
// them.  A producer warp issues TMA loads: the Q tile once,
// then 64-key K and V tiles into a ring of 2 stages (3 at d <= 64), each
// stage with a `full` mbarrier (bytes landed) and an `empty` one (the 128
// consumer threads are done with it).  The tensor maps are built on the
// host at each call over (d, Sq, H, B) for q and (d, Sk, KV, B) for k and v
// from the wrapper's strides, so GQA and transposed views are read in place
// (TMA fills rows past a map's length with zeros, which the mask keeps out
// of the softmax); their 64-column boxes land with
// the 128-byte swizzle that the wgmma descriptors read.  A head dim that is
// not a multiple of 64 (zamba2's 112) has a map whose d extent is the real
// d: TMA fills the columns past it with zeros, the products run at the
// padded width DP, and those output columns are never stored.  One
// consumer warpgroup of 128 threads per block:
//   S = Q . K^T  wgmma m64n64k16, bf16 -> f32, both operands K-major in
//                shared memory (DP / 16 instructions);
//   softmax      in registers on the accumulator fragments: masked scores
//                (after the diagonal, outside the window, past Sk) are -inf
//                *before* the row max, so a row whose tile is all masked
//                keeps its carry; scores in log2 units, exp2; each row's
//                max and sum are two xor shuffles over the 4 lanes that hold
//                it, a fixed order: no atomics, the same bits on every run;
//   O += P . V   P rounded to bf16 in registers is the register-A operand
//                of a second wgmma (m64nDPk16): the f32 accumulator's
//                fragment of S is, pair by pair, the A fragment of the
//                product, so P never goes through shared memory; V, a
//                keys x d tile with d contiguous, is the MN-major B operand
//                (read transposed by the descriptor).
// The sum l adds the float32 p before rounding; the epilogue divides by
// max(l, 1e-30) and stores bf16 pairs from registers.  Rounding P to bf16
// is what the model path's reference does (repro/models/layers.py
// _chunked_attn: p.astype(vb.dtype) before p . V); the Pallas kernel, the
// plain version and the float32 kernel keep p in float32.  The first-order
// error it adds is at most 2^-8 * sum_j p_j |v_j| / l per output (the
// derived bf16 limit of chip_smoke.py and tests/test_torch_cuda.py).
// Key tiles wholly after the diagonal or before the window are skipped.
// Shared memory: Q and 2 stages of K and V at DP = 128 take 80 KB, so two
// blocks share an SM (160 KB at DP = 256: one).
//
// float32 -- plain FMAs from shared memory (wgmma has no full-float32
// path, and the float32 checks hold the kernel at 2e-5): one block of 256
// threads per (64-query tile, head, batch); Q, one 64-key tile of K and of
// V, and the 64 x 64 score tile sit in shared memory (rows padded by one
// word against bank conflicts); each thread computes a 4 x 4 patch of scores
// and owns 4 rows x d/16 columns of the output in registers.  The masking,
// tile skipping and fixed-order reductions are as above.  No full-size
// model serves float32 on the card.
//
// Training's forward (bfloat16, d <= 128, called where the backward will
// run the kernel below) also stores each query row's log-sum-exp in log2
// units, lse2 = m + log2(l), float32 (B, H, ld), ld a multiple of 64, from
// a second instantiation of the same kernel (the template flag LSE);
// serving's instantiation is the code above, unchanged, and both give the
// same bits.
//
// Backward (bfloat16, d <= 128; replaces no Pallas kernel: the reference
// differentiates layers._chunked_attn with jax.grad).  Four launches:
//   dot   D_i = rowsum(dO_i * O_i) in float32, one warp a row;
//   dkdv  one block per (64 keys, query head, batch): K and V of its keys
//         are loaded once, then Q and dO of every 64-query tile its keys
//         can see (causal: none before the first key; window: none a
//         window past the last) stream through a 2-stage TMA ring with
//         the tile's lse2 and D.  Per tile, on wgmma: S^T = K Q^T and
//         dP^T = V dO^T (both operands K-major in shared memory, float32
//         accumulators); then in registers P^T = exp2(S^T s log2e - lse2)
//         (masked: 0) and dS^T = P^T (dP^T - D); then dV += P^T dO and
//         dK += dS^T Q with P^T and dS^T as register A operands and dO, Q
//         read transposed.  dK and dV stay float32 in registers across
//         the tiles and are stored as the head's float32 partials;
//   sum   dK and dV of each KV head: its group's partials summed in head
//         order, rounded to bfloat16 once;
//   dq    one block per (64 queries, head, batch) over the key tiles its
//         queries see: S and dP again, dS, and dQ += dS K, K transposed;
//         rounded once.
// A block is one warpgroup that issues its own TMA loads, and two blocks
// share an SM, so each holds up to 255 registers a thread (dK and dV take
// 128 at d = 128, the four split operands 64).  One block per query head,
// not per KV group, keeps the causal mask's heaviest block (the first keys
// see every query) a small share of the grid's work: at qwen3-14b's
// training shape (B 2, S 1,024, 40 / 8 heads) a group's block would hold
// 80 of the 41 tiles an SM does on average.
// No atomics: every sum runs in a fixed order, so two runs give the same
// bits.  P and dS are float32; a bfloat16 operand would round each by up
// to 2^-8, about what the gradients' limits allow for their own final
// rounding (chip_smoke.TRAIN_GRAD_F32), so each is split into a bfloat16
// high part and the bfloat16 of the remainder, x = hi + lo to ~2^-16, and
// the three products that take them run twice.  S and dP multiply the
// bfloat16 inputs as they are.  Work: 10 products of a kept pair a head
// dim (4 would do, keeping P): at qwen3-14b's training shapes it is bound
// by operations, 2 * 10 * pairs * d * H flops at 989 TFLOP/s.
//
// The launches go on the caller's stream, allocate nothing and return
// cudaGetLastError() (or minus the CUresult of a refused tensor map), so a
// refused launch reaches the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile

// Raises a kernel's dynamic shared-memory limit to `bytes` once per device
// (`done`, one per kernel, holds a bit per device) rather than on every
// launch (prefill launches once per layer).  Devices past the 64th are set
// on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ------------------------------------------------------------------------
// float32: plain FMAs from shared memory (wgmma has no full-float32 path)
namespace f32 {

constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 score patch each
constexpr int kPS = kBK + 1;      // padded score-tile row

// xor butterflies: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) *
         (size_t(kBQ) * dp + size_t(kBK) * dp + size_t(kBK) * d +
          size_t(kBQ) * kPS + 3 * kBQ);
}

// DCH: output columns per thread, d <= 16 * DCH
template <int DCH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int rep, int Sq, int Sk,
                           int d, int causal, int window, float scale,
                           int64_t q_sb, int64_t q_sh, int64_t q_ss,
                           int64_t k_sb, int64_t k_sh, int64_t k_ss,
                           int64_t v_sb, int64_t v_sh, int64_t v_ss,
                           int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;                      // [kBQ][dp]
  float* ks = qs + kBQ * dp;             // [kBK][dp]
  float* vs = ks + kBK * dp;             // [kBK][d]
  float* ps = vs + kBK * d;              // [kBQ][kPS]: scores, then p
  float* row_m = ps + kBQ * kPS;         // running max
  float* row_l = row_m + kBQ;            // running sum
  float* row_c = row_l + kBQ;            // this tile's rescale factor

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / rep;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* qp = q + b * q_sb + h * q_sh;
  const float* kp = k + b * k_sb + g * k_sh;
  const float* vp = v + b * v_sb + g * v_sh;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int qpos = q0 + r;
    qs[r * dp + c] = qpos < Sq ? qp[qpos * q_ss + c] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float o[4][DCH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DCH; ++j) o[i][j] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin -= kv_begin % kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();                     // the last tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int kpos = k0 + r;
      const bool ok = kpos < Sk;
      ks[r * dp + c] = ok ? kp[kpos * k_ss + c] : 0.f;
      vs[r * d + c] = ok ? vp[kpos * v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += a[i] * bb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int kpos = k0 + col;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
        ps[r * kPS + col] = ok ? sc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w + 7, two columns a lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = ps + r * kPS;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      float p0 = 0.f, p1 = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {          // else: nothing unmasked so far
        p0 = expf(x0 - m_new);           // masked: exp(-inf) = 0
        p1 = expf(x1 - m_new);
        corr = expf(m_old - m_new);      // first unmasked tile: 0
      }
      row[lane] = p0;
      row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        row_l[r] = row_l[r] * corr + psum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // o = o * corr + p . V over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DCH; ++j) o[i][j] *= corr;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < d ? vs[kk * d + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();

  float* op = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      const int c = tx + 16 * j;
      if (c < d) op[qpos * o_ss + c] = o[i][j] * inv;
    }
  }
}

template <int DCH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int rep, int Sq, int Sk, int d, int causal, int window,
           float scale, const int64_t* st, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  auto kernel = flash_attention_f32_kernel<DCH>;
  const cudaError_t err = allow_smem(kernel, int(smem_bytes(16 * DCH)), done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem_bytes(d), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), rep, Sq, Sk,
      d, causal, window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return 0;
}

int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int H, int rep, int Sq, int Sk, int d, int causal, int window,
               float scale, const int64_t* st, cudaStream_t s) {
  if (d <= 32) return launch<2>(q, k, v, out, B, H, rep, Sq, Sk, d, causal, window, scale, st, s);
  if (d <= 64) return launch<4>(q, k, v, out, B, H, rep, Sq, Sk, d, causal, window, scale, st, s);
  if (d <= 128) return launch<8>(q, k, v, out, B, H, rep, Sq, Sk, d, causal, window, scale, st, s);
  if (d <= 256) return launch<16>(q, k, v, out, B, H, rep, Sq, Sk, d, causal, window, scale, st, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace f32

// ------------------------------------------------------------------------
// bfloat16: wgmma on TMA-fed tiles
namespace tc {

constexpr int kPanel = 64;                // bf16 columns in a 128-byte row
constexpr int kPanelBytes = 64 * 128;     // 64 rows of one 64-column panel
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kThreads = kConsumers + 32; // and the producer warp

// DP: the padded head dim (64, 128 or 256); a Q, K or V tile is DP / 64
// panels of 64 rows x 128 bytes, each stored with the 128-byte swizzle
template <int DP>
struct Shape {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  // Q, then stage s's K at tile 1 + 2s and V at 2 + 2s, then the barriers
  static constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
  static constexpr int kMinBlocks = DP == 256 ? 1 : 2;
};

// a shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// pins registers in place around the asynchronous products: the compiler
// may not move their reads or writes across this point
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);    // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem,
// MN-major: read transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem,
// MN-major: read transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) . B (16 x 256, smem,
// MN-major: read transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// LSE: also store each row's log2-sum-exp at lse[(b H + h) lse_ld + row]
// (rows past Sq in the last tile get 0); without it lse is not read
template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreads, Shape<DP>::kMinBlocks)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, int H, int rep,
                          int Sq, int Sk, int d, int causal, int window,
                          float scale_log2,
                          int64_t o_sb, int64_t o_sh, int64_t o_ss,
                          float* __restrict__ lse, int lse_ld) {
  using C = Shape<DP>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::kStages;

  // blocks start in index order: under the causal mask the last
  // (heaviest) query tile of every head first, then the next-to-last, ...;
  // without it every tile does the same work, in plain order
  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int tile = int(blockIdx.x) / H;
  const int q0 = (causal ? n_q - 1 - tile : tile) * kBQ;
  const int h = int(blockIdx.x) % H;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // key tiles that hold an unmasked key for some row of this query tile
  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin -= kv_begin % kBK;
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: one lane keeps the ring full
    if (lane == 0) {
      const int g = h / rep;
      hopper::mbar_expect_tx(q_full, C::kTileBytes);
      for (int p = 0; p < C::kPanels; ++p)
        hopper::tma_load_4d(smem + p * kPanelBytes, &tq, q_full, p * kPanel,
                            q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages)              // tile t - kStages released it
          hopper::mbar_wait(&empty[s], ((t / C::kStages) - 1) & 1);
        unsigned char* ks = smem + (1 + 2 * s) * C::kTileBytes;
        unsigned char* vs = ks + C::kTileBytes;
        const int k0 = kv_begin + t * kBK;
        hopper::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          hopper::tma_load_4d(ks + p * kPanelBytes, &tk, &full[s], p * kPanel,
                              k0, g, b);
          hopper::tma_load_4d(vs + p * kPanelBytes, &tv, &full[s], p * kPanel,
                              k0, g, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w holds rows 16w .. 16w + 15 of the tile;
  // a lane holds rows row0 and row0 + 8 (i = 0, 1) and, in each 8-column
  // group j, columns 8j + 2 * (lane % 4) + {0, 1}: fragment x = 4j + 2i + c
  const int t4 = lane & 3;
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const uint32_t q_addr = hopper::smem_u32(smem);
  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    const int k0 = kv_begin + t * kBK;
    const uint32_t k_addr = q_addr + (1 + 2 * s) * C::kTileBytes;
    const uint32_t v_addr = k_addr + C::kTileBytes;
    hopper::mbar_wait(&full[s], (t / C::kStages) & 1);

    // S = Q . K^T, 16 head columns per instruction
    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_addr + off, 16, 1024),
                   sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // mask, then the online softmax on the fragments
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      const int qpos = row0 + 8 * i;
      const int kpos = k0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || qpos - kpos < window);
      sc[x] = ok ? sc[x] * scale_log2 : -INFINITY;
      mx[i] = fmaxf(mx[i], sc[x]);
    }
    float base[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // no visible key so far: p = exp2(-inf) = 0 and the carry stays
      base[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = m_new == -INFINITY ? 1.f : exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      sc[x] = exp2f(sc[x] - base[(x >> 1) & 1]);
      sum[(x >> 1) & 1] += sc[x];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * corr[i] + sum[i];
    }

    // P in bf16: keys 16kk .. 16kk + 15 are fragments 8kk .. 8kk + 7, which
    // pair up as the four registers of the product's A fragment
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    // the carry rescaled to this tile's max
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= corr[(x >> 1) & 1];
    pin(o);
    pin(pa);

    // O += P . V, 16 keys per instruction; V's tile is MN-major: 8-key row
    // groups 1024 bytes apart, 64-column panels one panel apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DP>(o, pa[kk], sw128_desc(v_addr + kk * 16 * 128, kPanelBytes,
                                         1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    hopper::mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l_run[i], 1e-30f);
  __nv_bfloat16* op = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int x = 0; x < DP / 2; x += 2) {
    const int i = (x >> 1) & 1;
    const int qpos = row0 + 8 * i;
    const int col = 8 * (x >> 2) + 2 * t4;
    if (qpos < Sq && col < d)
      *reinterpret_cast<__nv_bfloat162*>(op + qpos * o_ss + col) =
          __floats2bfloat162_rn(o[x] * inv[i], o[x + 1] * inv[i]);
  }
  if constexpr (LSE) {
    // the 4 lanes of a row hold the same m and l; one stores
    if (t4 == 0) {
      float* lp = lse + int64_t(b * H + h) * lse_ld;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = row0 + 8 * i;
        lp[qpos] = qpos < Sq ? m_run[i] + log2f(l_run[i]) : 0.f;
      }
    }
  }
}

// a 4-d map over (d, S, heads, B) of a bf16 tensor with the given element
// strides; 64 x 64 boxes with the 128-byte swizzle, zeros outside (past d
// and past S)
int encode(CUtensorMap* map, const void* base, int d, int S, int heads, int B,
           int64_t sb, int64_t sh, int64_t ss) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return -int(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(S), cuuint64_t(heads),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {kPanel, kBQ, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -int(r);
}

template <int DP, bool LSE>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* out, int B, int H, int rep, int Sq, int Sk, int d,
           int causal, int window, float scale_log2, const int64_t* ost,
           float* lse, int lse_ld, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  auto kernel = flash_attention_tc_kernel<DP, LSE>;
  const cudaError_t err = allow_smem(kernel, Shape<DP>::kSmem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(((Sq + kBQ - 1) / kBQ) * H, 1, B);
  kernel<<<grid, kThreads, Shape<DP>::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, rep, Sq, Sk, d,
      causal, window, scale_log2, ost[0], ost[1], ost[2], lse, lse_ld);
  return 0;
}

int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int Sq, int Sk, int d, int causal,
               int window, float scale, const int64_t* st, float* lse,
               int lse_ld, cudaStream_t s) {
  // TMA reads 16-byte-aligned bases and strides (the wrapper checks first)
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return int(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8) return int(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  // q's map ends at Sq, k's and v's at Sk: a key tile past Sk loads zeros
  int err = encode(&tq, q, d, Sq, H, B, st[0], st[1], st[2]);
  if (err == 0) err = encode(&tk, k, d, Sk, KV, B, st[3], st[4], st[5]);
  if (err == 0) err = encode(&tv, v, d, Sk, KV, B, st[6], st[7], st[8]);
  if (err != 0) return err;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int rep = H / KV;
  if (lse == nullptr) {
    if (d <= 64) return launch<64, false>(tq, tk, tv, out, B, H, rep, Sq, Sk, d, causal, window, scale_log2, st + 9, nullptr, 0, s);
    if (d <= 128) return launch<128, false>(tq, tk, tv, out, B, H, rep, Sq, Sk, d, causal, window, scale_log2, st + 9, nullptr, 0, s);
    if (d <= 256) return launch<256, false>(tq, tk, tv, out, B, H, rep, Sq, Sk, d, causal, window, scale_log2, st + 9, nullptr, 0, s);
  } else {
    // the backward kernel takes d <= 128: only those store an lse
    if (d <= 64) return launch<64, true>(tq, tk, tv, out, B, H, rep, Sq, Sk, d, causal, window, scale_log2, st + 9, lse, lse_ld, s);
    if (d <= 128) return launch<128, true>(tq, tk, tv, out, B, H, rep, Sq, Sk, d, causal, window, scale_log2, st + 9, lse, lse_ld, s);
  }
  return int(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------------
// the backward (bfloat16, DP = 64 or 128)

// a block is one warpgroup that issues its own TMA loads (thread 0); two
// blocks share an SM, so each may hold 255 registers a thread
constexpr int kBwdStages = 2;
constexpr int kVecBytes = 2 * kBQ * 4;               // a tile's lse2 and D

// two resident 64-row tiles (dkdv: K and V; dq: Q and dO), a ring of
// stages of two tiles (dkdv: Q and dO; dq: K and V), each stage's lse2 and
// D (dkdv), the barriers
template <int DP>
struct BwdShape {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kStageOff = 2 * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kVecOff = kStageOff + kBwdStages * kStageBytes;
  static constexpr int kBarOffset = kVecOff + kBwdStages * kVecBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + kBwdStages) + 1024;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// no (query, key) pair of the 64 x 64 tiles at q0 and k0 is visible
__device__ __forceinline__ bool tile_masked(int q0, int k0, int Sq, int Sk,
                                            int causal, int window) {
  return q0 >= Sq || k0 >= Sk || (causal && k0 > q0 + kBQ - 1) ||
         (window > 0 && q0 - (k0 + kBK - 1) >= window);
}

// x = hi + lo, each bfloat16, for the pair (x0, x1): a register A operand's
// word from each part
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void pin(uint32_t (&r)[4][4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) asm volatile("" : "+r"(r[i][j][c]) :: "memory");
}

// the 32 accumulator fragments of a 64 x 64 product (rows of the warpgroup,
// columns of the tile) as the register A operands of the next product,
// split: a[kk][r][0] high parts, a[kk][r][1] low parts
__device__ __forceinline__ void split_operand(const float (&x)[32],
                                              uint32_t (&a)[4][4][2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], a[kk][r][0],
                 a[kk][r][1]);
}

template <int DP>
__device__ __forceinline__ void wgmma_pv_split(float (&acc)[DP / 2],
                                               const uint32_t (&a)[4][2],
                                               uint64_t db) {
  const uint32_t hi[4] = {a[0][0], a[1][0], a[2][0], a[3][0]};
  const uint32_t lo[4] = {a[0][1], a[1][1], a[2][1], a[3][1]};
  wgmma_pv<DP>(acc, hi, db);
  wgmma_pv<DP>(acc, lo, db);
}

// S (+)= A . B^T over the head dim, both 64-row tiles K-major in shared
// memory: the forward's Q . K^T
template <int DP>
__device__ __forceinline__ void wgmma_rows(float (&d)[32], uint32_t a_addr,
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
    wgmma_ss_n64(d, sw128_desc(a_addr + off, 16, 1024),
                 sw128_desc(b_addr + off, 16, 1024), kk > 0);
  }
}

// the MN-major descriptor of keys or queries 16 kk .. 16 kk + 15 of a
// 64-row tile read transposed (as the forward reads V)
__device__ __forceinline__ uint64_t tdesc(uint32_t addr, int kk) {
  return sw128_desc(addr + kk * 16 * 128, kPanelBytes, 1024);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// D = rowsum(dO * O) in float32, rows < ld of each (b, h); 0 past Sq
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const __nv_bfloat16* __restrict__ dout,
                     const __nv_bfloat16* __restrict__ out,
                     float* __restrict__ dsum, int H, int Sq, int ld, int d,
                     int64_t rows, int64_t do_sb, int64_t do_sh,
                     int64_t do_ss, int64_t o_sb, int64_t o_sh,
                     int64_t o_ss) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = int(row % ld);
  const int bh = int(row / ld);
  const int h = bh % H, b = bh / H;
  float acc = 0.f;
  if (i < Sq) {
    const __nv_bfloat16* a = dout + b * do_sb + h * do_sh + i * do_ss;
    const __nv_bfloat16* o = out + b * o_sb + h * o_sh + i * o_ss;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a + c));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + c));
      acc += x.x * y.x + x.y * y.y;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) dsum[row] = acc;
}

// dK and dV of one query head: fp32 partials (B, H, Sk, d), dK already
// scaled, summed over the KV group's heads by flash_bwd_sum_kernel.  One
// block per (64 keys, head, batch), blocks in key order, so under the
// causal mask the first (heaviest) key tiles start first.  The block walks
// the 64-query tiles that see one of its keys.
template <int DP>
__global__ void __launch_bounds__(kConsumers, 2)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      float* __restrict__ dk_part, float* __restrict__ dv_part,
                      int H, int KV, int Sq, int Sk, int d, int causal,
                      int window, int ld, float scale, float scale_log2) {
  using C = BwdShape<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;

  const int h = int(blockIdx.x) % H;
  const int k0 = (int(blockIdx.x) / H) * kBK;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the query tiles that see a key of this block
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + kBK - 1 + window) : Sq;
  const int n_it = q_end > q_begin ? (q_end - q_begin + kBQ - 1) / kBQ : 0;
  const int64_t row = int64_t(b * H + h) * ld;

  // stage s of tile t: Q and dO, lse2 and D of queries q_begin + 64 t
  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  auto load = [=](int t) {
    const int s = t % kBwdStages;
    const int q0 = q_begin + t * kBQ;
    unsigned char* qs = smem + C::kStageOff + s * C::kStageBytes;
    unsigned char* vec = smem + C::kVecOff + s * kVecBytes;
    hopper::mbar_expect_tx(&full[s], 2 * C::kTileBytes + kVecBytes);
    for (int p = 0; p < C::kPanels; ++p) {
      hopper::tma_load_4d(qs + p * kPanelBytes, mq, &full[s], p * kPanel,
                          q0, h, b);
      hopper::tma_load_4d(qs + C::kTileBytes + p * kPanelBytes, mdo,
                          &full[s], p * kPanel, q0, h, b);
    }
    hopper::bulk_load(vec, lse + row + q0, kBQ * 4, &full[s]);
    hopper::bulk_load(vec + kBQ * 4, dsum + row + q0, kBQ * 4, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < 1 + kBwdStages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_mbar_init();
    hopper::mbar_expect_tx(kv_full, 2 * C::kTileBytes);
    for (int p = 0; p < C::kPanels; ++p) {
      hopper::tma_load_4d(smem + p * kPanelBytes, &tk, kv_full, p * kPanel,
                          k0, g, b);
      hopper::tma_load_4d(smem + C::kTileBytes + p * kPanelBytes, &tv,
                          kv_full, p * kPanel, k0, g, b);
    }
    for (int t = 0; t < min(n_it, kBwdStages); ++t) load(t);
  }
  __syncthreads();

  // the keys k0 .. k0 + 63 are the rows of S^T: a lane holds rows row0 and
  // row0 + 8 and query columns 8j + 2 t4 + {0, 1}
  const int t4 = lane & 3;
  const int row0 = k0 + 16 * warp + (lane >> 2);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t k_addr = base;
  const uint32_t v_addr = base + C::kTileBytes;
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int t = 0; t < n_it; ++t) {
    const int s = t % kBwdStages;
    const int q0 = q_begin + t * kBQ;
    const uint32_t q_addr = base + C::kStageOff + s * C::kStageBytes;
    const uint32_t do_addr = q_addr + C::kTileBytes;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + C::kVecOff + s * kVecBytes);
    const float* d_s = lse_s + kBQ;
    hopper::mbar_wait(&full[s], (t / kBwdStages) & 1);
    if (!tile_masked(q0, k0, Sq, Sk, causal, window)) {
      float sc[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
      pin(sc);
      pin(dp);
      wgmma_fence();
      wgmma_rows<DP>(sc, k_addr, q_addr);       // S^T = K Q^T
      wgmma_rows<DP>(dp, v_addr, do_addr);      // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int kpos = row0 + 8 * ((x >> 1) & 1);
        const int col = 8 * (x >> 2) + 2 * t4 + (x & 1);
        const bool ok = visible(q0 + col, kpos, Sq, Sk, causal, window);
        const float p = ok ? exp2f(sc[x] * scale_log2 - lse_s[col]) : 0.f;
        sc[x] = p;
        dp[x] = p * (dp[x] - d_s[col]);
      }
      uint32_t pa[4][4][2], sa[4][4][2];
      split_operand(sc, pa);
      split_operand(dp, sa);
      pin(pa);
      pin(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wgmma_pv_split<DP>(dv_acc, pa[kk], tdesc(do_addr, kk));  // P^T dO
        wgmma_pv_split<DP>(dk_acc, sa[kk], tdesc(q_addr, kk));   // dS^T Q
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dk_acc);
      pin(dv_acc);
    }
    if (t + kBwdStages < n_it) {
      // every thread is done with stage s: refill it
      __syncthreads();
      if (tid == 0) {
        hopper::fence_proxy_async();
        load(t + kBwdStages);
      }
    }
  }

  float* kp = dk_part + (int64_t(b * H + h) * Sk) * d;
  float* vp = dv_part + (int64_t(b * H + h) * Sk) * d;
#pragma unroll
  for (int x = 0; x < DP / 2; x += 2) {
    const int kpos = row0 + 8 * ((x >> 1) & 1);
    const int col = 8 * (x >> 2) + 2 * t4;
    if (kpos < Sk && col < d) {
      *reinterpret_cast<float2*>(kp + int64_t(kpos) * d + col) =
          make_float2(dk_acc[x] * scale, dk_acc[x + 1] * scale);
      *reinterpret_cast<float2*>(vp + int64_t(kpos) * d + col) =
          make_float2(dv_acc[x], dv_acc[x + 1]);
    }
  }
}

// dK and dV: the KV group's heads' partials summed in head order and
// rounded to bfloat16 once; two columns a thread
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ dk_part,
                     const float* __restrict__ dv_part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int KV, int Sk,
                     int d, int64_t pairs, int64_t dk_sb, int64_t dk_sh,
                     int64_t dk_ss, int64_t dv_sb, int64_t dv_sh,
                     int64_t dv_ss) {
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (i >= pairs) return;
  const int half = d / 2;
  const int col = int(i % half) * 2;
  const int64_t r = i / half;                   // (b * KV + g) * Sk + kpos
  const int kpos = int(r % Sk);
  const int g = int((r / Sk) % KV);
  const int b = int(r / (int64_t(Sk) * KV));
  const int rep = H / KV;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int j = 0; j < rep; ++j) {
    const int64_t off = ((int64_t(b * H + g * rep + j) * Sk) + kpos) * d + col;
    const float2 a = *reinterpret_cast<const float2*>(dk_part + off);
    const float2 c = *reinterpret_cast<const float2*>(dv_part + off);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += c.x;
    sv.y += c.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + b * dk_sb + g * dk_sh +
                                     kpos * dk_ss + col) =
      __floats2bfloat162_rn(sk.x, sk.y);
  *reinterpret_cast<__nv_bfloat162*>(dv + b * dv_sb + g * dv_sh +
                                     kpos * dv_ss + col) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

// dQ: one block per (64 queries, head, batch) over the key tiles its
// queries see; under the causal mask every head's last (heaviest) query
// tiles first, as the forward
template <int DP>
__global__ void __launch_bounds__(kConsumers, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int H, int KV, int Sq,
                    int Sk, int d, int causal, int window, int ld,
                    float scale, float scale_log2, int64_t dq_sb,
                    int64_t dq_sh, int64_t dq_ss) {
  using C = BwdShape<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;

  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int tile = int(blockIdx.x) / H;
  const int q0 = (causal ? n_q - 1 - tile : tile) * kBQ;
  const int h = int(blockIdx.x) % H;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the key tiles that hold a key some query of this block sees
  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin -= kv_begin % kBK;
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load = [=](int t) {
    const int s = t % kBwdStages;
    unsigned char* ks = smem + C::kStageOff + s * C::kStageBytes;
    const int kt0 = kv_begin + t * kBK;
    hopper::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
    for (int p = 0; p < C::kPanels; ++p) {
      hopper::tma_load_4d(ks + p * kPanelBytes, mk, &full[s], p * kPanel,
                          kt0, g, b);
      hopper::tma_load_4d(ks + C::kTileBytes + p * kPanelBytes, mv,
                          &full[s], p * kPanel, kt0, g, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 1 + kBwdStages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_mbar_init();
    hopper::mbar_expect_tx(q_full, 2 * C::kTileBytes);
    for (int p = 0; p < C::kPanels; ++p) {
      hopper::tma_load_4d(smem + p * kPanelBytes, &tq, q_full, p * kPanel, q0,
                          h, b);
      hopper::tma_load_4d(smem + C::kTileBytes + p * kPanelBytes, &tdo,
                          q_full, p * kPanel, q0, h, b);
    }
    for (int t = 0; t < min(n_tiles, kBwdStages); ++t) load(t);
  }
  __syncthreads();

  // the forward's fragment layout: rows row0 and row0 + 8 of the tile
  const int t4 = lane & 3;
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t q_addr = base;
  const uint32_t do_addr = base + C::kTileBytes;
  // rows up to q0 + 63 lie inside ld
  const float* lp = lse + int64_t(b * H + h) * ld;
  const float* dp_row = dsum + int64_t(b * H + h) * ld;
  const float lse_r[2] = {lp[row0], lp[row0 + 8]};
  const float d_r[2] = {dp_row[row0], dp_row[row0 + 8]};
  float dq_acc[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) dq_acc[x] = 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBwdStages;
    const int kt0 = kv_begin + t * kBK;
    const uint32_t k_addr = base + C::kStageOff + s * C::kStageBytes;
    const uint32_t v_addr = k_addr + C::kTileBytes;
    hopper::mbar_wait(&full[s], (t / kBwdStages) & 1);
    if (!tile_masked(q0, kt0, Sq, Sk, causal, window)) {
      float sc[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
      pin(sc);
      pin(dp);
      wgmma_fence();
      wgmma_rows<DP>(sc, q_addr, k_addr);       // S = Q K^T
      wgmma_rows<DP>(dp, do_addr, v_addr);      // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        const int kpos = kt0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
        const bool ok = visible(row0 + 8 * i, kpos, Sq, Sk, causal, window);
        const float p = ok ? exp2f(sc[x] * scale_log2 - lse_r[i]) : 0.f;
        dp[x] = p * (dp[x] - d_r[i]);
      }
      uint32_t sa[4][4][2];
      split_operand(dp, sa);
      pin(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv_split<DP>(dq_acc, sa[kk], tdesc(k_addr, kk));  // dS K
      wgmma_commit();
      wgmma_wait_all();
      pin(dq_acc);
    }
    if (t + kBwdStages < n_tiles) {
      __syncthreads();
      if (tid == 0) {
        hopper::fence_proxy_async();
        load(t + kBwdStages);
      }
    }
  }

  __nv_bfloat16* qp = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int x = 0; x < DP / 2; x += 2) {
    const int qpos = row0 + 8 * ((x >> 1) & 1);
    const int col = 8 * (x >> 2) + 2 * t4;
    if (qpos < Sq && col < d)
      *reinterpret_cast<__nv_bfloat162*>(qp + qpos * dq_ss + col) =
          __floats2bfloat162_rn(dq_acc[x] * scale, dq_acc[x + 1] * scale);
  }
}

// st: (b, head, position) strides of q, k, v, out, dout, dq, dk and dv;
// part: float32 scratch of 2 * B * H * Sk * d (the heads' dK and dV)
template <int DP>
int launch_bwd(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, const CUtensorMap& tdo,
               const void* out, const void* dout, const float* lse,
               float* dsum, float* part, void* dq, void* dk, void* dv, int B,
               int H, int KV, int Sq, int Sk, int d, int causal, int window,
               int ld, const int64_t* st, cudaStream_t stream) {
  static std::atomic<uint64_t> done_kv{0}, done_q{0};
  auto kv_kernel = flash_bwd_dkdv_kernel<DP>;
  auto q_kernel = flash_bwd_dq_kernel<DP>;
  cudaError_t err = allow_smem(kv_kernel, BwdShape<DP>::kSmem, done_kv);
  if (err == cudaSuccess)
    err = allow_smem(q_kernel, BwdShape<DP>::kSmem, done_q);
  if (err != cudaSuccess) return int(err);
  const float scale = 1.f / sqrtf(float(d));
  const float scale_log2 = scale * 1.4426950408889634f;
  const int64_t rows = int64_t(B) * H * ld;
  flash_bwd_dot_kernel<<<unsigned((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), dsum, H, Sq, ld, d, rows,
      st[12], st[13], st[14], st[9], st[10], st[11]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  float* dk_part = part;
  float* dv_part = part + int64_t(B) * H * Sk * d;
  const dim3 kv_grid(((Sk + kBK - 1) / kBK) * H, 1, B);
  kv_kernel<<<kv_grid, kConsumers, BwdShape<DP>::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, dsum, dk_part, dv_part, H, KV, Sq, Sk, d, causal,
      window, ld, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t pairs = int64_t(B) * KV * Sk * (d / 2);
  flash_bwd_sum_kernel<<<unsigned((pairs + 255) / 256), 256, 0, stream>>>(
      dk_part, dv_part, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, KV, Sk, d, pairs, st[18], st[19],
      st[20], st[21], st[22], st[23]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 q_grid(((Sq + kBQ - 1) / kBQ) * H, 1, B);
  q_kernel<<<q_grid, kConsumers, BwdShape<DP>::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<__nv_bfloat16*>(dq), H, KV,
      Sq, Sk, d, causal, window, ld, scale, scale_log2, st[15], st[16],
      st[17]);
  return 0;
}

}  // namespace tc

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (tile_matmul's codes).  Sq and Sk are
// the query and key lengths; they differ only when causal is 0.  Strides
// are in elements, (batch, head, position) for q, k, v and out in that order; the
// head dimension is contiguous in all four.  lse: null, or (bfloat16, d <=
// 128) a float32 (B, H, lse_ld) buffer, lse_ld >= Sq a multiple of 64,
// for each row's log2-sum-exp (the backward's input).  Returns 0 when the
// launch was accepted, a cudaError_t as a positive int, or minus the
// CUresult of a tensor map the driver refused.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int H, int KV, int Sq, int Sk, int d, int causal, int window,
    int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, float* lse, int lse_ld, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      d <= 0 || (causal && Sq != Sk))
    return int(cudaErrorInvalidValue);
  const float scale = 1.f / sqrtf(float(d));
  const int64_t st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                          v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 1:
      if (lse != nullptr) return int(cudaErrorInvalidValue);
      err = f32::dispatch_d(q, k, v, out, B, H, H / KV, Sq, Sk, d, causal, window, scale, st, s);
      break;
    case 2:
      if (d % 8 != 0) return int(cudaErrorInvalidValue);
      if (lse != nullptr && (lse_ld < Sq || lse_ld % kBQ != 0))
        return int(cudaErrorInvalidValue);
      err = tc::dispatch_d(q, k, v, out, B, H, KV, Sq, Sk, d, causal, window, scale, st, lse, lse_ld, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}

// The gradient of a bfloat16 flash_attention call at the forward's out and
// lse (lse_ld as there) for the output gradient dout: dq (B, H, Sq, d), dk
// and dv (B, KV, Sk, d), bfloat16.  dsum is float32 scratch of B * H *
// lse_ld.  st: 24 strides in elements, (batch, head, position) of q, k, v,
// out, dout, dq, dk and dv in that order, the head dimension contiguous in
// all; q, k, v and dout are read by TMA (16-byte aligned bases and
// strides).  d <= 128 and a multiple of 8.  Returns as
// flash_attention_launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* dsum, float* part, void* dq,
    void* dk, void* dv, int B, int H, int KV, int Sq, int Sk, int d,
    int causal, int window, int lse_ld, const int64_t* st, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      d <= 0 || d > 128 || d % 8 != 0 || (causal && Sq != Sk) ||
      lse_ld < Sq || lse_ld % kBQ != 0)
    return int(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return int(cudaErrorInvalidValue);
  for (int i = 0; i < 24; ++i)
    if (st[i] % 8) return int(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = tc::encode(&tq, q, d, Sq, H, B, st[0], st[1], st[2]);
  if (err == 0) err = tc::encode(&tk, k, d, Sk, KV, B, st[3], st[4], st[5]);
  if (err == 0) err = tc::encode(&tv, v, d, Sk, KV, B, st[6], st[7], st[8]);
  if (err == 0) err = tc::encode(&tdo, dout, d, Sq, H, B, st[12], st[13], st[14]);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    err = tc::launch_bwd<64>(tq, tk, tv, tdo, out, dout, lse, dsum, part, dq, dk, dv, B, H, KV, Sq, Sk, d, causal, window, lse_ld, st, s);
  else
    err = tc::launch_bwd<128>(tq, tk, tv, tdo, out, dout, lse, dsum, part, dq, dk, dv, B, H, KV, Sq, Sk, d, causal, window, lse_ld, st, s);
  if (err != 0) return err;
  return int(cudaGetLastError());
}
