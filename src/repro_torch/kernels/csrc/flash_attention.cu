// Forward flash attention for Hopper (sm_90a), causal and sliding-window,
//
//     out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, g, j] / sqrt(d)) v[b, g, j]
//
// over the keys j with j <= i (causal) and i - j < window (window > 0),
// where g = h / (H / KV) is the query head's KV head (grouped-query
// attention read in place, the mapping of jnp.repeat in the reference).
// q and out are (B, H, S, d), k and v (B, KV, S, d), each read or written
// through its (b, head, position) strides with the innermost dimension
// contiguous, so a transposed view of the projections is taken without a
// copy.  float32 and bfloat16, accumulated in float32.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel `_flash_kernel`), which keeps a bq = 128 query block in VMEM and
// sweeps bk = 128 key blocks along the grid's sequential minor axis with an
// (m, l, acc) online softmax in f32 scratch, and needs S % 128 == 0.  It
// also takes the body of the reference's layers._chunked_attn as prefill
// calls it (q_offset = 0, Sq = Sk), which adds GQA and pads a ragged S:
// here any S is taken and the ragged edge is masked inside the kernel.
//
// Design: one block of 256 threads per (64-query tile, head, batch); the
// key sweep is a loop inside the block, since CUDA blocks carry nothing
// between them.  Q, one 64-key tile of K and of V, and the 64 x 64 score
// tile sit in shared memory as float32 (rows padded by one word against
// bank conflicts).  Each thread computes a 4 x 4 patch of scores and owns
// 4 rows x d/16 columns of the output accumulator in registers.  Masked
// scores (after the causal diagonal, outside the window, past S) are set
// to -inf *before* the row max, so a ragged or diagonal tile never feeds
// garbage into the online-softmax carry; a row whose tile is all masked
// keeps its carry unchanged.  Key tiles wholly after the diagonal or before
// the window are skipped.  Row maxima and sums are warp butterfly
// reductions in a fixed order: no atomics, the same bits on every run.
//
// What bounds it on an H100: causal prefill does 2 * S^2 * d * H flops (half
// the square, QK and PV) and moves 2 * S * d * (2 * H + 2 * KV) bytes in
// bf16; at qwen3-14b's heads (H = 40, KV = 8, d = 128) the two bounds meet
// near S = 700 (3.35 TB/s against the bf16 tensor cores' 989 TFLOP/s), so a
// 512-token prompt is bound by bytes and longer ones by operations.  This
// kernel uses plain float32 FMAs from shared memory, far from either bound;
// wgmma and TMA (the FlashAttention-3 design) are the later step.  The
// score tile and float32 Q, K and V take 116 KB of shared memory at d = 128
// (214 KB at d = 256), so one block runs per SM.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 score patch each
constexpr int kPS = kBK + 1;      // padded score-tile row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
template <typename T, int DCH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int rep,
                       int S, int d, int causal, int window, float scale,
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
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + g * k_sh;
  const T* vp = v + b * v_sb + g * v_sh;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int qpos = q0 + r;
    qs[r * dp + c] = qpos < S ? to_f(qp[qpos * q_ss + c]) : 0.f;
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

  // key tiles that hold an unmasked key for some row of this query tile
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin -= kv_begin % kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();                     // the last tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int kpos = k0 + r;
      const bool ok = kpos < S;
      ks[r * dp + c] = ok ? to_f(kp[kpos * k_ss + c]) : 0.f;
      vs[r * d + c] = ok ? to_f(vp[kpos * v_ss + c]) : 0.f;
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
        const bool ok = kpos < S && (!causal || kpos <= qpos) &&
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

  T* op = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qpos = q0 + r;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(op + qpos * o_ss + c, o[i][j] * inv);
    }
  }
}

// Raises an instantiation's dynamic shared-memory limit to what its widest
// head (d = 16 * DCH) needs, once per device rather than on every launch
// (prefill launches once per layer).  Devices past the 64th are set on
// every launch.
template <typename T, int DCH>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, DCH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_bytes(16 * DCH)));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int DCH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int rep, int S, int d, int causal, int window, float scale,
           const int64_t* st, cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  const cudaError_t err = allow_smem<T, DCH>();
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DCH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), rep, S, d, causal,
      window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return 0;
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int H, int rep, int S, int d, int causal, int window,
               float scale, const int64_t* st, cudaStream_t s) {
  if (d <= 32) return launch<T, 2>(q, k, v, out, B, H, rep, S, d, causal, window, scale, st, s);
  if (d <= 64) return launch<T, 4>(q, k, v, out, B, H, rep, S, d, causal, window, scale, st, s);
  if (d <= 128) return launch<T, 8>(q, k, v, out, B, H, rep, S, d, causal, window, scale, st, s);
  if (d <= 256) return launch<T, 16>(q, k, v, out, B, H, rep, S, d, causal, window, scale, st, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (tile_matmul's codes).  Strides are in
// elements, (batch, head, position) for q, k, v and out in that order; the
// head dimension is contiguous in all four.  Returns a cudaError_t as int:
// 0 when the launch was accepted.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int H, int KV, int S, int d, int causal, int window, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || d <= 0)
    return int(cudaErrorInvalidValue);
  const float scale = 1.f / sqrtf(float(d));
  const int64_t st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                          v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 1:
      err = dispatch_d<float>(q, k, v, out, B, H, H / KV, S, d, causal, window, scale, st, s);
      break;
    case 2:
      err = dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, H / KV, S, d, causal, window, scale, st, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
