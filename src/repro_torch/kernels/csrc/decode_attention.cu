// Flash-decoding for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache,
//
//     out[b, h] = softmax(q[b, h] . K[b, :, g]^T / sqrt(d)) . V[b, :, g]
//
// over the valid positions lo <= pos < length, where g = h / (H / KV) is the
// query head's KV head (grouped-query attention read in place, the mapping
// of jnp.repeat(..., axis=2) in the reference) and lo = max(0, length -
// window) with a sliding window, else 0.  q is (B, H, d); k and v are
// (B, S, KV, d), read through their strides (the innermost dimension is
// contiguous), so one layer's slice of the model's cache is taken in place;
// out is (B, H, d).  float32 and bfloat16, accumulated in float32.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention (the Pallas
// kernel `_decode_kernel`), which sweeps bk = 512 sequence blocks in order
// with an (m, l, acc) online-softmax carry in VMEM scratch, masks pos >=
// length with a finite NEG_INF and divides by max(l, 1e-30), so a fully
// masked row gives zeros.  It also takes the body of the reference's
// layers.decode_attention, which adds GQA and the sliding window; any S is
// taken (the Pallas kernel needs S % 512 == 0), and length = 0 gives zeros.
//
// Design: a TPU grid step carries (m, l, acc) to the next; CUDA blocks run in
// parallel and carry nothing, so the sequence sweep is a loop inside one
// block per (b, h).  Its 8 warps take interleaved chunks of 8 keys; each lane
// holds d/32 columns, every key's dot product is a warp butterfly sum (the
// same bits on every lane), and each warp keeps its own online softmax.  The
// 8 warps' (m, l, acc) are then merged in shared memory in a fixed order, so
// the same inputs give the same bits on every run: no atomics anywhere.
// Masked positions are never visited, so no NEG_INF is needed; the final
// divide by max(l, 1e-30) makes an empty range give zeros.  p stays float32
// in the p . V product (the reference's layers.decode_attention rounds p to
// the cache's type first).
//
// What bounds it on an H100: every K and V element is read once per query
// head (the KV head's `rep` query heads each read it: GQA in place, no copy),
// 4 bytes of FMA work per 2-byte element: bytes bound it, far below the
// tensor cores' ratio.  One block per (b, h) gives B * H blocks: 40 at the
// serving path's B = 1, H = 40, on 132 SMs, so at most 40 SMs pull from
// memory; splitting the sequence across blocks (split-K with a second merge
// pass) is the later step.  Each warp loads its 8 keys' K and V rows before
// using them, to keep 8 row loads in flight per warp.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;        // keys per warp per round, loaded together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// xor butterfly: at each level a lane adds its partner's value to its own,
// a + b on one side and b + a on the other, so every lane ends with the
// same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DPL: columns per lane, d <= 32 * DPL
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        int rep, int d, int lo, int length, float scale,
                        int64_t q_sb, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t k_sh, int64_t v_sb,
                        int64_t v_ss, int64_t v_sh, int64_t o_sb,
                        int64_t o_sh) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * DPL];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / rep;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + g * k_sh;
  const T* vp = v + b * v_sb + g * v_sh;

  float qr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? to_f(qp[c]) : 0.f;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int j0 = lo + warp * kUnroll; j0 < length; j0 += kWarps * kUnroll) {
    float kr[kUnroll][DPL];
    float vr[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        const bool ok = j < length && c < d;
        kr[u][i] = ok ? to_f(kp[j * k_ss + c]) : 0.f;
        vr[u][i] = ok ? to_f(vp[j * v_ss + c]) : 0.f;
      }
    }
    float s[kUnroll];
    float cmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qr[i] * kr[u][i];
      s[u] = warp_sum(part) * scale;
      if (j0 + u < length) cmax = fmaxf(cmax, s[u]);
    }
    // key j0 is valid, so m_new is finite; exp(-inf) = 0 on the first round
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < length) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += p * vr[u][i];
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  // merge the warps' partial softmaxes in warp order; a warp that saw no
  // key (m = -inf) weighs 0, and no key at all gives zeros
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float f[kWarps];
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
    total += sm_l[w] * f[w];
  }
  const float inv = 1.f / fmaxf(total, 1e-30f);
  T* op = out + b * o_sb + h * o_sh;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][c] * f[w];
    store(op + c, o * inv);
  }
}

template <typename T, int DPL>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int H, int rep, int d, int lo, int length, float scale,
            const int64_t* st, cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_attention_kernel<T, DPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), rep, d, lo, length,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9]);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int H, int rep, int d, int lo, int length, float scale,
               const int64_t* st, cudaStream_t s) {
  if (d <= 32) launch<T, 1>(q, k, v, out, B, H, rep, d, lo, length, scale, st, s);
  else if (d <= 64) launch<T, 2>(q, k, v, out, B, H, rep, d, lo, length, scale, st, s);
  else if (d <= 128) launch<T, 4>(q, k, v, out, B, H, rep, d, lo, length, scale, st, s);
  else if (d <= 256) launch<T, 8>(q, k, v, out, B, H, rep, d, lo, length, scale, st, s);
  else return int(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (tile_matmul's codes).  Strides are in
// elements: q (b, h), k (b, s, kv head), v (b, s, kv head), out (b, h); the
// head dimension is contiguous in all four.  Returns a cudaError_t as int:
// 0 when the launch was accepted.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int H, int KV, int S, int d, int length, int window, int64_t q_sb,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || d <= 0 || length < 0 ||
      length > S)
    return int(cudaErrorInvalidValue);
  const int lo = window > 0 ? (length - window > 0 ? length - window : 0) : 0;
  const float scale = 1.f / sqrtf(float(d));
  const int64_t st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 1:
      err = dispatch_d<float>(q, k, v, out, B, H, H / KV, d, lo, length, scale, st, s);
      break;
    case 2:
      err = dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, H / KV, d, lo, length, scale, st, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
