// AdamW's update of one leaf, in two passes a step:
//
//   1. the gradient's sum of squares (sumsq_kernel): each block writes
//      its float32 partial, times the leaf's weight, to a scratch buffer
//      the wrapper allocates; one block (sumsq_finish_kernel) then adds
//      every leaf's partials in a fixed order, so the same gradients at
//      the same addresses give the same bits on every run;
//   2. the clip and the update (update_kernel): per element, in registers,
//      g * scale rounded to g's type, then the reference's float32 AdamW
//      and p rounded once to its type; p, m and v written back in place.
//
// Replaces no TPU kernel: the reference updates with jnp ops
// (repro/optim/adamw.py), which XLA fuses.  The port's plain version,
// optim/adamw.py's chunked torch ops, runs ~19 separate passes a chunk
// that each read and write float32 temporaries in device memory (~200
// bytes a parameter).  This file moves what the work needs: the
// gradient once for the norm (4 bytes a float32 element) and p, g, m and
// v once for the update (2 + 4 + 8 + 8 bytes for bf16 p), 28 bytes a
// parameter, all of it streamed: bytes bound it at 3.35 TB/s, so the
// design is 16-byte loads and stores, enough of them in flight, and
// nothing else in device memory.
//
// Bits.  Every operation of the update is the IEEE-rounded intrinsic of
// the torch op it replaces, in the same order, none contracted into an
// FMA (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): given the
// clip scale, p, m and v come out bit-identical to the plain version.  The
// scalars follow torch's own casts: a Python float becomes a float32
// argument; the scale, lr and bias corrections are float32 device scalars
// the kernel reads through pointers, so the step reads nothing back to the
// host.  A bf16 gradient is clipped as the reference clips it: the
// product with the float32 scale taken in float32 and rounded once to
// bf16.  The clipped gradient is not written back.
//
// Alignment.  Leaves may be views at any element offset (a bucket's
// gradients are slices of one flat buffer), and sizes are not multiples
// of the vector.  A pass takes the `head` elements before the first
// 16-byte boundary and the tail after the last whole vector one by one;
// when p, m and v are not aligned alike the update runs element by
// element, and a gradient aligned unlike them is read element by element
// inside the vector loop.
//
// Launches go on the caller's stream, allocate nothing and return
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // a block of either pass
constexpr int kVec = 8;              // elements a thread takes at once
constexpr int kFinishThreads = 1024;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec consecutive elements at a 16-byte-aligned address, as float32
__device__ __forceinline__ void load_vec(const float* src, float* out) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load_vec(const bf16* src, float* out) {
  const uint4 raw = reinterpret_cast<const uint4*>(src)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* dst, const float* in) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

__device__ __forceinline__ void store_vec(bf16* dst, const float* in) {
  uint4 raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = __float2bfloat16_rn(in[k]);
  reinterpret_cast<uint4*>(dst)[0] = raw;
}

// ---------------------------------------------------------------- the norm
// a sum over the block in a fixed order (a butterfly in each warp, then
// the warps' sums by the first warp); every thread gets the total
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  const int warps = blockDim.x >> 5;
  x = lane < warps ? warp_sums[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// each block's sum of g^2 over its share of the leaf, times `weight`
template <typename G>
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const G* __restrict__ g, int64_t n, int64_t head, int64_t nvec,
             float weight, float* __restrict__ partial) {
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
  for (int64_t i = tid; i < nvec; i += stride) {
    float x[kVec];
    load_vec(g + head + i * kVec, x);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = __fmaf_rn(x[k], x[k], acc[k]);
  }
  const int64_t body_end = head + nvec * kVec;
  if (tid < head) {
    const float x = to_f32(g[tid]);
    acc[0] = __fmaf_rn(x, x, acc[0]);
  }
  if (tid < n - body_end) {
    const float x = to_f32(g[body_end + tid]);
    acc[1] = __fmaf_rn(x, x, acc[1]);
  }
  float s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
            ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s * weight;
}

// the sum of `count` partials, each thread a strided share, then the block
__global__ void __launch_bounds__(kFinishThreads)
sumsq_finish_kernel(const float* __restrict__ partial, int64_t count,
                    float* __restrict__ out) {
  float s = 0.0f;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) s += partial[i];
  s = block_sum(s);
  if (threadIdx.x == 0) *out = s;
}

// ------------------------------------------------------------- the update
struct Scalars {
  const float* scale;   // the clip's min(1, max_norm / norm)
  const float* lr;
  const float* bc1;     // 1 - b1^step
  const float* bc2;     // 1 - b2^step
  float b1, c1, b2, c2, eps, wd;   // c1 = (float)(1 - b1), c2 likewise
};

struct Coeffs {
  float scale, lr, bc1, bc2, b1, c1, b2, c2, eps, wd;
};

__device__ __forceinline__ Coeffs coeffs(const Scalars& s) {
  Coeffs c;
  c.scale = *s.scale;
  c.lr = *s.lr;
  c.bc1 = *s.bc1;
  c.bc2 = *s.bc2;
  c.b1 = s.b1; c.c1 = s.c1; c.b2 = s.b2; c.c2 = s.c2;
  c.eps = s.eps; c.wd = s.wd;
  return c;
}

// g * scale in float32, rounded to g's type, as float32
template <typename G>
__device__ __forceinline__ float clipped(float g, float scale) {
  return to_f32(from_f32<G>(__fmul_rn(g, scale)));
}

// the plain version's float32 operations, in its order:
//   m = m*b1 + (1-b1)*g;  v = v*b2 + ((1-b2)*g)*g
//   delta = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p;  p = p - lr*delta
__device__ __forceinline__ void step_one(float& p, float g, float& m, float& v,
                                         const Coeffs& c) {
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.c1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(g, c.c2), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), c.eps);
  float delta = __fdiv_rn(__fdiv_rn(m, c.bc1), den);
  delta = __fadd_rn(delta, __fmul_rn(p, c.wd));
  p = __fsub_rn(p, __fmul_rn(c.lr, delta));
}

template <typename P, typename G>
__device__ __forceinline__ void update_at(P* p, const G* g, float* m,
                                          float* v, int64_t e,
                                          const Coeffs& c) {
  float pf = to_f32(p[e]), mf = m[e], vf = v[e];
  step_one(pf, clipped<G>(to_f32(g[e]), c.scale), mf, vf, c);
  p[e] = from_f32<P>(pf);
  m[e] = mf;
  v[e] = vf;
}

// kVecBody: elements [head, head + nvec * kVec) in vectors, the rest one
// by one; otherwise every element one by one.  kVecG: g is aligned as p,
// m and v are.
template <typename P, typename G, bool kVecBody, bool kVecG>
__global__ void __launch_bounds__(kThreads)
update_kernel(P* __restrict__ p, const G* __restrict__ g,
              float* __restrict__ m, float* __restrict__ v, int64_t n,
              int64_t head, int64_t nvec, Scalars s) {
  const Coeffs c = coeffs(s);
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  if (!kVecBody) {
    for (int64_t e = tid; e < n; e += stride) update_at(p, g, m, v, e, c);
    return;
  }
  for (int64_t i = tid; i < nvec; i += stride) {
    const int64_t e = head + i * kVec;
    float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
    if (kVecG) {
      load_vec(g + e, gf);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) gf[k] = to_f32(g[e + k]);
    }
    load_vec(p + e, pf);
    load_vec(m + e, mf);
    load_vec(v + e, vf);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      step_one(pf[k], clipped<G>(gf[k], c.scale), mf[k], vf[k], c);
    store_vec(p + e, pf);
    store_vec(m + e, mf);
    store_vec(v + e, vf);
  }
  const int64_t body_end = head + nvec * kVec;
  if (tid < head) update_at(p, g, m, v, tid, c);
  if (tid < n - body_end) update_at(p, g, m, v, body_end + tid, c);
}

// ------------------------------------------------------------- launching
// elements before the first 16-byte boundary at or after `ptr`
template <typename T>
int64_t head_of(const void* ptr, int64_t n) {
  const int64_t bytes = (16 - int64_t(reinterpret_cast<uintptr_t>(ptr) % 16)) % 16;
  const int64_t h = bytes / int64_t(sizeof(T));
  return h < n ? h : n;
}

template <typename T>
bool aligned_at(const void* ptr, int64_t h) {
  return (reinterpret_cast<uintptr_t>(ptr) + h * sizeof(T)) % 16 == 0;
}

// the blocks a grid-stride pass keeps resident on every SM at once
// (`per_sm` of them), and no more: a second wave would leave its blocks'
// shares to run last
int resident_blocks(int per_sm, int64_t units) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = int64_t(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int64_t want = (units + kThreads - 1) / kThreads;
  return int(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename G>
int launch_sumsq(const void* g, int64_t n, float weight, float* partial,
                 int blocks, cudaStream_t s) {
  const G* gg = static_cast<const G*>(g);
  const int64_t head = head_of<G>(g, n);
  const int64_t nvec = (n - head) / kVec;
  sumsq_kernel<G><<<blocks, kThreads, 0, s>>>(gg, n, head, nvec, weight,
                                               partial);
  return int(cudaGetLastError());
}

template <typename P, typename G, bool kVecBody, bool kVecG>
int launch_update_as(P* p, const G* g, float* m, float* v, int64_t n,
                     int64_t head, const Scalars& sc, cudaStream_t s) {
  const int64_t nvec = kVecBody ? (n - head) / kVec : 0;
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, update_kernel<P, G, kVecBody, kVecG>, kThreads, 0);
    return b;
  }();
  const int blocks = resident_blocks(per_sm, kVecBody ? nvec : n);
  update_kernel<P, G, kVecBody, kVecG><<<blocks, kThreads, 0, s>>>(
      p, g, m, v, n, kVecBody ? head : 0, nvec, sc);
  return int(cudaGetLastError());
}

template <typename P, typename G>
int launch_update(void* p, const void* g, float* m, float* v, int64_t n,
                  const Scalars& sc, cudaStream_t s) {
  P* pp = static_cast<P*>(p);
  const G* gg = static_cast<const G*>(g);
  const int64_t head = head_of<float>(m, n);
  if (!aligned_at<float>(v, head) || !aligned_at<P>(p, head))
    return launch_update_as<P, G, false, false>(pp, gg, m, v, n, 0, sc, s);
  if (!aligned_at<G>(g, head))
    return launch_update_as<P, G, true, false>(pp, gg, m, v, n, head, sc, s);
  return launch_update_as<P, G, true, true>(pp, gg, m, v, n, head, sc, s);
}

}  // namespace

// dtype codes: 1 float32, 2 bfloat16 (kernels/adamw.py's _DTYPE_CODES)
extern "C" int adamw_sumsq_launch(int g_dtype, const void* g, long long n,
                                  float weight, float* partial, int blocks,
                                  void* stream) {
  if (n <= 0 || blocks <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 1: return launch_sumsq<float>(g, n, weight, partial, blocks, s);
    case 2: return launch_sumsq<bf16>(g, n, weight, partial, blocks, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int adamw_sumsq_finish_launch(const float* partial,
                                         long long count, float* out,
                                         void* stream) {
  if (count <= 0) return int(cudaErrorInvalidValue);
  sumsq_finish_kernel<<<1, kFinishThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(partial, count,
                                                             out);
  return int(cudaGetLastError());
}

extern "C" int adamw_update_launch(int p_dtype, int g_dtype, void* p,
                                   const void* g, float* m, float* v,
                                   long long n, const float* scale,
                                   const float* lr, const float* bc1,
                                   const float* bc2, float b1, float c1,
                                   float b2, float c2, float eps, float wd,
                                   void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scalars sc{scale, lr, bc1, bc2, b1, c1, b2, c2, eps, wd};
  const int code = p_dtype * 4 + g_dtype;
  switch (code) {
    case 1 * 4 + 1: return launch_update<float, float>(p, g, m, v, n, sc, s);
    case 1 * 4 + 2: return launch_update<float, bf16>(p, g, m, v, n, sc, s);
    case 2 * 4 + 1: return launch_update<bf16, float>(p, g, m, v, n, sc, s);
    case 2 * 4 + 2: return launch_update<bf16, bf16>(p, g, m, v, n, sc, s);
    default: return int(cudaErrorInvalidValue);
  }
}
