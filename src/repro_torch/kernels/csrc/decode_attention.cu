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
// What bounds it on an H100: every valid K and V row is read once, 4 flops
// per query head for each of its 2-byte elements: bytes bound it, far below
// the tensor cores' ratio.  At B = 1 a qwen3-14b layer's cache is 2.2 MB at
// length 545, a few microseconds of the memory rate, so what the kernel
// must do is keep enough of the card's SMs pulling at once.
//
// Design: a grid of (split, KV head, batch) blocks.  [lo, length) is cut
// into `splits` ranges of `per` keys (the wrapper's decode_splits, a
// function of length, window and KV alone, never of B: a lane's bits do
// not depend on who else runs): about 256 blocks per batch row, at most 16
// per KV head, 16 at qwen3-14b's 8 KV heads and 8 at zamba2-7b's 32;
// trailing ranges may be empty.  Each block
// holds all `rep` query heads of its KV head, so each K and V row comes into
// shared memory once, as one bulk copy (cp.async.bulk) per row into a ring
// of 2-4 stages of 32 keys, completing on the stage's mbarrier, and the
// group's query heads all read that copy.  The first stages are requested
// before anything else, so the cache streams in while q is read.  Rows sit
// 16 bytes apart beyond their width, so the 32 lanes of a warp, one key
// each, read the same 16-byte column of their rows from distinct banks.
// Per 32-key tile, 256 threads: a thread per (head, key) takes the dot
// product (q's chunk a broadcast), a warp per head takes the online softmax
// (a lane per key, xor-butterfly max and sum), and a thread per (head, 4
// columns) updates acc = acc * corr + p . V, all in float32, each loop
// unrolled so that several loads are in flight.  p stays float32 in
// the p . V product (the reference's layers.decode_attention rounds p to
// the cache's type first).
//
// The splits of one (b, g) form a thread-block cluster.  After the sweep
// each block's (m, l, acc) per head sits in its shared memory; after a
// cluster barrier every block merges a slice of the group's outputs from
// all blocks' shared memory (distributed shared memory), in split order:
//     out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
// with M the largest m_s.  One launch, no scratch, no counter, no atomics:
// the same inputs give the same bits.  An empty range keeps m = -inf, l = 0,
// acc = 0 and weighs exactly 0; length = 0 gives zeros.
//
// With a non-null `lse` (float32, (B, H), contiguous), block 0 of each
// cluster also writes every head's log-sum-exp of its scaled scores,
// M + log(sum_s l_s e^(m_s - M)), or -inf where no key is valid: partials
// over slices of a sequence-sharded cache then combine exactly.  `out` is
// computed the same way with or without it.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <math.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;           // keys per tile: one a lane in the softmax
constexpr int kMaxSplits = 16;    // the largest (non-portable) cluster
constexpr int kMaxRep = 16;       // query heads per KV head
constexpr int kStageTarget = 64 << 10;   // ring bytes aimed at

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of K as floats
__device__ __forceinline__ void chunk(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void chunk(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// four neighbouring V columns as floats
__device__ __forceinline__ void quad(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void quad(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

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

// a K or V row's pitch in shared memory: its width and 16 bytes
template <typename T>
__host__ __device__ int pitch_of(int d) { return d + 16 / int(sizeof(T)); }

template <typename T>
int stages_for(int d) {
  const int stage = 2 * kTK * pitch_of<T>(d) * int(sizeof(T));
  const int n = kStageTarget / stage;
  return n < 2 ? 2 : (n > 4 ? 4 : n);
}

// barriers, then the ring (stage: K [kTK][pitch], V [kTK][pitch] of T),
// then float q [rep][d], acc [rep][d], scores [rep][kTK], m, l, corr
// [rep], the merge's weights [rep][kMaxSplits]
template <typename T>
size_t smem_bytes(int d, int rep, int stages) {
  return 64 + size_t(stages) * 2 * kTK * pitch_of<T>(d) * sizeof(T) +
         sizeof(float) * (size_t(2) * rep * d + size_t(rep) * kTK + 3 * rep +
                          size_t(rep) * kMaxSplits);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, int H, int rep, int d,
                        int lo, int length, int per, int stages,
                        float scale, int64_t q_sb, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_sh) {
  constexpr int E = 16 / sizeof(T);       // elements in a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = int(cluster.block_rank());
  const int splits = int(cluster.num_blocks());
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + 64);
  const int pitch = pitch_of<T>(d);
  const int stage_elems = 2 * kTK * pitch;
  float* qs = reinterpret_cast<float*>(ring + stages * stage_elems);
  float* acc = qs + rep * d;
  float* sc = acc + rep * d;
  float* ms = sc + rep * kTK;
  float* ls = ms + rep;
  float* cr = ls + rep;
  float* wts = cr + rep;

  const int ks = min(lo + split * per, length);     // this split's keys
  const int ke = min(ks + per, length);
  const int n_tiles = (ke - ks + kTK - 1) / kTK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const T* kp = k + b * k_sb + g * k_sh;
  const T* vp = v + b * v_sb + g * v_sh;
  // warp 0 brings tile t into its stage: one bulk copy per K and V row
  auto issue = [&](int t) {
    const int s = t % stages;
    const int k0 = ks + t * kTK;
    const int nk = min(kTK, ke - k0);
    T* kt = ring + s * stage_elems;
    T* vt = kt + kTK * pitch;
    hopper::fence_proxy_async();      // the stage's last readers are done
    if (lane == 0)
      hopper::mbar_expect_tx(&bars[s], uint32_t(2 * nk * d * sizeof(T)));
    __syncwarp();
    if (lane < nk) {
      const uint32_t bytes = uint32_t(d * sizeof(T));
      hopper::bulk_load(kt + lane * pitch, kp + (k0 + lane) * k_ss, bytes,
                        &bars[s]);
      hopper::bulk_load(vt + lane * pitch, vp + (k0 + lane) * v_ss, bytes,
                        &bars[s]);
    }
  };
  if (warp == 0)
    for (int t = 0; t < min(stages, n_tiles); ++t) issue(t);

  const T* qp = q + b * q_sb + int64_t(g) * rep * q_sh;
  for (int i = tid; i < rep * d; i += kThreads) {
    const int r = i / d, c = i % d;
    qs[i] = to_f(qp[r * q_sh + c]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }
  __syncthreads();

  const int nch = d / E;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % stages;
    const int k0 = ks + t * kTK;
    const int nk = min(kTK, ke - k0);
    const T* kt = ring + s * stage_elems;
    const T* vt = kt + kTK * pitch;
    hopper::mbar_wait(&bars[s], (t / stages) & 1);

    // scores: a thread per (head, key), four 16-byte chunks in flight
    for (int u = tid; u < rep * kTK; u += kThreads) {
      const int r = u / kTK, j = u % kTK;
      float x = -INFINITY;
      if (j < nk) {
        const T* krow = kt + j * pitch;
        const float4* qr = reinterpret_cast<const float4*>(qs + r * d);
        float dot = 0.f;
#pragma unroll 4
        for (int c = 0; c < nch; ++c) {
          float kv[E];
          chunk(krow + c * E, kv);
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = qr[(c * E + e) / 4];
            part += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
                    qv.w * kv[e + 3];
          }
          dot += part;
        }
        x = dot * scale;
      }
      sc[u] = x;
    }
    __syncthreads();

    // online softmax: a warp per head, a lane per key; the tile holds at
    // least one valid key, so m_new is finite
    for (int r = warp; r < rep; r += kWarps) {
      const float x = sc[r * kTK + lane];
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = expf(x - m_new);           // masked: exp(-inf) = 0
      const float psum = warp_sum(p);
      sc[r * kTK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // first tile: 0
        cr[r] = corr;
        ls[r] = ls[r] * corr + psum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V: a thread per (head, 4 columns), eight
    // keys' loads in flight
    const int quarter = d / 4;
    for (int u = tid; u < rep * quarter; u += kThreads) {
      const int r = u / quarter, c = 4 * (u % quarter);
      const float corr = cr[r];
      float4* ap = reinterpret_cast<float4*>(acc + r * d + c);
      float4 a = *ap;
      a.x *= corr; a.y *= corr; a.z *= corr; a.w *= corr;
      const float* pr = sc + r * kTK;
#pragma unroll 8
      for (int j = 0; j < nk; ++j) {
        float vv[4];
        quad(vt + j * pitch + c, vv);
        const float p = pr[j];
        a.x += p * vv[0];
        a.y += p * vv[1];
        a.z += p * vv[2];
        a.w += p * vv[3];
      }
      *ap = a;
    }
    __syncthreads();                  // the stage and the scores are free
    if (warp == 0 && t + stages < n_tiles) issue(t + stages);
  }

  // merge the cluster's splits in split order.  First each head's weights
  // e^(m_s - M) / sum_s l_s e^(m_s - M) from every block's m and l (an
  // empty split weighs 0), then block `split` takes every splits-th output
  // of the group
  cluster.sync();
  for (int r = tid; r < rep; r += kThreads) {
    float m_s[kMaxSplits];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      m_s[s] = s < splits ? *cluster.map_shared_rank(ms + r, s) : -INFINITY;
      mx = fmaxf(mx, m_s[s]);
    }
    float f[kMaxSplits];
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      f[s] = 0.f;
      if (m_s[s] != -INFINITY) {
        f[s] = expf(m_s[s] - mx);
        total += *cluster.map_shared_rank(ls + r, s) * f[s];
      }
    }
    const float inv = 1.f / fmaxf(total, 1e-30f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) wts[r * kMaxSplits + s] = f[s] * inv;
    if (lse != nullptr && split == 0)
      lse[int64_t(b) * H + int64_t(g) * rep + r] =
          mx == -INFINITY ? -INFINITY : mx + logf(total);
  }
  __syncthreads();
  for (int i = split * kThreads + tid; i < rep * d; i += splits * kThreads) {
    const int r = i / d, c = i % d;
    const float* w = wts + r * kMaxSplits;
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (w[s] != 0.f) o += *cluster.map_shared_rank(acc + i, s) * w[s];
    store(out + b * o_sb + (int64_t(g) * rep + r) * o_sh + c, o);
  }
  cluster.sync();                     // peers' shared memory stays until read
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int KV, int rep, int d, int lo, int length,
           int splits, int per, float scale, const int64_t* st,
           cudaStream_t stream) {
  // once per device: the dynamic shared-memory limit, raised to what the
  // widest head and group need, and clusters of up to 16 blocks
  static std::atomic<uint64_t> done{0};
  auto kernel = decode_attention_kernel<T>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(done.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_bytes<T>(256, kMaxRep, stages_for<T>(256))));
    // clusters of more than 8 blocks are allowed only on request
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return int(err);
    done.fetch_or(bit, std::memory_order_release);
  }
  const int stages = stages_for<T>(d);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>(d, rep, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, KV * rep, rep, d,
      lo, length, per, stages, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9]));
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (tile_matmul's codes).  Strides are in
// elements: q (b, h), k (b, s, kv head), v (b, s, kv head), out (b, h); the
// head dimension is contiguous in all four, and every K/V row starts on 16
// bytes (the wrapper checks).  [lo, length) is cut into `splits` ranges of
// `per` keys (decode_splits).  `lse` is null, or float32 (B, H)
// contiguous.  Returns a cudaError_t as int: 0 when the launch was
// accepted.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int B,
    int H, int KV, int S, int d, int length, int lo, int splits, int per,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxRep ||
      d <= 0 || d > 256 || d % 2 != 0 || length < 0 || length > S ||
      lo < 0 || lo > length || splits < 1 || splits > kMaxSplits ||
      per < 0 || int64_t(splits) * per < length - lo)
    return int(cudaErrorInvalidValue);
  const float scale = 1.f / sqrtf(float(d));
  const int64_t st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 1:
      err = launch<float>(q, k, v, out, static_cast<float*>(lse), B, KV,
                          H / KV, d, lo, length, splits, per, scale, st, s);
      break;
    case 2:
      err = launch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), B,
                                  KV, H / KV, d, lo, length, splits, per,
                                  scale, st, s);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}
