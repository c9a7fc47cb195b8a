// Flash-decode for Hopper (sm_90a): one new token of GQA attention over
// a padded KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention` (`_decode_body`) in
// src/repro/kernels/decode_attention/kernel.py.  q (B, Hq, D); k, v
// (B, Hkv, S, D); kv_len int32 (B,); out (B, Hq, D) in q's dtype (f32 or
// bf16), all math in f32.  Keys in [max(0, kv_len - window), kv_len)
// are live (window < 0: no window).
//
// Bound: memory.  A call must read the live K and V rows once
// (2 x Hkv x live x D elements per batch row) plus q, and write out;
// the arithmetic is 4 x Hq x live x D FLOPs, about 2 per byte read in
// bf16, far below the card's ratio.  At the serving path's shape
// (granite-8b: Hkv 8, D 128, bf16, live <= 1024) that is at most
// 4.2 MB, about 1.3 us at 3.35 TB/s; launch latency dominates.
//
// Design.  The TPU kernel walks the cache blocks of one (b, kv head) in
// order, carrying (m, l, acc) in VMEM.  Here the cache is split into
// `n_split` contiguous chunks so that B x Hkv x n_split blocks fill the
// SMs even at batch 1 (B x Hkv = 8 on the serving path).  Each block
// holds all `group` query rows of its kv head (so each K/V byte is read
// once for the group, as on the TPU), streams its chunk's live keys
// through shared memory in tiles of 4096 / D keys, runs the online
// softmax in f32 and writes its partial (m, l, acc).  A second kernel
// combines the partials of each query row in split order.  No float
// atomics: the result is the same on every run.  Chunks past kv_len or
// before the window exit after writing an empty partial.  CUDA cores
// only; wgmma / TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 4096;  // keys per tile x D
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory floats one split block needs for `group` query rows.
template <int D>
size_t split_smem_floats(int group) {
  constexpr int TK = kTileElems / D;
  return (size_t)group * D          // q rows
         + (size_t)TK * (D + 1)     // K tile (padded rows: no bank conflicts)
         + (size_t)TK * D           // V tile
         + (size_t)group * TK       // scores, then probabilities
         + (size_t)group * D        // acc
         + 3 * (size_t)group;       // m, l, alpha
}

// grid (n_split, Hkv, B); partials indexed [(b * Hq + row) * n_split + split].
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    int hq, int hkv, int S, int window, float scale,
                    int keys_per_split, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int TK = kTileElems / D;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = hq / hkv;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + G * D;
  float* sv = sk + TK * (D + 1);
  float* ss = sv + TK * D;
  float* sacc = ss + G * TK;
  float* sm = sacc + G * D;
  float* sl = sm + G;
  float* salpha = sl + G;

  const int len = min(kv_len[b], S);
  const int lo = window >= 0 ? max(0, len - window) : 0;
  const int k_begin = max(lo, split * keys_per_split);
  const int k_end = min(len, (split + 1) * keys_per_split);
  const size_t row0 = (size_t)b * hq + (size_t)h * G;

  const T* qb = q + row0 * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    sq[i] = to_f32(qb[i]);
    sacc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }
  __syncthreads();

  const size_t kv0 = ((size_t)b * hkv + h) * (size_t)S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t0 = k_begin; t0 < k_end; t0 += TK) {
    const int nk = min(TK, k_end - t0);
    for (int i = threadIdx.x; i < nk * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const size_t off = kv0 + (size_t)(t0 + j) * D + d;
      sk[j * (D + 1) + d] = to_f32(k[off]);
      sv[j * D + d] = to_f32(v[off]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * TK; i += kThreads) {
      const int g = i / TK, j = i % TK;
      float dot = 0.f;
      if (j < nk) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += sq[g * D + d] * sk[j * (D + 1) + d];
      }
      ss[i] = dot * scale;
    }
    __syncthreads();
    // online softmax, one warp per query row; every key of the tile is live
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, ss[g * TK + j]);
      mx = warp_max(mx);
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(ss[g * TK + j] - m_new);
        ss[g * TK + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float a = sacc[i] * salpha[g];
      for (int j = 0; j < nk; ++j) a += ss[g * TK + j] * sv[j * D + d];
      sacc[i] = a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    part_acc[((row0 + g) * n_split + split) * D + d] = sacc[i];
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part_m[(row0 + g) * n_split + split] = sm[g];
    part_l[(row0 + g) * n_split + split] = sl[g];
  }
}

// grid (B * Hq), D threads: combine the splits of one query row in order.
template <int D, typename T>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, int n_split,
                      T* __restrict__ out) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_m[row * n_split + s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(part_m[row * n_split + s] - m);
    l += part_l[row * n_split + s] * w;
    a += part_acc[(row * n_split + s) * D + d] * w;
  }
  out[row * D + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           int B, int hq, int hkv, int S, int window, float scale,
           int n_split, int keys_per_split, void* part_m, void* part_l,
           void* part_acc, void* out, cudaStream_t stream) {
  const size_t smem = split_smem_floats<D>(hq / hkv) * sizeof(float);
  auto split = decode_split_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(n_split, hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), hq, hkv, S,
      window, scale, keys_per_split, static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<D, T><<<B * hq, D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), n_split, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* kv_len, int B, int hq, int hkv, int S, int window,
               float scale, int n_split, int keys_per_split, void* part_m,
               void* part_l, void* part_acc, void* out, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, keys_per_split, part_m, part_l, part_acc, out, stream);
    case 64: return launch<64, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, keys_per_split, part_m, part_l, part_acc, out, stream);
    case 128: return launch<128, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, keys_per_split, part_m, part_l, part_acc, out, stream);
    case 256: return launch<256, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, keys_per_split, part_m, part_l, part_acc, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  window < 0: none.  Scratch part_m / part_l
// (B * Hq * n_split) and part_acc (B * Hq * n_split * D) are f32.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, int B, int hq, int hkv, int S,
                            int D, int dtype, int window, float scale,
                            int n_split, int keys_per_split, void* part_m,
                            void* part_l, void* part_acc, void* out,
                            void* stream) {
  if (B < 1 || hkv < 1 || hq % hkv != 0 || S < 1 || n_split < 1 ||
      keys_per_split < 1 || (long long)n_split * keys_per_split < S ||
      (long long)(hq / hkv) * D > 2 * kTileElems)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, keys_per_split, part_m, part_l, part_acc, out, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, keys_per_split, part_m, part_l, part_acc, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
