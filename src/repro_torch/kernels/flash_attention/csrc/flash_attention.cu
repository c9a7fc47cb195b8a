// Blocked causal / sliding-window GQA attention, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_fa_body`) in
// src/repro/kernels/flash_attention/kernel.py.  q (B, Hq, T, D); k, v
// (B, Hkv, S, D); out (B, Hq, T, D) in q's dtype (f32 or bf16), all
// math in f32.  Query row t sits at key position t + S - T; causal keeps
// keys <= that position, a window keeps keys > position - window.
//
// Bound: at the prefill shape (granite-8b, T = S = 256, Hq 32, Hkv 8,
// D 128, bf16, causal) the function must move 5.2 MB (q, k, v, out once)
// and do 0.54 GFLOP (QK^T and PV over the causal half), so memory bounds
// it: about 1.6 us at 3.35 TB/s against 0.5 us of bf16 tensor-core
// work.  At longer T the FLOPs grow as T^2 and take over.
//
// Design.  The TPU kernel's grid walks kv blocks in order per q tile,
// carrying (m, l, acc) in VMEM.  Here one CUDA block owns BQ query rows
// of one head (grid (T / BQ, Hq, B)) and loops over the kv tiles inside
// the causal / window band of its rows, so fully masked tiles are never
// read.  K and V tiles of 4096 / D keys are staged in shared memory as
// f32; scores, the online softmax and the accumulator stay in shared
// memory, all in f32, as the TPU body's astype(f32).  Each output row is
// written once by its block: no atomics, the same result on every run.
// CUDA cores only; wgmma / TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 4096;
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

template <int D>
struct Tile {
  static constexpr int TK = kTileElems / D;                       // keys
  static constexpr int BQ = kTileElems / D < 64 ? kTileElems / D : 64;  // rows
  static constexpr size_t smem_floats =
      (size_t)BQ * D + (size_t)TK * (D + 1) + (size_t)TK * D +
      (size_t)BQ * TK + (size_t)BQ * D + 3 * (size_t)BQ;
};

// Key range [lo, hi) of the query row at key position `pos`.
__device__ __forceinline__ void row_band(int pos, int S, bool causal,
                                         int window, int* lo, int* hi) {
  *hi = causal ? min(pos + 1, S) : S;
  *lo = window >= 0 ? max(0, pos - window + 1) : 0;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, int hq, int hkv, int Tq, int S,
                 bool causal, int window, float scale, T* __restrict__ out) {
  constexpr int TK = Tile<D>::TK, BQ = Tile<D>::BQ;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * D;
  float* sv = sk + TK * (D + 1);
  float* ss = sv + TK * D;
  float* sacc = ss + BQ * TK;
  float* sm = sacc + BQ * D;
  float* sl = sm + BQ;
  float* salpha = sl + BQ;

  const int t_first = qt * BQ;
  const int nq = min(BQ, Tq - t_first);
  const int offset = S - Tq;
  int k_begin, k_end, unused;
  row_band(t_first + offset, S, causal, window, &k_begin, &unused);
  row_band(t_first + nq - 1 + offset, S, causal, window, &unused, &k_end);

  const T* qb = q + (((size_t)b * hq + h) * Tq + t_first) * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    sq[i] = i < nq * D ? to_f32(qb[i]) : 0.f;
    sacc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  __syncthreads();

  const size_t kv0 = ((size_t)b * hkv + hk) * (size_t)S * D;
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
    for (int i = threadIdx.x; i < BQ * TK; i += kThreads) {
      const int r = i / TK, j = i % TK;
      float dot = 0.f;
      if (r < nq && j < nk) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += sq[r * D + d] * sk[j * (D + 1) + d];
      }
      ss[i] = dot * scale;
    }
    __syncthreads();
    // online softmax, one warp per query row; keys outside the row's band
    // get probability 0 whatever the running max is
    for (int r = warp; r < nq; r += kWarps) {
      int lo, hi;
      row_band(t_first + r + offset, S, causal, window, &lo, &hi);
      const int j_lo = max(lo - t0, 0), j_hi = min(hi - t0, nk);
      float mx = kNegInf;
      for (int j = j_lo + lane; j < j_hi; j += 32) mx = fmaxf(mx, ss[r * TK + j]);
      mx = warp_max(mx);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = (j >= j_lo && j < j_hi) ? expf(ss[r * TK + j] - m_new) : 0.f;
        ss[r * TK + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nq * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float a = sacc[i] * salpha[r];
      for (int j = 0; j < nk; ++j) a += ss[r * TK + j] * sv[j * D + d];
      sacc[i] = a;
    }
    __syncthreads();
  }
  T* ob = out + (((size_t)b * hq + h) * Tq + t_first) * D;
  for (int i = threadIdx.x; i < nq * D; i += kThreads)
    ob[i] = from_f32<T>(sacc[i] / fmaxf(sl[i / D], 1e-30f));
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, int B, int hq,
           int hkv, int Tq, int S, bool causal, int window, float scale,
           void* out, cudaStream_t stream) {
  const size_t smem = Tile<D>::smem_floats * sizeof(float);
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq + Tile<D>::BQ - 1) / Tile<D>::BQ;
  kern<<<dim3(n_qt, hq, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), hq, hkv, Tq, S, causal, window, scale,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, int B,
               int hq, int hkv, int Tq, int S, bool causal, int window,
               float scale, void* out, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, B, hq, hkv, Tq, S, causal, window, scale, out, stream);
    case 64: return launch<64, T>(q, k, v, B, hq, hkv, Tq, S, causal, window, scale, out, stream);
    case 128: return launch<128, T>(q, k, v, B, hq, hkv, Tq, S, causal, window, scale, out, stream);
    case 256: return launch<256, T>(q, k, v, B, hq, hkv, Tq, S, causal, window, scale, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  causal: 0 / 1.  window < 0: none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           int B, int hq, int hkv, int Tq, int S, int D,
                           int dtype, int causal, int window, float scale,
                           void* out, void* stream) {
  if (B < 1 || hkv < 1 || hq % hkv != 0 || Tq < 1 || S < 1 || Tq > S ||
      B > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, B, hq, hkv, Tq, S, causal != 0, window, scale, out, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, B, hq, hkv, Tq, S, causal != 0, window, scale, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
