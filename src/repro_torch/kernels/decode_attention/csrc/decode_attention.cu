// Flash-decode for Hopper (sm_90a): one new token of GQA attention over
// a padded KV cache, in one launch.
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
// bf16 at group 4, far below the card's ~295 FLOP/byte, so tensor cores
// cannot help.  At the serving path's shape (granite-8b: Hkv 8, D 128,
// bf16, live <= 1024) that is at most 4.2 MB, about 1.3 us at 3.35 TB/s;
// what counts is the bytes in flight and the launches.
//
// Design.  The TPU kernel walks the cache blocks of one (b, kv head) in
// order, carrying (m, l, acc) in VMEM.  Here one thread-block cluster of
// `n_split` CTAs (the plan, from the cache's shape and the SM count,
// never from the batch) shares the live keys of one (batch row, kv head,
// chunk of query rows); CTA r of the cluster takes the r-th contiguous
// share of the row's live range.  A CTA's 8 warps stream their keys with
// 16-byte vector loads: a K or V row spreads over D x elem / 16 lanes (up
// to 32; beyond that a lane takes two vectors), a warp covers
// 32 / lanes rows at a time, and each lane loads two rows of K and V (one
// where it takes two vectors a row) before it uses them: more rows in
// flight a lane cost registers, so fewer CTAs fit an SM, and measured no
// faster at batch 1.  The query rows of the kv head (all of
// them, up to 4 in bf16 / 8 in f32 at D <= 128; more are split into
// chunks of that size, each its own cluster) sit in registers, so each
// K/V byte is read once per chunk.  A lane's partial dot products are
// summed over the row's lanes by shuffles, and the online softmax runs in
// registers.  Then the partial (m, l, acc) states merge: across the row
// groups of a warp by shuffles, across warps in warp order through
// shared memory, and across the cluster's CTAs after cluster.sync(): CTA r
// combines its share of the output elements by reading every CTA's
// (m, l, acc) over distributed shared memory in rank order, and writes
// them.  No global scratch, no float atomics: the same result on every
// run, and a row's result does not depend on the batch it is served in.
// CTAs whose share is empty contribute an empty partial and still reach
// both cluster barriers.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// A 16-byte vector as f32 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

template <int D, typename T, int QG>
struct Plan {
  static constexpr int kVec = Vec<T>::kN;                  // elements a load
  static constexpr int kChunks = D / kVec;                 // loads a row
  static constexpr int kLanes = kChunks < 32 ? kChunks : 32;  // lanes a row
  static constexpr int kVpl = kChunks / kLanes;            // loads a lane
  static constexpr int kRowsPerWarp = 32 / kLanes;
  static constexpr int kElems = kVpl * kVec;               // a lane's part of a row
  static constexpr int kUnroll = 2 / kVpl;                 // rows a lane holds
  static constexpr int kStep = kWarps * kRowsPerWarp;      // rows a sub-step
  static constexpr int kIter = kStep * kUnroll;            // rows an iteration
};

// (m, l, acc) += (m2, l2, acc2), the online-softmax merge in base 2.
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m2, float l2, const float* acc2) {
  const float mn = fmaxf(m, m2);
  const float mu = mn == -INFINITY ? 0.f : mn;
  const float w1 = exp2f(m - mu), w2 = exp2f(m2 - mu);
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * w1 + acc2[e] * w2;
  m = mn;
}

// grid (n_split, Hkv x n_qc, B), clusters of n_split along x; each CTA
// holds query rows g0 .. g0 + QG - 1 of its kv head (chunk y % n_qc).
template <int D, typename T, int QG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, int hq, int hkv,
                        int n_qc, int S, int window, float scale_log2,
                        T* __restrict__ out) {
  using P = Plan<D, T, QG>;
  using V = Vec<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x;
  const int h = blockIdx.y / n_qc, b = blockIdx.z;
  const int G = hq / hkv;
  const int g0 = (blockIdx.y % n_qc) * QG;
  const int nq = min(QG, G - g0);

  __shared__ float s_acc[kWarps][QG * D];
  __shared__ float s_m[kWarps][QG], s_l[kWarps][QG];
  __shared__ float c_acc[QG * D], c_m[QG], c_l[QG];

  // this CTA's share of the row's live keys
  const int len = min(kv_len[b], S);
  const int lo = window >= 0 ? max(0, len - window) : 0;
  const int per = (max(len - lo, 0) + n_split - 1) / n_split;
  const int k_begin = lo + split * per;
  const int k_end = min(len, k_begin + per);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / P::kLanes;        // row group within the warp
  const int c = lane % P::kLanes;         // 16-byte column of the row

  const T* qb = q + ((size_t)b * hq + (size_t)h * G + g0) * D;
  float qf[QG][P::kElems];
#pragma unroll
  for (int g = 0; g < QG; ++g)
#pragma unroll
    for (int u = 0; u < P::kVpl; ++u) {
      if (g < nq) {
        V::unpack(load16(qb + (size_t)g * D + (c + u * P::kLanes) * P::kVec),
                  &qf[g][u * P::kVec]);
      } else {
#pragma unroll
        for (int e = 0; e < P::kVec; ++e) qf[g][u * P::kVec + e] = 0.f;
      }
    }
  float m[QG], l[QG], acc[QG][P::kElems];
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < P::kElems; ++e) acc[g][e] = 0.f;
  }

  const size_t kv0 = ((size_t)b * hkv + h) * (size_t)S * D;
  const T* kb = k + kv0;
  const T* vb = v + kv0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int j0 = k_begin; j0 < k_end; j0 += P::kIter) {
    // sub-steps holding a live key: the same for the whole CTA
    const int n_sub = min(P::kUnroll, (k_end - j0 + P::kStep - 1) / P::kStep);
    uint4 kr[P::kUnroll][P::kVpl], vr[P::kUnroll][P::kVpl];
    bool ok[P::kUnroll];
#pragma unroll
    for (int r = 0; r < P::kUnroll; ++r) {
      const int j = j0 + r * P::kStep + warp * P::kRowsPerWarp + rg;
      ok[r] = j < k_end;
#pragma unroll
      for (int u = 0; u < P::kVpl; ++u) {
        const size_t off = (size_t)j * D + (c + u * P::kLanes) * P::kVec;
        kr[r][u] = ok[r] ? load16(kb + off) : zero;
        vr[r][u] = ok[r] ? load16(vb + off) : zero;
      }
    }
    // scores: a lane's partial dots, summed over the row's lanes
    float sc[P::kUnroll][QG];
#pragma unroll
    for (int r = 0; r < P::kUnroll; ++r) {
      if (r >= n_sub) break;
      float kf[P::kElems];
#pragma unroll
      for (int u = 0; u < P::kVpl; ++u) V::unpack(kr[r][u], &kf[u * P::kVec]);
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < P::kElems; ++e) dot += qf[g][e] * kf[e];
#pragma unroll
        for (int o = P::kLanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[r][g] = ok[r] ? dot * scale_log2 : -INFINITY;
      }
    }
    // online softmax over the iteration's rows
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < P::kUnroll; ++r)
        if (r < n_sub) mx = fmaxf(mx, sc[r][g]);
      const float m_new = fmaxf(m[g], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[g] - mu);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < P::kElems; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int r = 0; r < P::kUnroll; ++r) {
        if (r >= n_sub) break;
        sc[r][g] = exp2f(sc[r][g] - mu);
        l[g] += sc[r][g];
      }
    }
#pragma unroll
    for (int r = 0; r < P::kUnroll; ++r) {
      if (r >= n_sub) break;
      float vf[P::kElems];
#pragma unroll
      for (int u = 0; u < P::kVpl; ++u) V::unpack(vr[r][u], &vf[u * P::kVec]);
#pragma unroll
      for (int g = 0; g < QG; ++g)
#pragma unroll
        for (int e = 0; e < P::kElems; ++e) acc[g][e] += sc[r][g] * vf[e];
    }
  }

  // merge the row groups of the warp (lanes kLanes, 2 kLanes, ... apart)
#pragma unroll
  for (int o = P::kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      float acc2[P::kElems];
#pragma unroll
      for (int e = 0; e < P::kElems; ++e)
        acc2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      merge<P::kElems>(m[g], l[g], acc[g], m2, l2, acc2);
    }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < QG; ++g) {
#pragma unroll
      for (int u = 0; u < P::kVpl; ++u)
#pragma unroll
        for (int e = 0; e < P::kVec; ++e)
          s_acc[warp][g * D + (c + u * P::kLanes) * P::kVec + e] =
              acc[g][u * P::kVec + e];
      if (c == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  // merge the warps in warp order: this CTA's partial
  for (int e = threadIdx.x; e < QG * D; e += kThreads) {
    const int g = e / D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][g]);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(s_m[w][g] - mu);
      ll += s_l[w][g] * wt;
      a += s_acc[w][e] * wt;
    }
    c_acc[e] = a;
    if (e % D == 0) {
      c_m[g] = mm;
      c_l[g] = ll;
    }
  }
  cluster.sync();
  // merge the cluster's CTAs in rank order; CTA `split` writes its share
  T* ob = out + ((size_t)b * hq + (size_t)h * G + g0) * D;
  for (int e = split * kThreads + threadIdx.x; e < nq * D;
       e += n_split * kThreads) {
    const int g = e / D;
    float rm[kMaxCluster], rl[kMaxCluster], ra[kMaxCluster];
    float mm = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_split) {
        rm[r] = *cluster.map_shared_rank(&c_m[g], r);
        rl[r] = *cluster.map_shared_rank(&c_l[g], r);
        ra[r] = *cluster.map_shared_rank(&c_acc[e], r);
        mm = fmaxf(mm, rm[r]);
      }
    }
    const float mu = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < n_split) {
        const float wt = exp2f(rm[r] - mu);
        ll += rl[r] * wt;
        a += ra[r] * wt;
      }
    }
    ob[e] = V::store(a / fmaxf(ll, 1e-30f));
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

// Query rows a CTA holds in registers: the group rounded up to a power
// of two, at most 32 f32 values of q per lane.
template <int D, typename T>
constexpr int max_rows() {
  return 32 / Plan<D, T, 1>::kElems;
}

template <int D, typename T, int QG>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           int B, int hq, int hkv, int S, int window, float scale,
           int n_split, void* out, cudaStream_t stream) {
  const int n_qc = (hq / hkv + QG - 1) / QG;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, hkv * n_qc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<D, T, QG>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), hq, hkv,
      n_qc, S, window, scale * kLog2e, static_cast<T*>(out));
}

template <int D, typename T>
int dispatch_rows(const void* q, const void* k, const void* v,
                  const void* kv_len, int B, int hq, int hkv, int S,
                  int window, float scale, int n_split, void* out,
                  cudaStream_t stream) {
  const int group = hq / hkv;
  constexpr int cap = max_rows<D, T>();
  const int rows = group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
  switch (rows < cap ? rows : cap) {
    case 1: return launch<D, T, 1>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    case 2: return launch<D, T, 2>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    case 4: return launch<D, T, 4>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    default:
      if constexpr (cap >= 8)
        return launch<D, T, 8>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* kv_len, int B, int hq, int hkv, int S, int window,
               float scale, int n_split, void* out, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_rows<32, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    case 64: return dispatch_rows<64, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    case 128: return dispatch_rows<128, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    case 256: return dispatch_rows<256, T>(q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  window < 0: none.  n_split: CTAs of a
// cluster, 1 .. 8.  q, k, v, out contiguous and 16-byte aligned.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, int B, int hq, int hkv, int S,
                            int D, int dtype, int window, float scale,
                            int n_split, void* out, void* stream) {
  if (B < 1 || B > 65535 || hkv < 1 || hq % hkv != 0 || S < 1 ||
      n_split < 1 || n_split > kMaxCluster || hkv * hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_len, B, hq, hkv, S, window, scale, n_split, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
