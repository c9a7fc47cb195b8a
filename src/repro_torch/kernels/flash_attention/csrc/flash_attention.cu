// Blocked causal / sliding-window GQA attention, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_fa_body`) in
// src/repro/kernels/flash_attention/kernel.py.  q (B, Hq, T, D); k, v
// (B, Hkv, S, D); out (B, Hq, T, D) in q's dtype (f32 or bf16), softmax
// in f32.  Query row t sits at key position t + S - T; causal keeps keys
// <= that position, a window keeps keys > position - window.
//
// Bound: at the prefill shape (granite-8b, T = S = 256, Hq 32, Hkv 8,
// D 128, bf16, causal) the function must move 5.2 MB (q, k, v, out once)
// and do 0.54 GFLOP (QK^T and PV over the causal half), so memory bounds
// it: about 1.6 us at 3.35 TB/s against 0.5 us of bf16 tensor-core
// work.  At longer T the FLOPs grow as T^2 and take over.
//
// Two kernels, chosen by dtype in flash_attention_launch:
//
// * bf16 (the serving path): `flash_fwd_wgmma_kernel`.  One CTA per
//   (64-row query tile, q head, batch) of 160 threads: warps 0-3 are one
//   consumer warpgroup, warp 4 the producer.  The producer brings the Q
//   tile once and the K and V tiles of 64 keys of the head's KV head into
//   a 2-stage ring by TMA (cp.async.bulk.tensor, 128-byte swizzle, 64
//   bf16 columns a box; 64-byte swizzle at D 32), each stage guarded by
//   a full and an empty mbarrier.  The consumer computes S = Q K^T with
//   wgmma m64n64k16 (both operands in shared memory, K-major), runs the
//   online softmax on the f32 accumulator in registers (a thread holds
//   pieces of two rows; a row's max and sum are shuffles over a quad),
//   rounds P to bf16 in registers and accumulates O += P V with wgmma
//   m64nDk16, P as the register A operand and V as an MN-major B from
//   shared memory.  Rounding P to bf16 is the one change against the
//   f32 arithmetic of the plain version.  The CTA walks only the KV
//   tiles of its rows' causal / window band; every element's key is
//   checked against its row's band, so keys >= S (zero-filled by TMA)
//   and keys outside the band count for nothing, and rows >= T are
//   never written.  Each output row is written once: no atomics, the
//   same result on every run.  Strided q / k / v / out (the views that
//   gqa_forward builds) are described by the tensor maps and the output
//   strides, without a copy.
// * f32: `flash_fwd_kernel`, CUDA cores, kept from the first port: one
//   block per (query tile, head, batch) with K and V staged in shared
//   memory as f32 and the softmax and accumulator in shared memory.
//   TF32 tensor cores would not hold the f32 tolerance.
//
// The tensor maps are encoded with cuTensorMapEncodeTiled, looked up at
// run time through cudaGetDriverEntryPoint, so the library links no
// libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 4096;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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


// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------
constexpr int kRows = 64;          // query rows and keys of a tile
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kWgThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct HTile {
  static constexpr int kSwizzle = D >= 64 ? 128 : 64;  // bytes of a row
  static constexpr int kBoxCols = kSwizzle / 2;        // bf16 per box row
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBoxBytes = kRows * kSwizzle;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // 64 x D bf16
  // wgmma descriptor layout code: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  // Q, the K ring, the V ring, 5 mbarriers, and slack to align to 1 KB
  static constexpr size_t kSmem = 5 * (size_t)kTileBytes + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One TMA box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (Q or a K tile, rows x D), k-step kk of 16 columns:
// 32 bytes into a swizzled row, the next box every kSwizzle bytes; 8-row
// groups lie 8 rows apart.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using H = HTile<D>;
  const uint32_t addr = tile + (kk * 32 / H::kSwizzle) * H::kBoxBytes +
                        (kk * 32) % H::kSwizzle;
  return smem_desc(addr, 16, 8 * H::kSwizzle, H::kLayout);
}

// MN-major operand (a V tile, keys x D read as 16 keys x D), k-step kk:
// 16 key rows further; the next box of columns (LBO) is a box further,
// the next 8 keys (SBO) 8 rows further.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using H = HTile<D>;
  return smem_desc(tile + kk * 16 * H::kSwizzle, H::kBoxBytes,
                   8 * H::kSwizzle, H::kLayout);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64, f32) += A (64 x 16, smem) * B (64 x 16, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// grid (ceil(T / 64), Hq, B), 160 threads.  q / k / v are read through
// the tensor maps (dims D, rows, heads, batch); out is written through
// its element strides (the last dim has stride 1).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, int hq,
                       int hkv, int Tq, int S, bool causal, int window,
                       float scale_log2, __nv_bfloat16* __restrict__ out,
                       long long so_b, long long so_h, long long so_t) {
  using H = HTile<D>;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + H::kTileBytes;       // 2 stages
  const uint32_t sv = sk + 2 * H::kTileBytes;   // 2 stages
  const uint32_t bar_q = sv + 2 * H::kTileBytes;
  const uint32_t bar_full = bar_q + 8;          // 2 barriers
  const uint32_t bar_empty = bar_full + 16;     // 2 barriers

  const int t_first = qt * kRows;
  const int nq = min(kRows, Tq - t_first);
  const int offset = S - Tq;
  int k_begin, k_end, unused;
  row_band(t_first + offset, S, causal, window, &k_begin, &unused);
  row_band(t_first + nq - 1 + offset, S, causal, window, &unused, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kRows - 1) / kRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // producer: one thread issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(bar_q, H::kTileBytes);
      for (int x = 0; x < H::kBoxes; ++x)
        tma_load_4d(sq + x * H::kBoxBytes, &map_q, x * H::kBoxCols, t_first,
                    h, b, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(bar_empty + 8 * s, ((i >> 1) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * H::kTileBytes);
        const int t0 = k_begin + i * kRows;
        for (int x = 0; x < H::kBoxes; ++x) {
          tma_load_4d(sk + s * H::kTileBytes + x * H::kBoxBytes, &map_k,
                      x * H::kBoxCols, t0, hk, b, full);
          tma_load_4d(sv + s * H::kTileBytes + x * H::kBoxBytes, &map_v,
                      x * H::kBoxCols, t0, hk, b, full);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r0 and r0 + 8 of the tile
  const int r0 = 16 * warp + lane / 4;
  int lo[2], hi[2];
  for (int hh = 0; hh < 2; ++hh)
    row_band(t_first + r0 + 8 * hh + offset, S, causal, window, &lo[hh],
             &hi[hh]);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1;
    mbar_wait(bar_full + 8 * s, (i >> 1) & 1);
    const uint32_t k_tile = sk + s * H::kTileBytes;
    const uint32_t v_tile = sv + s * H::kTileBytes;

    // S = Q K^T (64 x 64, f32)
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<D>(sq, kk), kmajor_desc<D>(k_tile, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask to each row's band, online softmax in f32 (base 2)
    const int t0 = k_begin + i * kRows;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hh = (j >> 1) & 1;
      const int key = t0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      sc[j] = (key >= lo[hh] && key < hi[hh]) ? sc[j] * scale_log2 : -INFINITY;
      mx[hh] = fmaxf(mx[hh], sc[j]);
    }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = exp2f(m[hh] - m_use[hh]);
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = exp2f(sc[j] - m_use[(j >> 1) & 1]);
      sum[(j >> 1) & 1] += sc[j];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l[hh] = l[hh] * alpha[hh] + sum[hh];
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    // P in bf16 as the A operand: the accumulator layout of 16 columns is
    // the A fragment layout of one k-step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P V
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, pa[kk], mnmajor_desc<D>(v_tile, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * s);
  }

  // each row written once, as bf16
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t_first + r0 + 8 * hh;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow = out + b * so_b + h * so_h + t * so_t;
#pragma unroll
    for (int c8 = 0; c8 < D / 8; ++c8) {
      const int j = 4 * c8 + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c8 + 2 * (lane & 3)) =
          __floats2bfloat162_rn(o[j] / denom, o[j + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Error codes of this file beyond CUDA's own.
constexpr int kErrNoEncoder = 9001;   // no cuTensorMapEncodeTiled entry point
constexpr int kErrEncode = 9002;      // the tensor map was refused

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a bf16 (B, H, rows, D) view with element strides
// (s_b, s_h, s_row) and a unit last stride; boxes of 64 rows x kBoxCols.
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int B, int heads, int rows,
               const long long* strides) {
  using H = HTile<D>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)H::kBoxCols, (cuuint32_t)kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      H::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrEncode;
}

// Sets a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kern, size_t smem, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// strides: element strides (batch, head, row) of q, k, v and out.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const long long* strides, int B, int hq, int hkv, int Tq,
                int S, bool causal, int window, float scale, void* out,
                cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = allow_smem_once(kern, HTile<D>::kSmem, &configured);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  int rc = encode_map<D>(&mq, q, B, hq, Tq, strides);
  if (rc == 0) rc = encode_map<D>(&mk, k, B, hkv, S, strides + 3);
  if (rc == 0) rc = encode_map<D>(&mv, v, B, hkv, S, strides + 6);
  if (rc != 0) return rc;
  const int n_qt = (Tq + kRows - 1) / kRows;
  kern<<<dim3(n_qt, hq, B), kWgThreads, HTile<D>::kSmem, stream>>>(
      mq, mk, mv, hq, hkv, Tq, S, causal, window, scale * kLog2e,
      static_cast<__nv_bfloat16*>(out), strides[9], strides[10], strides[11]);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, int B, int hq,
               int hkv, int Tq, int S, bool causal, int window, float scale,
               void* out, cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kern = flash_fwd_kernel<D, float>;
  const size_t smem = Tile<D>::smem_floats * sizeof(float);
  cudaError_t err = allow_smem_once(kern, smem, &configured);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Tq + Tile<D>::BQ - 1) / Tile<D>::BQ;
  kern<<<dim3(n_qt, hq, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), hq, hkv, Tq, S, causal, window, scale,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The f32 kernel reads and writes contiguous tensors.
bool contiguous(const long long* s, int heads, int rows, int D) {
  return s[2] == D && s[1] == (long long)rows * D &&
         s[0] == (long long)heads * rows * D;
}

}  // namespace

extern "C" {

// dtype: 0 = f32 (CUDA cores; contiguous q, k, v, out), 1 = bf16 (TMA +
// wgmma).  strides: 12 element strides, (batch, head, row) of q, k, v,
// out in turn; every last dim has stride 1.  causal: 0 / 1.  window < 0:
// none.  Returns 0, a CUDA error, or 9001 / 9002 when a tensor map could
// not be made.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const long long* strides, int B, int hq, int hkv,
                           int Tq, int S, int D, int dtype, int causal,
                           int window, float scale, void* out, void* stream) {
  if (B < 1 || hkv < 1 || hq % hkv != 0 || Tq < 1 || S < 1 || Tq > S ||
      B > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == 0) {
    if (!contiguous(strides, hq, Tq, D) || !contiguous(strides + 3, hkv, S, D) ||
        !contiguous(strides + 6, hkv, S, D) || !contiguous(strides + 9, hq, Tq, D))
      return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, B, hq, hkv, Tq, S, c, window, scale, out, st);
      case 64: return launch_f32<64>(q, k, v, B, hq, hkv, Tq, S, c, window, scale, out, st);
      case 128: return launch_f32<128>(q, k, v, B, hq, hkv, Tq, S, c, window, scale, out, st);
      case 256: return launch_f32<256>(q, k, v, B, hq, hkv, Tq, S, c, window, scale, out, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(q, k, v, strides, B, hq, hkv, Tq, S, c, window, scale, out, st);
      case 64: return launch_bf16<64>(q, k, v, strides, B, hq, hkv, Tq, S, c, window, scale, out, st);
      case 128: return launch_bf16<128>(q, k, v, strides, B, hq, hkv, Tq, S, c, window, scale, out, st);
      case 256: return launch_bf16<256>(q, k, v, strides, B, hq, hkv, Tq, S, c, window, scale, out, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
