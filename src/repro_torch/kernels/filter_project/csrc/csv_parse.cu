// Fixed-width CSV field decode for Hopper (sm_90a): every numeric field
// of a scan in one pass over the raw row matrix.
//
// Replaces the Pallas TPU kernel `parse_i32` in src/repro/kernels/
// filter_project/kernel.py ((N, 10) zero-padded ASCII digits -> int32),
// and its 8-digit fractional variant `parse_f32` ((N, 8) digits -> f32
// in [0, 1)), which the JAX package leaves to XLA in its physical scan.
// Both are what a CSV scan pays for every numeric column it reads: the
// cost the covering-expression cache exists to avoid.
//
// Bound: memory.  A field lies inside a wider row (90 bytes for
// store_sales), so what the card moves is the sectors that hold field
// bytes, not the field bytes alone: for one 10-byte field of
// store_sales at SF1 capacity (2^22 rows) about 168 MB of 32-byte
// sectors + 16.8 MB out (about 55 us at an H100 SXM's 3.35 TB/s), for
// all ten numeric fields the whole 377.5 MB + 168 MB out (about 163 us).
// The arithmetic (a dozen integer or f32 operations a field) is far
// below the card's rate.
//
// Design.  One launch decodes a list of fields (width 10 -> int32 or
// width 8 -> f32) of one row matrix, so a scan that reads k numeric
// fields reads the rows once, not k times.  Two modes, one kernel:
//  * staged (two or more fields).  The row layout repeats on 16-byte
//    word boundaries every P = 16 / gcd(stride, 16) rows; the host's plan
//    lists the words of such a period that hold a field byte, and where
//    in them each (row of the period, field) starts.  A block takes a
//    run of whole periods (about 24 KB of planned words) and copies its
//    planned words, packed, into shared memory by 16-byte cp.async
//    (coalesced; a word no field touches is never fetched, so neither
//    are untouched sectors).  Threads then decode from shared memory,
//    one (row, field) at a time, each field's bytes from four aligned
//    32-bit loads, and write each output coalesced.
//  * direct (one field).  A thread a row, the field's bytes loaded where
//    they lie.  With one field there is nothing to share between the
//    loads, and the staging costs its barrier.
// Semantics are the plain torch versions' bit for bit, padding rows past
// the live count included (their zero bytes decode as digit -48):
//  * int32 fields accumulate in uint32, so the 10-digit values past 2^31
//    (and the padding rows) wrap modulo 2^32 exactly as the plain
//    version's integer sum does, with no signed overflow;
//  * f32 fields add the digit products in the plain version's order,
//    most significant first, each rounded on its own (__fadd_rn /
//    __fmul_rn forbid contraction; every product d * 10^k is exact in
//    f32 anyway), then scale once by f32(1e-8).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 32;
constexpr int kRunBytes = 24 * 1024;  // a block's run of packed words
constexpr int kMaxRunRows = 1024;

struct Params {
  const unsigned char* base;  // 16-byte aligned; row r at base + r * stride
  long long stride, n;
  const unsigned char* lo;    // [lo, hi): the bytes the kernel may read
  const unsigned char* hi;
  // plan: words[n_words] (period-relative word offsets, ascending), then
  // at[period_rows * n_fields] (packed byte offset of row j's field f)
  const int* plan;
  int n_words, period_rows, log_period_rows;
  long long period_words;     // the base advances this many words a period
  int run_periods;            // periods a block's run
  int n_fields;
  int off[kMaxFields];        // byte offset from the row's start
  int width[kMaxFields];      // 10: int32, 8: f32
  void* out[kMaxFields];
  int direct;                 // direct mode: no staging, a thread a row
};

// float32(1e-8), the plain version's scale
constexpr float kScale = 0x1.5798eep-27f;

// A field's bytes from the packed words in shared memory: four aligned
// 32-bit loads at `at` (a byte offset into `buf`, 16-byte aligned), which
// may read up to 6 bytes past the field; byte k of the field is
// shared_byte(x, k).
__device__ __forceinline__ void window_shared(const unsigned char* buf,
                                              int at, unsigned (&x)[3]) {
  const unsigned* w = reinterpret_cast<const unsigned*>(buf + (at & ~3));
  const unsigned s = (unsigned)(at & 3) * 8;
  const unsigned w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  x[0] = __funnelshift_r(w0, w1, s);
  x[1] = __funnelshift_r(w1, w2, s);
  x[2] = __funnelshift_r(w2, w3, s);
}

__device__ __forceinline__ unsigned shared_byte(const unsigned (&x)[3],
                                                int k) {
  return (x[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

// sum((byte(k) - 48) * 10^(9-k)) mod 2^32, as sum(byte(k) * 10^(9-k)) -
// 48 * 1111111111 (the same ring arithmetic)
template <typename Byte>
__device__ __forceinline__ int32_t decode_i32(Byte byte) {
  constexpr uint32_t kPow[10] = {1000000000u, 100000000u, 10000000u,
                                 1000000u,    100000u,    10000u,
                                 1000u,       100u,       10u,
                                 1u};
  uint32_t acc = 0u - 48u * 1111111111u;
#pragma unroll
  for (int k = 0; k < 10; ++k) acc += byte(k) * kPow[k];
  return (int32_t)acc;
}

template <typename Byte>
__device__ __forceinline__ float decode_f32(Byte byte) {
  constexpr float kPow[8] = {1e7f, 1e6f, 1e5f, 1e4f, 1e3f, 1e2f, 1e1f, 1.0f};
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    acc = __fadd_rn(acc, __fmul_rn((float)((int)byte(k) - 48), kPow[k]));
  return __fmul_rn(acc, kScale);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Issues the copies of run `run`'s planned words into `buf`.
__device__ __forceinline__ void stage(const Params& p, const int* words,
                                      unsigned char* buf, long long run) {
  const long long r0 = run * p.run_periods * p.period_rows;
  const long long rows = min((long long)p.run_periods * p.period_rows,
                             p.n - r0);
  const int periods = (int)((rows + p.period_rows - 1) >> p.log_period_rows);
  const long long w0 = (r0 >> p.log_period_rows) * p.period_words;
  for (int i = threadIdx.x; i < periods * p.n_words; i += kThreads) {
    const int per = i / p.n_words, s = i - per * p.n_words;
    const unsigned char* src =
        p.base + (w0 + per * p.period_words + words[s]) * 16;
    unsigned char* dst = buf + i * 16;
    if (src >= p.lo && src + 16 <= p.hi) {
      cp_async16(dst, src);
    } else {  // a word at the allocation's edge: only rows past n use
      for (int k = 0; k < 16; ++k)  // its outside bytes
        dst[k] = (src + k >= p.lo && src + k < p.hi) ? src[k] : 0;
    }
  }
}

__device__ __forceinline__ void decode(const Params& p, const int* at,
                                       const unsigned char* buf,
                                       long long run) {
  const long long r0 = run * p.run_periods * p.period_rows;
  const int rows = (int)min((long long)p.run_periods * p.period_rows,
                            p.n - r0);
  const int period_bytes = p.n_words * 16;
  for (int f = 0; f < p.n_fields; ++f) {
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int j = r & (p.period_rows - 1), per = r >> p.log_period_rows;
      unsigned x[3];
      window_shared(buf + per * period_bytes, at[j * p.n_fields + f], x);
      const auto byte = [&](int k) { return shared_byte(x, k); };
      if (p.width[f] == 10)
        static_cast<int32_t*>(p.out[f])[r0 + r] = decode_i32(byte);
      else
        static_cast<float*>(p.out[f])[r0 + r] = decode_f32(byte);
    }
  }
}

// Direct mode: a thread a row, each field's bytes read from device
// memory where they lie.
__device__ __forceinline__ void decode_direct(const Params& p) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.n) return;
  const unsigned char* row = p.base + r * p.stride;
  for (int f = 0; f < p.n_fields; ++f) {
    const unsigned char* field = row + p.off[f];
    const auto byte = [&](int k) { return (unsigned)__ldg(field + k); };
    if (p.width[f] == 10)
      static_cast<int32_t*>(p.out[f])[r] = decode_i32(byte);
    else
      static_cast<float*>(p.out[f])[r] = decode_f32(byte);
  }
}

__global__ void __launch_bounds__(kThreads)
parse_fields_kernel(const __grid_constant__ Params p) {
  if (p.direct) {  // uniform: the whole launch takes one mode
    decode_direct(p);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const int run_bytes = p.run_periods * p.n_words * 16;
  int* words = reinterpret_cast<int*>(smem + run_bytes);
  int* at = words + p.n_words;
  for (int i = threadIdx.x; i < p.n_words; i += kThreads)
    words[i] = p.plan[i];
  for (int i = threadIdx.x; i < p.period_rows * p.n_fields; i += kThreads)
    at[i] = p.plan[p.n_words + i];
  __syncthreads();
  stage(p, words, smem, blockIdx.x);
  cp_async_wait_all();
  __syncthreads();
  decode(p, at, smem, blockIdx.x);
}

int g_max_smem = 0;  // opt-in shared memory per block

}  // namespace

extern "C" {

// Decodes n_fields fields of the n rows at base + r * stride (base
// 16-byte aligned, stride >= 0): field f's width[f] digits at byte off[f]
// of each row go to out[f] (int32 for width 10, f32 for 8).  direct: a
// thread a row, reading the fields where they lie; else the staged mode
// over plan (on the device), the host's word plan for a period of
// period_rows rows (a power of two) and period_words words.  [lo, hi) is
// the allocation the rows lie in.  Returns a CUDA error code.
int parse_fields_launch(const void* base, long long stride, long long n,
                        const void* lo, const void* hi, int n_fields,
                        const int* off, const int* width, void* const* out,
                        int direct, const void* plan, int n_words,
                        int period_rows, long long period_words,
                        void* stream) {
  if (n < 1 || stride < 0 || n_fields < 1 || n_fields > kMaxFields ||
      (reinterpret_cast<uintptr_t>(base) & 15) || n_words < 1 ||
      period_rows < 1 || period_rows > 16 ||
      (period_rows & (period_rows - 1)) || period_words < 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.base = static_cast<const unsigned char*>(base);
  p.stride = stride;
  p.n = n;
  p.lo = static_cast<const unsigned char*>(lo);
  p.hi = static_cast<const unsigned char*>(hi);
  p.plan = static_cast<const int*>(plan);
  p.n_words = n_words;
  p.period_rows = period_rows;
  p.log_period_rows = __builtin_ctz(period_rows);
  p.period_words = period_words;
  p.n_fields = n_fields;
  p.direct = direct;
  for (int f = 0; f < n_fields; ++f) {
    if ((width[f] != 10 && width[f] != 8) || off[f] < 0)
      return (int)cudaErrorInvalidValue;
    p.off[f] = off[f];
    p.width[f] = width[f];
    p.out[f] = out[f];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct) {
    parse_fields_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  // a block a run of whole periods, about kRunBytes of packed words
  const long long period_bytes = 16ll * n_words;
  long long periods = kRunBytes / period_bytes;
  if (periods > kMaxRunRows / period_rows) periods = kMaxRunRows / period_rows;
  if (periods < 1) periods = 1;
  p.run_periods = (int)periods;
  const long long run_rows = periods * period_rows;
  // the run's words, then the plan (a field's window may read 6 bytes
  // past the words: into the plan)
  const long long smem =
      periods * period_bytes + 4ll * (n_words + period_rows * n_fields);
  if (smem > 48 * 1024) {
    if (g_max_smem == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&g_max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (smem > g_max_smem) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        parse_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  parse_fields_kernel<<<(unsigned)((n + run_rows - 1) / run_rows), kThreads,
                        (size_t)smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
