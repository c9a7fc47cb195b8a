// Fixed-width CSV field decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `parse_i32` in src/repro/kernels/
// filter_project/kernel.py ((N, 10) zero-padded ASCII digits -> int32),
// and adds its 8-digit fractional variant `parse_f32` ((N, 8) digits ->
// f32 in [0, 1)), which the JAX package leaves to XLA in its physical
// scan.  Both are what a CSV scan pays for every numeric column it
// reads: the cost the covering-expression cache exists to avoid.
//
// Bound: memory.  A launch reads each live row's field once (10 or 8
// bytes) and writes 4 bytes per row.  At SF1 (2,880,404 live rows of
// store_sales) that is 40.3 MB for parse_i32 and 34.6 MB for parse_f32,
// about 12.0 and 10.3 us at an H100 SXM's 3.35 TB/s.  The field lies
// inside a wider row (90 bytes for store_sales), so the card really
// moves whole 32-byte sectors of the raw row matrix; the arithmetic (a
// dozen integer or f32 operations a row) is far below the card's rate.
//
// Design.  One thread per row with byte loads: the field is taken as
// the strided view it is (row pointer = base + row * row_stride), so no
// copy of the field is made.  Semantics are the plain torch versions'
// bit for bit, padding rows past the live count included (their zero
// bytes decode as digit -48):
//  * parse_i32 accumulates in uint32, so the 10-digit values past 2^31
//    (and the padding rows) wrap modulo 2^32 exactly as the plain
//    version's integer sum does, with no signed overflow;
//  * parse_f32 adds the digit products in the plain version's order,
//    most significant first, each rounded on its own (__fadd_rn /
//    __fmul_rn forbid contraction; every product d * 10^k is exact in
//    f32 anyway), then scales once by f32(1e-8).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__constant__ uint32_t kPow10I[10] = {1000000000u, 100000000u, 10000000u,
                                     1000000u,    100000u,    10000u,
                                     1000u,       100u,       10u,
                                     1u};
__constant__ float kPow10F[8] = {1e7f, 1e6f, 1e5f, 1e4f,
                                 1e3f, 1e2f, 1e1f, 1.0f};
// float32(1e-8), the plain version's scale
constexpr float kScale = 0x1.5798eep-27f;

__global__ void __launch_bounds__(kThreads)
parse_i32_kernel(const uint8_t* __restrict__ raw, long long row_stride,
                 long long n, int32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint8_t* p = raw + row * row_stride;
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < 10; ++k)
    acc += ((uint32_t)p[k] - 48u) * kPow10I[k];
  out[row] = (int32_t)acc;
}

__global__ void __launch_bounds__(kThreads)
parse_f32_kernel(const uint8_t* __restrict__ raw, long long row_stride,
                 long long n, float* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint8_t* p = raw + row * row_stride;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    acc = __fadd_rn(acc, __fmul_rn((float)((int)p[k] - 48), kPow10F[k]));
  out[row] = __fmul_rn(acc, kScale);
}

unsigned grid_of(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// (n, 10) digits at raw + row * row_stride -> int32 (n,).
int parse_i32_launch(const void* raw, long long row_stride, long long n,
                     void* out, void* stream) {
  if (n < 1 || row_stride < 0) return (int)cudaErrorInvalidValue;
  parse_i32_kernel<<<grid_of(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), row_stride, n,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// (n, 8) fractional digits at raw + row * row_stride -> f32 (n,).
int parse_f32_launch(const void* raw, long long row_stride, long long n,
                     void* out, void* stream) {
  if (n < 1 || row_stride < 0) return (int)cudaErrorInvalidValue;
  parse_f32_kernel<<<grid_of(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), row_stride, n,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
