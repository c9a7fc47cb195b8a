// Fused columnar predicate scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/filter_project/
// kernel.py: `filter_scan` (one literal predicate program) and
// `filter_scan_batch` (one slotted program evaluated for n_q queries in
// one pass over shared columns).
//
// Bound: memory, once the interpreter's issue cost is amortised.  A
// launch reads nrows x sum(predicate column bytes) (rows at or past
// nrows are false without a read) and writes n_q x N_cap mask bytes
// (plus n_q x N_cap/block int32 counts).  For the TPC-DS F2 window at SF1
// that is nrows = 2,880,404 live rows of N_cap = 2^22, two 4-byte columns
// and n_q = 8: about 56.6 MB, or about 16.9 us at an H100 SXM's 3.35 TB/s
// (the literal n_q = 1 launch: about 27.2 MB, 8.1 us).
//
// Design.  The predicate program differs per query template and nvcc
// runs once, so the host encodes each program into a small bytecode
// (int32 [op, cmp, a, b] words plus i64/f32 literal tables) that this
// kernel interprets.  All folding (fractional thresholds on int columns,
// In-list filtering, literal casts) is done on the host, so the kernel
// only runs exact compares: ints compare in their own width (64 bits for
// int64: exact beyond 2^53), f32 in f32, mixed col-col in f32.
//
// An interpreter that decodes every instruction for every row is bound
// by instruction issue, not by bytes.  So each thread owns R = 16
// consecutive rows and decodes each instruction once for all R (16 rows
// measured faster than 8 at every shape timed):
//  * a boolean stack entry is an R-bit lane mask: AND / OR / NOT are one
//    bitwise operation each; the stack top lives in its own register and
//    the rest in a shift register of W 64-bit words (a template
//    parameter the host picks from the program's depth), so no stack
//    slot is ever indexed at run time;
//  * the block translates the bytecode once into resolved words (column
//    types folded into the opcode, columns as shared-memory offsets,
//    32-bit literals inline), so a compare is one 16-byte shared load
//    and two switches (uniform across the block), then an unrolled loop
//    over the R rows;
//  * a window's slotted program runs G = 4 queries a pass, each with its
//    own stack: a slot compare loads its column's R values once and
//    compares them with each query's operand;
//  * the block first stages its tile of every predicate column in shared
//    memory with coalesced 16-byte loads, swizzled so that each thread's
//    16-byte reads of its own R rows hit distinct banks; instructions
//    index the column by its number in shared memory, never a register
//    array, so nothing goes to local memory;
//  * the literal tables and the launch's (n_q, k) operand rows are
//    loaded into shared memory once per block (they stay in global
//    memory when they are too large to fit);
//  * a query's R mask bytes are one 16-byte store, and its count
//    is __popc of the lane masks summed over the warp by
//    __reduce_add_sync, one shared-memory add per warp.
// A block covers `span` whole count-blocks of `block` rows, so it owns
// every count it adds to and no global atomics or zeroing are needed;
// any `block` that divides N works (a `block` that is not a multiple of
// 32 R counts per thread and count-block instead of per warp).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kRows = 16;                // R: rows a thread
constexpr int kMaxThreads = 256;
constexpr int kTileBudget = 64 * 1024;   // staged column bytes a block
constexpr int kCountBudget = 16 * 1024;  // per-block count bytes
constexpr int kTableBudget = 32 * 1024;  // literal + operand tables

enum Op : int {
  OP_CMP_INT_LIT = 0,  // int col  cmp lit_i[b]
  OP_CMP_F32_LIT = 1,  // f32 col  cmp lit_f[b]
  OP_CMP_SLOT_I = 2,   // col      cmp iconsts[q, b]
  OP_CMP_SLOT_F = 3,   // col (as f32) cmp fconsts[q, b]
  OP_CMP_CC_INT = 4,   // int col a cmp int col b (same width)
  OP_CMP_CC_F32 = 5,   // col a cmp col b, both as f32
  OP_IN_INT = 6,       // int col a in lit_i[b : b + cmp]
  OP_IN_F32 = 7,       // f32 col a in lit_f[b : b + cmp]
  OP_CONST = 8,        // push cmp != 0
  OP_AND = 9,
  OP_OR = 10,
  OP_NOT = 11,
};

enum ColType : int { T_I32 = 0, T_I64 = 1, T_F32 = 2 };

struct Params {
  const void* col_ptr[kMaxCols];
  int col_type[kMaxCols];
  int col_vec[kMaxCols];  // 16-byte aligned: staged with vector loads
  int n_cols;
  const int* prog;
  int n_ins;
  const long long* lit_i;
  int n_lit_i;
  const float* lit_f;
  int n_lit_f;
  const int* iconsts;
  int ki;
  const float* fconsts;
  int kf;
  int n_q;
  long long n, nrows;
  int block;  // rows per count-block
  bool* mask;
  int* counts;
};

// Shared-memory layout of one block (byte offsets, 16-byte aligned).
struct Layout {
  int span;                 // count-blocks a block covers
  int col_off[kMaxCols];    // each staged column's tile
  int prog, counts;         // translated program, per-block counts
  int lit_i, lit_f, ic, fc; // tables, -1 when they stay in global memory
  int bytes;
};

__host__ __device__ inline int align16(long long x) {
  return (int)((x + 15) & ~15ll);
}

__host__ __device__ inline int elt_size(int type) {
  return type == T_I64 ? 8 : 4;
}

// Fills `L`; false for a size no launch could hold.
__host__ inline bool make_layout(const Params& p, int R, int threads,
                                 int span, bool tables, Layout* L) {
  long long off = 0;
  L->span = span;
  for (int c = 0; c < kMaxCols; ++c) {
    L->col_off[c] = (int)off;
    if (c < p.n_cols) off += (long long)threads * R * elt_size(p.col_type[c]);
  }
  L->prog = align16(off);
  off = L->prog + 16ll * p.n_ins;
  L->counts = align16(off);
  off = L->counts + 4ll * p.n_q * span;
  L->lit_i = L->lit_f = L->ic = L->fc = -1;
  if (tables) {
    L->lit_i = align16(off);
    off = L->lit_i + 8ll * p.n_lit_i;
    L->lit_f = align16(off);
    off = L->lit_f + 4ll * p.n_lit_f;
    L->ic = align16(off);
    off = L->ic + 4ll * p.n_q * p.ki;
    L->fc = align16(off);
    off = L->fc + 4ll * p.n_q * p.kf;
  }
  if (off > (1ll << 30)) return false;
  L->bytes = align16(off);
  return true;
}

// The R-bit mask of rows r0 .. r0 + R - 1 that lie in [lo, hi).
template <int R>
__device__ __forceinline__ unsigned lanes_in(long long r0, long long lo,
                                             long long hi) {
  const long long a = min(max(lo - r0, 0ll), (long long)R);
  const long long b = min(max(hi - r0, 0ll), (long long)R);
  if (b <= a) return 0u;
  return ((1u << b) - 1u) & ~((1u << a) - 1u);
}

// 16-byte chunk j of thread t's rows sits at chunk t * C + (j ^ swz(t)):
// the 8 threads of a 128-bit shared load phase then read 8 distinct
// 16-byte bank groups.
__host__ __device__ __forceinline__ int swizzle(int t, int chunks) {
  return ((t * chunks) >> 3) & (chunks - 1);
}

template <int R, typename T>
struct Rows {
  T v[R];
};

__device__ __forceinline__ void unpack(const int4& x, int* d) {
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}
__device__ __forceinline__ void unpack(const int4& x, float* d) {
  d[0] = __int_as_float(x.x); d[1] = __int_as_float(x.y);
  d[2] = __int_as_float(x.z); d[3] = __int_as_float(x.w);
}
__device__ __forceinline__ void unpack(const int4& x, long long* d) {
  d[0] = (long long)(((unsigned long long)(unsigned)x.y << 32) | (unsigned)x.x);
  d[1] = (long long)(((unsigned long long)(unsigned)x.w << 32) | (unsigned)x.z);
}

// This thread's R staged values of one column, as stored.
template <int R, typename T>
__device__ __forceinline__ Rows<R, T> rows(const unsigned char* col,
                                           int tid) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = R / kPer;
  const int4* c4 = reinterpret_cast<const int4*>(col) + tid * kChunks;
  const int sw = swizzle(tid, kChunks);
  Rows<R, T> out;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) unpack(c4[j ^ sw], &out.v[j * kPer]);
  return out;
}

// ... converted to f32 as the plain version promotes it.
template <int R>
__device__ __forceinline__ Rows<R, float> rows_f(const unsigned char* col,
                                                 int type, int tid) {
  Rows<R, float> out;
  if (type == T_F32) return rows<R, float>(col, tid);
  if (type == T_I32) {
    const Rows<R, int> v = rows<R, int>(col, tid);
#pragma unroll
    for (int r = 0; r < R; ++r) out.v[r] = __int2float_rn(v.v[r]);
  } else {
    const Rows<R, long long> v = rows<R, long long>(col, tid);
#pragma unroll
    for (int r = 0; r < R; ++r) out.v[r] = __ll2float_rn(v.v[r]);
  }
  return out;
}

#define LANES(EXPR)                                                   \
  _Pragma("unroll") for (int r = 0; r < R; ++r) m |= (unsigned)(EXPR) << r

template <int R, typename T>
__device__ __forceinline__ unsigned cmp_scalar(int c, const Rows<R, T>& x,
                                               T y) {
  unsigned m = 0;
  switch (c) {
    case 0: LANES(x.v[r] < y); break;
    case 1: LANES(x.v[r] <= y); break;
    case 2: LANES(x.v[r] > y); break;
    case 3: LANES(x.v[r] >= y); break;
    case 4: LANES(x.v[r] == y); break;
    default: LANES(x.v[r] != y); break;
  }
  return m;
}

// The R rows against G operands at once: one switch for all G.
#define LANES_G(EXPR)                                                  \
  _Pragma("unroll") for (int g = 0; g < G; ++g)                        \
      _Pragma("unroll") for (int r = 0; r < R; ++r)                    \
          m[g] |= (unsigned)(EXPR) << r

template <int R, typename T, int G>
__device__ __forceinline__ void cmp_scalars(int c, const Rows<R, T>& x,
                                            const T (&y)[G],
                                            unsigned (&m)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = 0u;
  switch (c) {
    case 0: LANES_G(x.v[r] < y[g]); break;
    case 1: LANES_G(x.v[r] <= y[g]); break;
    case 2: LANES_G(x.v[r] > y[g]); break;
    case 3: LANES_G(x.v[r] >= y[g]); break;
    case 4: LANES_G(x.v[r] == y[g]); break;
    default: LANES_G(x.v[r] != y[g]); break;
  }
}

#undef LANES_G

template <int R, typename T>
__device__ __forceinline__ unsigned cmp_rows(int c, const Rows<R, T>& x,
                                             const Rows<R, T>& y) {
  unsigned m = 0;
  switch (c) {
    case 0: LANES(x.v[r] < y.v[r]); break;
    case 1: LANES(x.v[r] <= y.v[r]); break;
    case 2: LANES(x.v[r] > y.v[r]); break;
    case 3: LANES(x.v[r] >= y.v[r]); break;
    case 4: LANES(x.v[r] == y.v[r]); break;
    default: LANES(x.v[r] != y.v[r]); break;
  }
  return m;
}

template <int R, typename T, typename L>
__device__ __forceinline__ unsigned in_list(const Rows<R, T>& x,
                                            const L* vals, int count) {
  unsigned m = 0;
  for (int j = 0; j < count; ++j) {
    const T y = (T)vals[j];
    LANES(x.v[r] == y);
  }
  return m;
}

#undef LANES

// The program as the block runs it: each host word [op, cmp, a, b]
// becomes {kind | cmp << 8, a, b, v} with the column types resolved
// into the kind, the columns as their tiles' shared-memory offsets, and
// 32-bit literals inline, so an instruction is one 16-byte shared load
// and one switch.
enum Kind : int {
  K_AND, K_OR, K_NOT, K_CONST,  // K_CONST: cmp holds the value
  K_I32_LIT,                    // i32 col a cmp v
  K_I64_LIT,                    // i64 col a cmp lit_i[b]
  K_F32_LIT,                    // f32 col a cmp v (f32 bits)
  K_I32_SLOT_I, K_I64_SLOT_I,   // col a cmp iconsts[q, b]
  K_F32_SLOT_I,                 // f32 col a cmp f32(iconsts[q, b])
  K_SLOT_F,                     // col a (type v) as f32 cmp fconsts[q, b]
  K_CC_I32, K_CC_I64,           // col a cmp col b (offsets a, b)
  K_CC_F,                       // col a, b (types v & 3, v >> 2) as f32
  K_IN_I32, K_IN_I64,           // int col a in lit_i[b : b + v]
  K_IN_F32,                     // f32 col a in lit_f[b : b + v]
};

__device__ __forceinline__ int4 translate(const int* w, const int* col_off,
                                          const int* col_type,
                                          const long long* lit_i,
                                          const float* lit_f) {
  const int op = w[0], c = w[1], a = w[2], b = w[3];
  const bool reads_a = op <= OP_IN_F32;
  const int ta = reads_a ? col_type[a] : T_I32;
  const int oa = reads_a ? col_off[a] : 0;
  switch (op) {
    case OP_CMP_INT_LIT:
      if (ta == T_I32)  // the host checked the literal fits the column
        return make_int4(K_I32_LIT | c << 8, oa, 0, (int)lit_i[b]);
      return make_int4(K_I64_LIT | c << 8, oa, b, 0);
    case OP_CMP_F32_LIT:  // the host emits it for f32 columns only
      return make_int4(K_F32_LIT | c << 8, oa, 0, __float_as_int(lit_f[b]));
    case OP_CMP_SLOT_I:
      return make_int4((ta == T_I32   ? K_I32_SLOT_I
                        : ta == T_I64 ? K_I64_SLOT_I
                                      : K_F32_SLOT_I) | c << 8,
                       oa, b, 0);
    case OP_CMP_SLOT_F: return make_int4(K_SLOT_F | c << 8, oa, b, ta);
    case OP_CMP_CC_INT:  // the host emits it for two ints of one width
      return make_int4((ta == T_I32 ? K_CC_I32 : K_CC_I64) | c << 8, oa,
                       col_off[b], 0);
    case OP_CMP_CC_F32:
      return make_int4(K_CC_F | c << 8, oa, col_off[b],
                       ta | col_type[b] << 2);
    case OP_IN_INT:  // the host kept only values the column can hold
      return make_int4(ta == T_I32 ? K_IN_I32 : K_IN_I64, oa, b, c);
    case OP_IN_F32: return make_int4(K_IN_F32, oa, b, c);
    case OP_CONST: return make_int4(K_CONST | c << 8, 0, 0, 0);
    case OP_AND: return make_int4(K_AND, 0, 0, 0);
    case OP_OR: return make_int4(K_OR, 0, 0, 0);
    default: return make_int4(K_NOT, 0, 0, 0);
  }
}

// What a block's threads interpret against.
struct Tables {
  const unsigned char* smem;
  const long long* lit_i;
  const float* lit_f;
  const int* ic;    // (n_q, ki) operand rows
  const float* fc;  // (n_q, kf)
  int ki, kf;
};

// A leaf that reads no operand row: the same lane mask for every query.
template <int R>
__device__ __forceinline__ unsigned shared_leaf(const int4& w,
                                                const Tables& t, int tid) {
  constexpr unsigned kFull = (1u << R) - 1u;
  const int c = w.x >> 8;
  const unsigned char* ca = t.smem + w.y;
  switch (w.x & 0xff) {
    case K_CONST: return c ? kFull : 0u;
    case K_I32_LIT:
      return cmp_scalar<R, int>(c, rows<R, int>(ca, tid), w.w);
    case K_I64_LIT:
      return cmp_scalar<R, long long>(c, rows<R, long long>(ca, tid),
                                      t.lit_i[w.z]);
    case K_F32_LIT:
      return cmp_scalar<R, float>(c, rows<R, float>(ca, tid),
                                  __int_as_float(w.w));
    case K_CC_I32:
      return cmp_rows<R, int>(c, rows<R, int>(ca, tid),
                              rows<R, int>(t.smem + w.z, tid));
    case K_CC_I64:
      return cmp_rows<R, long long>(c, rows<R, long long>(ca, tid),
                                    rows<R, long long>(t.smem + w.z, tid));
    case K_CC_F:
      return cmp_rows<R, float>(c, rows_f<R>(ca, w.w & 3, tid),
                                rows_f<R>(t.smem + w.z, w.w >> 2, tid));
    case K_IN_I32:
      return in_list<R, int>(rows<R, int>(ca, tid), t.lit_i + w.z, w.w);
    case K_IN_I64:
      return in_list<R, long long>(rows<R, long long>(ca, tid),
                                   t.lit_i + w.z, w.w);
    default:  // K_IN_F32
      return in_list<R, float>(rows<R, float>(ca, tid), t.lit_f + w.z, w.w);
  }
}

// One leaf over this thread's R rows for the G queries q[g]: a slot
// compare loads the column's values once and compares them with each
// query's operand.
template <int R, int G>
__device__ __forceinline__ void leaf(const int4& w, const Tables& t, int tid,
                                     const int (&q)[G], unsigned (&m)[G]) {
  const int c = w.x >> 8;
  const unsigned char* ca = t.smem + w.y;
  switch (w.x & 0xff) {
    case K_I32_SLOT_I: {
      int y[G];
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = t.ic[q[g] * t.ki + w.z];
      cmp_scalars<R, int, G>(c, rows<R, int>(ca, tid), y, m);
      return;
    }
    case K_I64_SLOT_I: {
      long long y[G];
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = t.ic[q[g] * t.ki + w.z];
      cmp_scalars<R, long long, G>(c, rows<R, long long>(ca, tid), y, m);
      return;
    }
    case K_F32_SLOT_I: {
      float y[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        y[g] = __int2float_rn(t.ic[q[g] * t.ki + w.z]);
      cmp_scalars<R, float, G>(c, rows<R, float>(ca, tid), y, m);
      return;
    }
    case K_SLOT_F: {
      float y[G];
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = t.fc[q[g] * t.kf + w.z];
      cmp_scalars<R, float, G>(c, rows_f<R>(ca, w.w, tid), y, m);
      return;
    }
    default: {
      const unsigned v = shared_leaf<R>(w, t, tid);
#pragma unroll
      for (int g = 0; g < G; ++g) m[g] = v;
    }
  }
}

// The stack below the top: entries of R bits, newest in the low bits.
template <int R, int W>
__device__ __forceinline__ void push(unsigned long long (&s)[W], unsigned x) {
#pragma unroll
  for (int w = W - 1; w > 0; --w) s[w] = (s[w] << R) | (s[w - 1] >> (64 - R));
  s[0] = (s[0] << R) | x;
}

template <int R, int W>
__device__ __forceinline__ unsigned pop(unsigned long long (&s)[W]) {
  const unsigned x = (unsigned)(s[0] & ((1ull << R) - 1ull));
#pragma unroll
  for (int w = 0; w < W - 1; ++w) s[w] = (s[w] >> R) | (s[w + 1] << (64 - R));
  s[W - 1] >>= R;
  return x;
}

// The program for the G queries q[g], each with its own stack; the
// lane masks of their results in top[g].
template <int R, int W, int G>
__device__ __forceinline__ void run_program(const int4* prog, int n_ins,
                                            const Tables& t, int tid,
                                            const int (&q)[G],
                                            unsigned (&top)[G]) {
  constexpr unsigned kFull = (1u << R) - 1u;
  unsigned long long st[G][W];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    top[g] = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) st[g][w] = 0ull;
  }
  for (int i = 0; i < n_ins; ++i) {
    const int4 ins = prog[i];
    switch (ins.x & 0xff) {
      case K_AND:
#pragma unroll
        for (int g = 0; g < G; ++g) top[g] &= pop<R, W>(st[g]);
        break;
      case K_OR:
#pragma unroll
        for (int g = 0; g < G; ++g) top[g] |= pop<R, W>(st[g]);
        break;
      case K_NOT:
#pragma unroll
        for (int g = 0; g < G; ++g) top[g] = ~top[g] & kFull;
        break;
      default: {
        unsigned r[G];
        leaf<R, G>(ins, t, tid, q, r);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          push<R, W>(st[g], top[g]);
          top[g] = r[g];
        }
      }
    }
  }
}

// Four mask bits -> four bytes 0/1 (bit k lands on bit 8k; no carries).
__device__ __forceinline__ unsigned expand4(unsigned x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

template <int R>
__device__ __forceinline__ void store_mask(bool* out, long long r0,
                                           unsigned m, unsigned own,
                                           bool vec) {
  static_assert(R == 16, "one 16-byte store of R mask bytes");
  constexpr unsigned kFull = (1u << R) - 1u;
  if (own == kFull && vec) {
    *reinterpret_cast<uint4*>(out + r0) =
        make_uint4(expand4(m), expand4(m >> 4), expand4(m >> 8),
                   expand4(m >> 12));
  } else if (own) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((own >> r) & 1u) out[r0 + r] = (m >> r) & 1u;
  }
}

// Copies rows [base, base + rows) of one column into its tile, 16 bytes
// a thread and chunk, at the swizzled chunk of the thread that reads it.
template <int R>
__device__ __forceinline__ void stage(const Params& p, int c,
                                      unsigned char* tile, long long base,
                                      int rows, int tid, int nt) {
  const int elt = elt_size(p.col_type[c]);
  const int per = 16 / elt;
  const int chunks = R / per;
  const unsigned char* src =
      static_cast<const unsigned char*>(p.col_ptr[c]) + base * elt;
  const bool vec = p.col_vec[c] != 0;
  const int n_chunks = (rows + per - 1) / per;
  for (int k = tid; k < n_chunks; k += nt) {
    const int t = k / chunks, j = k % chunks;
    int4* dst = reinterpret_cast<int4*>(tile) + t * chunks +
                (j ^ swizzle(t, chunks));
    const long long g = base + (long long)k * per;
    if (vec && g + per <= p.n) {
      *dst = __ldg(reinterpret_cast<const int4*>(src) + k);
    } else {  // an unaligned column, or the chunk that ends the column
      unsigned char* d = reinterpret_cast<unsigned char*>(dst);
      for (int e = 0; e < per && g + e < p.n; ++e)
        for (int byte = 0; byte < elt; ++byte)
          d[e * elt + byte] = src[(k * per + e) * elt + byte];
    }
  }
}

// (at most 128 registers: two 256-thread blocks an SM)
template <int R, int W, int G>
__global__ void __launch_bounds__(kMaxThreads, 2)
filter_scan_kernel(const __grid_constant__ Params p,
                   const __grid_constant__ Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  int4* sprog = reinterpret_cast<int4*>(smem + L.prog);
  int* scount = reinterpret_cast<int*>(smem + L.counts);
  for (int i = tid; i < p.n_q * L.span; i += nt) scount[i] = 0;
  Tables t{smem, p.lit_i, p.lit_f, p.iconsts, p.fconsts, p.ki, p.kf};
  if (L.lit_i >= 0) {
    long long* li = reinterpret_cast<long long*>(smem + L.lit_i);
    float* lf = reinterpret_cast<float*>(smem + L.lit_f);
    int* ic = reinterpret_cast<int*>(smem + L.ic);
    float* fc = reinterpret_cast<float*>(smem + L.fc);
    for (int i = tid; i < p.n_lit_i; i += nt) li[i] = p.lit_i[i];
    for (int i = tid; i < p.n_lit_f; i += nt) lf[i] = p.lit_f[i];
    for (int i = tid; i < p.n_q * p.ki; i += nt) ic[i] = p.iconsts[i];
    for (int i = tid; i < p.n_q * p.kf; i += nt) fc[i] = p.fconsts[i];
    t.lit_i = li;
    t.lit_f = lf;
    t.ic = ic;
    t.fc = fc;
  }
  for (int i = tid; i < p.n_ins; i += nt)
    sprog[i] = translate(p.prog + 4 * i, L.col_off, p.col_type, p.lit_i,
                         p.lit_f);
  __syncthreads();

  const int tile = nt * R;
  const long long span_lo = (long long)blockIdx.x * L.span * p.block;
  const long long span_hi = min(span_lo + (long long)L.span * p.block, p.n);
  const long long live_hi = min(span_hi, p.nrows);
  const bool warp_counts = p.block % (32 * R) == 0;
  const bool vec_store = p.n % R == 0;
  for (long long base = span_lo - span_lo % R; base < span_hi; base += tile) {
    // a tile wholly past nrows reads nothing and stores zeros
    const long long load_hi = min(base + tile, live_hi);
    if (load_hi > base)
      for (int c = 0; c < p.n_cols; ++c)
        stage<R>(p, c, smem + L.col_off[c], base, (int)(load_hi - base), tid,
                 nt);
    __syncthreads();
    const long long r0 = base + (long long)tid * R;
    const unsigned own = lanes_in<R>(r0, span_lo, span_hi);
    const unsigned live = lanes_in<R>(r0, span_lo, live_hi);
    // the count-block (of this block's) that holds the warp's rows
    const int warp_cb =
        (int)(max(base + (long long)(tid & ~31) * R - span_lo, 0ll) / p.block);
    for (int q0 = 0; q0 < p.n_q; q0 += G) {
      // the last pass repeats query n_q - 1 in its unused slots
      int q[G];
      unsigned m[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        q[g] = min(q0 + g, p.n_q - 1);
        m[g] = 0u;
      }
      if (live) {
        run_program<R, W, G>(sprog, p.n_ins, t, tid, q, m);
#pragma unroll
        for (int g = 0; g < G; ++g) m[g] &= live;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (q0 + g >= p.n_q) break;  // uniform
        store_mask<R>(p.mask + (long long)(q0 + g) * p.n, r0, m[g], own,
                      vec_store);
        int* qcount = scount + (q0 + g) * L.span;
        if (warp_counts) {  // the warp's 32 R rows lie in one count-block
          const unsigned total = __reduce_add_sync(0xffffffffu, __popc(m[g]));
          if (lane == 0 && total) atomicAdd(&qcount[warp_cb], (int)total);
        } else if (m[g]) {  // split this thread's rows by count-block
          long long row = max(r0, span_lo);
          const long long end = min(r0 + R, span_hi);
          while (row < end) {
            const long long cb = (row - span_lo) / p.block;
            const long long stop = min(end, span_lo + (cb + 1) * p.block);
            const int k = __popc(m[g] & lanes_in<R>(r0, row, stop));
            if (k) atomicAdd(&qcount[(int)cb], k);
            row = stop;
          }
        }
      }
    }
    __syncthreads();
  }
  const long long n_blocks = p.n / p.block;
  for (int i = tid; i < p.n_q * L.span; i += nt) {
    const int q = i / L.span;
    const long long cb = (long long)blockIdx.x * L.span + i % L.span;
    if (cb < n_blocks) p.counts[q * n_blocks + cb] = scount[i];
  }
}

int g_max_smem = 0;  // opt-in shared memory per block of this device

template <int R, int W, int G>
int launch_variant(const Params& p, const Layout& L, int threads,
                   cudaStream_t stream) {
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        filter_scan_kernel<R, W, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_blocks = p.n / p.block;
  const long long grid = (n_blocks + L.span - 1) / L.span;
  filter_scan_kernel<R, W, G>
      <<<(unsigned)grid, threads, L.bytes, stream>>>(p, L);
  return (int)cudaGetLastError();
}

// The compiled variants: W stack words, G queries a pass (4 only for
// stacks of one or two words).
int launch_words(const Params& p, const Layout& L, int threads, int words,
                 int queries, cudaStream_t stream) {
  constexpr int R = kRows;
  if (queries == 4) {
    if (words == 1) return launch_variant<R, 1, 4>(p, L, threads, stream);
    if (words == 2) return launch_variant<R, 2, 4>(p, L, threads, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (queries != 1) return (int)cudaErrorInvalidValue;
  switch (words) {
    case 1: return launch_variant<R, 1, 1>(p, L, threads, stream);
    case 2: return launch_variant<R, 2, 1>(p, L, threads, stream);
    case 4: return launch_variant<R, 4, 1>(p, L, threads, stream);
    case 8: return launch_variant<R, 8, 1>(p, L, threads, stream);
    case 16: return launch_variant<R, 16, 1>(p, L, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -1: the program, the query count and the smallest tile do not fit in
// shared memory.
int launch(Params p, int stack_words, int queries, cudaStream_t stream) {
  if (p.n_cols < 1 || p.n_cols > kMaxCols || p.block < 1 ||
      p.n % p.block != 0 || p.n_q < 1 || p.n_ins < 1)
    return (int)cudaErrorInvalidValue;
  if (g_max_smem == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  constexpr int R = kRows;
  int row_bytes = 0;
  for (int c = 0; c < p.n_cols; ++c) {
    row_bytes += elt_size(p.col_type[c]);
    p.col_vec[c] = (reinterpret_cast<uintptr_t>(p.col_ptr[c]) & 15) == 0;
  }
  // the widest tile within budget (32 threads at the least), the most
  // count-blocks it spans within budget, the tables when they fit
  int threads = kMaxThreads;
  while (threads > 32 && threads * R * row_bytes > kTileBudget) threads /= 2;
  const int tile = threads * R;
  int span = tile / p.block > 1 ? tile / p.block : 1;
  while (span > 1 && 4ll * p.n_q * span > kCountBudget) span /= 2;
  const long long table_bytes = 8ll * p.n_lit_i + 4ll * p.n_lit_f +
                                4ll * p.n_q * (p.ki + p.kf);
  Layout L;
  if (!make_layout(p, R, threads, span, table_bytes <= kTableBudget, &L))
    return -1;
  if (L.bytes > g_max_smem) {
    if (!make_layout(p, R, threads, span, false, &L) || L.bytes > g_max_smem)
      return -1;
  }
  return launch_words(p, L, threads, stack_words, queries, stream);
}

Params params_of(const long long* col_ptrs, const int* col_types, int n_cols,
                 const void* prog, int n_ins, const void* lit_i, int n_lit_i,
                 const void* lit_f, int n_lit_f, long long n,
                 long long nrows, int block, void* mask, void* counts) {
  Params p = {};
  for (int c = 0; c < kMaxCols && c < n_cols; ++c) {
    p.col_ptr[c] = reinterpret_cast<const void*>(col_ptrs[c]);
    p.col_type[c] = col_types[c];
  }
  p.n_cols = n_cols;
  p.prog = static_cast<const int*>(prog);
  p.n_ins = n_ins;
  p.lit_i = static_cast<const long long*>(lit_i);
  p.n_lit_i = n_lit_i;
  p.lit_f = static_cast<const float*>(lit_f);
  p.n_lit_f = n_lit_f;
  p.n = n;
  p.nrows = nrows;
  p.block = block;
  p.mask = static_cast<bool*>(mask);
  p.counts = static_cast<int*>(counts);
  return p;
}

}  // namespace

extern "C" {

// One literal program (n_q = 1, no slot operands): mask (N,), counts
// (N / block,).  stack_words: the 64-bit words of the stack below its
// top (1, 2, 4, 8 or 16).  Returns a CUDA error code, or -1 when the
// program does not fit in shared memory.
int filter_scan_launch(const long long* col_ptrs, const int* col_types,
                       int n_cols, const void* prog, int n_ins,
                       const void* lit_i, int n_lit_i, const void* lit_f,
                       int n_lit_f, long long n, long long nrows, int block,
                       int stack_words, void* mask, void* counts,
                       void* stream) {
  Params p = params_of(col_ptrs, col_types, n_cols, prog, n_ins, lit_i,
                       n_lit_i, lit_f, n_lit_f, n, nrows, block, mask,
                       counts);
  p.n_q = 1;
  return launch(p, stack_words, 1, static_cast<cudaStream_t>(stream));
}

// One slotted program for n_q queries: mask (n_q, N), counts
// (n_q, N / block); iconsts / fconsts are (n_q, ki) / (n_q, kf);
// queries (1, or 4 with 1 or 2 stack words) are evaluated a pass.
int filter_scan_batch_launch(const long long* col_ptrs, const int* col_types,
                             int n_cols, const void* prog, int n_ins,
                             const void* lit_i, int n_lit_i,
                             const void* lit_f, int n_lit_f,
                             const void* iconsts, int ki,
                             const void* fconsts, int kf, int n_q,
                             long long n, long long nrows, int block,
                             int stack_words, int queries, void* mask,
                             void* counts, void* stream) {
  Params p = params_of(col_ptrs, col_types, n_cols, prog, n_ins, lit_i,
                       n_lit_i, lit_f, n_lit_f, n, nrows, block, mask,
                       counts);
  p.iconsts = static_cast<const int*>(iconsts);
  p.ki = ki;
  p.fconsts = static_cast<const float*>(fconsts);
  p.kf = kf;
  p.n_q = n_q;
  return launch(p, stack_words, queries, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
