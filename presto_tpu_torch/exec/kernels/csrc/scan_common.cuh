// Shared by the fused scan kernels (the hash kernel of scan_grouped.cu,
// and the direct and span kernels generated per chain by
// exec/kernels/codegen.py, compiled with NVRTC): the plan vector's layout,
// column decode, one function per ExprProgram opcode (op_*) and the
// interpreter that the hash kernel runs over them, so every kernel runs
// one expression semantics -- the torch evaluator's (exec/lowering.py
// ExprProgram.run) --, the chain's steps with the join probe (kernel #5,
// probe_step below), the stage ring of scan_kernel_dma = "double" (kernel
// #2, ring_copy / stage_rows below), the folds of rows into accumulator
// tables and the grouped kernels' reduce over their partials.
//
// The interpreter's functions that read columns take a template parameter
// S: S = 1 is the unstaged kernel (every per-row load an __ldg from device
// memory), S = 2 reads the staged arrays from the tile's stage of the ring
// in shared memory (the ring's depth is the launch's).
#pragma once
#ifdef __CUDACC_RTC__
// NVRTC (the direct kernel generated per chain, exec/kernels/codegen.py)
// has no host headers: the fixed-width types it needs
typedef signed char int8_t;
typedef short int16_t;
typedef int int32_t;
typedef unsigned char uint8_t;
typedef unsigned int uint32_t;
#else
#include <cuda_runtime.h>
#include <stdint.h>
#endif

// plan header words (exec/kernels/scan_kernel.py build_scan_plan)
enum {
  H_N_COLS = 0, H_N_STEPS, H_G, H_N_I, H_N_F, H_N_SPECS, H_N_KEYS,
  H_OFF_COLS, H_OFF_STEPS, H_OFF_KEYS, H_OFF_SPECS, H_OFF_ROWS, H_DEPTH,
  H_OFF_SRC, H_N_JOINS, H_OFF_JOINS,
};
enum { COL_WORDS = 6, SPEC_WORDS = 7 };
// column kinds: resident encodings, then the probe steps' virtual columns
// (a gathered build column, a semi-join marker)
enum { K_PLAIN = 0, K_DICT = 1, K_RLE = 2, K_GATHER = 3, K_SEMI = 4 };
// a probe step's record (exec/kernels/scan_kernel.py _JOIN_WORDS)
enum { JOIN_WORDS = 10 };
enum { J_TABLE = 0, J_FORM, J_N_KEYS, J_KEYS_OFF, J_OP0, J_OP1, J_SIZE,
       J_BHN, J_DIR, J_DIR_SHIFT };
enum { TBL_DIRECT = 0, TBL_UNIQUE = 1 };
enum { FORM_INNER = 0, FORM_LEFT = 1, FORM_SEMI = 2 };
enum { DT_I8 = 0, DT_I16, DT_I32, DT_I64, DT_F64, DT_BOOL };
enum { S_COUNT_STAR = 0, S_COUNT, S_SUM, S_AVG, S_MIN, S_MAX };
enum { R_ADD = 0, R_MIN = 1, R_MAX = 2 };
// opcodes: exec/lowering.py OPS, in order
enum {
  OP_COL = 0, OP_CONST_I, OP_CONST_F, OP_NULL_I, OP_NULL_F, OP_PARAM_I,
  OP_PARAM_F, OP_MULC_I, OP_DIVR_I, OP_I2F, OP_DIVC_F, OP_WRAP32,
  OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_ADD_F, OP_SUB_F, OP_MUL_F,
  OP_LT_I, OP_LTE_I, OP_GT_I, OP_GTE_I, OP_EQ_I, OP_NEQ_I,
  OP_LT_F, OP_LTE_F, OP_GT_F, OP_GTE_F, OP_EQ_F, OP_NEQ_F,
  OP_AND, OP_OR, OP_NOT,
  OP_NEG_I, OP_NEG_F, OP_ABS_I, OP_ABS_F, OP_YEAR, OP_MONTH, OP_DAY,
  OP_QUARTER, OP_MULC_F, OP_RINT_I,
  OP_DIV_I, OP_MOD_I, OP_DIVQ_I, OP_DIV_F, OP_MOD_F,
  OP_IS_NULL, OP_IF, OP_COALESCE, OP_NULLIF_I, OP_NULLIF_F,
  OP_IN_I, OP_IN_F, OP_LIT, OP_DIVQS_I,
};

typedef long long i64;
typedef unsigned long long u64;

__device__ __forceinline__ double as_f(i64 b) { return __longlong_as_double(b); }
__device__ __forceinline__ i64 as_b(double f) { return __double_as_longlong(f); }

#define GOLDEN 0x9E3779B97F4A7C15ULL

// exec/operators.py splitmix64, in native uint64
__device__ __forceinline__ u64 splitmix64(u64 x) {
  x += GOLDEN;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// One key's round of exec/operators.py hash_columns (h starts at salt + 1):
// the group keys of the hash kernel and the unique-table probe keys hash
// through it alike.
__device__ __forceinline__ u64 hash_mix(u64 h, i64 v, bool null) {
  return splitmix64(h * 31ULL + (null ? GOLDEN : splitmix64((u64)v)));
}

__device__ __forceinline__ i64 load_bits(i64 ptr, i64 i, int dt) {
  switch (dt) {
    case DT_I8: return (i64)((const int8_t*)ptr)[i];
    case DT_I16: return (i64)((const int16_t*)ptr)[i];
    case DT_I32: return (i64)((const int32_t*)ptr)[i];
    case DT_BOOL: return (i64)((const uint8_t*)ptr)[i];
    default: return ((const i64*)ptr)[i];   // int64, or float64 bits
  }
}

// RLE: the run of absolute row a, searchsorted(run_starts, a,
// side="right") - 1 clipped to the n runs (the reference's _bisect_right)
__device__ __forceinline__ i64 rle_run(const i64* starts, i64 n, i64 a) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (starts[mid] <= a) lo = mid + 1; else hi = mid;
  }
  const i64 ri = lo - 1;
  return ri < 0 ? 0 : (ri > n - 1 ? n - 1 : ri);
}

// logical value (int64, or float64 bits) of column `c` at absolute row `a`
static __device__ i64 decode(const i64* cm, i64 a) {
  const int kind = (int)cm[0];
  if (kind == K_PLAIN) return load_bits(cm[2], a, (int)cm[1]);
  if (kind == K_DICT) {
    const i64 code = load_bits(cm[2], a, (int)cm[1]);
    return load_bits(cm[4], code, (int)cm[3]);
  }
  return load_bits(cm[2], rle_run((const i64*)cm[4], cm[5], a), (int)cm[1]);
}

__device__ __forceinline__ i64 div_round_half_up(i64 v, i64 d) {
  const u64 mag = v < 0 ? 0ULL - (u64)v : (u64)v;
  const i64 q = (i64)((mag + (u64)(d / 2)) / (u64)d);
  return v < 0 ? -q : (v > 0 ? q : 0);
}

// Integer helpers of the expression semantics (exec/lowering.py): floor
// division and modulus as Python's // and % (b never -1 here: divisors are
// constants or absolute values), sign, abs and the int32 wrap in
// two's-complement int64.
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ i64 floor_mod(i64 a, i64 b) {
  const i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ i64 isign(i64 v) { return (i64)(v > 0) - (v < 0); }
__device__ __forceinline__ i64 iabs(i64 v) {
  return v < 0 ? (i64)(0ULL - (u64)v) : v;
}
__device__ __forceinline__ i64 imul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}
__device__ __forceinline__ i64 wrap32(i64 v) {
  return (i64)(int32_t)(uint32_t)(u64)v;
}

// year / month / day / quarter of a date (days since the epoch): the
// reference's _civil_from_days, every division a floor division
static __device__ i64 date_part(i64 days, int op) {
  const i64 z = days + 719468;
  const i64 era = floor_div(z >= 0 ? z : z - 146096, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = floor_div(doe - floor_div(doe, 1460) +
                                floor_div(doe, 36524) -
                                floor_div(doe, 146096),
                            365);
  const i64 doy = doe - (365 * yoe + floor_div(yoe, 4) - floor_div(yoe, 100));
  const i64 mp = floor_div(5 * doy + 2, 153);
  const i64 m = mp < 10 ? mp + 3 : mp - 9;
  if (op == OP_YEAR) return yoe + era * 400 + (m <= 2);
  if (op == OP_MONTH) return m;
  if (op == OP_QUARTER) return floor_div(m + 2, 3);
  return doy - floor_div(153 * mp + 2, 5) + 1;
}

// The reference's integer-domain divide / modulus of a by b (b != 0: the
// caller divides by 1 where b is 0 and makes the row NULL): the quotient
// truncates toward zero, the remainder takes a's sign.  Bit 0 of `narrow`
// marks an int32 dividend, bit 1 an int32 divisor: the reference keeps
// each in its dtype, so its abs wraps at 32 bits and the result takes the
// dividend's.
__device__ __forceinline__ i64 int_divide(i64 a, i64 b, int narrow,
                                          bool modulus) {
  i64 aa = iabs(a), ab = iabs(b);
  if (narrow & 1) aa = wrap32(aa);
  if (narrow & 2) ab = wrap32(ab);
  const i64 out = modulus ? imul(isign(a), floor_mod(aa, ab))
                          : imul(imul(isign(a), isign(b)), floor_div(aa, ab));
  return narrow & 1 ? wrap32(out) : out;
}

// the reference's decimal quotient after the numerator's rescale: rounds
// half away from zero (b != 0 and `narrow` as above)
__device__ __forceinline__ i64 dec_quotient(i64 num, i64 b, int narrow) {
  i64 an = iabs(num), ab = iabs(b);
  if (narrow & 1) an = wrap32(an);
  if (narrow & 2) ab = wrap32(ab);
  const i64 q = imul(imul(isign(num), isign(b)),
                     floor_div((i64)((u64)an + (u64)floor_div(ab, 2)), ab));
  return narrow & 1 ? wrap32(q) : q;
}

// DIVQS_I's quotient: num * 10**k / b (b != 0), rounded half away from
// zero, by long division so that the scaled numerator never leaves int64
// (exec/lowering.py _scaled_decimal_quotient; every step wraps as its
// int64 tensors do).  `narrow` bit 1 marks an int32 divisor, k is
// narrow >> 2.
__device__ __forceinline__ i64 scaled_dec_quotient(i64 num, i64 b,
                                                   int narrow) {
  i64 an = iabs(num), ab = iabs(b);
  if (narrow & 2) ab = wrap32(ab);
  i64 q = floor_div(an, ab), r = floor_mod(an, ab);
  for (int k = narrow >> 2; k > 0; --k) {
    r = imul(r, 10);
    q = (i64)((u64)imul(q, 10) + (u64)floor_div(r, ab));
    r = floor_mod(r, ab);
  }
  q = (i64)((u64)q + (u64)(r >= ab - floor_div(ab, 2)));
  return imul(imul(isign(num), isign(b)), q);
}

// jnp.mod of doubles: C's fmod moved to the divisor's sign
__device__ __forceinline__ double float_mod(double a, double b) {
  const double m = fmod(a, b);
  return (m != 0.0 && ((m < 0.0) != (b < 0.0))) ? __dadd_rn(m, b) : m;
}

// ---------------------------------------------------------------------------
// One function per opcode of exec/lowering.py OPS, on one row's value bits
// (int64, or float64 bits): the interpreter below (interpret / eval_ext)
// and the direct kernel generated per chain (exec/kernels/codegen.py) both
// call these, so the two run one expression semantics.  Null flags are
// masks (bit r: row r NULL); the generated code passes one row's flag as
// bit 0.
// ---------------------------------------------------------------------------
__device__ __forceinline__ i64 op_MULC_I(i64 v, i64 c) {
  return (i64)((u64)v * (u64)c);
}
__device__ __forceinline__ i64 op_DIVR_I(i64 v, i64 c) {
  return div_round_half_up(v, c);
}
__device__ __forceinline__ i64 op_I2F(i64 v) { return as_b((double)v); }
__device__ __forceinline__ i64 op_DIVC_F(i64 v, i64 c) {
  return as_b(__ddiv_rn(as_f(v), as_f(c)));
}
__device__ __forceinline__ i64 op_WRAP32(i64 v) { return wrap32(v); }
__device__ __forceinline__ i64 op_NOT(i64 v) { return (i64)(v == 0); }
__device__ __forceinline__ i64 op_ADD_I(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 op_SUB_I(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 op_MUL_I(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}
__device__ __forceinline__ i64 op_ADD_F(i64 a, i64 b) {
  return as_b(__dadd_rn(as_f(a), as_f(b)));
}
__device__ __forceinline__ i64 op_SUB_F(i64 a, i64 b) {
  return as_b(__dsub_rn(as_f(a), as_f(b)));
}
__device__ __forceinline__ i64 op_MUL_F(i64 a, i64 b) {
  return as_b(__dmul_rn(as_f(a), as_f(b)));
}
__device__ __forceinline__ i64 op_LT_I(i64 a, i64 b) { return (i64)(a < b); }
__device__ __forceinline__ i64 op_LTE_I(i64 a, i64 b) { return (i64)(a <= b); }
__device__ __forceinline__ i64 op_GT_I(i64 a, i64 b) { return (i64)(a > b); }
__device__ __forceinline__ i64 op_GTE_I(i64 a, i64 b) { return (i64)(a >= b); }
__device__ __forceinline__ i64 op_EQ_I(i64 a, i64 b) { return (i64)(a == b); }
__device__ __forceinline__ i64 op_NEQ_I(i64 a, i64 b) { return (i64)(a != b); }
__device__ __forceinline__ i64 op_LT_F(i64 a, i64 b) {
  return (i64)(as_f(a) < as_f(b));
}
__device__ __forceinline__ i64 op_LTE_F(i64 a, i64 b) {
  return (i64)(as_f(a) <= as_f(b));
}
__device__ __forceinline__ i64 op_GT_F(i64 a, i64 b) {
  return (i64)(as_f(a) > as_f(b));
}
__device__ __forceinline__ i64 op_GTE_F(i64 a, i64 b) {
  return (i64)(as_f(a) >= as_f(b));
}
__device__ __forceinline__ i64 op_EQ_F(i64 a, i64 b) {
  return (i64)(as_f(a) == as_f(b));
}
__device__ __forceinline__ i64 op_NEQ_F(i64 a, i64 b) {
  return (i64)(as_f(a) != as_f(b));
}
// Kleene AND / OR over value bits av, bv (nonzero: true) and null masks
// an, bn: returns the value bits, sets n to the result's null mask
__device__ __forceinline__ unsigned op_AND(unsigned av, unsigned an,
                                           unsigned bv, unsigned bn,
                                           unsigned& n) {
  const unsigned value = (av | an) & (bv | bn);   // no definite false
  n = value & (an | bn);
  return value & ~n;
}
__device__ __forceinline__ unsigned op_OR(unsigned av, unsigned an,
                                          unsigned bv, unsigned bn,
                                          unsigned& n) {
  const unsigned v = (av & ~an) | (bv & ~bn);
  n = ~v & (an | bn);
  return v;
}
__device__ __forceinline__ i64 op_NEG_I(i64 v) { return (i64)(0ULL - (u64)v); }
__device__ __forceinline__ i64 op_NEG_F(i64 v) {
  return (i64)((u64)v ^ 0x8000000000000000ULL);
}
__device__ __forceinline__ i64 op_ABS_I(i64 v) { return iabs(v); }
__device__ __forceinline__ i64 op_ABS_F(i64 v) {
  return (i64)((u64)v & 0x7fffffffffffffffULL);
}
__device__ __forceinline__ i64 op_YEAR(i64 v) { return date_part(v, OP_YEAR); }
__device__ __forceinline__ i64 op_MONTH(i64 v) {
  return date_part(v, OP_MONTH);
}
__device__ __forceinline__ i64 op_DAY(i64 v) { return date_part(v, OP_DAY); }
__device__ __forceinline__ i64 op_QUARTER(i64 v) {
  return date_part(v, OP_QUARTER);
}
__device__ __forceinline__ i64 op_MULC_F(i64 v, i64 c) {
  return as_b(__dmul_rn(as_f(v), as_f(c)));
}
__device__ __forceinline__ i64 op_RINT_I(i64 v) { return (i64)rint(as_f(v)); }
// DIV_I / MOD_I / DIVQ_I / DIVQS_I: `narrow` as int_divide's (DIVQS_I:
// scaled_dec_quotient's); a zero divisor divides by 1 and sets `zero`
// (the row turns NULL)
__device__ __forceinline__ i64 int_div_op(i64 a, i64 b, int narrow,
                                          int op, unsigned& zero) {
  if (narrow & 1) a = wrap32(a);
  if (narrow & 2) b = wrap32(b);
  zero = b == 0;
  const i64 sb = b == 0 ? 1 : b;
  return op == OP_DIVQS_I ? scaled_dec_quotient(a, sb, narrow)
         : op == OP_DIVQ_I ? dec_quotient(a, sb, narrow)
                           : int_divide(a, sb, narrow, op == OP_MOD_I);
}
__device__ __forceinline__ i64 op_DIV_I(i64 a, i64 b, int narrow,
                                        unsigned& zero) {
  return int_div_op(a, b, narrow, OP_DIV_I, zero);
}
__device__ __forceinline__ i64 op_MOD_I(i64 a, i64 b, int narrow,
                                        unsigned& zero) {
  return int_div_op(a, b, narrow, OP_MOD_I, zero);
}
__device__ __forceinline__ i64 op_DIVQ_I(i64 a, i64 b, int narrow,
                                         unsigned& zero) {
  return int_div_op(a, b, narrow, OP_DIVQ_I, zero);
}
__device__ __forceinline__ i64 op_DIVQS_I(i64 a, i64 b, int narrow,
                                          unsigned& zero) {
  return int_div_op(a, b, narrow, OP_DIVQS_I, zero);
}
__device__ __forceinline__ i64 op_DIV_F(i64 a, i64 b) {
  return as_b(__ddiv_rn(as_f(a), as_f(b)));
}
__device__ __forceinline__ i64 op_MOD_F(i64 a, i64 b) {
  return as_b(float_mod(as_f(a), as_f(b)));
}
// IS_NULL: the value is the null flag, the result never NULL
__device__ __forceinline__ i64 op_IS_NULL(unsigned vn) { return (i64)(vn & 1u); }
// IF(cond, then, else) of one row: a definite TRUE cond takes `then`
__device__ __forceinline__ i64 op_IF(i64 c, unsigned cn, i64 t, unsigned tn,
                                     i64 f, unsigned fn, unsigned& n) {
  const bool p = c != 0 && !(cn & 1u);
  n = p ? tn : fn;
  return p ? t : f;
}
__device__ __forceinline__ i64 op_COALESCE(i64 a, unsigned an, i64 b,
                                           unsigned bn, unsigned& n) {
  n = an & bn;
  return an & 1u ? b : a;
}
// NULL_IF(a, b): a, NULL where a == b and neither is NULL
__device__ __forceinline__ i64 op_NULLIF_I(i64 a, unsigned an, i64 b,
                                           unsigned bn, unsigned& n) {
  n = an | ((unsigned)(a == b) & ~an & ~bn & 1u);
  return a;
}
__device__ __forceinline__ i64 op_NULLIF_F(i64 a, unsigned an, i64 b,
                                           unsigned bn, unsigned& n) {
  n = an | ((unsigned)(as_f(a) == as_f(b)) & ~an & ~bn & 1u);
  return a;
}
// one constant of IN's list (the LIT instructions after it)
__device__ __forceinline__ bool op_IN_I(i64 v, i64 lit) { return v == lit; }
__device__ __forceinline__ bool op_IN_F(i64 v, i64 lit) {
  return as_f(v) == as_f(lit);
}

// Rows a thread carries through one pass of the interpreter: every
// instruction is fetched and dispatched once for RPT rows, whose values sit
// side by side in the thread's stack slots.
#define RPT 4

// The block-relative rows [lo, hi) of block bidx that work item `item`
// covers: slice item % n_sub of grid entry item / n_sub.
__device__ __forceinline__ void item_rows(const i64* grid, int n_grid,
                                          i64 rows_per_cta, int n_sub,
                                          i64 item, i64& bidx, i64& lo,
                                          i64& hi) {
  const int e = (int)(item / n_sub), sub = (int)(item % n_sub);
  bidx = grid[e];
  lo = grid[n_grid + e] + (i64)sub * rows_per_cta;
  const i64 end = grid[2 * n_grid + e];
  hi = end < lo + rows_per_cta ? end : lo + rows_per_cta;
}

// ---------------------------------------------------------------------------
// Kernel #2: the stage ring (scan_kernel_dma = "double").
//
// Replaces presto_tpu/exec/kernels/scan_kernel.py _stage_slabs (:329; the
// arrays it stages, staged_indices :310; its scratch, dma_scratch_shapes
// :499).  The reference copies every per-row array of the next grid block
// into VMEM while the current one computes.  Here a persistent CTA keeps a
// ring of S stages (2 <= S <= 4) in shared memory, each holding P passes
// (1 <= P <= 8) of RPT x T rows of a work item, filled by Hopper's bulk
// asynchronous copies:
//
// - What is staged is the plan's decision (exec/kernels/scan_kernel.py
//   ScanPlan.staging): the per-row arrays (plain values, dictionary codes)
//   that the kernel reads under a pass's full row mask, and the 1- and
//   2-byte arrays wherever they are read (a 32-byte sector holds 16-32 of
//   their rows, so a selective step still touches nearly every sector).
//   An array of 4 or 8 bytes first read after a filter, an inner join or
//   a semi-join's filter has narrowed the rows is loaded per live row from
//   device memory, as in the unstaged kernel: staging it would move every
//   row's bytes for the few that are read.  A plan with nothing worth
//   staging launches unstaged.
// - One thread (tid 0) is the producer.  Per stage it arms the stage's
//   "full" mbarrier with the stage's bytes (mbarrier.arrive.expect_tx) and
//   issues one cp.async.bulk per staged array, each completing on that
//   barrier; the other threads spend no instruction or register on the
//   copies.  Consumers wait on the stage's phase (mbarrier.try_wait.parity)
//   and each warp releases the stage on its "empty" mbarrier (one arrive
//   per warp) once its rows are read; the producer waits on that before it
//   refills the stage with the stage S - 1 ahead.  No __syncthreads guards
//   a stage.  The stage sequence runs across the CTA's work items
//   (RingCursor), and the phase parity is that of the CTA's stage count,
//   so the ring never drains between items.
// - S and P are the ring that the shared memory left at the layout's CTA
//   count holds (ScanPlan.staging): more than two stages where any fit,
//   then the longest stages -- they spread each stage's barrier waits and
//   bulk copies over more rows; P divides a work item's passes, as a
//   stage never spans two items --, then the most stages.  The layout
//   reserves a two-stage ring of one pass, so S and P never lower the CTA
//   count, and a single and a double launch run the same CTAs over the
//   same rows in the same fold order -- their outputs are bit-identical.
//   A plan with a probe step keeps stages of one pass where its layout
//   leaves the L1 room: longer ones take the L1 its gathers hit (J2, J3).
// - A bulk copy moves 16-byte-aligned bytes.  A stage's rows start at any
//   byte, so the ring copies each array's aligned interior (its region
//   keeps the device-memory offset modulo 16), and the consumers read the
//   ragged head and tail rows (under 16 bytes each) straight from device
//   memory (stage_rows): no thread stores into a stage, so only the async
//   proxy writes the ring, and nothing outside an array is read.  Nearly
//   every stage starts and ends on a multiple of 16 rows (grid blocks are
//   64K rows), so it is dense: all its rows are staged and its loads
//   check no bound.
//
// The four things that held the earlier two-stage cp.async ring back
// (every per-row array staged, every thread issuing 16-byte chunks and
// waiting on two __syncthreads per tile, one tile in flight, and a ring
// reservation sized by every array) are each answered above: the plan's
// set, one producer thread and mbarrier phases, stages of up to 8 passes
// with up to three of them in flight, and a reservation of only the
// staged arrays' two stages.
//
// Bound: the staged bytes (each staged array's rows once) over the device
// memory rate, 3.35 TB/s on an H100 SXM (exec/kernels/scan_kernel.py
// Staging.staged_bytes), beside the carrying kernel's byte bound, which
// it can pass: a 1-byte array the carrier reads only for the rows a
// filter keeps is staged for every row.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int dt_bytes(int dt) {
  return dt == DT_I8 || dt == DT_BOOL ? 1 : dt == DT_I16 ? 2
         : dt == DT_I32 ? 4 : 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
// the producer's arrival on a stage's full barrier, with the bytes the
// stage's copies will complete
__device__ __forceinline__ void mbar_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// The 16-byte-aligned interior [ci, ce) of rows [a0, a0 + n) of an array
// of es-byte elements at `ptr`, as device addresses (ce <= ci: empty).
__device__ __forceinline__ void ring_interior(u64 ptr, int es, i64 a0, int n,
                                              u64& src, u64& ci, u64& ce) {
  src = ptr + (u64)a0 * (u64)es;
  ci = (src + 15u) & ~(u64)15u;
  ce = (src + (u64)n * (u64)es) & ~(u64)15u;
}

// The bytes the ring copies of one array's tile.
__device__ __forceinline__ unsigned ring_bytes(u64 ptr, int es, i64 a0,
                                               int n) {
  u64 src, ci, ce;
  ring_interior(ptr, es, a0, n, src, ci, ce);
  return ce > ci ? (unsigned)(ce - ci) : 0u;
}

// Issue the bulk copy of one array's tile interior into its stage region,
// completing on the stage's full barrier.  The region keeps the tile's
// device-memory offset modulo 16 (its row k sits at region + (src & 15) +
// k * es).
__device__ __forceinline__ void ring_copy(u64 ptr, int es,
                                          unsigned char* region, i64 a0,
                                          int n, u64* full) {
  u64 src, ci, ce;
  ring_interior(ptr, es, a0, n, src, ci, ce);
  if (ce <= ci) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(region + (ci - (src & ~(u64)15u)))), "l"(ci),
         "r"((unsigned)(ce - ci)), "r"(smem_addr(full))
      : "memory");
}

// Initialise the ring's S full barriers (the producer's one arrival) and
// S empty barriers (one arrival per warp) at `bars`; one thread, before
// the CTA barrier that publishes them.
__device__ __forceinline__ void ring_init(u64* bars, int S, int warps) {
  for (int s = 0; s < S; ++s) {
    mbar_init(bars + s, 1);
    mbar_init(bars + S + s, (unsigned)warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's walk over the CTA's stages, ahead of the consumers: rows
// [lo, min(hi, lo + stage rows)) of grid block b, in work item `item`
// (items blockIdx.x, blockIdx.x + gridDim.x, ...; empty items skipped).
struct RingCursor {
  i64 item, b, lo, hi;
};

// from c.item on, the first non-empty work item's first stage; false past
// the CTA's last item
__device__ __forceinline__ bool ring_seek(RingCursor& c, const i64* grid,
                                          int n_grid, i64 rows_per_cta,
                                          int n_sub, i64 n_items) {
  for (; c.item < n_items; c.item += gridDim.x) {
    item_rows(grid, n_grid, rows_per_cta, n_sub, c.item, c.b, c.lo, c.hi);
    if (c.hi > c.lo) return true;
  }
  return false;
}

// the next stage of `rows` rows; false past the CTA's last one
__device__ __forceinline__ bool ring_next(RingCursor& c, i64 rows,
                                          const i64* grid, int n_grid,
                                          i64 rows_per_cta, int n_sub,
                                          i64 n_items) {
  c.lo += rows;
  if (c.lo < c.hi) return true;
  c.item += gridDim.x;
  return ring_seek(c, grid, n_grid, rows_per_cta, n_sub, n_items);
}

// A stage's rows: its first absolute row a0 and its n rows, and whether
// it is dense -- every staged array's rows start and end on 16-byte
// boundaries, so the ring holds all of them and no bound is checked.
struct StagePos {
  i64 a0;
  int n, dense;
};

// The hash kernel's producer state, in shared memory beside the ring's
// barriers: only thread 0 walks the cursor and writes each stage's rows
// (published to the consumers by the stage's full barrier), so none of
// it holds a register across the interpreter's loop.
struct RingCtl {
  RingCursor cur;
  StagePos pos[4];
  int more, arrays16;
};
// its bytes, as the launch reserves them (exec/kernels/scan_kernel.py
// _RING_CTL_BYTES)
#define RING_CTL_BYTES 128
static_assert(sizeof(RingCtl) <= RING_CTL_BYTES, "RingCtl");

// 16-byte aligned arrays whose stage starts and ends at rows that are
// multiples of 16: every staged array's rows are whole 16-byte chunks
__device__ __forceinline__ int stage_dense(bool arrays16, i64 a0, int n) {
  return arrays16 && ((a0 | (i64)n) & 15) == 0;
}

// The same rows of a staged array: stage rows k0 + r * T from the stage
// region -- all of them in a dense stage; else those in the copied
// interior, and the ragged head and tail rows from device memory.
template <typename V>
__device__ __forceinline__ void stage_rows(const unsigned char* region,
                                           i64 ptr, const StagePos& p,
                                           int dense, int k0, int T,
                                           unsigned active,
                                           i64 (&out)[RPT]) {
  if (dense) {
    const V* s = (const V*)region;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      out[r] = (active >> r) & 1u ? (i64)s[k0 + r * T] : 0;
    return;
  }
  u64 src, ci, ce;
  ring_interior((u64)ptr, (int)sizeof(V), p.a0, p.n, src, ci, ce);
  const int k_lo = (int)((ci - src) / sizeof(V));
  const int k_hi = ce > ci ? (int)((ce - src) / sizeof(V)) : k_lo;
  const V* s = (const V*)(region + (src & 15u));
  const V* g = (const V*)ptr + p.a0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int k = k0 + r * T;
    out[r] = !((active >> r) & 1u) ? 0
             : k >= k_lo && k < k_hi ? (i64)s[k] : (i64)__ldg(g + k);
  }
}

// Per-thread interpreter state.  The value stack lives in shared memory as
// [slot][row][T] (thread tid owns slot * RPT * T + row * T + tid), the
// null flags as one RPT-bit mask per slot, so nothing spills to local
// memory.
struct Tile {
  const i64* plan;
  const i64* cols;       // column table (COL_WORDS per column)
  const i64* params;
  // the stage ring (S = 2): each column's region offset in a stage (-1:
  // not staged), the current pass's stage, the stage's rows and the stage
  // row of the thread's row 0
  const i64* stab;
  const unsigned char* stage;
  const StagePos* pos;
  int k0;
  i64* stk;              // value stack, depth x RPT x T
  unsigned* nulls;       // null masks, depth x T
  // per probe step j: each row's build row (j x RPT x T), the hit mask
  // and the semi marker's null mask (j x T)
  int* jrow;
  unsigned* jhit;
  unsigned* jnul;
  int T, tid;
  i64 row0;              // absolute row of this thread's row 0
};

// Per-row loads of one array, all issued before any is used: the RPT
// rows' HBM latencies overlap instead of adding up.
template <typename V>
__device__ __forceinline__ void load_rows(i64 ptr, i64 row0, int T,
                                          unsigned active, i64 (&out)[RPT]) {
  const V* p = (const V*)ptr;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    out[r] = (active >> r) & 1u ? (i64)__ldg(p + row0 + r * T) : 0;
}

// A dictionary's values at the rows' codes (x[r] holds the code on entry):
// a gather through the cache-resident values array.
template <typename V>
__device__ __forceinline__ void dict_values(i64 vals, unsigned active,
                                            i64 (&x)[RPT]) {
  const V* p = (const V*)vals;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    x[r] = (active >> r) & 1u ? (i64)__ldg(p + x[r]) : 0;
}

// An RLE column's values at rows row0 + r * T: a binary search per row.
template <typename V>
__device__ __forceinline__ void rle_rows(i64 vals, i64 starts, i64 n,
                                         i64 row0, int T, unsigned active,
                                         i64 (&out)[RPT]) {
  const V* p = (const V*)vals;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    out[r] = (active >> r) & 1u
                 ? (i64)p[rle_run((const i64*)starts, n, row0 + r * T)]
                 : 0;
}

// Decode column `cm` at rows row0 + r * T (r < RPT, live in `active`) into
// dst[r * T]: the per-row array (plain values or dict codes) is loaded for
// all rows first -- from the stage region `sb` (stage rows k0 + r * T of
// the stage `pos`) when the column is staged, else from device memory
// --, then dict codes
// gather through the (cache-resident) values; RLE runs its binary search
// per row.
__device__ __forceinline__ void load_column(const i64* cm, i64 row0, int T,
                                            unsigned active, i64* dst,
                                            const unsigned char* sb,
                                            const StagePos* pos, int k0) {
  const int kind = (int)cm[0], dt = (int)cm[1];
  i64 raw[RPT];
  if (kind == K_RLE) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      dst[r * T] = (active >> r) & 1u ? decode(cm, row0 + r * T) : 0;
    return;
  }
  if (sb != nullptr) {
#define STAGE_ROWS(V) \
  stage_rows<V>(sb, cm[2], *pos, pos->dense, k0, T, active, raw)
    switch (dt) {
      case DT_I8: STAGE_ROWS(int8_t); break;
      case DT_I16: STAGE_ROWS(int16_t); break;
      case DT_I32: STAGE_ROWS(int32_t); break;
      case DT_BOOL: STAGE_ROWS(uint8_t); break;
      default: STAGE_ROWS(i64); break;
    }
#undef STAGE_ROWS
  } else {
    switch (dt) {
      case DT_I8: load_rows<int8_t>(cm[2], row0, T, active, raw); break;
      case DT_I16: load_rows<int16_t>(cm[2], row0, T, active, raw); break;
      case DT_I32: load_rows<int32_t>(cm[2], row0, T, active, raw); break;
      case DT_BOOL: load_rows<uint8_t>(cm[2], row0, T, active, raw); break;
      default: load_rows<i64>(cm[2], row0, T, active, raw); break;
    }
  }
  if (kind == K_PLAIN) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) dst[r * T] = raw[r];
    return;
  }
  const int vdt = (int)cm[3];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    dst[r * T] = (active >> r) & 1u ? load_bits(cm[4], raw[r], vdt) : 0;
}

// The stage region of column `arg` in the current tile's stage when the
// column is staged, else nullptr.
template <int S>
__device__ __forceinline__ const unsigned char* staged_base(const Tile& t,
                                                            i64 arg) {
  if (S < 2 || t.stab[arg] < 0) return nullptr;
  return t.stage + t.stab[arg];
}

// A gathered build column's values at the rows' build rows row[r] (rows
// in `active`); returns their null mask: the build column's NULL flags
// (gn, or none) and, for a LEFT join (left_nulls), the misses.
template <typename V>
__device__ __forceinline__ unsigned gather_rows(i64 vals, const uint8_t* gn,
                                                const int (&row)[RPT],
                                                unsigned active, unsigned hit,
                                                bool left_nulls,
                                                i64 (&out)[RPT]) {
  const V* p = (const V*)vals;
  unsigned nulls = left_nulls ? ~hit & ((1u << RPT) - 1) : 0u;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!((active >> r) & 1u)) {
      out[r] = 0;
      continue;
    }
    out[r] = (i64)__ldg(p + row[r]);
    if (gn != nullptr && gn[row[r]]) nulls |= 1u << r;
  }
  return nulls;
}

// A probe step's virtual column `cm` for the rows in `active` into
// dst[r * T]: a gathered build column reads its values (and NULL flags) at
// the rows' build rows, NULL on a LEFT join's misses; a semi marker is the
// hit bit.  Returns the rows' null mask.
__device__ __forceinline__ unsigned load_joined(const Tile& t, const i64* cm,
                                                unsigned active, i64* dst) {
  const int T = t.T, j = (int)cm[3];
  const unsigned hit = t.jhit[j * T + t.tid];
  if (cm[0] == K_SEMI) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) dst[r * T] = (hit >> r) & 1u;
    return t.jnul[j * T + t.tid];
  }
  int row[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) row[r] = t.jrow[(j * RPT + r) * T + t.tid];
  const uint8_t* gn = (const uint8_t*)cm[4];
  const bool left = cm[5] != 0;
  i64 out[RPT];
  unsigned nulls;
  switch ((int)cm[1]) {
    case DT_I8: nulls = gather_rows<int8_t>(cm[2], gn, row, active, hit, left, out); break;
    case DT_I16: nulls = gather_rows<int16_t>(cm[2], gn, row, active, hit, left, out); break;
    case DT_I32: nulls = gather_rows<int32_t>(cm[2], gn, row, active, hit, left, out); break;
    case DT_BOOL: nulls = gather_rows<uint8_t>(cm[2], gn, row, active, hit, left, out); break;
    default: nulls = gather_rows<i64>(cm[2], gn, row, active, hit, left, out); break;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) dst[r * T] = out[r];
  return nulls;
}

// The opcodes beyond the TPC-H Q1 / Q6 set (negate, abs, date parts, the
// double multiply and round, divide and modulus, IS_NULL, IF, COALESCE,
// NULL_IF, IN), out of line: their temporaries (64-bit divisions, the
// civil calendar) stay out of the interpreter loop's registers.  `sv` is
// the thread's stack (slot k row r at sv[(k * RPT + r) * T]), `nb` its
// null masks (slot k at nb[k * T]), `lits` the arguments of the LIT
// instructions after an IN (stride 2).  Returns the new stack depth.
static __device__ __noinline__ int eval_ext(int op, i64 arg, const i64* lits,
                                     i64* sv, unsigned* nb, int sp, int T) {
  const int RT = RPT * T;
  i64* top = sv + (sp - 1) * RT;
  unsigned* n1 = nb + (sp - 1) * T;           // the top slot's nulls
  unsigned* n2 = n1 - T;                      // the slot below it
  switch (op) {
    case OP_NEG_I: case OP_NEG_F: case OP_ABS_I: case OP_ABS_F:
    case OP_YEAR: case OP_MONTH: case OP_DAY: case OP_QUARTER:
    case OP_MULC_F: case OP_RINT_I:
      for (int r = 0; r < RPT; ++r) {
        const i64 v = top[r * T];
        i64 o;
        switch (op) {
          case OP_NEG_I: o = op_NEG_I(v); break;
          case OP_NEG_F: o = op_NEG_F(v); break;
          case OP_ABS_I: o = op_ABS_I(v); break;
          case OP_ABS_F: o = op_ABS_F(v); break;
          case OP_MULC_F: o = op_MULC_F(v, arg); break;
          case OP_RINT_I: o = op_RINT_I(v); break;
          case OP_YEAR: o = op_YEAR(v); break;
          case OP_MONTH: o = op_MONTH(v); break;
          case OP_DAY: o = op_DAY(v); break;
          default: o = op_QUARTER(v); break;
        }
        top[r * T] = o;
      }
      return sp;
    case OP_IS_NULL:
      for (int r = 0; r < RPT; ++r) top[r * T] = op_IS_NULL(*n1 >> r);
      *n1 = 0;
      return sp;
    case OP_IN_I: case OP_IN_F:         // IN over the k LIT constants
      for (int r = 0; r < RPT; ++r) {
        const i64 v = top[r * T];
        bool hit = false;
        for (int j = 0; j < (int)arg; ++j)
          hit |= op == OP_IN_I ? op_IN_I(v, lits[2 * j])
                               : op_IN_F(v, lits[2 * j]);
        top[r * T] = hit;
      }
      return sp;
    case OP_IF: {      // IF(cond, then, else)
      i64* c_ = top - 2 * RT;
      unsigned* n3 = n2 - T;
      unsigned out = 0;
      for (int r = 0; r < RPT; ++r) {
        unsigned n;
        c_[r * T] = op_IF(c_[r * T], *n3 >> r, top[r * T - RT], *n2 >> r,
                          top[r * T], *n1 >> r, n);
        out |= (n & 1u) << r;
      }
      *n3 = out;
      return sp - 2;
    }
    case OP_COALESCE: case OP_NULLIF_I: case OP_NULLIF_F: {
      unsigned out = 0;
      for (int r = 0; r < RPT; ++r) {
        const i64 a = top[r * T - RT], b = top[r * T];
        const unsigned an = *n2 >> r, bn = *n1 >> r;
        unsigned n;
        top[r * T - RT] = op == OP_COALESCE ? op_COALESCE(a, an, b, bn, n)
                          : op == OP_NULLIF_I ? op_NULLIF_I(a, an, b, bn, n)
                                              : op_NULLIF_F(a, an, b, bn, n);
        out |= (n & 1u) << r;
      }
      *n2 = out;
      return sp - 1;
    }
    case OP_DIV_F: case OP_MOD_F:
      for (int r = 0; r < RPT; ++r) {
        const i64 a = top[r * T - RT], b = top[r * T];
        top[r * T - RT] = op == OP_DIV_F ? op_DIV_F(a, b) : op_MOD_F(a, b);
      }
      *n2 |= *n1;
      return sp - 1;
    default: {  // DIV_I / MOD_I / DIVQ_I / DIVQS_I: a zero divisor divides
      unsigned zero = 0;              // by 1 and makes the row NULL
      for (int r = 0; r < RPT; ++r) {
        unsigned z;
        top[r * T - RT] = int_div_op(top[r * T - RT], top[r * T], (int)arg,
                                     op, z);
        zero |= z << r;
      }
      *n2 |= *n1 | zero;
      return sp - 1;
    }
  }
}

// The interpreter loop over the `len` instructions at p[1..]: EXT adds
// the opcodes of eval_ext.
template <int S, bool EXT>
__device__ __forceinline__ void interpret(const Tile& t, const i64* p,
                                          int len, unsigned active) {
  const int T = t.T, RT = RPT * T;
  i64* sv = t.stk + t.tid;
  unsigned* nb = t.nulls + t.tid;
  int sp = 0;
  for (int i = 0; i < len; ++i) {
    const int op = (int)p[1 + 2 * i];
    const i64 arg = p[2 + 2 * i];
    i64* push = sv + sp * RT;          // the slot a push writes
    i64* top = push - RT;              // the slot on top of the stack
    switch (op) {
      case OP_COL: {
        const i64* cm = t.cols + COL_WORDS * arg;
        if (cm[0] >= K_GATHER) {
          nb[sp * T] = load_joined(t, cm, active, push);
        } else {                          // resident columns hold no NULLs
          load_column(cm, t.row0, T, active, push, staged_base<S>(t, arg),
                      t.pos, t.k0);
          nb[sp * T] = 0;
        }
        ++sp;
        break;
      }
      case OP_CONST_I: case OP_CONST_F: case OP_NULL_I: case OP_NULL_F:
      case OP_PARAM_I: case OP_PARAM_F: {
        const bool null = op == OP_NULL_I || op == OP_NULL_F;
        const i64 v = op == OP_PARAM_I || op == OP_PARAM_F ? t.params[arg]
                      : null ? (op == OP_NULL_F ? as_b(0.0) : 0) : arg;
#pragma unroll
        for (int r = 0; r < RPT; ++r) push[r * T] = v;
        nb[sp * T] = null ? (1u << RPT) - 1 : 0;
        ++sp;
        break;
      }
// one loop over the RPT rows per instruction: the switch is taken once
#define UNARY(OPC, EXPR)                                              \
      case OPC:                                                       \
        _Pragma("unroll") for (int r = 0; r < RPT; ++r) {             \
          const i64 v = top[r * T];                                   \
          top[r * T] = (EXPR);                                        \
        }                                                             \
        break;
#define BINARY(OPC, EXPR)                                             \
      case OPC:                                                       \
        _Pragma("unroll") for (int r = 0; r < RPT; ++r) {             \
          const i64 a = top[r * T - RT], b = top[r * T];              \
          top[r * T - RT] = (EXPR);                                   \
        }                                                             \
        nb[(sp - 2) * T] |= nb[(sp - 1) * T];                         \
        --sp;                                                         \
        break;
      UNARY(OP_MULC_I, op_MULC_I(v, arg))
      UNARY(OP_DIVR_I, op_DIVR_I(v, arg))
      UNARY(OP_I2F, op_I2F(v))
      UNARY(OP_DIVC_F, op_DIVC_F(v, arg))
      UNARY(OP_WRAP32, op_WRAP32(v))
      UNARY(OP_NOT, op_NOT(v))
      BINARY(OP_ADD_I, op_ADD_I(a, b))
      BINARY(OP_SUB_I, op_SUB_I(a, b))
      BINARY(OP_MUL_I, op_MUL_I(a, b))
      BINARY(OP_ADD_F, op_ADD_F(a, b))
      BINARY(OP_SUB_F, op_SUB_F(a, b))
      BINARY(OP_MUL_F, op_MUL_F(a, b))
      BINARY(OP_LT_I, op_LT_I(a, b))
      BINARY(OP_LTE_I, op_LTE_I(a, b))
      BINARY(OP_GT_I, op_GT_I(a, b))
      BINARY(OP_GTE_I, op_GTE_I(a, b))
      BINARY(OP_EQ_I, op_EQ_I(a, b))
      BINARY(OP_NEQ_I, op_NEQ_I(a, b))
      BINARY(OP_LT_F, op_LT_F(a, b))
      BINARY(OP_LTE_F, op_LTE_F(a, b))
      BINARY(OP_GT_F, op_GT_F(a, b))
      BINARY(OP_GTE_F, op_GTE_F(a, b))
      BINARY(OP_EQ_F, op_EQ_F(a, b))
      BINARY(OP_NEQ_F, op_NEQ_F(a, b))
#undef UNARY
#undef BINARY
      case OP_AND: case OP_OR: {          // Kleene logic
        i64* a_ = top - RT;
        const unsigned bn = nb[(sp - 1) * T], an = nb[(sp - 2) * T];
        unsigned av = 0, bv = 0;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          av |= (unsigned)(a_[r * T] != 0) << r;
          bv |= (unsigned)(top[r * T] != 0) << r;
        }
        unsigned n;
        const unsigned v = op == OP_AND ? op_AND(av, an, bv, bn, n)
                                        : op_OR(av, an, bv, bn, n);
#pragma unroll
        for (int r = 0; r < RPT; ++r) a_[r * T] = (v >> r) & 1u;
        nb[(sp - 2) * T] = n & ((1u << RPT) - 1);
        --sp;
        break;
      }
      default:                            // the forms beyond Q1 / Q6
        if (EXT) {
          sp = eval_ext(op, arg, p + 2 + 2 * (i + 1), sv, nb, sp, T);
          if (op == OP_IN_I || op == OP_IN_F) i += (int)arg;
        }
        break;
    }
  }
}

// By value: a reference would put the caller's Tile in local memory for
// the whole kernel.
// Interpret the program at plan[off] for the rows in `active` (bit r: row
// row0 + r * T); the result is left in stack slot 0.  X: the kernel
// instance for plans that use an opcode beyond the TPC-H Q1 / Q6 set
// (ScanPlan.ext); the other instances keep that set's loop and registers.
template <int S, bool X>
__device__ __forceinline__ void eval_prog(const Tile& t, i64 off,
                                          unsigned active) {
  const i64* p = t.plan + off;
  interpret<S, X>(t, p, (int)p[0], active);
}

// value of row r in stack slot 0 after eval_prog
__device__ __forceinline__ i64 result(const Tile& t, int r) {
  return t.stk[r * t.T + t.tid];
}
__device__ __forceinline__ unsigned result_nulls(const Tile& t) {
  return t.nulls[t.tid];
}

// Kernel #5: the fanout-1 join / semi-join probe of the thread's rows in
// `live` against the build table of record `jr` (probe step j).  Replaces
// the reference's in-kernel probe, presto_tpu/exec/kernels/join.py
// _make_applier (:191) / join_appliers (:268), and computes what that
// applier -- and its plain version here, exec/kernels/join.py -- computes:
//   direct  k = key - base, in bounds, one int32 slot load; a hit is a
//           slot >= 0 and a non-NULL key, its build row the slot.
//   unique  the keys hashed as hash_columns does (hash_mix), the sign bit
//           flipped, then searchsorted(keyhash_sorted, kh, side="left")
//           through the table's bucket directory (probe_unique); a hit is
//           an equal HASH (the reference's match rule) with no NULL key,
//           its build row perm[lo].
// INNER drops the misses from `live`; LEFT keeps them (load_joined reads
// their gathered columns as NULL); a semi step records its marker's null
// mask, (miss and build-had-NULL) or NULL probe key.  Build operands stay
// in device memory: at most 4 MiB (the reference's gate), so they sit in
// the 50 MB L2 and a plain gather serves.  The rows' loads are issued
// together, as in load_rows.
//
// The two table lookups are shared with the direct and span kernels
// generated per chain (exec/kernels/codegen.py), which compute the probe
// keys themselves.
// probe_direct: the rows' key values key[r] (NULL in knull) against a
// DirectTable (int32 slots, base key at *base_p, `size` slots); returns
// the hit mask and each hit's build row in row[r] (0 for a miss).
__device__ __forceinline__ unsigned probe_direct(const i64 (&key)[RPT],
                                                 unsigned knull,
                                                 unsigned live,
                                                 const int32_t* slots,
                                                 const i64* base_p, i64 size,
                                                 int (&row)[RPT]) {
  const i64 base = __ldg(base_p);
  int s[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const i64 k = (i64)((u64)key[r] - (u64)base);
    s[r] = ((live >> r) & 1u) && k >= 0 && k < size ? __ldg(slots + k) : -1;
  }
  unsigned hit = 0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool found = s[r] >= 0 && !((knull >> r) & 1u);
    hit |= (unsigned)found << r;
    row[r] = found ? s[r] : 0;
  }
  return hit;
}

// probe_unique: the rows' key hashes h[r] (hash_mix from 1 over the keys)
// against a unique table (keyhash_sorted khs of n entries, perm), through
// its bucket directory `dir` (exec/kernels/join.py bucket_directory): for
// k = 64 - shift, dir[b] is the lower bound in khs of the first orderable
// hash whose unsigned top k bits are b, and dir[2^k] = n.  Every khs
// entry before dir[b] is below the bucket, every entry from dir[b + 1] on
// above it, so the lower bound of a hash in bucket b lies in
// [dir[b], dir[b + 1]]: the bisect inside that range gives the reference's
// searchsorted(side="left") index by construction.  Buckets hold 0-2
// entries on average (2^k > 2n); the bisect is still needed for the last
// bucket, which holds the dead padding rows (INT64_MAX).  Then the
// reference's clip to [0, n - 1], hash compare and perm[lo].  A hash in
// an empty bucket never hits (the clipped entry lies outside the bucket),
// so only a non-empty bucket loads the entry it compares.  Indices are
// 32-bit (perm is int32).  Returns the hit mask and build rows.
__device__ __forceinline__ unsigned probe_unique(const u64 (&h)[RPT],
                                                 unsigned knull,
                                                 unsigned live,
                                                 const i64* khs,
                                                 const int32_t* perm, i64 n,
                                                 const int32_t* dir,
                                                 int shift, int (&row)[RPT]) {
  i64 kh[RPT];
  int lo[RPT], hi[RPT];
  unsigned filled = 0;                 // rows whose bucket holds entries
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    kh[r] = (i64)(h[r] ^ 0x8000000000000000ULL);
    const bool on = (live >> r) & 1u;
    const int b = on ? (int)(h[r] >> shift) : 0;
    lo[r] = on ? __ldg(dir + b) : 0;
    hi[r] = on ? __ldg(dir + b + 1) : 0;
    filled |= (unsigned)(lo[r] < hi[r]) << r;
  }
  // the rows bisect together, their loads issued before any compare
  for (;;) {
    int mid[RPT];
    i64 v[RPT];
    bool more = false;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      mid[r] = (lo[r] + hi[r]) >> 1;
      v[r] = 0;
      if (lo[r] < hi[r]) {
        v[r] = __ldg(khs + mid[r]);
        more = true;
      }
    }
    if (!more) break;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (lo[r] >= hi[r]) continue;
      if (v[r] < kh[r]) lo[r] = mid[r] + 1; else hi[r] = mid[r];
    }
  }
  unsigned hit = 0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const i64 p = lo[r] < n - 1 ? lo[r] : n - 1;
    const bool found = ((filled >> r) & 1u) && !((knull >> r) & 1u) &&
                       __ldg(khs + p) == kh[r];
    hit |= (unsigned)found << r;
    row[r] = found ? __ldg(perm + p) : 0;
  }
  return hit;
}

// A semi marker's null mask: a miss against a build side that held a NULL
// key, or a NULL probe key.
__device__ __forceinline__ unsigned semi_nulls(unsigned hit, unsigned knull,
                                               const uint8_t* bhn) {
  return ((*bhn != 0 ? ~hit : 0u) | knull) & ((1u << RPT) - 1);
}

template <int S, bool X>
__device__ unsigned probe_step(const Tile& t, const i64* jr, int j,
                               unsigned live) {
  const int T = t.T, tid = t.tid;
  const i64* kofs = t.plan + jr[J_KEYS_OFF];
  unsigned hit, knull = 0;
  int row[RPT];
  if (jr[J_TABLE] == TBL_DIRECT) {
    eval_prog<S, X>(t, kofs[0], live);
    knull = result_nulls(t);
    i64 key[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) key[r] = result(t, r);
    hit = probe_direct(key, knull, live, (const int32_t*)jr[J_OP0],
                       (const i64*)jr[J_OP1], jr[J_SIZE], row);
  } else {
    u64 h[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) h[r] = 1ULL;      // salt 0, plus one
    const int n_keys = (int)jr[J_N_KEYS];
    for (int k = 0; k < n_keys; ++k) {
      eval_prog<S, X>(t, kofs[k], live);
      const unsigned nm = result_nulls(t);
      knull |= nm;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        h[r] = hash_mix(h[r], result(t, r), (nm >> r) & 1u);
    }
    hit = probe_unique(h, knull, live, (const i64*)jr[J_OP0],
                       (const int32_t*)jr[J_OP1], jr[J_SIZE],
                       (const int32_t*)jr[J_DIR], (int)jr[J_DIR_SHIFT], row);
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) t.jrow[(j * RPT + r) * T + tid] = row[r];
  t.jhit[j * T + tid] = hit;
  const int form = (int)jr[J_FORM];
  if (form == FORM_SEMI) {
    t.jnul[j * T + tid] = semi_nulls(hit, knull, (const uint8_t*)jr[J_BHN]);
    return live;
  }
  return form == FORM_INNER ? live & hit : live;
}

// The chain's steps for the thread's rows in `live`: a filter keeps its
// TRUE rows, a probe step (step word -2 - j) runs probe_step.  Each step's
// live rows count into cnt[(s + 1) * T + tid].  Returns the rows live after
// the last step.
template <int S, bool X>
__device__ unsigned run_steps(const Tile& t, int n_steps, unsigned live,
                              i64* cnt) {
  const i64* steps = t.plan + t.plan[H_OFF_STEPS];
  const i64* joins = t.plan + t.plan[H_OFF_JOINS];
  for (int s = 0; s < n_steps; ++s) {
    const i64 w = steps[s];
    if (live && w >= 0) {
      eval_prog<S, X>(t, w, live);
      unsigned ok = 0;
#pragma unroll
      for (int r = 0; r < RPT; ++r) ok |= (unsigned)(result(t, r) != 0) << r;
      live &= ok & ~result_nulls(t);
    } else if (live && w <= -2) {
      const int j = (int)(-2 - w);
      live = probe_step<S, X>(t, joins + JOIN_WORDS * j, j, live);
    }
    cnt[(s + 1) * t.T + t.tid] += __popc(live);
  }
  return live;
}

// float min/max that propagates NaN like jnp.minimum / jnp.maximum
__device__ __forceinline__ double fcombine(double acc, double x, int op) {
  if (op == R_ADD) return __dadd_rn(acc, x);
  if (x != x || acc != acc) return x != x ? x : acc;
  if (op == R_MIN) return x < acc ? x : acc;
  return x > acc ? x : acc;
}

__device__ __forceinline__ i64 icombine(i64 acc, i64 x, int op) {
  if (op == R_ADD) return (i64)((u64)acc + (u64)x);
  if (op == R_MIN) return x < acc ? x : acc;
  return x > acc ? x : acc;
}

#define FULL_MASK 0xffffffffu
#define I64_MAX 0x7fffffffffffffffLL
#define I64_MIN (-I64_MAX - 1)

// Fold each lane's rows in `take` (RPT bits; row r has group code[r]) into
// dst[code]: one round per distinct code among the warp's rows -- the
// lane's own rows fold in registers, a butterfly folds the warp, and one
// lane issues one atomic (dst in shared or global memory).  count: add the
// number of rows; otherwise fold the rows' values (stack slot 0) with op.
// Every lane of the warp must call it (it synchronizes the warp).
__device__ __forceinline__ void warp_fold(unsigned take,
                                          const i64 (&code)[RPT],
                                          const Tile& t, bool count, int op,
                                          bool in_float, i64* dst) {
  const int lane = threadIdx.x & 31;
  unsigned pending = take;
  for (;;) {
    const unsigned lanes = __ballot_sync(FULL_MASK, pending != 0);
    if (!lanes) break;
    const int src = __ffs(lanes) - 1;
    const int first = __ffs(pending) - 1;        // -1: no pending row
    i64 mine = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) if (r == first) mine = code[r];
    const i64 c = __shfl_sync(FULL_MASK, mine, src);
    unsigned sel = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (((pending >> r) & 1u) && code[r] == c) sel |= 1u << r;
    pending &= ~sel;
    if (count) {
      const unsigned n = __reduce_add_sync(FULL_MASK, __popc(sel));
      if (lane == src) atomicAdd((u64*)&dst[c], (u64)n);
      continue;
    }
    i64 part = op == R_MIN ? I64_MAX : op == R_MAX ? I64_MIN : 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if ((sel >> r) & 1u) {
        const i64 x = result(t, r);
        part = icombine(part, in_float ? (i64)as_f(x) : x, op);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part = icombine(part, __shfl_xor_sync(FULL_MASK, part, o), op);
    if (lane == src) {
      if (op == R_MIN) atomicMin(&dst[c], part);
      else if (op == R_MAX) atomicMax(&dst[c], part);
      else atomicAdd((u64*)&dst[c], (u64)part);
    }
  }
}

// ---------------------------------------------------------------------------
// The grouped kernels' folds and reduce: shared by the hash kernel
// (scan_grouped.cu) and the span kernel generated per chain (codegen.py).
// ---------------------------------------------------------------------------

// the reduce: 32 slots x REDUCE_LANES partial sequences per block
#define REDUCE_LANES 8

// On chip: an int64 add into shared memory as two native 32-bit atomics
// (a 64-bit shared-memory add is a compare-and-swap loop): the low words
// add, the add that wraps them carries one into the high word with its
// own high half.  The sum is exact modulo 2^64, like the int64 add.
__device__ __forceinline__ void shared_add64(i64* p, i64 v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  const unsigned lo = (unsigned)(u64)v;
  unsigned old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;"
               : "=r"(old) : "r"(a), "r"(lo) : "memory");
  const unsigned hi = (unsigned)((u64)v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) asm volatile("red.shared.add.u32 [%0], %1;"
                       :: "r"(a + 4), "r"(hi) : "memory");
}

// Row r's value bits of an aggregate input: the generated kernels' value
// array, or the interpreter's stack slot 0 (read where it is used).
__device__ __forceinline__ i64 value_at(const i64 (&x)[RPT], int r) {
  return x[r];
}
__device__ __forceinline__ i64 value_at(const Tile& t, int r) {
  return result(t, r);
}

// A warp's float rows, staged per row position: for each r, the lanes
// holding rows of one slot fold their values value_at(x, r) (float64
// bits, or integers when !in_float) in lane order (a __match_any_sync
// group; a lane alone keeps its own value) and the group's lowest lane
// leaves (slot, value) in sc[r * 32 + lane], sv[r * 32 + lane]; every
// other entry gets slot -1.  Within one r the staged slots are distinct.
// The order depends only on which rows each lane holds, so it is the same
// on every launch.
template <typename X>
__device__ __forceinline__ void warp_stage_float(unsigned take,
                                                const i64 (&code)[RPT],
                                                const X& x, int op,
                                                bool in_float, i64* sc,
                                                double* sv) {
  const int lane = threadIdx.x & 31;
  const double ident = op == R_MIN ? as_f(0x7ff0000000000000LL)
                       : op == R_MAX ? as_f((i64)0xfff0000000000000ULL)
                       : 0.0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool mine = (take >> r) & 1u;
    const i64 xb = value_at(x, r);
    const double xv = !mine ? ident : in_float ? as_f(xb) : (double)xb;
    const unsigned peers = __match_any_sync(FULL_MASK, mine ? code[r] : -1);
    // lanes whose slot other lanes share fold the group in lane order
    const unsigned shared = __ballot_sync(FULL_MASK,
                                          mine && (peers & (peers - 1)));
    double sum = (shared >> lane) & 1u ? ident : xv;
    for (unsigned m = shared; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const double y = __shfl_sync(FULL_MASK, xv, k);
      if ((shared >> lane) & 1u && (peers >> k) & 1u)
        sum = fcombine(sum, y, op);
    }
    const bool leader = mine && __ffs(peers) - 1 == lane;
    sc[r * 32 + lane] = leader ? code[r] : -1;
    sv[r * 32 + lane] = sum;
  }
  __syncwarp();
}

// Fold float rows staged by every warp (sc / sv: per warp RPT x 32
// (slot, value) pairs, distinct slots within one warp and row position)
// into the CTA's table `dst`, in (warp, row position) order.  Warp w
// applies the slots = w mod warps; __syncwarp orders its positions.  The
// caller's __syncthreads precede and follow it.
__device__ __forceinline__ void apply_staged(const i64* sc, const double* sv,
                                             int n_warps, int op,
                                             double* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < n_warps * RPT; ++k) {
    const i64 c = sc[k * 32 + lane];
    if (c >= 0 && (int)c % n_warps == warp)
      dst[c] = fcombine(dst[c], sv[k * 32 + lane], op);
    __syncwarp();
  }
}

// The grouped kernels' final accumulators, one block of (32, REDUCE_LANES)
// threads per (32 slots, accumulator row blockIdx.y: the n_i integer rows,
// then the n_f float rows).  Thread (x, y) folds the slot's partials b =
// y, y + REDUCE_LANES, ... in order from the row op's identity, the
// REDUCE_LANES sequences combine as a pairwise tree, and the row's initial
// value comes first (exec/kernels/grouped.py reduce_partials).  rows:
// (init bits, op) per row; src: the row each integer row is copied from
// (itself when the kernel folds it).  An integer row's partials are
// part_i's (n_iparts x n_fold x G, at the row's fold position), or none
// (part_i null): its atomic sums are in acc_i already.  A row standing for
// __seen folds (or copies) __seen's.  Float partials: n_fparts x n_f x G.
__device__ __forceinline__ void grouped_reduce(
    const i64* rows, const i64* src, int n_i, int n_f, i64 G, int n_iparts,
    int n_fparts, const i64* __restrict__ part_i, i64* __restrict__ acc_i,
    const double* __restrict__ part_f, double* __restrict__ acc_f) {
  __shared__ i64 red[REDUCE_LANES][32];
  const int row = blockIdx.y, x = threadIdx.x, y = threadIdx.y;
  const i64 g = (i64)blockIdx.x * 32 + x;
  const bool in = g < G;
  if (row < n_i) {
    const int sr = (int)src[row];
    if (part_i == nullptr) {                 // block-uniform
      if (y == 0 && in && sr != row) acc_i[row * G + g] = acc_i[sr * G + g];
      return;
    }
    int q = 0, n_fold = 0;                   // sr's fold position
    for (int r = 0; r < n_i; ++r) {
      q += r < sr && src[r] == r;
      n_fold += src[r] == r;
    }
    const int op = (int)rows[2 * sr + 1];
    i64 acc = op == R_MIN ? I64_MAX : op == R_MAX ? I64_MIN : 0;
    if (in)
      for (int b = y; b < n_iparts; b += REDUCE_LANES)
        acc = icombine(acc, part_i[((size_t)b * n_fold + q) * G + g], op);
    red[y][x] = acc;
    for (int w = 1; w < REDUCE_LANES; w <<= 1) {
      __syncthreads();
      if ((y & (2 * w - 1)) == 0)
        red[y][x] = icombine(red[y][x], red[y + w][x], op);
    }
    if (y == 0 && in)
      acc_i[row * G + g] = icombine(rows[2 * sr], red[0][x], op);
    return;
  }
  const int fr = row - n_i;
  if (fr >= n_f) return;
  const int op = (int)rows[2 * (n_i + fr) + 1];
  double acc = op == R_MIN ? as_f(0x7ff0000000000000LL)
               : op == R_MAX ? as_f((i64)0xfff0000000000000ULL) : 0.0;
  if (in)
    for (int b = y; b < n_fparts; b += REDUCE_LANES)
      acc = fcombine(acc, part_f[((size_t)b * n_f + fr) * G + g], op);
  double* fred = (double*)&red[0][0];
  fred[y * 32 + x] = acc;
  for (int w = 1; w < REDUCE_LANES; w <<= 1) {
    __syncthreads();
    if ((y & (2 * w - 1)) == 0)
      fred[y * 32 + x] = fcombine(fred[y * 32 + x], fred[(y + w) * 32 + x],
                                  op);
  }
  if (y == 0 && in)
    acc_f[fr * G + g] = fcombine(as_f(rows[2 * (n_i + fr)]), fred[x], op);
}
