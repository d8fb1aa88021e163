// Shared by the fused scan kernels (scan_direct.cu, scan_grouped.cu): the
// plan vector's layout, column decode and the ExprProgram interpreter, so
// every kernel runs one expression semantics -- the torch evaluator's
// (exec/lowering.py ExprProgram.run) --, the chain's steps with the join
// probe (kernel #5, probe_step below), and the warp-level fold of integer
// rows into accumulators.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

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
enum { JOIN_WORDS = 9 };
enum { J_TABLE = 0, J_FORM, J_N_KEYS, J_KEYS_OFF, J_OP0, J_OP1, J_SIZE,
       J_BHN, J_TRIPS };
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

// logical value (int64, or float64 bits) of column `c` at absolute row `a`
__device__ i64 decode(const i64* cm, i64 a) {
  const int kind = (int)cm[0];
  if (kind == K_PLAIN) return load_bits(cm[2], a, (int)cm[1]);
  if (kind == K_DICT) {
    const i64 code = load_bits(cm[2], a, (int)cm[1]);
    return load_bits(cm[4], code, (int)cm[3]);
  }
  // RLE: searchsorted(run_starts, a, side="right") - 1, clipped
  const i64* starts = (const i64*)cm[4];
  const i64 n = cm[5];
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (starts[mid] <= a) lo = mid + 1; else hi = mid;
  }
  i64 ri = lo - 1;
  ri = ri < 0 ? 0 : (ri > n - 1 ? n - 1 : ri);
  return load_bits(cm[2], ri, (int)cm[1]);
}

__device__ __forceinline__ i64 div_round_half_up(i64 v, i64 d) {
  const u64 mag = v < 0 ? 0ULL - (u64)v : (u64)v;
  const i64 q = (i64)((mag + (u64)(d / 2)) / (u64)d);
  return v < 0 ? -q : (v > 0 ? q : 0);
}

// Rows a thread carries through one pass of the interpreter: every
// instruction is fetched and dispatched once for RPT rows, whose values sit
// side by side in the thread's stack slots.
#define RPT 4

// Per-thread interpreter state.  The value stack lives in shared memory as
// [slot][row][T] (thread tid owns slot * RPT * T + row * T + tid), the
// null flags as one RPT-bit mask per slot, so nothing spills to local
// memory.
struct Tile {
  const i64* plan;
  const i64* cols;       // column table (COL_WORDS per column)
  const i64* params;
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

// Decode column `cm` at rows row0 + r * T (r < RPT, live in `active`) into
// dst[r * T]: the per-row array (plain values or dict codes) is loaded for
// all rows first, then dict codes gather through the (cache-resident)
// values; RLE runs its binary search per row.
__device__ __forceinline__ void load_column(const i64* cm, i64 row0, int T,
                                            unsigned active, i64* dst) {
  const int kind = (int)cm[0], dt = (int)cm[1];
  i64 raw[RPT];
  if (kind == K_RLE) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      dst[r * T] = (active >> r) & 1u ? decode(cm, row0 + r * T) : 0;
    return;
  }
  switch (dt) {
    case DT_I8: load_rows<int8_t>(cm[2], row0, T, active, raw); break;
    case DT_I16: load_rows<int16_t>(cm[2], row0, T, active, raw); break;
    case DT_I32: load_rows<int32_t>(cm[2], row0, T, active, raw); break;
    case DT_BOOL: load_rows<uint8_t>(cm[2], row0, T, active, raw); break;
    default: load_rows<i64>(cm[2], row0, T, active, raw); break;
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
  const int* rows = t.jrow + j * RPT * T + t.tid;
  const int dt = (int)cm[1];
  const uint8_t* gn = (const uint8_t*)cm[4];
  unsigned nulls = cm[5] ? ~hit & ((1u << RPT) - 1) : 0u;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!((active >> r) & 1u)) {
      dst[r * T] = 0;
      continue;
    }
    const int b = rows[r * T];
    dst[r * T] = load_bits(cm[2], b, dt);
    if (gn != nullptr && gn[b]) nulls |= 1u << r;
  }
  return nulls;
}

// Interpret the program at plan[off] for the rows in `active` (bit r: row
// row0 + r * T); the result is left in stack slot 0.
__device__ void eval_prog(const Tile& t, i64 off, unsigned active) {
  const i64* p = t.plan + off;
  const int len = (int)p[0];
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
          load_column(cm, t.row0, T, active, push);
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
      UNARY(OP_MULC_I, (i64)((u64)v * (u64)arg))
      UNARY(OP_DIVR_I, div_round_half_up(v, arg))
      UNARY(OP_I2F, as_b((double)v))
      UNARY(OP_DIVC_F, as_b(__ddiv_rn(as_f(v), as_f(arg))))
      UNARY(OP_WRAP32, (i64)(int32_t)(uint32_t)(u64)v)
      UNARY(OP_NOT, (i64)(v == 0))
      BINARY(OP_ADD_I, (i64)((u64)a + (u64)b))
      BINARY(OP_SUB_I, (i64)((u64)a - (u64)b))
      BINARY(OP_MUL_I, (i64)((u64)a * (u64)b))
      BINARY(OP_ADD_F, as_b(__dadd_rn(as_f(a), as_f(b))))
      BINARY(OP_SUB_F, as_b(__dsub_rn(as_f(a), as_f(b))))
      BINARY(OP_MUL_F, as_b(__dmul_rn(as_f(a), as_f(b))))
      BINARY(OP_LT_I, (i64)(a < b))
      BINARY(OP_LTE_I, (i64)(a <= b))
      BINARY(OP_GT_I, (i64)(a > b))
      BINARY(OP_GTE_I, (i64)(a >= b))
      BINARY(OP_EQ_I, (i64)(a == b))
      BINARY(OP_NEQ_I, (i64)(a != b))
      BINARY(OP_LT_F, (i64)(as_f(a) < as_f(b)))
      BINARY(OP_LTE_F, (i64)(as_f(a) <= as_f(b)))
      BINARY(OP_GT_F, (i64)(as_f(a) > as_f(b)))
      BINARY(OP_GTE_F, (i64)(as_f(a) >= as_f(b)))
      BINARY(OP_EQ_F, (i64)(as_f(a) == as_f(b)))
      BINARY(OP_NEQ_F, (i64)(as_f(a) != as_f(b)))
#undef UNARY
#undef BINARY
      default: {                          // OP_AND / OP_OR, Kleene logic
        i64* a_ = top - RT;
        const unsigned bn = nb[(sp - 1) * T], an = nb[(sp - 2) * T];
        unsigned av = 0, bv = 0;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          av |= (unsigned)(a_[r * T] != 0) << r;
          bv |= (unsigned)(top[r * T] != 0) << r;
        }
        unsigned v, n;
        if (op == OP_AND) {       // false unless no definite false
          const unsigned value = (av | an) & (bv | bn);
          n = value & (an | bn);
          v = value & ~n;
        } else {
          v = (av & ~an) | (bv & ~bn);
          n = ~v & (an | bn);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) a_[r * T] = (v >> r) & 1u;
        nb[(sp - 2) * T] = n & ((1u << RPT) - 1);
        --sp;
        break;
      }
    }
  }
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
//           flipped, then a fixed-trip lower-bound bisect of
//           keyhash_sorted; a hit is an equal HASH (the reference's match
//           rule) with no NULL key, its build row perm[lo].
// INNER drops the misses from `live`; LEFT keeps them (load_joined reads
// their gathered columns as NULL); a semi step records its marker's null
// mask, (miss and build-had-NULL) or NULL probe key.  Build operands stay
// in device memory: at most 4 MiB (the reference's gate), so they sit in
// the 50 MB L2 and a plain gather serves.  The rows' loads are issued
// together, as in load_rows.
__device__ unsigned probe_step(const Tile& t, const i64* jr, int j,
                               unsigned live) {
  const int T = t.T, tid = t.tid;
  const i64* kofs = t.plan + jr[J_KEYS_OFF];
  unsigned hit = 0, knull = 0;
  int row[RPT];
  if (jr[J_TABLE] == TBL_DIRECT) {
    eval_prog(t, kofs[0], live);
    knull = result_nulls(t);
    const int32_t* slots = (const int32_t*)jr[J_OP0];
    const i64 base = __ldg((const i64*)jr[J_OP1]);
    const i64 size = jr[J_SIZE];
    int s[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const i64 k = (i64)((u64)result(t, r) - (u64)base);
      s[r] = ((live >> r) & 1u) && k >= 0 && k < size ? __ldg(slots + k)
                                                       : -1;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const bool found = s[r] >= 0 && !((knull >> r) & 1u);
      hit |= (unsigned)found << r;
      row[r] = found ? s[r] : 0;
    }
  } else {
    u64 h[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) h[r] = 1ULL;      // salt 0, plus one
    const int n_keys = (int)jr[J_N_KEYS];
    for (int k = 0; k < n_keys; ++k) {
      eval_prog(t, kofs[k], live);
      const unsigned nm = result_nulls(t);
      knull |= nm;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        h[r] = hash_mix(h[r], result(t, r), (nm >> r) & 1u);
    }
    const i64* khs = (const i64*)jr[J_OP0];
    const int32_t* perm = (const int32_t*)jr[J_OP1];
    const i64 n = jr[J_SIZE];
    const int trips = (int)jr[J_TRIPS];
    i64 kh[RPT], lo[RPT], hi[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      kh[r] = (i64)(h[r] ^ 0x8000000000000000ULL);
      lo[r] = 0;
      hi[r] = (live >> r) & 1u ? n : 0;
    }
    for (int it = 0; it < trips; ++it) {
      i64 mid[RPT], v[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        mid[r] = (lo[r] + hi[r]) >> 1;
        v[r] = lo[r] < hi[r] ? __ldg(khs + mid[r]) : 0;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (lo[r] >= hi[r]) continue;
        if (v[r] < kh[r]) lo[r] = mid[r] + 1; else hi[r] = mid[r];
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const i64 p = lo[r] < n - 1 ? lo[r] : n - 1;
      const bool found = ((live >> r) & 1u) && !((knull >> r) & 1u) &&
                         __ldg(khs + p) == kh[r];
      hit |= (unsigned)found << r;
      row[r] = found ? __ldg(perm + p) : 0;
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) t.jrow[(j * RPT + r) * T + tid] = row[r];
  t.jhit[j * T + tid] = hit;
  const int form = (int)jr[J_FORM];
  if (form == FORM_SEMI) {
    const bool bhn = *(const uint8_t*)jr[J_BHN] != 0;
    t.jnul[j * T + tid] = ((bhn ? ~hit : 0u) | knull) & ((1u << RPT) - 1);
    return live;
  }
  return form == FORM_INNER ? live & hit : live;
}

// The chain's steps for the thread's rows in `live`: a filter keeps its
// TRUE rows, a probe step (step word -2 - j) runs probe_step.  Each step's
// live rows count into cnt[(s + 1) * T + tid].  Returns the rows live after
// the last step.
__device__ unsigned run_steps(const Tile& t, int n_steps, unsigned live,
                              i64* cnt) {
  const i64* steps = t.plan + t.plan[H_OFF_STEPS];
  const i64* joins = t.plan + t.plan[H_OFF_JOINS];
  for (int s = 0; s < n_steps; ++s) {
    const i64 w = steps[s];
    if (live && w >= 0) {
      eval_prog(t, w, live);
      unsigned ok = 0;
#pragma unroll
      for (int r = 0; r < RPT; ++r) ok |= (unsigned)(result(t, r) != 0) << r;
      live &= ok & ~result_nulls(t);
    } else if (live && w <= -2) {
      const int j = (int)(-2 - w);
      live = probe_step(t, joins + JOIN_WORDS * j, j, live);
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
