// Grouped fused scan kernel for Hopper (sm_90a): decode -> filter/project
// -> span-slot or hash-slot aggregation, in one pass over the encoded
// columns, for GROUP BYs beyond the direct kernel's 64 groups.
//
// Replaces the reference's grouped Pallas kernels in
// presto_tpu/exec/kernels/grouped.py:
// - span mode: try_grouped_scan_kernel (:213), build_direct_runner with
//   ops.agg_span_update over 8192-row subtiles (:272-278).  The combined
//   stride code of the key programs is the slot, G <= 32768.
// - hash mode: build_hash_runner (:63, launched :207), the open-addressing
//   table of ops.agg_update with its __collision flag, <= 65536 slots.
// Outputs match the plain versions (exec/kernels/grouped.py
// scan_span_plain / scan_hash_plain): integer accumulators and row
// counters exactly, float64 sums within rounding, and the hash table's
// groups keyed by their key values (its slot layout is its own).
//
// Design (a first kernel that is right and simple):
// - A persistent grid: a fixed number of CTAs (a small multiple of the
//   SMs) strides over the grid entries' rows_per_cta-row slices, so the
//   per-CTA partials scale with the CTA count, not with the table.  The
//   per-row work (decode, chain steps with their join / semi-join probes
//   -- kernel #5 --, key programs) is scan_direct's, from
//   scan_common.cuh.
// - Span slots: code = sum of key value x stride, rows off the grid drop.
// - Hash slots: each live row hashes its key values exactly as
//   exec/operators.py hash_columns(salt) does (splitmix64 over uint64),
//   then claims slot kh % S with atomicCAS(EMPTY -> kh) or finds its own
//   keyhash there, probing linearly for at most PROBE_ROUNDS slots.  The
//   claiming row writes the slot's key values and counts one group.  A
//   row left unplaced sets the collision flag; the host doubles the table
//   and relaunches.
// - Integer accumulators: into the CTA's shared accumulators when n_i x G
//   fits (span), else into the global table, with int64 add / min / max
//   atomics, which are exact and order-free.  Each row issues its own
//   atomic, except while a hash table holds fewer than SPREAD_GROUPS
//   groups: then the warp first folds its rows per slot (warp_fold: one
//   round per distinct slot) and one lane issues one atomic -- a few hot
//   global slots would otherwise serialize across the SMs.
// - Float64 accumulators: never unordered float atomics.  Each warp owns
//   a partial table in global memory.  For each of a thread's RPT row
//   positions, the lanes holding rows of one slot fold them in lane order
//   (a __match_any_sync group) into shared-memory staging, and the
//   warp's lanes apply the staged (slot, value) pairs -- distinct slots
//   within a row position -- to its table with plain loads and stores.
//   A second launch folds the warps' partials in (CTA, warp) order, so two
//   launches on the same inputs give bit-identical floats.
//
// Bound: like scan_direct, the encoded bytes of the scanned columns once
// plus the table once, over the device memory rate (3.35 TB/s on an H100
// SXM).  What bounds it in practice is the interpreter's instruction count
// per row, as in scan_direct, plus the folds; TMA staging and a compiled
// expression path are left for later work.
#include "scan_common.cuh"

enum { MODE_SPAN = 0, MODE_HASH = 1 };
#define PROBE_ROUNDS 16
#define EMPTY_SLOT 0xffffffffffffffffULL
#define REDUCE_THREADS 256
// groups a hash table must hold before its integer rows fold with one
// atomic each
#define SPREAD_GROUPS 128

// Integer rows into dst[code]: one atomic per row when `spread`, else
// warp_fold's per-slot rounds.  `spread` is warp-uniform, so warp_fold is
// entered by the whole warp.
__device__ __forceinline__ void int_fold(bool spread, unsigned take,
                                         const i64 (&code)[RPT],
                                         const Tile& t, bool count, int op,
                                         bool in_float, i64* dst) {
  if (!spread) {
    warp_fold(take, code, t, count, op, in_float, dst);
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!((take >> r) & 1u)) continue;
    i64* p = dst + code[r];
    if (count) {
      atomicAdd((u64*)p, 1ULL);
      continue;
    }
    const i64 x = result(t, r);
    const i64 v = in_float ? (i64)as_f(x) : x;
    if (op == R_MIN) atomicMin(p, v);
    else if (op == R_MAX) atomicMax(p, v);
    else atomicAdd((u64*)p, (u64)v);
  }
}

// A warp's float rows, staged per row position: for each r, the lanes
// holding rows of one slot fold them in lane order (a __match_any_sync
// group; a lane alone keeps its own value) and the group's lowest lane
// leaves (slot, value) in sc[r * 32 + lane], sv[r * 32 + lane]; every
// other entry gets slot -1.  Within one r the staged slots are distinct.
// The order depends only on which rows each lane holds, so it is the
// same on every launch.
__device__ __forceinline__ void warp_stage_float(unsigned take,
                                                const i64 (&code)[RPT],
                                                const Tile& t, int op,
                                                bool in_float, i64* sc,
                                                double* sv) {
  const int lane = threadIdx.x & 31;
  const double ident = op == R_MIN ? as_f(0x7ff0000000000000LL)
                       : op == R_MAX ? as_f((i64)0xfff0000000000000ULL)
                       : 0.0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const bool mine = (take >> r) & 1u;
    const i64 xb = result(t, r);
    const double x = !mine ? ident : in_float ? as_f(xb) : (double)xb;
    const unsigned peers = __match_any_sync(FULL_MASK, mine ? code[r] : -1);
    // lanes whose slot other lanes share fold the group in lane order
    const unsigned shared = __ballot_sync(FULL_MASK,
                                          mine && (peers & (peers - 1)));
    double sum = (shared >> lane) & 1u ? ident : x;
    for (unsigned m = shared; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const double y = __shfl_sync(FULL_MASK, x, k);
      if ((shared >> lane) & 1u && (peers >> k) & 1u)
        sum = fcombine(sum, y, op);
    }
    const bool leader = mine && __ffs(peers) - 1 == lane;
    sc[r * 32 + lane] = leader ? code[r] : -1;
    sv[r * 32 + lane] = sum;
  }
  __syncwarp();
}

// Hash the live rows' key values (stashed per thread in kst / knull) and
// place each row: its slot goes to code[r].  The rows probe in lockstep,
// their table loads issued together; a row that claims a slot counts one
// more group in meta[1].  Returns the rows placed.
__device__ unsigned probe_rows(const Tile& t, const i64* keys, int n_keys,
                               unsigned live, i64 (&code)[RPT], i64 S,
                               u64 salt, i64* kst, unsigned* knull,
                               u64* keyhash, i64* keyvals, int8_t* keynull,
                               int* meta) {
  const int T = t.T, tid = t.tid;
  u64 h[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) h[r] = salt + 1;
  for (int k = 0; k < n_keys; ++k) {
    eval_prog(t, keys[2 * k], live);
    const unsigned nm = result_nulls(t);
    knull[k * T + tid] = nm;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const i64 v = result(t, r);
      kst[(k * RPT + r) * T + tid] = v;
      h[r] = hash_mix(h[r], v, (nm >> r) & 1u);
    }
  }
  u64 s[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (h[r] == EMPTY_SLOT) h[r] = 0;            // EMPTY is reserved
    s[r] = h[r] % (u64)S;
  }
  unsigned pending = live;
  for (int round = 0; round < PROBE_ROUNDS && pending; ++round) {
    u64 cur[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      cur[r] = (pending >> r) & 1u ? __ldcg(keyhash + s[r]) : 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (!((pending >> r) & 1u)) continue;
      if (cur[r] == EMPTY_SLOT) {
        cur[r] = atomicCAS(keyhash + s[r], EMPTY_SLOT, h[r]);
        if (cur[r] == EMPTY_SLOT) {   // claimed: this row writes the keys
          atomicAdd(meta + 1, 1);
          for (int k = 0; k < n_keys; ++k) {
            keyvals[k * S + s[r]] = kst[(k * RPT + r) * T + tid];
            keynull[k * S + s[r]] = (int8_t)((knull[k * T + tid] >> r) & 1u);
          }
          cur[r] = h[r];
        }
      }
      if (cur[r] == h[r]) {
        code[r] = (i64)s[r];
        pending &= ~(1u << r);
      } else {
        s[r] = s[r] + 1 == (u64)S ? 0 : s[r] + 1;
      }
    }
  }
  if (pending) meta[0] = 1;             // collision
  return live & ~pending;
}

template <int MODE>
__global__ void __launch_bounds__(256, 2)
scan_grouped_kernel(const i64* __restrict__ plan_g, int n_plan,
                    const i64* __restrict__ grid, int n_grid, i64 br,
                    i64 rows_per_cta, int n_sub,
                    const i64* __restrict__ params_g, int n_params, i64 G,
                    i64* __restrict__ part_i, i64* __restrict__ acc_i,
                    double* __restrict__ part_f, u64* __restrict__ counts,
                    u64* __restrict__ keyhash, i64* __restrict__ keyvals,
                    int8_t* __restrict__ keynull, int* __restrict__ meta,
                    u64 salt) {
  extern __shared__ i64 smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5;
  i64* plan = smem;                              // n_plan
  i64* params = plan + n_plan;                   // n_params
  for (int k = tid; k < n_plan; k += T) plan[k] = plan_g[k];
  for (int k = tid; k < n_params; k += T) params[k] = params_g[k];
  __syncthreads();
  const int n_steps = (int)plan[H_N_STEPS];
  const int n_i = (int)plan[H_N_I], n_f = (int)plan[H_N_F];
  const int n_specs = (int)plan[H_N_SPECS], n_keys = (int)plan[H_N_KEYS];
  const int depth = (int)plan[H_DEPTH], n_joins = (int)plan[H_N_JOINS];
  const i64* keys = plan + plan[H_OFF_KEYS];
  const i64* specs = plan + plan[H_OFF_SPECS];
  const i64* rows = plan + plan[H_OFF_ROWS];   // (init bits, op) per row
  // span: integer accumulators of this CTA in shared memory when given
  // partials to write them to; otherwise they fold into acc_i
  const bool int_smem = part_i != nullptr;

  i64* sm_cnt = params + n_params;                   // 1 + n_steps
  i64* cnt = sm_cnt + 1 + n_steps;                   // (1 + n_steps) x T
  i64* stk = cnt + (1 + n_steps) * T;                // depth x RPT x T
  i64* kst = stk + depth * RPT * T;                  // hash: keys x RPT x T
  // float staging, RPT x 32 (slot, value) pairs per warp
  i64* stg_c = kst + (MODE == MODE_HASH ? n_keys * RPT * T : 0);
  double* stg_v = (double*)(stg_c + (n_f ? RPT * T : 0));
  i64* sm_i = (i64*)(stg_v + (n_f ? RPT * T : 0));
  unsigned* nulls = (unsigned*)(sm_i + (int_smem ? n_i * G : 0));
  unsigned* knull = nulls + depth * T;               // hash: keys x T
  int* jrow = (int*)(knull + (MODE == MODE_HASH ? n_keys * T : 0));
  unsigned* jhit = (unsigned*)(jrow + n_joins * RPT * T);  // joins x T
  unsigned* jnul = jhit + n_joins * T;                     // joins x T
  if (int_smem)
    for (i64 k = tid; k < n_i * G; k += T) sm_i[k] = rows[2 * (k / G)];
  for (int k = tid; k <= n_steps; k += T) sm_cnt[k] = 0;
  for (int k = 0; k <= n_steps; ++k) cnt[k * T + tid] = 0;
  // this warp's float partials, in global memory
  const int lane = tid & 31;
  double* pf = n_f ? part_f + ((size_t)blockIdx.x * (T >> 5) + warp) *
                                  n_f * G
                   : nullptr;
  for (i64 s = lane; s < n_f * G; s += 32)
    __stcg(pf + s, as_f(rows[2 * (n_i + s / G)]));
  __syncthreads();
  i64* iacc = int_smem ? sm_i : acc_i;
  i64* wsc = stg_c + warp * RPT * 32;
  double* wsv = stg_v + warp * RPT * 32;

  Tile t;
  t.plan = plan;
  t.cols = plan + plan[H_OFF_COLS];
  t.params = params;
  t.stk = stk;
  t.nulls = nulls;
  t.jrow = jrow;
  t.jhit = jhit;
  t.jnul = jnul;
  t.T = T;
  t.tid = tid;
  const i64 n_items = (i64)n_grid * n_sub;
  for (i64 item = blockIdx.x; item < n_items; item += gridDim.x) {
    // grid entry e; this CTA takes its rows_per_cta-row slice `sub`
    const int e = (int)(item / n_sub), sub = (int)(item % n_sub);
    const i64 bidx = grid[e];
    const i64 lo = grid[n_grid + e] + (i64)sub * rows_per_cta;
    const i64 hi = min(grid[2 * n_grid + e], lo + rows_per_cta);
    const i64 span = hi - lo;
    const int n_pass =
        span > 0 ? (int)((span + RPT * T - 1) / (RPT * T)) : 0;
    // every thread of the CTA runs every pass (the folds need whole
    // warps); rows past `hi` are simply not live
    for (int pass = 0; pass < n_pass; ++pass) {
      const i64 base = lo + (i64)pass * RPT * T + tid;
      t.row0 = bidx * br + base;
      unsigned live = 0;
#pragma unroll
      for (int r = 0; r < RPT; ++r) live |= (unsigned)(base + r * T < hi) << r;
      cnt[tid] += __popc(live);
      live = run_steps(t, n_steps, live, cnt);
      __syncwarp();
      const bool any = __any_sync(FULL_MASK, live != 0);
      i64 code[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) code[r] = 0;
      bool spread = MODE == MODE_SPAN;
      if (any) {
        if (MODE == MODE_SPAN) {
          for (int k = 0; k < n_keys; ++k) {
            eval_prog(t, keys[2 * k], live);
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              code[r] += result(t, r) * keys[2 * k + 1];
          }
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            if (code[r] < 0 || code[r] >= G) live &= ~(1u << r);
        } else {
          live = probe_rows(t, keys, n_keys, live, code, G, salt, kst, knull,
                            keyhash, keyvals, keynull, meta);
          spread = __shfl_sync(FULL_MASK, __ldcg(meta + 1), 0) >=
                   SPREAD_GROUPS;
        }
        int_fold(spread, live, code, t, true, R_ADD, false, iacc);  // __seen
      }
      for (int s = 0; s < n_specs; ++s) {
        const i64* sp = specs + SPEC_WORDS * s;
        const int kind = (int)sp[0], acc_float = (int)sp[1];
        const int vrow = (int)sp[3], crow = (int)sp[4], in_float = (int)sp[5];
        // seen_count: the spec's row count equals __seen; the reduce
        // copies it
        const bool seen_count = sp[6] != 0;
        const bool is_count = kind == S_COUNT_STAR || kind == S_COUNT;
        if (is_count && seen_count) continue;
        unsigned take = live;
        if (any && kind != S_COUNT_STAR) {
          eval_prog(t, sp[2], live);
          take &= ~result_nulls(t);
        }
        if (is_count) {
          if (any)
            int_fold(spread, take, code, t, true, R_ADD, false,
                     iacc + vrow * G);
          continue;
        }
        const int op = kind == S_MIN ? R_MIN : kind == S_MAX ? R_MAX : R_ADD;
        if (acc_float) {
          if (!any) continue;
          warp_stage_float(take, code, t, op, in_float, wsc, wsv);
          // within one row position the staged slots are distinct: the
          // lanes apply them at once, row positions in order
          double* dst = pf + vrow * G;
          for (int r = 0; r < RPT; ++r) {
            const i64 c = wsc[r * 32 + lane];
            if (c >= 0)
              __stcg(dst + c, fcombine(__ldcg(dst + c), wsv[r * 32 + lane],
                                       op));
            __syncwarp();
          }
        } else if (any) {
          int_fold(spread, take, code, t, false, op, in_float,
                   iacc + vrow * G);
        }
        if (any && !seen_count)
          int_fold(spread, take, code, t, true, R_ADD, false,
                   iacc + crow * G);
      }
    }
  }

  // row counters: warp reduce, one shared atomic per warp, one global
  // atomic per CTA
  for (int k = 0; k <= n_steps; ++k) {
    i64 c = cnt[k * T + tid];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(FULL_MASK, c, o);
    if ((tid & 31) == 0 && c) atomicAdd((u64*)&sm_cnt[k], (u64)c);
  }
  __syncthreads();
  for (int k = tid; k <= n_steps; k += T)
    if (sm_cnt[k]) atomicAdd(&counts[k], (u64)sm_cnt[k]);
  if (int_smem)
    for (i64 k = tid; k < n_i * G; k += T)
      part_i[(size_t)blockIdx.x * n_i * G + k] = sm_i[k];
}

// Final accumulators, one thread per (row, slot).  Integer rows fold the
// per-CTA partials (span, shared-memory accumulators) or already hold
// their atomic sums; a row standing for __seen copies it.  Float rows fold
// the per-warp partials in (CTA, warp) order -- the same order on every
// run.
__global__ void scan_grouped_reduce(const i64* __restrict__ plan, i64 G,
                                    int n_parts, int n_fparts,
                                    const i64* __restrict__ part_i,
                                    i64* __restrict__ acc_i,
                                    const double* __restrict__ part_f,
                                    double* __restrict__ acc_f) {
  const int n_i = (int)plan[H_N_I], n_f = (int)plan[H_N_F];
  const i64* rows = plan + plan[H_OFF_ROWS];
  const i64* src = plan + plan[H_OFF_SRC];
  const i64 k = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_i * G) {
    const int r = (int)(k / G);
    const i64 g = k - r * G;
    const int sr = (int)src[r];
    if (part_i != nullptr) {
      const int op = (int)rows[2 * sr + 1];
      i64 acc = rows[2 * sr];
      for (int b = 0; b < n_parts; ++b)
        acc = icombine(acc, part_i[((size_t)b * n_i + sr) * G + g], op);
      acc_i[k] = acc;
    } else if (sr != r) {
      acc_i[k] = acc_i[sr * G + g];
    }
  } else if (k < (n_i + n_f) * G) {
    const i64 s0 = k - n_i * G;
    const int fr = (int)(s0 / G);
    const int op = (int)rows[2 * (n_i + fr) + 1];
    double acc = as_f(rows[2 * (n_i + fr)]);
    for (int b = 0; b < n_fparts; ++b)
      acc = fcombine(acc, part_f[(size_t)b * n_f * G + s0], op);
    acc_f[s0] = acc;
  }
}

typedef void (*grouped_kernel_t)(const i64*, int, const i64*, int, i64, i64,
                                 int, const i64*, int, i64, i64*, i64*,
                                 double*, u64*, u64*, i64*, int8_t*, int*,
                                 u64);

// Launch the scan kernel in `mode` over n_ctas persistent CTAs, then the
// reduce, on `stream`; returns cudaGetLastError().  part_f holds
// n_ctas x threads / 32 warp partials.
extern "C" int scan_grouped_launch(
    int mode, const void* plan, int n_plan, const void* grid, int n_grid,
    long long br, long long rows_per_cta, int n_sub, const void* params,
    int n_params, long long G, int n_i, int n_f, void* part_i, void* acc_i,
    void* part_f, void* acc_f, void* counts, void* keyhash, void* keyvals,
    void* keynull, void* table_meta, long long salt, int n_ctas, int threads,
    int smem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const grouped_kernel_t kernel = mode == MODE_HASH
                                      ? scan_grouped_kernel<MODE_HASH>
                                      : scan_grouped_kernel<MODE_SPAN>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_ctas, threads, smem_bytes, st>>>(
      (const i64*)plan, n_plan, (const i64*)grid, n_grid, br, rows_per_cta,
      n_sub, (const i64*)params, n_params, G, (i64*)part_i, (i64*)acc_i,
      (double*)part_f, (u64*)counts, (u64*)keyhash, (i64*)keyvals,
      (int8_t*)keynull, (int*)table_meta, (u64)salt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_slots = (long long)(n_i + n_f) * G;
  scan_grouped_reduce<<<(unsigned)((n_slots + REDUCE_THREADS - 1) /
                                   REDUCE_THREADS),
                        REDUCE_THREADS, 0, st>>>(
      (const i64*)plan, G, n_ctas, n_ctas * (threads / 32),
      (const i64*)part_i, (i64*)acc_i,
      (const double*)part_f, (double*)acc_f);
  return (int)cudaGetLastError();
}
