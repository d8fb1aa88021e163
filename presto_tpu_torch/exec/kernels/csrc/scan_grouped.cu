// Hash-grouped fused scan kernel for Hopper (sm_90a): decode ->
// filter/project -> hash-slot aggregation, in one pass over the encoded
// columns, for GROUP BYs beyond the direct kernel's 64 groups whose keys
// are not closed domains (span mode is a kernel generated per chain:
// exec/kernels/codegen.py).
//
// Replaces the reference's hash Pallas kernel in
// presto_tpu/exec/kernels/grouped.py: build_hash_runner (:63, launched
// :207), the open-addressing table of ops.agg_update with its __collision
// flag, <= 65536 slots.  Outputs match the plain version
// (exec/kernels/grouped.py scan_hash_plain): integer accumulators and row
// counters exactly, float64 sums within rounding, and the table's groups
// keyed by their key values (its slot layout is its own).
//
// Design:
// - A persistent grid: a fixed number of CTAs strides over the grid
//   entries' rows_per_cta-row slices, so the per-CTA partials scale with
//   the CTA count, not with the rows.  The per-row work (decode, chain
//   steps with their join / semi-join probes -- kernel #5 --, key
//   programs) runs through the interpreter of scan_common.cuh.
// - Hash slots: each live row hashes its key values exactly as
//   exec/operators.py hash_columns(salt) does (splitmix64 over uint64),
//   then claims slot kh % S with atomicCAS(EMPTY -> kh) or finds its own
//   keyhash there, probing linearly for at most PROBE_ROUNDS slots.  The
//   claiming row writes the slot's key values and counts one group.  A
//   row left unplaced sets the collision flag; the host doubles the table
//   and relaunches.
// - On chip (`onchip`, when the plan's tables fit: ScanPlan.layout).
//   The reference keeps its whole table in VMEM across its sequential
//   grid (grouped.py:63-100); here each CTA keeps its own, keyed by the
//   global slot, in shared memory, and the CTAs merge once at the end:
//   * a mirror of the table's key hashes.  A claimed slot never changes,
//     so a non-EMPTY mirror entry is final: a row probes the mirror
//     first, goes to device memory (__ldcg) only on a mirror EMPTY and to
//     atomicCAS only on a device EMPTY, and copies what it learns into
//     the mirror.  A hot group costs a shared-memory load.
//   * the integer rows the kernel folds (ScanPlan.n_fold: a count equal
//     to __seen is copied by the reduce) fold with shared-memory atomics
//     (exact, order-free) and go to part_i once per CTA.
//   * float rows: never unordered float atomics.  Each warp stages its
//     rows per row position (warp_stage_float: a slot's lanes fold in
//     lane order).  Where a table per warp fits (small tables), the warp
//     applies its pairs to its own table, row positions in order, as on
//     the device-memory path.  Otherwise, after a CTA barrier, the staged
//     pairs apply to the CTA's one table in (warp, row position) order --
//     warp w applies the slots = w mod warps, with __syncwarp between
//     positions -- and a second barrier frees the staging: the barriers
//     cost H2 more than per-warp device-memory tables do at the same
//     occupancy.  The tables go to part_f once per CTA.
//   * CTA width: an on-chip table of 4096 slots leaves room for one CTA
//     per SM; with 256 threads that CTA ran H1 3x slower than the
//     device-memory path at two CTAs per SM.  A hash plan therefore takes
//     the widest CTA (up to 512 threads) whose table still fits, and the
//     claiming rows re-evaluate their keys instead of every row stashing
//     them in shared memory.
// - On the device-memory path (tables too large for shared memory):
//   integer rows fold into acc_i with global atomics, each row its own
//   once the table holds SPREAD_GROUPS groups, else one per warp and slot
//   (warp_fold); each warp owns a float table in part_f.
// - A CTA barrier starts every pass, in both modes: the folds run faster
//   with the CTA's warps in step (HASH_DATE_PARTS -37%, H1 -12% on an
//   H100); the stage ring's mbarriers need none.
// - The reduce (scan_grouped_reduce, scan_common.cuh grouped_reduce)
//   folds each slot's partials in REDUCE_LANES interleaved sequences, then
//   a pairwise tree over them (exec/kernels/grouped.py reduce_partials): a
//   fixed order, so two launches on the same inputs give bit-identical
//   floats.
// - STAGES = 2 (scan_kernel_dma = "double" where the plan stages an
//   array, kernel #2): thread 0 keeps the next n_stages - 1 stages of
//   n_passes passes each of the staged arrays -- across work items -- in
//   flight into a ring of n_stages stages in shared memory, by bulk copies
//   completing on each stage's mbarrier (scan_common.cuh ring_copy), while
//   the CTA computes this one; each warp releases a stage once its rows
//   are read.  STAGES = 1 is the unstaged kernel.  Both take the same
//   path and grid (the on-chip fit reserves a two-stage ring either way,
//   and the ring's depth fills only the room left), so they agree bit for
//   bit.
//
// Bound: the encoded bytes of the scanned columns once plus the table
// once, over the device memory rate (3.35 TB/s on an H100 SXM).  What
// bounds it in practice is the interpreter's instruction count per row
// plus the probe rounds and folds; generating its code per chain, as the
// direct and span kernels are (codegen.py), is left for later work.
//
// Build: the eight kernel instances take most of nvcc's time, so the
// file compiles once per SG_PART, all parts in parallel (build.py PARTS),
// and the objects link into one library.  Parts 1-4 each hold the two
// stage counts of one (ONCHIP, EXT) pair and export their picker; part 0
// holds the reduce and the launch.  A non-inline __device__ function
// (here and in scan_common.cuh) is static, so its host-side stub stays
// in its part.
#ifndef SG_PART
#error "compile once per SG_PART in 0..4 (exec/kernels/build.py PARTS)"
#endif
#include "scan_common.cuh"

#define PROBE_ROUNDS 16
#define EMPTY_SLOT 0xffffffffffffffffULL
// device-memory path: groups a hash table must hold before its integer
// rows fold with one atomic each
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

// Integer rows into the CTA's table dst[code] in shared memory (on chip),
// one add (or 64-bit min / max) per row.
__device__ __forceinline__ void shared_fold(unsigned take,
                                            const i64 (&code)[RPT],
                                            const Tile& t, bool count, int op,
                                            bool in_float, i64* dst) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (!((take >> r) & 1u)) continue;
    i64* p = dst + code[r];
    if (count) {
      shared_add64(p, 1);
      continue;
    }
    const i64 x = result(t, r);
    const i64 v = in_float ? (i64)as_f(x) : x;
    if (op == R_MIN) atomicMin(p, v);
    else if (op == R_MAX) atomicMax(p, v);
    else shared_add64(p, v);
  }
}

// Hash the live rows' key values and place each row: its slot goes to
// code[r].  The rows probe in lockstep, their table loads issued together;
// a row that claims a slot counts one more group in meta[1], and the
// claiming rows' key values are evaluated again after the probe and
// written to the slot (claims are rare: a stash of every row's keys would
// cost shared memory a wider CTA needs).  With a `mirror` (on chip) a row
// reads the CTA's copy of the key hashes first and device memory only
// where the copy is still EMPTY.  Returns the rows placed.
template <int STAGES, bool EXT>
__device__ unsigned probe_rows(const Tile& t, const i64* keys, int n_keys,
                               unsigned live, i64 (&code)[RPT], i64 S,
                               u64 salt, u64* keyhash, i64* keyvals,
                               int8_t* keynull, int* meta, u64* mirror) {
  u64 h[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) h[r] = salt + 1;
  for (int k = 0; k < n_keys; ++k) {
    eval_prog<STAGES, EXT>(t, keys[2 * k], live);
    const unsigned nm = result_nulls(t);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      h[r] = hash_mix(h[r], result(t, r), (nm >> r) & 1u);
  }
  u64 s[RPT];
  // the host's tables have power-of-two sizes: a mask, not a 64-bit
  // division, picks the first slot
  const bool pow2 = (S & (S - 1)) == 0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (h[r] == EMPTY_SLOT) h[r] = 0;            // EMPTY is reserved
    s[r] = pow2 ? h[r] & (u64)(S - 1) : h[r] % (u64)S;
  }
  unsigned pending = live, claimed = 0;
  for (int round = 0; round < PROBE_ROUNDS && pending; ++round) {
    u64 cur[RPT];
    unsigned fresh = 0;
    if (mirror != nullptr) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        cur[r] = (pending >> r) & 1u ? mirror[s[r]] : 0;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if ((pending >> r) & 1u && cur[r] == EMPTY_SLOT) {
          cur[r] = __ldcg(keyhash + s[r]);
          fresh |= 1u << r;
        }
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        cur[r] = (pending >> r) & 1u ? __ldcg(keyhash + s[r]) : 0;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (!((pending >> r) & 1u)) continue;
      if (cur[r] == EMPTY_SLOT) {
        cur[r] = atomicCAS(keyhash + s[r], EMPTY_SLOT, h[r]);
        if (cur[r] == EMPTY_SLOT) {   // claimed: this row writes the keys
          atomicAdd(meta + 1, 1);
          claimed |= 1u << r;
          cur[r] = h[r];
        }
      }
      // a hash learned from device memory is final: keep it on chip
      if ((fresh >> r) & 1u) mirror[s[r]] = cur[r];
      if (cur[r] == h[r]) {
        code[r] = (i64)s[r];
        pending &= ~(1u << r);
      } else {
        s[r] = s[r] + 1 == (u64)S ? 0 : s[r] + 1;
      }
    }
  }
  if (pending) meta[0] = 1;             // collision
  if (__any_sync(FULL_MASK, claimed != 0)) {
    for (int k = 0; k < n_keys; ++k) {
      eval_prog<STAGES, EXT>(t, keys[2 * k], claimed);
      const unsigned nm = result_nulls(t);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if ((claimed >> r) & 1u) {
          keyvals[k * S + code[r]] = result(t, r);
          keynull[k * S + code[r]] = (int8_t)((nm >> r) & 1u);
        }
    }
  }
  return live & ~pending;
}

// integer rows the kernel folds (the others copy __seen: src[r] != r)
__device__ __forceinline__ int n_fold_rows(const i64* src, int n_i) {
  int n = 0;
  for (int r = 0; r < n_i; ++r) n += src[r] == r;
  return n;
}

// Thread 0's fill of stage s (at `st`, completing on `full`) with the
// cursor's stage of the CTA: its rows into ctl->pos[s], the full barrier
// armed with the stage's bytes, one bulk copy per staged column; then the
// cursor moves on.  Not inlined: its temporaries stay out of the
// interpreter loop's registers.
static __device__ __noinline__ void ring_fill_cols(
    RingCtl* ctl, int s, unsigned char* st, u64* full, const i64* cols,
    const i64* stab, int n_cols, i64 br, i64 stage_n, const i64* grid,
    int n_grid, i64 rows_per_cta, int n_sub, i64 n_items) {
  RingCursor& c = ctl->cur;
  const i64 a0 = c.b * br + c.lo;
  const int n = (int)min(stage_n, c.hi - c.lo);
  ctl->pos[s].a0 = a0;
  ctl->pos[s].n = n;
  ctl->pos[s].dense = stage_dense(ctl->arrays16 != 0, a0, n);
  unsigned tx = 0;
  for (int k = 0; k < n_cols; ++k)
    if (stab[k] >= 0) {
      const i64* cm = cols + COL_WORDS * k;
      tx += ring_bytes((u64)cm[2], dt_bytes((int)cm[1]), a0, n);
    }
  mbar_expect_tx(full, tx);
  for (int k = 0; k < n_cols; ++k)
    if (stab[k] >= 0) {
      const i64* cm = cols + COL_WORDS * k;
      ring_copy((u64)cm[2], dt_bytes((int)cm[1]), st + stab[k], a0, n, full);
    }
  ctl->more = ring_next(c, stage_n, grid, n_grid, rows_per_cta, n_sub,
                        n_items);
}

// ONCHIP: the tables live in shared memory.  Every instance fits 512
// threads of an SM at 128 registers each: two CTAs of 256 threads, or one
// wider CTA, which a plan takes when its on-chip table leaves room for
// one CTA per SM (ScanPlan.threads).
template <int STAGES, bool ONCHIP, bool EXT>
__global__ void __launch_bounds__(512, 1)
scan_grouped_kernel(const i64* __restrict__ plan_g, int n_plan,
                    const i64* __restrict__ grid, int n_grid, i64 br,
                    i64 rows_per_cta, int n_sub,
                    const i64* __restrict__ params_g, int n_params, i64 G,
                    int f_tables, i64* __restrict__ part_i,
                    i64* __restrict__ acc_i, double* __restrict__ part_f,
                    u64* __restrict__ counts, u64* __restrict__ keyhash,
                    i64* __restrict__ keyvals, int8_t* __restrict__ keynull,
                    int* __restrict__ meta, u64 salt, int stage_tab,
                    int n_stages, int n_passes, int stage_bytes) {
  extern __shared__ __align__(16) i64 smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, n_warps = T >> 5;
  // the stage ring (STAGES > 1) comes first, 16-byte aligned: n_stages
  // stages, their full and empty mbarriers and the producer's state
  unsigned char* ring = (unsigned char*)smem;
  u64* full = (u64*)(ring + (STAGES > 1 ? n_stages * stage_bytes : 0));
  u64* empty = full + n_stages;
  RingCtl* ctl = (RingCtl*)(full + 2 * n_stages);
  i64* plan = (i64*)(STAGES > 1 ? (unsigned char*)ctl + RING_CTL_BYTES
                                : ring);                          // n_plan
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
  const i64* src = plan + plan[H_OFF_SRC];     // row a row is copied from
  const bool onchip = ONCHIP, mirrored = ONCHIP;

  i64* sm_cnt = params + n_params;                   // 1 + n_steps
  i64* cnt = sm_cnt + 1 + n_steps;                   // (1 + n_steps) x T
  i64* stk = cnt + (1 + n_steps) * T;                // depth x RPT x T
  // float staging, RPT x 32 (slot, value) pairs per warp
  i64* stg_c = stk + depth * RPT * T;
  double* stg_v = (double*)(stg_c + (n_f ? RPT * T : 0));
  // on chip: the key-hash mirror (hash), the folded integer rows and the
  // float rows (f_tables tables: one per warp, or one for the CTA), G
  // slots each
  u64* mirror = (u64*)(stg_v + (n_f ? RPT * T : 0));
  i64* sm_i = (i64*)(mirror + (mirrored ? G : 0));
  double* sm_f = (double*)(sm_i + (onchip ? n_fold_rows(src, n_i) * G : 0));
  unsigned* nulls = (unsigned*)(sm_f + (onchip ? f_tables * n_f * G : 0));
  int* jrow = (int*)(nulls + depth * T);
  unsigned* jhit = (unsigned*)(jrow + n_joins * RPT * T);  // joins x T
  unsigned* jnul = jhit + n_joins * T;                     // joins x T
  int* ipos = (int*)(jnul + n_joins * T);  // n_i: a row's on-chip position
  if (tid == 0)
    for (int r = 0, q = 0; r < n_i; ++r) ipos[r] = src[r] == r ? q++ : -1;
  for (int k = tid; k <= n_steps; k += T) sm_cnt[k] = 0;
  for (int k = 0; k <= n_steps; ++k) cnt[k * T + tid] = 0;
  if (mirrored)
    for (i64 k = tid; k < G; k += T) mirror[k] = EMPTY_SLOT;
  if (onchip)
    for (i64 k = tid; k < f_tables * n_f * G; k += T)
      sm_f[k] = as_f(rows[2 * (n_i + (k / G) % n_f)]);
  __syncthreads();
  if (onchip)
    for (int r = 0; r < n_i; ++r)
      if (ipos[r] >= 0)
        for (i64 k = tid; k < G; k += T) sm_i[ipos[r] * G + k] = rows[2 * r];
  // this warp's float table: the CTA's or its own in shared memory (on
  // chip), its own in part_f (device memory)
  const int lane = tid & 31;
  const bool cta_floats = ONCHIP && f_tables == 1;
  double* pf = !n_f ? nullptr
               : cta_floats ? sm_f
               : onchip ? sm_f + (size_t)warp * n_f * G
               : part_f + ((size_t)blockIdx.x * n_warps + warp) * n_f * G;
  if (!onchip)
    for (i64 s = lane; s < n_f * G; s += 32)
      __stcg(pf + s, as_f(rows[2 * (n_i + s / G)]));
  __syncthreads();
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
  t.stab = STAGES > 1 ? plan + stage_tab : nullptr;
  t.stage = nullptr;
  t.pos = ctl->pos;
  t.k0 = 0;
  // integer row r's folds: on chip, at its fold position in shared
  // memory; else into acc_i with global atomics (warp_fold's rounds while
  // a hash table holds fewer than SPREAD_GROUPS groups)
  auto fold = [&](bool spread, unsigned take, const i64 (&code)[RPT],
                  bool count, int op, bool in_float, int r) {
    if (ONCHIP)
      shared_fold(take, code, t, count, op, in_float, sm_i + ipos[r] * G);
    else
      int_fold(spread, take, code, t, count, op, in_float, acc_i + r * G);
  };
  const i64 n_items = (i64)n_grid * n_sub, tile = (i64)RPT * T;
  const int n_cols = (int)plan[H_N_COLS];
  // the stage ring: thread 0 fills stages 0 .. n_stages - 2 with the
  // CTA's first stages of n_passes passes; the first pass of each stage
  // then refills the stage the previous one read with the stage
  // n_stages - 1 ahead (n_used counts the stages computed: its stage and
  // phase parity)
  const i64 stage_n = (i64)n_passes * tile;
  if (STAGES > 1) {
    if (tid == 0) {
      ring_init(full, n_stages, n_warps);
      ctl->cur.item = blockIdx.x;
      ctl->arrays16 = 1;
      for (int c = 0; c < n_cols; ++c)
        if (t.stab[c] >= 0)
          ctl->arrays16 &= (t.cols[COL_WORDS * c + 2] & 15) == 0;
      ctl->more = ring_seek(ctl->cur, grid, n_grid, rows_per_cta, n_sub,
                            n_items);
    }
    __syncthreads();
    if (tid == 0)
      for (int s = 0; s < n_stages - 1 && ctl->more; ++s)
        ring_fill_cols(ctl, s, ring + (size_t)s * stage_bytes, full + s,
                       t.cols, t.stab, n_cols, br, stage_n, grid, n_grid,
                       rows_per_cta, n_sub, n_items);
  }
  int n_used = 0, stg = 0;
  for (i64 item = blockIdx.x; item < n_items; item += gridDim.x) {
    // grid entry item / n_sub; this CTA takes its rows_per_cta-row slice
    // item % n_sub
    i64 bidx, lo, hi;
    item_rows(grid, n_grid, rows_per_cta, n_sub, item, bidx, lo, hi);
    const i64 span = hi - lo;
    const int n_pass =
        span > 0 ? (int)((span + RPT * T - 1) / (RPT * T)) : 0;
    // every thread of the CTA runs every pass (the folds need whole
    // warps, the on-chip float fold the whole CTA); rows past `hi` are
    // simply not live
    for (int pass0 = 0; pass0 < n_pass; pass0 += n_passes) {
      if (STAGES > 1) {
        // the producer: the stage the previous one read, once every warp
        // released it, takes the stage n_stages - 1 ahead
        if (tid == 0 && ctl->more) {
          const int s = (n_used + n_stages - 1) % n_stages;
          if (n_used > 0)
            mbar_wait(empty + s, (unsigned)((n_used - 1) / n_stages) & 1u);
          ring_fill_cols(ctl, s, ring + (size_t)s * stage_bytes, full + s,
                         t.cols, t.stab, n_cols, br, stage_n, grid, n_grid,
                         rows_per_cta, n_sub, n_items);
        }
        __syncwarp();
        stg = n_used % n_stages;
        mbar_wait(full + stg, (unsigned)(n_used / n_stages) & 1u);
        t.stage = ring + (size_t)stg * stage_bytes;
        t.pos = ctl->pos + stg;
      }
      // the stage's passes (one without the ring)
      const int np = min(n_passes, n_pass - pass0);
      for (int sp = 0; sp < np; ++sp) {
        const int pass = pass0 + sp;
        const i64 base = lo + (i64)pass * RPT * T + tid;
        t.row0 = bidx * br + base;
        t.k0 = sp * (int)tile + tid;
        // the folds' pace: the CTA's warps start each pass together.
        // Measured on an H100, single mode, against the kernel without it
        // (benchmarks/kernel_times.py --parent): HASH_DATE_PARTS 24.6 ->
        // 15.4 ms, H1 3.16 -> 2.79 ms (the mechanism, likely the warps'
        // atomics on a few hot slots, is not isolated).  It guards no
        // stage.
        __syncthreads();
        unsigned live = 0;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          live |= (unsigned)(base + r * T < hi) << r;
        cnt[tid] += __popc(live);
        live = run_steps<STAGES, EXT>(t, n_steps, live, cnt);
        __syncwarp();
        const bool any = __any_sync(FULL_MASK, live != 0);
        i64 code[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) code[r] = 0;
        // device memory: warp_fold's rounds until the table holds
        // SPREAD_GROUPS groups, then one atomic per row
        bool spread = false;
        if (any) {
          live = probe_rows<STAGES, EXT>(t, keys, n_keys, live, code, G, salt,
                                         keyhash, keyvals, keynull, meta,
                                         mirrored ? mirror : nullptr);
          if (!ONCHIP)
            spread = __shfl_sync(FULL_MASK, __ldcg(meta + 1), 0) >=
                     SPREAD_GROUPS;
          fold(spread, live, code, true, R_ADD, false, 0);
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
            eval_prog<STAGES, EXT>(t, sp[2], live);
            take &= ~result_nulls(t);
          }
          if (is_count) {
            if (any)
              fold(spread, take, code, true, R_ADD, false, vrow);
            continue;
          }
          const int op = kind == S_MIN ? R_MIN : kind == S_MAX ? R_MAX : R_ADD;
          if (acc_float && cta_floats) {
            // every warp stages (no rows: all slots -1); the CTA applies
            // the pairs only when some warp had rows
            warp_stage_float(take, code, t, op, in_float, wsc, wsv);
            if (__syncthreads_or(any)) {
              apply_staged(stg_c, stg_v, n_warps, op, pf + vrow * G);
              __syncthreads();
            }
          } else if (acc_float) {
            if (!any) continue;
            warp_stage_float(take, code, t, op, in_float, wsc, wsv);
            // within one row position the staged slots are distinct: the
            // lanes apply them at once, row positions in order
            double* dst = pf + vrow * G;
            for (int r = 0; r < RPT; ++r) {
              const i64 c = wsc[r * 32 + lane];
              if (c >= 0) {
                if (ONCHIP)
                  dst[c] = fcombine(dst[c], wsv[r * 32 + lane], op);
                else
                  __stcg(dst + c, fcombine(__ldcg(dst + c),
                                           wsv[r * 32 + lane], op));
              }
              __syncwarp();
            }
          } else if (any) {
            fold(spread, take, code, false, op, in_float, vrow);
          }
          if (any && !seen_count)
            fold(spread, take, code, true, R_ADD, false, crow);
        }
      }
      if (STAGES > 1) {
        // this warp has read the stage's rows: release it
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stg);
        ++n_used;
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
  if (onchip) {
    const i64 ni = n_fold_rows(src, n_i) * G;
    for (i64 k = tid; k < ni; k += T)
      part_i[(size_t)blockIdx.x * ni + k] = sm_i[k];
    const i64 nf = (i64)f_tables * n_f * G;
    for (i64 k = tid; k < nf; k += T)
      part_f[(size_t)blockIdx.x * nf + k] = sm_f[k];
  }
}

typedef void (*grouped_kernel_t)(const i64*, int, const i64*, int, i64, i64,
                                 int, const i64*, int, i64, int, i64*, i64*,
                                 double*, u64*, u64*, i64*, int8_t*, int*,
                                 u64, int, int, int, int);

#define SG_CAT(a, b) a##b
#define SG_PICK(part) SG_CAT(scan_grouped_pick_, part)

#if SG_PART > 0
// part k in 1..4: ONCHIP = (k - 1) & 1, EXT = (k - 1) >> 1
extern "C" grouped_kernel_t SG_PICK(SG_PART)(int stages) {
  constexpr bool onchip = ((SG_PART - 1) & 1) != 0;
  constexpr bool ext = ((SG_PART - 1) >> 1) != 0;
  return stages >= 2 ? scan_grouped_kernel<2, onchip, ext>
                     : scan_grouped_kernel<1, onchip, ext>;
}
#else
// Final accumulators: grouped_reduce (scan_common.cuh) over the plan's
// rows.
__global__ void scan_grouped_reduce(const i64* __restrict__ plan, i64 G,
                                    int n_iparts, int n_fparts,
                                    const i64* __restrict__ part_i,
                                    i64* __restrict__ acc_i,
                                    const double* __restrict__ part_f,
                                    double* __restrict__ acc_f) {
  grouped_reduce(plan + plan[H_OFF_ROWS], plan + plan[H_OFF_SRC],
                 (int)plan[H_N_I], (int)plan[H_N_F], G, n_iparts, n_fparts,
                 part_i, acc_i, part_f, acc_f);
}

extern "C" grouped_kernel_t scan_grouped_pick_1(int stages);
extern "C" grouped_kernel_t scan_grouped_pick_2(int stages);
extern "C" grouped_kernel_t scan_grouped_pick_3(int stages);
extern "C" grouped_kernel_t scan_grouped_pick_4(int stages);

static grouped_kernel_t pick(int stages, int onchip, int ext) {
  switch ((onchip ? 1 : 0) + (ext ? 2 : 0)) {
    case 0: return scan_grouped_pick_1(stages);
    case 1: return scan_grouped_pick_2(stages);
    case 2: return scan_grouped_pick_3(stages);
    default: return scan_grouped_pick_4(stages);
  }
}

// Launch the hash scan kernel over n_ctas persistent CTAs, then the
// reduce, on `stream`; returns cudaGetLastError().  onchip: the CTAs keep
// their tables in shared memory and write them to part_i (n_ctas x
// n_fold x G); otherwise part_i is null.  part_f holds n_ctas x f_tables
// float tables (n_f x G each): f_tables is threads / 32 (one per warp)
// or, on chip without room for those, 1.  stages >= 2 runs the stage ring
// of `stages` stages of `passes` passes and stage_bytes each (stage table
// at plan word stage_tab), 1 the unstaged kernel; smem_bytes includes the
// ring, its barriers and producer state and the on-chip tables; ext picks
// the instance for the opcodes beyond the Q1 / Q6 set.
extern "C" int scan_grouped_launch(
    const void* plan, int n_plan, const void* grid, int n_grid,
    long long br, long long rows_per_cta, int n_sub, const void* params,
    int n_params, long long G, int n_i, int n_f, int onchip, int f_tables,
    void* part_i,
    void* acc_i, void* part_f, void* acc_f, void* counts, void* keyhash,
    void* keyvals, void* keynull, void* table_meta, long long salt,
    int n_ctas, int threads, int stages, int passes, int stage_tab,
    int stage_bytes, int smem_bytes, int ext, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const grouped_kernel_t kernel = pick(stages, onchip, ext);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_ctas, threads, smem_bytes, st>>>(
      (const i64*)plan, n_plan, (const i64*)grid, n_grid, br, rows_per_cta,
      n_sub, (const i64*)params, n_params, G, f_tables, (i64*)part_i,
      (i64*)acc_i, (double*)part_f, (u64*)counts, (u64*)keyhash,
      (i64*)keyvals, (int8_t*)keynull, (int*)table_meta, (u64)salt,
      stage_tab, stages, passes, stage_bytes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 rgrid((unsigned)((G + 31) / 32), (unsigned)(n_i + n_f));
  scan_grouped_reduce<<<rgrid, dim3(32, REDUCE_LANES), 0, st>>>(
      (const i64*)plan, G, n_ctas, n_ctas * f_tables, (const i64*)part_i,
      (i64*)acc_i, (const double*)part_f, (double*)acc_f);
  return (int)cudaGetLastError();
}
#endif  // SG_PART
