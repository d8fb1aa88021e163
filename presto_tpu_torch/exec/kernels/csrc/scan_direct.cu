// Fused scan kernel for Hopper (sm_90a): decode -> filter/project ->
// direct-slot partial aggregation, in one pass over the encoded columns.
//
// Replaces the Pallas TPU kernel presto_tpu/exec/kernels/scan_kernel.py
// build_direct_runner (launched at :731, gated by try_direct_scan_kernel
// :737).  It computes the same outputs -- the stacked int64 accumulator
// rows acc_i (n_i, G), the float64 rows acc_f (max(n_f,1), G) and the
// per-step live-row counters (1 + n_steps) -- over the same grid of
// (block, lo, hi) entries that aligned_grid builds on the host.
//
// Design (a first kernel that is right and simple):
// - Each grid entry is cut into slices of rows_per_cta rows, one CTA per
//   slice (so a scan has thousands of CTAs to spread over the 132 SMs);
//   zone-map pruning happens on the host, so pruned blocks are never
//   launched.  Threads stride over the slice's rows of block `bidx * br`;
//   neighbouring threads read neighbouring rows.
// - Decode runs at each column load, for a thread's RPT rows at once (their
//   loads issued together): plain is a load, dict a gather through the
//   code, RLE a binary search over run_starts (the reference's
//   _bisect_right).  Only live rows load, so a column read only by the
//   aggregate inputs (Q6's l_extendedprice) is fetched only for rows that
//   passed the filter.
// - Chain steps are ExprPrograms (exec/lowering.py) interpreted per row on
//   a stack of (int64-or-float64 bits, null) slots whose depth the plan
//   fixes; bound parameters come from a device vector, so new literals
//   reuse the loaded module.  A fanout-1 join or semi-join step runs its
//   probe in the same pass (kernel #5, scan_common.cuh probe_step).  Each thread runs the program over RPT rows
//   at once, so every instruction's fetch and dispatch is paid once per
//   RPT rows; the stack and row counters sit in shared memory.
// - No compaction: the TPU kernel's Blelloch compaction only shrinks its
//   one-hot grid.  A thread folds its live rows straight into the
//   accumulators.
// - Integer accumulators: per CTA in shared memory.  A warp first folds
//   its rows per group code (registers, then a butterfly), so one lane
//   issues one int64 atomic per code present in the warp -- exact, and
//   int64 addition wraps like the reference's.  Row counters: per-thread
//   counts, a warp shuffle reduce, one shared atomic per warp, one global
//   atomic per CTA.
// - Float64 accumulators: no float atomics.  Each thread owns a slot per
//   (row, group) in shared memory; the CTA then combines the slots in
//   thread order, and a second small launch combines the per-CTA partials
//   in a fixed order -- results are identical from run to run.
//
// - STAGES = 2 (scan_kernel_dma = "double", kernel #2): the per-row
//   arrays of the slice's next pass are copied into a two-stage ring in
//   shared memory while this pass computes (scan_common.cuh stage_tile);
//   STAGES = 1 is the unstaged kernel.
//
// Bound: the kernel moves the encoded bytes of the scanned columns once
// (about 12 B/row for TPC-H Q6 and 15 B/row for Q1 at SF10) and does a
// few dozen integer operations per row, so it is bounded by device
// memory bandwidth (3.35 TB/s on an H100 SXM).  A persistent grid and a
// compiled (not interpreted) expression path are left for later work.
#include "scan_common.cuh"

#define REDUCE_THREADS 256

// EXT: the instance for plans whose programs use an opcode beyond the
// TPC-H Q1 / Q6 set (ScanPlan.ext)
template <int STAGES, bool EXT>
__global__ void __launch_bounds__(256, 3)
scan_direct_kernel(const i64* __restrict__ plan_g, int n_plan,
                                   const i64* __restrict__ grid, int n_grid,
                                   i64 br, i64 rows_per_cta,
                                   const i64* __restrict__ params_g,
                                   int n_params,
                                   i64* __restrict__ part_i,
                                   double* __restrict__ part_f,
                                   u64* __restrict__ counts, int stage_tab,
                                   int stage_bytes) {
  extern __shared__ __align__(16) i64 smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  // the stage ring (STAGES > 1) comes first, 16-byte aligned
  unsigned char* ring = (unsigned char*)smem;
  // the interpreter reads its plan and parameters from shared memory: a
  // dependent global load per instruction was the kernel's latency chain
  i64* plan = smem + (STAGES > 1 ? STAGES * stage_bytes / 8 : 0);  // n_plan
  i64* params = plan + n_plan;                   // n_params
  for (int k = tid; k < n_plan; k += T) plan[k] = plan_g[k];
  for (int k = tid; k < n_params; k += T) params[k] = params_g[k];
  __syncthreads();
  const int n_steps = (int)plan[H_N_STEPS], G = (int)plan[H_G];
  const int n_i = (int)plan[H_N_I], n_f = (int)plan[H_N_F];
  const int n_specs = (int)plan[H_N_SPECS], n_keys = (int)plan[H_N_KEYS];
  const int n_joins = (int)plan[H_N_JOINS];
  const i64* keys = plan + plan[H_OFF_KEYS];
  const i64* specs = plan + plan[H_OFF_SPECS];
  const i64* rows = plan + plan[H_OFF_ROWS];   // (init bits, op) per row

  const int depth = (int)plan[H_DEPTH];
  i64* sm_i = params + n_params;                 // n_i * G
  i64* sm_cnt = sm_i + n_i * G;                  // 1 + n_steps
  i64* cnt = sm_cnt + 1 + n_steps;               // (1 + n_steps) x T
  i64* stk = cnt + (1 + n_steps) * T;            // depth x RPT x T
  double* sm_f = (double*)(stk + depth * RPT * T);  // n_f * G x T
  unsigned* nulls = (unsigned*)(sm_f + n_f * G * T);  // depth x T
  int* jrow = (int*)(nulls + depth * T);            // joins x RPT x T
  unsigned* jhit = (unsigned*)(jrow + n_joins * RPT * T);  // joins x T
  unsigned* jnul = jhit + n_joins * T;              // joins x T
  for (int k = tid; k < n_i * G; k += T) sm_i[k] = rows[2 * (k / G)];
  for (int k = tid; k <= n_steps; k += T) sm_cnt[k] = 0;
  for (int k = 0; k <= n_steps; ++k) cnt[k * T + tid] = 0;
  for (int s = 0; s < n_f * G; ++s)
    sm_f[s * T + tid] = as_f(rows[2 * (n_i + s / G)]);
  __syncthreads();

  // grid entry blockIdx.x; this CTA takes its rows_per_cta-row slice
  // blockIdx.y of [lo, hi)
  const i64 bidx = grid[blockIdx.x];
  const i64 e_lo = grid[n_grid + blockIdx.x];
  const i64 e_hi = grid[2 * n_grid + blockIdx.x];
  const i64 lo = e_lo + (i64)blockIdx.y * rows_per_cta;
  const i64 hi = min(e_hi, lo + rows_per_cta);
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
  // each pass: rows base + r * T (r < RPT) -- neighbouring threads read
  // neighbouring rows.  Every thread runs every pass (warp_fold needs the
  // whole warp); rows past `hi` are simply not live.
  const i64 span = hi - lo, tile = (i64)RPT * T;
  const int n_pass = span > 0 ? (int)((span + RPT * T - 1) / (RPT * T)) : 0;
  const int n_cols = (int)plan[H_N_COLS];
  if (STAGES > 1 && n_pass > 0) {                // the first tile's copies
    stage_tile(t.cols, t.stab, n_cols, ring, bidx * br + lo,
               (int)min(tile, span), T, tid);
    cp_async_commit();
  }
  for (int pass = 0; pass < n_pass; ++pass) {
    const i64 base = lo + (i64)pass * RPT * T + tid;
    t.row0 = bidx * br + base;
    if (STAGES > 1) {
      // every thread is done with the stage the next tile's copies
      // overwrite; they are issued before this tile computes
      __syncthreads();
      if (pass + 1 < n_pass) {
        const i64 nlo = lo + (pass + 1) * tile;
        stage_tile(t.cols, t.stab, n_cols,
                   ring + ((pass + 1) % STAGES) * stage_bytes,
                   bidx * br + nlo, (int)min(tile, hi - nlo), T, tid);
      }
      cp_async_commit();
      cp_async_wait_prev();                      // this tile's copies
      __syncthreads();
      t.stage = ring + (pass % STAGES) * stage_bytes;
    }
    unsigned live = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) live |= (unsigned)(base + r * T < hi) << r;
    cnt[tid] += __popc(live);
    live = run_steps<STAGES, EXT>(t, n_steps, live, cnt);
    __syncwarp();
    if (!__any_sync(FULL_MASK, live != 0)) continue;
    i64 code[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) code[r] = 0;
    for (int k = 0; k < n_keys; ++k) {
      eval_prog<STAGES, EXT>(t, keys[2 * k], live);
#pragma unroll
      for (int r = 0; r < RPT; ++r) code[r] += result(t, r) * keys[2 * k + 1];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (code[r] < 0 || code[r] >= G) live &= ~(1u << r);  // off the grid
    warp_fold(live, code, t, true, R_ADD, false, sm_i);     // __seen: row 0
    for (int s = 0; s < n_specs; ++s) {
      const i64* sp = specs + SPEC_WORDS * s;
      const int kind = (int)sp[0], acc_float = (int)sp[1];
      const int vrow = (int)sp[3], crow = (int)sp[4], in_float = (int)sp[5];
      // seen_count: the spec's row count equals __seen (count(*), or an
      // input that is never NULL); it is copied once at the end
      const bool seen_count = sp[6] != 0;
      if ((kind == S_COUNT_STAR || kind == S_COUNT) && seen_count) continue;
      unsigned take = live;
      if (kind != S_COUNT_STAR) {
        eval_prog<STAGES, EXT>(t, sp[2], live);
        take &= ~result_nulls(t);
      }
      if (kind == S_COUNT_STAR || kind == S_COUNT) {
        warp_fold(take, code, t, true, R_ADD, false, sm_i + vrow * G);
        continue;
      }
      const int op = kind == S_MIN ? R_MIN : kind == S_MAX ? R_MAX : R_ADD;
      if (acc_float) {
        // float rows stay in this thread's own slots, folded in row order
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (!((take >> r) & 1u)) continue;
          const i64 x = result(t, r);
          double* slot = &sm_f[(vrow * G + code[r]) * T + tid];
          *slot = fcombine(*slot, in_float ? as_f(x) : (double)x, op);
        }
      } else {
        warp_fold(take, code, t, false, op, in_float, sm_i + vrow * G);
      }
      if (!seen_count)
        warp_fold(take, code, t, true, R_ADD, false, sm_i + crow * G);
    }
  }

  // row counters: warp reduce, one shared atomic per warp
  for (int k = 0; k <= n_steps; ++k) {
    i64 c = cnt[k * T + tid];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if ((tid & 31) == 0 && c) atomicAdd((u64*)&sm_cnt[k], (u64)c);
  }
  __syncthreads();
  for (int k = tid; k <= n_steps; k += T)
    if (sm_cnt[k]) atomicAdd(&counts[k], (u64)sm_cnt[k]);
  for (int k = tid; k < n_specs * G; k += T) {
    const i64* sp = specs + SPEC_WORDS * (k / G);
    if (sp[6]) {
      const bool is_count = sp[0] == S_COUNT_STAR || sp[0] == S_COUNT;
      sm_i[(is_count ? sp[3] : sp[4]) * G + k % G] = sm_i[k % G];
    }
  }
  __syncthreads();
  const size_t b = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
  for (int k = tid; k < n_i * G; k += T) part_i[b * n_i * G + k] = sm_i[k];
  // float slots combine in thread order
  for (int s = tid; s < n_f * G; s += T) {
    const int op = (int)rows[2 * (n_i + s / G) + 1];
    double acc = as_f(rows[2 * (n_i + s / G)]);
    for (int t = 0; t < T; ++t) acc = fcombine(acc, sm_f[s * T + t], op);
    part_f[b * n_f * G + s] = acc;
  }
}

// Combine the per-CTA partials: one CTA per accumulator slot (row, group).
// Thread t folds partials t, t + T, ... in order, then a fixed pairwise
// tree folds the threads -- the same order on every run.
__global__ void scan_direct_reduce(const i64* __restrict__ plan, int n_parts,
                                   const i64* __restrict__ part_i,
                                   const double* __restrict__ part_f,
                                   i64* __restrict__ acc_i,
                                   double* __restrict__ acc_f) {
  __shared__ i64 red[REDUCE_THREADS];
  const int G = (int)plan[H_G];
  const int n_i = (int)plan[H_N_I], n_f = (int)plan[H_N_F];
  const i64* rows = plan + plan[H_OFF_ROWS];
  const int k = blockIdx.x, t = threadIdx.x;
  if (k < n_i * G) {
    const int op = (int)rows[2 * (k / G) + 1];
    i64 acc = rows[2 * (k / G)];
    for (int b = t; b < n_parts; b += REDUCE_THREADS)
      acc = icombine(acc, part_i[(size_t)b * n_i * G + k], op);
    red[t] = acc;
    __syncthreads();
    for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
      if (t < s) red[t] = icombine(red[t], red[t + s], op);
      __syncthreads();
    }
    if (t == 0) acc_i[k] = red[0];
  } else {
    const int s0 = k - n_i * G;
    const int op = (int)rows[2 * (n_i + s0 / G) + 1];
    double acc = as_f(rows[2 * (n_i + s0 / G)]);
    for (int b = t; b < n_parts; b += REDUCE_THREADS)
      acc = fcombine(acc, part_f[(size_t)b * n_f * G + s0], op);
    red[t] = as_b(acc);
    __syncthreads();
    for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
      if (t < s) red[t] = as_b(fcombine(as_f(red[t]), as_f(red[t + s]), op));
      __syncthreads();
    }
    if (t == 0) acc_f[s0] = as_f(red[0]);
  }
}

typedef void (*direct_kernel_t)(const i64*, int, const i64*, int, i64, i64,
                                const i64*, int, i64*, double*, u64*, int,
                                int);

// Launch both kernels on `stream`; returns cudaGetLastError().  stages 2
// runs the stage ring of stage_bytes per stage (stage table at plan word
// stage_tab); smem_bytes includes the ring; ext picks the instance for
// the opcodes beyond the Q1 / Q6 set.
extern "C" int scan_direct_launch(const void* plan, int n_plan,
                                  const void* grid, int n_grid, long long br,
                                  long long rows_per_cta, int n_sub,
                                  const void* params, int n_params,
                                  void* part_i,
                                  void* part_f, void* counts, void* acc_i,
                                  void* acc_f, int n_slots, int threads,
                                  int stages, int stage_tab, int stage_bytes,
                                  int smem_bytes, int ext, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const direct_kernel_t kernel =
      ext ? (stages == 2 ? scan_direct_kernel<2, true>
                         : scan_direct_kernel<1, true>)
          : (stages == 2 ? scan_direct_kernel<2, false>
                         : scan_direct_kernel<1, false>);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(n_grid, n_sub), threads, smem_bytes, st>>>(
      (const i64*)plan, n_plan, (const i64*)grid, n_grid, br, rows_per_cta,
      (const i64*)params, n_params, (i64*)part_i, (double*)part_f,
      (u64*)counts, stage_tab, stage_bytes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_direct_reduce<<<n_slots, REDUCE_THREADS, 0, st>>>(
      (const i64*)plan, n_grid * n_sub, (const i64*)part_i,
      (const double*)part_f, (i64*)acc_i, (double*)acc_f);
  return (int)cudaGetLastError();
}
