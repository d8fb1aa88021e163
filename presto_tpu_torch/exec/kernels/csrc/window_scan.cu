// Prefix-scan window kernel for Hopper (sm_90a): row_number, rank,
// dense_rank and running count / count(*) / integer sum / decimal avg over
// the default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW) of one
// sorted run, every function of one (partition, order) spec in one launch.
//
// Replaces the Pallas TPU kernel presto_tpu/exec/kernels/window.py
// _build_runner (:111, launched :209 via try_window_kernel :214).  The
// TPU kernel holds the whole run (padded to a power of two) in VMEM and
// scans it with pairing scans; here the run stays in device memory and is
// scanned by many CTAs in four launches on one stream:
//
//   1. tile pass, one CTA per TILE rows: each row's partition-start and
//      peer-start flags (row i against row i-1, read across tile edges,
//      with the live -> dead mask transition; values compared at their own
//      width, two NULLs equal, NaN equal to NaN for float64 keys), stored
//      as one byte per row, and the tile's aggregates: the max partition-
//      start and peer-start index, the min peer-start index, the peer-start
//      count and, per prefix-sum slot, the sums of contrib and of the
//      contributing values.
//   2. carry pass, one CTA: an exclusive scan of the tile aggregates,
//      forward max and add, backward min.
//   3. scan pass, one CTA per tile: each thread scans its RPT consecutive
//      rows; a CTA-wide scan (warp shuffles, then shared memory) of the
//      threads' totals, seeded with the tile's carry, gives every row's
//      segment start, peer-group start, peer-group end (next peer start
//      less one, a backward min scan), dense-rank counter and inclusive
//      count and sum per slot, written to int64 scratch.
//   4. output pass, one thread per row: row_number, rank,
//      cp - cp[seg_start] + 1, and the frame count and sum as
//      incl[fe] - incl[fs] + contrib[fs] (empty frames give 0), the
//      decimal avg rounded half away from zero, and the null flags.
//
// Every scan is an int64 max, min or (wrapping) add, with no atomics, so
// the outputs are bit-identical to the plain torch version
// (window.py window_scan_plain) and to the reference whatever the tiling.
// Rows are not padded: dead rows sorted last start their own segment at
// the mask transition, so live rows see the same segments.
//
// Bound: the function reads the sorted mask, key and argument columns once
// and writes 8 bytes per row per function (9 for sum / avg), a few integer
// operations per row: bounded by device memory bandwidth (3.35 TB/s on an
// H100 SXM).  This first version also writes and re-reads about
// 8 * (4 + 2 * slots) bytes of scratch per row, and a thread's RPT rows
// are consecutive, so a warp's loads are strided; a single-pass
// decoupled look-back scan, TMA loads and the gather fused into the tile
// pass are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

#define THREADS 256
#define RPT 16
#define TILE (THREADS * RPT)
#define CARRY_THREADS 1024
#define MAX_DESC 1024
#define OUT_THREADS 256
#define OUT_CTAS_MAX 4096

// descriptor layout (exec/kernels/window.py window_scan): header words,
// then n_cols x (dtype, values, nulls), the partition and order key column
// indices, n_slots x (argument column or -1, needs sum), and n_specs x
// (kind, slot, output values, output nulls or 0)
enum { D_N, D_NCOLS, D_NPART, D_NORDER, D_NSLOTS, D_NSPECS, D_NTILES,
       D_MASK, D_HEADER };
#define COL_WORDS 3
#define SLOT_WORDS 2
#define SPEC_WORDS 4
enum { K_ROW_NUMBER, K_RANK, K_DENSE_RANK, K_COUNT, K_SUM, K_AVG };
// per-tile aggregate fields; slot s adds F_SLOTS + 2s (count), +1 (sum)
enum { F_PART, F_PEER, F_PEER_MIN, F_DENSE, F_SLOTS };
// column dtypes (exec/kernels/scan_kernel.py _DTYPES)
enum { DT_I8, DT_I16, DT_I32, DT_I64, DT_F64, DT_BOOL };

struct OpMax {
  __device__ static i64 f(i64 a, i64 b) { return a > b ? a : b; }
};
struct OpMin {
  __device__ static i64 f(i64 a, i64 b) { return a < b ? a : b; }
};
struct OpAdd {   // two's-complement wrap, like torch's int64 cumsum
  __device__ static i64 f(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
};

__device__ __forceinline__ i64 load_int(i64 ptr, int dt, i64 i) {
  switch (dt) {
    case DT_I8: return ((const int8_t*)ptr)[i];
    case DT_I16: return ((const int16_t*)ptr)[i];
    case DT_I32: return ((const int32_t*)ptr)[i];
    case DT_I64: return ((const i64*)ptr)[i];
    case DT_BOOL: return ((const uint8_t*)ptr)[i];
    default: return 0;
  }
}

// row i of the column differs from row i-1 (operators._row_change)
__device__ __forceinline__ bool col_change(const i64* col, i64 i) {
  const int dt = (int)col[0];
  if (col[2]) {
    const uint8_t* nl = (const uint8_t*)col[2];
    const bool na = nl[i] != 0, nb = nl[i - 1] != 0;
    if (na || nb) return !(na && nb);
  }
  if (dt == DT_F64) {
    const double a = ((const double*)col[1])[i];
    const double b = ((const double*)col[1])[i - 1];
    return !(a == b || (isnan(a) && isnan(b)));
  }
  return load_int(col[1], dt, i) != load_int(col[1], dt, i - 1);
}

// bit 0: row i starts a partition, bit 1: it starts a peer group
__device__ unsigned row_flags(const i64* d, i64 i) {
  if (i == 0) return 3u;
  const uint8_t* mask = (const uint8_t*)d[D_MASK];
  const i64* cols = d + D_HEADER;
  const i64* part = cols + COL_WORDS * d[D_NCOLS];
  const i64* order = part + d[D_NPART];
  bool p = mask[i] != mask[i - 1];
  for (int k = 0; k < (int)d[D_NPART] && !p; ++k)
    p = col_change(cols + COL_WORDS * part[k], i);
  bool q = p;
  for (int k = 0; k < (int)d[D_NORDER] && !q; ++k)
    q = col_change(cols + COL_WORDS * order[k], i);
  return (p ? 1u : 0u) | (q ? 2u : 0u);
}

__device__ __forceinline__ const i64* slot_at(const i64* d, int s) {
  const i64* part = d + D_HEADER + COL_WORDS * d[D_NCOLS];
  return part + d[D_NPART] + d[D_NORDER] + SLOT_WORDS * s;
}

// contrib (live and the argument not NULL) and the value it adds (0 when
// the slot needs no sum)
__device__ __forceinline__ void slot_row(const i64* d, const i64* slot,
                                         i64 i, i64& c, i64& x) {
  const bool live = ((const uint8_t*)d[D_MASK])[i] != 0;
  if (slot[0] < 0) {       // count(*)
    c = live;
    x = 0;
    return;
  }
  const i64* col = d + D_HEADER + COL_WORDS * slot[0];
  const bool contrib =
      live && !(col[2] && ((const uint8_t*)col[2])[i] != 0);
  c = contrib;
  x = (slot[1] && contrib) ? load_int(col[1], (int)col[0], i) : 0;
}

template <class Op>
__device__ __forceinline__ i64 warp_incl(i64 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, x, k);
    if (lane >= k) x = Op::f(y, x);
  }
  return x;
}

template <class Op>
__device__ __forceinline__ i64 warp_incl_rev(i64 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const i64 y = __shfl_down_sync(0xffffffffu, x, k);
    if (lane + k < 32) x = Op::f(x, y);
  }
  return x;
}

// Exclusive scan of v over the block's threads, in thread order (REV: in
// reverse thread order), with identity `ident`; every thread of the block
// calls it.  buf: 32 words of shared memory, free again on return.
template <class Op, bool REV>
__device__ i64 block_excl(i64 v, i64 ident, i64* buf, i64* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const i64 x = REV ? warp_incl_rev<Op>(v) : warp_incl<Op>(v);
  if (lane == (REV ? 0 : 31)) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < nw ? buf[lane] : ident;
    w = REV ? warp_incl_rev<Op>(w) : warp_incl<Op>(w);
    if (lane < nw) buf[lane] = w;
  }
  __syncthreads();
  i64 before;
  if (REV) before = warp + 1 < nw ? buf[warp + 1] : ident;
  else before = warp > 0 ? buf[warp - 1] : ident;
  i64 in_warp = REV ? __shfl_down_sync(0xffffffffu, x, 1)
                    : __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == (REV ? 31 : 0)) in_warp = ident;
  const i64 t = REV ? buf[0] : buf[nw - 1];
  __syncthreads();
  if (total) *total = t;
  return Op::f(before, in_warp);
}

__device__ __forceinline__ void load_desc(i64* d, const i64* desc_g,
                                          int n_desc) {
  for (int k = threadIdx.x; k < n_desc; k += blockDim.x) d[k] = desc_g[k];
  __syncthreads();
}

// 1. flags and per-tile aggregates
__global__ void __launch_bounds__(THREADS)
window_tile_kernel(const i64* __restrict__ desc_g, int n_desc,
                   uint8_t* __restrict__ flags, i64* __restrict__ tile_agg,
                   int n_fields) {
  __shared__ i64 d[MAX_DESC];
  __shared__ i64 buf[32];
  load_desc(d, desc_g, n_desc);
  const i64 N = d[D_N];
  const i64 r0 = (i64)blockIdx.x * TILE + (i64)threadIdx.x * RPT;
  const i64 r1 = r0 + RPT < N ? r0 + RPT : N;
  i64 pmax = 0, qmax = 0, qmin = N, dense = 0;
  for (i64 i = r0; i < r1; ++i) {
    const unsigned fl = row_flags(d, i);
    flags[i] = (uint8_t)fl;
    if (fl & 1u) pmax = i;
    if (fl & 2u) {
      qmax = i;
      if (qmin == N) qmin = i;
      ++dense;
    }
  }
  i64* agg = tile_agg + (i64)blockIdx.x * n_fields;
  i64 t;
  block_excl<OpMax, false>(pmax, 0, buf, &t);
  if (threadIdx.x == 0) agg[F_PART] = t;
  block_excl<OpMax, false>(qmax, 0, buf, &t);
  if (threadIdx.x == 0) agg[F_PEER] = t;
  block_excl<OpMin, true>(qmin, N, buf, &t);
  if (threadIdx.x == 0) agg[F_PEER_MIN] = t;
  block_excl<OpAdd, false>(dense, 0, buf, &t);
  if (threadIdx.x == 0) agg[F_DENSE] = t;
  for (int s = 0; s < (int)d[D_NSLOTS]; ++s) {
    const i64* slot = slot_at(d, s);
    i64 cs = 0, xs = 0;
    for (i64 i = r0; i < r1; ++i) {
      i64 c, x;
      slot_row(d, slot, i, c, x);
      cs += c;
      xs = OpAdd::f(xs, x);
    }
    block_excl<OpAdd, false>(cs, 0, buf, &t);
    if (threadIdx.x == 0) agg[F_SLOTS + 2 * s] = t;
    block_excl<OpAdd, false>(xs, 0, buf, &t);
    if (threadIdx.x == 0) agg[F_SLOTS + 2 * s + 1] = t;
  }
}

// 2. exclusive carries of the tile aggregates (one CTA): thread k folds a
// contiguous range of tiles, the CTA scans the folds, and each thread
// writes its tiles' carries
__global__ void __launch_bounds__(CARRY_THREADS)
window_carry_kernel(const i64* __restrict__ tile_agg, i64* __restrict__ carry,
                    i64 n_tiles, int n_fields, i64 N) {
  __shared__ i64 buf[32];
  const i64 per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const i64 lo = (i64)threadIdx.x * per;
  const i64 hi = lo + per < n_tiles ? lo + per : n_tiles;
  for (int f = 0; f < n_fields; ++f) {
    if (f == F_PEER_MIN) {
      i64 acc = N;
      for (i64 k = lo; k < hi; ++k)
        acc = OpMin::f(acc, tile_agg[k * n_fields + f]);
      i64 run = block_excl<OpMin, true>(acc, N, buf, nullptr);
      for (i64 k = hi - 1; k >= lo; --k) {
        carry[k * n_fields + f] = run;
        run = OpMin::f(run, tile_agg[k * n_fields + f]);
      }
    } else if (f == F_PART || f == F_PEER) {
      i64 acc = 0;
      for (i64 k = lo; k < hi; ++k)
        acc = OpMax::f(acc, tile_agg[k * n_fields + f]);
      i64 run = block_excl<OpMax, false>(acc, 0, buf, nullptr);
      for (i64 k = lo; k < hi; ++k) {
        carry[k * n_fields + f] = run;
        run = OpMax::f(run, tile_agg[k * n_fields + f]);
      }
    } else {
      i64 acc = 0;
      for (i64 k = lo; k < hi; ++k)
        acc = OpAdd::f(acc, tile_agg[k * n_fields + f]);
      i64 run = block_excl<OpAdd, false>(acc, 0, buf, nullptr);
      for (i64 k = lo; k < hi; ++k) {
        carry[k * n_fields + f] = run;
        run = OpAdd::f(run, tile_agg[k * n_fields + f]);
      }
    }
  }
}

// 3. per-row scans seeded with the tile carries
__global__ void __launch_bounds__(THREADS)
window_scan_kernel(const i64* __restrict__ desc_g, int n_desc,
                   const uint8_t* __restrict__ flags,
                   const i64* __restrict__ carry, int n_fields,
                   i64* __restrict__ seg, i64* __restrict__ peer_idx,
                   i64* __restrict__ peer_end, i64* __restrict__ dense,
                   i64* __restrict__ cnt, i64* __restrict__ sum) {
  __shared__ i64 d[MAX_DESC];
  __shared__ i64 buf[32];
  load_desc(d, desc_g, n_desc);
  const i64 N = d[D_N];
  const i64 r0 = (i64)blockIdx.x * TILE + (i64)threadIdx.x * RPT;
  const i64 r1 = r0 + RPT < N ? r0 + RPT : N;
  const i64* c = carry + (i64)blockIdx.x * n_fields;
  i64 pmax = 0, qmax = 0, qmin = N, nd = 0;
  for (i64 i = r0; i < r1; ++i) {
    const unsigned fl = flags[i];
    if (fl & 1u) pmax = i;
    if (fl & 2u) {
      qmax = i;
      if (qmin == N) qmin = i;
      ++nd;
    }
  }
  i64 run_p = OpMax::f(c[F_PART],
                       block_excl<OpMax, false>(pmax, 0, buf, nullptr));
  i64 run_q = OpMax::f(c[F_PEER],
                       block_excl<OpMax, false>(qmax, 0, buf, nullptr));
  i64 run_d = OpAdd::f(c[F_DENSE],
                       block_excl<OpAdd, false>(nd, 0, buf, nullptr));
  i64 run_m = OpMin::f(c[F_PEER_MIN],
                       block_excl<OpMin, true>(qmin, N, buf, nullptr));
  for (i64 i = r0; i < r1; ++i) {
    const unsigned fl = flags[i];
    if (fl & 1u) run_p = i;
    if (fl & 2u) {
      run_q = i;
      ++run_d;
    }
    seg[i] = run_p;
    peer_idx[i] = run_q;
    dense[i] = run_d;
  }
  for (i64 i = r1 - 1; i >= r0; --i) {
    peer_end[i] = run_m - 1;
    if (flags[i] & 2u) run_m = i;
  }
  for (int s = 0; s < (int)d[D_NSLOTS]; ++s) {
    const i64* slot = slot_at(d, s);
    i64 cs = 0, xs = 0;
    for (i64 i = r0; i < r1; ++i) {
      i64 ci, xi;
      slot_row(d, slot, i, ci, xi);
      cs += ci;
      xs = OpAdd::f(xs, xi);
    }
    i64 run_c = OpAdd::f(c[F_SLOTS + 2 * s],
                         block_excl<OpAdd, false>(cs, 0, buf, nullptr));
    i64 run_x = OpAdd::f(c[F_SLOTS + 2 * s + 1],
                         block_excl<OpAdd, false>(xs, 0, buf, nullptr));
    i64* cnt_s = cnt + (i64)s * N;
    i64* sum_s = sum + (i64)s * N;
    for (i64 i = r0; i < r1; ++i) {
      i64 ci, xi;
      slot_row(d, slot, i, ci, xi);
      run_c += ci;
      cnt_s[i] = run_c;
      if (slot[1]) {
        run_x = OpAdd::f(run_x, xi);
        sum_s[i] = run_x;
      }
    }
  }
}

// operators._decimal_avg: round half away from zero at the input scale
__device__ __forceinline__ i64 decimal_avg(i64 s, i64 n, bool empty) {
  const i64 safe = empty ? 1 : n;
  const i64 a = s < 0 ? -s : s;
  const i64 q = (a + safe / 2) / safe;
  return s > 0 ? q : (s < 0 ? -q : 0);
}

// 4. the functions' values and null flags, one thread per row
__global__ void __launch_bounds__(OUT_THREADS)
window_output_kernel(const i64* __restrict__ desc_g, int n_desc,
                     const i64* __restrict__ seg,
                     const i64* __restrict__ peer_idx,
                     const i64* __restrict__ peer_end,
                     const i64* __restrict__ dense,
                     const i64* __restrict__ cnt,
                     const i64* __restrict__ sum) {
  __shared__ i64 d[MAX_DESC];
  load_desc(d, desc_g, n_desc);
  const i64 N = d[D_N];
  const int n_specs = (int)d[D_NSPECS];
  const i64* specs = slot_at(d, (int)d[D_NSLOTS]);
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (i64)gridDim.x * blockDim.x) {
    const i64 fs = seg[i], fe = peer_end[i];
    const bool empty = fe < fs;
    const i64 fsc = fs < 0 ? 0 : (fs > N - 1 ? N - 1 : fs);
    const i64 fec = fe < 0 ? 0 : (fe > N - 1 ? N - 1 : fe);
    for (int j = 0; j < n_specs; ++j) {
      const i64* sp = specs + SPEC_WORDS * j;
      const int kind = (int)sp[0];
      i64 v;
      bool isnull = false;
      if (kind == K_ROW_NUMBER) {
        v = i - fs + 1;
      } else if (kind == K_RANK) {
        v = peer_idx[i] - fs + 1;
      } else if (kind == K_DENSE_RANK) {
        v = OpAdd::f(dense[i] - dense[fs], 1);
      } else {
        const int s = (int)sp[1];
        const i64* slot = slot_at(d, s);
        const i64* cnt_s = cnt + (i64)s * N;
        i64 c0, x0;
        slot_row(d, slot, fsc, c0, x0);
        const i64 n = empty ? 0 : cnt_s[fec] - cnt_s[fsc] + c0;
        if (kind == K_COUNT) {
          v = n;
        } else {
          const i64* sum_s = sum + (i64)s * N;
          const i64 sm = empty ? 0
              : OpAdd::f(OpAdd::f(sum_s[fec], -sum_s[fsc]), x0);
          isnull = n == 0;
          v = kind == K_SUM ? sm : decimal_avg(sm, n, isnull);
        }
      }
      ((i64*)sp[2])[i] = v;
      if (sp[3]) ((uint8_t*)sp[3])[i] = isnull ? 1 : 0;
    }
  }
}

// Launch the four kernels on `stream`; returns the first CUDA error.
// scratch: int64 words, 2 * n_tiles * n_fields + N * (4 + 2 * n_slots).
extern "C" int window_scan_launch(const void* desc, int n_desc, i64 N,
                                  i64 n_tiles, int n_fields, int n_slots,
                                  void* flags, void* scratch, void* stream) {
  if (n_desc > MAX_DESC || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  i64* tile_agg = (i64*)scratch;
  i64* carry = tile_agg + n_tiles * n_fields;
  i64* seg = carry + n_tiles * n_fields;
  i64* peer_idx = seg + N;
  i64* peer_end = peer_idx + N;
  i64* dense = peer_end + N;
  i64* cnt = dense + N;
  i64* sum = cnt + (i64)n_slots * N;
  const i64* dg = (const i64*)desc;
  window_tile_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
      dg, n_desc, (uint8_t*)flags, tile_agg, n_fields);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  window_carry_kernel<<<1, CARRY_THREADS, 0, st>>>(tile_agg, carry, n_tiles,
                                                   n_fields, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  window_scan_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
      dg, n_desc, (const uint8_t*)flags, carry, n_fields, seg, peer_idx,
      peer_end, dense, cnt, sum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  i64 ctas = (N + OUT_THREADS - 1) / OUT_THREADS;
  if (ctas > OUT_CTAS_MAX) ctas = OUT_CTAS_MAX;
  window_output_kernel<<<(unsigned)ctas, OUT_THREADS, 0, st>>>(
      dg, n_desc, seg, peer_idx, peer_end, dense, cnt, sum);
  return (int)cudaGetLastError();
}
