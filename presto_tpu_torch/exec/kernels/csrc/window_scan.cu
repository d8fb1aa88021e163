// Prefix-scan window kernel for Hopper (sm_90a): row_number, rank,
// dense_rank and running count / count(*) / integer sum / decimal avg over
// the default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW) of one
// sorted run, every function of one (partition, order) spec in one call.
//
// Replaces the Pallas TPU kernel presto_tpu/exec/kernels/window.py
// _build_runner (:111, launched :209 via try_window_kernel :214).  The
// TPU kernel holds the whole run in VMEM and scans it with pairing scans;
// here the run stays in device memory and is scanned in ONE forward pass
// with decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back"), plus a small fix-up launch:
//
//   state     every row's inclusive prefix is a segmented state
//             (P, Q, D, C[s], X[s]): P the last partition start, Q the last
//             peer-group start, and, reset at each partition start, D the
//             peer starts (dense_rank), C[s] the contributing rows and X[s]
//             their wrapping int64 sum per prefix-sum slot s.  The combine
//             (A then B) takes max(P), max(Q) and, where B holds a partition
//             start, B's counters, else A's plus B's: associative and exact.
//             row_number = i - P + 1, rank = Q - P + 1, dense_rank = D, and
//             a frame (the partition start .. the peer group's last row)
//             reads C[s] / X[s] at the peer group's last row.
//   forward   one CTA per tile of tile_rows rows, tile ids from an atomic
//             ticket (a tile only waits on earlier ones).  Each warp walks
//             32-row chunks of its part of the tile: lane l reads row
//             base + l (coalesced loads: the keys at the row and the row
//             before it, mask, arguments), the row flags come from null-
//             and NaN-aware comparisons (operators._row_change), and the
//             chunk's segmented prefix comes from ballots of the partition-
//             , peer- and contribution flags (popc over the lanes since the
//             last partition start) and one shuffle scan per summed slot.
//             Pass 1 folds the tile's aggregate, published with status 1;
//             warp 0 then looks back over 32 predecessors at a time (status
//             2 = inclusive prefix), stopping at an inclusive prefix or at an
//             aggregate holding a partition start, and publishes the tile's
//             inclusive prefix.  Pass 2 rescans with the exclusive prefix,
//             writes row_number / rank / dense_rank, and records the frame
//             values (C, X) at each peer group's last row in shared memory,
//             keyed by the group's start; pass 3 writes count / sum / avg
//             for every row whose peer group closes inside the tile.
//   fix-up    a peer group still open at a tile's end (W3's ~1,250-row
//             groups) closes in a later tile: that tile records the group's
//             frame values under the tile where the group started; the
//             second launch writes count / sum / avg for the open group's
//             rows of each tile that left one open.  Nothing else is read.
//
// Pass 1 keeps each row's flags in shared memory for pass 2.
//
// Scratch: the ticket, a status word and two F-word states per tile, and
// per tile an open-group start and one (C, X) record per slot; no per-row
// scratch.  Every combine is an int64 max or wrapping add, with no float
// and no unordered result, so the outputs are bit-identical to the plain
// torch version (window.py window_scan_plain) whatever the tiling.  Dead
// rows sorted last start their own segment at the mask transition.
//
// Bound: the function reads the sorted mask, key and argument columns once
// and writes 8 bytes per row per function (9 for sum / avg): device-memory
// bandwidth (3.35 TB/s on an H100 SXM).  Keys are read twice (row and row
// before, the second from cache) and the tile twice (passes 1 and 2, the
// second from cache).
#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_DESC 1024
#define FULL 0xffffffffu

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
// column dtypes (exec/kernels/scan_kernel.py _DTYPES, and the window's
// own float32 for REAL keys, window.py _WINDOW_DTYPES)
enum { DT_I8, DT_I16, DT_I32, DT_I64, DT_F64, DT_BOOL, DT_F32 };

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {   // two's-complement
  return (i64)((u64)a + (u64)b);
}

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
  if (dt == DT_F32) {
    const float a = ((const float*)col[1])[i];
    const float b = ((const float*)col[1])[i - 1];
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

// operators._decimal_avg: round half away from zero at the input scale
__device__ __forceinline__ i64 decimal_avg(i64 s, i64 n, bool empty) {
  const i64 safe = empty ? 1 : n;
  const i64 a = s < 0 ? -s : s;
  const i64 q = (a + safe / 2) / safe;
  return s > 0 ? q : (s < 0 ? -q : 0);
}

__device__ __forceinline__ void load_desc(i64* d, const i64* desc_g,
                                          int n_desc) {
  for (int k = threadIdx.x; k < n_desc; k += blockDim.x) d[k] = desc_g[k];
  __syncthreads();
}

// The segmented prefix state (see the header); MS bounds the slots.
template <int MS>
struct State {
  i64 p, q, d;
  i64 c[MS], x[MS];
};

template <int MS>
__device__ __forceinline__ State<MS> identity_state() {
  State<MS> s;
  s.p = -1;
  s.q = -1;
  s.d = 0;
#pragma unroll
  for (int k = 0; k < MS; ++k) s.c[k] = s.x[k] = 0;
  return s;
}

// a then b
template <int MS>
__device__ __forceinline__ State<MS> combine(const State<MS>& a,
                                             const State<MS>& b) {
  State<MS> o;
  o.p = a.p > b.p ? a.p : b.p;
  o.q = a.q > b.q ? a.q : b.q;
  const bool reset = b.p >= 0;
  o.d = reset ? b.d : wadd(a.d, b.d);
#pragma unroll
  for (int k = 0; k < MS; ++k) {
    o.c[k] = reset ? b.c[k] : wadd(a.c[k], b.c[k]);
    o.x[k] = reset ? b.x[k] : wadd(a.x[k], b.x[k]);
  }
  return o;
}

// a state's F = 3 + 2 ns words: p, q, d, then (c, x) per slot
template <int MS>
__device__ __forceinline__ void store_state(i64* w, const State<MS>& s,
                                            int ns) {
  w[0] = s.p;
  w[1] = s.q;
  w[2] = s.d;
#pragma unroll
  for (int k = 0; k < MS; ++k)
    if (k < ns) {
      w[3 + 2 * k] = s.c[k];
      w[4 + 2 * k] = s.x[k];
    }
}

// from device memory another CTA wrote (L2, not the incoherent L1) when
// `l2`, else from shared memory
template <int MS>
__device__ __forceinline__ State<MS> load_state(const i64* w, int ns,
                                                bool l2) {
  State<MS> s = identity_state<MS>();
  s.p = l2 ? __ldcg(w) : w[0];
  s.q = l2 ? __ldcg(w + 1) : w[1];
  s.d = l2 ? __ldcg(w + 2) : w[2];
#pragma unroll
  for (int k = 0; k < MS; ++k)
    if (k < ns) {
      s.c[k] = l2 ? __ldcg(w + 3 + 2 * k) : w[3 + 2 * k];
      s.x[k] = l2 ? __ldcg(w + 4 + 2 * k) : w[4 + 2 * k];
    }
  return s;
}

// One warp's 32-row chunk at rows base + lane, after state S: each lane's
// inclusive state (r) and its row flags; returns lane 31's state (the
// chunk's end).  Rows at or past N add nothing.  Every lane calls it.
// The flags come from the key columns (row_flags) in pass 1, which keeps
// them in fls (one byte per row of the tile at ts), and from fls after.
template <int MS>
__device__ __forceinline__ State<MS> chunk(const i64* d, i64 base, i64 N,
                                           int ns, const State<MS>& S,
                                           State<MS>& r, unsigned& fl,
                                           unsigned char* fls, i64 ts,
                                           bool first_pass) {
  const int lane = threadIdx.x & 31;
  const i64 i = base + lane;
  const bool in = i < N;
  if (first_pass) {
    fl = in ? row_flags(d, i) : 0u;
    if (in) fls[i - ts] = (unsigned char)fl;
  } else {
    fl = in ? fls[i - ts] : 0u;
  }
  const unsigned bp = __ballot_sync(FULL, fl & 1u);
  const unsigned bq = __ballot_sync(FULL, (fl >> 1) & 1u);
  const unsigned lm = lane == 31 ? FULL : (2u << lane) - 1u;  // lanes <= l
  const unsigned pl = bp & lm, ql = bq & lm;
  const int sl = pl ? 31 - __clz(pl) : -1;       // last partition start
  const int qs = ql ? 31 - __clz(ql) : -1;       // last peer start
  const unsigned rm = sl >= 0 ? lm & ~((1u << sl) - 1u) : lm;
  r.p = sl >= 0 ? base + sl : S.p;
  r.q = qs >= 0 ? base + qs : S.q;
  r.d = wadd(sl >= 0 ? 0 : S.d, (i64)__popc(bq & rm));
#pragma unroll
  for (int k = 0; k < MS; ++k) {
    r.c[k] = r.x[k] = 0;
    if (k >= ns) continue;                       // warp-uniform
    i64 c = 0, x = 0;
    if (in) slot_row(d, slot_at(d, k), i, c, x);
    const unsigned bc = __ballot_sync(FULL, c != 0);
    r.c[k] = wadd(sl >= 0 ? 0 : S.c[k], (i64)__popc(bc & rm));
    i64 sx = x;                                  // inclusive scan of x
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(FULL, sx, o);
      if (lane >= o) sx = wadd(sx, y);
    }
    const i64 before = __shfl_sync(FULL, sx, sl > 0 ? sl - 1 : 0);
    r.x[k] = sl >= 0 ? wadd(sx, sl > 0 ? (i64)(0ULL - (u64)before) : 0)
                     : wadd(S.x[k], sx);
  }
  State<MS> e;
  e.p = __shfl_sync(FULL, r.p, 31);
  e.q = __shfl_sync(FULL, r.q, 31);
  e.d = __shfl_sync(FULL, r.d, 31);
#pragma unroll
  for (int k = 0; k < MS; ++k) {
    e.c[k] = __shfl_sync(FULL, r.c[k], 31);
    e.x[k] = __shfl_sync(FULL, r.x[k], 31);
  }
  return e;
}

// The count / sum / avg functions of row i from its frame's count n and
// sum x per slot: slot s's at cx[2 s x stride] and cx[(2 s + 1) x stride].
__device__ __forceinline__ void frame_outputs(const i64* d, i64 i,
                                              const i64* cx, int stride) {
  const i64* specs = slot_at(d, (int)d[D_NSLOTS]);
  for (int j = 0; j < (int)d[D_NSPECS]; ++j) {
    const i64* sp = specs + SPEC_WORDS * j;
    const int kind = (int)sp[0];
    if (kind < K_COUNT) continue;
    const int s = (int)sp[1];
    const i64 n = cx[2 * s * stride], sm = cx[(2 * s + 1) * stride];
    const bool isnull = kind != K_COUNT && n == 0;
    ((i64*)sp[2])[i] = kind == K_COUNT ? n
                       : kind == K_SUM ? sm : decimal_avg(sm, n, isnull);
    if (sp[3]) ((uint8_t*)sp[3])[i] = isnull ? 1 : 0;
  }
}

// Dynamic shared memory of the forward launch (window.py
// forward_smem_bytes): per row of the tile its group start's slot (short)
// and its flags (byte), the frame values at each group end (2 x ns words
// per tile row + 1), the warps' states and the look-back window (F words
// each).
template <int MS>
__global__ void __launch_bounds__(THREADS)
window_forward(const i64* __restrict__ desc_g, int n_desc, int tile_rows,
               int* __restrict__ ticket, int* __restrict__ status,
               i64* __restrict__ agg, i64* __restrict__ incl,
               i64* __restrict__ open_start, i64* __restrict__ rec) {
  __shared__ i64 d[MAX_DESC];
  __shared__ int s_tile, s_trail_open, s_lead_closed;
  __shared__ i64 s_trail_q, s_trail_gs;
  __shared__ int lb_st[32];
  extern __shared__ __align__(16) i64 dyn[];
  load_desc(d, desc_g, n_desc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_tile = atomicAdd(ticket, 1);
    s_lead_closed = 0;
  }
  __syncthreads();
  const i64 N = d[D_N];
  const int ns = (int)d[D_NSLOTS], F = 3 + 2 * ns, t = s_tile;
  const i64 ts = (i64)t * tile_rows;
  const i64 te = ts + tile_rows < N ? ts + tile_rows : N;
  const int per_warp = tile_rows / WARPS;        // a multiple of 32
  // the frame values at a group's end, word w of group slot q at
  // gv[w * gs + q] (neighbouring rows on neighbouring banks)
  const int gs = tile_rows + 1;
  i64* gv = dyn;                                 // 2 ns x (tile_rows + 1)
  i64* wst = gv + (size_t)(tile_rows + 1) * 2 * ns;   // WARPS x F
  i64* lbv = wst + WARPS * F;                    // 32 x F
  i64* es = lbv + 32 * F;                        // F: the exclusive prefix
  short* qloc = (short*)(es + F);                // tile_rows
  unsigned char* fls = (unsigned char*)(qloc + tile_rows);   // tile_rows
  const i64 wbase = ts + (i64)warp * per_warp;

  // pass 1: the warps' aggregates, then the tile's
  State<MS> S = identity_state<MS>(), r;
  unsigned fl;
  for (int c = 0; c < per_warp; c += 32)
    S = chunk<MS>(d, wbase + c, N, ns, S, r, fl, fls, ts, true);
  if (lane == 0) store_state<MS>(wst + warp * F, S, ns);
  __syncthreads();
  if (tid == 0) {
    State<MS> run = identity_state<MS>();
    for (int w = 0; w < WARPS; ++w) {            // exclusive per warp
      const State<MS> a = load_state<MS>(wst + w * F, ns, false);
      store_state<MS>(wst + w * F, run, ns);
      run = combine<MS>(run, a);
    }
    if (t == 0) {
      store_state<MS>(incl, run, ns);
      store_state<MS>(es, identity_state<MS>(), ns);
      __threadfence();
      atomicExch(&status[0], 2);
    } else {
      store_state<MS>(agg + (size_t)t * F, run, ns);
      store_state<MS>(lbv, run, ns);             // kept for the inclusive
      __threadfence();
      atomicExch(&status[t], 1);
    }
  }
  __syncthreads();

  // the look-back: 32 predecessors at a time
  if (t > 0 && warp == 0) {
    const State<MS> own = load_state<MS>(lbv, ns, false);
    __syncwarp();
    State<MS> acc = identity_state<MS>();
    int k = t - 1;
    bool done = false;
    while (!done) {
      const int j = k - lane;
      int st = -1;
      if (j >= 0) {
        while ((st = *(volatile int*)&status[j]) == 0) {
        }
        __threadfence();
        const i64* src = (st == 2 ? incl : agg) + (size_t)j * F;
        for (int f = 0; f < F; ++f) lbv[lane * F + f] = __ldcg(src + f);
      }
      lb_st[lane] = st;
      __syncwarp();
      if (lane == 0) {
        for (int l = 0; l < 32 && !done; ++l) {
          if (lb_st[l] < 0) {                    // past tile 0
            done = true;
            break;
          }
          acc = combine<MS>(load_state<MS>(lbv + l * F, ns, false), acc);
          done = lb_st[l] == 2 || acc.p >= 0;
        }
      }
      done = __shfl_sync(FULL, done, 0);
      k -= 32;
      __syncwarp();
    }
    if (lane == 0) {
      store_state<MS>(es, acc, ns);
      store_state<MS>(incl + (size_t)t * F, combine<MS>(acc, own), ns);
      __threadfence();
      atomicExch(&status[t], 2);
    }
  }
  __syncthreads();

  // pass 2: every row's state; ranking functions out, frame values at
  // each group end recorded under the group's start
  const State<MS> E = load_state<MS>(es, ns, false);
  S = combine<MS>(E, load_state<MS>(wst + warp * F, ns, false));
  const i64* specs = slot_at(d, ns);
  const int n_specs = (int)d[D_NSPECS];
  for (int c = 0; c < per_warp; c += 32) {
    const i64 base = wbase + c;
    const State<MS> e = chunk<MS>(d, base, N, ns, S, r, fl, fls, ts, false);
    const i64 i = base + lane;
    // the next row's flags: the next lane's, the tile's, or (past the
    // tile's last row) from the keys
    unsigned nf = __shfl_down_sync(FULL, fl, 1);
    if (lane == 31 && i + 1 < N)
      nf = i + 1 < te ? fls[i + 1 - ts] : row_flags(d, i + 1);
    if (i < N) {
      for (int jj = 0; jj < n_specs; ++jj) {
        const i64* sp = specs + SPEC_WORDS * jj;
        const int kind = (int)sp[0];
        if (kind >= K_COUNT) continue;
        ((i64*)sp[2])[i] = kind == K_ROW_NUMBER ? i - r.p + 1
                           : kind == K_RANK ? r.q - r.p + 1 : r.d;
      }
      const bool end = i + 1 >= N || ((nf >> 1) & 1u);
      const int q = r.q >= ts ? (int)(r.q - ts) : tile_rows;
      qloc[i - ts] = (short)q;
      if (end) {
#pragma unroll
        for (int k = 0; k < MS; ++k)
          if (k < ns) {
            gv[(2 * k) * gs + q] = r.c[k];
            gv[(2 * k + 1) * gs + q] = r.x[k];
          }
        if (q == tile_rows) s_lead_closed = 1;
      }
      if (i == te - 1) {
        s_trail_open = !end;
        s_trail_q = q;
        s_trail_gs = r.q;
      }
    }
    S = e;
  }
  __syncthreads();

  // the open-group records, then pass 3: count / sum / avg of every row
  // whose peer group closed in this tile
  if (tid == 0) {
    open_start[t] = s_trail_open ? s_trail_gs : -1;
    if (s_lead_closed) {
      // the leading group started at E.q, in tile E.q / tile_rows
      i64* rv = rec + (size_t)(E.q / tile_rows) * 2 * ns;
      for (int k = 0; k < 2 * ns; ++k) rv[k] = gv[k * gs + tile_rows];
    }
  }
  const bool trail_open = s_trail_open != 0;
  const int trail_q = (int)s_trail_q;
  for (i64 i = ts + tid; i < te; i += THREADS) {
    const int q = qloc[i - ts];
    if (trail_open && q == trail_q) continue;
    frame_outputs(d, i, gv + q, gs);
  }
}

// Count / sum / avg of the rows of tile blockIdx.x in a peer group still
// open at its end, from the record of the tile where the group closed.
__global__ void __launch_bounds__(THREADS)
window_fixup(const i64* __restrict__ desc_g, int n_desc, int tile_rows,
             const i64* __restrict__ open_start,
             const i64* __restrict__ rec) {
  __shared__ i64 d[MAX_DESC];
  const i64 gs = open_start[blockIdx.x];
  if (gs < 0) return;                            // the whole CTA
  load_desc(d, desc_g, n_desc);
  const i64 N = d[D_N];
  const int ns = (int)d[D_NSLOTS];
  const i64 ts = (i64)blockIdx.x * tile_rows;
  const i64 lo = gs > ts ? gs : ts;
  const i64 hi = ts + tile_rows < N ? ts + tile_rows : N;
  const i64* rv = rec + (size_t)(gs / tile_rows) * 2 * ns;
  for (i64 i = lo + threadIdx.x; i < hi; i += THREADS)
    frame_outputs(d, i, rv, 1);
}

typedef void (*forward_t)(const i64*, int, int, int*, int*, i64*, i64*,
                          i64*, i64*);

// Launch the forward pass and the fix-up on `stream`; returns the first
// CUDA error.  ms: the slot bound of the instance (1, 2, 4 or 8, at least
// the descriptor's slot count).  scratch (window.py window_scratch): the
// ticket and the tiles' status words (int32, zeroed by the caller), then
// int64: agg and incl (n_tiles x F each), open_start (n_tiles) and rec
// (n_tiles x 2 ns).
extern "C" int window_scan_launch(const void* desc, int n_desc, i64 n_tiles,
                                  int tile_rows, int n_slots, int ms,
                                  int smem_bytes, void* status_words,
                                  void* scratch, void* stream) {
  if (n_desc > MAX_DESC || n_tiles <= 0 || tile_rows % THREADS != 0 ||
      n_slots > ms)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int F = 3 + 2 * n_slots;
  int* ticket = (int*)status_words;
  int* status = ticket + 1;
  i64* agg = (i64*)scratch;
  i64* incl = agg + n_tiles * F;
  i64* open_start = incl + n_tiles * F;
  i64* rec = open_start + n_tiles;
  const forward_t fwd = ms <= 1 ? window_forward<1>
                        : ms <= 2 ? window_forward<2>
                        : ms <= 4 ? window_forward<4> : window_forward<8>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const i64* dg = (const i64*)desc;
  fwd<<<(unsigned)n_tiles, THREADS, smem_bytes, st>>>(
      dg, n_desc, tile_rows, ticket, status, agg, incl, open_start, rec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  window_fixup<<<(unsigned)n_tiles, THREADS, 0, st>>>(dg, n_desc, tile_rows,
                                                      open_start, rec);
  return (int)cudaGetLastError();
}
