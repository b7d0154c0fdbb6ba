// Anti-diagonal wavefront DP for batched pairwise global alignment, for
// Hopper (sm_90a): global affine (Gotoh, three states) and global linear
// gap alignment, each with a trace mode and a score mode, the three
// kernels of the lowmem affine aligner, and two score-only affine kernels
// (the streamed and the row-blocked one, at the end of this file).
//
// affine_wavefront replaces the Pallas kernel _affine_kernel
// (gonomics_tpu/ops/wavefront.py:94) and const_wavefront replaces
// _const_kernel (:243); both are launched there by the pallas_call of
// wavefront_align (:1584).
//
// Cell (i, j) lies on diagonal d = i + j at lane s = i. On a diagonal the
// three Gotoh states have no dependency between lanes: I reads (d-1, s),
// D reads (d-1, s-1), M reads (d-2, s-1). So the n+m diagonals run in a
// loop inside one block per pair, with a barrier between diagonals, and
// the block's threads stride over the interior lanes 1..n of a diagonal.
// Row 0 and column 0 are constants, written by thread 0; their trace
// codes, and those of lanes outside the grid, are written as 0.
//
// Diagonal state (per pair: 3 states x 3 slots x (n+1) int32 for affine,
// 3 slots x (n+1) for const) lives in shared memory when it fits and in
// a global scratch (L1/L2 resident) otherwise; the wrapper picks and
// passes a null scratch for shared memory. Three slots (diagonals d,
// d-1, d-2) and not the TPU kernel's two: a TPU step reads a whole slot
// before it overwrites it, but in a block thread s would read lane s-1
// of the slot that thread s-1 is overwriting. With three slots, one
// barrier per diagonal orders every read before the next overwrite.
//
// What bounds it on the card: integer operations. A 1024 x 1024 pair has
// 1.05 M interior cells at 10-26 int32 operations each (itemised in
// chip_smoke.py), while its trace is one byte a cell; at B = 128 with
// trace that is ~3.5 G operations (~0.21 ms at the int32 rate) against
// 134 MB of interior trace (~0.04 ms at 3.35 TB/s). This design takes
// several times that: every diagonal costs a barrier, nine state loads a
// lane through a generic pointer and the per-diagonal set-up of every
// warp (~0.74 us a diagonal on an H100, PERF.md), and a block runs one
// pair. The TPU kernel's (B, S) lane layout, sliding beta window and
// five precomputed profiles are TPU mechanisms and are not carried over:
// the substitution score is a lookup in the 5x5 table, held in shared
// memory, as scores[row(beta code), clip(alpha code)] like the TPU
// kernel's profile select (_select_score :85, _build_inputs :393).
//
// Each entry returns cudaGetLastError() so that the caller can raise on
// a launch the runtime refused.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);  // NEG = -(2**30)
constexpr int kThreads = 512;

__device__ __forceinline__ int max3(int a, int b, int c) { return max(max(a, b), c); }

// tie order M(0) > I(1) > D(2), as _argmax3 (wavefront.py:69)
__device__ __forceinline__ int argmax3(int a, int b, int c) {
  return (a >= b && a >= c) ? 0 : (b >= c ? 1 : 2);
}

// Substitution score of interior cell (s, j): alpha codes are clipped
// to 0..4; a beta code picks the score row as _select_score does: 0 -> 0,
// 1 or negative -> 1, 2 -> 2, 3 -> 3, 4 or more -> 4.
__device__ __forceinline__ int substitution(const int* sc, const int8_t* al,
                                            const int8_t* be, int s, int j) {
  const int a = min(max((int)al[s - 1], 0), 4);
  const int bc = be[j - 1];
  const int row = bc < 2 ? (bc == 0 ? 0 : 1) : min(bc, 4);
  return sc[row * 5 + a];
}

// The slots of diagonals d-1 (M1, I1, D1) and d-2 (M2, I2, D2).
struct Prev {
  const int32_t *M1, *I1, *D1, *M2, *I2, *D2;
};

// One interior Gotoh cell from its predecessors' values: (m2p, i2p,
// d2p) at (d-2, s-1), (m1s, i1s, d1s) at (d-1, s), (m1p, i1p, d1p) at
// (d-1, s-1). Returns the trace code tM + 4 tI + 16 tD, each the
// predecessor state in tie order.
__device__ __forceinline__ int gotoh_values(int m2p, int i2p, int d2p, int m1s,
                                            int i1s, int d1s, int m1p, int i1p,
                                            int d1p, int sub, int goe, int ge,
                                            int& mv, int& iv, int& dv) {
  const int ai = goe + m1s, bi = ge + i1s, ci = goe + d1s;  // I from (i, j-1)
  const int ad = goe + m1p, bd = goe + i1p, cd = ge + d1p;  // D from (i-1, j)
  mv = sub + max3(m2p, i2p, d2p);
  iv = max3(ai, bi, ci);
  dv = max3(ad, bd, cd);
  return argmax3(m2p, i2p, d2p) + 4 * argmax3(ai, bi, ci) + 16 * argmax3(ad, bd, cd);
}

// One interior Gotoh cell at lane s of diagonal d, where lane p stands
// for s-1 (s-1 itself, or s at a window's left edge, as the Pallas
// kernels' _shift does): I from (d-1, s), D from (d-1, p), M from
// (d-2, p).
__device__ __forceinline__ int gotoh_cell(const Prev& pv, int s, int p,
                                          int sub, int goe, int ge, int& mv,
                                          int& iv, int& dv) {
  return gotoh_values(pv.M2[p], pv.I2[p], pv.D2[p], pv.M1[s], pv.I1[s], pv.D1[s],
                      pv.M1[p], pv.I1[p], pv.D1[p], sub, goe, ge, mv, iv, dv);
}

// Seeds diagonal 0 (slot 0, lane 0): state 0 (M, or const's c) with 0
// and the others (I, D) with seed_gap; sets the pair's capture rows to
// NEG and loads the score table. No other lane needs a value before its
// diagonal writes it: an interior cell reads only cells of the grid.
__device__ void init_state(int32_t* st, int n_states, int S, int seed_gap,
                           int* sc, const int32_t* scores,
                           int32_t* const* rows, int n_rows) {
  for (int r = 0; r < n_rows; ++r)
    for (int s = threadIdx.x; s < S; s += blockDim.x) rows[r][s] = kNeg;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  if (threadIdx.x == 0)
    for (int k = 0; k < n_states; ++k) st[k * 3 * S] = k ? seed_gap : 0;
  __syncthreads();
}

template <bool kTrace>
__global__ void __launch_bounds__(kThreads)
affine_wavefront_kernel(const int8_t* __restrict__ alpha,   // (B, n)
                        const int8_t* __restrict__ beta,    // (B, m)
                        const int32_t* __restrict__ fin,    // (B,)
                        const int32_t* __restrict__ scores, // (5, 5)
                        int go, int ge, int B, int n, int m,
                        int32_t* scratch,                   // (B, 9 S) or null
                        int32_t* __restrict__ res_m,        // (B, S); score mode: max3
                        int32_t* __restrict__ res_i,        // (B, S); trace mode only
                        int32_t* __restrict__ res_d,        // (B, S); trace mode only
                        int8_t* __restrict__ trace) {       // (n+m, B, S)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  const int S = n + 1;
  const int b = blockIdx.x;
  int32_t* st = scratch ? scratch + (int64_t)b * 9 * S : smem;
  int32_t* const rows[3] = {res_m + (int64_t)b * S,
                            kTrace ? res_i + (int64_t)b * S : nullptr,
                            kTrace ? res_d + (int64_t)b * S : nullptr};
  // cell (0,0): M = 0, I = D = gap open (affineGap.go:159-165)
  init_state(st, 3, S, go, sc, scores, rows, kTrace ? 3 : 1);

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  const int f = fin[b];
  const int goe = go + ge;
  for (int d = 1; d <= n + m; ++d) {
    // slots of diagonals d, d-1 and d-2; state k of slot t at st + (3k + t) S
    const int t0 = d % 3, t1 = (d + 2) % 3, t2 = (d + 1) % 3;
    const Prev pv = {st + t1 * S, st + (3 + t1) * S, st + (6 + t1) * S,
                     st + t2 * S, st + (3 + t2) * S, st + (6 + t2) * S};
    int32_t *M0 = st + t0 * S, *I0 = st + (3 + t0) * S, *D0 = st + (6 + t0) * S;
    const int lo = max(1, d - m), hi = min(d - 1, n);  // interior lanes
    int8_t* trow = kTrace ? trace + ((int64_t)(d - 1) * B + b) * S : nullptr;
    if (threadIdx.x == 0) {
      // row 0 (I = go + ge d) and column 0 (D = go + ge d) of the grid
      const int bnd = go + ge * d;
      if (kTrace) trow[0] = 0;
      if (d <= m) {
        M0[0] = kNeg; I0[0] = bnd; D0[0] = kNeg;
        if (d == f) {
          if (kTrace) { rows[0][0] = kNeg; rows[1][0] = bnd; rows[2][0] = kNeg; }
          else rows[0][0] = bnd;
        }
      }
      if (d <= n) {
        M0[d] = kNeg; I0[d] = kNeg; D0[d] = bnd;
        if (d == f) {
          if (kTrace) { rows[0][d] = kNeg; rows[1][d] = kNeg; rows[2][d] = bnd; }
          else rows[0][d] = bnd;
        }
      }
    }
    for (int s = threadIdx.x + 1; s <= n; s += blockDim.x) {
      if (s < lo || s > hi) {
        if (kTrace) trow[s] = 0;
        continue;
      }
      int mv, iv, dv;
      const int code = gotoh_cell(pv, s, s - 1, substitution(sc, al, be, s, d - s),
                                  goe, ge, mv, iv, dv);
      if (kTrace) trow[s] = (int8_t)code;
      M0[s] = mv;
      I0[s] = iv;
      D0[s] = dv;
      if (d == f) {
        if (kTrace) {
          rows[0][s] = mv;
          rows[1][s] = iv;
          rows[2][s] = dv;
        } else {
          rows[0][s] = max3(mv, iv, dv);
        }
      }
    }
    __syncthreads();
  }
}

template <bool kTrace>
__global__ void __launch_bounds__(kThreads)
const_wavefront_kernel(const int8_t* __restrict__ alpha,   // (B, n)
                       const int8_t* __restrict__ beta,    // (B, m)
                       const int32_t* __restrict__ fin,    // (B,)
                       const int32_t* __restrict__ scores, // (5, 5)
                       int gap, int B, int n, int m,
                       int32_t* scratch,                   // (B, 3 S) or null
                       int32_t* __restrict__ res,          // (B, S)
                       int8_t* __restrict__ trace) {       // (n+m, B, S)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  const int S = n + 1;
  const int b = blockIdx.x;
  int32_t* st = scratch ? scratch + (int64_t)b * 3 * S : smem;
  int32_t* const rows[3] = {res + (int64_t)b * S, nullptr, nullptr};
  init_state(st, 1, S, 0, sc, scores, rows, 1);

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  const int f = fin[b];
  for (int d = 1; d <= n + m; ++d) {
    const int32_t* C1 = st + ((d + 2) % 3) * S;  // diagonal d-1
    const int32_t* C2 = st + ((d + 1) % 3) * S;  // diagonal d-2
    int32_t* C0 = st + (d % 3) * S;
    const int lo = max(1, d - m), hi = min(d - 1, n);  // interior lanes
    int8_t* trow = kTrace ? trace + ((int64_t)(d - 1) * B + b) * S : nullptr;
    if (threadIdx.x == 0) {
      // row 0 and column 0 of the grid: gap * d
      if (kTrace) trow[0] = 0;
      if (d <= m) {
        C0[0] = gap * d;
        if (d == f) rows[0][0] = gap * d;
      }
      if (d <= n) {
        C0[d] = gap * d;
        if (d == f) rows[0][d] = gap * d;
      }
    }
    for (int s = threadIdx.x + 1; s <= n; s += blockDim.x) {
      if (s < lo || s > hi) {
        if (kTrace) trow[s] = 0;
        continue;
      }
      const int diag = C2[s - 1] + substitution(sc, al, be, s, d - s);  // M
      const int left = C1[s] + gap;                                     // I
      const int up = C1[s - 1] + gap;                                   // D
      if (kTrace) trow[s] = (int8_t)argmax3(diag, left, up);
      const int c = max3(diag, left, up);
      C0[s] = c;
      if (d == f) rows[0][s] = c;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The lowmem affine aligner (affine_gap_lowmem_batch, wavefront.py:1212):
// a forward that keeps the two-diagonal state every K diagonals, then per
// block, from the last, a re-fill of its K diagonals inside a window of W
// lanes and a walk of that window's trace.
//
// affine_fwd_block replaces _affine_fwd_chunked_kernel (:895, pallas_call
// :991): K diagonals of score-mode Gotoh from a checkpoint, one launch a
// block (as the JAX forward loop does), one thread-block cluster of CL
// blocks a pair. It writes every lane 0..n of every diagonal (NEG outside
// the grid), so its end state, the next checkpoint, equals the plain
// version's on every lane whatever the input holds outside the grid. The
// checkpoint lives in device memory, (3, 2, B, S) int32: state k of
// diagonals d0-1 and d0.
//
// The cluster splits a pair's interior lanes 1..n into CL contiguous
// ranges of `chunk` lanes (the last shorter, trailing ones possibly
// empty); block r of the cluster owns lanes 1 + r chunk .. and keeps
// their three slots x three states in its own shared memory (or, where
// 9 (chunk + 1) int32 do not fit, in its own part of a global scratch);
// block 0 also owns lane 0. The one value a block needs from outside its
// range is lane s-1 at its left edge, of diagonals d-1 and d-2: block r-1
// keeps its last lane of every slot in a 9-int `edge` array in shared
// memory, and thread 0 of block r reads it through distributed shared
// memory right after the barrier, before its own lanes. The per-diagonal
// barrier is a cluster barrier. The three-slot argument holds cluster
// wide: at diagonal d block r reads slots d-1 and d-2 of block r-1, both
// written before the last barrier, while block r-1 writes only the slot
// of d (= d-3). Every block, an empty one too, reaches every barrier. A
// block of a cluster asks for more than half an SM's shared memory, so
// that it has its SM to itself: a diagonal's time grows with the lanes an
// SM sweeps, so two blocks on one SM would hold their clusters back. The
// wrapper picks CL, 1 to 8 (ops/wavefront.py fwd_cluster_size), from the
// pair count, the lanes and the clusters the card holds at once.
//
// affine_bwd_window replaces _affine_bwd_window_kernel (:1007,
// pallas_call :1085): it re-fills diagonals d0+1..d0+K of a pair on the
// lanes [wlo, wlo+W) only, reading the window of the checkpoint, and
// writes the packed trace (K, B, W). Each block computes its pair's wlo
// from the walk's current row i on the card, so the block loop needs no
// round trip to the host. The window's lane 0 takes its own value as its
// s-1 neighbour, as the Pallas kernel's _shift does.
//
// lowmem_walk_block replaces the jnp walk _walk_block (:1102): one thread
// a pair walks K steps over the block's trace, carrying (i, j, k) in
// device memory from block to block.
//
// State slots: three, as for affine_wavefront (the Pallas kernels' two
// parity slots race on a GPU), in shared memory when 9 x lanes x 4 bytes
// fit (the wrapper's SMEM_STATE_BYTES_MAX), else in a global scratch of
// 9 x lanes int32 a block that stays in L2. At the full-width shape (16
// pairs of 16,384 x 16,384, K = 1024) the forward's state is 590 KB a
// pair, 74 KB a block of a cluster of 8 (shared); the backward's W =
// 2,688 lanes take 97 KB (shared); at K = 4096, W = 8,832 lanes take 318
// KB (global).
//
// What bounds them on the card: the forward's function by integer
// operations (10 a cell in score mode, 4.3 G cells a run at full width:
// ~0.16 ms a block at the int32 rate of all 132 SMs). The cluster design
// takes ~16x that: a diagonal costs ~0.5 ns a lane a block sweeps plus
// ~1.1 us whatever its lanes (tools/k6_timing.py). The backward window
// is one block a pair, K2's design; the walk is a chain of dependent
// one-byte loads, bound by latency.

constexpr int kLowmemThreads = 1024;
// Dynamic shared memory that a block of a cluster of affine_fwd_block asks
// for at least: more than half an SM's 228 KB, so that no SM runs two
// blocks and every block of every cluster has an SM to itself.
constexpr size_t kOwnSmBytes = 120 * 1024;

namespace cg = cooperative_groups;

// The per-diagonal barrier of a cluster: a block barrier, then a relaxed
// cluster barrier whose wait acquires. Only `release`, the thread that
// wrote the block's edge lane (all that another block reads), pays for a
// fence at cluster scope; a release arrive would fence every thread.
__device__ __forceinline__ void cluster_step(bool release) {
  __syncthreads();
  if (release) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

// Slot of diagonal d (d may be -1).
__device__ __forceinline__ int slot_of(int d) { return ((d % 3) + 3) % 3; }

// kGlobal: the state lives in the global scratch (a template argument, so
// that the shared-memory kernel addresses shared memory directly).
template <bool kGlobal>
__global__ void __launch_bounds__(kLowmemThreads)
affine_fwd_block_kernel(const int8_t* __restrict__ alpha,    // (B, n)
                        const int8_t* __restrict__ beta,     // (B, m)
                        const int32_t* __restrict__ scores,  // (5, 5)
                        int go, int ge, int B, int n, int m, int d0, int K,
                        int fin, int CL, int chunk,
                        const int32_t* __restrict__ state_in,  // (3, 2, B, S)
                        int32_t* scratch,  // (B CL, 9 (chunk + 1)) or null
                        int32_t* __restrict__ state_out,       // (3, 2, B, S)
                        int32_t* __restrict__ capture) {       // (3, B, S)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  __shared__ int edge[9];  // the block's last lane: state k of slot t at 3k + t
  cg::cluster_group cluster = cg::this_cluster();
  const int S = n + 1;
  const int r = blockIdx.x % CL;  // the block's rank in its cluster
  const int b = blockIdx.x / CL;
  // local index x holds lane lo - 1 + x: the block's lanes at x = 1..len,
  // and block 0's lane 0 at x = 0
  const int P = chunk + 1;
  const int lo = 1 + r * chunk;
  const int len = max(0, min(n - lo + 1, chunk));
  const int x0 = r == 0 ? 0 : 1;
  // state k of slot t at st + (3k + t) P
  int32_t* st = kGlobal ? scratch + (int64_t)blockIdx.x * 9 * P : smem;
  const int* left = r > 0 ? cluster.map_shared_rank(edge, r - 1) : nullptr;
  // the thread that owns local lane chunk, the block's last, and writes
  // `edge` (when the block's range is full)
  const bool edge_writer =
      len == chunk && (int)threadIdx.x == (chunk - x0) % (int)blockDim.x;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  for (int k = 0; k < 3; ++k) {
    for (int p = 0; p < 2; ++p) {
      const int t = slot_of(d0 - 1 + p);
      const int32_t* src = state_in + ((int64_t)(2 * k + p) * B + b) * S + lo - 1;
      int32_t* dst = st + (3 * k + t) * P;
      for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) {
        dst[x] = src[x];
        if (x == chunk) edge[3 * k + t] = src[x];
      }
    }
    int32_t* cap = capture + ((int64_t)k * B + b) * S + lo - 1;
    for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) cap[x] = kNeg;
  }
  int32_t* cap_m = capture + (int64_t)b * S + lo - 1;
  int32_t* cap_i = capture + ((int64_t)B + b) * S + lo - 1;
  int32_t* cap_d = capture + ((int64_t)2 * B + b) * S + lo - 1;
  cluster.sync();

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  const int goe = go + ge;
  for (int d = d0 + 1; d <= d0 + K; ++d) {
    const int t0 = slot_of(d), t1 = slot_of(d - 1), t2 = slot_of(d - 2);
    const int32_t *M1 = st + t1 * P, *I1 = st + (3 + t1) * P, *D1 = st + (6 + t1) * P;
    const int32_t *M2 = st + t2 * P, *I2 = st + (3 + t2) * P, *D2 = st + (6 + t2) * P;
    int32_t *M0 = st + t0 * P, *I0 = st + (3 + t0) * P, *D0 = st + (6 + t0) * P;
    const int dlo = max(1, d - m), dhi = min(d - 1, n);  // interior lanes
    const int bnd = go + ge * d;
    // lane lo - 1 of diagonals d-1 and d-2 from block r-1, first: it is on
    // every diagonal's critical path
    int hm1 = kNeg, hi1 = kNeg, hd1 = kNeg, hm2 = kNeg, hi2 = kNeg, hd2 = kNeg;
    if (left != nullptr && threadIdx.x == 0 && len > 0) {
      hm1 = left[t1];
      hi1 = left[3 + t1];
      hd1 = left[6 + t1];
      hm2 = left[t2];
      hi2 = left[3 + t2];
      hd2 = left[6 + t2];
    }
    for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) {
      const int s = lo - 1 + x;
      int mv = kNeg, iv = kNeg, dv = kNeg;
      if (s >= dlo && s <= dhi) {
        const int sub = substitution(sc, al, be, s, d - s);
        if (x == 1 && left != nullptr) {
          gotoh_values(hm2, hi2, hd2, M1[x], I1[x], D1[x], hm1, hi1, hd1, sub,
                       goe, ge, mv, iv, dv);
        } else {
          gotoh_values(M2[x - 1], I2[x - 1], D2[x - 1], M1[x], I1[x], D1[x],
                       M1[x - 1], I1[x - 1], D1[x - 1], sub, goe, ge, mv, iv, dv);
        }
      } else {
        if (s == 0 && d <= m) iv = bnd;  // row 0
        if (s == d && d <= n) dv = bnd;  // column 0
      }
      M0[x] = mv;
      I0[x] = iv;
      D0[x] = dv;
      if (x == chunk) {
        edge[t0] = mv;
        edge[3 + t0] = iv;
        edge[6 + t0] = dv;
      }
      if (d == fin) {
        cap_m[x] = mv;
        cap_i[x] = iv;
        cap_d[x] = dv;
      }
    }
    if (CL > 1) {
      cluster_step(edge_writer);
    } else {
      __syncthreads();
    }
  }
  // the end state: diagonals d0+K-1 and d0+K
  for (int k = 0; k < 3; ++k)
    for (int p = 0; p < 2; ++p) {
      const int32_t* src = st + (3 * k + slot_of(d0 + K - 1 + p)) * P;
      int32_t* dst = state_out + ((int64_t)(2 * k + p) * B + b) * S + lo - 1;
      for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) dst[x] = src[x];
    }
}

__global__ void __launch_bounds__(kLowmemThreads)
affine_bwd_window_kernel(const int8_t* __restrict__ alpha,    // (B, n)
                         const int8_t* __restrict__ beta,     // (B, m)
                         const int32_t* __restrict__ scores,  // (5, 5)
                         int go, int ge, int B, int n, int m, int d0, int K,
                         int W,
                         const int32_t* __restrict__ i_cur,     // (B,)
                         const int32_t* __restrict__ state_in,  // (3, 2, B, S)
                         int32_t* scratch,                      // (B, 9 W) or null
                         int32_t* __restrict__ wlo_out,         // (B,)
                         int8_t* __restrict__ trace) {          // (K, B, W)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  const int S = n + 1;
  const int b = blockIdx.x;
  int32_t* st = scratch ? scratch + (int64_t)b * 9 * W : smem;
  // wlo = clip(floor((i - 2K - 128) / 128) * 128, 0, S - W)
  const int x = i_cur[b] - 2 * K - 128;
  const int wlo = min(x > 0 ? x / 128 * 128 : 0, S - W);
  if (threadIdx.x == 0) wlo_out[b] = wlo;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  for (int k = 0; k < 3; ++k)
    for (int p = 0; p < 2; ++p) {
      const int32_t* src = state_in + ((int64_t)(2 * k + p) * B + b) * S + wlo;
      int32_t* dst = st + (3 * k + slot_of(d0 - 1 + p)) * W;
      for (int w = threadIdx.x; w < W; w += blockDim.x) dst[w] = src[w];
    }
  __syncthreads();

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  const int goe = go + ge;
  for (int t = 0; t < K; ++t) {
    const int d = d0 + 1 + t;
    const int t0 = slot_of(d), t1 = slot_of(d - 1), t2 = slot_of(d - 2);
    const Prev pv = {st + t1 * W, st + (3 + t1) * W, st + (6 + t1) * W,
                     st + t2 * W, st + (3 + t2) * W, st + (6 + t2) * W};
    int32_t *M0 = st + t0 * W, *I0 = st + (3 + t0) * W, *D0 = st + (6 + t0) * W;
    const int lo = max(1, d - m), hi = min(d - 1, n);  // interior lanes
    const int bnd = go + ge * d;
    int8_t* trow = trace + ((int64_t)t * B + b) * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const int s = wlo + w;
      int mv = kNeg, iv = kNeg, dv = kNeg, code = 0;
      if (s >= lo && s <= hi) {
        code = gotoh_cell(pv, w, w > 0 ? w - 1 : 0,
                          substitution(sc, al, be, s, d - s), goe, ge, mv, iv, dv);
      } else {
        if (s == 0 && d <= m) iv = bnd;  // row 0
        if (s == d && d <= n) dv = bnd;  // column 0
      }
      M0[w] = mv;
      I0[w] = iv;
      D0[w] = dv;
      trow[w] = (int8_t)code;
    }
    __syncthreads();
  }
}

__global__ void lowmem_walk_block_kernel(const int8_t* __restrict__ trace,  // (K, B, W)
                                         const int32_t* __restrict__ wlo,   // (B,)
                                         int d0, int K, int W, int B,
                                         int32_t* __restrict__ i_io,  // (B,)
                                         int32_t* __restrict__ j_io,  // (B,)
                                         int32_t* __restrict__ k_io,  // (B,)
                                         int8_t* __restrict__ ops) {  // (K, B)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = i_io[b], j = j_io[b], k = k_io[b];
  const int soff = wlo[b];
  for (int t = 0; t < K; ++t) {
    const int d_rel = i + j - 1 - d0;
    if (i < 1 || j < 1 || d_rel < 0) {  // inactive: the op is 4, nothing moves
      ops[(int64_t)t * B + b] = 4;
      continue;
    }
    const int dd = min(d_rel, K - 1);
    const int ss = min(max(i - soff, 0), W - 1);
    const int packed = trace[((int64_t)dd * B + b) * W + ss];
    ops[(int64_t)t * B + b] = (int8_t)k;
    const int kn = k == 0 ? packed & 3 : k == 1 ? (packed >> 2) & 3 : (packed >> 4) & 3;
    if (k == 0 || k == 2) --i;
    if (k == 0 || k == 1) --j;
    k = kn;
  }
  i_io[b] = i;
  j_io[b] = j;
  k_io[b] = k;
}

// ---------------------------------------------------------------------------
// Score-only global affine alignment.
//
// affine_stream replaces _affine_stream_kernel (:1306, pallas_call :1507
// in wavefront_affine_stream :1449): the Gotoh score at cell (n, m) of
// many pairs of one shape. The TPU kernel staggers two pairs through one
// (B, S) lane set, reads a combined reversed-beta buffer by manual DMA and
// divides by a magic multiply, to fill its lanes and to dodge its scalar
// unit's stalls; a GPU has neither problem, and none of it is carried
// over. Here one warp aligns one pair and no block barrier is paid: the
// warp sweeps the DP in strips of 32 rows, lane t owning row 32k + t + 1
// and working on column c - t + 1 at step c. A cell's left neighbour is
// the lane's own last cell; its upper and upper-left neighbours come from
// lane t - 1 by __shfl_up_sync (this step's value and the last step's).
// Lane 0 takes them from the boundary row, the last row of the strip
// before, which lane 31 writes to a per-pair scratch as (max(M, I), D),
// all that a lower row reads, and which the warp reads back 32 columns at
// a time, a chunk ahead, broadcasting one column a step to lane 0. The
// substitution score is one shared-memory load from a table of the 256
// beta codes x 5 clipped alpha codes (the scoring rule of substitution()
// above), built by each block.
//
// What bounds it: the rate at which the SM dispatches integer
// instructions. A step of 32 cells is ~30 warp instructions (four
// shuffles, ~20 on the int32 pipe) for the ~10 int32 operations a cell
// that the function needs; the boundary rows
// (8 bytes a cell of every 32nd row) stay in L2. Strips of 32 rows fill a
// warp on m + 31 steps of m: 97% at m = 1024.
//
// affine_block replaces _affine_block_kernel (:466, pallas_call :620 in
// wavefront_align_blocked :569): one row block of the score-mode Gotoh DP,
// one launch a block as the JAX loop. Lane s is row k_off + s; lane 0 is
// the boundary row the block before left, read from (3, B, m) M/I/D
// tensors at column d (one diagonal ahead, so the load hides behind the
// barrier); lane r_rows writes its cell of each diagonal d > r_rows into
// the next boundary row at column d - r_rows (the TPU kernel's 128-lane
// capture ring and flush). Alpha rows past n read code 4, the JAX
// function's padding. One thread block a pair, three diagonal slots and a
// barrier a diagonal, as K2 and bound the same way (~0.74 us a diagonal,
// PERF.md); a thread takes several lanes when r_rows + 1 > 1024; the state
// lives in shared memory up to SMEM_STATE_BYTES_MAX and in a global
// scratch above.

constexpr int kStreamWarps = 4;  // pairs (one a warp) per block of affine_stream
constexpr unsigned kAllLanes = 0xffffffffu;

__global__ void __launch_bounds__(32 * kStreamWarps)
affine_stream_kernel(const int8_t* __restrict__ alpha,    // (NP, n)
                     const int8_t* __restrict__ beta,     // (NP, m)
                     const int32_t* __restrict__ scores,  // (5, 5)
                     int go, int ge, int NP, int n, int m,
                     int2* __restrict__ bnd,              // (NP, m) scratch
                     int32_t* __restrict__ out) {         // (NP,)
  // tab[5 c + a]: the score of beta byte c against clipped alpha code a
  __shared__ int tab[256 * 5];
  for (int x = threadIdx.x; x < 256 * 5; x += blockDim.x) {
    const int bc = (int8_t)(x / 5);
    const int row = bc < 2 ? (bc == 0 ? 0 : 1) : min(bc, 4);
    tab[x] = scores[row * 5 + x % 5];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kStreamWarps + threadIdx.x / 32;
  if (p >= NP) return;  // the whole warp
  if (n == 0) {  // cell (0, m) of row 0, unreached at m = 0
    if (lane == 0) out[p] = m > 0 ? go + ge * m : kNeg;
    return;
  }
  const int8_t* al = alpha + (int64_t)p * n;
  const uint8_t* be = (const uint8_t*)beta + (int64_t)p * m;
  int2* brow = bnd + (int64_t)p * m;  // column j at index j - 1
  const int goe = go + ge;
  // row 0: M = D = NEG, I = go + ge j
  for (int j = lane; j < m; j += 32) brow[j] = make_int2(go + ge * (j + 1), kNeg);
  __syncwarp();
  int M = kNeg, I = kNeg, D = kNeg;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int i = r0 + lane + 1;  // this lane's row; rows past n read code 4
    const int* sub = tab + (i <= n ? min(max((int)al[i - 1], 0), 4) : 4);
    const bool last = r0 + 32 >= n;
    // the lane's cell before its first step: (i, 0), M = I = NEG
    M = kNeg;
    I = kNeg;
    D = go + ge * i;
    // lane 0's upper-left at step 0: cell (r0, 0) as (max(M, I), D)
    int pH = r0 == 0 ? max(0, go) : kNeg;
    int pD = go + ge * r0;
    const int2 none = make_int2(kNeg, kNeg);
    int2 chunk = lane < m ? brow[lane] : none;
    int2 ahead = lane + 32 < m ? brow[lane + 32] : none;
    for (int c = 0; c < m + 31; ++c) {
      if ((c & 31) == 0 && c > 0) {
        chunk = ahead;
        if (c + 32 + lane < m) ahead = brow[c + 32 + lane];
      }
      // boundary column c + 1 for lane 0
      const int bH = __shfl_sync(kAllLanes, chunk.x, c & 31);
      const int bD = __shfl_sync(kAllLanes, chunk.y, c & 31);
      // cell (i - 1, j) of lane t - 1, computed on the step before
      int uH = __shfl_up_sync(kAllLanes, max(M, I), 1);
      int uD = __shfl_up_sync(kAllLanes, D, 1);
      if (lane == 0) {
        uH = bH;
        uD = bD;
      }
      const int j = c - lane + 1;
      if (j >= 1 && j <= m) {
        const int mv = sub[5 * be[j - 1]] + max(pH, pD);  // from (i-1, j-1)
        I = max(goe + max(M, D), ge + I);                  // from (i, j-1)
        D = max(goe + uH, ge + uD);                        // from (i-1, j)
        M = mv;
        if (lane == 31 && !last) brow[j - 1] = make_int2(max(M, I), D);
      }
      pH = uH;
      pD = uD;
    }
    __syncwarp();
  }
  if (lane == (n - 1) % 32) out[p] = max3(M, I, D);
}

__global__ void __launch_bounds__(kLowmemThreads)
affine_block_kernel(const int8_t* __restrict__ alpha,     // (B, n)
                    const int8_t* __restrict__ beta,      // (B, m)
                    const int32_t* __restrict__ fin,      // (B,)
                    const int32_t* __restrict__ scores,   // (5, 5)
                    int go, int ge, int B, int n, int m, int R, int k_off,
                    const int32_t* __restrict__ bnd_in,   // (3, B, m)
                    int32_t* __restrict__ bnd_out,        // (3, B, m)
                    int32_t* scratch,                     // (B, 9 (R+1)) or null
                    int32_t* __restrict__ res) {          // (B, R+1)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  const int S = R + 1;
  const int b = blockIdx.x;
  // state k of slot t at st + (3k + t) S
  int32_t* st = scratch ? scratch + (int64_t)b * 9 * S : smem;
  int32_t* out = res + (int64_t)b * S;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  // diagonal 0 (slot 0): lane 0 is cell (k_off, 0), the origin (M = 0,
  // I = D = go) for the first block and D = go + ge k_off for the others
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const bool origin = s == 0 && k_off == 0;
    st[s] = origin ? 0 : kNeg;
    st[3 * S + s] = origin ? go : kNeg;
    st[6 * S + s] = s == 0 ? go + ge * k_off : kNeg;
    out[s] = kNeg;
  }
  const int64_t at_m = (int64_t)b * m, at_i = ((int64_t)B + b) * m,
                at_d = ((int64_t)2 * B + b) * m;
  // lane 0's boundary cell of the next diagonal (column 1)
  int nm = kNeg, ni = kNeg, nd = kNeg;
  if (threadIdx.x == 0 && m >= 1) {
    nm = bnd_in[at_m];
    ni = bnd_in[at_i];
    nd = bnd_in[at_d];
  }
  __syncthreads();

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  const int f = fin[b] - k_off;  // the pair's diagonal in this block
  const int goe = go + ge;
  for (int d = 1; d <= R + m; ++d) {
    const int t0 = d % 3, t1 = (d + 2) % 3, t2 = (d + 1) % 3;
    const Prev pv = {st + t1 * S, st + (3 + t1) * S, st + (6 + t1) * S,
                     st + t2 * S, st + (3 + t2) * S, st + (6 + t2) * S};
    int32_t *M0 = st + t0 * S, *I0 = st + (3 + t0) * S, *D0 = st + (6 + t0) * S;
    const int lo = max(1, d - m), hi = min(d - 1, R);  // interior lanes
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      int mv = kNeg, iv = kNeg, dv = kNeg;
      if (s == 0) {  // the boundary row at column d (NEG past m)
        if (d <= m) {
          mv = nm;
          iv = ni;
          dv = nd;
        }
        if (d < m) {
          nm = bnd_in[at_m + d];
          ni = bnd_in[at_i + d];
          nd = bnd_in[at_d + d];
        }
      } else if (s >= lo && s <= hi) {
        const int row = k_off + s;
        const int a = row <= n ? min(max((int)al[row - 1], 0), 4) : 4;
        const int bc = be[d - s - 1];
        const int brow = bc < 2 ? (bc == 0 ? 0 : 1) : min(bc, 4);
        gotoh_cell(pv, s, s - 1, sc[brow * 5 + a], goe, ge, mv, iv, dv);
      } else if (s == d) {  // column 0 (s <= R)
        dv = go + ge * (k_off + s);
      }
      M0[s] = mv;
      I0[s] = iv;
      D0[s] = dv;
      if (d == f) out[s] = max3(mv, iv, dv);
      if (s == R && d > R) {  // cell (k_off + R, d - R) of the next boundary
        bnd_out[at_m + d - R - 1] = mv;
        bnd_out[at_i + d - R - 1] = iv;
        bnd_out[at_d + d - R - 1] = dv;
      }
    }
    __syncthreads();
  }
}

// One thread per lane, up to cap (K2/K3 sweep the interior lanes 1..n).
int threads_for(int lanes, int cap = kThreads) {
  const int t = (max(lanes, 1) + 31) / 32 * 32;
  return t < cap ? t : cap;
}

// Opts a kernel into `bytes` of dynamic shared memory where that is more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The launch of affine_fwd_block on `clusters` clusters of CL blocks, each
// block sweeping up to chunk + 1 lanes (block 0's lane 0 included) with
// its state in shared memory when in_smem; `attr` holds the cluster size.
cudaLaunchConfig_t fwd_block_config(int clusters, int CL, int chunk,
                                    bool in_smem, void* stream,
                                    cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CL);
  cfg.blockDim = dim3(threads_for(chunk + 1, kLowmemThreads));
  const size_t state = in_smem ? (size_t)9 * (chunk + 1) * sizeof(int32_t) : 0;
  cfg.dynamicSmemBytes = CL > 1 && state < kOwnSmBytes ? kOwnSmBytes : state;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" const char* wavefront_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int affine_wavefront_launch(const void* alpha, const void* beta,
                                       const void* fin, const void* scores,
                                       int go, int ge, int B, int n, int m,
                                       int with_trace, void* scratch,
                                       void* res_m, void* res_i, void* res_d,
                                       void* trace, void* stream) {
  const int S = n + 1;
  const size_t smem = scratch ? 0 : (size_t)9 * S * sizeof(int32_t);
  auto kernel = with_trace ? &affine_wavefront_kernel<true> : &affine_wavefront_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads_for(n), smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)fin,
      (const int32_t*)scores, go, ge, B, n, m, (int32_t*)scratch,
      (int32_t*)res_m, (int32_t*)res_i, (int32_t*)res_d, (int8_t*)trace);
  return (int)cudaGetLastError();
}

extern "C" int const_wavefront_launch(const void* alpha, const void* beta,
                                      const void* fin, const void* scores,
                                      int gap, int B, int n, int m,
                                      int with_trace, void* scratch, void* res,
                                      void* trace, void* stream) {
  const int S = n + 1;
  const size_t smem = scratch ? 0 : (size_t)3 * S * sizeof(int32_t);
  auto kernel = with_trace ? &const_wavefront_kernel<true> : &const_wavefront_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads_for(n), smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)fin,
      (const int32_t*)scores, gap, B, n, m, (int32_t*)scratch, (int32_t*)res,
      (int8_t*)trace);
  return (int)cudaGetLastError();
}

// The launch of affine_fwd_block with clusters of CL blocks at `chunk`
// lanes a block, written to out (three ints): the clusters the card holds
// at once, the dynamic shared memory a block asks for, and its threads.
extern "C" int affine_fwd_block_clusters(int CL, int chunk, int in_smem,
                                         void* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_block_config(1, CL, chunk, in_smem, nullptr, &attr);
  auto kernel = in_smem ? &affine_fwd_block_kernel<false> : &affine_fwd_block_kernel<true>;
  cudaError_t err = allow_smem(kernel, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int* res = (int*)out;
  res[1] = (int)cfg.dynamicSmemBytes;
  res[2] = (int)cfg.blockDim.x;
  return (int)cudaOccupancyMaxActiveClusters(res, (const void*)kernel, &cfg);
}

extern "C" int affine_fwd_block_launch(const void* alpha, const void* beta,
                                       const void* scores, int go, int ge,
                                       int B, int n, int m, int d0, int K,
                                       int fin, int CL, int chunk,
                                       const void* state_in, void* scratch,
                                       void* state_out, void* capture,
                                       void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_block_config(B, CL, chunk, scratch == nullptr,
                                                  stream, &attr);
  auto kernel = scratch ? &affine_fwd_block_kernel<true> : &affine_fwd_block_kernel<false>;
  cudaError_t err = allow_smem(kernel, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, (const int8_t*)alpha,
                           (const int8_t*)beta, (const int32_t*)scores, go, ge, B, n,
                           m, d0, K, fin, CL, chunk, (const int32_t*)state_in,
                           (int32_t*)scratch, (int32_t*)state_out, (int32_t*)capture);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


extern "C" int affine_bwd_window_launch(const void* alpha, const void* beta,
                                        const void* scores, int go, int ge,
                                        int B, int n, int m, int d0, int K,
                                        int W, const void* i_cur,
                                        const void* state_in, void* scratch,
                                        void* wlo, void* trace, void* stream) {
  const size_t smem = scratch ? 0 : (size_t)9 * W * sizeof(int32_t);
  cudaError_t err = allow_smem(affine_bwd_window_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  affine_bwd_window_kernel<<<B, threads_for(W, kLowmemThreads), smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)scores, go, ge,
      B, n, m, d0, K, W, (const int32_t*)i_cur, (const int32_t*)state_in,
      (int32_t*)scratch, (int32_t*)wlo, (int8_t*)trace);
  return (int)cudaGetLastError();
}

extern "C" int lowmem_walk_block_launch(const void* trace, const void* wlo,
                                        int d0, int K, int W, int B, void* i,
                                        void* j, void* k, void* ops,
                                        void* stream) {
  const int threads = 128;
  lowmem_walk_block_kernel<<<(B + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int8_t*)trace, (const int32_t*)wlo, d0, K, W, B, (int32_t*)i,
      (int32_t*)j, (int32_t*)k, (int8_t*)ops);
  return (int)cudaGetLastError();
}

extern "C" int affine_stream_launch(const void* alpha, const void* beta,
                                    const void* scores, int go, int ge, int NP,
                                    int n, int m, void* bnd, void* out,
                                    void* stream) {
  affine_stream_kernel<<<(NP + kStreamWarps - 1) / kStreamWarps, 32 * kStreamWarps,
                         0, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)scores, go, ge,
      NP, n, m, (int2*)bnd, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int affine_block_launch(const void* alpha, const void* beta,
                                   const void* fin, const void* scores, int go,
                                   int ge, int B, int n, int m, int R, int k_off,
                                   const void* bnd_in, void* bnd_out,
                                   void* scratch, void* res, void* stream) {
  const int S = R + 1;
  const size_t smem = scratch ? 0 : (size_t)9 * S * sizeof(int32_t);
  cudaError_t err = allow_smem(affine_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  affine_block_kernel<<<B, threads_for(S, kLowmemThreads), smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)fin,
      (const int32_t*)scores, go, ge, B, n, m, R, k_off, (const int32_t*)bnd_in,
      (int32_t*)bnd_out, (int32_t*)scratch, (int32_t*)res);
  return (int)cudaGetLastError();
}
