// Extension DPs of the graph read aligner, for Hopper (sm_90a): the two
// linear-gap wavefronts that gsw's seed extension runs for every (genome
// window, read part) job of a wave, and the walk that turns each job's
// trace into its packed result row.
//
// local_wavefront replaces the Pallas kernel _local_kernel
// (gonomics_tpu/ops/wavefront.py:179, pallas_call :451 in wavefront_local),
// the LeftDynamicAln DP; gsw_right_wavefront replaces _gsw_right_kernel
// (:289, pallas_call :368 in wavefront_gsw_right), the RightDynamicAln DP;
// gsw_walk_pack replaces the jnp glue of gonomics_tpu/ops/gsw_dp.py
// (_left_full / _right_full, _walk_left / _walk_right, _pack_result,
// :30-157); its local side replaces the jnp glue of local_align_full
// after K4 (gonomics_tpu/ops/wavefront.py:661-696: the best cell, the
// lax.scan walk and the packing), the read aligner's mesh path, where K4
// runs over a read's whole (L, L + 2 pad) grid.
//
// Cell (i, j) of a job lies on diagonal d = i + j at lane s = i (i walks
// the genome window alpha, j the read part beta); results are (C, S)
// int32 and the trace (n+m, C, S) int8, row d-1 holding diagonal d, for
// S = n + 1 lanes. Two designs, picked by shape in the wrapper
// (ops/wavefront.py graph_dp_design):
//
// - The warp design (gsw_warp_kernel), wherever a job's m + 1 read-part
//   slots fit 32 L for an L it is built for (m <= 511): one warp a job,
//   its state along the read part in registers, no block barrier (see
//   the note above the kernel). The graph path's jobs always take it.
// - The block design (gsw_wavefront_kernel), for longer read parts: one
//   block a job, the n+m diagonals in a loop with a barrier between
//   them, the block's threads striding over the S lanes. Three diagonal
//   slots (d, d-1, d-2) and not the TPU kernels' two: a TPU step reads a
//   whole slot before it overwrites it, but in a block thread s reads
//   lane s-1 of the slot that thread s-1 writes. With three, one barrier
//   per diagonal orders every read before the next overwrite. The state
//   and the per-lane bests (6 rows of S int32 for the local DP, 5 for the
//   anchored one) live in shared memory when they fit the wrapper's 200
//   KB (n <= 8532 local, n <= 10239 anchored), else in the job's part of
//   a (C, rows x S) global scratch that stays in L1/L2; the wrapper picks
//   (state_in_shared_memory) and passes a null scratch for shared memory.
//
// What bounds them on the card: the trace's bytes and the cells' integer
// operations. At the graph path's wave (2048 jobs a side at (n, m) =
// (192, 128)) the contract writes C (n+m) S = 126 MB of trace a side
// (~0.038 ms at 3.35 TB/s), most of it the constant outside the cells;
// K5's padded rectangle is 51 M cells (~0.04 ms of int32 operations),
// K4's own grids ~3 M. The warp design runs only those cells, but one
// warp's diagonal step is a chain of ~30-40 instructions a cell, so it
// is bound by that latency and the issue rate of the ~16 warps an SM
// (PERF.md). The TPU kernels' beta window, five profiles and 128-lane S
// are TPU mechanisms and are not carried over: the score is
// scores[row(beta code), clip(alpha code)], the profile's orientation
// (_select_score :85, _build_inputs :393).
//
// The walk is one warp a job walking a tile of the trace at a time (see
// the note above gsw_walk_pack_kernel): a round of independent loads by
// the whole warp brings the cells of many steps into shared memory, which
// the warp then walks. It is bound by the latency of its dependent steps
// and of those rounds, not by bytes or operations.
//
// Each entry returns cudaGetLastError() so that the caller can raise on
// a launch the runtime refused.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "walk_ops.cuh"

namespace {

constexpr int kNeg = -(1 << 30);  // NEG = -(2**30)
constexpr int kThreads = 512;

__device__ __forceinline__ int max3(int a, int b, int c) { return max(max(a, b), c); }

// tie order diag(0) > left(1) > up(2), as _argmax3 (wavefront.py:69)
__device__ __forceinline__ int argmax3(int a, int b, int c) {
  return (a >= b && a >= c) ? 0 : (b >= c ? 1 : 2);
}

// Substitution score of cell (s, j): alpha codes are clipped to 0..4; a
// beta code picks the score row as _select_score does: 0 -> 0, 1 or
// negative -> 1, 2 -> 2, 3 -> 3, 4 or more -> 4.
__device__ __forceinline__ int substitution(const int* sc, const int8_t* al,
                                            const int8_t* be, int s, int j) {
  const int a = min(max((int)al[s - 1], 0), 4);
  const int bc = be[j - 1];
  const int row = bc < 2 ? (bc == 0 ? 0 : 1) : min(bc, 4);
  return sc[row * 5 + a];
}

// kLocal: LeftDynamicAln (clamped at 0 inside 1 <= i <= n_b, 1 <= j <= m_b,
// 0 and trace 3 elsewhere). Otherwise RightDynamicAln (unclamped over the
// padded grid, row 0 and column 0 at gap * d with trace 1 and 2, NEG and
// trace 0 outside). Both keep each lane's best value inside the job's own
// grid, with its diagonal, by strict >. kGlobal: the state lives in the
// global scratch (a template argument, so that the shared-memory kernel
// addresses shared memory directly).
template <bool kLocal, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
gsw_wavefront_kernel(const int8_t* __restrict__ alpha,   // (C, n)
                     const int8_t* __restrict__ beta,    // (C, m)
                     const int32_t* __restrict__ n_vec,  // (C,)
                     const int32_t* __restrict__ m_vec,  // (C,)
                     const int32_t* __restrict__ scores, // (5, 5)
                     int gap, int C, int n, int m,
                     int32_t* scratch,                   // (C, rows S) or null
                     int32_t* __restrict__ bv_out,       // (C, S)
                     int32_t* __restrict__ bd_out,       // (C, S)
                     int32_t* __restrict__ corner_out,   // (C, S) or null
                     int8_t* __restrict__ trace) {       // (n+m, C, S)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  const int S = n + 1;
  const int b = blockIdx.x;
  // 3 slots of S lanes, then the bests (and the corner)
  int32_t* st = kGlobal ? scratch + (int64_t)b * (kLocal ? 6 : 5) * S : smem;
  int32_t* bv = st + 3 * S;
  int32_t* bd = bv + S;
  int32_t* cr = bd + S;        // corner capture (kLocal only)
  const int nb = n_vec[b], mb = m_vec[b];
  const bool corner = kLocal && corner_out != nullptr;
  // diagonal 0 sits in slot 0 and "diagonal -1" in slot 2: all 0 for the
  // local DP; for the anchored one, cell (0, 0) = 0 and NEG elsewhere
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    for (int t = 0; t < 3; ++t)
      st[t * S + s] = (kLocal || (t == 0 && s == 0)) ? 0 : kNeg;
    bv[s] = 0;
    bd[s] = 0;
    if (corner) cr[s] = 0;
  }
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  __syncthreads();

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  for (int d = 1; d <= n + m; ++d) {
    const int32_t* C1 = st + ((d + 2) % 3) * S;  // diagonal d-1
    const int32_t* C2 = st + ((d + 1) % 3) * S;  // diagonal d-2
    int32_t* C0 = st + (d % 3) * S;
    int8_t* trow = trace + ((int64_t)(d - 1) * C + b) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int j = d - s;
      int c, t;
      if (kLocal) {
        if (s >= 1 && s <= nb && j >= 1 && j <= mb) {
          const int diag = C2[s - 1] + substitution(sc, al, be, s, j);
          const int left = C1[s] + gap;
          const int up = C1[s - 1] + gap;
          c = max3(diag, left, up);
          if (c > 0) {
            t = argmax3(diag, left, up);
            if (c > bv[s]) { bv[s] = c; bd[s] = d; }
          } else {
            c = 0;
            t = 3;
          }
        } else {
          c = 0;
          t = 3;
        }
        if (corner && d == nb + mb) cr[s] = c;
      } else {
        if (s >= max(1, d - m) && s <= min(d - 1, n)) {
          const int diag = C2[s - 1] + substitution(sc, al, be, s, j);
          const int left = C1[s] + gap;
          const int up = C1[s - 1] + gap;
          c = max3(diag, left, up);
          t = argmax3(diag, left, up);
          if (s <= nb && j <= mb && c > bv[s]) { bv[s] = c; bd[s] = d; }
        } else if (s == 0 && d <= m) {
          c = gap * d;
          t = 1;
        } else if (s == d && d <= n) {
          c = gap * d;
          t = 2;
        } else {
          c = kNeg;
          t = 0;
        }
      }
      C0[s] = c;
      trow[s] = (int8_t)t;
    }
    __syncthreads();
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    bv_out[(int64_t)b * S + s] = bv[s];
    bd_out[(int64_t)b * S + s] = bd[s];
    if (corner) corner_out[(int64_t)b * S + s] = cr[s];
  }
}

// The warp design: one warp a job, no block barrier. The state runs
// along the read part j (the short side on the graph path), not the
// window lane s: lane l holds the R contiguous slots j = l R + r, and
// slot j holds cell (d - j, j) of diagonal d, its values of d-1 and d-2
// in registers. Cell (i, j) reads diag from slot j-1 at d-2, left from
// slot j-1 at d-1 and up from slot j at d-1: within a lane all but its
// first slot read their own registers, and a diagonal exchanges only the
// lane's edge by __shfl_up_sync. A row i of the grid enters slot 0 on
// diagonal i and moves one slot a diagonal; its clipped alpha code,
// running best value and that value's diagonal (strict >, so the
// smallest d of a tie) move with it, and the lane holding slot m_b stores
// them at lane i, the row's last own column. Slot 0 takes a fresh row's
// alpha code from a register chunk of 32 codes loaded 32 diagonals ahead.
// The beta code of a slot is fixed: its score row offset stays in a
// register. K5 sweeps the padded rectangle [0, n] x [0, m] over all n+m
// diagonals with R = L (the kernel's template, 32 L >= m + 1); K4 only
// diagonals 1..n_b+m_b with R = m_b / 32 + 1, the slots of the job's own
// grid. The launch fills the trace with its constant (3 for K4, 0 for
// K5) at the card's write rate first (cudaMemsetAsync on the stream), and
// the slots write only their cells: the warps writing every byte of their
// jobs' rows themselves was slower at every shape measured (PERF.md).
constexpr int kWarpJobs = 4;  // jobs (warps) a block
constexpr unsigned kFull = 0xffffffffu;

// What one warp knows of its job.
struct WarpJob {
  const int8_t* al;  // the job's alpha row (n codes)
  const int* sc;     // the score table in shared memory
  int8_t* trace;     // trace row of diagonal 1 of the job: + (d-1) C S
  int32_t* bv;       // the job's rows of bv, bd and the corner (or null)
  int32_t* bd;
  int32_t* cr;
  int64_t pitch;     // C S, the bytes between two diagonals' rows
  int n, m, nb, mb, gap;
};

// The clipped alpha code of row i + 1 (4 past the window).
__device__ __forceinline__ int alpha_code(const WarpJob& g, int i) {
  return i < g.n ? min(max((int)g.al[i], 0), 4) : 4;
}

// Diagonals 1..dmax of one job, lane l holding the R contiguous slots
// j = l R + r. Within a thread a cell's left and diag neighbours are its
// own slot r-1, so a diagonal exchanges only the lane's edge (slot l R - 1
// and the row state moving into slot l R) by __shfl_up_sync. The slots
// are swept from r = R-1 down, so each one reads slot r-1's values of
// diagonal d-1 before they are overwritten.
template <bool kLocal, int R>
__device__ __forceinline__ void warp_sweep(const WarpJob& g, const int8_t* be,
                                           int dmax) {
  const int lane = threadIdx.x & 31;
  const int n = g.n, m = g.m, nb = g.nb, mb = g.mb, gap = g.gap;
  const int j0 = lane * R;  // the lane's first slot
  // diagonal 0 and "diagonal -1": all 0 for K4; for K5 cell (0, 0) = 0
  // and NEG elsewhere. Per slot: its cells of d-1 and d-2, and the best
  // value, best diagonal and alpha code of the row passing through
  int c1[R], c2[R], rv[R], rd[R], ac[R], soff[R];
  bool jin[R], jown[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    c1[r] = (kLocal || j == 0) ? 0 : kNeg;
    c2[r] = kLocal ? 0 : kNeg;
    rv[r] = rd[r] = ac[r] = 0;
    int row = 4;
    if (j >= 1 && j <= m) {
      const int bc = be[j - 1];
      row = bc < 2 ? (bc == 0 ? 0 : 1) : min(bc, 4);
    }
    soff[r] = 5 * row;
    jin[r] = j <= m;                  // K5: columns of the rectangle
    jown[r] = j >= 1 && j <= mb;      // columns of the job's own grid
  }
  // the lane's slot of the rows' last own column m_b, if it holds it
  const int rl = mb - j0;
  const bool last = mb >= 1 && rl >= 0 && rl < R;
  // lane l holds the code of alpha[base + l], base = 32 floor((d-1)/32)
  int acur = alpha_code(g, lane), anext = alpha_code(g, 32 + lane);
  int e2 = kLocal ? 0 : kNeg;  // the edge slot's cell of d-2
  int8_t* trow = g.trace;
#pragma unroll 2  // two diagonals a pass: the slots' values rotate by name
  for (int d = 1; d <= dmax; ++d, trow += g.pitch) {
    const int q = (d - 1) & 31;
    const int afresh = __shfl_sync(kFull, acur, q);
    if (q == 31) {
      acur = anext;
      anext = alpha_code(g, d + 32 + lane);
    }
    // slot l R - 1 of diagonal d-1 and its row; slot 0 takes row d fresh
    int e1 = __shfl_up_sync(kFull, c1[R - 1], 1);
    int ev = __shfl_up_sync(kFull, rv[R - 1], 1);
    int ed = __shfl_up_sync(kFull, rd[R - 1], 1);
    int ea = __shfl_up_sync(kFull, ac[R - 1], 1);
    if (lane == 0) {
      e1 = kLocal ? 0 : kNeg;
      ev = ed = 0;
      ea = afresh;
    }
    const int i0 = d - j0;  // the row of slot r is i0 - r
    int8_t* tp = trow + i0;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int left = r ? c1[r - 1] : e1;
      const int dg = r ? c2[r - 1] : e2;
      const int a = r ? ac[r - 1] : ea;
      int v = r ? rv[r - 1] : ev;
      int bdg = r ? rd[r - 1] : ed;
      const int i = i0 - r;
      const int diag = dg + g.sc[soff[r] + a];
      const int lf = left + gap, up = c1[r] + gap;
      const int mlu = max(lf, up);
      const int cm = max(diag, mlu);
      const int tm = diag >= mlu ? 0 : (lf >= up ? 1 : 2);
      const bool own = jown[r] && (unsigned)(i - 1) < (unsigned)nb;
      int c, t;
      bool cell, upd;  // the slot writes its trace byte; the best moves
      if (kLocal) {
        cell = own;
        const bool pos = own && cm > 0;
        c = pos ? cm : 0;
        t = pos ? tm : 3;
        upd = pos && cm > v;
      } else {
        // Row 0 and column 0 need no case of their own: their cells'
        // other neighbours are NEG (the rows above row 0, and column -1
        // at lane 0's edge), so the cell gives gap * d with code 1
        // (left) or 2 (up), as the contract has them. Cells past the
        // rectangle are computed and never read nor written.
        cell = jin[r] && (unsigned)i <= (unsigned)n;
        c = i >= 0 ? cm : kNeg;
        t = tm;
        upd = own && cm > v;
      }
      v = upd ? c : v;
      bdg = upd ? d : bdg;
      c2[r] = c1[r];
      c1[r] = c;
      rv[r] = v;
      rd[r] = bdg;
      ac[r] = a;
      if (cell) tp[-r] = (int8_t)t;
    }
    if (last) {  // one lane: its row at column m_b stores its best
      int lv = 0, ld = 0, lc = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lv = r == rl ? rv[r] : lv;
        ld = r == rl ? rd[r] : ld;
        lc = r == rl ? c1[r] : lc;
      }
      const int i = i0 - rl;
      if ((unsigned)(i - 1) < (unsigned)nb) {
        g.bv[i] = lv;
        g.bd[i] = ld;
        if (kLocal && g.cr && i == nb) g.cr[i] = lc;
      }
    }
    e2 = e1;
  }
}

// K4's sweep over the rows its job's read part fills: R = m_b / 32 + 1,
// one of 1..L.
template <int R, int L>
__device__ __forceinline__ void local_sweep(const WarpJob& g, const int8_t* be,
                                            int rows, int dmax) {
  if constexpr (R <= L) {
    if (rows <= R) warp_sweep<true, R>(g, be, dmax);
    else local_sweep<R + 1, L>(g, be, rows, dmax);
  }
}

template <bool kLocal, int L>
__global__ void __launch_bounds__(32 * kWarpJobs)
gsw_warp_kernel(const int8_t* __restrict__ alpha,   // (C, n)
                const int8_t* __restrict__ beta,    // (C, m)
                const int32_t* __restrict__ n_vec,  // (C,)
                const int32_t* __restrict__ m_vec,  // (C,)
                const int32_t* __restrict__ scores, // (5, 5)
                int gap, int C, int n, int m,
                int32_t* __restrict__ bv_out,       // (C, S)
                int32_t* __restrict__ bd_out,       // (C, S)
                int32_t* __restrict__ corner_out,   // (C, S) or null
                int8_t* __restrict__ trace) {       // (n+m, C, S)
  __shared__ int sc[25];
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  __syncthreads();  // once, before any diagonal
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpJobs + threadIdx.x / 32;
  if (b >= C) return;  // the whole warp leaves together
  const int S = n + 1;
  WarpJob g;
  g.al = alpha + (int64_t)b * n;
  g.sc = sc;
  g.trace = trace + (int64_t)b * S;
  g.pitch = (int64_t)C * S;
  g.bv = bv_out + (int64_t)b * S;
  g.bd = bd_out + (int64_t)b * S;
  g.cr = kLocal && corner_out ? corner_out + (int64_t)b * S : nullptr;
  g.n = n;
  g.m = m;
  g.nb = min(max(n_vec[b], 0), n);
  g.mb = min(max(m_vec[b], 0), m);
  g.gap = gap;
  const bool any = g.nb >= 1 && g.mb >= 1;  // the job has an own cell
  // lanes that no row stores to hold 0
  for (int s = lane; s < S; s += 32) {
    if (!(any && s >= 1 && s <= g.nb)) {
      g.bv[s] = 0;
      g.bd[s] = 0;
    }
    if (g.cr && !(any && s == g.nb)) g.cr[s] = 0;
  }
  const int8_t* be = beta + (int64_t)b * m;
  int dmax = n + m;  // K5: the padded rectangle, every diagonal
  if (kLocal) {  // K4: the job's own grid
    dmax = any ? g.nb + g.mb : 0;
    if (any) local_sweep<1, L>(g, be, g.mb / 32 + 1, dmax);
  } else {
    warp_sweep<false, L>(g, be, dmax);
  }
}

// The walk, gsw_walk_pack: one warp a job, the tile walk of
// lowmem_walk_block taken to this trace's layout, on one of three sides.
// kLeftSide (_left_full): score = corner at lane n_b; walk from (n_b,
// m_b) while the score is > 0, i and j are > 0 and the code is not 3; the
// meta holds (score, i, j) where the walk stopped. kRightSide
// (_right_full): the first lane of the maximal best value (a warp-wide
// first-max; a max <= 0 gives (0, 0) and score 0); walk from there to the
// origin with i and j clamped at 0; the meta holds (score, start i, start
// j). kLocalSide (local_align_full's glue after K4, gonomics_tpu/ops/
// wavefront.py:661-696): the right side's start on K4's bests, the left
// side's walk and stop; the meta holds (score, start i, start j, i, j)
// where it stopped, 20 bytes. All run D steps, code 4 once inactive, and
// pack min(op, 3) four to a byte, low bits first, padded with 3, after
// the little-endian meta. Trace codes are 0-3.
//
// Cell (i, j) lies on row dd = clamp(u, 0, D-1) of the trace, u = i + j
// - 1, at lane clamp(i, 0, S-1); rows of a job lie C S bytes apart, so a
// walk that reads one byte a step makes up to D dependent round trips to
// L2 or HBM. A step lowers u by at most 2 and i by at most 1, so a tile
// of TD = 32 diagonals x TL = 16 lanes whose corner (dtop, itop) is the
// current cell holds at least 16 steps: every lane of the warp takes part
// in one round of independent loads (lane x loads diagonal dtop - x, the
// 16 bytes of lanes itop - 15 .. itop, every row and lane clamped as the
// walk clamps them) into the warp's tile in shared memory, row x at 16 x
// bytes. The warp then walks the tile, one byte load a step, its address
// moved by the step itself: from cell (x, y) = (dtop - u, itop - i) of
// the tile at least min((TD - 1 - x) / 2, TL - 1 - y) + 1 steps stay in
// it, which the warp takes with no test of the tile's edges. A
// right-side step clamped at i = 0 or j = 0 that does not move stays in
// the tile. The ops go into 32-bit words, 16 steps a word, the lane g mod
// 32 keeping word g; the warp stores 32 words at a time, then, once the
// walk has stopped, its last words, the 3s after them and the meta, every
// lane a few bytes. Tiles of 32 or 64 diagonals x 16 or 32 lanes were
// timed; 32 x 16 was the fastest (PERF.md): steps, not rounds of loads,
// set the pace, and a larger tile's loads cost more than the rounds they
// save.
constexpr int kWalkWarps = 4;   // jobs (warps) a block of the walk
constexpr int kTileDiags = 32;  // TD: a diagonal a lane
constexpr int kTileLanes = 16;  // TL
// the walk's sides, as gsw_walk_pack_launch takes them
constexpr int kRightSide = 0, kLeftSide = 1, kLocalSide = 2;

// The 16 bytes at p as 4 words, from an aligned 16-byte load and one
// more where they straddle a 16-byte boundary; the words are shifted into
// place by whole words and then by a funnel shift.
__device__ __forceinline__ void load_words(const int8_t* p, uint32_t* w) {
  const uintptr_t a = (uintptr_t)p;
  const uint4* q = (const uint4*)(a & ~(uintptr_t)15);
  const int off = (int)(a & 15);
  const uint4 c0 = __ldg(q), c1 = off ? __ldg(q + 1) : make_uint4(0, 0, 0, 0);
  const uint32_t v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const int s = off >> 2, sh = 8 * (off & 3);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = s == 0 ? v[k] : s == 1 ? v[k + 1] : s == 2 ? v[k + 2] : v[k + 3];
    const uint32_t hi = s == 0 ? v[k + 1] : s == 1 ? v[k + 2] : s == 2 ? v[k + 3] : v[k + 4];
    w[k] = __funnelshift_r(lo, hi, sh);
  }
}

template <int kSide>
__global__ void __launch_bounds__(32 * kWalkWarps)
gsw_walk_pack_kernel(const int8_t* __restrict__ trace,    // (D, C, S)
                     const int32_t* __restrict__ values,  // (C, S) corner or bv
                     const int32_t* __restrict__ diags,   // (C, S) bd (right, local)
                     const int32_t* __restrict__ n_vec,   // (C,) (left)
                     const int32_t* __restrict__ m_vec,   // (C,) (left)
                     int C, int S, int D, int P,
                     uint8_t* __restrict__ out) {         // (C, meta + P)
  constexpr int TD = kTileDiags, TL = kTileLanes;
  // the left side's corner start; the left and local sides' stop on code 3
  constexpr bool kLeft = kSide == kLeftSide, kStop = kSide != kRightSide;
  constexpr int kMeta = kSide == kLocalSide ? 20 : 12;  // meta bytes
  __shared__ uint4 smem[kWalkWarps * TD];  // a row of TL bytes a diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= C) return;  // the whole warp leaves together
  uint8_t* tile = (uint8_t*)(smem + warp * TD);
  const int32_t* vrow = values + (int64_t)b * S;
  int score, i, j;
  if (kLeft) {
    i = n_vec[b];
    j = m_vec[b];
    score = vrow[min(max(i, 0), S - 1)];
  } else {
    int best = INT_MIN, arg = S;
    for (int s = lane; s < S; s += 32) {
      const int v = vrow[s];
      if (v > best) { best = v; arg = s; }
    }
    for (int k = 16; k > 0; k >>= 1) {
      const int ob = __shfl_xor_sync(kFull, best, k);
      const int oa = __shfl_xor_sync(kFull, arg, k);
      if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
    }
    if (best <= 0) {
      score = i = j = 0;
    } else {
      score = best;
      i = arg;
      j = diags[(int64_t)b * S + arg] - arg;
    }
  }
  const int i_start = i, j_start = j;
  uint8_t* row = out + (int64_t)b * (kMeta + P);
  const int8_t* tb = trace + (int64_t)b * S;  // row dd at tb + dd C S
  const int64_t pitch = (int64_t)C * S;
  int dtop = 0, itop = -TL;  // no tile yet
  OpWords ops;
  int t = 0;
  bool live = kStop ? (score > 0 && i > 0 && j > 0) : (i > 0 || j > 0);
  while (live && t < D) {
    const int u = i + j - 1;
    int x = dtop - u, y = itop - i;
    if ((unsigned)x >= (unsigned)TD || (unsigned)y >= (unsigned)TL) {
      dtop = u;
      itop = i;
      x = y = 0;
      const int lo = itop - TL + 1;
      const int dd = min(max(dtop - lane, 0), D - 1);
      const int8_t* rp = tb + dd * pitch;
      uint32_t w[4];
      if (lo >= 0 && itop <= S - 1 && !(dd == D - 1 && b == C - 1)) {
        // no clamp: every aligned 16-byte chunk loaded holds a byte of the
        // tile. It starts at or after the 16-byte boundary below a byte
        // of the trace, never before the allocation, which starts on a
        // 256-byte boundary; it ends before the next boundary above a
        // byte of the trace, past the trace's end only on its last row
        // (S >= TL = 16), which is loaded byte by byte.
        load_words(rp + lo, w);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t v = 0;
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const int ss = min(max(lo + 4 * q + z, 0), S - 1);
            v |= (uint32_t)(uint8_t)rp[ss] << (8 * z);
          }
          w[q] = v;
        }
      }
      __syncwarp();  // every lane has read the tile before
      smem[warp * TD + lane] = make_uint4(w[0], w[1], w[2], w[3]);
      __syncwarp();
    }
    // the steps that surely stay in the tile, each a byte load at p (a
    // right walk's start may have j < 0, which its first step clamps to
    // 0: that step alone, then the tile is found anew)
    int n = min(min((TD - 1 - x) >> 1, TL - 1 - y) + 1, D - t);
    if (!kStop && j < 0) n = 1;
    const uint8_t* p = tile + x * TL + (TL - 1 - y);
    for (int k = 0; k < n; ++k) {
      const uint32_t code = *p;
      if (kStop && code == 3) {  // inactive from here on
        live = false;
        break;
      }
      // 0 and 2 lower i, 0 and 1 lower j (right: clamped at 0); x grows
      // by both, y by i's
      int i2 = i - ((0x5 >> code) & 1), j2 = j - ((0x3 >> code) & 1);
      if (!kStop) {
        i2 = max(i2, 0);
        j2 = max(j2, 0);
      }
      p += (TL - 1) * (i - i2) + TL * (j - j2);
      i = i2;
      j = j2;
      ops.push(t, code, row + kMeta, P, lane);
      ++t;
      live = kStop ? (i > 0 && j > 0) : (i > 0 || j > 0);
      if (!live) break;
    }
  }
  ops.finish(t, row + kMeta, P, lane);
  if (lane < kMeta) {  // the meta, a byte a lane
    const int f = lane / 4;  // its field
    const int v = f == 0 ? score
                : f == 1 ? (kLeft ? i : i_start)
                : f == 2 ? (kLeft ? j : j_start)
                : f == 3 ? i : j;
    row[lane] = (uint8_t)((unsigned)v >> (8 * (lane % 4)));
  }
}

// The slots a lane of the warp design is built for (L): a job's m + 1
// slots fit in 32 L (the wrapper's graph_dp_design picks the smallest L
// that holds them from what gsw_dp_built reports; larger m goes to the
// block design).
#define GSW_WARP_SLOTS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(12) X(16)

// The launch of C jobs padded to a window of n bases: the warp design
// (slots > 0) kWarpJobs warps a block; the block design one block a job,
// one thread a lane (s = 0..n) up to kThreads.
struct LaunchShape {
  int threads, blocks;
};

LaunchShape launch_shape(int C, int n, int slots) {
  if (slots > 0) return {32 * kWarpJobs, (C + kWarpJobs - 1) / kWarpJobs};
  const int t = (n + 1 + 31) / 32 * 32;
  return {t < kThreads ? t : kThreads, C};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool kLocal, int L>
cudaError_t warp_launch_l(const void* alpha, const void* beta,
                          const void* n_vec, const void* m_vec,
                          const void* scores, int gap, int C, int n, int m,
                          void* bv, void* bd, void* corner, void* trace,
                          cudaStream_t stream) {
  const LaunchShape ls = launch_shape(C, n, L);
  gsw_warp_kernel<kLocal, L><<<ls.blocks, ls.threads, 0, stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)n_vec,
      (const int32_t*)m_vec, (const int32_t*)scores, gap, C, n, m,
      (int32_t*)bv, (int32_t*)bd, (int32_t*)corner, (int8_t*)trace);
  return cudaGetLastError();
}

template <bool kLocal>
int wavefront_launch(const void* alpha, const void* beta, const void* n_vec,
                     const void* m_vec, const void* scores, int gap, int C,
                     int n, int m, int slots, void* scratch,
                     void* bv, void* bd, void* corner, void* trace,
                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (slots > 0) {  // the warp design, L = slots a lane
    if (32 * slots < m + 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(
        trace, kLocal ? 3 : 0, (size_t)(n + m) * C * (n + 1), st);
    if (err != cudaSuccess) return (int)err;
    switch (slots) {
#define GSW_WARP_CASE(R)                                                   \
      case R:                                                              \
        return (int)warp_launch_l<kLocal, R>(alpha, beta, n_vec, m_vec,    \
                                             scores, gap, C, n, m, bv, bd, \
                                             corner, trace, st);
      GSW_WARP_SLOTS(GSW_WARP_CASE)
#undef GSW_WARP_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = scratch ? 0 : (size_t)(kLocal ? 6 : 5) * (n + 1) * sizeof(int32_t);
  auto kernel = scratch ? &gsw_wavefront_kernel<kLocal, true>
                        : &gsw_wavefront_kernel<kLocal, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const LaunchShape ls = launch_shape(C, n, 0);
  kernel<<<ls.blocks, ls.threads, smem, st>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)n_vec,
      (const int32_t*)m_vec, (const int32_t*)scores, gap, C, n, m,
      (int32_t*)scratch, (int32_t*)bv, (int32_t*)bd, (int32_t*)corner,
      (int8_t*)trace);
  return (int)cudaGetLastError();
}

}  // namespace

// What the warp design is built for: out[0] its jobs (warps) a block,
// out[1] the count k of slots a lane it takes, out[2..k+1] those, rising.
extern "C" int gsw_dp_built(int* out) {
  int k = 0;
  out[0] = kWarpJobs;
#define GSW_WARP_REPORT(R) out[2 + k++] = R;
  GSW_WARP_SLOTS(GSW_WARP_REPORT)
#undef GSW_WARP_REPORT
  out[1] = k;
  return 0;
}

// The launch local_wavefront_launch and gsw_right_wavefront_launch make
// for C jobs padded to a window of n bases at slots a lane (0: the block
// design): out[0] a block's threads, out[1] the blocks.
extern "C" int gsw_dp_launch_shape(int C, int n, int slots, int* out) {
  const LaunchShape ls = launch_shape(C, n, slots);
  out[0] = ls.threads;
  out[1] = ls.blocks;
  return 0;
}

extern "C" const char* gsw_dp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int local_wavefront_launch(const void* alpha, const void* beta,
                                      const void* n_vec, const void* m_vec,
                                      const void* scores, int gap, int C,
                                      int n, int m, int slots, void* scratch,
                                      void* bv, void* bd,
                                      void* corner, void* trace,
                                      void* stream) {
  return wavefront_launch<true>(alpha, beta, n_vec, m_vec, scores, gap, C, n,
                                m, slots, scratch, bv, bd, corner, trace,
                                stream);
}

extern "C" int gsw_right_wavefront_launch(const void* alpha, const void* beta,
                                          const void* n_vec, const void* m_vec,
                                          const void* scores, int gap, int C,
                                          int n, int m, int slots,
                                          void* scratch, void* bv, void* bd,
                                          void* trace, void* stream) {
  return wavefront_launch<false>(alpha, beta, n_vec, m_vec, scores, gap, C,
                                 n, m, slots, scratch, bv, bd, nullptr,
                                 trace, stream);
}

// side: kRightSide (0), kLeftSide (1) or kLocalSide (2); out (C, 12 + P)
// uint8, (C, 20 + P) for the local side.
extern "C" int gsw_walk_pack_launch(const void* trace, const void* values,
                                    const void* diags, const void* n_vec,
                                    const void* m_vec, int side, int C,
                                    int S, int D, void* out, void* stream) {
  const int P = (D + 3) / 4;
  const int blocks = (C + kWalkWarps - 1) / kWalkWarps;
  auto kernel = side == kLeftSide    ? &gsw_walk_pack_kernel<kLeftSide>
                : side == kLocalSide ? &gsw_walk_pack_kernel<kLocalSide>
                : side == kRightSide ? &gsw_walk_pack_kernel<kRightSide>
                                     : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, 32 * kWalkWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)trace, (const int32_t*)values, (const int32_t*)diags,
      (const int32_t*)n_vec, (const int32_t*)m_vec, C, S, D, P,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
