// Banded local Smith-Waterman for vote-anchored read windows, and the
// backward walk over its trace, for Hopper (sm_90a).
//
// banded_dp_kernel replaces the Pallas kernel _banded_kernel
// (gonomics_tpu/ops/wavefront.py:709, pallas_call at :850). It has two
// modes, one DP step:
// - the trace mode (banded_dp) writes the int8 trace (L, B, 64) and the
//   per-lane bests (bv, bi), the contract of _banded_kernel;
// - the fused mode (banded_align_fused) keeps a read's trace in shared
//   memory at 2 bits a code, then in the same block finds the best cell
//   (best_cell, ops/banded.py), walks back from it (_banded_walk, :789)
//   and packs the ops (:874-883): the whole of banded_align_full (:815)
//   in one launch, with no trace in device memory.
// banded_walk_pack replaces the lax.scan walk _banded_walk and the 2-bit
// packing after it, which were jnp glue around the Pallas kernel; it
// walks the trace mode's trace where the fused mode's does not fit a
// block's shared memory (long reads).
//
// What bounds the DP on the card: integer operations. A batch of 4096
// reads x 150 rows x 64 lanes is 39.3 M band cells; the function needs
// about 19 int32 operations for each valid one (itemised in chip_smoke.py;
// ~0.73 G operations, ~44 us at the H100's int32 rate), while the trace
// mode's one large output, the int8 trace, is 39.3 MB (~12 us at 3.35
// TB/s); the fused mode writes no trace, only 75 bytes a read. The design
// spends few operations beyond that count. A thread owns R adjacent lanes
// of the 64-lane band (R = 2, 4 or 8, a template argument), so G = 64 / R
// threads hold a read and 32 / G reads share a warp; the row loop runs
// inside the kernel with every score in registers. The within-row
// left-gap chain H[c] = max(0, max_{k<=c} base[k] + gap (c - k)) is a
// sequential max-prefix over a thread's R cells (one max a cell), a
// log2(G)-step shuffle scan of the threads' totals inside the read's
// segment of the warp (the shuffles' width keeps the reads apart), one
// shuffle for the exclusive value and one max a cell to fix up; the up
// and left neighbours are one shuffle each at the thread's edge. The
// read's codes and its window's codes are staged once, clipped to 0..4
// and the window padded with N to L + 64 columns, in shared memory with
// 16-byte loads, so the row loop loads nothing from device memory; the
// substitution score is a lookup in the 5x5 table in shared memory. Reads
// whose staged codes do not fit a block's shared memory even at one warp
// (above about 116 kbp) take the trace mode's global-codes variant, which
// keeps a thread's R window codes in registers and loads one byte a row
// (see the note above the kernel; ops/banded.py banded_plan). The
// TPU kernel's five sliding profiles, int16 profiles and 4-bit input
// packing were TPU mechanisms and are not carried over. The fused mode
// writes a thread's R codes of a row into the read's trace in shared
// memory (lane c at bits 2 (c mod 4) of byte c / 4 of a 16-byte row: 2.4
// KB for 150 rows), finds the best cell by a butterfly over the read's
// threads, and walks from the read's first thread, a shared-memory byte
// load a step, writing the packed ops a byte at a time. The walk's steps
// depend on each other; its cost grows with the warps that walk, so the
// fused mode's plan takes 8 lanes a thread (4 reads a warp) where the
// reads fill the card (ops/banded.py banded_plan).
//
// banded_walk_pack is one warp a read walking a tile of the trace at a
// time (see the note above its kernel): bound by the latency of its
// dependent steps and of the rounds of loads that bring the tiles, not by
// bytes or operations.
//
// Each entry returns cudaGetLastError() so that the caller can raise on
// a launch the runtime refused.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_ops.cuh"

namespace {

constexpr int kBand = 64;                  // BW: lanes c of row i are columns j = i + c
constexpr int kNegHalf = -(1 << 29);       // NEG // 2 with NEG = -(2**30)
constexpr int kMaxWarps = 8;               // warps a block of banded_dp_kernel
constexpr unsigned kFull = 0xffffffffu;

// Trace code of one cell: 3 local stop, 0 diagonal, 1 left, 2 up.
__device__ __forceinline__ int trace_code(int h, int diag, int left) {
  return h == 0 ? 3 : (h == diag ? 0 : (h == left ? 1 : 2));
}

// The pitch in shared memory of a staged row of `cols` codes: a multiple
// of 16 bytes, and 64 bytes past a multiple of 128, so that the rows of
// two reads of a warp start 16 banks apart.
__host__ __device__ __forceinline__ int staged_pitch(int cols) {
  return (cols + 127) / 128 * 128 + 64;
}

// Reads a block holds at R lanes a thread and WB warps.
__host__ __device__ __forceinline__ int reads_per_block(int R, int WB) { return WB * R / 2; }

// A block's dynamic shared memory: the staged read and window codes of
// its reads and, in the fused mode, their traces at 2 bits a code (16
// bytes a row); none where the codes stay in device memory.
size_t banded_smem(int R, int WB, int L, bool fused, bool global) {
  if (global) return 0;
  return (size_t)reads_per_block(R, WB) *
         (staged_pitch(L) + staged_pitch(L + kBand) + (fused ? (size_t)16 * L : 0));
}

// Rows b0 .. b0 + RB - 1 of the (B, S) int8 array g into RB rows of
// `pitch` bytes at s, columns 0 .. cols - 1, codes clipped to 0..4;
// columns at or past S and rows at or past B read 4 (N). The block's rows
// are one contiguous span of g: its aligned 16-byte chunks are loaded
// (each holds a byte of the span, so none leaves g's pages), clipped four
// bytes at a time, and their bytes scattered to the rows. g must be
// 16-byte aligned.
__device__ void stage_rows(const int8_t* __restrict__ g, int B, int S, int b0, int RB,
                           uint8_t* __restrict__ s, int pitch, int cols) {
  const int nb = max(0, min(RB, B - b0));
  for (int x = threadIdx.x; x < RB * cols; x += blockDim.x) {
    const int r = x / cols, q = x - r * cols;
    if (r >= nb || q >= S) s[r * pitch + q] = 4;
  }
  if (nb == 0) return;
  const int64_t s0 = (int64_t)b0 * S, s1 = (int64_t)(b0 + nb) * S;
  const int64_t a0 = s0 & ~(int64_t)15;
  const int chunks = (int)((s1 - a0 + 15) >> 4);
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const int64_t p = a0 + 16 * (int64_t)k;
    uint4 v = __ldg(reinterpret_cast<const uint4*>(g + p));
    v.x = __vmins4(__vmaxs4(v.x, 0u), 0x04040404u);
    v.y = __vmins4(__vmaxs4(v.y, 0u), 0x04040404u);
    v.z = __vmins4(__vmaxs4(v.z, 0u), 0x04040404u);
    v.w = __vmins4(__vmaxs4(v.w, 0u), 0x04040404u);
    const int64_t off = p - s0;  // the span's byte at this chunk's first
    const int e0 = off < 0 ? (int)-off : 0;
    int r = (int)((off + e0) / S);
    int q = (int)(off + e0 - (int64_t)r * S);
    for (int e = e0; e < 16 && r < nb; ++e) {
      const uint32_t w = e < 8 ? (e < 4 ? v.x : v.y) : (e < 12 ? v.z : v.w);
      if (q < cols) s[r * pitch + q] = (uint8_t)(w >> (8 * (e & 3)));
      if (++q == S) {
        q = 0;
        ++r;
      }
    }
  }
}

// The clipped code of column q of a (B, S) row g of codes in device
// memory, 4 (N) at columns at or past S and for rows past B (g null): the
// staged copy's contents, for the trace mode's global-codes variant.
__device__ __forceinline__ int global_code(const int8_t* g, int S, int q) {
  return g != nullptr && q < S ? min(max((int)__ldg(g + q), 0), 4) : 4;
}

// The outputs of banded_dp_kernel: bv, bi and trace in the trace mode;
// score .. packed in the fused mode.
struct BandedOut {
  int32_t* bv;        // (B, 64)
  int32_t* bi;        // (B, 64)
  int8_t* trace;      // (L, B, 64)
  int32_t* score;     // (B,)
  int32_t* i_end;     // (B,)
  int32_t* j_end;     // (B,)
  int32_t* i0;        // (B,)
  int32_t* j0;        // (B,)
  uint8_t* packed;    // (B, P)
};

// R consecutive int32 of a thread, stored at p (aligned to 4 R bytes)
template <int R>
__device__ __forceinline__ void store_lanes(int32_t* p, const int (&v)[R]) {
  if constexpr (R == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < R; k += 4)
      *reinterpret_cast<int4*>(p + k) = make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// Banded DP of a block of WB warps at R lanes a thread (G = 64 / R
// threads a read, 32 / G reads a warp): read r of the block is lanes
// G r' .. G r' + G - 1 of warp r / (32 / G), and thread t of a read owns
// lanes c = t R .. t R + R - 1. Lanes whose read is past B take part in
// every shuffle (their cells are all invalid) and store nothing.
//
// kGlobal (the trace mode only): the codes stay in device memory, for
// reads whose staged read and window do not fit a block's shared memory
// even at one warp (above about 116 kbp on an H100). A thread keeps the
// window codes of its R lanes in registers: row i's lane c reads column
// i - 1 + c, so from one row to the next its codes move down one lane and
// it loads one byte, column i - 1 + t R + R - 1, through the read-only
// cache; the read's code of the row is one byte that its G threads load
// alike. The values read are those of the staged copy: clipped to 0..4, 4
// at columns at or past W and for reads past B.
template <int R, bool kFused, bool kGlobal = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
banded_dp_kernel(const int8_t* __restrict__ reads,     // (B, L)
                 const int8_t* __restrict__ windows,   // (B, W)
                 const int32_t* __restrict__ n_vec,    // (B,)
                 const int32_t* __restrict__ m_vec,    // (B,)
                 const int32_t* __restrict__ scores,   // (5, 5)
                 int gap, int B, int L, int W, int D, int P, BandedOut out) {
  constexpr int G = kBand / R;
  constexpr int RW = 32 / G;  // reads a warp
  static_assert(!(kFused && kGlobal), "the fused mode stages its codes");
  extern __shared__ uint4 dyn[];
  __shared__ int sc[25];
  const int RB = (blockDim.x >> 5) * RW;
  const int b0 = blockIdx.x * RB;
  const int pr = staged_pitch(L), pw = staged_pitch(L + kBand);
  uint8_t* rs = reinterpret_cast<uint8_t*>(dyn);
  uint8_t* ws = rs + RB * pr;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  if constexpr (!kGlobal) {
    stage_rows(reads, B, L, b0, RB, rs, pr, L);
    stage_rows(windows, B, W, b0, RB, ws, pw, L + kBand);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);
  const int r = (threadIdx.x >> 5) * RW + lane / G;
  const int b = b0 + r;
  const bool live = b < B;
  const int n = live ? n_vec[b] : 0, m = live ? m_vec[b] : 0;
  const uint8_t* rrow = rs + r * pr;
  const uint8_t* wrow = ws + r * pw + t * R;
  uint8_t* tr = ws + RB * pw + r * 16 * L;  // the fused mode's trace, 16 bytes a row
  // kGlobal: the read's and its window's codes in device memory (null
  // past B), and the window codes of the thread's lanes for the row
  const int8_t* gread = live ? reads + (int64_t)b * L : nullptr;
  const int8_t* gwin = live ? windows + (int64_t)b * W : nullptr;
  int wv[R];

  int gc[R], p[R], bv[R], bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    gc[k] = gap * (t * R + k);
    p[k] = bv[k] = bi[k] = 0;  // row 0 of the band is zeros
    // "row 0"'s columns t R + k - 1; lane 0's is shifted out unread
    if constexpr (kGlobal) wv[k] = k ? global_code(gwin, W, t * R + k - 1) : 4;
  }
  for (int i = 1; i <= L; ++i) {
    // cell (i, c) is valid where i <= n and j = i + c <= m (j >= 1 always
    // holds): lane k of this thread where k <= lim
    const int lim = (i <= n ? m : 0) - i - t * R;
    const uint8_t* wq = wrow + i - 1;  // window column i - 1 + c, c = t R + k
    int rcode;
    if constexpr (kGlobal) {
#pragma unroll
      for (int k = 0; k + 1 < R; ++k) wv[k] = wv[k + 1];
      wv[R - 1] = global_code(gwin, W, i - 1 + t * R + R - 1);
      rcode = global_code(gread, L, i - 1);
    } else {
      rcode = rrow[i - 1];
    }
    const int* srow = sc + 5 * rcode;
    // up = prev[c + 1] + gap; lane 64 reads 0
    int next = __shfl_down_sync(kFull, p[0], 1, G);
    if (t == G - 1) next = 0;
    int diag[R], pre[R];
    int s = kNegHalf;  // the TPU scan's NEG//2 fill
#pragma unroll
    for (int k = 0; k < R; ++k) {
      diag[k] = p[k] + srow[kGlobal ? wv[k] : wq[k]];
      // base = max(diag, up + gap) as one DPX add-max, NEG//2 where invalid;
      // then the inclusive max-prefix of a = base - gap c over the thread
      const int base = k <= lim ? __viaddmax_s32(k + 1 < R ? p[k + 1] : next, gap, diag[k])
                                : kNegHalf;
      s = max(s, base - gc[k]);
      pre[k] = s;
    }
    // the max-prefix of the threads' totals over the read's G threads; a
    // shuffle from before the segment's start returns the lane's own value
#pragma unroll
    for (int off = 1; off < G; off <<= 1) s = max(s, __shfl_up_sync(kFull, s, off, G));
    int excl = __shfl_up_sync(kFull, s, 1, G);
    if (t == 0) excl = kNegHalf;
    int h[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      h[k] = k <= lim ? __viaddmax_s32(max(pre[k], excl), gc[k], 0) : 0;

    // left = h[c - 1] + gap from the final row; lane -1 reads 0
    int hl = __shfl_up_sync(kFull, h[R - 1], 1, G);
    if (t == 0) hl = 0;
    uint32_t code[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      code[k] = trace_code(h[k], diag[k], (k ? h[k - 1] : hl) + gap);
    if constexpr (kFused) {
      // lane c's code at bits 2 (c mod 4) of byte c / 4 of the row
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < R; ++k) bits |= code[k] << (2 * k);
      uint8_t* row = tr + (i - 1) * 16;
      if constexpr (R == 2) {
        const uint32_t hi = __shfl_down_sync(kFull, bits, 1, G);
        if (!(t & 1)) row[t >> 1] = (uint8_t)(bits | hi << 4);
      } else if constexpr (R == 4) {
        row[t] = (uint8_t)bits;
      } else {
        reinterpret_cast<uint16_t*>(row)[t] = (uint16_t)bits;
      }
    } else if (live) {
      // a byte a lane, one aligned store of R bytes
      uint32_t word[(R + 3) / 4] = {};
#pragma unroll
      for (int k = 0; k < R; ++k) word[k >> 2] |= code[k] << (8 * (k & 3));
      int8_t* row = out.trace + ((int64_t)(i - 1) * B + b) * kBand + t * R;
      if constexpr (R == 2) {
        *reinterpret_cast<uint16_t*>(row) = (uint16_t)word[0];
      } else if constexpr (R == 4) {
        *reinterpret_cast<uint32_t*>(row) = word[0];
      } else {
        *reinterpret_cast<uint2*>(row) = make_uint2(word[0], word[1]);
      }
    }
    // best cell a lane, strictly greater: the smallest row wins
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (h[k] > bv[k]) {
        bv[k] = h[k];
        bi[k] = i;
      }
      p[k] = h[k];
    }
  }

  if constexpr (!kFused) {
    if (live) {
      store_lanes<R>(out.bv + (int64_t)b * kBand + t * R, bv);
      store_lanes<R>(out.bi + (int64_t)b * kBand + t * R, bi);
    }
  } else {
    // best_cell: the max over the 64 lanes, the first lane holding it and
    // that lane's row (a butterfly over the read's G threads)
    int mv = bv[0], mc = t * R, mi = bi[0];
#pragma unroll
    for (int k = 1; k < R; ++k) {
      if (bv[k] > mv) {
        mv = bv[k];
        mc = t * R + k;
        mi = bi[k];
      }
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const int ov = __shfl_xor_sync(kFull, mv, off, G);
      const int oc = __shfl_xor_sync(kFull, mc, off, G);
      const int oi = __shfl_xor_sync(kFull, mi, off, G);
      if (ov > mv || (ov == mv && oc < mc)) {
        mv = ov;
        mc = oc;
        mi = oi;
      }
    }
    __syncwarp();  // the read's trace rows, written by its G threads
    if (live && t == 0) {
      // the walk (_banded_walk): code 0 -> i-1; 1 -> c-1; 2 -> i-1, c+1;
      // 3, or i = 0, stops; cell (i, c) at row clamp(i - 1, 0, L-1),
      // column clamp(c, 0, 63). The walk starts at 1 <= i <= L and stops
      // at i = 0, so its row needs no clamp: a row pointer moves with i.
      // Ops four a byte, low bits first, 3 from the stop on; a byte a
      // round of four steps.
      int i = mi, c = mc;
      const uint8_t* row = tr + (i - 1) * 16;
      uint8_t* ops = out.packed + (int64_t)b * P;
      bool walking = mv > 0;
      for (int q = 0; q < P; ++q) {
        uint32_t byte = 0xff;
        if (walking) {
          byte = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t code = 3;
            if (walking && 4 * q + e < D) {
              const int cc = min(max(c, 0), kBand - 1);
              code = (row[cc >> 2] >> (2 * (cc & 3))) & 3;
            }
            if (code == 3) {
              walking = false;
            } else {
              const int di = (int)(~code & 1);          // 0 and 2 lower i
              c += (int)(code >> 1) - (int)(code & 1);  // 1 lowers c, 2 raises it
              i -= di;
              row -= 16 * di;
              walking = i > 0;
            }
            byte |= code << (2 * e);
          }
        }
        ops[q] = (uint8_t)byte;
      }
      out.score[b] = mv;
      out.i_end[b] = mi;
      out.j_end[b] = mi + mc;
      out.i0[b] = i;
      out.j0[b] = i + c;
    }
  }
}

// Backward walk from (i_end, c_end): code 0 -> i-1; 1 -> c-1; 2 -> i-1,
// c+1; 3, or an inactive read, emits 4 and stops (trace codes are 0-3).
// Cell (i, c) lies on row clamp(i - 1, 0, L-1) at column clamp(c, 0, 63);
// the rows of a read lie B 64 bytes apart, so a walk that reads one byte a
// step makes up to D dependent round trips to L2 or HBM. One warp walks
// one read. A step lowers the row by at most 1 and every column is in a
// 64-byte row, so a tile of the 32 rows rtop - 31 .. rtop whose top is the
// current row holds at least 32 steps, and the walk leaves it only through
// its top row: lane x loads row clamp(rtop - x, 0, L-1), 64-byte aligned,
// as four aligned 16-byte loads, all lanes in one round, into the warp's
// 2 KB tile in shared memory, and the warp walks the tile, one byte load a
// step, its row moved by the step itself: from row x of the tile the next
// 32 - x steps stay in it, which the warp takes with no test of the
// tile's edge. Ops are packed four a byte, low bits first, as min(op, 3),
// padded with 3, as OpWords stores them; i0 and c0 from lane 0. Steps, not
// rounds of loads, set the pace (PERF.md): the tile held in registers (a
// shuffle a step) and the next tile loaded while one is walked were both
// timed slower.
constexpr int kWalkWarps = 8;  // reads (warps) a block of the walk

__global__ void __launch_bounds__(32 * kWalkWarps)
banded_walk_pack_kernel(const int8_t* __restrict__ trace,  // (L, B, 64)
                        const int32_t* __restrict__ i_end,
                        const int32_t* __restrict__ c_end,
                        const uint8_t* __restrict__ active,
                        int B, int L, int D, int P,
                        int32_t* __restrict__ i0_out,
                        int32_t* __restrict__ c0_out,
                        uint8_t* __restrict__ packed) {    // (B, P)
  __shared__ uint4 smem[kWalkWarps * 32 * 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= B) return;  // the whole warp leaves together
  int i = i_end[b], c = c_end[b];
  uint8_t* out = packed + (int64_t)b * P;
  const int8_t* tb = trace + (int64_t)b * kBand;  // row r at tb + r B 64
  const int64_t pitch = (int64_t)B * kBand;
  int rtop = -1;  // no tile yet (the walk reads rows >= 0)
  uint4* mine = smem + (warp * 32 + lane) * 4;
  const uint8_t* tile = (const uint8_t*)(smem + warp * 32 * 4);
  OpWords ops;
  int t = 0;
  bool live = active[b] != 0 && i > 0;
  while (live && t < D) {
    int x = rtop - (i - 1);
    if ((unsigned)x > 31u) {
      rtop = i - 1;
      x = 0;
      const uint4* src = (const uint4*)(tb + (int64_t)min(max(rtop - lane, 0), L - 1) * pitch);
      uint4 cur[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[q] = __ldg(src + q);
      __syncwarp();  // every lane has read the tile before
#pragma unroll
      for (int q = 0; q < 4; ++q) mine[q] = cur[q];
      __syncwarp();
    }
    // the steps that surely stay in the tile, each a byte load in row x
    const int n = min(32 - x, D - t);
    const uint8_t* p = tile + x * kBand;
    for (int k = 0; k < n; ++k) {
      const uint32_t code = p[min(max(c, 0), kBand - 1)];
      if (code == 3) {  // inactive from here on
        live = false;
        break;
      }
      const int di = ~code & 1;               // 0 and 2 lower i
      c += (int)(code >> 1) - (int)(code & 1);  // 1 lowers c, 2 raises it
      i -= di;
      p += di * kBand;
      ops.push(t, code, out, P, lane);
      ++t;
      if (i == 0) {
        live = false;
        break;
      }
    }
  }
  ops.finish(t, out, P, lane);
  if (lane == 0) {
    i0_out[b] = i;
    c0_out[b] = c;
  }
}

}  // namespace

extern "C" const char* banded_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

using DpKernel = void (*)(const int8_t*, const int8_t*, const int32_t*, const int32_t*,
                          const int32_t*, int, int, int, int, int, int, BandedOut);

// The lanes a thread banded_dp_kernel is built for.
#define BANDED_LANES(X) X(2) X(4) X(8)

// The kernel's variants: the trace mode with its codes staged, the fused
// mode, and the trace mode with its codes in device memory.
constexpr int kVariants = 3;

DpKernel dp_kernel(int R, bool fused, bool global) {
#define DP_CASE(X)                                                        \
  if (R == X)                                                             \
    return fused ? (global ? nullptr : banded_dp_kernel<X, true>)         \
                 : (global ? banded_dp_kernel<X, false, true> : banded_dp_kernel<X, false>);
  BANDED_LANES(DP_CASE)
#undef DP_CASE
  return nullptr;
}

DpKernel dp_variant(int R, int v) { return dp_kernel(R, v == 1, v == 2); }

// A launch of either mode for B reads of L at R lanes a thread and WB
// warps a block, its codes staged or (global, the trace mode) read from
// device memory; out: the mode's outputs (BandedOut).
int dp_launch(bool fused, bool global, const void* reads, const void* windows,
              const void* n_vec, const void* m_vec, const void* scores, int gap, int B,
              int L, int W, int D, int P, int R, int WB, const BandedOut& out,
              void* stream) {
  const DpKernel kernel = dp_kernel(R, fused, global);
  if (kernel == nullptr || WB < 1 || WB > kMaxWarps || L < 0 ||
      (uintptr_t)reads % 16 || (uintptr_t)windows % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = banded_smem(R, WB, L, fused, global);
  const int RB = reads_per_block(R, WB);
  kernel<<<(B + RB - 1) / RB, 32 * WB, smem, (cudaStream_t)stream>>>(
      (const int8_t*)reads, (const int8_t*)windows, (const int32_t*)n_vec,
      (const int32_t*)m_vec, (const int32_t*)scores, gap, B, L, W, D, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

// What banded_dp_kernel is built for, written to out: the most warps a
// block has, the most dynamic shared memory every instance can take on
// this device (bytes: the opt-in less the instance's static part), the
// number of lane counts a thread, and for each count, rising: the count,
// then the registers and local (spill) bytes a thread of the trace mode,
// of the fused mode and of the trace mode with its codes in device
// memory. It also lets every instance take its most on the current
// device, once (a launch above 48 KB needs it), so that no launch sets an
// attribute.
extern "C" int banded_built(void* out) {
  int* res = (int*)out;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  res[0] = kMaxWarps;
  res[1] = optin;
  int k = 0;
#define DP_REPORT(X)                                                     \
  {                                                                      \
    int* e = res + 3 + (1 + 2 * kVariants) * k++;                        \
    e[0] = X;                                                            \
    for (int v = 0; v < kVariants && err == cudaSuccess; ++v) {          \
      cudaFuncAttributes fa;                                             \
      err = cudaFuncGetAttributes(&fa, (const void*)dp_variant(X, v));   \
      e[1 + 2 * v] = fa.numRegs;                                         \
      e[2 + 2 * v] = (int)fa.localSizeBytes;                             \
      res[1] = min(res[1], optin - (int)fa.sharedSizeBytes);             \
      if (err == cudaSuccess)                                            \
        err = cudaFuncSetAttribute(dp_variant(X, v),                     \
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                   optin - (int)fa.sharedSizeBytes);     \
    }                                                                    \
  }
  BANDED_LANES(DP_REPORT)
#undef DP_REPORT
  res[2] = k;
  return (int)err;
}

// The launch of banded_dp_kernel (fused or not, its codes staged or
// global) for B reads of L at R lanes a thread and WB warps a block,
// written to out (five ints): a block's threads, the blocks, a block's
// shared memory (static and dynamic; the dynamic part is banded_smem),
// and the blocks an SM holds at once. Above 48 KB of shared memory it
// needs banded_built first.
extern "C" int banded_shape(int B, int L, int R, int WB, int fused, int global, void* out) {
  const DpKernel kernel = dp_kernel(R, fused != 0, global != 0);
  if (kernel == nullptr || WB < 1 || WB > kMaxWarps || L < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = banded_smem(R, WB, L, fused != 0, global != 0);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  int* res = (int*)out;
  const int RB = reads_per_block(R, WB);
  res[0] = 32 * WB;
  res[1] = (B + RB - 1) / RB;
  res[2] = (int)(fa.sharedSizeBytes + smem);
  res[3] = (int)smem;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(res + 4, kernel, 32 * WB, smem);
  return (int)err;
}

// The trace mode: bv, bi (B, 64) int32 and the trace (L, B, 64) int8,
// its codes staged in shared memory or (global) read from device memory.
// reads and windows must be 16-byte aligned (the wrapper's check).
extern "C" int banded_dp_launch(const void* reads, const void* windows,
                                const void* n_vec, const void* m_vec,
                                const void* scores, int gap, int B, int L,
                                int W, int R, int WB, int global, void* bv,
                                void* bi, void* trace, void* stream) {
  BandedOut out = {};
  out.bv = (int32_t*)bv;
  out.bi = (int32_t*)bi;
  out.trace = (int8_t*)trace;
  return dp_launch(false, global != 0, reads, windows, n_vec, m_vec, scores, gap, B, L, W,
                   0, 0, R, WB, out, stream);
}

// The fused mode: score, i_end, j_end, i0, j0 (B,) int32 and the walk's
// D ops packed into (B, P) uint8.
extern "C" int banded_fused_launch(const void* reads, const void* windows,
                                   const void* n_vec, const void* m_vec,
                                   const void* scores, int gap, int B, int L,
                                   int W, int D, int P, int R, int WB,
                                   void* score, void* i_end, void* j_end,
                                   void* i0, void* j0, void* packed,
                                   void* stream) {
  BandedOut out = {};
  out.score = (int32_t*)score;
  out.i_end = (int32_t*)i_end;
  out.j_end = (int32_t*)j_end;
  out.i0 = (int32_t*)i0;
  out.j0 = (int32_t*)j0;
  out.packed = (uint8_t*)packed;
  return dp_launch(true, false, reads, windows, n_vec, m_vec, scores, gap, B, L, W, D, P,
                   R, WB, out, stream);
}

extern "C" int banded_walk_pack_launch(const void* trace, const void* i_end,
                                       const void* c_end, const void* active,
                                       int B, int L, int D, int P, void* i0,
                                       void* c0, void* packed, void* stream) {
  const int blocks = (B + kWalkWarps - 1) / kWalkWarps;
  banded_walk_pack_kernel<<<blocks, 32 * kWalkWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)trace, (const int32_t*)i_end, (const int32_t*)c_end,
      (const uint8_t*)active, B, L, D, P, (int32_t*)i0, (int32_t*)c0,
      (uint8_t*)packed);
  return (int)cudaGetLastError();
}
