// Banded local Smith-Waterman for vote-anchored read windows, and the
// backward walk over its trace, for Hopper (sm_90a).
//
// banded_dp replaces the Pallas kernel _banded_kernel
// (gonomics_tpu/ops/wavefront.py:709, pallas_call at :850).
// banded_walk_pack replaces the lax.scan walk _banded_walk (:789) and the
// 2-bit packing after it (:874-883), which were jnp glue around the
// Pallas kernel.
//
// What bounds banded_dp on the card: integer operations. A batch of 4096
// reads x 150 rows x 64 lanes is 39.3 M band cells; the function needs
// about 19 int32 operations for each valid one (itemised in chip_smoke.py;
// ~0.73 G operations, ~44 us at the H100's int32 rate), while its one
// large output, the int8 trace, is 39.3 MB (~12 us at 3.35 TB/s). This
// kernel spends more than that count: its parallel max-prefix scan takes
// six shuffle-and-max steps a lane pair where a sequential one needs one
// max a cell. The design keeps every score in registers: one warp per
// read, each thread owning two adjacent lanes of the 64-lane band, the
// row loop inside the kernel, neighbours through warp shuffles, the
// within-row left-gap chain as a log-step max-prefix scan over shuffles.
// Only the trace (64 contiguous bytes per row and read) and the per-lane
// best cells leave the chip. The TPU kernel's five sliding profiles,
// int16 profiles and 4-bit input packing were TPU mechanisms and are not
// carried over: the substitution score is a lookup in a 5x5 table held
// in shared memory.
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
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip_code(int x) { return min(max(x, 0), 4); }

// Trace code of one cell: 3 local stop, 0 diagonal, 1 left, 2 up.
__device__ __forceinline__ int trace_code(int h, int diag, int left) {
  return h == 0 ? 3 : (h == diag ? 0 : (h == left ? 1 : 2));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_dp_kernel(const int8_t* __restrict__ reads,     // (B, L)
                 const int8_t* __restrict__ windows,   // (B, W)
                 const int32_t* __restrict__ n_vec,    // (B,)
                 const int32_t* __restrict__ m_vec,    // (B,)
                 const int32_t* __restrict__ scores,   // (5, 5)
                 int gap, int B, int L, int W,
                 int32_t* __restrict__ bv_out,         // (B, 64)
                 int32_t* __restrict__ bi_out,         // (B, 64)
                 int8_t* __restrict__ trace) {         // (L, B, 64)
  __shared__ int sc[25];
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together: shuffles stay full

  const int c0 = 2 * lane, c1 = c0 + 1;
  const int gc0 = gap * c0, gc1 = gap * c1;
  const int n = n_vec[b], m = m_vec[b];
  const int8_t* rd = reads + (int64_t)b * L;
  const int8_t* win = windows + (int64_t)b * W;
  int p0 = 0, p1 = 0;                 // row i-1 of the band (row 0 is zeros)
  int bv0 = 0, bv1 = 0, bi0 = 0, bi1 = 0;

  for (int i = 1; i <= L; ++i) {
    // cell (i, c) is valid where i <= n and 1 <= j = i + c <= m; j >= 1
    // always holds, and a row past the read has no valid cell
    const int m_row = i <= n ? m : 0;
    // sub[c] = scores[read[i-1], window[i-1+c]]; codes clipped to 0..4,
    // window positions past W read N
    const int* srow = sc + 5 * clip_code(rd[i - 1]);
    const int q0 = i - 1 + c0, q1 = q0 + 1;
    const int w0 = q0 < W ? clip_code(win[q0]) : 4;
    const int w1 = q1 < W ? clip_code(win[q1]) : 4;
    const int diag0 = p0 + srow[w0];
    const int diag1 = p1 + srow[w1];
    // up = prev[c+1] + gap; lane 64 reads 0
    int next = __shfl_down_sync(kFull, p0, 1);
    if (lane == 31) next = 0;
    // base = max(diag, up + gap), one fused DPX add-max each
    int base0 = __viaddmax_s32(p1, gap, diag0);
    int base1 = __viaddmax_s32(next, gap, diag1);
    const bool v0 = i + c0 <= m_row;
    const bool v1 = i + c1 <= m_row;
    if (!v0) base0 = kNegHalf;
    if (!v1) base1 = kNegHalf;

    // left-gap chain: inclusive max-prefix of a[c] = base[c] - gap*c over
    // the 64 lanes (pair first, then across the warp), floored at the
    // TPU scan's NEG//2 fill
    const int a0 = base0 - gc0;
    const int a1 = max(base1 - gc1, a0);
    int s = a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s = max(s, o);
    }
    int excl = __shfl_up_sync(kFull, s, 1);
    if (lane == 0) excl = kNegHalf;
    const int pre0 = max(max(a0, excl), kNegHalf);
    const int pre1 = max(max(a1, excl), kNegHalf);
    int h0 = __viaddmax_s32(pre0, gc0, 0);
    int h1 = __viaddmax_s32(pre1, gc1, 0);
    if (!v0) h0 = 0;
    if (!v1) h1 = 0;

    // left = h[c-1] + gap from the final row; lane -1 reads 0
    int prev_h = __shfl_up_sync(kFull, h1, 1);
    if (lane == 0) prev_h = 0;
    const int t0 = trace_code(h0, diag0, prev_h + gap);
    const int t1 = trace_code(h1, diag1, h0 + gap);
    const uint16_t pair = (uint16_t)(uint8_t)t0 | ((uint16_t)(uint8_t)t1 << 8);
    *reinterpret_cast<uint16_t*>(trace + ((int64_t)(i - 1) * B + b) * kBand + c0) = pair;

    // best cell per lane, strictly greater: the smallest row wins
    if (h0 > bv0) { bv0 = h0; bi0 = i; }
    if (h1 > bv1) { bv1 = h1; bi1 = i; }
    p0 = h0;
    p1 = h1;
  }
  *reinterpret_cast<int2*>(bv_out + (int64_t)b * kBand + c0) = make_int2(bv0, bv1);
  *reinterpret_cast<int2*>(bi_out + (int64_t)b * kBand + c0) = make_int2(bi0, bi1);
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

extern "C" int banded_dp_launch(const void* reads, const void* windows,
                                const void* n_vec, const void* m_vec,
                                const void* scores, int gap, int B, int L,
                                int W, void* bv, void* bi, void* trace,
                                void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  banded_dp_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)reads, (const int8_t*)windows, (const int32_t*)n_vec,
      (const int32_t*)m_vec, (const int32_t*)scores, gap, B, L, W,
      (int32_t*)bv, (int32_t*)bi, (int8_t*)trace);
  return (int)cudaGetLastError();
}

// The trace must be 16-byte aligned (the wrapper's check).
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
