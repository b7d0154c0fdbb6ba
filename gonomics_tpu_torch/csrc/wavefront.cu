// Anti-diagonal wavefront DP for batched pairwise global alignment, for
// Hopper (sm_90a): the three kernels of the lowmem affine aligner (the
// forward with a strip mode, the sequence-sharded aligner's forward), two
// score-only affine kernels (the streamed one, and the diagonal readout
// that serves the affine score mode and the row-blocked entry point), and
// the kernel of the pairwise aligner's trace (global affine alignment with
// a trace, global linear-gap alignment with a trace and in score mode),
// the last three at the end of this file, in that order.
//
// Cell (i, j) lies on diagonal d = i + j at lane s = i. On a diagonal the
// three Gotoh states have no dependency between lanes: I reads (d-1, s),
// D reads (d-1, s-1), M reads (d-2, s-1). The TPU kernels' (B, S) lane
// layout, sliding beta window and five precomputed profiles are TPU
// mechanisms and are not carried over: the substitution score is a lookup
// in the 5x5 table, as scores[row(beta code), clip(alpha code)] like the
// TPU kernels' profile select (_select_score :85, _build_inputs :393).
//
// Each entry returns cudaGetLastError() so that the caller can raise on
// a launch the runtime refused.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);  // NEG = -(2**30)
constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ int max3(int a, int b, int c) { return max(max(a, b), c); }

// tie order M(0) > I(1) > D(2), as _argmax3 (wavefront.py:69)
__device__ __forceinline__ int argmax3(int a, int b, int c) {
  return (a >= b && a >= c) ? 0 : (b >= c ? 1 : 2);
}

// Substitution score of interior cell (s, j): alpha codes are clipped
// to 0..4; a beta code picks the score row as _select_score does: 0 -> 0,
// 1 or negative -> 1, 2 -> 2, 3 -> 3, 4 or more -> 4.
__device__ __forceinline__ int alpha_column(int a) { return min(max(a, 0), 4); }
__device__ __forceinline__ int beta_row(int bc) {
  return bc < 2 ? (bc == 0 ? 0 : 1) : min(bc, 4);
}
__device__ __forceinline__ int substitution(const int* sc, const int8_t* al,
                                            const int8_t* be, int s, int j) {
  return sc[beta_row(be[j - 1]) * 5 + alpha_column(al[s - 1])];
}

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
// writes the packed trace (K, B, W). Each pair computes its wlo from the
// walk's current row i on the card, so the block loop needs no round trip
// to the host. The window's lane 0 takes its own value as its s-1
// neighbour, as the Pallas kernel's _shift does.
//
// Its design has no barrier a diagonal. The window is cut into strips of
// 32 L lanes, one warp a strip; lane l of a warp owns L consecutive
// window lanes and keeps their M, I, D of diagonals d-1 and d-2 in
// registers, with their alpha codes and a sliding window of their beta
// score rows (one new beta byte a diagonal, loaded a diagonal ahead). A
// cell reads only lane s-1, so within a thread that is its own register,
// across threads of a warp three shuffles of the last diagonal's values
// (the d-2 triple is the one received the step before), and across
// strips the last lane of the strip below: lane 31 of warp g writes it
// each diagonal into a ring of kBwdRing slots in the shared memory of
// warp g+1's block, each of M, I, D as one 64-bit word that carries the
// diagonal's tag beside the value, and warp g+1 reads the words of
// diagonal d-1 until their tags say they are written, so no fence and no
// separate flag stand between the two. The whole warp waits, all lanes
// reading the same word: a lane that spins alone while the others wait
// for it to reconverge made a step about three times as slow. Warp g+1
// reports every kBwdPeriod diagonals how many it has read, and warp g
// does not overwrite a slot still unread, so the strips run pipelined,
// each a diagonal or two behind the one below. One pair is one thread-block
// cluster of CL blocks of NW warps; the strip edge between blocks goes
// through distributed shared memory. A cluster barrier before the loop
// (the rings are cleared) and after it (no block leaves while another may
// still write into its shared memory) are the only barriers. A window
// wider than CL NW strips (above 32,768 lanes at 8 blocks of 16 warps of
// 8 lanes) is swept in passes: warp g takes strip g of each pass in turn,
// the ring's tags and counts run on over the passes, and the last strip
// of a pass hands its edge, all K diagonals of it, to the first strip of
// the next through a zeroed global buffer of tagged words, which needs no
// count since nothing in it is overwritten. The wrapper picks L and CL
// (ops/wavefront.py bwd_window_plan); the launch sets NW and the passes.
//
// lowmem_walk_block replaces the jnp walk _walk_block (:1102): one warp
// a pair walks K steps back over the block's trace, carrying (i, j, k) in
// device memory from block to block. A step moves the walk at most one
// lane and two diagonals down, so a tile of 32 diagonals x 16 lanes whose
// corner is the current cell holds at least 15 steps: lane x of the warp
// loads the 16 bytes of diagonal dtop - x in one round of independent
// loads (one or two aligned 16-byte loads; byte by byte, each row and
// column clamped as the walk clamps them, at the window's edges), and the
// warp then walks inside the tile from registers, one shuffle a step,
// until the walk leaves it. About K/15 rounds of loads replace the K
// dependent loads of a walk that reads one byte a step.
//
// State of the forward: three slots (the Pallas kernels' two parity
// slots race on a GPU: a thread would read lane s-1 of the slot that
// thread s-1 is overwriting), in shared memory when 9 x
// lanes x 4 bytes fit (the wrapper's SMEM_STATE_BYTES_MAX), else in a
// global scratch of 9 x lanes int32 a block that stays in L2. At the
// full-width shape (16 pairs of 16,384 x 16,384, K = 1024) the forward's
// state is 590 KB a pair, 98 KB a block of a cluster of 6 (shared).
//
// What bounds them on the card: the forward's function by integer
// operations (10 a cell in score mode, 4.3 G cells a run at full width:
// ~0.16 ms a block at the int32 rate of all 132 SMs). The cluster design
// takes ~16x that: a diagonal costs ~0.5 ns a lane a block sweeps plus
// ~1.1 us whatever its lanes (tools/lowmem_timing.py k6). The backward
// window by operations too (26 a cell with its trace, ~0.07 ms a block at
// full width); the strips take ~10x that, bound by the latency of a
// warp-step: ~800 cycles for one strip alone, ~1,400 at the main shape,
// where two warps share each of an SM's schedulers and wait on each
// other's edges (tools/lowmem_timing.py k7). The walk by the latency of a
// tile's loads and of one shuffle a step.

constexpr int kLowmemThreads = 1024;
// Dynamic shared memory that a block of a cluster of affine_fwd_block
// asks for at least, and every block of affine_bwd_window: more than half
// an SM's 228 KB, so that no SM runs two blocks and every block of every
// cluster has an SM to itself.
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
//
// kStrip: the strip mode, the forward of the sequence-sharded aligner
// (shard_seq_affine_align's block_fwd, parallel/__init__.py:323-368, and
// shard_seq_affine_score's local, :482-537). It runs the same K diagonals
// over the lanes [lo_strip, lo_strip + width) of each pair only: its
// state is the strip's own, (3, 2, B, width); block r of the cluster owns
// lanes lo_strip + r chunk .. (no block owns a lane 0 apart: where
// lo_strip is 0, lane 0 is block 0's first lane, never interior). Block 0
// reads lane lo_strip - 1 from `edge_in`, (B, K + 1, 3) int32 in device
// memory (M, I, D of diagonals d0-1 .. d0+K-1 at that lane, written by
// the strip to the left; null where lo_strip is 0), one diagonal ahead of
// its use; the thread of the strip's last lane writes the same record of
// that lane to `edge_out`. The capture is each pair's own diagonal
// fin_vec[b], into a buffer the caller filled with NEG once: no block
// resets it, so a pair's capture survives the blocks after its fin.
template <bool kGlobal, bool kStrip>
__global__ void __launch_bounds__(kLowmemThreads)
affine_fwd_block_kernel(const int8_t* __restrict__ alpha,    // (B, n)
                        const int8_t* __restrict__ beta,     // (B, m)
                        const int32_t* __restrict__ scores,  // (5, 5)
                        int go, int ge, int B, int n, int m, int d0, int K,
                        int fin, int CL, int chunk,
                        const int32_t* __restrict__ state_in,  // (3, 2, B, row)
                        int32_t* scratch,  // (B CL, 9 (chunk + 1)) or null
                        int32_t* __restrict__ state_out,       // (3, 2, B, row)
                        int32_t* __restrict__ capture,         // (3, B, row)
                        int lo_strip, int width,
                        const int32_t* __restrict__ edge_in,   // (B, K + 1, 3) or null
                        int32_t* __restrict__ edge_out,        // (B, K + 1, 3)
                        const int32_t* __restrict__ fin_vec) {  // (B,)
  extern __shared__ int32_t smem[];
  __shared__ int sc[25];
  __shared__ int edge[9];  // the block's last lane: state k of slot t at 3k + t
  cg::cluster_group cluster = cg::this_cluster();
  const int r = blockIdx.x % CL;  // the block's rank in its cluster
  const int b = blockIdx.x / CL;
  // local index x holds lane lo - 1 + x: the block's lanes at x = 1..len,
  // and (not in the strip mode) block 0's lane 0 at x = 0; a state row
  // holds local index x at off + x
  const int P = chunk + 1;
  const int lo = kStrip ? lo_strip + r * chunk : 1 + r * chunk;
  const int len = max(0, min((kStrip ? lo_strip + width : n + 1) - lo, chunk));
  const int x0 = !kStrip && r == 0 ? 0 : 1;
  const int row = kStrip ? width : n + 1;
  const int off = kStrip ? lo - 1 - lo_strip : lo - 1;
  // state k of slot t at st + (3k + t) P
  int32_t* st = kGlobal ? scratch + (int64_t)blockIdx.x * 9 * P : smem;
  const int* left = r > 0 ? cluster.map_shared_rank(edge, r - 1) : nullptr;
  // strip mode: block 0 reads its left lane from edge_in, and the strip's
  // last lane (local x_last where this block holds it) goes to edge_out
  const bool from_edge_in = kStrip && r == 0 && edge_in != nullptr;
  const int x_last = kStrip ? lo_strip + width - lo : -1;
  const int fin_b = kStrip ? fin_vec[b] : fin;
  int32_t* e_out = kStrip ? edge_out + (int64_t)b * (K + 1) * 3 : nullptr;
  const int32_t* e_in = from_edge_in ? edge_in + (int64_t)b * (K + 1) * 3 : nullptr;
  // the thread that owns local lane chunk, the block's last, and writes
  // `edge` (when the block's range is full)
  const bool edge_writer =
      len == chunk && (int)threadIdx.x == (chunk - x0) % (int)blockDim.x;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  for (int k = 0; k < 3; ++k) {
    for (int p = 0; p < 2; ++p) {
      const int t = slot_of(d0 - 1 + p);
      const int32_t* src = state_in + ((int64_t)(2 * k + p) * B + b) * row + off;
      int32_t* dst = st + (3 * k + t) * P;
      for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) {
        dst[x] = src[x];
        if (x == chunk) edge[3 * k + t] = src[x];
        if (kStrip && x == x_last) e_out[3 * p + k] = src[x];
      }
    }
    if (!kStrip) {
      int32_t* cap = capture + ((int64_t)k * B + b) * row + off;
      for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) cap[x] = kNeg;
    }
  }
  int32_t* cap_m = capture + (int64_t)b * row + off;
  int32_t* cap_i = capture + ((int64_t)B + b) * row + off;
  int32_t* cap_d = capture + ((int64_t)2 * B + b) * row + off;
  // strip mode, block 0: lane lo - 1 of diagonals d-1 (e*1) and d-2 (e*2)
  int em1 = kNeg, ei1 = kNeg, ed1 = kNeg, em2 = kNeg, ei2 = kNeg, ed2 = kNeg;
  if (from_edge_in && threadIdx.x == 0) {
    em2 = e_in[0];
    ei2 = e_in[1];
    ed2 = e_in[2];
    em1 = e_in[3];
    ei1 = e_in[4];
    ed1 = e_in[5];
  }
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
    // lane lo - 1 of diagonals d-1 and d-2 from block r-1 (or edge_in),
    // first: it is on every diagonal's critical path
    int hm1 = kNeg, hi1 = kNeg, hd1 = kNeg, hm2 = kNeg, hi2 = kNeg, hd2 = kNeg;
    if (left != nullptr && threadIdx.x == 0 && len > 0) {
      hm1 = left[t1];
      hi1 = left[3 + t1];
      hd1 = left[6 + t1];
      hm2 = left[t2];
      hi2 = left[3 + t2];
      hd2 = left[6 + t2];
    }
    if (from_edge_in) {
      hm1 = em1;
      hi1 = ei1;
      hd1 = ed1;
      hm2 = em2;
      hi2 = ei2;
      hd2 = ed2;
    }
    for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) {
      const int s = lo - 1 + x;
      int mv = kNeg, iv = kNeg, dv = kNeg;
      if (s >= dlo && s <= dhi) {
        const int sub = substitution(sc, al, be, s, d - s);
        if (x == 1 && (left != nullptr || from_edge_in)) {
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
      if (kStrip && x == x_last && d < d0 + K) {
        int32_t* e = e_out + 3 * (d - d0 + 1);
        e[0] = mv;
        e[1] = iv;
        e[2] = dv;
      }
      if (d == fin_b) {
        cap_m[x] = mv;
        cap_i[x] = iv;
        cap_d[x] = dv;
      }
    }
    // the next diagonal's left lane, loaded before the barrier hides it
    if (from_edge_in && threadIdx.x == 0 && d < d0 + K) {
      em2 = em1;
      ei2 = ei1;
      ed2 = ed1;
      const int32_t* e = e_in + 3 * (d - d0 + 1);
      em1 = e[0];
      ei1 = e[1];
      ed1 = e[2];
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
      int32_t* dst = state_out + ((int64_t)(2 * k + p) * B + b) * row + off;
      for (int x = x0 + threadIdx.x; x <= len; x += blockDim.x) dst[x] = src[x];
    }
}

// affine_bwd_window: warps (strips of 32 L lanes) a block at most, slots
// of a strip's edge ring (a power of two), and the diagonals between two
// reports of a strip's progress to the strip below it. A strip may run up
// to kBwdRing - 2 diagonals ahead of the one above it, which keeps both
// moving while the period is at most a quarter of the ring.
constexpr int kBwdMaxWarps = 16;
constexpr int kBwdLanesBuilt[] = {2, 4, 8};
constexpr int kMaxCluster = 8;  // the portable maximum of a cluster
constexpr int kBwdRing = 32;
constexpr int kBwdPeriod = 4;
static_assert(4 * kBwdPeriod <= kBwdRing, "the ring must outlast two periods");

// Shared-memory accesses of the strips' hand-off, by 32-bit shared-window
// addresses; `remote` addresses are in the cluster window (mapa) and may
// lie in another block of the cluster.
__device__ __forceinline__ uint32_t cta_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t cluster_address(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(cta_address(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void store_u32(uint32_t a, int v, bool remote) {
  if (remote) {
    asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
  } else {
    asm volatile("st.volatile.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
  }
}
__device__ __forceinline__ int load_u32(uint32_t a) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// A ring word: a value in its low half and its tag (the step that wrote
// it, plus one) in its high half, stored and loaded whole, so that a
// reader that sees the tag it waits for sees the value with it; no fence
// orders the value before a flag.
__device__ __forceinline__ void put_tagged(uint32_t a, int v, int tag, bool remote) {
  const unsigned long long w = (unsigned long long)(unsigned)tag << 32 | (unsigned)v;
  if (remote) {
    asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;" ::"r"(a), "l"(w) : "memory");
  } else {
    asm volatile("st.volatile.shared.u64 [%0], %1;" ::"r"(a), "l"(w) : "memory");
  }
}
__device__ __forceinline__ int get_tagged(uint32_t a, int tag) {
  unsigned long long w;
  do {
    asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(w) : "r"(a) : "memory");
  } while ((int)(w >> 32) != tag);
  return (int)(unsigned)w;
}
// The same words in global memory (the edge between two passes).
__device__ __forceinline__ void put_tagged_global(unsigned long long* a, int v, int tag) {
  const unsigned long long w = (unsigned long long)(unsigned)tag << 32 | (unsigned)v;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(a), "l"(w) : "memory");
}
__device__ __forceinline__ int get_tagged_global(const unsigned long long* a, int tag) {
  unsigned long long w;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(a) : "memory");
  } while ((int)(w >> 32) != tag);
  return (int)(unsigned)w;
}

template <int L>
__global__ void __launch_bounds__(32 * kBwdMaxWarps)
affine_bwd_window_kernel(const int8_t* __restrict__ alpha,    // (B, n)
                         const int8_t* __restrict__ beta,     // (B, m)
                         const int32_t* __restrict__ scores,  // (5, 5)
                         int go, int ge, int B, int n, int m, int d0, int K,
                         int W, int CL, int passes,
                         const int32_t* __restrict__ i_cur,     // (B,)
                         const int32_t* __restrict__ state_in,  // (3, 2, B, S)
                         unsigned long long* __restrict__ edge,  // (passes-1, B, K, 3)
                         int32_t* __restrict__ wlo_out,         // (B,)
                         int8_t* __restrict__ trace) {          // (K, B, W)
  // ring[q]: M, I, D of the edge lane of the strip below warp q, a slot a
  // diagonal; drained[q]: the diagonals the strip above warp q has read
  // from its ring
  __shared__ unsigned long long ring[kBwdMaxWarps][kBwdRing][3];
  __shared__ int drained[kBwdMaxWarps];
  __shared__ int sc[25];
  cg::cluster_group cluster = cg::this_cluster();
  const int NW = blockDim.x / 32;
  const int G = CL * NW;  // strips a pass
  const int r = blockIdx.x % CL;  // the block's rank in its cluster
  const int b = blockIdx.x / CL;
  const int q = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = r * NW + q;  // the warp's strip in each pass
  const int S = n + 1;
  // wlo = clip(floor((i - 2K - 128) / 128) * 128, 0, S - W)
  const int x = i_cur[b] - 2 * K - 128;
  const int wlo = min(x > 0 ? x / 128 * 128 : 0, S - W);
  if (r == 0 && threadIdx.x == 0) wlo_out[b] = wlo;
  if (threadIdx.x < 25) sc[threadIdx.x] = scores[threadIdx.x];
  for (int x = threadIdx.x; x < NW * kBwdRing * 3; x += blockDim.x) (&ring[0][0][0])[x] = 0;
  if (threadIdx.x < NW) drained[threadIdx.x] = 0;
  // lane 31 writes its edge into the ring of the strip above; lane 0
  // reports what it has read to the strip below; in another block for
  // the block's last and first warp; the last strip of a pass writes, and
  // the first reads, the global edge between passes
  const bool up_remote = q == NW - 1, down_remote = q == 0;
  uint32_t up_ring = 0, down_drained = 0;
  if (g + 1 < G)
    up_ring = up_remote ? cluster_address(&ring[0][0][0], r + 1) : cta_address(&ring[q + 1][0][0]);
  if (g > 0)
    down_drained = down_remote ? cluster_address(&drained[NW - 1], r - 1)
                               : cta_address(&drained[q - 1]);
  const uint32_t my_ring = cta_address(&ring[q][0][0]), my_drained = cta_address(&drained[q]);
  cluster.sync();  // every block's rings are cleared before any is written

  const int8_t* al = alpha + (int64_t)b * n;
  const int8_t* be = beta + (int64_t)b * m;
  const int goe = go + ge;
  const int32_t* st = state_in + (int64_t)b * S;
  const int64_t plane = (int64_t)B * S;  // state (k, p) at st + (2k + p) plane
  const int64_t row_step = (int64_t)B * W;
  int drained_seen = 0, until_report = kBwdPeriod;
  for (int p = 0; p < passes; ++p) {
    const int w0 = (p * G + g) * 32 * L;  // the strip's first window lane
    if (w0 >= W) break;
    const bool below = w0 > 0;            // a strip below feeds lane 0
    const bool above = w0 + 32 * L < W;   // a strip above reads lane 31
    const bool ring_below = below && g > 0, ring_above = above && g + 1 < G;
    // the edge from the last strip of pass p-1, to the first of pass p+1
    const unsigned long long* edge_in =
        below && g == 0 ? edge + ((int64_t)(p - 1) * B + b) * K * 3 : nullptr;
    unsigned long long* edge_out =
        above && g + 1 == G ? edge + ((int64_t)p * B + b) * K * 3 : nullptr;
    const int T0 = p * K;  // the ring's steps run on over the passes
    const int lw = w0 + lane * L;  // the thread's first window lane
    const int s0 = wlo + lw;
    // lanes s0 + e: M, I, D of diagonals d-1 (1) and d-2 (2), the clipped
    // alpha code, and 5 x the score row of the beta code that cell
    // (d, s0 + e) reads
    int M1[L], I1[L], D1[L], M2[L], I2[L], D2[L], A[L], R5[L];
#pragma unroll
    for (int e = 0; e < L; ++e) {
      const int s = s0 + e;
      const bool in = lw + e < W;
      M2[e] = in ? st[s] : kNeg;
      M1[e] = in ? st[plane + s] : kNeg;
      I2[e] = in ? st[2 * plane + s] : kNeg;
      I1[e] = in ? st[3 * plane + s] : kNeg;
      D2[e] = in ? st[4 * plane + s] : kNeg;
      D1[e] = in ? st[5 * plane + s] : kNeg;
      A[e] = s >= 1 && s <= n ? alpha_column(al[s - 1]) : 0;
      const int j = d0 + 1 - s;
      R5[e] = j >= 1 && j <= m ? 5 * beta_row(be[j - 1]) : 0;
    }
    // lane s0 - 1 of diagonals d-1 (n1) and d-2 (n2): from lane l-1 by
    // shuffles; for lane 0 of a strip with one below it the edge of that
    // strip (e1, e2: the checkpoint at the first diagonal, then the ring
    // or the edge between passes); for lane 0 of strip 0 the lane itself
    // (_shift)
    int n1m = __shfl_up_sync(kAllLanes, M2[L - 1], 1);
    int n1i = __shfl_up_sync(kAllLanes, I2[L - 1], 1);
    int n1d = __shfl_up_sync(kAllLanes, D2[L - 1], 1);
    int e1m = kNeg, e1i = kNeg, e1d = kNeg, e2m = kNeg, e2i = kNeg, e2d = kNeg;
    if (below) {
      e2m = st[s0 - 1];
      e1m = st[plane + s0 - 1];
      e2i = st[2 * plane + s0 - 1];
      e1i = st[3 * plane + s0 - 1];
      e2d = st[4 * plane + s0 - 1];
      e1d = st[5 * plane + s0 - 1];
    }
    const bool pack = L % 4 == 0 && W % 4 == 0 && lw + L <= W;
    int8_t* trow = trace + (int64_t)b * W + lw;  // diagonal d0+1+t at + t B W
    for (int t = 0; t < K; ++t) {
      const int d = d0 + 1 + t, T = T0 + t;
      // the beta code of lane s0 at the next diagonal, loaded a step ahead
      const int jn = d + 1 - s0;
      const int bn = jn >= 1 && jn <= m ? be[jn - 1] : 0;
      int n2m = n1m, n2i = n1i, n2d = n1d;
      n1m = __shfl_up_sync(kAllLanes, M1[L - 1], 1);
      n1i = __shfl_up_sync(kAllLanes, I1[L - 1], 1);
      n1d = __shfl_up_sync(kAllLanes, D1[L - 1], 1);
      if (below && t > 0) {
        // the whole warp waits for the strip below's diagonal d-1 (one
        // word read by all lanes), so that no lane spins alone
        e2m = e1m;
        e2i = e1i;
        e2d = e1d;
        if (ring_below) {
          const uint32_t slot = my_ring + 24 * ((T - 1) & (kBwdRing - 1));
          e1m = get_tagged(slot, T);
          e1i = get_tagged(slot + 8, T);
          e1d = get_tagged(slot + 16, T);
        } else {
          const unsigned long long* w = edge_in + 3 * (t - 1);
          e1m = get_tagged_global(w, t);
          e1i = get_tagged_global(w + 1, t);
          e1d = get_tagged_global(w + 2, t);
        }
      }
      if (lane == 0) {
        n1m = below ? e1m : M1[0];
        n1i = below ? e1i : I1[0];
        n1d = below ? e1d : D1[0];
        n2m = below ? e2m : M2[0];
        n2i = below ? e2i : I2[0];
        n2d = below ? e2d : D2[0];
      }
      const int lo = max(1, d - m), hi = min(min(d - 1, n), wlo + W - 1);
      const int bnd = go + ge * d;
      int code[L];
      // from the last lane down, so that lane e-1 still holds diagonals
      // d-1 and d-2 when lane e reads it
#pragma unroll
      for (int e = L - 1; e >= 0; --e) {
        const int s = s0 + e;
        const int pm1 = e ? M1[e - 1] : n1m, pi1 = e ? I1[e - 1] : n1i,
                  pd1 = e ? D1[e - 1] : n1d;
        const int pm2 = e ? M2[e - 1] : n2m, pi2 = e ? I2[e - 1] : n2i,
                  pd2 = e ? D2[e - 1] : n2d;
        int mv = kNeg, iv = kNeg, dv = kNeg, c = 0;
        if (s >= lo && s <= hi) {
          c = gotoh_values(pm2, pi2, pd2, M1[e], I1[e], D1[e], pm1, pi1, pd1,
                           sc[R5[e] + A[e]], goe, ge, mv, iv, dv);
        } else {
          if (s == 0 && d <= m) iv = bnd;  // row 0
          if (s == d && d <= n) dv = bnd;  // column 0
        }
        M2[e] = M1[e];
        I2[e] = I1[e];
        D2[e] = D1[e];
        M1[e] = mv;
        I1[e] = iv;
        D1[e] = dv;
        code[e] = c;
      }
      if (pack) {
#pragma unroll
        for (int e = 0; e < L; e += 4)
          *(uint32_t*)(trow + e) = (uint32_t)(code[e] | code[e + 1] << 8 |
                                              code[e + 2] << 16 | code[e + 3] << 24);
      } else {
#pragma unroll
        for (int e = 0; e < L; ++e)
          if (lw + e < W) trow[e] = (int8_t)code[e];
      }
      trow += row_step;
#pragma unroll
      for (int e = L - 1; e > 0; --e) R5[e] = R5[e - 1];
      R5[0] = 5 * beta_row(bn);
      if (ring_above) {
        // slot T held step T - kBwdRing, which the strip above read at its
        // step T - kBwdRing + 1 (the whole warp reads the count)
        while (drained_seen < T - kBwdRing + 2) drained_seen = load_u32(my_drained);
        const uint32_t slot = up_ring + 24 * (T & (kBwdRing - 1));
        if (lane == 31) {
          put_tagged(slot, M1[L - 1], T + 1, up_remote);
          put_tagged(slot + 8, I1[L - 1], T + 1, up_remote);
          put_tagged(slot + 16, D1[L - 1], T + 1, up_remote);
        }
      } else if (above && lane == 31) {
        unsigned long long* w = edge_out + 3 * t;
        put_tagged_global(w, M1[L - 1], t + 1);
        put_tagged_global(w + 1, I1[L - 1], t + 1);
        put_tagged_global(w + 2, D1[L - 1], t + 1);
      }
      // the warp has read slot T - 1 (its values are in this step's cells)
      if (--until_report == 0 || t + 1 == K) {
        until_report = kBwdPeriod;
        if (lane == 0 && ring_below) store_u32(down_drained, T + 1, down_remote);
      }
    }
  }
  cluster.sync();  // no block leaves while another may still write into it
}

constexpr int kWalkWarps = 4;  // pairs (one a warp) per block of the walk

// Word z (0..7) of the 32 bytes a, b.
__device__ __forceinline__ uint32_t word_of(const uint4& a, const uint4& b, int z) {
  return z == 0 ? a.x : z == 1 ? a.y : z == 2 ? a.z : z == 3 ? a.w
       : z == 4 ? b.x : z == 5 ? b.y : z == 6 ? b.z : b.w;
}

__global__ void __launch_bounds__(32 * kWalkWarps)
lowmem_walk_block_kernel(const int8_t* __restrict__ trace,  // (K, B, W)
                         const int32_t* __restrict__ wlo,   // (B,)
                         int d0, int K, int W, int B,
                         int32_t* __restrict__ i_io,  // (B,)
                         int32_t* __restrict__ j_io,  // (B,)
                         int32_t* __restrict__ k_io,  // (B,)
                         int8_t* __restrict__ ops) {  // (K, B)
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp
  int i = i_io[b], j = j_io[b], k = k_io[b];
  const int soff = wlo[b];
  const int8_t* tb = trace + (int64_t)b * W;  // diagonal dd at + dd B W
  const int64_t row_step = (int64_t)B * W;
  // the tile: lane x holds the bytes of rows itop - 15 .. itop (columns
  // c_lo + z, z = 0..15, four to a word, each clamped as the walk clamps
  // it) on diagonal dtop - x; none is loaded yet
  int dtop = -1, itop = -1;
  uint32_t tile[4] = {0, 0, 0, 0};
  int t = 0;
  for (; t < K; ++t) {
    const int d_rel = i + j - 1 - d0;
    if (i < 1 || j < 1 || d_rel < 0) break;  // inactive from here on
    int x = dtop - d_rel, y = itop - i;
    if ((unsigned)x > 31u || (unsigned)y > 15u) {
      dtop = d_rel;
      itop = i;
      x = y = 0;
      const int c_lo = itop - 15 - soff;
      const int8_t* row = tb + min(max(dtop - lane, 0), K - 1) * row_step;
      if (c_lo >= 0 && c_lo + 15 <= W - 1) {
        // no clamp: two aligned 16-byte loads hold the 16 bytes (the
        // second only when they straddle; it holds a byte of the trace,
        // so it lies inside the allocation)
        const uintptr_t a0 = (uintptr_t)(row + c_lo);
        const uint4* q = (const uint4*)(a0 & ~(uintptr_t)15);
        const int off = (int)(a0 & 15);
        const uint4 q0 = q[0];
        const uint4 q1 = off ? q[1] : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          tile[w] = __funnelshift_r(word_of(q0, q1, (off >> 2) + w),
                                    word_of(q0, q1, (off >> 2) + w + 1), 8 * (off & 3));
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t v = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ss = min(max(c_lo + 4 * w + u, 0), W - 1);
            v |= (uint32_t)(uint8_t)row[ss] << (8 * u);
          }
          tile[w] = v;
        }
      }
    }
    const int z = 15 - y;  // the cell's byte in the tile
    const int zw = z >> 2;
    const uint32_t word = zw == 0 ? tile[0] : zw == 1 ? tile[1] : zw == 2 ? tile[2] : tile[3];
    const int packed = (int)(__shfl_sync(kAllLanes, word, x) >> (8 * (z & 3))) & 0xff;
    if (lane == 0) ops[(int64_t)t * B + b] = (int8_t)k;
    const int kn = k == 0 ? packed & 3 : k == 1 ? (packed >> 2) & 3 : (packed >> 4) & 3;
    if (k == 0 || k == 2) --i;
    if (k == 0 || k == 1) --j;
    k = kn;
  }
  for (int u = t + lane; u < K; u += 32) ops[(int64_t)u * B + b] = 4;
  if (lane == 0) {
    i_io[b] = i;
    j_io[b] = j;
    k_io[b] = k;
  }
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
// over. One warp aligns one pair with no block barrier, sweeping the DP in
// strips of 32 R rows (R, the rows a lane, is a template argument): row r
// of lane t is row r0 + t R + r + 1 and works on column c - t R - r + 1 at
// step c. Row r's left neighbour is its own last cell; its upper and
// upper-left neighbours are row r - 1 of the same lane, one and two steps
// back, so a step updates the rows from r = R - 1 down to 0 and all of
// them stay in registers. Only row 0 takes its upper neighbour from lane
// t - 1 (row R - 1), by one rotating __shfl_sync of (max(M, I), D); lane 0
// gets lane 31's instead, which lane 31 sends from the boundary row, the
// strip before's last row. That row is a per-pair scratch of (max(M, I),
// D), all a lower row reads, which lane 31 alone writes (its row R - 1)
// and reads back R columns a load, one block of R steps ahead. The
// shuffles, the boundary and the loop are paid once for R cells, and the
// R cells of a step are independent of each other.
//
// The substitution score: each lane keeps, per strip, a profile of its R
// rows in shared memory (the score of each of the 5 beta score rows
// against each row's clipped alpha code, lane-minor so that a warp's
// loads hit 32 banks); a beta column enters a lane once, on row 0, as one
// byte load a block ahead and one lookup of its profile offset
// (_select_score's rule for beta codes, once a column), and rows r > 0
// reuse it r steps later from a ring of R registers. A cell's score is
// then one ld.shared at an immediate offset. The recurrences use DPX
// add-max (__viaddmax_s32).
//
// Rows before their first column compute junk, and each is reset to its
// column-0 cell (M = I = NEG, D = go + ge i) on the step it reaches
// column 0, one lane a step, only in the first 32 blocks of steps; past
// column m a row's junk feeds only columns past m. The last strip stops
// on the step that computes cell (n, m) and its lane writes the score.
//
// What bounds it: the SM's int32 pipe (16 lanes a scheduler, so two
// cycles a warp instruction). At R = 8 a step of the blocks without edge
// tests is 87 SASS instructions for 8 cells, 58 of them on that pipe
// (VIMNMX, VIADD and the DPX VIADDMNMX: ~7.25 a cell), which at two cycles
// each is the ~117 cycles a warp-step that 4 warps a scheduler take on
// the card (PERF.md); the boundary rows (8 bytes a column every 32 R
// rows) stay in L2. A strip costs m + 32 R - 1 steps for m columns: the
// ramp, 20% at R = 8 and m = 1024. Strips that wrap into each other with
// no ramp (columns 0..m a strip, two profiles a warp, the column-0 reset
// every step) were timed slower, 1.38 against 1.20-1.23 ms for 2048
// pairs of 1024 x 1024 (NVIDIA H100 80GB HBM3, 700 W power limit).
//
// affine_score_diag replaces _affine_kernel's score mode (:94, pallas_call
// :1584 in wavefront_align :1534) and _affine_block_kernel (:466,
// pallas_call :620 in wavefront_align_blocked :569). Both compute one
// function: max3(M, I, D) of every row's cell on the pair's diagonal fin,
// over the padded grid (n rows for the first; nb r_rows rows for the
// second, alpha rows past n reading code 4 as the JAX function pads them),
// laid out as (nb, B, r_rows + 1) with nb = 1 and r_rows = n for the
// first. It runs affine_stream's step: at step c every cell of a strip
// lies on diagonal r0 + c + 2, so diagonal fin is one warp-uniform step of
// each strip, c = fin - r0 - 2, on which each lane writes its R rows whose
// column lies in 0..m (a row reset to column 0 on that step first), and a
// strip runs no step past it: the cells after diagonal fin feed nothing
// that is read out, and the strip below needs the boundary row only up to
// diagonal fin - 1. A pair stops after the strip that holds row
// min(fin, rows); a pair whose fin is outside 1..rows + m computes
// nothing. The kernel writes every lane of the result first, NEG but row
// 0's cell (0, fin); then lane i - k r_rows of block k holds row i and,
// where i = k r_rows, so does lane r_rows of block k - 1 (lane 0 of block
// k stays NEG at column 0: the block's local diagonal 0 is never reached).
// The JAX loop's one launch a block, its boundary M/I/D tensors and its
// capture ring are gone: all row blocks run in one launch.
//
// A pair's strips are pipelined over W warps of one block: warp w takes
// strips w, w + W, ..., strip s writes its last row into ring row s mod W
// of the pair's (W, ld) scratch (row 0, the boundary of strip 0, starts in
// ring row W - 1) and reads the boundary from ring row (s - 1) mod W.
// After each block of R steps lane 31 of the producer stores its progress
// (the strip in the high half, the blocks done in the low) into one
// shared-memory word with release semantics at block scope; before each
// of its block-ahead boundary loads the whole consumer warp reads that
// word with acquire semantics until the strip before has done kDiagLag
// blocks more than it (lane 31 of that strip writes column j at step j +
// 32 R - 2, and the load at block k reads columns up to (k + 2) R). Ring
// row s mod W is rewritten by strip s + W only after strip s + 1 has read
// it: strip s + W runs behind s + W - 1, which runs behind s + W - 2, ...,
// down to s + 1, each by at least kDiagLag blocks, while strip s + W
// writes column j only at its step j + 32 R - 2 and strip s + 1 has read
// it before its step j. The progress word is monotone over a warp's strips, so
// a consumer whose producer has finished and moved on never waits on a
// later strip's count. W = 1 where a launch's pairs fill the card (one
// warp a pair, four pairs a block, as affine_stream); below that the plan
// (ops/wavefront.py score_diag_plan) gives each pair up to kDiagMaxWarps
// warps, one block a pair.
//
// What bounds it: as affine_stream, the int32 pipe at 8 operations a cell
// where many pairs fill the card; at the main shapes (256 pairs, 4 strips
// each) the latency of a warp-step, which the pipeline pays for the steps
// of one strip plus the lag of each strip behind the one before, not for
// every strip in turn: 256 pairs of 1024 x 1024 at W = 4 take ~0.31 ms, 4
// strips in turn (W = 1) ~0.52 ms. A step alone costs ~190 cycles here
// against affine_stream's ~150 (NVIDIA H100 80GB HBM3, 700 W;
// tools/score_timing.py plans): at 128 registers ptxas spills a few
// values and issues the adds as IMAD.IADD, where affine_stream gets
// VIADD.

constexpr int kStreamWarps = 4;  // pairs (one a warp) per block of affine_stream
// The rows a lane affine_stream is built for (affine_stream_built).
#define STREAM_ROWS(X) X(2) X(4) X(8)

// Columns of the boundary row of a pair: column j at index j - 1, padded
// to a multiple of R so that lane 31 reads R columns at a time, aligned.
int stream_ld(int m, int R) { return ((m > 1 ? m : 1) + R - 1) / R * R; }

// One block of R steps c = k R + s of a strip of affine_stream or
// affine_score_diag, for one lane (see the notes above): the boundary row
// is read from bin and this strip's last row written to bout (the same
// row in affine_stream). kEdge: the block may hold a step on which a row
// reaches column 0 (k < 32) or the strip's last step (c_cap), on which
// capture(r, max3(M, I, D)) reads out row r of the lane, for each r (by
// value: an array passed by reference would leave registers); the other
// blocks skip both tests. Returns true after the capture.
template <int R, bool kEdge, typename Capture>
__device__ __forceinline__ bool stream_block(
    int k, int (&M)[R], int (&I)[R], int (&D)[R], int (&G)[R], int (&cb)[R],
    int (&bq)[R], int2 (&bn)[R], const char* prof, const int* lut,
    const uint8_t* be, const int2* bin, int2* bout, int lane, int m, int ld,
    int go, int ge, int i0, int w_lo, int c_cap, const Capture& capture) {
  const int goe = go + ge;
  // this block's new columns (row 0's) and lane 31's boundary columns,
  // then the loads of the next block's
  int cn[R];
  int2 bc[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    cn[s] = lut[bq[s]] + 4 * lane;
    bc[s] = bn[s];
  }
  const int x0 = (k + 1 - lane) * R;  // column x0 + s + 1 of the next block
#pragma unroll
  for (int s = 0; s < R; ++s)
    bq[s] = (unsigned)(x0 + s) < (unsigned)m ? __ldg(be + x0 + s) : 0;
  if (lane == 31 && (k + 1) * R < ld) {
    const int4* src = reinterpret_cast<const int4*>(bin + (k + 1) * R);
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const int4 v = src[q];
      bn[2 * q] = make_int2(v.x, v.y);
      bn[2 * q + 1] = make_int2(v.z, v.w);
    }
  }
  const int from = (lane + 31) & 31;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int c = k * R + s;
    cb[(s + 1) % R] = cn[s];
    // row 0's upper neighbour: row R - 1 of lane t - 1 on the step before,
    // and for lane 0 the boundary row, which lane 31 sends
    int sH = max(M[R - 1], I[R - 1]), sD = D[R - 1];
    if (lane == 31) {
      sH = bc[s].x;
      sD = bc[s].y;
    }
    const int u0H = __shfl_sync(kAllLanes, sH, from);
    const int u0D = __shfl_sync(kAllLanes, sD, from);
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int up = r > 0 ? r - 1 : 0;
      const int uH = r > 0 ? max(M[up], I[up]) : u0H;  // cell (i - 1, j)
      const int uD = r > 0 ? D[up] : u0D;
      const int sub = *reinterpret_cast<const int*>(prof + cb[(s + 1 - r + R) % R] + 128 * r);
      const int mv = sub + G[r];                                  // from (i-1, j-1)
      I[r] = __viaddmax_s32(max(M[r], D[r]), goe, ge + I[r]);    // from (i, j-1)
      D[r] = __viaddmax_s32(uH, goe, ge + uD);                    // from (i-1, j)
      G[r] = max(uH, uD);
      M[r] = mv;
    }
    if (lane == 31 && (unsigned)(c - w_lo) < (unsigned)m)
      bout[c - w_lo] = make_int2(max(M[R - 1], I[R - 1]), D[R - 1]);
    if (kEdge) {
      // the row that reached column 0 on this step takes cell (i, 0)
      const int rr = (s + 1) % R;
      if (lane == k + (s == R - 1 ? 1 : 0)) {
        M[rr] = kNeg;
        I[rr] = kNeg;
        D[rr] = go + ge * (i0 + rr);
      }
      if (c == c_cap) {
#pragma unroll
        for (int r = 0; r < R; ++r) capture(r, max3(M[r], I[r], D[r]));
        return true;
      }
    }
  }
  return false;
}

// The start of the strip at row r0 of affine_stream or affine_score_diag,
// for one lane whose first row is i0: the profile of its rows (rows past n
// read code 4), each row's column-0 cell, the ring of beta offsets and the
// beta codes of the first block of steps.
template <int R>
__device__ __forceinline__ void stream_strip_start(
    int r0, int i0, int lane, const int8_t* al, int n, const uint8_t* be, int m,
    const int32_t* scores, int* prof, int go, int ge, int (&M)[R], int (&I)[R],
    int (&D)[R], int (&G)[R], int (&cb)[R], int (&bq)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int a = i0 + r <= n ? alpha_column(al[i0 + r - 1]) : 4;
#pragma unroll
    for (int b = 0; b < 5; ++b) prof[(b * R + r) * 32 + lane] = __ldg(scores + b * 5 + a);
    M[r] = kNeg;
    I[r] = kNeg;
    D[r] = go + ge * (i0 + r);
    G[r] = kNeg;
    cb[r] = 4 * lane;
  }
  // lane 0's upper-left before its first step: cell (r0, 0) as max3
  G[0] = r0 == 0 ? max(0, go) : go + ge * r0;
#pragma unroll
  for (int s = 0; s < R; ++s)
    bq[s] = (unsigned)(s - lane * R) < (unsigned)m ? __ldg(be + s - lane * R) : 0;
}

template <int R>
__global__ void __launch_bounds__(32 * kStreamWarps, 4)
affine_stream_kernel(const int8_t* __restrict__ alpha,    // (NP, n)
                     const int8_t* __restrict__ beta,     // (NP, m)
                     const int32_t* __restrict__ scores,  // (5, 5)
                     int go, int ge, int NP, int n, int m, int ld,
                     int2* __restrict__ bnd,              // (NP, ld) scratch
                     int32_t* __restrict__ out) {         // (NP,)
  // lut[c]: the profile offset of beta byte c's score row; prof[w]: warp
  // w's profile, the score of beta row b against row r of lane t at int
  // (b R + r) 32 + t
  __shared__ int lut[256];
  __shared__ int prof_all[kStreamWarps][5 * R * 32];
  for (int x = threadIdx.x; x < 256; x += blockDim.x)
    lut[x] = beta_row((int8_t)x) * R * 128;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x / 32;
  const int p = blockIdx.x * kStreamWarps + w;
  if (p >= NP) return;  // the whole warp
  if (n == 0) {  // cell (0, m) of row 0, unreached at m = 0
    if (lane == 0) out[p] = m > 0 ? go + ge * m : kNeg;
    return;
  }
  const int8_t* al = alpha + (int64_t)p * n;
  const uint8_t* be = (const uint8_t*)beta + (int64_t)p * m;
  int2* brow = bnd + (int64_t)p * ld;
  int* prof = prof_all[w];
  // the boundary row of the first strip is row 0: M = D = NEG, I = go + ge j
  for (int x = lane; x < ld; x += 32)
    brow[x] = x < m ? make_int2(go + ge * (x + 1), kNeg) : make_int2(kNeg, kNeg);
  __syncwarp();
  int M[R], I[R], D[R], G[R], cb[R], bq[R];
  int2 bn[R];
  for (int r0 = 0;; r0 += 32 * R) {
    const bool last = r0 + 32 * R >= n;
    const int i0 = r0 + lane * R + 1;  // this lane's first row
    stream_strip_start<R>(r0, i0, lane, al, n, be, m, scores, prof, go, ge, M, I, D, G,
                          cb, bq);
    if (lane == 31) {
#pragma unroll
      for (int s = 0; s < R; ++s) bn[s] = brow[s];
    }
    // the last strip stops on the step of cell (n, m), q rows into it
    const int q = n - 1 - r0;
    const int c_end = last ? m - 1 + q : m + 32 * R - 2;
    const int nblk = c_end / R + 1;
    const int w_lo = last ? (1 << 30) : 32 * R - 1;  // lane 31 writes column c - w_lo + 1
    const int c_cap = last ? c_end : -1;
    // the score: row q % R of lane q / R
    auto capture = [&](int r, int v) {
      if (lane == q / R && r == q % R) out[p] = v;
    };
    for (int k = 0; k < nblk; ++k) {
      if (k < 32 || k == nblk - 1) {
        if (stream_block<R, true>(k, M, I, D, G, cb, bq, bn, (const char*)prof, lut, be,
                                  brow, brow, lane, m, ld, go, ge, i0, w_lo, c_cap, capture))
          return;
      } else {
        stream_block<R, false>(k, M, I, D, G, cb, bq, bn, (const char*)prof, lut, be,
                               brow, brow, lane, m, ld, go, ge, i0, w_lo, c_cap, capture);
      }
    }
  }
}

// affine_score_diag: the most warps a block has (one pair's, at 128
// registers a thread), the warps (pairs) a block takes at one warp a
// pair, and the blocks of R steps a strip keeps ahead of the strip below
// it (see the note above).
constexpr int kDiagMaxWarps = 16;
constexpr int kDiagPairWarps = 4;
constexpr int kDiagLag = 34;

// The progress word of a strip of affine_score_diag at shared address a:
// stored by the lane that wrote the ring, read by a whole warp, which
// keeps the blocks done of strip s (0xffffffff once it is done or a later
// strip has begun).
__device__ __forceinline__ void publish(uint32_t a, int s, unsigned blocks) {
  const unsigned long long v = (unsigned long long)(unsigned)s << 32 | blocks;
  asm volatile("st.release.cta.shared.u64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned observe(uint32_t a, int s) {
  unsigned long long v;
  asm volatile("ld.acquire.cta.shared.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  const int strip = (int)(v >> 32);
  return strip > s ? 0xffffffffu : strip == s ? (unsigned)v : 0u;
}

// Writes v, the cell of row i on the pair's diagonal (column j), into
// every lane of the result (nb, NP, Rb + 1) that holds row i (see the note
// above).
__device__ __forceinline__ void put_row(int32_t* out, int NP, int p, int Rb, int nb, int i,
                                        int j, int v) {
  const int k = i / Rb, x = i - k * Rb;
  if (k < nb && (x != 0 || j != 0)) out[((int64_t)k * NP + p) * (Rb + 1) + x] = v;
  if (x == 0 && k > 0) out[((int64_t)(k - 1) * NP + p) * (Rb + 1) + Rb] = v;
}

template <int R>
__global__ void __launch_bounds__(32 * kDiagMaxWarps, 1)
affine_score_diag_kernel(const int8_t* __restrict__ alpha,    // (NP, n)
                         const int8_t* __restrict__ beta,     // (NP, m)
                         const int32_t* __restrict__ fin,     // (NP,)
                         const int32_t* __restrict__ scores,  // (5, 5)
                         int go, int ge, int NP, int n, int m, int rows, int Rb,
                         int nb, int W, int ld,
                         int2* ring,                          // (NP, W, ld) scratch
                         int32_t* __restrict__ out) {         // (nb, NP, Rb + 1)
  // lut and the profiles as in affine_stream (a warp's at diag_prof + 5 R
  // 32 w); progress[w]: warp w's strip (high half) and blocks done (low)
  __shared__ int lut[256];
  __shared__ unsigned long long progress[kDiagMaxWarps];
  extern __shared__ int diag_prof[];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int slot = w / W, phase = w % W;  // the warp's pair in the block, its strips
  const int p = blockIdx.x * (blockDim.x / 32 / W) + slot;
  for (int x = threadIdx.x; x < 256; x += blockDim.x) lut[x] = beta_row((int8_t)x) * R * 128;
  if (lane == 0) progress[w] = 0;
  const int f = p < NP ? fin[p] : 0;
  if (p < NP) {
    // every lane of the pair's result NEG but row 0's cell (0, f), and
    // the boundary of strip 0, row 0 (M = D = NEG, I = go + ge j), in
    // ring row W - 1
    const int t = phase * 32 + lane;
    for (int k = 0; k < nb; ++k) {
      int32_t* o = out + ((int64_t)k * NP + p) * (Rb + 1);
      for (int x = t; x <= Rb; x += 32 * W)
        o[x] = k == 0 && x == 0 && f >= 1 && f <= m ? go + ge * f : kNeg;
    }
    int2* row0 = ring + ((int64_t)p * W + W - 1) * ld;
    for (int x = t; x < ld; x += 32 * W)
      row0[x] = x < m ? make_int2(go + ge * (x + 1), kNeg) : make_int2(kNeg, kNeg);
  }
  __syncthreads();
  if (p >= NP || rows == 0 || f < 1 || f > rows + m) return;  // the whole warp
  const int8_t* al = alpha + (int64_t)p * n;
  const uint8_t* be = (const uint8_t*)beta + (int64_t)p * m;
  int* prof = diag_prof + w * 5 * R * 32;
  const uint32_t mine = cta_address(progress + w),
                 before = cta_address(progress + slot * W + (phase + W - 1) % W);
  const int s_last = (min(f, rows) - 1) / (32 * R);  // the strip of row min(f, rows)
  int M[R], I[R], D[R], G[R], cb[R], bq[R];
  int2 bn[R];
  for (int s = phase; s <= s_last; s += W) {
    const int r0 = s * 32 * R;
    const int c_f = f - r0 - 2;  // the step of diagonal f
    if (c_f < 0) {  // f = r0 + 1 (s = s_last): cell (f, 0), the strip's first row
      if (lane == 0) put_row(out, NP, p, Rb, nb, f, 0, go + ge * f);
      break;
    }
    const int i0 = r0 + lane * R + 1;
    stream_strip_start<R>(r0, i0, lane, al, n, be, m, scores, prof, go, ge, M, I, D, G, cb,
                          bq);
    const int2* bin = ring + ((int64_t)p * W + (s + W - 1) % W) * ld;
    int2* bout = ring + ((int64_t)p * W + s % W) * ld;
    // the blocks the strip before has done, as far as this warp has seen
    // (the whole warp waits)
    const bool waits = W > 1 && s > 0;
    unsigned seen = 0;
    if (waits)
      while (seen < kDiagLag - 1) seen = observe(before, s - 1);
    if (lane == 31) {
#pragma unroll
      for (int x = 0; x < R; ++x) bn[x] = bin[x];
    }
    const bool last = r0 + 32 * R >= rows;
    const int c_end = last ? m - 1 + (rows - 1 - r0) : m + 32 * R - 2;
    const bool cap = c_f <= c_end;  // the strip has a cell on diagonal f
    const int c_stop = cap ? c_f : c_end;
    const int nblk = c_stop / R + 1;
    const bool feeds = s < s_last;  // a strip below reads this one's last row
    const int w_lo = feeds ? 32 * R - 1 : (1 << 30);
    auto capture = [&](int r, int v) {
      const int i = i0 + r, j = f - i;
      if (cap && i <= rows && (unsigned)j <= (unsigned)m) put_row(out, NP, p, Rb, nb, i, j, v);
    };
    for (int k = 0; k < nblk; ++k) {
      if (waits)
        while (seen < (unsigned)(k + kDiagLag)) seen = observe(before, s - 1);
      if (k < 32 || k == nblk - 1) {
        if (stream_block<R, true>(k, M, I, D, G, cb, bq, bn, (const char*)prof, lut, be, bin,
                                  bout, lane, m, ld, go, ge, i0, w_lo, c_stop, capture))
          break;
      } else {
        stream_block<R, false>(k, M, I, D, G, cb, bq, bn, (const char*)prof, lut, be, bin,
                               bout, lane, m, ld, go, ge, i0, w_lo, c_stop, capture);
      }
      if (feeds && W > 1 && lane == 31) publish(mine, s, k + 1);
    }
    if (feeds && W > 1 && lane == 31) publish(mine, s, 0xffffffffu);
  }
}

// trace_diag replaces _affine_kernel in trace mode (:94) and _const_kernel
// (:243) in both of its modes, all launched there by the pallas_call of
// wavefront_align (:1584 in :1534). In trace mode it writes the whole
// (n+m, B, S) trace, tM + 4 tI + 16 tD (affine) or the argmax of (diag,
// left, up) (const) for every interior cell and 0 for every other byte
// (row 0, column 0, lanes outside the grid), and each row's M, I and D
// (const: its score) on the pair's diagonal fin into (B, S) rows that are
// NEG elsewhere; in const's score mode only the scores on diagonal fin.
// It runs affine_score_diag's strips and pipeline (see the notes above:
// strips of 32 R rows, R rows a lane in registers, a pair's strips
// pipelined over W warps through a ring of boundary rows and a progress
// word a warp, kDiagLag blocks of R steps of lag) with steps of its own,
// so that affine_stream's and affine_score_diag's steps stay as they are:
// - Affine trace: a row keeps M, I and D of its last cell, and max3 (G)
//   and argmax3 (T) of its next upper-left cell. I's code needs M >= D of
//   the left cell and D's needs M >= I of the upper one, so the upper
//   neighbour travels as (M, I, D), three shuffles a step; the boundary
//   row holds (max(M, I), 2 D + (M >= I)) a column, which lane 31 turns
//   back into an (M, I, D) with the same max and the same tie. The
//   boundary is written and read at the same steps as affine_score_diag's,
//   so its lag is the same: 34 blocks is the least the block-ahead load
//   allows (lane 31 of a strip writes column j at step j + 32 R - 2; the
//   load at block k reads columns up to (k + 2) R).
// - Const: one state; a row keeps its last cell and its next upper-left
//   one; the boundary row holds one int a column. In score mode a strip
//   stops on its step of diagonal fin and a pair after the strip of row
//   min(fin, n), as affine_score_diag's; in trace mode every strip runs
//   to the last diagonal of its rows.
//
// The trace write. Step c of a strip is diagonal d = r0 + c + 2, and the
// R cells of a lane on it are R consecutive bytes of trace row (d - 1, b).
// The kernel writes rows of pitch P = 16 + round_up(n, 16) with lane s at
// byte 15 + s (the wrapper returns the (n+m, B, S) view of them), so the
// first row of lane t, r0 + t R + 1, lies at byte 16 + r0 + t R: the lane
// packs its R codes into one aligned store of R bytes a step (0 for a cell
// outside columns 1..m, tested only in the blocks that can hold one);
// lanes whose rows all lie past n store nothing, and a lane's bytes past
// n fall into the row's padding. The other bytes of the view are zeros
// written as aligned 16-byte chunks: lane 0's (with the 15 bytes of
// padding before it) on every diagonal by the pair's warps before the
// pipeline starts, and a strip's lanes on the diagonals its steps do not
// reach (1..r0 + 1 before its first step, written while the warp waits for
// the strip before; those past its last step after it). Every byte of the
// view is written once, and no fill of the whole trace precedes it.
//
// What bounds it: at the main shapes (128 pairs of 1024 x 1024 with trace,
// 8 strips a pair at R = 4, W = 8; 256 in const's score mode, 4 strips at
// R = 8, W = 4) the latency of a warp-step over the pipeline's critical
// path, as affine_score_diag, with ~33 SASS instructions a cell in affine
// trace mode against the ~10 of the score step. The trace itself, one
// byte a cell and ~269 MB at the main shape, is ~0.08 ms of device memory
// writes.

constexpr int kTraceMaxWarps = 8;
enum { kAffineTrace = 0, kConstTrace = 1, kConstScore = 2 };

// The pitch of trace_diag's trace rows (see the note above).
int trace_pitch(int n) { return 16 + (n + 15) / 16 * 16; }

// The R trace codes of a lane, a byte each, in one aligned store.
template <int R>
__device__ __forceinline__ void store_codes(int8_t* a, const uint32_t (&w)[(R + 3) / 4]) {
  static_assert(R == 2 || R == 4 || R == 8, "rows a lane");
  if constexpr (R == 2) {
    *reinterpret_cast<uint16_t*>(a) = (uint16_t)w[0];
  } else if constexpr (R == 4) {
    *reinterpret_cast<uint32_t*>(a) = w[0];
  } else {
    *reinterpret_cast<uint2*>(a) = make_uint2(w[0], w[1]);
  }
}

// Zeros into the trace rows of diagonals d0..d1 of pair p over bytes
// [x0, x1) of each padded row (multiples of 16), a 16-byte chunk a lane.
__device__ void zero_trace(int8_t* trace, int NP, int p, int P, int d0, int d1, int x0,
                           int x1, int lane) {
  const int chunks = (x1 - x0) / 16;
  if (chunks <= 0) return;
  // chunk q = lane + 32 u is chunk x of row d, moved on without a division
  const int dd = 32 / chunks, dx = 32 % chunks;
  int d = d0 + lane / chunks, x = lane % chunks;
  for (; d <= d1; d += dd, x += dx) {
    if (x >= chunks) {
      x -= chunks;
      ++d;
      if (d > d1) break;
    }
    *reinterpret_cast<int4*>(trace + ((int64_t)(d - 1) * NP + p) * P + x0 + 16 * x) =
        make_int4(0, 0, 0, 0);
  }
}

// R entries of a boundary row from src (16-byte aligned, or 8 for R = 2
// ints): lane 31's boundary columns of the next block.
template <int R>
__device__ __forceinline__ void load_boundary(const int2* src, int2 (&bn)[R]) {
  const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < R / 2; ++q) {
    const int4 x = v[q];
    bn[2 * q] = make_int2(x.x, x.y);
    bn[2 * q + 1] = make_int2(x.z, x.w);
  }
}
template <int R>
__device__ __forceinline__ void load_boundary(const int* src, int (&bn)[R]) {
  if constexpr (R == 2) {
    const int2 x = *reinterpret_cast<const int2*>(src);
    bn[0] = x.x;
    bn[1] = x.y;
  } else {
    const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int4 x = v[q];
      bn[4 * q] = x.x;
      bn[4 * q + 1] = x.y;
      bn[4 * q + 2] = x.z;
      bn[4 * q + 3] = x.w;
    }
  }
}

// The boundary entry of an affine cell: max(M, I) and 2 D + (M >= I).
__device__ __forceinline__ int2 gotoh_boundary(int M, int I, int D) {
  return make_int2(max(M, I), (int)((unsigned)D << 1) | (M >= I ? 1 : 0));
}

// What the blocks of a strip of trace_diag share: the pair's result rows
// (res0: rm, or const's res; res1, res2: ri, rd), the grid, the lane's
// first row, the ring column lane 31 writes at step c (c - w_lo), the step
// of diagonal fin and the strip's last step, whether the lane stores trace
// codes, its trace bytes on the next step, and the bytes from one
// diagonal's trace row to the next.
struct TraceStrip {
  int32_t *res0, *res1, *res2;
  int n, m, ld, i0, w_lo, c_f, c_end;
  bool writes;
  int8_t* trow;
  int64_t tstep;
};

// One block of R steps c = k R + s of a strip of trace_diag in affine
// trace mode, for one lane (see the notes above; its loads as
// stream_block's). kEdge: the block may hold a step on which a row
// reaches column 0 (k < 32), a cell outside columns 1..m, the step of
// diagonal fin (M, I and D of each row whose cell is on the grid go to
// the results) or the strip's last step, after which it returns true; the
// other blocks skip those tests.
template <int R, bool kEdge>
__device__ __forceinline__ bool gotoh_trace_block(
    int k, int (&M)[R], int (&I)[R], int (&D)[R], int (&G)[R], int (&T)[R], int (&cb)[R],
    int (&bq)[R], int2 (&bn)[R], const char* prof, const int* lut, const uint8_t* be,
    const int2* bin, int2* bout, int lane, int go, int ge, TraceStrip& st) {
  const int goe = go + ge, m = st.m;
  int cn[R];
  int2 bc[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    cn[s] = lut[bq[s]] + 4 * lane;
    bc[s] = bn[s];
  }
  const int x0 = (k + 1 - lane) * R;
#pragma unroll
  for (int s = 0; s < R; ++s)
    bq[s] = (unsigned)(x0 + s) < (unsigned)m ? __ldg(be + x0 + s) : 0;
  if (lane == 31 && (k + 1) * R < st.ld) load_boundary<R>(bin + (k + 1) * R, bn);
  const int from = (lane + 31) & 31;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int c = k * R + s;
    cb[(s + 1) % R] = cn[s];
    // row 0's upper neighbour: row R - 1 of lane t - 1 on the step before,
    // and for lane 0 the boundary row's cell, which lane 31 rebuilds
    int sM = M[R - 1], sI = I[R - 1], sD = D[R - 1];
    if (lane == 31) {
      sI = bc[s].x;
      sM = (bc[s].y & 1) ? sI : sI - 1;
      sD = bc[s].y >> 1;
    }
    const int u0M = __shfl_sync(kAllLanes, sM, from);
    const int u0I = __shfl_sync(kAllLanes, sI, from);
    const int u0D = __shfl_sync(kAllLanes, sD, from);
    uint32_t w[(R + 3) / 4] = {};
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int uM = r > 0 ? M[r - 1] : u0M;  // cell (i - 1, j)
      const int uI = r > 0 ? I[r - 1] : u0I;
      const int uD = r > 0 ? D[r - 1] : u0D;
      const int sub = *reinterpret_cast<const int*>(prof + cb[(s + 1 - r + R) % R] + 128 * r);
      const int mv = sub + G[r];  // from (i - 1, j - 1), whose code is T[r]
      // I from (i, j - 1): goe + M, ge + I, goe + D; M wins a tie with I,
      // I a tie with D (each max with its tie in one DPX instruction)
      const bool md = M[r] >= D[r];
      const int x = max(M[r], D[r]);
      const int iv = __viaddmax_s32(x, goe, ge + I[r]);
      const int ti = x + go - (md ? 0 : 1) >= I[r] ? (md ? 0 : 2) : 1;
      // D from (i - 1, j): goe + M, goe + I, ge + D
      const bool mi = uM >= uI;
      const int uH = max(uM, uI);
      const int dv = __viaddmax_s32(uH, goe, ge + uD);
      const int td = uH + go >= uD ? (mi ? 0 : 1) : 2;
      int code = T[r] + 4 * ti + 16 * td;
      if (kEdge && (unsigned)(c - lane * R - r) >= (unsigned)m) code = 0;
      w[r / 4] |= (uint32_t)code << (8 * (r % 4));
      // the next step's upper-left cell is this step's upper one
      G[r] = max(uH, uD);
      T[r] = uH >= uD ? (mi ? 0 : 1) : 2;
      M[r] = mv;
      I[r] = iv;
      D[r] = dv;
    }
    if (lane == 31 && (unsigned)(c - st.w_lo) < (unsigned)m)
      bout[c - st.w_lo] = gotoh_boundary(M[R - 1], I[R - 1], D[R - 1]);
    if (st.writes) store_codes<R>(st.trow, w);
    st.trow += st.tstep;
    if (kEdge) {
      // the row that reached column 0 on this step takes cell (i, 0)
      const int rr = (s + 1) % R;
      if (lane == k + (s == R - 1 ? 1 : 0)) {
        M[rr] = kNeg;
        I[rr] = kNeg;
        D[rr] = go + ge * (st.i0 + rr);
      }
      if (c == st.c_f) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = st.i0 + r, j = c - lane * R - r + 1;
          if (i <= st.n && (unsigned)j <= (unsigned)m) {
            st.res0[i] = M[r];
            st.res1[i] = I[r];
            st.res2[i] = D[r];
          }
        }
      }
      if (c == st.c_end) return true;
    }
  }
  return false;
}

// One block of R steps of a strip of trace_diag in const's modes (kTrace:
// trace mode), for one lane: C holds the rows' last cells, G their next
// upper-left cells; the boundary row is one int a column. kEdge as for
// gotoh_trace_block.
template <int R, bool kEdge, bool kTrace>
__device__ __forceinline__ bool linear_diag_block(int k, int (&C)[R], int (&G)[R], int (&cb)[R],
                                                  int (&bq)[R], int (&bn)[R], const char* prof,
                                                  const int* lut, const uint8_t* be,
                                                  const int* bin, int* bout, int lane, int gap,
                                                  TraceStrip& st) {
  const int m = st.m;
  int cn[R], bc[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    cn[s] = lut[bq[s]] + 4 * lane;
    bc[s] = bn[s];
  }
  const int x0 = (k + 1 - lane) * R;
#pragma unroll
  for (int s = 0; s < R; ++s)
    bq[s] = (unsigned)(x0 + s) < (unsigned)m ? __ldg(be + x0 + s) : 0;
  if (lane == 31 && (k + 1) * R < st.ld) load_boundary<R>(bin + (k + 1) * R, bn);
  const int from = (lane + 31) & 31;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int c = k * R + s;
    cb[(s + 1) % R] = cn[s];
    const int u0 = __shfl_sync(kAllLanes, lane == 31 ? bc[s] : C[R - 1], from);
    uint32_t w[(R + 3) / 4] = {};
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int uC = r > 0 ? C[r - 1] : u0;  // cell (i - 1, j)
      const int sub = *reinterpret_cast<const int*>(prof + cb[(s + 1 - r + R) % R] + 128 * r);
      const int dg = G[r] + sub, lf = C[r] + gap, up = uC + gap;
      if (kTrace) {
        int code = argmax3(dg, lf, up);
        C[r] = __vimax3_s32(dg, lf, up);
        if (kEdge && (unsigned)(c - lane * R - r) >= (unsigned)m) code = 0;
        w[r / 4] |= (uint32_t)code << (8 * (r % 4));
      } else {
        C[r] = __vimax3_s32(dg, lf, up);
      }
      G[r] = uC;
    }
    if (lane == 31 && (unsigned)(c - st.w_lo) < (unsigned)m) bout[c - st.w_lo] = C[R - 1];
    if (kTrace) {
      if (st.writes) store_codes<R>(st.trow, w);
      st.trow += st.tstep;
    }
    if (kEdge) {
      const int rr = (s + 1) % R;
      if (lane == k + (s == R - 1 ? 1 : 0)) C[rr] = gap * (st.i0 + rr);
      if (c == st.c_f) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = st.i0 + r, j = c - lane * R - r + 1;
          if (i <= st.n && (unsigned)j <= (unsigned)m) st.res0[i] = C[r];
        }
      }
      if (c == st.c_end) return true;
    }
  }
  return false;
}

// kMode: kAffineTrace (go, ge: the affine gaps), kConstTrace or
// kConstScore (go: the linear gap). ring: per pair W rows of ld boundary
// entries (int2 affine, int const); trace: (n + m, NP, P) bytes, the
// padded rows of the trace modes.
template <int R, int kMode>
__global__ void __launch_bounds__(32 * kTraceMaxWarps, 1)
trace_diag_kernel(const int8_t* __restrict__ alpha,    // (NP, n)
                  const int8_t* __restrict__ beta,     // (NP, m)
                  const int32_t* __restrict__ fin,     // (NP,)
                  const int32_t* __restrict__ scores,  // (5, 5)
                  int go, int ge, int NP, int n, int m, int W, int ld, int P, void* ring,
                  int32_t* __restrict__ res0,          // (NP, n + 1): rm, or res
                  int32_t* __restrict__ res1,          // ri (affine)
                  int32_t* __restrict__ res2,          // rd (affine)
                  int8_t* __restrict__ trace) {
  constexpr bool kAffine = kMode == kAffineTrace, kTrace = kMode != kConstScore;
  // lut and the profiles as in affine_score_diag; progress[w]: warp w's
  // strip (high half) and blocks done (low)
  __shared__ int lut[256];
  __shared__ unsigned long long progress[kTraceMaxWarps];
  extern __shared__ int diag_prof[];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int slot = w / W, phase = w % W;  // the warp's pair in the block, its strips
  const int p = blockIdx.x * (blockDim.x / 32 / W) + slot;
  const int S = n + 1;
  for (int x = threadIdx.x; x < 256; x += blockDim.x) lut[x] = beta_row((int8_t)x) * R * 128;
  if (lane == 0) progress[w] = 0;
  const int f = p < NP ? fin[p] : 0;
  int2* ring2 = reinterpret_cast<int2*>(ring) + (int64_t)p * W * ld;
  int* ring1 = reinterpret_cast<int*>(ring) + (int64_t)p * W * ld;
  TraceStrip st;
  st.res0 = res0 + (int64_t)p * S;
  st.res1 = kAffine ? res1 + (int64_t)p * S : nullptr;
  st.res2 = kAffine ? res2 + (int64_t)p * S : nullptr;
  if (p < NP) {
    // every lane of the results NEG but row 0's cell (0, f) (affine: I =
    // go + ge f; const: gap f), the boundary of strip 0, row 0, in ring
    // row W - 1, and lane 0's trace byte of every diagonal
    const int t = phase * 32 + lane;
    const int e = kAffine ? go + ge * f : go * f;
    for (int x = t; x < S; x += 32 * W) {
      const bool row0 = x == 0 && f >= 1 && f <= m;
      st.res0[x] = !kAffine && row0 ? e : kNeg;
      if (kAffine) {
        st.res1[x] = row0 ? e : kNeg;
        st.res2[x] = kNeg;
      }
    }
    for (int x = t; x < ld; x += 32 * W) {
      if (kAffine)
        ring2[(W - 1) * ld + x] = gotoh_boundary(kNeg, x < m ? go + ge * (x + 1) : kNeg, kNeg);
      else
        ring1[(W - 1) * ld + x] = x < m ? go * (x + 1) : kNeg;
    }
    if (kTrace)
      for (int d = t; d < n + m; d += 32 * W)
        *reinterpret_cast<int4*>(trace + ((int64_t)d * NP + p) * P) = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  if (p >= NP || n == 0 || (!kTrace && (f < 1 || f > n + m))) return;  // the whole warp
  const int8_t* al = alpha + (int64_t)p * n;
  const uint8_t* be = (const uint8_t*)beta + (int64_t)p * m;
  int* prof = diag_prof + w * 5 * R * 32;
  const uint32_t mine = cta_address(progress + w),
                 before = cta_address(progress + slot * W + (phase + W - 1) % W);
  const int strips = (n + 32 * R - 1) / (32 * R);
  const int s_last = kTrace ? strips - 1 : (min(f, n) - 1) / (32 * R);
  st.n = n;
  st.m = m;
  st.ld = ld;
  st.tstep = (int64_t)NP * P;
  int M[R], I[R], D[R], G[R], T[R], cb[R], bq[R];
  int2 bn2[R];
  int bn1[R];
  for (int s = phase; s <= s_last; s += W) {
    const int r0 = s * 32 * R;
    const int c_f = f - r0 - 2;  // the step of diagonal f
    if (!kTrace && c_f < 0) {  // f = r0 + 1 (s = s_last): cell (f, 0), the strip's first row
      if (lane == 0) st.res0[f] = go * f;
      break;
    }
    const int i0 = r0 + lane * R + 1;  // this lane's first row
    const bool last = r0 + 32 * R >= n;
    const int c_end = last ? m - 1 + (n - 1 - r0) : m + 32 * R - 2;  // the strip's last step
    const int x_lo = 16 + r0, x_hi = 16 + min(r0 + 32 * R, (n + 15) / 16 * 16);
    if (kTrace) zero_trace(trace, NP, p, P, 1, r0 + 1, x_lo, x_hi, lane);
    // the profile and the rows' column-0 cells: affine (NEG, NEG, go + ge
    // i), const gap i in D; G[0] of lane 0 the cell (r0, 0)
    stream_strip_start<R>(r0, i0, lane, al, n, be, m, scores, prof, kAffine ? go : 0,
                          kAffine ? ge : go, M, I, D, G, cb, bq);
    if (kAffine) {
#pragma unroll
      for (int r = 0; r < R; ++r) T[r] = 0;
      T[0] = r0 == 0 ? argmax3(0, go, go) : argmax3(kNeg, kNeg, go + ge * r0);
    }
    if (kTrace && c_f == -1 && lane == 0) {  // cell (f, 0), the strip's first row, on no step
      st.res0[f] = kAffine ? kNeg : go * f;
      if (kAffine) {
        st.res1[f] = kNeg;
        st.res2[f] = go + ge * f;
      }
    }
    const int2* bin2 = ring2 + (int64_t)((s + W - 1) % W) * ld;
    int2* bout2 = ring2 + (int64_t)(s % W) * ld;
    const int* bin1 = ring1 + (int64_t)((s + W - 1) % W) * ld;
    int* bout1 = ring1 + (int64_t)(s % W) * ld;
    // the blocks the strip before has done, as far as this warp has seen
    // (the whole warp waits)
    const bool waits = W > 1 && s > 0;
    unsigned seen = 0;
    if (waits)
      while (seen < kDiagLag - 1) seen = observe(before, s - 1);
    if (lane == 31) {
      if (kAffine)
        load_boundary<R>(bin2, bn2);
      else
        load_boundary<R>(bin1, bn1);
    }
    const int c_stop = kTrace || c_f > c_end ? c_end : c_f;
    const int nblk = c_stop < 0 ? 0 : c_stop / R + 1;
    const bool feeds = s < s_last;  // a strip below reads this one's last row
    st.i0 = i0;
    st.w_lo = feeds ? 32 * R - 1 : (1 << 30);
    st.c_f = c_f;
    st.c_end = c_stop;
    st.writes = kTrace && i0 <= n;
    st.trow = kTrace ? trace + ((int64_t)(r0 + 1) * NP + p) * P + 15 + i0 : nullptr;
    const int k_f = c_f >= 0 && c_f <= c_stop ? c_f / R : -1;
    const int k_tail = m / R;  // the first block that may hold a cell past column m
    for (int k = 0; k < nblk; ++k) {
      if (waits)
        while (seen < (unsigned)(k + kDiagLag)) seen = observe(before, s - 1);
      const bool edge = k < 32 || k >= k_tail || k == k_f || k == nblk - 1;
      bool done;
      if constexpr (kAffine) {
        done = edge ? gotoh_trace_block<R, true>(k, M, I, D, G, T, cb, bq, bn2,
                                                  (const char*)prof, lut, be, bin2, bout2, lane,
                                                  go, ge, st)
                    : gotoh_trace_block<R, false>(k, M, I, D, G, T, cb, bq, bn2,
                                                   (const char*)prof, lut, be, bin2, bout2, lane,
                                                   go, ge, st);
      } else {
        done = edge ? linear_diag_block<R, true, kTrace>(k, D, G, cb, bq, bn1,
                                                         (const char*)prof, lut, be, bin1,
                                                         bout1, lane, go, st)
                    : linear_diag_block<R, false, kTrace>(k, D, G, cb, bq, bn1,
                                                          (const char*)prof, lut, be, bin1,
                                                          bout1, lane, go, st);
      }
      if (feeds && W > 1 && lane == 31) publish(mine, s, k + 1);
      if (done) break;
    }
    if (feeds && W > 1 && lane == 31) publish(mine, s, 0xffffffffu);
    if (kTrace) zero_trace(trace, NP, p, P, r0 + c_end + 3, n + m, x_lo, x_hi, lane);
  }
}

// One thread per lane, up to cap.
int threads_for(int lanes, int cap) {
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

// A launch of `blocks` blocks in clusters of CL, with `threads` threads
// and `smem` bytes of dynamic shared memory a block; `attr` holds the
// cluster size.
cudaLaunchConfig_t cluster_config(int blocks, int CL, int threads, size_t smem,
                                  void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The launch of affine_fwd_block on `clusters` clusters of CL blocks, each
// block sweeping up to chunk + 1 lanes (block 0's lane 0 included) with
// its state in shared memory when in_smem.
cudaLaunchConfig_t fwd_block_config(int clusters, int CL, int chunk,
                                    bool in_smem, void* stream,
                                    cudaLaunchAttribute* attr) {
  const size_t state = in_smem ? (size_t)9 * (chunk + 1) * sizeof(int32_t) : 0;
  return cluster_config(clusters * CL, CL, threads_for(chunk + 1, kLowmemThreads),
                        CL > 1 && state < kOwnSmBytes ? kOwnSmBytes : state,
                        stream, attr);
}

// affine_bwd_window at L lanes a thread, or null for an L it is not built
// for (kBwdLanesBuilt).
using BwdWindowKernel = decltype(&affine_bwd_window_kernel<2>);
BwdWindowKernel bwd_window_kernel(int L) {
  switch (L) {
    case 2: return &affine_bwd_window_kernel<2>;
    case 4: return &affine_bwd_window_kernel<4>;
    case 8: return &affine_bwd_window_kernel<8>;
    default: return nullptr;
  }
}

// Warps (strips of 32 L lanes) a block of a cluster of CL takes for a
// window of W lanes, at most kBwdMaxWarps, and the passes over the window
// that CL blocks of as many warps make.
int bwd_window_warps(int W, int CL, int L, int* passes) {
  const int strips = (W + 32 * L - 1) / (32 * L);
  const int per_block = (strips + CL - 1) / CL;
  const int NW = per_block < kBwdMaxWarps ? per_block : kBwdMaxWarps;
  *passes = (strips + CL * NW - 1) / (CL * NW);
  return NW;
}

// affine_fwd_block's kernel: its state in shared memory or a global
// scratch, in K6's own mode or the strip mode.
using FwdBlockKernel = decltype(&affine_fwd_block_kernel<false, false>);
FwdBlockKernel fwd_block_kernel(bool global, bool strip) {
  if (strip) return global ? &affine_fwd_block_kernel<true, true> : &affine_fwd_block_kernel<false, true>;
  return global ? &affine_fwd_block_kernel<true, false> : &affine_fwd_block_kernel<false, false>;
}

// Launches affine_fwd_block's kernel on B clusters of CL blocks.
int fwd_block_launch(bool strip, const void* alpha, const void* beta, const void* scores,
                     int go, int ge, int B, int n, int m, int d0, int K, int fin, int CL,
                     int chunk, const void* state_in, void* scratch, void* state_out,
                     void* capture, int lo, int width, const void* edge_in, void* edge_out,
                     const void* fin_vec, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_block_config(B, CL, chunk, scratch == nullptr,
                                                  stream, &attr);
  auto kernel = fwd_block_kernel(scratch != nullptr, strip);
  cudaError_t err = allow_smem(kernel, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, (const int8_t*)alpha,
                           (const int8_t*)beta, (const int32_t*)scores, go, ge, B, n,
                           m, d0, K, fin, CL, chunk, (const int32_t*)state_in,
                           (int32_t*)scratch, (int32_t*)state_out, (int32_t*)capture,
                           lo, width, (const int32_t*)edge_in, (int32_t*)edge_out,
                           (const int32_t*)fin_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* wavefront_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The launch of affine_fwd_block (in the strip mode where `strip`) with
// clusters of CL blocks at `chunk` lanes a block, written to out (three
// ints): the clusters the card holds at once, the dynamic shared memory a
// block asks for, and its threads.
extern "C" int affine_fwd_block_clusters(int CL, int chunk, int in_smem,
                                         int strip, void* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fwd_block_config(1, CL, chunk, in_smem, nullptr, &attr);
  auto kernel = fwd_block_kernel(!in_smem, strip);
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
  return fwd_block_launch(false, alpha, beta, scores, go, ge, B, n, m, d0, K, fin, CL,
                          chunk, state_in, scratch, state_out, capture, 0, n + 1,
                          nullptr, nullptr, nullptr, stream);
}

// The strip mode: lanes [lo, lo + width) of each pair, the state (3, 2,
// B, width), edge_in (B, K + 1, 3) or null where lo is 0, edge_out (B,
// K + 1, 3), capture (3, B, width) written where d == fin[b].
extern "C" int affine_fwd_strip_launch(const void* alpha, const void* beta,
                                       const void* scores, int go, int ge,
                                       int B, int n, int m, int d0, int K,
                                       int CL, int chunk, int lo, int width,
                                       const void* state_in, void* scratch,
                                       void* state_out, void* capture,
                                       const void* edge_in, void* edge_out,
                                       const void* fin, void* stream) {
  return fwd_block_launch(true, alpha, beta, scores, go, ge, B, n, m, d0, K, 0, CL,
                          chunk, state_in, scratch, state_out, capture, lo, width,
                          edge_in, edge_out, fin, stream);
}


// What affine_bwd_window is built for, written to out (3 ints and the
// lane counts): the most warps a block has, the largest cluster it takes,
// the number of lane counts a thread it is built for, and those counts,
// smallest first.
extern "C" int affine_bwd_window_built(void* out) {
  constexpr int built = sizeof(kBwdLanesBuilt) / sizeof(kBwdLanesBuilt[0]);
  int* res = (int*)out;
  res[0] = kBwdMaxWarps;
  res[1] = kMaxCluster;
  res[2] = built;
  for (int x = 0; x < built; ++x) res[3 + x] = kBwdLanesBuilt[x];
  return 0;
}

// The launch of affine_bwd_window with clusters of CL blocks for a window
// of W lanes at L lanes a thread, written to out (six ints): the clusters
// the card holds at once, the warps a block, the passes over the window,
// a block's threads, its static shared memory with the dynamic shared
// memory it asks for, and the diagonals between two progress reports.
// Every block asks for kOwnSmBytes, so that it has an SM to itself: the
// card would otherwise place several blocks of a cluster on one SM, which
// then issues the instructions of all their strips.
extern "C" int affine_bwd_window_clusters(int W, int CL, int L, void* out) {
  const BwdWindowKernel kernel = bwd_window_kernel(L);
  if (kernel == nullptr || CL < 1 || CL > kMaxCluster || W < 1) return (int)cudaErrorInvalidValue;
  int passes;
  const int NW = bwd_window_warps(W, CL, L, &passes);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, kOwnSmBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(CL, CL, 32 * NW, kOwnSmBytes, nullptr, &attr);
  int* res = (int*)out;
  res[1] = NW;
  res[2] = passes;
  res[3] = 32 * NW;
  res[4] = (int)(fa.sharedSizeBytes + kOwnSmBytes);
  res[5] = kBwdPeriod;
  return (int)cudaOccupancyMaxActiveClusters(res, (const void*)kernel, &cfg);
}

// edge: (passes - 1, B, K, 3) zeroed 64-bit words where the launch makes
// more than one pass (affine_bwd_window_clusters), else unused.
extern "C" int affine_bwd_window_launch(const void* alpha, const void* beta,
                                        const void* scores, int go, int ge,
                                        int B, int n, int m, int d0, int K,
                                        int W, int CL, int L,
                                        const void* i_cur, const void* state_in,
                                        void* edge, void* wlo, void* trace,
                                        void* stream) {
  const BwdWindowKernel kernel = bwd_window_kernel(L);
  if (kernel == nullptr || CL < 1 || CL > kMaxCluster || W < 1) return (int)cudaErrorInvalidValue;
  int passes;
  const int NW = bwd_window_warps(W, CL, L, &passes);
  if (passes > 1 && edge == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, kOwnSmBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B * CL, CL, 32 * NW, kOwnSmBytes, stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const int8_t*)alpha, (const int8_t*)beta,
      (const int32_t*)scores, go, ge, B, n, m, d0, K, W, CL, passes,
      (const int32_t*)i_cur, (const int32_t*)state_in, (unsigned long long*)edge,
      (int32_t*)wlo, (int8_t*)trace);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int lowmem_walk_block_launch(const void* trace, const void* wlo,
                                        int d0, int K, int W, int B, void* i,
                                        void* j, void* k, void* ops,
                                        void* stream) {
  lowmem_walk_block_kernel<<<(B + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps, 0,
                             (cudaStream_t)stream>>>(
      (const int8_t*)trace, (const int32_t*)wlo, d0, K, W, B, (int32_t*)i,
      (int32_t*)j, (int32_t*)k, (int8_t*)ops);
  return (int)cudaGetLastError();
}

using StreamKernel = void (*)(const int8_t*, const int8_t*, const int32_t*, int, int, int,
                             int, int, int, int2*, int32_t*);

StreamKernel stream_kernel(int R) {
#define STREAM_CASE(X) \
  if (R == X) return affine_stream_kernel<X>;
  STREAM_ROWS(STREAM_CASE)
#undef STREAM_CASE
  return nullptr;
}

// What affine_stream is built for, written to out: the warps (pairs) a
// block, the number of row counts a lane, and those counts, rising.
extern "C" int affine_stream_built(void* out) {
  int* res = (int*)out;
  int k = 0;
  res[0] = kStreamWarps;
#define STREAM_REPORT(X) res[2 + k++] = X;
  STREAM_ROWS(STREAM_REPORT)
#undef STREAM_REPORT
  res[1] = k;
  return 0;
}

// The launch of affine_stream for NP pairs of m columns at R rows a lane,
// written to out (seven ints): a block's threads, the blocks, the int2
// columns of a pair's boundary row (the scratch the caller allocates),
// the registers and local (spill) bytes a thread, the static shared
// memory a block and the blocks an SM holds at once.
extern "C" int affine_stream_shape(int NP, int m, int R, void* out) {
  const StreamKernel kernel = stream_kernel(R);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  int* res = (int*)out;
  res[0] = 32 * kStreamWarps;
  res[1] = (NP + kStreamWarps - 1) / kStreamWarps;
  res[2] = stream_ld(m, R);
  res[3] = fa.numRegs;
  res[4] = (int)fa.localSizeBytes;
  res[5] = (int)fa.sharedSizeBytes;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(res + 6, kernel, 32 * kStreamWarps, 0);
  return (int)err;
}

// bnd: (NP, stream_ld(m, R)) int2 scratch.
extern "C" int affine_stream_launch(const void* alpha, const void* beta,
                                    const void* scores, int go, int ge, int NP,
                                    int n, int m, int R, void* bnd, void* out,
                                    void* stream) {
  const StreamKernel kernel = stream_kernel(R);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<(NP + kStreamWarps - 1) / kStreamWarps, 32 * kStreamWarps, 0,
           (cudaStream_t)stream>>>((const int8_t*)alpha, (const int8_t*)beta,
                                   (const int32_t*)scores, go, ge, NP, n, m,
                                   stream_ld(m, R), (int2*)bnd, (int32_t*)out);
  return (int)cudaGetLastError();
}

using DiagKernel = void (*)(const int8_t*, const int8_t*, const int32_t*, const int32_t*,
                           int, int, int, int, int, int, int, int, int, int, int2*, int32_t*);

DiagKernel diag_kernel(int R) {
#define DIAG_CASE(X) \
  if (R == X) return affine_score_diag_kernel<X>;
  STREAM_ROWS(DIAG_CASE)
#undef DIAG_CASE
  return nullptr;
}

// Warps a block of affine_score_diag takes at W warps a pair: one pair's
// W warps, or kDiagPairWarps / W pairs of W warps where W is smaller.
int diag_block_warps(int W) { return W >= kDiagPairWarps ? W : kDiagPairWarps / W * W; }

// Its dynamic shared memory: a profile of 5 R x 32 int a warp.
size_t diag_smem(int R, int W) { return (size_t)diag_block_warps(W) * 5 * R * 32 * sizeof(int); }

// What affine_score_diag is built for, written to out: the most warps a
// block (and a pair) has, the warps (pairs) a block at one warp a pair,
// the number of row counts a lane, and those counts, rising.
extern "C" int affine_score_diag_built(void* out) {
  int* res = (int*)out;
  int k = 0;
  res[0] = kDiagMaxWarps;
  res[1] = kDiagPairWarps;
#define DIAG_REPORT(X) res[3 + k++] = X;
  STREAM_ROWS(DIAG_REPORT)
#undef DIAG_REPORT
  res[2] = k;
  return 0;
}

// The launch of affine_score_diag for NP pairs of m columns at R rows a
// lane and W warps a pair, written to out (seven ints): a block's threads,
// the blocks, the int2 columns of a ring row (the caller's scratch is NP W
// of them), the registers and local (spill) bytes a thread, a block's
// shared memory (static and dynamic) and the blocks an SM holds at once.
extern "C" int affine_score_diag_shape(int NP, int m, int R, int W, void* out) {
  const DiagKernel kernel = diag_kernel(R);
  if (kernel == nullptr || W < 1 || W > kDiagMaxWarps) return (int)cudaErrorInvalidValue;
  const int threads = 32 * diag_block_warps(W);
  const size_t smem = diag_smem(R, W);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  int* res = (int*)out;
  const int pairs = threads / 32 / W;
  res[0] = threads;
  res[1] = (NP + pairs - 1) / pairs;
  res[2] = stream_ld(m, R);
  res[3] = fa.numRegs;
  res[4] = (int)fa.localSizeBytes;
  res[5] = (int)(fa.sharedSizeBytes + smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(res + 6, kernel, threads, smem);
  return (int)err;
}

// The readout of diagonal fin of the score-mode Gotoh DP over rows rows
// (alpha rows past n read code 4) into out (nb, NP, Rb + 1); ring: (NP,
// W, stream_ld(m, R)) int2 scratch.
extern "C" int affine_score_diag_launch(const void* alpha, const void* beta,
                                        const void* fin, const void* scores, int go,
                                        int ge, int NP, int n, int m, int rows, int Rb,
                                        int nb, int R, int W, void* ring, void* out,
                                        void* stream) {
  const DiagKernel kernel = diag_kernel(R);
  if (kernel == nullptr || W < 1 || W > kDiagMaxWarps || rows > nb * Rb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = diag_smem(R, W);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * diag_block_warps(W);
  const int pairs = threads / 32 / W;
  kernel<<<(NP + pairs - 1) / pairs, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)fin,
      (const int32_t*)scores, go, ge, NP, n, m, rows, Rb, nb, W, stream_ld(m, R),
      (int2*)ring, (int32_t*)out);
  return (int)cudaGetLastError();
}

using TraceKernel = void (*)(const int8_t*, const int8_t*, const int32_t*, const int32_t*, int,
                            int, int, int, int, int, int, int, void*, int32_t*, int32_t*,
                            int32_t*, int8_t*);

// The rows a lane trace_diag is built for in its trace modes: those
// trace_diag_plan can take there (K2's trace mode ran 2.2x slower at R = 8
// than at R = 4 at the main shapes, PERF.md §6). Const's score mode takes
// STREAM_ROWS.
#define TRACE_ROWS(X) X(2) X(4)

TraceKernel trace_kernel(int R, int mode) {
#define TRACE_CASE(X)                                                 \
  if (R == X)                                                         \
    return mode == kAffineTrace ? trace_diag_kernel<X, kAffineTrace> \
                                : trace_diag_kernel<X, kConstTrace>;
#define SCORE_CASE(X) \
  if (R == X) return trace_diag_kernel<X, kConstScore>;
  if (mode == kAffineTrace || mode == kConstTrace) {
    TRACE_ROWS(TRACE_CASE)
  } else if (mode == kConstScore) {
    STREAM_ROWS(SCORE_CASE)
  }
#undef SCORE_CASE
#undef TRACE_CASE
  return nullptr;
}

// What trace_diag is built for in `mode`, written to out: the most warps a
// block (and a pair) has, the warps (pairs) a block at one warp a pair,
// the number of row counts a lane, and those counts, rising.
extern "C" int trace_diag_built(int mode, void* out) {
  if (mode < kAffineTrace || mode > kConstScore) return (int)cudaErrorInvalidValue;
  int* res = (int*)out;
  int k = 0;
  res[0] = kTraceMaxWarps;
  res[1] = kDiagPairWarps;
#define TRACE_REPORT(X) res[3 + k++] = X;
  if (mode == kConstScore) {
    STREAM_ROWS(TRACE_REPORT)
  } else {
    TRACE_ROWS(TRACE_REPORT)
  }
#undef TRACE_REPORT
  res[2] = k;
  return 0;
}

// The launch of trace_diag in `mode` (0 affine trace, 1 const trace, 2
// const score) for NP pairs of n x m at R rows a lane and W warps a pair,
// written to out (eight ints): a block's threads, the blocks, the entries
// of a ring row (the caller's scratch is NP W rows: int2 entries for
// affine, int for const), the registers and local (spill) bytes a thread,
// a block's shared memory (static and dynamic), the blocks an SM holds at
// once, and the pitch in bytes of a trace row (the caller's trace is
// (n + m, NP, pitch) bytes, lane s of a row at byte 15 + s).
extern "C" int trace_diag_shape(int NP, int n, int m, int R, int W, int mode, void* out) {
  const TraceKernel kernel = trace_kernel(R, mode);
  if (kernel == nullptr || W < 1 || W > kTraceMaxWarps) return (int)cudaErrorInvalidValue;
  const int threads = 32 * diag_block_warps(W);
  const size_t smem = diag_smem(R, W);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  int* res = (int*)out;
  const int pairs = threads / 32 / W;
  res[0] = threads;
  res[1] = (NP + pairs - 1) / pairs;
  res[2] = stream_ld(m, R);
  res[3] = fa.numRegs;
  res[4] = (int)fa.localSizeBytes;
  res[5] = (int)(fa.sharedSizeBytes + smem);
  res[7] = trace_pitch(n);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(res + 6, kernel, threads, smem);
  return (int)err;
}

// K2's trace mode (mode 0: rm, ri, rd in res0..res2) and K3 (mode 1 with
// trace, mode 2 without: res in res0) of NP pairs padded to n x m, at R
// rows a lane and W warps a pair; ring and the trace's padded rows as
// trace_diag_shape gives them (trace unused in mode 2).
extern "C" int trace_diag_launch(const void* alpha, const void* beta, const void* fin,
                                 const void* scores, int go, int ge, int NP, int n, int m,
                                 int R, int W, int mode, void* ring, void* res0, void* res1,
                                 void* res2, void* trace, void* stream) {
  const TraceKernel kernel = trace_kernel(R, mode);
  if (kernel == nullptr || W < 1 || W > kTraceMaxWarps ||
      (mode != kConstScore && trace == nullptr && n + m > 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = diag_smem(R, W);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * diag_block_warps(W);
  const int pairs = threads / 32 / W;
  kernel<<<(NP + pairs - 1) / pairs, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)fin, (const int32_t*)scores,
      go, ge, NP, n, m, W, stream_ld(m, R), trace_pitch(n), ring, (int32_t*)res0,
      (int32_t*)res1, (int32_t*)res2, (int8_t*)trace);
  return (int)cudaGetLastError();
}
