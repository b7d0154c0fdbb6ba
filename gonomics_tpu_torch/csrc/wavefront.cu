// Anti-diagonal wavefront DP for batched pairwise global alignment, for
// Hopper (sm_90a): global affine (Gotoh, three states) and global linear
// gap alignment, each with a trace mode and a score mode.
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
    const int32_t *M1 = st + t1 * S, *I1 = st + (3 + t1) * S, *D1 = st + (6 + t1) * S;
    const int32_t *M2 = st + t2 * S, *I2 = st + (3 + t2) * S, *D2 = st + (6 + t2) * S;
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
      const int m1 = M1[s], i1 = I1[s], d1 = D1[s];
      const int m1p = M1[s - 1], i1p = I1[s - 1], d1p = D1[s - 1];
      const int m2p = M2[s - 1], i2p = I2[s - 1], d2p = D2[s - 1];
      const int ai = goe + m1, bi = ge + i1, ci = goe + d1;   // I from (i, j-1)
      const int ad = goe + m1p, bd = goe + i1p, cd = ge + d1p; // D from (i-1, j)
      const int mv = substitution(sc, al, be, s, d - s) + max3(m2p, i2p, d2p);
      const int iv = max3(ai, bi, ci);
      const int dv = max3(ad, bd, cd);
      if (kTrace)
        trow[s] = (int8_t)(argmax3(m2p, i2p, d2p) + 4 * argmax3(ai, bi, ci) +
                           16 * argmax3(ad, bd, cd));
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

// One thread per interior lane (s = 1..n), up to kThreads.
int threads_for(int n) {
  const int t = (max(n, 1) + 31) / 32 * 32;
  return t < kThreads ? t : kThreads;
}

// Opts a kernel into `bytes` of dynamic shared memory where that is more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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
