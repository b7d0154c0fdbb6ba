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
// :30-157).
//
// Cell (i, j) of a job lies on diagonal d = i + j at lane s = i (i walks
// the genome window alpha, j the read part beta); results are (C, S)
// int32 and the trace (n+m, C, S) int8, row d-1 holding diagonal d, for
// S = n + 1 lanes. One block runs one job: the n+m diagonals in a loop
// with a barrier between them, the block's threads striding over the S
// lanes. Three diagonal slots (d, d-1, d-2) and not the TPU kernels' two:
// a TPU step reads a whole slot before it overwrites it, but in a block
// thread s reads lane s-1 of the slot that thread s-1 writes. With three,
// one barrier per diagonal orders every read before the next overwrite.
// The state and the per-lane bests (6 rows of S int32 for the local DP,
// 5 for the anchored one) live in shared memory when they fit the
// wrapper's 200 KB (n <= 8532 local, n <= 10239 anchored), else in the
// job's part of a (C, rows x S) global scratch that stays in L1/L2; the
// wrapper picks (ops/wavefront.py state_in_shared_memory) and passes a
// null scratch for shared memory. Each lane's best value, its diagonal
// and the corner capture are touched only by the thread that owns the
// lane.
//
// What bounds them on the card: integer operations. A job's cells number
// n_b x m_b (at most ~192 x 192 for 150 bp reads) at ~10 int32 operations
// each; a wave of 2048 jobs a side is ~0.7 G operations (~0.09 ms at the
// int32 rate) against ~150 MB of trace (~0.045 ms at 3.35 TB/s). This
// design runs every cell of the padded grid and pays a barrier a
// diagonal; making it fast (a warp per job, the trace kept on chip for
// the walk) is later work. The TPU kernels' beta window, five profiles
// and 128-lane S are TPU mechanisms and are not carried over: the score
// is scores[row(beta code), clip(alpha code)], the profile's orientation
// (_select_score :85, _build_inputs :393).
//
// The walk is one warp per job: the warp finds the right side's first
// maximal lane, then one thread walks the trace (D = n+m dependent
// one-byte loads) and packs the ops; latency-bound, and small beside the
// DPs.
//
// Each entry returns cudaGetLastError() so that the caller can raise on
// a launch the runtime refused.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);  // NEG = -(2**30)
constexpr int kThreads = 512;
constexpr int kWalkWarps = 4;

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

// One warp per job. kLeft (_left_full): score = corner at lane n_b; walk
// from (n_b, m_b) while the score is > 0, i and j are > 0 and the code is
// not 3; the meta holds (score, i, j) where the walk stopped. Otherwise
// (_right_full): the first lane of the maximal best value; a max <= 0
// gives (0, 0) and score 0; walk from there to the origin with i and j
// clamped at 0; the meta holds (score, start i, start j). Both run D
// steps, code 4 once inactive, and pack min(op, 3) four to a byte, low
// bits first, padded with 3, after the 12-byte little-endian meta.
template <bool kLeft>
__global__ void __launch_bounds__(32 * kWalkWarps)
gsw_walk_pack_kernel(const int8_t* __restrict__ trace,    // (D, C, S)
                     const int32_t* __restrict__ values,  // (C, S) corner or bv
                     const int32_t* __restrict__ diags,   // (C, S) bd (right)
                     const int32_t* __restrict__ n_vec,   // (C,) (left)
                     const int32_t* __restrict__ m_vec,   // (C,) (left)
                     int C, int S, int D, int P,
                     uint8_t* __restrict__ out) {         // (C, 12 + P)
  const int b = blockIdx.x * kWalkWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= C) return;  // the whole warp leaves together
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
      const int ob = __shfl_xor_sync(0xffffffffu, best, k);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, k);
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
  if (lane != 0) return;
  uint8_t* row = out + (int64_t)b * (12 + P);
  int meta[3] = {score, i, j};
  bool active = !kLeft || score > 0;
  unsigned byte = 0;
  for (int step = 0; step < D; ++step) {
    int t = 4;
    const bool cont = kLeft ? (active && i > 0 && j > 0) : (i > 0 || j > 0);
    if (cont) {
      const int dd = min(max(i + j - 1, 0), D - 1);
      const int t_raw = trace[((int64_t)dd * C + b) * S + min(max(i, 0), S - 1)];
      if (kLeft && t_raw == 3) active = false;
      else t = t_raw;
    } else if (kLeft) {
      active = false;
    }
    if (t == 0 || t == 2) i -= 1;
    if (t == 0 || t == 1) j -= 1;
    if (!kLeft) { i = max(i, 0); j = max(j, 0); }
    byte |= (unsigned)min(t, 3) << (2 * (step & 3));
    if ((step & 3) == 3) {
      row[12 + step / 4] = (uint8_t)byte;
      byte = 0;
    }
  }
  if (D & 3) {
    for (int k = D & 3; k < 4; ++k) byte |= 3u << (2 * k);
    row[12 + D / 4] = (uint8_t)byte;
  }
  if (kLeft) { meta[1] = i; meta[2] = j; }
  for (int k = 0; k < 12; ++k) row[k] = (uint8_t)((unsigned)meta[k / 4] >> (8 * (k % 4)));
}

// One thread per lane (s = 0..n), up to kThreads.
int threads_for(int n) {
  const int t = (n + 1 + 31) / 32 * 32;
  return t < kThreads ? t : kThreads;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool kLocal>
int wavefront_launch(const void* alpha, const void* beta, const void* n_vec,
                     const void* m_vec, const void* scores, int gap, int C,
                     int n, int m, void* scratch, void* bv, void* bd,
                     void* corner, void* trace, void* stream) {
  const size_t smem = scratch ? 0 : (size_t)(kLocal ? 6 : 5) * (n + 1) * sizeof(int32_t);
  auto kernel = scratch ? &gsw_wavefront_kernel<kLocal, true>
                        : &gsw_wavefront_kernel<kLocal, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, threads_for(n), smem, (cudaStream_t)stream>>>(
      (const int8_t*)alpha, (const int8_t*)beta, (const int32_t*)n_vec,
      (const int32_t*)m_vec, (const int32_t*)scores, gap, C, n, m,
      (int32_t*)scratch, (int32_t*)bv, (int32_t*)bd, (int32_t*)corner,
      (int8_t*)trace);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* gsw_dp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int local_wavefront_launch(const void* alpha, const void* beta,
                                      const void* n_vec, const void* m_vec,
                                      const void* scores, int gap, int C,
                                      int n, int m, void* scratch, void* bv,
                                      void* bd, void* corner, void* trace,
                                      void* stream) {
  return wavefront_launch<true>(alpha, beta, n_vec, m_vec, scores, gap, C, n,
                                m, scratch, bv, bd, corner, trace, stream);
}

extern "C" int gsw_right_wavefront_launch(const void* alpha, const void* beta,
                                          const void* n_vec, const void* m_vec,
                                          const void* scores, int gap, int C,
                                          int n, int m, void* scratch,
                                          void* bv, void* bd, void* trace,
                                          void* stream) {
  return wavefront_launch<false>(alpha, beta, n_vec, m_vec, scores, gap, C,
                                 n, m, scratch, bv, bd, nullptr, trace, stream);
}

extern "C" int gsw_walk_pack_launch(const void* trace, const void* values,
                                    const void* diags, const void* n_vec,
                                    const void* m_vec, int left, int C,
                                    int S, int D, void* out, void* stream) {
  const int P = (D + 3) / 4;
  const int blocks = (C + kWalkWarps - 1) / kWalkWarps;
  auto kernel = left ? &gsw_walk_pack_kernel<true> : &gsw_walk_pack_kernel<false>;
  kernel<<<blocks, 32 * kWalkWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)trace, (const int32_t*)values, (const int32_t*)diags,
      (const int32_t*)n_vec, (const int32_t*)m_vec, C, S, D, P,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
