// The packed ops of the two trace walks, banded_walk_pack (banded.cu)
// and gsw_walk_pack (gsw_dp.cu): one warp a walk, every lane stepping
// alike, the lanes writing the packed row together.

#pragma once

#include <cstdint>

// The walk's ops, 2 bits a step, 16 steps to a word: each step's op
// enters the word's top bits and the word moves down 2 bits, so that
// step 16 g + s ends in bits 2 s of word g; word g is kept by lane g mod
// 32 and the warp stores 32 words at a time to the P bytes at ops, every
// lane its own 4 bytes.
struct OpWords {
  uint32_t acc = 0;   // the word being filled (the same on every lane)
  uint32_t held = 0;  // this lane's word of the current 32
  __device__ __forceinline__ void store(uint8_t* ops, int P, int g0, int g, int lane) const {
    const int gi = g0 + lane;  // this lane's word
    if (gi > g) return;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * gi + k < P) ops[4 * gi + k] = (uint8_t)(held >> (8 * k));
  }
  // step t's op (0..3)
  __device__ __forceinline__ void push(int t, uint32_t op, uint8_t* ops, int P, int lane) {
    acc = __funnelshift_r(acc, op, 2);
    if ((t & 15) == 15) {
      const int g = t >> 4;
      if (lane == (g & 31)) held = acc;
      if ((g & 31) == 31) store(ops, P, g - 31, g, lane);
    }
  }
  // the walk stopped before step t: steps t.. and the padding are 3
  __device__ __forceinline__ void finish(int t, uint8_t* ops, int P, int lane) {
    const int g = t >> 4, m = t & 15;  // m ops in the top bits of acc
    const uint32_t last = m ? (acc >> (32 - 2 * m)) | (~0u << (2 * m)) : ~0u;
    if (lane == (g & 31)) held = last;
    store(ops, P, g & ~31, g, lane);
    for (int k = 4 * (g + 1) + lane; k < P; k += 32) ops[k] = 0xff;
  }
};
