// The packed move-code layout of kernels C and D: editdp_fill.cu writes
// it, editdp_walk.cu reads it, ops/cuda_editdp.py::layout sizes it.
//
// The target's columns are words of WORD = 32; word j belongs to segment
// seg = j / T and thread k = j % T of that segment. One batch row's codes
// are pairs uint2 [nseg][steps][T]: the pair [seg][s][k] holds word
// seg*T + k at DP row x = s - k as two bit planes, .x the low bit of each
// column's code and .y the high bit, column WORD * j + i at bit i (0 for
// columns past Lt). Only rows x < qlen are written. At a step the 32
// threads of a warp store 32 neighbouring pairs: two 128-byte lines.
#pragma once

#include <stddef.h>

constexpr int WORD = 32;               // target columns a thread owns

// the pair of word k of segment seg at step s, in one row's codes
__host__ __device__ __forceinline__ size_t packed_word(int seg, int k,
                                                       int s, int T,
                                                       int steps) {
  return ((size_t)seg * steps + s) * T + k;
}
