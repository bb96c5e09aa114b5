// The packed move-code layout of kernels C and D: editdp_fill.cu writes
// it, editdp_walk.cu reads it, ops/cuda_editdp.py::layout sizes it.
//
// One batch row's codes are words [nseg][steps][T]. The target's columns
// are strips of STRIP; strip j belongs to segment seg = j / T and thread
// k = j % T of that segment. At wavefront step s, thread k computes DP row
// x = s - k, and the word [seg][s][k] holds the STRIP two-bit codes of
// that row over the strip (column STRIP * j + i at bits 2i..2i+1; 0 for
// columns past Lt). Only rows x < qlen are written.
#pragma once

#include <stddef.h>

constexpr int STRIP = 16;              // target columns a thread owns

// the word of strip k of segment seg at step s, in one row's codes
__host__ __device__ __forceinline__ size_t packed_word(int seg, int k,
                                                       int s, int T,
                                                       int steps) {
  return ((size_t)seg * steps + s) * T + k;
}
