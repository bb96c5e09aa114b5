// int32 sums that wrap modulo 2^32, as XLA's int32 arithmetic does.
//
// The realign fills (kernels A and F) decide their move codes by exact
// ties such as `BIG + cost`, so the sums must wrap as the JAX package's
// do; signed overflow would be undefined behaviour in C++.
#pragma once

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
