// Modular arithmetic for residues below 2^31, shared by every kernel.
//
// Residues travel as int64 (the reference's layout) and are handled as
// uint32 inside the kernels.  A product of two residues fits 62 bits and
// is reduced by Barrett with m = floor(2^64 / q): the quotient estimate
// is at most one short, so one conditional subtract finishes it.  No
// signed `%` appears anywhere: C++ `%` truncates toward zero, so a
// difference is formed as u + q - v instead.
//
// The functions are __host__ __device__ so the same code compiles with
// a host compiler for a check against Python integers.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HADES_HD __host__ __device__ __forceinline__
#else
#define HADES_HD inline
#endif

namespace hades {

// floor(2^64 / q) for an odd q < 2^31 (q never divides 2^64).
HADES_HD uint64_t barrett_m(uint32_t q) { return ~0ull / q; }

HADES_HD uint64_t mulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// x mod q for any x < 2^64 - q.
HADES_HD uint32_t reduce(uint64_t x, uint32_t q, uint64_t m) {
  uint64_t r = x - mulhi64(x, m) * q;
  if (r >= q) r -= q;
  if (r >= q) r -= q;
  return (uint32_t)r;
}

HADES_HD uint32_t mulmod(uint32_t a, uint32_t b, uint32_t q, uint64_t m) {
  return reduce((uint64_t)a * b, q, m);
}

// a, b in [0, q): the sum stays below 2^32.
HADES_HD uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

HADES_HD uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

}  // namespace hades
