// Modular arithmetic for residues below 2^31, shared by every kernel.
//
// Residues travel as int64 (the reference's layout) and are handled as
// uint32 inside the kernels.  A product of two varying residues fits 62
// bits and is reduced by Barrett with m = floor(2^64 / q): the quotient
// estimate is at most one short, so one conditional subtract finishes it.
// A product with a fixed operand w (a twiddle, a twist, a key transform)
// uses Shoup's form instead, with the precomputed w' = floor(w 2^32 / q):
// three 32-bit multiplies and one conditional subtract.  No
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

HADES_HD uint32_t mulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// Shoup's companion of a fixed w < q: floor(w * 2^32 / q).
HADES_HD uint32_t shoup(uint32_t w, uint32_t q) {
  return (uint32_t)(((uint64_t)w << 32) / q);
}

// x * w mod q for ANY x < 2^32, w < q < 2^31, wp = shoup(w, q).  The
// quotient estimate umulhi(x, wp) is at most one short, so x*w - qhat*q
// lies in [0, 2q), below 2^32: exact in 32-bit arithmetic.
HADES_HD uint32_t mul_shoup(uint32_t x, uint32_t w, uint32_t wp,
                            uint32_t q) {
  const uint32_t r = x * w - mulhi32(x, wp) * q;
  return r >= q ? r - q : r;
}

// (sum_b acc[b] * 2^(8b)) mod q: the byte columns of the tensor-core
// Eval recombined.  Each column is reduced first, then Horner in base
// 2^8 keeps every intermediate below 2^39.
HADES_HD uint32_t recombine_bytes(const uint64_t acc[4], uint32_t q,
                                  uint64_t m) {
  uint32_t r = reduce(acc[3], q, m);
  for (int b = 2; b >= 0; --b)
    r = reduce(((uint64_t)r << 8) + reduce(acc[b], q, m), q, m);
  return r;
}

// a, b in [0, q): the sum stays below 2^32.  Branch-free: the unsigned
// minimum of s and s - q is whichever of them lies in [0, q).
HADES_HD uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b, t = s - q;
  return t < s ? t : s;
}

// a, b in [0, q): a - b wraps above 2^32 - q exactly when a < b, and then
// a - b + q is the residue; the unsigned minimum picks it.
HADES_HD uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t t = a - b, u = t + q;
  return u < t ? u : t;
}

}  // namespace hades
