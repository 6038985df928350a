// The negacyclic NTT schedule in shared memory, shared by every kernel
// that transforms: the fused multiply and both directions of ntt_br.
//
// It is the reference's schedule (src/repro/kernels/ntt.py::_fwd_stages
// and _inv_stages) over uint32 residues, with the same twiddle tables:
//
//   DIF (forward), natural -> bit-reversed order, stages s = log_n-1 .. 0:
//     pairs (i0, i0 + 2^s) inside blocks of 2^(s+1),
//     (u, v) -> (u + v, (u - v) * stage_w[s][j]),  j = i0 mod 2^s
//   DIT (inverse), bit-reversed -> natural order, stages s = 0 .. log_n-1:
//     t = v * stage_w_inv[s][j],  (u, v) -> (u + t, u - t)
//
// Twiddles are one tower's [log_n, n/2] int64 table, read through L2.
// NP polynomials of n residues lie at x, x + n, ..., one butterfly loop
// serving all of them.  The caller syncs after filling x; each stage
// ends with __syncthreads(), so x is complete on return.
#pragma once

#include "modarith.cuh"

namespace hades {

// x *= tw (elementwise, mod q) while loading n int64 residues from src.
__device__ __forceinline__ void load_twisted(uint32_t* x,
                                             const int64_t* __restrict__ src,
                                             const int64_t* __restrict__ tw,
                                             uint32_t q, uint64_t m, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    x[i] = mulmod((uint32_t)src[i], (uint32_t)tw[i], q, m);
}

template <int NP>
__device__ __forceinline__ void dif_stages(uint32_t* x,
                                           const int64_t* __restrict__ w_f,
                                           uint32_t q, uint64_t m, int n,
                                           int log_n) {
  const int half = n >> 1;
  for (int s = log_n - 1; s >= 0; --s) {
    const int h = 1 << s;
    const int64_t* ws = w_f + (int64_t)s * half;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int j = t & (h - 1);
      const int i0 = ((t >> s) << (s + 1)) + j;
      const uint32_t w = (uint32_t)ws[j];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t* xp = x + p * n;
        const uint32_t u = xp[i0], v = xp[i0 + h];
        xp[i0] = addmod(u, v, q);
        xp[i0 + h] = mulmod(submod(u, v, q), w, q, m);
      }
    }
    __syncthreads();
  }
}

template <int NP>
__device__ __forceinline__ void dit_stages(uint32_t* x,
                                           const int64_t* __restrict__ w_i,
                                           uint32_t q, uint64_t m, int n,
                                           int log_n) {
  const int half = n >> 1;
  for (int s = 0; s < log_n; ++s) {
    const int h = 1 << s;
    const int64_t* ws = w_i + (int64_t)s * half;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int j = t & (h - 1);
      const int i0 = ((t >> s) << (s + 1)) + j;
      const uint32_t w = (uint32_t)ws[j];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t* xp = x + p * n;
        const uint32_t u = xp[i0];
        const uint32_t tv = mulmod(xp[i0 + h], w, q, m);
        xp[i0] = addmod(u, tv, q);
        xp[i0 + h] = submod(u, tv, q);
      }
    }
    __syncthreads();
  }
}

// log2 of a power of two n.
__host__ __device__ __forceinline__ int log2_pow2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace hades
