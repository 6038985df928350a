// The negacyclic NTT schedule, shared by every kernel that transforms:
// the fused multiplies and both directions of ntt_br.
//
// It is the reference's schedule (src/repro/kernels/ntt.py::_fwd_stages
// and _inv_stages) over uint32 residues, with the same twiddles:
//
//   DIF (forward), natural -> bit-reversed order, stages s = log_n-1 .. 0:
//     pairs (i0, i0 + 2^s) inside blocks of 2^(s+1),
//     (u, v) -> (u + v, (u - v) * w_s[j]),  j = i0 mod 2^s
//   DIT (inverse), bit-reversed -> natural order, stages s = 0 .. log_n-1:
//     t = v * wi_s[j],  (u, v) -> (u + t, u - t)
//
// Stage s reads only the first 2^s twiddles of its row, so one tower's
// twiddles fit one table of n entries, w_s[j] at index 2^s + j.  Every
// fixed operand (twiddle, twist, key transform) is a uint2 {w, w'} with
// Shoup's companion w' = floor(w 2^32 / q) (see modarith.cuh).
//
// Register passes.  The log_n stages are cut into 2-4 passes of up to 4
// stages (NttPlan).  In a pass covering stages [s_lo, s_lo + R), a
// thread holds the 2^R coefficients whose indices differ only in those
// bits and runs all R stages on them in registers, so shared memory is
// visited once per pass, not once per stage: at n = 4096, three passes of
// four stages.  The first DIF pass and the last DIT pass address indices
// t + m 2^s_lo with consecutive t on consecutive threads, so they read
// and write device memory directly, coalesced.  The last DIF pass and the
// first DIT pass cover the same index sets, so a multiply fuses them with
// the pointwise product in registers (fused_pass).  Shared memory pads one
// word per 32 (sidx), which keeps the strided passes free of bank
// conflicts.
#pragma once

#include "modarith.cuh"

namespace hades {

__host__ __device__ __forceinline__ int smem_words(int n) {
  return n + (n >> 5);
}

__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// log2 of a power of two n.
__host__ __device__ __forceinline__ int log2_pow2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// DIF pass i covers stages [s_lo(i), s_lo(i) + r(i)); pass 0 the highest.
// log_n in [5, 16]: ceil(log_n / 4) passes (at least 2), sizes as even as
// they go, the larger first (12 -> 4,4,4; 14 -> 4,4,3,3; 10 -> 4,3,3).
struct NttPlan {
  int log_n, passes, base, extra;
  __host__ __device__ explicit NttPlan(int ln) : log_n(ln) {
    passes = (ln + 3) / 4 < 2 ? 2 : (ln + 3) / 4;
    base = ln / passes;
    extra = ln % passes;
  }
  __device__ __forceinline__ int r(int i) const {
    return base + (i < extra ? 1 : 0);
  }
  __device__ __forceinline__ int s_lo(int i) const {
    return log_n - (i + 1) * base - (i + 1 < extra ? i + 1 : extra);
  }
};

template <int M>
struct Log2 {
  static constexpr int value = M == 2 ? 1 : M == 4 ? 2 : M == 8 ? 3 : 4;
};

// DIF stages s_lo + R - 1 .. s_lo on the 2^R values v[m] at indices
// base + (m << s_lo).
template <int M>
__device__ __forceinline__ void dif_regs(uint32_t (&v)[M], int base,
                                         int s_lo,
                                         const uint2* __restrict__ w,
                                         uint32_t q) {
  constexpr int R = Log2<M>::value;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int bb = R - 1 - r;
    const int h = 1 << (s_lo + bb);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m & (1 << bb)) continue;
      const int m2 = m | (1 << bb);
      const uint2 t = __ldg(w + h + ((base + (m << s_lo)) & (h - 1)));
      const uint32_t a = v[m], b = v[m2];
      v[m] = addmod(a, b, q);
      v[m2] = mul_shoup(a + q - b, t.x, t.y, q);
    }
  }
}

// DIT stages s_lo .. s_lo + R - 1, the same index sets.
template <int M>
__device__ __forceinline__ void dit_regs(uint32_t (&v)[M], int base,
                                         int s_lo,
                                         const uint2* __restrict__ w,
                                         uint32_t q) {
  constexpr int R = Log2<M>::value;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = 1 << (s_lo + r);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m & (1 << r)) continue;
      const int m2 = m | (1 << r);
      const uint2 t = __ldg(w + h + ((base + (m << s_lo)) & (h - 1)));
      const uint32_t u = v[m];
      const uint32_t tv = mul_shoup(v[m2], t.x, t.y, q);
      v[m] = addmod(u, tv, q);
      v[m2] = submod(u, tv, q);
    }
  }
}

// One pass of R stages over a polynomial: ld(i) gives coefficient i,
// st(i, x) takes it back.  Threads stride over the n / 2^R index sets.
template <bool DIT, int R, class Ld, class St>
__device__ __forceinline__ void pass_r(int n, int s_lo,
                                       const uint2* __restrict__ w,
                                       uint32_t q, Ld& ld, St& st) {
  constexpr int M = 1 << R;
  for (int t = threadIdx.x; t < (n >> R); t += blockDim.x) {
    const int base = ((t >> s_lo) << (s_lo + R)) | (t & ((1 << s_lo) - 1));
    uint32_t v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = ld(base + (m << s_lo));
    if (DIT)
      dit_regs(v, base, s_lo, w, q);
    else
      dif_regs(v, base, s_lo, w, q);
#pragma unroll
    for (int m = 0; m < M; ++m) st(base + (m << s_lo), v[m]);
  }
}

template <bool DIT, class Ld, class St>
__device__ __forceinline__ void pass(int R, int n, int s_lo,
                                     const uint2* __restrict__ w, uint32_t q,
                                     Ld ld, St st) {
  switch (R) {
    case 1: pass_r<DIT, 1>(n, s_lo, w, q, ld, st); break;
    case 2: pass_r<DIT, 2>(n, s_lo, w, q, ld, st); break;
    case 3: pass_r<DIT, 3>(n, s_lo, w, q, ld, st); break;
    default: pass_r<DIT, 4>(n, s_lo, w, q, ld, st); break;
  }
}

// The last DIF pass (stages R-1 .. 0, contiguous index sets), then
// mul(base, v) on the bit-reversed-order values, then the first DIT pass,
// all in registers over the shared-memory polynomial xs.
template <int R, class Mul>
__device__ __forceinline__ void fused_r(uint32_t* xs, int n,
                                        const uint2* __restrict__ wf,
                                        const uint2* __restrict__ wi,
                                        uint32_t q, Mul& mul) {
  constexpr int M = 1 << R;
  for (int t = threadIdx.x; t < (n >> R); t += blockDim.x) {
    const int base = t << R;
    uint32_t v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = xs[sidx(base + m)];
    dif_regs(v, base, 0, wf, q);
    mul(base, v);
    dit_regs(v, base, 0, wi, q);
#pragma unroll
    for (int m = 0; m < M; ++m) xs[sidx(base + m)] = v[m];
  }
}

template <class Mul>
__device__ __forceinline__ void fused_pass(int R, uint32_t* xs, int n,
                                           const uint2* __restrict__ wf,
                                           const uint2* __restrict__ wi,
                                           uint32_t q, Mul mul) {
  switch (R) {
    case 1: fused_r<1>(xs, n, wf, wi, q, mul); break;
    case 2: fused_r<2>(xs, n, wf, wi, q, mul); break;
    case 3: fused_r<3>(xs, n, wf, wi, q, mul); break;
    default: fused_r<4>(xs, n, wf, wi, q, mul); break;
  }
}

// Shared-memory accessors for pass().
struct SmemLd {
  const uint32_t* xs;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return xs[sidx(i)];
  }
};

struct SmemSt {
  uint32_t* xs;
  __device__ __forceinline__ void operator()(int i, uint32_t x) const {
    xs[sidx(i)] = x;
  }
};

// Coefficient i of an int64 row times the fixed twist tw[i].
struct TwistLd {
  const int64_t* __restrict__ src;
  const uint2* __restrict__ tw;
  uint32_t q;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    const uint2 t = __ldg(tw + i);
    return mul_shoup((uint32_t)src[i], t.x, t.y, q);
  }
};

// Coefficient i times the fixed twist tw[i], written to an int64 row.
struct TwistSt {
  int64_t* __restrict__ dst;
  const uint2* __restrict__ tw;
  uint32_t q;
  __device__ __forceinline__ void operator()(int i, uint32_t x) const {
    const uint2 t = __ldg(tw + i);
    dst[i] = (int64_t)mul_shoup(x, t.x, t.y, q);
  }
};

}  // namespace hades
