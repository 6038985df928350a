// HADES Eval, coefficient 0: the gadget-mode kernel for every (atom, row)
// lane of a scan tile, and the paper-mode kernel (further below) for
// lane pairs or the rows of one column.
//
// Replaces the TPU kernel src/repro/kernels/cmp_eval.py::_eval_gadget_kernel
// (wrapper eval_coeff0_gadget, pallas_call at cmp_eval.py:111).  Per lane
// and target tower k it returns
//
//   ( scale * d0[k][0]  +  Σ_{k_src, j} coeff0(digit_{k_src,j}(d1) ⊛ cek[k_src, j, k]) )  mod q_k
//
// with d0 = col.c0 - bound.c0, d1 = col.c1 - bound.c1 (mod q) and digits of
// gadget_log_base bits.  The TPU kernel gets there with NTTs; this one
// uses coeff0(x ⊛ c) = <x, rev(c)>, rev(c)[0] = c[0], rev(c)[i] = -c[n-i]
// mod q, against the reversed coefficient-domain gadget CEK (`cek_rev`,
// precomputed once per key set).  Digits are < 2^8 and rev(c) < 2^31, so
// the E*n-term sum stays below 2^54 and one reduction per lane suffices:
// the result is byte-identical to the reference's NTT form.
//
// Bound on this card: integer issue.  Each lane needs K*E*n = 65.5k
// 32x32->64-bit multiply-adds at paper-bfv, which run on the SM's 64
// INT32 lanes, half the FP32 lanes; at the served shapes that takes
// longer than reading each row's 64 KB of c1 once from HBM.  Besides,
// every c1 element meets D*K = 8 int64 cek_rev words read through L2
// (512 KB per row in all).  Design: one block per
// (row, chunk of up to 8 atoms).  The row's c1 is read from device memory
// once per chunk and reused by every atom of the chunk; digits are cut in
// registers, so the reference's [B, E, K, n] broadcast digit tensor never
// exists; cek_rev (512 KB) and the atom bounds are read through L2; the
// lane sums meet in warp shuffles and one shared-memory pass.  The row
// tile is addressed by pointer offset into the table's column, so no tile
// copy is made.
#include <cuda_runtime.h>

#include "modarith.cuh"

using hades::barrett_m;
using hades::mulmod;
using hades::reduce;
using hades::submod;

constexpr int kThreads = 256;

template <int K, int ACH>
__global__ void eval_gadget_kernel(
    const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
    const int64_t* __restrict__ bc0, const int64_t* __restrict__ bc1,
    int64_t b_astride, int64_t b_rstride,
    const int64_t* __restrict__ cek_rev, const int64_t* __restrict__ qs,
    int64_t scale, int64_t* __restrict__ out, int A, int rows, int n, int D,
    int log_b) {
  const int r = blockIdx.x;
  const int a0 = blockIdx.y * ACH;
  const int na = A - a0 < ACH ? A - a0 : ACH;
  const int64_t kn = (int64_t)K * n;
  const int64_t* crow = c1 + (int64_t)r * kn;
  const int64_t* brow[ACH];
#pragma unroll
  for (int a = 0; a < ACH; ++a) {
    const int aa = a0 + (a < na ? a : na - 1);
    brow[a] = bc1 + aa * b_astride + (int64_t)r * b_rstride;
  }
  const uint32_t mask = (1u << log_b) - 1u;

  uint64_t acc[ACH][K];
#pragma unroll
  for (int a = 0; a < ACH; ++a)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[a][k] = 0;

#pragma unroll
  for (int ks = 0; ks < K; ++ks) {
    const uint32_t q = (uint32_t)qs[ks];
    const int64_t* cek_ks = cek_rev + (int64_t)ks * D * kn;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t x = (uint32_t)crow[ks * n + i];
      uint32_t d[ACH];
#pragma unroll
      for (int a = 0; a < ACH; ++a)
        d[a] = a < na ? submod(x, (uint32_t)brow[a][ks * n + i], q) : 0u;
      for (int j = 0; j < D; ++j) {
        uint32_t ck[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          ck[k] = (uint32_t)cek_ks[((int64_t)j * K + k) * n + i];
        const int sh = j * log_b;
#pragma unroll
        for (int a = 0; a < ACH; ++a) {
          const uint32_t dig = (d[a] >> sh) & mask;
#pragma unroll
          for (int k = 0; k < K; ++k) acc[a][k] += (uint64_t)dig * ck[k];
        }
      }
    }
  }

  __shared__ uint64_t red[kThreads / 32][ACH * K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < ACH; ++a)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint64_t v = acc[a][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][a * K + k] = v;
    }
  __syncthreads();

  for (int o = threadIdx.x; o < na * K; o += blockDim.x) {
    const int a = o / K;
    const int k = o % K;
    uint64_t s = 0;
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w)
      s += red[w][a * K + k];
    const uint64_t q = (uint64_t)qs[k];
    const uint32_t col0 = (uint32_t)c0[(int64_t)r * kn + (int64_t)k * n];
    const uint32_t bnd0 =
        (uint32_t)bc0[(a0 + a) * b_astride + (int64_t)r * b_rstride +
                      (int64_t)k * n];
    const uint64_t d0 = submod(col0, bnd0, (uint32_t)q);
    const uint64_t scaled = d0 * ((uint64_t)scale % q) % q;
    out[((int64_t)(a0 + a) * rows + r) * K + k] =
        (int64_t)((scaled + s % q) % q);
  }
}

template <int K, int ACH>
static int launch(const void* c0, const void* c1, const void* bc0,
                  const void* bc1, long long b_astride, long long b_rstride,
                  const void* cek_rev, const void* qs, long long scale,
                  void* out, int A, int rows, int n, int D, int log_b,
                  cudaStream_t stream) {
  dim3 grid((unsigned)rows, (unsigned)((A + ACH - 1) / ACH));
  eval_gadget_kernel<K, ACH><<<grid, kThreads, 0, stream>>>(
      (const int64_t*)c0, (const int64_t*)c1, (const int64_t*)bc0,
      (const int64_t*)bc1, b_astride, b_rstride, (const int64_t*)cek_rev,
      (const int64_t*)qs, scale, (int64_t*)out, A, rows, n, D, log_b);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_k(const void* c0, const void* c1, const void* bc0,
                    const void* bc1, long long b_astride, long long b_rstride,
                    const void* cek_rev, const void* qs, long long scale,
                    void* out, int A, int rows, int n, int D, int log_b,
                    cudaStream_t stream) {
#define HADES_EVAL_LAUNCH(ach)                                              \
  return launch<K, ach>(c0, c1, bc0, bc1, b_astride, b_rstride, cek_rev, qs, \
                        scale, out, A, rows, n, D, log_b, stream)
  if (A == 1) HADES_EVAL_LAUNCH(1);
  if (A == 2) HADES_EVAL_LAUNCH(2);
  if (A <= 4) HADES_EVAL_LAUNCH(4);
  HADES_EVAL_LAUNCH(8);
#undef HADES_EVAL_LAUNCH
}

// c0/c1: the tile's first row of one column, rows of K*n contiguous int64.
// bc0/bc1: bounds, lane (a, r) at a*b_astride + r*b_rstride (elements).
// out: [A, rows, K] int64 residues.  K must be 1 or 2.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_eval_gadget(
    const void* c0, const void* c1, const void* bc0, const void* bc1,
    long long b_astride, long long b_rstride, const void* cek_rev,
    const void* qs, long long scale, void* out, int A, int rows, int K,
    int n, int D, int log_b, void* stream) {
  if (A == 0 || rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 1)
    return launch_k<1>(c0, c1, bc0, bc1, b_astride, b_rstride, cek_rev, qs,
                       scale, out, A, rows, n, D, log_b, s);
  if (K == 2)
    return launch_k<2>(c0, c1, bc0, bc1, b_astride, b_rstride, cek_rev, qs,
                       scale, out, A, rows, n, D, log_b, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Paper-mode HADES Eval, coefficient 0.
//
// Replaces the TPU kernel src/repro/kernels/cmp_eval.py::_eval_paper_kernel
// (wrapper eval_coeff0_paper, pallas_call at cmp_eval.py:80).  Per lane r
// and tower k it returns
//
//   ( scale * d0[k][0]  +  coeff0(d1[k] ⊛ cek[k]) )  mod q_k
//
// with d = a - b (lane form) or d = a (column form: the column side of the
// executor's paper-mode factoring, and the bounds side, each evaluated once
// and subtracted afterwards).  The TPU kernel gets there with an NTT round
// trip per lane; this one uses coeff0(x ⊛ c) = <x, rev(c)>, rev(c)[0] =
// c[0], rev(c)[i] = -c[n-i] mod q, against the reversed paper CEK
// (`KeySet.cek_rev`, [K, n], precomputed once per key set).  Terms are
// 31 x 31-bit, so each is Barrett-reduced before it is summed: n reduced
// terms stay below 2^43, and one more reduction ends the lane.  a - b is
// formed in registers as a + q - b; no difference tensor exists and no
// signed % is used.
//
// Bound on this card: bytes.  A lane reads its K*n int64 words of c1 (64 KB
// at paper-bfv), one coefficient of c0 per tower and, in the lane form, as
// much of b (nothing when b has batch stride 0), against K*n reduced
// multiply-adds: far below the integer rate per byte.  Design: one block
// per lane, coalesced 8-byte reads, rev(cek) (64 KB) read through L2, the
// per-tower sums met in warp shuffles and one shared-memory pass.  The
// column form addresses a row tile of a table's column by pointer (the
// wrapper passes the tile's first row), so no tile copy is made.

template <bool HAS_B>
__global__ void eval_paper_kernel(
    const int64_t* __restrict__ a0, int64_t sa0,
    const int64_t* __restrict__ a1, int64_t sa1,
    const int64_t* __restrict__ b0, int64_t sb0,
    const int64_t* __restrict__ b1, int64_t sb1,
    const int64_t* __restrict__ cek_rev, const int64_t* __restrict__ qs,
    int64_t scale, int64_t* __restrict__ out, int K, int n) {
  const int64_t r = blockIdx.x;
  __shared__ uint64_t red[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k) {
    const uint32_t q = (uint32_t)qs[k];
    const uint64_t m = barrett_m(q);
    const int64_t* x = a1 + r * sa1 + (int64_t)k * n;
    const int64_t* y = HAS_B ? b1 + r * sb1 + (int64_t)k * n : nullptr;
    const int64_t* c = cek_rev + (int64_t)k * n;
    uint64_t acc = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t d = HAS_B ? submod((uint32_t)x[i], (uint32_t)y[i], q)
                               : (uint32_t)x[i];
      acc += mulmod(d, (uint32_t)c[i], q, m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint64_t s = 0;
      for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) s += red[w];
      const uint32_t x0 = (uint32_t)a0[r * sa0 + (int64_t)k * n];
      const uint32_t d0 =
          HAS_B ? submod(x0, (uint32_t)b0[r * sb0 + (int64_t)k * n], q) : x0;
      const uint32_t scaled = mulmod(d0, (uint32_t)((uint64_t)scale % q), q, m);
      out[r * K + k] = (int64_t)reduce((uint64_t)scaled + reduce(s, q, m),
                                       q, m);
    }
    __syncthreads();
  }
}

// a0/a1: lane r's rows at r * sa0 / r * sa1 (elements), each K*n int64.
// b0/b1: the same for the subtracted side, or both null (column form);
// a stride of 0 repeats one polynomial for every lane.  cek_rev: [K, n].
// out: [lanes, K] int64 residues.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_eval_paper(
    const void* a0, long long sa0, const void* a1, long long sa1,
    const void* b0, long long sb0, const void* b1, long long sb1,
    const void* cek_rev, const void* qs, long long scale, void* out,
    long long lanes, int K, int n, void* stream) {
  if (lanes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)lanes;
  if (b0 != nullptr && b1 != nullptr)
    eval_paper_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int64_t*)a0, sa0, (const int64_t*)a1, sa1,
        (const int64_t*)b0, sb0, (const int64_t*)b1, sb1,
        (const int64_t*)cek_rev, (const int64_t*)qs, scale, (int64_t*)out,
        K, n);
  else if (b0 == nullptr && b1 == nullptr)
    eval_paper_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int64_t*)a0, sa0, (const int64_t*)a1, sa1, nullptr, 0,
        nullptr, 0, (const int64_t*)cek_rev, (const int64_t*)qs, scale,
        (int64_t*)out, K, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
