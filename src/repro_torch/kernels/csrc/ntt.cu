// Fused negacyclic multiply a ⊛ b over [B, K, n] int64 residues.
//
// Replaces the TPU kernel src/repro/kernels/ntt.py::_mul_kernel (wrapper
// negacyclic_mul, pallas_call at ntt.py:149): twist both operands by
// psi^i, DIF-NTT both (natural -> bit-reversed), multiply pointwise,
// DIT-INTT (bit-reversed -> natural), post-twist by psi^-i * n^-1.  The
// stage schedule and twiddle tables are the reference's (`_fwd_stages`
// with stage_w, `_inv_stages` with stage_w_inv), so the output is
// byte-identical to the plain version in kernels/ntt.py.
//
// Bound on this card: bytes.  One (polynomial, tower) reads 2 x n int64
// and writes n int64, against ~3 n/2 log2 n modular multiplies; at
// n = 4096 that is ~90k multiplies per 96 KB moved, below the integer
// rate.  Design: one block per (polynomial, tower); both operands stay
// in shared memory as uint32 (2 x 16 KB at n = 4096) across all log2 n
// stages, so device memory sees each input once and the output once.
// The second operand may have batch stride 0 (pk0, pk1, sk shared by
// every row) and is then read from L2.  Twiddles are read through L2.
// Not done yet: pre-transforming the fixed operand once per key.
#include <cuda_runtime.h>

#include "modarith.cuh"

using hades::addmod;
using hades::barrett_m;
using hades::mulmod;
using hades::submod;

__global__ void negacyclic_mul_kernel(
    const int64_t* __restrict__ a, int64_t a_bstride,
    const int64_t* __restrict__ b, int64_t b_bstride,
    int64_t* __restrict__ out,
    const int64_t* __restrict__ psi, const int64_t* __restrict__ psi_inv,
    const int64_t* __restrict__ wf, const int64_t* __restrict__ wi,
    const int64_t* __restrict__ qs, int K, int n, int log_n) {
  extern __shared__ uint32_t smem[];
  uint32_t* xa = smem;
  uint32_t* xb = smem + n;
  const int64_t row = blockIdx.x;
  const int k = blockIdx.y;
  const uint32_t q = (uint32_t)qs[k];
  const uint64_t m = barrett_m(q);
  const int half = n >> 1;

  const int64_t* pa = a + row * a_bstride + (int64_t)k * n;
  const int64_t* pb = b + row * b_bstride + (int64_t)k * n;
  const int64_t* tw = psi + (int64_t)k * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t t = (uint32_t)tw[i];
    xa[i] = mulmod((uint32_t)pa[i], t, q, m);
    xb[i] = mulmod((uint32_t)pb[i], t, q, m);
  }
  __syncthreads();

  // DIF: stage s pairs (i0, i0 + 2^s) inside blocks of 2^(s+1).
  const int64_t* w_f = wf + (int64_t)k * log_n * half;
  for (int s = log_n - 1; s >= 0; --s) {
    const int h = 1 << s;
    const int64_t* ws = w_f + (int64_t)s * half;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int j = t & (h - 1);
      const int i0 = ((t >> s) << (s + 1)) + j;
      const int i1 = i0 + h;
      const uint32_t w = (uint32_t)ws[j];
      uint32_t u = xa[i0], v = xa[i1];
      xa[i0] = addmod(u, v, q);
      xa[i1] = mulmod(submod(u, v, q), w, q, m);
      u = xb[i0];
      v = xb[i1];
      xb[i0] = addmod(u, v, q);
      xb[i1] = mulmod(submod(u, v, q), w, q, m);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    xa[i] = mulmod(xa[i], xb[i], q, m);
  __syncthreads();

  // DIT: stage s, t = v * w, (u + t, u - t).
  const int64_t* w_i = wi + (int64_t)k * log_n * half;
  for (int s = 0; s < log_n; ++s) {
    const int h = 1 << s;
    const int64_t* ws = w_i + (int64_t)s * half;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int j = t & (h - 1);
      const int i0 = ((t >> s) << (s + 1)) + j;
      const int i1 = i0 + h;
      const uint32_t u = xa[i0];
      const uint32_t tv = mulmod(xa[i1], (uint32_t)ws[j], q, m);
      xa[i0] = addmod(u, tv, q);
      xa[i1] = submod(u, tv, q);
    }
    __syncthreads();
  }

  const int64_t* ti = psi_inv + (int64_t)k * n;
  int64_t* po = out + (row * K + k) * (int64_t)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    po[i] = (int64_t)mulmod(xa[i], (uint32_t)ti[i], q, m);
}

// Strides are in elements; a stride of 0 repeats one polynomial for every
// row.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_negacyclic_mul(
    const void* a, long long a_bstride, const void* b, long long b_bstride,
    void* out, long long batch, const void* psi, const void* psi_inv,
    const void* wf, const void* wi, const void* qs, int K, int n,
    void* stream) {
  if (batch == 0) return 0;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const size_t smem = 2 * (size_t)n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        negacyclic_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = n / 2 < 512 ? n / 2 : 512;
  dim3 grid((unsigned)batch, (unsigned)K);
  negacyclic_mul_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, a_bstride, (const int64_t*)b, b_bstride,
      (int64_t*)out, (const int64_t*)psi, (const int64_t*)psi_inv,
      (const int64_t*)wf, (const int64_t*)wi, (const int64_t*)qs, K, n,
      log_n);
  return (int)cudaGetLastError();
}
