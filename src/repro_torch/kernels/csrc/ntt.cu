// Negacyclic NTT kernels over [B, K, n] int64 residues: the fused
// multiply a ⊛ b, and the bit-reversed-order transform ntt_br in both
// directions.  All three run the one schedule in ntt_stages.cuh, so the
// multiply and the transforms cannot drift apart.
//
// Replaces the TPU kernel src/repro/kernels/ntt.py::_mul_kernel (wrapper
// negacyclic_mul, pallas_call at ntt.py:149): twist both operands by
// psi^i, DIF-NTT both (natural -> bit-reversed), multiply pointwise,
// DIT-INTT (bit-reversed -> natural), post-twist by psi^-i * n^-1.
//
// Replaces the TPU kernels src/repro/kernels/ntt.py::_ntt_kernel and
// _intt_kernel (wrapper ntt_br, pallas_call at ntt.py:129): forward is
// the psi pre-twist + DIF (natural -> bit-reversed), inverse is DIT
// (bit-reversed -> natural) + the psi^-1 * n^-1 post-twist.  The output
// of the forward transform is in bit-reversed order; it equals the
// plain version in kernels/ntt.py byte for byte.
//
// Bound on this card: bytes.  One (polynomial, tower) of ntt_br reads n
// int64 and writes n int64 against n/2 log2 n + n modular multiplies
// (~28k at n = 4096 per 64 KB moved); the multiply reads 2n and writes
// n against ~3 n/2 log2 n + 4n.  Both are below the integer rate per
// byte.  Design: one block per (polynomial, tower); the polynomial stays
// in shared memory as uint32 (16 KB at n = 4096, 64 KB at n = 16384 with
// the dynamic shared-memory opt-in) across all log2 n stages, so device
// memory sees each input once and the output once.  The multiply's
// second operand may have batch stride 0 (pk0, pk1, sk shared by every
// row) and is then read from L2.  Twiddles are read through L2.
// Not done yet: pre-transforming the multiply's fixed operand once per
// key.
#include <cuda_runtime.h>

#include "ntt_stages.cuh"

using hades::barrett_m;
using hades::mulmod;

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
  const int64_t twist = (int64_t)k * n;
  const int64_t table = (int64_t)k * log_n * (n >> 1);

  hades::load_twisted(xa, a + row * a_bstride + twist, psi + twist, q, m, n);
  hades::load_twisted(xb, b + row * b_bstride + twist, psi + twist, q, m, n);
  __syncthreads();
  hades::dif_stages<2>(smem, wf + table, q, m, n, log_n);

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    xa[i] = mulmod(xa[i], xb[i], q, m);
  __syncthreads();
  hades::dit_stages<1>(xa, wi + table, q, m, n, log_n);

  const int64_t* ti = psi_inv + twist;
  int64_t* po = out + (row * K + k) * (int64_t)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    po[i] = (int64_t)mulmod(xa[i], (uint32_t)ti[i], q, m);
}

// FWD: out = DIF(x * psi);  !FWD: out = DIT(x) * psi_inv.  `tw` is psi or
// psi_inv, `w` stage_w or stage_w_inv, each [K, ...] over the towers.
template <bool FWD>
__global__ void ntt_br_kernel(const int64_t* __restrict__ x,
                              int64_t* __restrict__ out,
                              const int64_t* __restrict__ tw,
                              const int64_t* __restrict__ w,
                              const int64_t* __restrict__ qs, int K, int n,
                              int log_n) {
  extern __shared__ uint32_t smem[];
  const int64_t row = blockIdx.x;
  const int k = blockIdx.y;
  const uint32_t q = (uint32_t)qs[k];
  const uint64_t m = barrett_m(q);
  const int64_t poly = (row * K + k) * (int64_t)n;
  const int64_t* twk = tw + (int64_t)k * n;
  const int64_t* wk = w + (int64_t)k * log_n * (n >> 1);

  if (FWD) {
    hades::load_twisted(smem, x + poly, twk, q, m, n);
    __syncthreads();
    hades::dif_stages<1>(smem, wk, q, m, n, log_n);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      out[poly + i] = (int64_t)smem[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      smem[i] = (uint32_t)x[poly + i];
    __syncthreads();
    hades::dit_stages<1>(smem, wk, q, m, n, log_n);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      out[poly + i] = (int64_t)mulmod(smem[i], (uint32_t)twk[i], q, m);
  }
}

// Above 48 KB a kernel's dynamic shared memory needs an opt-in.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static int threads_for(int n) { return n / 2 < 512 ? n / 2 : 512; }

// Strides are in elements; a stride of 0 repeats one polynomial for every
// row.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_negacyclic_mul(
    const void* a, long long a_bstride, const void* b, long long b_bstride,
    void* out, long long batch, const void* psi, const void* psi_inv,
    const void* wf, const void* wi, const void* qs, int K, int n,
    void* stream) {
  if (batch == 0) return 0;
  const size_t smem = 2 * (size_t)n * sizeof(uint32_t);
  cudaError_t e = allow_smem(negacyclic_mul_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)batch, (unsigned)K);
  negacyclic_mul_kernel<<<grid, threads_for(n), smem, (cudaStream_t)stream>>>(
      (const int64_t*)a, a_bstride, (const int64_t*)b, b_bstride,
      (int64_t*)out, (const int64_t*)psi, (const int64_t*)psi_inv,
      (const int64_t*)wf, (const int64_t*)wi, (const int64_t*)qs, K, n,
      hades::log2_pow2(n));
  return (int)cudaGetLastError();
}

// x, out: [batch, K, n] contiguous int64.  fwd != 0: tw = psi_pow and
// w = stage_w; fwd == 0: tw = psi_inv_pow and w = stage_w_inv.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_ntt_br(const void* x, void* out, long long batch,
                            const void* tw, const void* w, const void* qs,
                            int K, int n, int fwd, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  cudaError_t e = fwd ? allow_smem(ntt_br_kernel<true>, smem)
                      : allow_smem(ntt_br_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)batch, (unsigned)K);
  const int log_n = hades::log2_pow2(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (fwd)
    ntt_br_kernel<true><<<grid, threads_for(n), smem, s>>>(
        (const int64_t*)x, (int64_t*)out, (const int64_t*)tw,
        (const int64_t*)w, (const int64_t*)qs, K, n, log_n);
  else
    ntt_br_kernel<false><<<grid, threads_for(n), smem, s>>>(
        (const int64_t*)x, (int64_t*)out, (const int64_t*)tw,
        (const int64_t*)w, (const int64_t*)qs, K, n, log_n);
  return (int)cudaGetLastError();
}
