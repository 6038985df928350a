// ntt_br as one block per (polynomial, tower), whatever the batch: the
// design the package's ntt_br had before its narrow and wide forms
// (csrc/ntt.cu), kept only to time those forms against it.  It includes
// the package's ntt.cu, so the library also carries every entry of the
// package's own; tools/kernel_variants.py builds it (build_c1) and
// chip_smoke.py times it beside the planned forms.
#include "ntt.cu"

// FWD: out = DIF(x * psi), bit-reversed order;  !FWD: out = DIT(x) *
// psi_inv, natural order.  The contiguous passes meet device memory
// through shared memory, so every access to it is coalesced.
template <bool FWD>
__global__ void __launch_bounds__(kMaxThreads, FWD ? 2 : 4) ntt_br_c1_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ out,
    const uint2* __restrict__ tables, const int64_t* __restrict__ qs, int K,
    int n, int log_n) {
  extern __shared__ uint32_t smem[];
  const int64_t row = blockIdx.x;
  const int k = blockIdx.y;
  const uint32_t q = (uint32_t)qs[k];
  const Tables tb(tables, k, n);
  const NttPlan p(log_n);
  const int64_t poly = (row * K + k) * (int64_t)n;

  if (FWD) {
    hades::pass<false>(p.r(0), n, p.s_lo(0), tb.wf, q,
                       TwistLd{x + poly, tb.psi, q}, SmemSt{smem});
    __syncthreads();
    for (int i = 1; i < p.passes; ++i) {
      hades::pass<false>(p.r(i), n, p.s_lo(i), tb.wf, q, SmemLd{smem},
                         SmemSt{smem});
      __syncthreads();
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      out[poly + i] = (int64_t)smem[hades::sidx(i)];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      smem[hades::sidx(i)] = (uint32_t)x[poly + i];
    __syncthreads();
    for (int i = p.passes - 1; i >= 1; --i) {
      hades::pass<true>(p.r(i), n, p.s_lo(i), tb.wi, q, SmemLd{smem},
                        SmemSt{smem});
      __syncthreads();
    }
    hades::pass<true>(p.r(0), n, p.s_lo(0), tb.wi, q, SmemLd{smem},
                      TwistSt{out + poly, tb.psi_inv, q});
  }
}

// x, out: [batch, K, n] contiguous int64; fwd != 0 is the forward
// direction.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_ntt_br_c1(const void* x, void* out, long long batch,
                               const void* tables, const void* qs, int K,
                               int n, int fwd, void* stream) {
  if (batch == 0) return 0;
  if (!n_supported(n)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)hades::smem_words(n) * sizeof(uint32_t);
  cudaError_t e = fwd ? allow_smem(ntt_br_c1_kernel<true>, smem)
                      : allow_smem(ntt_br_c1_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)batch, (unsigned)K);
  const int log_n = hades::log2_pow2(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (fwd)
    ntt_br_c1_kernel<true><<<grid, threads_for(n), smem, s>>>(
        (const int64_t*)x, (int64_t*)out, (const uint2*)tables,
        (const int64_t*)qs, K, n, log_n);
  else
    ntt_br_c1_kernel<false><<<grid, threads_for(n), smem, s>>>(
        (const int64_t*)x, (int64_t*)out, (const uint2*)tables,
        (const int64_t*)qs, K, n, log_n);
  return (int)cudaGetLastError();
}
