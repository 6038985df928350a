// Negacyclic NTT kernels over [B, K, n] int64 residues: the fused
// multiply a ⊛ b (with b a key already in the NTT domain, or with both
// operands varying), and the bit-reversed-order transform ntt_br in both
// directions.  All of them run the one schedule in ntt_stages.cuh, so the
// multiplies and the transforms cannot drift apart.
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
// (~28k at n = 4096 per 64 KB moved); the key-in-NTT multiply reads n and
// writes n against ~n log2 n + 3n.  Both are below the integer rate per
// byte.  Design: one block per (polynomial, tower); the polynomial stays
// in shared memory as uint32 (16.5 KB at n = 4096, 66 KB at n = 16384
// with the dynamic shared-memory opt-in) and is visited once per register
// pass of up to four stages (ntt_stages.cuh), so device memory sees each
// input once and the output once.  Every fixed multiplier (twiddles,
// twists, the key transform) is a 32-bit Shoup pair read through the
// read-only cache: one tower's tables are 4 x 32 KB at n = 4096.
//
// negacyclic_mul_ntt_kernel takes the fixed operand (pk0, pk1 or sk)
// already transformed, once per key (KeySet.key_br), so a row costs two
// transforms, not three.  negacyclic_mul_kernel keeps both operands
// varying (keygen's a * sk, tests): it transforms both and multiplies
// them pointwise by 64-bit Barrett, the one product with no fixed side.
#include <cuda_runtime.h>

#include "ntt_stages.cuh"

using hades::barrett_m;
using hades::mulmod;
using hades::mul_shoup;
using hades::NttPlan;
using hades::SmemLd;
using hades::SmemSt;
using hades::TwistLd;
using hades::TwistSt;

// One thread per 16 coefficients (a 4-stage pass), 32 to 256 of them.
// Blocks per SM asked of the register allocator, each kernel's fastest on
// the H100 among 2, 3 and 4 (PERF.md): the key multiply 3, the multiply
// of two varying operands 4, ntt_br forward 2 and inverse 4.
constexpr int kMaxThreads = 256;

// One tower's fixed tables: [4, n] uint2 Shoup pairs, in this order.
struct Tables {
  const uint2* psi;      // psi^i
  const uint2* psi_inv;  // psi^-i n^-1
  const uint2* wf;       // DIF twiddles, stage s at 2^s + j
  const uint2* wi;       // DIT twiddles, the same layout
  __device__ Tables(const uint2* t, int k, int n)
      : psi(t + (int64_t)k * 4 * n), psi_inv(psi + n), wf(psi + 2 * n),
        wi(psi + 3 * n) {}
};

// out[row] = a[row] * b, with b one polynomial per key: VAR = false, b is
// its bit-reversed-order transform as Shoup pairs [K, n] (`key`);
// VAR = true, b is an int64 row at b_bstride (0: one row for all), and is
// transformed here too.
template <bool VAR>
__global__ void __launch_bounds__(kMaxThreads, VAR ? 4 : 3)
    negacyclic_mul_kernel(
    const int64_t* __restrict__ a, int64_t a_bstride,
    const int64_t* __restrict__ b, int64_t b_bstride,
    const uint2* __restrict__ key, int64_t* __restrict__ out,
    const uint2* __restrict__ tables, const int64_t* __restrict__ qs, int K,
    int n, int log_n) {
  extern __shared__ uint32_t smem[];
  uint32_t* xa = smem;
  uint32_t* xb = smem + hades::smem_words(n);
  const int64_t row = blockIdx.x;
  const int k = blockIdx.y;
  const uint32_t q = (uint32_t)qs[k];
  const Tables tb(tables, k, n);
  const NttPlan p(log_n);
  const int last = p.passes - 1;

  hades::pass<false>(p.r(0), n, p.s_lo(0), tb.wf, q,
                     TwistLd{a + row * a_bstride + (int64_t)k * n, tb.psi, q},
                     SmemSt{xa});
  if constexpr (VAR)
    hades::pass<false>(p.r(0), n, p.s_lo(0), tb.wf, q,
                       TwistLd{b + row * b_bstride + (int64_t)k * n, tb.psi,
                               q},
                       SmemSt{xb});
  __syncthreads();
  for (int i = 1; i < last; ++i) {
    hades::pass<false>(p.r(i), n, p.s_lo(i), tb.wf, q, SmemLd{xa},
                       SmemSt{xa});
    if constexpr (VAR)
      hades::pass<false>(p.r(i), n, p.s_lo(i), tb.wf, q, SmemLd{xb},
                         SmemSt{xb});
    __syncthreads();
  }
  if constexpr (VAR) {
    const uint64_t m = barrett_m(q);
    hades::fused_pass(p.r(last), xa, n, tb.wf, tb.wi, q,
                      [&](int base, auto& v) {
                        constexpr int M = sizeof(v) / sizeof(v[0]);
                        uint32_t vb[M];
#pragma unroll
                        for (int j = 0; j < M; ++j)
                          vb[j] = xb[hades::sidx(base + j)];
                        hades::dif_regs(vb, base, 0, tb.wf, q);
#pragma unroll
                        for (int j = 0; j < M; ++j)
                          v[j] = mulmod(v[j], vb[j], q, m);
                      });
  } else {
    const uint2* kb = key + (int64_t)k * n;
    hades::fused_pass(p.r(last), xa, n, tb.wf, tb.wi, q,
                      [&](int base, auto& v) {
                        constexpr int M = sizeof(v) / sizeof(v[0]);
#pragma unroll
                        for (int j = 0; j < M; ++j) {
                          const uint2 w = __ldg(kb + base + j);
                          v[j] = mul_shoup(v[j], w.x, w.y, q);
                        }
                      });
  }
  __syncthreads();
  for (int i = last - 1; i >= 1; --i) {
    hades::pass<true>(p.r(i), n, p.s_lo(i), tb.wi, q, SmemLd{xa},
                      SmemSt{xa});
    __syncthreads();
  }
  hades::pass<true>(p.r(0), n, p.s_lo(0), tb.wi, q, SmemLd{xa},
                    TwistSt{out + (row * K + k) * (int64_t)n, tb.psi_inv,
                            q});
}

// FWD: out = DIF(x * psi), bit-reversed order;  !FWD: out = DIT(x) *
// psi_inv, natural order.  The contiguous passes meet device memory
// through shared memory, so every access to it is coalesced.
template <bool FWD>
__global__ void __launch_bounds__(kMaxThreads, FWD ? 2 : 4) ntt_br_kernel(
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

// Above 48 KB a kernel's dynamic shared memory needs an opt-in.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static int threads_for(int n) {
  const int t = n / 16;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

static bool n_supported(int n) {
  const int l = hades::log2_pow2(n);
  return (1 << l) == n && l >= 5 && l <= 16;
}

template <bool VAR>
static int launch_mul(const void* a, long long a_bstride, const void* b,
                      long long b_bstride, const void* key, void* out,
                      long long batch, const void* tables, const void* qs,
                      int K, int n, void* stream) {
  if (batch == 0) return 0;
  if (!n_supported(n)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (VAR ? 2 : 1) * (size_t)hades::smem_words(n) * sizeof(uint32_t);
  cudaError_t e = allow_smem(negacyclic_mul_kernel<VAR>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)batch, (unsigned)K);
  negacyclic_mul_kernel<VAR>
      <<<grid, threads_for(n), smem, (cudaStream_t)stream>>>(
          (const int64_t*)a, a_bstride, (const int64_t*)b, b_bstride,
          (const uint2*)key, (int64_t*)out, (const uint2*)tables,
          (const int64_t*)qs, K, n, hades::log2_pow2(n));
  return (int)cudaGetLastError();
}

// a, out: [batch, K, n] int64 (a at batch stride a_bstride, 0: one row
// for all).  key: the fixed operand's bit-reversed-order transform as
// Shoup pairs, [K, n] x {w, w'} uint32.  tables: Ring.shoup, [K, 4, n]
// pairs.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_negacyclic_mul_ntt(const void* a, long long a_bstride,
                                        const void* key, void* out,
                                        long long batch, const void* tables,
                                        const void* qs, int K, int n,
                                        void* stream) {
  return launch_mul<false>(a, a_bstride, nullptr, 0, key, out, batch,
                           tables, qs, K, n, stream);
}

// a, b: int64 rows of K*n at their batch strides (0 repeats one
// polynomial for every row); out: [batch, K, n].
extern "C" int hades_negacyclic_mul(const void* a, long long a_bstride,
                                    const void* b, long long b_bstride,
                                    void* out, long long batch,
                                    const void* tables, const void* qs,
                                    int K, int n, void* stream) {
  return launch_mul<true>(a, a_bstride, b, b_bstride, nullptr, out, batch,
                          tables, qs, K, n, stream);
}

// x, out: [batch, K, n] contiguous int64; fwd != 0 is the forward
// direction.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_ntt_br(const void* x, void* out, long long batch,
                            const void* tables, const void* qs, int K, int n,
                            int fwd, void* stream) {
  if (batch == 0) return 0;
  if (!n_supported(n)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)hades::smem_words(n) * sizeof(uint32_t);
  cudaError_t e = fwd ? allow_smem(ntt_br_kernel<true>, smem)
                      : allow_smem(ntt_br_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)batch, (unsigned)K);
  const int log_n = hades::log2_pow2(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (fwd)
    ntt_br_kernel<true><<<grid, threads_for(n), smem, s>>>(
        (const int64_t*)x, (int64_t*)out, (const uint2*)tables,
        (const int64_t*)qs, K, n, log_n);
  else
    ntt_br_kernel<false><<<grid, threads_for(n), smem, s>>>(
        (const int64_t*)x, (int64_t*)out, (const uint2*)tables,
        (const int64_t*)qs, K, n, log_n);
  return (int)cudaGetLastError();
}
