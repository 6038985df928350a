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
// byte.  Design of the multiplies: one block per (polynomial, tower); the polynomial stays in shared memory as uint32
// the polynomial stays in shared memory as uint32 (16.5 KB at n = 4096,
// 66 KB at n = 16384 with the dynamic shared-memory opt-in) and is
// visited once per register pass of up to four stages (ntt_stages.cuh),
// so device memory sees each input once and the output once.  Every
// fixed multiplier (twiddles, twists, the key transform) is a 32-bit
// Shoup pair read through the read-only cache: one tower's tables are
// 4 x 32 KB at n = 4096.
//
// ntt_br has two forms, chosen per call by the wrapper's plan
// (kernels/ntt.py) from the card's SM count and shared memory.  Both run
// the same stages with the same tables and Shoup arithmetic, so their
// output is the same, and both read each stage's twiddles once per
// thread (pass_tw: 15 loads a 4-stage pass instead of 32).  What held
// the earlier one-block-per-(polynomial, tower) design back (it is kept
// only as tools/ntt_c1.cu, for comparison): a block walks n coefficients
// alone, so a few polynomials at n = 16,384 leave most SMs idle (0.019
// ms for one on an H100); its inverse, held to 64 registers, runs at
// 1.3-2x its forward; and per-butterfly twiddle loads crowd the load
// units.
//
// * Narrow (fewer items than SMs at n >= 16,384, or a polynomial whose
//   wide form does not fit a block: clusters of C = kCluster = 8
//   blocks): each (polynomial, tower) is split over the C blocks of a
//   thread-block cluster (ntt_split.cuh), block r holding
//   coefficients [r n/C, (r+1) n/C) in its shared memory.  The forward's
//   cross pass loads its groups straight from device memory (16 values a
//   thread in flight), runs the log2 C stages of stride >= n/C in
//   registers and stores each value into the owning block's shared
//   memory (distributed shared memory); after one cluster barrier every
//   block runs the local stages as register passes over its n/C
//   coefficients and writes them out.  The inverse runs the local passes
//   first, then the cross pass reads the owners' shared memory and writes
//   device memory.  C = 8 (2,048 coefficients a block at n = 16,384) is
//   the largest portable size; at the paths' shapes on an H100, C = 16,
//   which needs the non-portable opt-in, was within 5 % of it (PERF.md).
//   tools/kernel_variants.py builds the other sizes.
// * Wide (everything else): a resident grid of blocks (two a SM) that
//   each walk (polynomial, tower) items, one block per item below a wave.
//   With a staged row (depth 1) the next item's int64 row is copied into
//   a staging buffer in shared memory by cp.async while the current
//   item's passes run, so a block never waits on device memory at an
//   item's start; the inverse's first pass then also reads shared memory
//   instead of a strided loop over device memory.  The inverse always
//   stages (at n = 16,384 its 194 KB leave one block a SM and it is
//   still the fastest form); the forward stages only at n <= 4,096 from
//   two items a block (32 KB beside the 16.5 KB working buffer) and
//   otherwise reads device memory 16 values a thread in its first pass.
//
// negacyclic_mul_ntt_kernel takes the fixed operand (pk0, pk1 or sk)
// already transformed, once per key (KeySet.key_br), so a row costs two
// transforms, not three.  negacyclic_mul_kernel keeps both operands
// varying (keygen's a * sk, tests): it transforms both and multiplies
// them pointwise by 64-bit Barrett, the one product with no fixed side.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_split.cuh"
#include "ntt_stages.cuh"

namespace cg = cooperative_groups;

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
// of two varying operands 4, ntt_br's wide form 2.
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

// The narrow form's blocks per (polynomial, tower), and its smallest
// block: n / kCluster >= kMinBlock coefficients.
constexpr int kCluster = 8;
constexpr int kMinBlock = 256;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The register passes of the narrow and wide forms.  They run the
// butterflies of ntt_stages.cuh's pass() in the same order, but read each
// stage's twiddles once per thread: in a pass of R stages from s_lo, the
// thread's index set is tlow + (m << s_lo) plus high bits (tlow = its
// index mod 2^s_lo), so stage s_lo + b needs only the 2^b twiddles
// tlow + (i << s_lo), i < 2^b, of its 2^(R-1) butterflies: 15 loads a
// 4-stage pass instead of 32.

// Stage s_lo + BB of a pass over v (M = 2^R values, BB < R): its 2^BB
// twiddles from wh (at stride 2^s_lo), each for the M / 2^(BB+1) pairs
// (m, m + 2^BB) with m = i mod 2^BB.  Every bound is a compile-time
// constant, so v and the twiddles stay in registers.
template <int M, int BB, bool DIT>
__device__ __forceinline__ void stage_tw(uint32_t (&v)[M],
                                         const uint2* __restrict__ wh,
                                         int s_lo, uint32_t q) {
#pragma unroll
  for (int i = 0; i < (1 << BB); ++i) {
    const uint2 t = __ldg(wh + (i << s_lo));
#pragma unroll
    for (int hi = 0; hi < (M >> (BB + 1)); ++hi) {
      const int m = (hi << (BB + 1)) | i;
      const int m2 = m | (1 << BB);
      if (DIT) {
        const uint32_t u = v[m];
        const uint32_t tv = mul_shoup(v[m2], t.x, t.y, q);
        v[m] = hades::addmod(u, tv, q);
        v[m2] = hades::submod(u, tv, q);
      } else {
        const uint32_t a = v[m], b = v[m2];
        v[m] = hades::addmod(a, b, q);
        v[m2] = mul_shoup(a + q - b, t.x, t.y, q);
      }
    }
  }
}

// DIF stages s_lo + R - 1 .. s_lo on the thread's index set.
template <int M>
__device__ __forceinline__ void dif_regs_tw(uint32_t (&v)[M], int tlow,
                                            int s_lo,
                                            const uint2* __restrict__ w,
                                            uint32_t q) {
  constexpr int R = hades::Log2<M>::value;
  const uint2* wt = w + tlow;
  if constexpr (R > 3) stage_tw<M, 3, false>(v, wt + (8 << s_lo), s_lo, q);
  if constexpr (R > 2) stage_tw<M, 2, false>(v, wt + (4 << s_lo), s_lo, q);
  if constexpr (R > 1) stage_tw<M, 1, false>(v, wt + (2 << s_lo), s_lo, q);
  stage_tw<M, 0, false>(v, wt + (1 << s_lo), s_lo, q);
}

// DIT stages s_lo .. s_lo + R - 1, the same index sets.
template <int M>
__device__ __forceinline__ void dit_regs_tw(uint32_t (&v)[M], int tlow,
                                            int s_lo,
                                            const uint2* __restrict__ w,
                                            uint32_t q) {
  constexpr int R = hades::Log2<M>::value;
  const uint2* wt = w + tlow;
  stage_tw<M, 0, true>(v, wt + (1 << s_lo), s_lo, q);
  if constexpr (R > 1) stage_tw<M, 1, true>(v, wt + (2 << s_lo), s_lo, q);
  if constexpr (R > 2) stage_tw<M, 2, true>(v, wt + (4 << s_lo), s_lo, q);
  if constexpr (R > 3) stage_tw<M, 3, true>(v, wt + (8 << s_lo), s_lo, q);
}

template <bool DIT, int R, class Ld, class St>
__device__ __forceinline__ void pass_tw_r(int n, int s_lo,
                                          const uint2* __restrict__ w,
                                          uint32_t q, Ld& ld, St& st) {
  constexpr int M = 1 << R;
  for (int t = threadIdx.x; t < (n >> R); t += blockDim.x) {
    const int tlow = t & ((1 << s_lo) - 1);
    const int base = ((t >> s_lo) << (s_lo + R)) | tlow;
    uint32_t v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = ld(base + (m << s_lo));
    if (DIT)
      dit_regs_tw(v, tlow, s_lo, w, q);
    else
      dif_regs_tw(v, tlow, s_lo, w, q);
#pragma unroll
    for (int m = 0; m < M; ++m) st(base + (m << s_lo), v[m]);
  }
}

template <bool DIT, class Ld, class St>
__device__ __forceinline__ void pass_tw(int R, int n, int s_lo,
                                        const uint2* __restrict__ w,
                                        uint32_t q, Ld ld, St st) {
  switch (R) {
    case 1: pass_tw_r<DIT, 1>(n, s_lo, w, q, ld, st); break;
    case 2: pass_tw_r<DIT, 2>(n, s_lo, w, q, ld, st); break;
    case 3: pass_tw_r<DIT, 3>(n, s_lo, w, q, ld, st); break;
    default: pass_tw_r<DIT, 4>(n, s_lo, w, q, ld, st); break;
  }
}

// The n coefficients of a shared-memory polynomial out to a 16-byte
// aligned int64 row, two a thread at a time (one 16-byte store; the
// padded reads of 2t and 2t + 1 fall in distinct banks across a warp).
__device__ __forceinline__ void store_pairs(int64_t* __restrict__ dst,
                                            const uint32_t* xs, int n) {
  for (int i = 2 * threadIdx.x; i < n; i += 2 * blockDim.x) {
    longlong2 v;
    v.x = (long long)xs[hades::sidx(i)];
    v.y = (long long)xs[hades::sidx(i + 1)];
    *reinterpret_cast<longlong2*>(dst + i) = v;
  }
}

// The narrow form: grid (rows * C, K), clusters of (C, 1, 1); block
// (row * C + r, k) holds coefficients [r nc, (r+1) nc) of (row, k) in
// shared memory (ntt_split.cuh).  Every thread runs the same number of
// cross-pass rounds, so the cluster barrier inside the first round is
// reached by all of them.
template <bool FWD, int C>
__global__ void __launch_bounds__(kMaxThreads) ntt_br_cluster(
    const int64_t* __restrict__ x, int64_t* __restrict__ out,
    const uint2* __restrict__ tables, const int64_t* __restrict__ qs, int K,
    int n, int log_n) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / C;
  const int k = blockIdx.y;
  const uint32_t q = (uint32_t)qs[k];
  const Tables tb(tables, k, n);
  const hades::Split sp{C, log_n - hades::CrossLog2<C>::value};
  const int nc = sp.nc();
  const NttPlan p(sp.log_nc);
  const int64_t poly = (row * K + k) * (int64_t)n;
  const int g0 = sp.group_begin(rank), g1 = sp.group_begin(rank + 1);
  // a thread takes RD groups a round: 16 coefficients in flight, all
  // loaded before the first butterfly
  constexpr int RD = 16 / C;
  const int span = RD * (int)blockDim.x;
  int rounds = (g1 - g0 + span - 1) / span;
  if (rounds < 1) rounds = 1;

  if (FWD) {
    // every block of the cluster has started once this barrier completes;
    // it is waited on only before the first store into another block
    cluster_arrive_relaxed();
    for (int it = 0; it < rounds; ++it) {
      uint32_t v[RD][C];
#pragma unroll
      for (int d = 0; d < RD; ++d) {
        const int j = g0 + it * span + d * (int)blockDim.x + threadIdx.x;
        if (j < g1)
          hades::cross_fwd<C>(v[d], j, sp.log_nc, x + poly, tb.psi, tb.wf,
                              q);
      }
      if (it == 0) cluster_wait();
#pragma unroll
      for (int d = 0; d < RD; ++d) {
        const int j = g0 + it * span + d * (int)blockDim.x + threadIdx.x;
        if (j >= g1) continue;
#pragma unroll
        for (int m = 0; m < C; ++m)
          *cluster.map_shared_rank(smem + hades::sidx(j), m) = v[d][m];
      }
    }
    cluster.sync();                 // release the stores, acquire them
    for (int i = 0; i < p.passes; ++i) {
      pass_tw<false>(p.r(i), nc, p.s_lo(i), tb.wf, q, SmemLd{smem},
                     SmemSt{smem});
      __syncthreads();
    }
    store_pairs(out + poly + (int64_t)rank * nc, smem, nc);
  } else {
    const int64_t* src = x + poly + (int64_t)rank * nc;
    for (int i = threadIdx.x; i < nc; i += blockDim.x)
      smem[hades::sidx(i)] = (uint32_t)src[i];
    __syncthreads();
    for (int i = p.passes - 1; i >= 0; --i) {
      pass_tw<true>(p.r(i), nc, p.s_lo(i), tb.wi, q, SmemLd{smem},
                    SmemSt{smem});
      __syncthreads();
    }
    cluster.sync();
    for (int it = 0; it < rounds; ++it) {
      uint32_t v[RD][C];
#pragma unroll
      for (int d = 0; d < RD; ++d) {
        const int j = g0 + it * span + d * (int)blockDim.x + threadIdx.x;
        if (j >= g1) continue;
#pragma unroll
        for (int m = 0; m < C; ++m)
          v[d][m] = *cluster.map_shared_rank(smem + hades::sidx(j), m);
      }
#pragma unroll
      for (int d = 0; d < RD; ++d) {
        const int j = g0 + it * span + d * (int)blockDim.x + threadIdx.x;
        if (j < g1)
          hades::cross_inv<C>(v[d], j, sp.log_nc, out + poly, tb.psi_inv,
                              tb.wi, q);
      }
    }
    cluster.sync();   // no block leaves while another reads its memory
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n int64 from device memory into shared memory, 16 bytes a thread at a
// time (both 16-byte aligned: the wrapper hands an aligned operand).
__device__ __forceinline__ void stage_row(int64_t* dst,
                                          const int64_t* __restrict__ src,
                                          int n) {
  for (int i = 2 * threadIdx.x; i < n; i += 2 * blockDim.x)
    cp_async16(dst + i, src + i);
}

// Coefficient i of a staged int64 row times the fixed twist tw[i].
struct StagedTwistLd {
  const int64_t* s;
  const uint2* __restrict__ tw;
  uint32_t q;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    const uint2 t = __ldg(tw + i);
    return mul_shoup((uint32_t)s[i], t.x, t.y, q);
  }
};

// Shared memory of the wide form: the staged int64 row (STAGED), then
// the working polynomial as uint32.
static size_t wide_smem(int n, bool staged) {
  return (staged ? (size_t)n * sizeof(int64_t) : 0) +
         (size_t)hades::smem_words(n) * sizeof(uint32_t);
}

// The wide form: a resident grid; block b runs the items (row * K + k) b,
// b + G, b + 2G, ...  STAGED: item it + G is copied into the staging
// buffer right after item it's first pass has left it, so it lands while
// item it's other passes run.  Otherwise the first pass reads device
// memory itself.
template <bool FWD, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, 2) ntt_br_wide(
    const int64_t* __restrict__ x, int64_t* __restrict__ out,
    const uint2* __restrict__ tables, const int64_t* __restrict__ qs, int K,
    int n, int log_n, int64_t items) {
  extern __shared__ __align__(16) unsigned char wide_buf[];
  int64_t* stage = reinterpret_cast<int64_t*>(wide_buf);
  uint32_t* work = reinterpret_cast<uint32_t*>(stage + (STAGED ? n : 0));
  const NttPlan p(log_n);
  const int64_t step = gridDim.x;
  if (STAGED && blockIdx.x < items) {
    stage_row(stage, x + blockIdx.x * (int64_t)n, n);
    cp_async_commit();
  }
  for (int64_t it = blockIdx.x; it < items; it += step) {
    const int k = (int)(it % K);
    const uint32_t q = (uint32_t)qs[k];
    const Tables tb(tables, k, n);
    if constexpr (STAGED) cp_async_wait<0>();
    __syncthreads();
    if constexpr (STAGED) {
      if (FWD) {
        pass_tw<false>(p.r(0), n, p.s_lo(0), tb.wf, q,
                       StagedTwistLd{stage, tb.psi, q}, SmemSt{work});
      } else {
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          work[hades::sidx(i)] = (uint32_t)stage[i];
      }
      __syncthreads();
      if (it + step < items) {
        stage_row(stage, x + (it + step) * n, n);
        cp_async_commit();
      }
    } else {
      if (FWD) {
        pass_tw<false>(p.r(0), n, p.s_lo(0), tb.wf, q,
                       TwistLd{x + it * n, tb.psi, q}, SmemSt{work});
      } else {
        const int64_t* src = x + it * n;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          work[hades::sidx(i)] = (uint32_t)src[i];
      }
      __syncthreads();
    }
    if (FWD) {
      for (int i = 1; i < p.passes; ++i) {
        pass_tw<false>(p.r(i), n, p.s_lo(i), tb.wf, q, SmemLd{work},
                       SmemSt{work});
        __syncthreads();
      }
      store_pairs(out + it * n, work, n);
    } else {
      for (int i = p.passes - 1; i >= 1; --i) {
        pass_tw<true>(p.r(i), n, p.s_lo(i), tb.wi, q, SmemLd{work},
                      SmemSt{work});
        __syncthreads();
      }
      pass_tw<true>(p.r(0), n, p.s_lo(0), tb.wi, q, SmemLd{work},
                    TwistSt{out + it * n, tb.psi_inv, q});
    }
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

constexpr int kMaxCards = 64;

static int current_card() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// Once per card and kernel (`done`, one array per kernel): the dynamic
// shared-memory opt-in up to the card's limit, an attribute of the
// kernel on the current card.
template <typename Kernel>
static cudaError_t prepare_kernel(Kernel kernel, bool (&done)[kMaxCards]) {
  const int card = current_card();
  if (card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
  if (done[card]) return cudaSuccess;
  int limit = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, card);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess) done[card] = true;
  return e;
}

static cudaLaunchConfig_t cluster_config(long long batch, int K, int n,
                                         int C, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  const int nc = n / C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * C), (unsigned)K, 1);
  cfg.blockDim = dim3(threads_for(nc), 1, 1);
  cfg.dynamicSmemBytes = (size_t)hades::smem_words(nc) * sizeof(uint32_t);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool FWD>
static int launch_cluster(const void* x, void* out, long long batch,
                          const void* tables, const void* qs, int K, int n,
                          cudaStream_t stream) {
  static bool done[kMaxCards] = {};
  if (n / kCluster < kMinBlock) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare_kernel(ntt_br_cluster<FWD, kCluster>, done);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(batch, K, n, kCluster, stream, attr);
  e = cudaLaunchKernelEx(&cfg, ntt_br_cluster<FWD, kCluster>,
                         (const int64_t*)x, (int64_t*)out,
                         (const uint2*)tables, (const int64_t*)qs, K, n,
                         hades::log2_pow2(n));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The wide form's grid: as many blocks as the card holds at once, at
// most one per item.  Blocks a SM and SMs are read once per card.
template <bool FWD, bool STAGED>
static int launch_wide(const void* x, void* out, long long batch,
                       const void* tables, const void* qs, int K, int n,
                       cudaStream_t stream) {
  static int per_sm[kMaxCards][17] = {};
  static int sms[kMaxCards] = {};
  static bool done[kMaxCards] = {};
  const size_t smem = wide_smem(n, STAGED);
  cudaError_t e = prepare_kernel(ntt_br_wide<FWD, STAGED>, done);
  if (e != cudaSuccess) return (int)e;
  const int card = current_card();
  const int log_n = hades::log2_pow2(n);
  const int threads = threads_for(n);
  if (per_sm[card][log_n] == 0) {
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, ntt_br_wide<FWD, STAGED>, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (nb < 1) return (int)cudaErrorInvalidConfiguration;
    e = cudaDeviceGetAttribute(&sms[card], cudaDevAttrMultiProcessorCount,
                               card);
    if (e != cudaSuccess) return (int)e;
    per_sm[card][log_n] = nb;
  }
  const long long items = batch * K;
  const long long resident = (long long)per_sm[card][log_n] * sms[card];
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  ntt_br_wide<FWD, STAGED><<<grid, threads, smem, stream>>>(
      (const int64_t*)x, (int64_t*)out, (const uint2*)tables,
      (const int64_t*)qs, K, n, log_n, items);
  return (int)cudaGetLastError();
}

template <bool FWD>
static int launch_ntt_br(const void* x, void* out, long long batch,
                         const void* tables, const void* qs, int K, int n,
                         int cluster, int depth, cudaStream_t s) {
  if (cluster == 0) {
    switch (depth) {
      case 0:
        return launch_wide<FWD, false>(x, out, batch, tables, qs, K, n, s);
      case 1:
        return launch_wide<FWD, true>(x, out, batch, tables, qs, K, n, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (cluster != kCluster || depth != 0) return (int)cudaErrorInvalidValue;
  return launch_cluster<FWD>(x, out, batch, tables, qs, K, n, s);
}

// x, out: [batch, K, n] contiguous int64, x 16-byte aligned; fwd != 0 is
// the forward direction.  The plan: cluster kCluster with depth 0 (the
// narrow form, n / kCluster >= kMinBlock), or cluster 0 with depth D in
// {0, 1} (the wide form, D rows staged ahead a block; its shared memory
// must fit the card).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int hades_ntt_br(const void* x, void* out, long long batch,
                            const void* tables, const void* qs, int K, int n,
                            int fwd, int cluster, int depth, void* stream) {
  if (batch == 0) return 0;
  if (!n_supported(n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return fwd ? launch_ntt_br<true>(x, out, batch, tables, qs, K, n,
                                   cluster, depth, s)
             : launch_ntt_br<false>(x, out, batch, tables, qs, K, n,
                                    cluster, depth, s);
}
