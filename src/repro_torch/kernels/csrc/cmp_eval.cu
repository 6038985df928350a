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
// mod q, against the reversed coefficient-domain gadget CEK (`cek_rev`),
// and runs that dot product on the tensor cores as an integer matrix
// product (kernels/cmp_eval.py, "the byte-split form"):
//
//   A [lanes x words]  the digits of d1, 4 bytes to a 32-bit word: at
//                      log_b = 8 the residue d1 itself is its word;
//   B [words x 8]      cek_rev split into bytes, column (k, b) = byte b of
//                      the residue meeting tower k (KeySet.cek_rev_bytes,
//                      made once per key set, in fragment order);
//   C [lanes x 8]      s32 sums, flushed every 4,096 words (16,384 terms
//                      of at most 255 x 255) into 32-bit sums mod q_k, and
//                      recombined at the end: Σ_b C[., (k, b)] 2^(8b) mod q_k.
//
// with mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32.  The result is
// byte-identical to the reference's NTT form.
//
// Bound on this card: bytes.  The product is lanes x 32,768 x 8 u8 MACs
// per lane at paper-bfv (0.04 ms over 8 x 16,384 lanes at the 1,979 TOPS
// dense INT8 rate); reading the tile's c1 once (64 KB a row) takes longer.
// What it costs besides is forming the digits: one modular difference per
// (lane, coefficient).  Design: a block is 16 rows (one m16 tile) x a
// chunk of up to 8 atoms, run by 4 warps that each sum every 4th group of
// 32 words and meet in shared memory at the end.  A thread loads its 8 c1
// coefficients of a group once (the 4 threads of an mma group read 64
// contiguous bytes), one group ahead of use, and forms every atom's
// differences and words from them in registers; the B fragments of a
// group are read once from shared memory and reused for every atom.  B
// (8 KB a chunk of 8 groups) and, with one bound per atom, the atoms'
// bounds for the chunk are staged through shared memory by cp.async,
// double-buffered: without that the bounds' reads through L1 took half
// the time.  B's L2 traffic is 256 KB per 16 rows.  The row tile is
// addressed by pointer offset into the table's column (no tile copy).
#include <cuda_runtime.h>

#include "modarith.cuh"

using hades::addmod;
using hades::barrett_m;
using hades::mulmod;
using hades::recombine_bytes;
using hades::reduce;
using hades::submod;

constexpr int kThreads = 256;         // the paper kernel's block

constexpr int kEvalWarps = 4;
// warps sharing one m16 tile, each summing every kSplit-th group: of 1, 2
// and 4, the fastest over the served tiles and the per-lane layout on the
// H100 (PERF.md)
constexpr int kSplit = 4;
constexpr int kEvalRows = 16 * kEvalWarps / kSplit;   // rows per block
constexpr int kGroupU32 = 256;        // one group of B: 4 steps x 32 lanes x 2
constexpr int kChunkGroups = 8;       // groups per staged chunk (8 KB)
constexpr int kFlushGroups = 128;     // 4,096 words = 16,384 terms per s32 run
static_assert(kEvalWarps % kSplit == 0 && kChunkGroups % kSplit == 0,
              "a tile's warps split each chunk's groups evenly");
static_assert((kEvalWarps - kEvalWarps / kSplit) * 8 * 4 * 32 <=
                  2 * kChunkGroups * kGroupU32,
              "the warps of a tile meet in the B buffers");

__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// The thread's CPT coefficients of a group, c_j = 8 (j >> 1) + 2 tig +
// (j & 1) from p (at 2 tig, 16-byte aligned), as uint32: the 4 threads of
// an mma group read 64 contiguous bytes per load.  Device or shared memory.
template <int CPT>
__device__ __forceinline__ void load_coeffs(uint32_t (&x)[CPT],
                                            const int64_t* p) {
#pragma unroll
  for (int i = 0; i < CPT / 2; ++i) {
    const longlong2 t = *reinterpret_cast<const longlong2*>(p + 8 * i);
    x[2 * i] = (uint32_t)t.x;
    x[2 * i + 1] = (uint32_t)t.y;
  }
}

// Word w of a coefficient: its digits 4w .. 4w+3, one byte each.  WPC = 1
// only at log_b = 8 with at most 4 digits: the residue d is its own word.
template <int WPC>
__device__ __forceinline__ uint32_t word_of(uint32_t d, int w, int log_b,
                                            int D, uint32_t mask) {
  if (WPC == 1) return d;
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * w + j;
    if (t < D) r |= ((d >> (t * log_b)) & mask) << (8 * j);
  }
  return r;
}

template <int K, int ACH, int WPC>
__global__ void __launch_bounds__(32 * kEvalWarps) eval_gadget_kernel(
    const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
    const int64_t* __restrict__ bc0, const int64_t* __restrict__ bc1,
    int64_t b_astride, int64_t b_rstride,
    const uint32_t* __restrict__ cekb, const int64_t* __restrict__ qs,
    int64_t scale, int64_t* __restrict__ out, int A, int rows, int n, int D,
    int log_b) {
  constexpr int CPT = 8 / WPC;        // coefficients per thread and group
  constexpr int CPG = 32 / WPC;       // coefficients per group
  constexpr int CC = kChunkGroups * CPG;   // coefficients per chunk
  // B chunks, then (per-atom bounds) each atom's chunk of int64 bounds
  extern __shared__ __align__(16) uint32_t smem[];
  auto bsm = [&](int buf) { return smem + buf * kChunkGroups * kGroupU32; };
  int64_t* bnd = reinterpret_cast<int64_t*>(smem + 2 * kChunkGroups *
                                            kGroupU32);
  const bool per_lane = b_rstride != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int part = warp % kSplit;     // this warp's share of the groups
  const int a0 = blockIdx.y * ACH;
  const int na = A - a0 < ACH ? A - a0 : ACH;
  const int rw = blockIdx.x * kEvalRows + (warp / kSplit) * 16;
  const int r_lo = min(rw + g, rows - 1), r_hi = min(rw + g + 8, rows - 1);
  const int64_t kn = (int64_t)K * n;
  const uint32_t mask = (1u << log_b) - 1u;
  // the thread's C columns are (k, b) = (tig / 2, 2 (tig % 2) + {0, 1})
  const int kc = (tig >> 1) < K ? (tig >> 1) : K - 1;
  const uint32_t qc = (uint32_t)qs[kc];
  const uint64_t mc = barrett_m(qc);
  uint32_t qsrc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) qsrc[k] = (uint32_t)qs[k];

  int acc[ACH][4];
  uint32_t red[ACH][4];
#pragma unroll
  for (int a = 0; a < ACH; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0, red[a][c] = 0;
  auto flush = [&]() {
#pragma unroll
    for (int a = 0; a < ACH; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[a][c] = reduce((uint64_t)red[a][c] + (uint32_t)acc[a][c], qc, mc);
        acc[a][c] = 0;
      }
  };

  // group G covers coefficients [G CPG, (G + 1) CPG) of the [K n] row
  const int ngroups = K * n / CPG;
  const int nchunks = (ngroups + kChunkGroups - 1) / kChunkGroups;
  auto stage = [&](int buf, int ch) {
    const int g0 = ch * kChunkGroups;
    const int ng = min(kChunkGroups, ngroups - g0);
    const uint4* src = reinterpret_cast<const uint4*>(cekb) +
                       (int64_t)g0 * (kGroupU32 / 4);
    uint4* dst = reinterpret_cast<uint4*>(bsm(buf));
    for (int i = threadIdx.x; i < ng * (kGroupU32 / 4); i += blockDim.x)
      cp_async16(dst + i, src + i);
    if (!per_lane) {
      const int pairs = ng * CPG / 2;
      for (int i = threadIdx.x; i < na * pairs; i += blockDim.x) {
        const int a = i / pairs, c = 2 * (i - a * pairs);
        cp_async16(bnd + (buf * ACH + a) * CC + c,
                   bc1 + (a0 + a) * b_astride + (int64_t)g0 * CPG + c);
      }
    }
    cp_async_commit();
  };

  // c1 of the next group is loaded while this one computes
  uint32_t xl[CPT], xh[CPT];
  if (part < ngroups) {
    load_coeffs(xl, c1 + r_lo * kn + part * CPG + 2 * tig);
    load_coeffs(xh, c1 + r_hi * kn + part * CPG + 2 * tig);
  }
  stage(0, 0);
  int since_flush = 0;
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage((ch + 1) & 1, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* bchunk = bsm(ch & 1);
    const int64_t* bchunk_bnd = bnd + (ch & 1) * ACH * CC;
    const int ng = min(kChunkGroups, ngroups - ch * kChunkGroups);
    for (int gg = part; gg < ng; gg += kSplit) {
      const int G = ch * kChunkGroups + gg;
      const uint32_t q = K == 1 ? qsrc[0] : qsrc[G * CPG >= n ? 1 : 0];
      const int64_t coef = (int64_t)G * CPG + 2 * tig;
      uint32_t nxl[CPT], nxh[CPT];
      if (G + kSplit < ngroups) {
        load_coeffs(nxl, c1 + r_lo * kn + coef + kSplit * CPG);
        load_coeffs(nxh, c1 + r_hi * kn + coef + kSplit * CPG);
      }
      uint2 bf[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        bf[t] = *reinterpret_cast<const uint2*>(bchunk + gg * kGroupU32 +
                                                t * 64 + lane * 2);
#pragma unroll
      for (int a = 0; a < ACH; ++a) {
        if (a >= na) break;
        uint32_t yl[CPT], yh[CPT];
        if (per_lane) {
          const int64_t* bp = bc1 + (a0 + a) * b_astride + coef;
          load_coeffs(yl, bp + r_lo * b_rstride);
          load_coeffs(yh, bp + r_hi * b_rstride);
        } else {
          load_coeffs(yl, bchunk_bnd + a * CC + gg * CPG + 2 * tig);
#pragma unroll
          for (int i = 0; i < CPT; ++i) yh[i] = yl[i];
        }
        uint32_t wl[8], wh[8];
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const uint32_t dl = submod(xl[i], yl[i], q);
          const uint32_t dh = submod(xh[i], yh[i], q);
#pragma unroll
          for (int w = 0; w < WPC; ++w) {
            wl[i * WPC + w] = word_of<WPC>(dl, w, log_b, D, mask);
            wh[i * WPC + w] = word_of<WPC>(dh, w, log_b, D, mask);
          }
        }
        // step t: this thread's words 2t and 2t+1 are the step's words
        // tig and 4 + tig (rows g and g + 8), as the B fragments are
#pragma unroll
        for (int t = 0; t < 4; ++t)
          mma_u8(acc[a], wl[2 * t], wh[2 * t], wl[2 * t + 1], wh[2 * t + 1],
                 bf[t].x, bf[t].y);
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) xl[i] = nxl[i], xh[i] = nxh[i];
      if (++since_flush == kFlushGroups) {
        flush();
        since_flush = 0;
      }
    }
    __syncthreads();
  }
  flush();

  // the kSplit warps of a tile meet in shared memory (the B buffers are
  // free now): part 0 adds the others' sums mod q
  uint32_t* meet = smem;
  const int tile = warp / kSplit;
  if (part != 0) {
#pragma unroll
    for (int a = 0; a < ACH; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        meet[(((tile * (kSplit - 1) + part - 1) * ACH + a) * 4 + c) * 32 +
             lane] = red[a][c];
  }
  __syncthreads();
  if (part != 0) return;
  for (int p = 1; p < kSplit; ++p)
#pragma unroll
    for (int a = 0; a < ACH; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[a][c] = addmod(
            red[a][c],
            meet[(((tile * (kSplit - 1) + p - 1) * ACH + a) * 4 + c) * 32 +
                 lane],
            qc);

  // column (k, b) pairs: tig even holds b = 0, 1 of tower tig / 2, its odd
  // neighbour b = 2, 3; C rows g (red[.][0..1]) and g + 8 (red[.][2..3])
#pragma unroll
  for (int a = 0; a < ACH; ++a) {
    uint32_t nb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      nb[c] = __shfl_down_sync(0xffffffffu, red[a][c], 1);
    if (a >= na || (tig & 1) || (tig >> 1) >= K) continue;
    const int k = tig >> 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + g + 8 * h;
      if (r >= rows) continue;
      const uint64_t cols[4] = {red[a][2 * h], red[a][2 * h + 1], nb[2 * h],
                                nb[2 * h + 1]};
      const uint32_t keyed = recombine_bytes(cols, qc, mc);
      const int64_t bo = (a0 + a) * b_astride + r * b_rstride + (int64_t)k * n;
      const uint32_t d0 =
          submod((uint32_t)c0[r * kn + (int64_t)k * n], (uint32_t)bc0[bo], qc);
      const uint32_t scaled =
          mulmod(d0, (uint32_t)((uint64_t)scale % qc), qc, mc);
      out[((int64_t)(a0 + a) * rows + r) * K + k] =
          (int64_t)addmod(scaled, keyed, qc);
    }
  }
}

template <int K, int ACH, int WPC>
static int launch(const void* c0, const void* c1, const void* bc0,
                  const void* bc1, long long b_astride, long long b_rstride,
                  const void* cekb, const void* qs, long long scale,
                  void* out, int A, int rows, int n, int D, int log_b,
                  cudaStream_t stream) {
  dim3 grid((unsigned)((rows + kEvalRows - 1) / kEvalRows),
            (unsigned)((A + ACH - 1) / ACH));
  // two B chunks (16 KB) and, with per-atom bounds, two of ACH atoms'
  // bounds (at most 32 KB): within the 48 KB a block gets unasked
  const size_t smem = 2 * kChunkGroups * kGroupU32 * sizeof(uint32_t) +
                      (b_rstride == 0 ? 2 * ACH * kChunkGroups * (32 / WPC) *
                                            sizeof(int64_t)
                                      : 0);
  eval_gadget_kernel<K, ACH, WPC>
      <<<grid, 32 * kEvalWarps, smem, stream>>>(
          (const int64_t*)c0, (const int64_t*)c1, (const int64_t*)bc0,
          (const int64_t*)bc1, b_astride, b_rstride, (const uint32_t*)cekb,
          (const int64_t*)qs, scale, (int64_t*)out, A, rows, n, D, log_b);
  return (int)cudaGetLastError();
}

template <int K, int WPC>
static int launch_a(const void* c0, const void* c1, const void* bc0,
                    const void* bc1, long long b_astride, long long b_rstride,
                    const void* cekb, const void* qs, long long scale,
                    void* out, int A, int rows, int n, int D, int log_b,
                    cudaStream_t stream) {
#define HADES_EVAL_LAUNCH(ach)                                             \
  return launch<K, ach, WPC>(c0, c1, bc0, bc1, b_astride, b_rstride, cekb, \
                             qs, scale, out, A, rows, n, D, log_b, stream)
  if (A == 1) HADES_EVAL_LAUNCH(1);
  if (A == 2) HADES_EVAL_LAUNCH(2);
  if (A <= 4) HADES_EVAL_LAUNCH(4);
  HADES_EVAL_LAUNCH(8);
#undef HADES_EVAL_LAUNCH
}

// c0/c1: the tile's first row of one column, rows of K*n contiguous int64
// (c1 16-byte aligned).  bc0/bc1: bounds, lane (a, r) at a*b_astride +
// r*b_rstride (elements; bc1 16-byte aligned).  cekb: KeySet.cek_rev_bytes.
// out: [A, rows, K] int64 residues.  K must be 1 or 2, log_b at most 8 and
// D at most 8 (two words a coefficient; one when log_b = 8).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hades_eval_gadget(
    const void* c0, const void* c1, const void* bc0, const void* bc1,
    long long b_astride, long long b_rstride, const void* cekb,
    const void* qs, long long scale, void* out, int A, int rows, int K,
    int n, int D, int log_b, void* stream) {
  if (A == 0 || rows == 0) return 0;
  if (log_b < 1 || log_b > 8 || D < 1 || D > 8 || n % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define HADES_EVAL_K(k, wpc)                                                  \
  return launch_a<k, wpc>(c0, c1, bc0, bc1, b_astride, b_rstride, cekb, qs, \
                          scale, out, A, rows, n, D, log_b, s)
  const bool one = log_b == 8 && D <= 4;   // kernels/cmp_eval.py: WPC
  if (K == 1) {
    if (one) HADES_EVAL_K(1, 1);
    HADES_EVAL_K(1, 2);
  }
  if (K == 2) {
    if (one) HADES_EVAL_K(2, 1);
    HADES_EVAL_K(2, 2);
  }
#undef HADES_EVAL_K
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
