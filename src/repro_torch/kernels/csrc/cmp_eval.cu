// HADES Eval, coefficient 0: the gadget-mode kernel for every (atom, row)
// lane of a scan tile, and the paper-mode kernels (further below) for
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "modarith.cuh"

using hades::addmod;
using hades::barrett_m;
using hades::mulmod;
using hades::recombine_bytes;
using hades::reduce;
using hades::submod;

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
// 31 x 31-bit, so each is Barrett-reduced before it is summed; a - b is
// formed in registers as a + q - b (no difference tensor, no signed %).
// Sums: at most n reduced terms, each below 2^31, meet in one (lane,
// tower) sum, so every partial and the cluster's total stay below
// n * 2^31 <= 2^45 at n = 16,384: uint64 holds them exactly, and one
// more reduction ends the lane.
//
// Bound on this card: bytes.  A lane reads its K*n int64 words of c1 (64
// KB at paper-bfv), one coefficient of c0 per tower and, in the lane form,
// as much of b (nothing new when b has batch stride 0), against K*n
// reduced multiply-adds: far below the integer rate per byte.  The paths
// launch it at two very different sizes, and it has one design for each:
//
// * Small lane sets (probe steps and merges of 1-8,191 lanes).  A few
//   lanes cannot fill 132 SMs with a block each, and one block walking a
//   lane's 2 x 4,096 coefficients waits on one dependent memory round trip
//   after another.  So each (lane, tower) dot product is split over the S
//   blocks of a thread-block cluster (S = 1, 2, 4 or 8, the portable
//   sizes; the smallest with lanes x K x S >= two waves of blocks, S = 1
//   once lanes x K fills them), towers on the grid.  A thread issues its
//   share's 16-byte loads (two coefficients of a, b and rev(cek) each)
//   in chunks of kPaperChunk = 8 vectors, every load of a chunk before
//   the chunk's first multiply, the trip count a compile-time constant
//   (one instance per profile n): one chunk when S >= 2 at n <= 4,096,
//   2 at n = 4,096 with S = 1, 8 at n = 16,384 with S = 1; rank 0's first thread loads
//   coefficient 0 of a and b at block start.  A block sums its n/S terms
//   in warp shuffles and shared memory; each block stores its partial
//   into rank 0's shared memory (distributed shared memory), the cluster
//   meets at one barrier, and rank 0 adds scale * d0 and writes the
//   residue: one launch, no global atomics.
// * Wide lane sets (>= 8,192 lanes: sort stages, merges, column passes).
//   Reading rev(cek) through L2 for every lane doubles the L2 traffic of
//   a column pass.  So a block stages one tower of rev(cek) in shared
//   memory once (cp.async; n int64, 32 KB at n = 4,096) and its warps
//   then walk lanes, one lane per warp at a time, streaming the lane's a
//   (and b) in chunks of 16 (8 each with b) 16-byte loads per thread,
//   each chunk's loads issued while the chunk before it is summed; the
//   lane's sum meets in warp shuffles, with no block barrier.  The grid is one
//   resident wave (a power of two of blocks per tower, so power-of-two
//   lane counts split evenly over the warps).

namespace cg = cooperative_groups;

constexpr int kPaperMaxCluster = 8;      // portable cluster sizes only
constexpr int kPaperWideLanes = 8192;    // lanes from which the wide form runs
constexpr int kPaperWideWarps = 8;
constexpr int kPaperChunk = 8;           // 16-byte loads per array in flight
// the wide form's loads in flight per thread: a chunk of a (and of b),
// issued one chunk ahead of its arithmetic; the fastest of the chunk
// sizes tried on the H100 (PERF.md)
constexpr int kPaperWideChunkA = 16;
constexpr int kPaperWideChunkAB = 8;

struct PaperArgs {
  const int64_t* a0;
  const int64_t* a1;
  const int64_t* b0;
  const int64_t* b1;
  const int64_t* cek_rev;
  const int64_t* qs;
  int64_t sa0, sa1, sb0, sb1;            // lane strides (elements)
  int64_t scale;
  int64_t* out;
  int64_t lanes;
};

// threads of a split block: n / (2 S) vectors of 2 coefficients per
// block, one per thread up to 128 threads, at least one warp
__host__ __device__ constexpr int split_threads(int n, int S) {
  return n / (2 * S) < 32 ? 32 : (n / (2 * S) > 128 ? 128 : n / (2 * S));
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// the Barrett-reduced terms of one 16-byte vector (two coefficients)
template <bool HAS_B>
__device__ __forceinline__ uint64_t vec_terms(longlong2 x, longlong2 y,
                                              longlong2 w, uint32_t q,
                                              uint64_t m) {
  const uint32_t dx = HAS_B ? submod((uint32_t)x.x, (uint32_t)y.x, q)
                            : (uint32_t)x.x;
  const uint32_t dy = HAS_B ? submod((uint32_t)x.y, (uint32_t)y.y, q)
                            : (uint32_t)x.y;
  return (uint64_t)mulmod(dx, (uint32_t)w.x, q, m) +
         mulmod(dy, (uint32_t)w.y, q, m);
}

// scale * d0 + sum, mod q: the lane's residue
template <bool HAS_B>
__device__ __forceinline__ int64_t finish(uint32_t x0, uint32_t y0,
                                          uint64_t sum, int64_t scale,
                                          uint32_t q, uint64_t m) {
  const uint32_t d0 = HAS_B ? submod(x0, y0, q) : x0;
  const uint32_t scaled = mulmod(d0, (uint32_t)((uint64_t)scale % q), q, m);
  return (int64_t)reduce((uint64_t)scaled + reduce(sum, q, m), q, m);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid (lanes * S, K), clusters of (S, 1, 1): block (r * S + rank, k) sums
// the coefficients [rank n/S, (rank + 1) n/S) of lane r, tower k.
template <int N, int S, bool HAS_B>
__global__ void __launch_bounds__(split_threads(N, S))
    eval_paper_split(const PaperArgs p) {
  constexpr int T = split_threads(N, S);
  constexpr int P = N / (2 * S * T);        // vectors per thread and array
  constexpr int CH = P < kPaperChunk ? P : kPaperChunk;
  static_assert(P >= 1 && P % CH == 0, "whole chunks of whole vectors");
  __shared__ uint64_t wsum[T / 32];
  __shared__ uint64_t part[S];
  // every block of the cluster has started once this barrier completes;
  // it is waited on only before the partials cross blocks
  if constexpr (S > 1) cluster_arrive_relaxed();
  const int rank = (int)(blockIdx.x % S);
  const int64_t r = blockIdx.x / S;
  const int k = blockIdx.y;
  const bool head = rank == 0 && threadIdx.x == 0;
  uint32_t x0 = 0, y0 = 0;
  if (head) {
    x0 = (uint32_t)p.a0[r * p.sa0 + (int64_t)k * N];
    if (HAS_B) y0 = (uint32_t)p.b0[r * p.sb0 + (int64_t)k * N];
  }
  const uint32_t q = (uint32_t)p.qs[k];
  const uint64_t m = barrett_m(q);
  const int64_t first = rank * (N / (2 * S)) + threadIdx.x;   // vector
  const longlong2* x =
      reinterpret_cast<const longlong2*>(p.a1 + r * p.sa1 + (int64_t)k * N) +
      first;
  const longlong2* y =
      HAS_B ? reinterpret_cast<const longlong2*>(p.b1 + r * p.sb1 +
                                                 (int64_t)k * N) + first
            : nullptr;
  const longlong2* w =
      reinterpret_cast<const longlong2*>(p.cek_rev + (int64_t)k * N) + first;
  uint64_t acc = 0;
#pragma unroll
  for (int c = 0; c < P / CH; ++c) {
    longlong2 xv[CH], yv[CH], wv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int v = (c * CH + j) * T;
      xv[j] = __ldg(x + v);
      if (HAS_B) yv[j] = __ldg(y + v);
      wv[j] = __ldg(w + v);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
      acc += vec_terms<HAS_B>(xv[j], HAS_B ? yv[j] : xv[j], wv[j], q, m);
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = acc;
  __syncthreads();
  uint64_t block = 0;
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < T / 32; ++i) block += wsum[i];
  if constexpr (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    if (threadIdx.x == 0) *cluster.map_shared_rank(&part[rank], 0) = block;
    cluster.sync();                 // release the stores, acquire them
    if (!head) return;
    block = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) block += part[i];
  } else if (!head) {
    return;
  }
  p.out[r * gridDim.y + k] = finish<HAS_B>(x0, y0, block, p.scale, q, m);
}

// grid (G, K), blocks of kPaperWideWarps warps; dynamic shared memory: N
// int64, tower k of rev(cek).  Warp w of block g takes lanes g W + w,
// (g + G) W + w, ...
template <int N, bool HAS_B>
__global__ void __launch_bounds__(32 * kPaperWideWarps)
    eval_paper_wide(const PaperArgs p) {
  constexpr int V = N / 64;                 // vectors per thread and lane
  constexpr int CW = HAS_B ? kPaperWideChunkAB : kPaperWideChunkA;
  constexpr int CH = V < CW ? V : CW;
  static_assert(V % CH == 0, "whole chunks");
  extern __shared__ __align__(16) int64_t cek_s[];
  const int k = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t* ck = p.cek_rev + (int64_t)k * N;
  for (int i = threadIdx.x; i < N / 2; i += blockDim.x)
    cp_async16(cek_s + 2 * i, ck + 2 * i);
  cp_async_commit();
  const uint32_t q = (uint32_t)p.qs[k];
  const uint64_t m = barrett_m(q);
  cp_async_wait<0>();
  __syncthreads();
  const longlong2* w = reinterpret_cast<const longlong2*>(cek_s) + lane;
  const int64_t step = (int64_t)gridDim.x * kPaperWideWarps;
  int64_t r = (int64_t)blockIdx.x * kPaperWideWarps + warp;
  if (r >= p.lanes) return;
  const longlong2* a1 = reinterpret_cast<const longlong2*>(p.a1) + lane;
  const longlong2* b1 =
      HAS_B ? reinterpret_cast<const longlong2*>(p.b1) + lane : nullptr;
  // chunk c of lane r: its CH vectors of a (and b) per thread
  auto load = [&](int64_t rr, int c, longlong2 (&xs)[CH],
                  longlong2 (&ys)[CH]) {
    const int64_t xo = (rr * p.sa1 + (int64_t)k * N) / 2 + c * CH * 32;
    const int64_t yo = (rr * p.sb1 + (int64_t)k * N) / 2 + c * CH * 32;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      xs[j] = __ldg(a1 + xo + j * 32);
      if (HAS_B) ys[j] = __ldg(b1 + yo + j * 32);
    }
  };
  auto head = [&](int64_t rr, uint32_t& x0, uint32_t& y0) {
    if (lane == 0) {
      x0 = (uint32_t)p.a0[rr * p.sa0 + (int64_t)k * N];
      if (HAS_B) y0 = (uint32_t)p.b0[rr * p.sb0 + (int64_t)k * N];
    }
  };
  auto terms = [&](int c, const longlong2 (&xs)[CH],
                   const longlong2 (&ys)[CH]) {
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      s += vec_terms<HAS_B>(xs[j], HAS_B ? ys[j] : xs[j],
                            w[(c * CH + j) * 32], q, m);
    return s;
  };
  constexpr int NC = V / CH;                // chunks per lane
  uint32_t x0 = 0, y0 = 0;
  uint64_t acc = 0;
  longlong2 xv[CH], yv[CH];
  head(r, x0, y0);
  // the warp's chunks in order over its lanes, each chunk's loads
  // issued while the chunk before it is summed
  load(r, 0, xv, yv);
  for (int c = 0;;) {
    const int cn = c + 1 == NC ? 0 : c + 1;
    const int64_t rn = cn == 0 ? r + step : r;
    longlong2 xn[CH], yn[CH];
    if (rn < p.lanes) load(rn, cn, xn, yn);
    acc += terms(c, xv, yv);
    if (cn == 0) {
      acc = warp_sum(acc);
      if (lane == 0)
        p.out[r * gridDim.y + k] = finish<HAS_B>(x0, y0, acc, p.scale, q, m);
      if (rn >= p.lanes) break;
      acc = 0;
      head(rn, x0, y0);
    }
    r = rn;
    c = cn;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      xv[j] = xn[j];
      if (HAS_B) yv[j] = yn[j];
    }
  }
}

// What the launches below ask of a card is kept per card: an entry
// launches on the thread's current device (the wrappers make it the
// operands' card), and one process may launch on several cards.
constexpr int kMaxCards = 64;

static int current_card() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// SMs of the current card (0 beyond kMaxCards, where launch_wide refuses)
static int sm_count() {
  static int sms[kMaxCards] = {};
  const int card = current_card();
  if (card < 0 || card >= kMaxCards) return 0;
  if (sms[card] == 0)
    cudaDeviceGetAttribute(&sms[card], cudaDevAttrMultiProcessorCount,
                           card);
  return sms[card];
}

template <int N, int S, bool HAS_B>
static int launch_split(const PaperArgs& p, int K, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.lanes * S), (unsigned)K, 1);
  cfg.blockDim = dim3(split_threads(N, S), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, eval_paper_split<N, S, HAS_B>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int N, bool HAS_B>
static int launch_wide(const PaperArgs& p, int K, cudaStream_t stream) {
  constexpr int threads = 32 * kPaperWideWarps;
  constexpr size_t smem = (size_t)N * sizeof(int64_t);
  // resident blocks per SM, once per card: the shared-memory opt-in is
  // an attribute of the kernel on the current card
  static int per_sm[kMaxCards] = {};
  const int card = current_card();
  if (card < 0 || card >= kMaxCards) return (int)cudaErrorInvalidDevice;
  if (per_sm[card] == 0) {
    cudaFuncSetAttribute(eval_paper_wide<N, HAS_B>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    int nb = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, eval_paper_wide<N, HAS_B>, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (nb < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm[card] = nb;
  }
  // one resident wave, a power of two of blocks per tower
  long long g = (long long)per_sm[card] * sm_count() / K;
  long long pow2 = 1;
  while (2 * pow2 <= g) pow2 *= 2;
  const long long need = (p.lanes + kPaperWideWarps - 1) / kPaperWideWarps;
  const unsigned G = (unsigned)(pow2 < need ? pow2 : need);
  eval_paper_wide<N, HAS_B><<<dim3(G, (unsigned)K), threads, smem, stream>>>(
      p);
  return (int)cudaGetLastError();
}

// the cluster size for a small lane set: the smallest S with lanes x K x S
// blocks filling two waves of the card, at most kPaperMaxCluster and at
// most n / 64 (a block keeps at least one vector per thread of a warp)
static int pick_split(long long lanes, int K, int n) {
  const long long units = lanes * K, want = 2LL * sm_count();
  int S = 1;
  while (2 * S <= kPaperMaxCluster && 2 * S <= n / 64 && units * S < want)
    S *= 2;
  return S;
}

template <int N, bool HAS_B>
static int launch_paper(const PaperArgs& p, int K, cudaStream_t stream) {
  if (p.lanes >= kPaperWideLanes) return launch_wide<N, HAS_B>(p, K, stream);
  switch (pick_split(p.lanes, K, N)) {
    case 1:
      return launch_split<N, 1, HAS_B>(p, K, stream);
    case 2:
      if constexpr (N / 64 >= 2) return launch_split<N, 2, HAS_B>(p, K, stream);
      break;
    case 4:
      if constexpr (N / 64 >= 4) return launch_split<N, 4, HAS_B>(p, K, stream);
      break;
    case 8:
      if constexpr (N / 64 >= 8) return launch_split<N, 8, HAS_B>(p, K, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <int N>
static int launch_paper_n(const PaperArgs& p, bool has_b, int K,
                          cudaStream_t stream) {
  return has_b ? launch_paper<N, true>(p, K, stream)
               : launch_paper<N, false>(p, K, stream);
}

// a0/a1: lane r's rows at r * sa0 / r * sa1 (elements), each K*n int64.
// b0/b1: the same for the subtracted side, or both null (column form);
// a stride of 0 repeats one polynomial for every lane.  cek_rev: [K, n].
// a1, b1 and cek_rev start on 16-byte boundaries and sa1, sb1 are even
// (the kernels read them 16 bytes at a time).  n is one of the profiles'
// ring degrees: 256, 512, 1,024, 4,096 or 16,384.  out: [lanes, K] int64
// residues.  Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for operands outside this contract.
extern "C" int hades_eval_paper(
    const void* a0, long long sa0, const void* a1, long long sa1,
    const void* b0, long long sb0, const void* b1, long long sb1,
    const void* cek_rev, const void* qs, long long scale, void* out,
    long long lanes, int K, int n, void* stream) {
  if (lanes == 0) return 0;
  const bool has_b = b0 != nullptr && b1 != nullptr;
  if ((b0 == nullptr) != (b1 == nullptr) || K < 1 || K > 65535 ||
      lanes < 0 || lanes > 0x7fffffffLL / kPaperMaxCluster)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)a1 | (uintptr_t)cek_rev |
                          (has_b ? (uintptr_t)b1 : 0);
  if ((align & 15) || ((sa1 | (has_b ? sb1 : 0)) & 1))
    return (int)cudaErrorInvalidValue;
  const PaperArgs p = {(const int64_t*)a0, (const int64_t*)a1,
                       (const int64_t*)b0, (const int64_t*)b1,
                       (const int64_t*)cek_rev, (const int64_t*)qs,
                       sa0, sa1, sb0, sb1, scale, (int64_t*)out, lanes};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 256: return launch_paper_n<256>(p, has_b, K, s);
    case 512: return launch_paper_n<512>(p, has_b, K, s);
    case 1024: return launch_paper_n<1024>(p, has_b, K, s);
    case 4096: return launch_paper_n<4096>(p, has_b, K, s);
    case 16384: return launch_paper_n<16384>(p, has_b, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the lane count from which hades_eval_paper runs its wide form
extern "C" int hades_paper_wide_lanes() { return kPaperWideLanes; }

// ---------------------------------------------------------------------------
// The launch floor: an empty kernel behind the same C interface, in the
// same library.  kernels/timing.py launches it through ctypes exactly as
// the wrappers launch the Evals, so its device time (back to back in a
// CUDA graph) and its host time bound from below what any small launch of
// the port costs.  No path launches it.

__global__ void empty_kernel() {}

extern "C" int hades_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
