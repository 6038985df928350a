// The cluster split of ntt_br's narrow form: a length-n transform spread
// over the C blocks of a thread-block cluster.
//
// Block r holds the contiguous block [r nc, (r+1) nc), nc = n / C.  The
// log2 C stages whose stride is at least nc pair indices that differ by a
// multiple of nc, so they fall apart into nc independent groups: group j
// is the C indices j + m nc (m = 0 .. C-1), one in each block, at local
// index j.  These stages are the cross pass.  The other log2 nc stages
// stay inside one block, and there a stage of stride h < nc indexes its
// twiddle by the global index mod h, which equals the local index mod h
// because the block's offset r nc is a multiple of h: the local stages
// are the whole-polynomial schedule (ntt_stages.cuh) on nc coefficients,
// with the same twiddle tables.
//
//   forward:  cross pass (psi twist, DIF stages log_n-1 .. log_nc, each
//             value to its block), then each block's local DIF stages;
//   inverse:  each block's local DIT stages, then the cross pass (DIT
//             stages log_nc .. log_n-1, the psi^-1 n^-1 twist, out).
//
// Block r runs the groups [r nc / C, (r+1) nc / C) of the cross pass.
//
// The functions are __host__ __device__, as in modarith.cuh, so a host
// build runs the same split over C blocks in turn against the plain
// version.  cross_dif and cross_dit are the butterflies of dif_regs and
// dit_regs (ntt_stages.cuh) at s_lo = log_nc, with the twiddle read
// through load_pair so that they also build for the host.
#pragma once

#include "modarith.cuh"

namespace hades {

#ifdef __CUDACC__
using pair32 = uint2;
#else
struct pair32 {
  uint32_t x, y;
};
#endif

// A fixed operand's Shoup pair {w, w'}, through the read-only cache on
// the card.
HADES_HD pair32 load_pair(const pair32* p, int i) {
#ifdef __CUDA_ARCH__
  return __ldg(p + i);
#else
  return p[i];
#endif
}

HADES_HD uint32_t load_residue(const int64_t* x, int i) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__ldg(reinterpret_cast<const long long*>(x) + i);
#else
  return (uint32_t)x[i];
#endif
}

template <int C>
struct CrossLog2 {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8 || C == 16,
                "cluster sizes 1, 2, 4, 8 and 16");
  static constexpr int value = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2
                               : C == 8 ? 3 : 4;
};

// The index map of a split over C blocks of 2^log_nc coefficients.
struct Split {
  int C, log_nc;
  HADES_HD int nc() const { return 1 << log_nc; }
  // global index of local index j in block m
  HADES_HD int global(int m, int j) const { return (m << log_nc) + j; }
  HADES_HD int block_of(int i) const { return i >> log_nc; }
  HADES_HD int local_of(int i) const { return i & (nc() - 1); }
  // the cross-pass groups block r runs: [group_begin(r), group_begin(r+1))
  HADES_HD int group_begin(int r) const {
    return (int)(((int64_t)r << log_nc) / C);
  }
};

// DIF stages log_nc + log2 C - 1 .. log_nc on group j (v[m] at j + m nc).
template <int C>
HADES_HD void cross_dif(uint32_t (&v)[C], int j, int log_nc,
                        const pair32* w, uint32_t q) {
  constexpr int R = CrossLog2<C>::value;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int bb = R - 1 - r;
    const int h = 1 << (log_nc + bb);
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (m & (1 << bb)) continue;
      const int m2 = m | (1 << bb);
      const pair32 t = load_pair(w, h + ((j + (m << log_nc)) & (h - 1)));
      const uint32_t a = v[m], b = v[m2];
      v[m] = addmod(a, b, q);
      v[m2] = mul_shoup(a + q - b, t.x, t.y, q);
    }
  }
}

// DIT stages log_nc .. log_nc + log2 C - 1 on group j.
template <int C>
HADES_HD void cross_dit(uint32_t (&v)[C], int j, int log_nc,
                        const pair32* w, uint32_t q) {
  constexpr int R = CrossLog2<C>::value;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = 1 << (log_nc + r);
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (m & (1 << r)) continue;
      const int m2 = m | (1 << r);
      const pair32 t = load_pair(w, h + ((j + (m << log_nc)) & (h - 1)));
      const uint32_t u = v[m];
      const uint32_t tv = mul_shoup(v[m2], t.x, t.y, q);
      v[m] = addmod(u, tv, q);
      v[m2] = submod(u, tv, q);
    }
  }
}

// The forward cross pass of group j: x's C coefficients of the group
// (natural order) times psi^i, then the DIF stages of stride >= nc.
// v[m] then belongs to block m at local index j.
template <int C>
HADES_HD void cross_fwd(uint32_t (&v)[C], int j, int log_nc,
                        const int64_t* x, const pair32* psi,
                        const pair32* wf, uint32_t q) {
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const int i = j + (m << log_nc);
    const pair32 t = load_pair(psi, i);
    v[m] = mul_shoup(load_residue(x, i), t.x, t.y, q);
  }
  cross_dif<C>(v, j, log_nc, wf, q);
}

// The inverse cross pass of group j: v[m] from block m at local index j
// (after every block's local DIT stages), the DIT stages of stride >= nc,
// then the psi^-i n^-1 twist, written to out (natural order).
template <int C>
HADES_HD void cross_inv(uint32_t (&v)[C], int j, int log_nc, int64_t* out,
                        const pair32* psi_inv, const pair32* wi,
                        uint32_t q) {
  cross_dit<C>(v, j, log_nc, wi, q);
#pragma unroll
  for (int m = 0; m < C; ++m) {
    const int i = j + (m << log_nc);
    const pair32 t = load_pair(psi_inv, i);
    out[i] = (int64_t)mul_shoup(v[m], t.x, t.y, q);
  }
}

}  // namespace hades
