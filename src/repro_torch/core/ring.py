"""R_q = Z_q[x]/(x^n + 1) arithmetic in RNS form, in PyTorch.

Polynomials are int64 tensors of shape [..., K, n] (K = number of RNS
towers), with residues kept in [0, q_k).  Every product of two residues
fits a signed int64 (q_k < 2^31), and `%` (torch.remainder) keeps the
sign of the divisor as Python and jnp do, so the arithmetic is exact and
byte-identical to `repro.core.ring`.

The plain NTT is the reference's: pre-twist by psi^i, bit-reverse, DIT
Cooley-Tukey forward; Gentleman-Sande inverse, bit-reverse, post-twist by
psi^-i * n^-1.  `negacyclic_mul` is `kernels.ntt.negacyclic_mul`: the
fused multiply kernel on a CUDA tensor, its plain version on a CPU one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.params import HadesParams, NttTables


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and
    no card is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Ring:
    """Ring context: static moduli + int64 twiddle tables on one device."""

    qs: Tuple[int, ...]
    n: int
    q_arr: torch.Tensor          # [K, 1] int64
    psi_pow: torch.Tensor        # [K, n]
    psi_inv_pow: torch.Tensor    # [K, n]
    stage_w: torch.Tensor        # [K, S, n/2]
    stage_w_inv: torch.Tensor    # [K, S, n/2]
    bitrev: torch.Tensor         # [n]

    @property
    def num_towers(self) -> int:
        return len(self.qs)

    @property
    def stages(self) -> int:
        return self.n.bit_length() - 1

    @property
    def device(self) -> torch.device:
        return self.q_arr.device

    def to(self, device) -> "Ring":
        """The same ring with every table on `device`."""
        return Ring(qs=self.qs, n=self.n,
                    **{f.name: getattr(self, f.name).to(device)
                       for f in dataclasses.fields(self)
                       if f.name not in ("qs", "n")})


def int64_tensor(x, device) -> torch.Tensor:
    """A host array (numpy, a list, or another framework's array that
    converts through numpy) as an int64 tensor on `device`, copied."""
    return torch.from_numpy(np.array(x, np.int64)).to(device)


def make_ring(params: HadesParams, device="cpu") -> Ring:
    t: NttTables = params.ntt_tables()
    dev = torch.device(device)
    return Ring(
        qs=tuple(params.qs),
        n=params.n,
        q_arr=int64_tensor(np.asarray(params.qs)[:, None], dev),
        psi_pow=int64_tensor(t.psi_pow, dev),
        psi_inv_pow=int64_tensor(t.psi_inv_pow, dev),
        stage_w=int64_tensor(t.stage_w, dev),
        stage_w_inv=int64_tensor(t.stage_w_inv, dev),
        bitrev=int64_tensor(t.bitrev, dev),
    )


# ---------------------------------------------------------------------------
# elementwise ring ops
# ---------------------------------------------------------------------------

def add(ring: Ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b) % ring.q_arr


def sub(ring: Ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b) % ring.q_arr


def neg(ring: Ring, a: torch.Tensor) -> torch.Tensor:
    return (-a) % ring.q_arr


def scalar_mul(ring: Ring, a: torch.Tensor, s: int) -> torch.Tensor:
    """a * s mod q, s an integer already reduced below 2^31."""
    return (a * int(s)) % ring.q_arr


def pointwise_mul(ring: Ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b) % ring.q_arr


# ---------------------------------------------------------------------------
# NTT (plain PyTorch, the reference's schedule)
# ---------------------------------------------------------------------------

def _dit_stages(a: torch.Tensor, stage_w: torch.Tensor, q: torch.Tensor,
                n: int) -> torch.Tensor:
    """Forward DIT butterflies on bit-reversed input. a: [..., K, n]."""
    qb = q[..., None]                                  # [K, 1, 1]
    for s in range(n.bit_length() - 1):
        h = 1 << s
        w = stage_w[:, s, :h]                          # [K, h]
        x = a.reshape(a.shape[:-1] + (n // (2 * h), 2 * h))
        u, v = x[..., :h], x[..., h:]
        t = (v * w[:, None, :]) % qb
        a = torch.cat([(u + t) % qb, (u - t) % qb], dim=-1)
        a = a.reshape(a.shape[:-2] + (n,))
    return a


def _gs_stages(a: torch.Tensor, stage_w_inv: torch.Tensor, q: torch.Tensor,
               n: int) -> torch.Tensor:
    """Inverse Gentleman-Sande butterflies, natural-order input."""
    qb = q[..., None]
    for s in reversed(range(n.bit_length() - 1)):
        h = 1 << s
        w = stage_w_inv[:, s, :h]
        x = a.reshape(a.shape[:-1] + (n // (2 * h), 2 * h))
        u, v = x[..., :h], x[..., h:]
        a = torch.cat([(u + v) % qb, ((u - v) * w[:, None, :]) % qb], dim=-1)
        a = a.reshape(a.shape[:-2] + (n,))
    return a


def ntt(ring: Ring, a: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT. a: [..., K, n] -> [..., K, n] (eval domain)."""
    q = ring.q_arr
    a = (a * ring.psi_pow) % q                         # pre-twist
    a = a.index_select(-1, ring.bitrev)
    return _dit_stages(a, ring.stage_w, q, ring.n)


def intt(ring: Ring, a: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse NTT (includes n^-1 scaling)."""
    q = ring.q_arr
    a = _gs_stages(a, ring.stage_w_inv, q, ring.n)
    a = a.index_select(-1, ring.bitrev)
    return (a * ring.psi_inv_pow) % q                  # post-twist * n^-1


def negacyclic_mul(ring: Ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b in R_q.  Batch dims broadcast; `kernels.ntt.negacyclic_mul`
    picks the fused kernel or its plain version by the tensors' device."""
    from repro_torch.kernels import ntt as NK      # NK imports this module
    return NK.negacyclic_mul(a, b, ring)


def naive_negacyclic_mul(ring: Ring, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """O(n^2) schoolbook negacyclic product — oracle for the NTT itself.

    Only for tests with small n. a, b: [K, n].
    """
    n = ring.n
    i = torch.arange(n, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    k = ((i + j) % n).reshape(-1)
    sign = torch.where(i + j >= n, -1, 1).to(torch.int64)
    outs = []
    for t, q in enumerate(ring.qs):
        prod = (a[t][:, None] * b[t][None, :]) % q
        contrib = ((sign * prod) % q).reshape(-1)
        out = torch.zeros(n, dtype=torch.int64, device=a.device)
        out.index_add_(0, k, contrib)
        outs.append(out % q)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# CRT decode (centered representative of a coefficient mod Q)
# ---------------------------------------------------------------------------

def _mulmod(a: torch.Tensor, b_int: int, m_int: int) -> torch.Tensor:
    """(a * b) mod m with m up to 2^62, via double-and-add. a: any shape."""
    acc = torch.zeros_like(a)
    cur = a % m_int
    b = b_int % m_int
    while b:
        if b & 1:
            acc = (acc + cur) % m_int
        cur = (cur * 2) % m_int
        b >>= 1
    return acc


def crt_centered(params: HadesParams, residues: torch.Tensor) -> torch.Tensor:
    """Reconstruct the centered value in (-Q/2, Q/2] from residues [..., K].

    Exact for Q < 2^62 (int64 double-and-add; no partial sum exceeds
    2^63)."""
    Q = params.Q
    acc = torch.zeros(residues.shape[:-1], dtype=torch.int64,
                      device=residues.device)
    for k, alpha in enumerate(params.crt_alphas()):
        acc = (acc + _mulmod(residues[..., k], alpha, Q)) % Q
    return torch.where(acc > Q // 2, acc - Q, acc)


def to_rns(params: HadesParams, coeffs: np.ndarray) -> np.ndarray:
    """Host helper: integer coefficient array [..., n] -> residues [..., K, n]."""
    coeffs = np.asarray(coeffs, dtype=object)
    return np.stack([np.asarray(coeffs % q, dtype=np.int64)
                     for q in params.qs], axis=-2)


def qs_tensor(params: HadesParams, device) -> torch.Tensor:
    """The RNS moduli as a [K] int64 tensor on `device`."""
    return torch.tensor(params.qs, dtype=torch.int64, device=device)


def const_poly(params: HadesParams, value: torch.Tensor) -> torch.Tensor:
    """Embed integer scalar(s) as the constant coefficient of an RNS poly.

    value: [...] int64 (may be negative) -> [..., K, n].
    """
    K, n = params.num_towers, params.n
    res = value[..., None] % qs_tensor(params, value.device)   # [..., K]
    out = torch.zeros(value.shape + (K, n), dtype=torch.int64,
                      device=value.device)
    out[..., 0] = res
    return out
