"""R_q = Z_q[x]/(x^n + 1) arithmetic in RNS form, in PyTorch.

Polynomials are int64 tensors of shape [..., K, n] (K = number of RNS
towers), with residues kept in [0, q_k).  Every product of two residues
fits a signed int64 (q_k < 2^31), and `%` (torch.remainder) keeps the
sign of the divisor as Python and jnp do, so the arithmetic is exact and
byte-identical to `repro.core.ring`.

`ntt`/`intt` take and give natural order, through `kernels.ntt.ntt_br`,
whose forward output is in bit-reversed order: ntt(x) =
ntt_br(x)[..., bitrev] and intt(y) = ntt_br_inv(y[..., bitrev]) (the bit
reversal is an involution).  `negacyclic_mul` is
`kernels.ntt.negacyclic_mul`.  Each runs its kernel on a CUDA tensor and
its plain version on a CPU one.
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
    # the kernels' 32-bit Shoup pairs {w, floor(w 2^32 / q)} as int32
    # bits: [K, 4, n, 2] over psi_pow, psi_inv_pow and the forward and
    # inverse stage twiddles, stage s's 2^s distinct ones at [2^s, 2^s+1)
    shoup: torch.Tensor

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


def shoup_pairs(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Residues w (int64, [..., K, n], q broadcast over them) as the
    kernels' Shoup pairs: [..., 2] int32 holding the uint32 bits of w and
    of floor(w 2^32 / q)."""
    pairs = torch.stack([w, (w << 32) // q], dim=-1)
    return torch.where(pairs >= 1 << 31, pairs - (1 << 32),
                       pairs).to(torch.int32)


def _shoup_tables(t: NttTables, dev) -> torch.Tensor:
    """[K, 4, n, 2]: psi_pow, psi_inv_pow, and the stage twiddles with
    stage s's first 2^s entries at [2^s, 2^(s+1)) (all a stage reads)."""
    K, n = t.psi_pow.shape
    tabs = np.zeros((K, 4, n), np.int64)
    tabs[:, 0], tabs[:, 1] = t.psi_pow, t.psi_inv_pow
    for s in range(n.bit_length() - 1):
        h = 1 << s
        tabs[:, 2, h:2 * h] = t.stage_w[:, s, :h]
        tabs[:, 3, h:2 * h] = t.stage_w_inv[:, s, :h]
    q = int64_tensor(np.asarray(t.qs)[:, None, None], dev)
    return shoup_pairs(int64_tensor(tabs, dev), q)


def make_ring(params: HadesParams, device=None) -> Ring:
    """The ring's tables on `device` (CUDA unless asked otherwise; see
    `resolve_device`)."""
    t: NttTables = params.ntt_tables()
    dev = resolve_device(device)
    return Ring(
        qs=tuple(params.qs),
        n=params.n,
        q_arr=int64_tensor(np.asarray(params.qs)[:, None], dev),
        psi_pow=int64_tensor(t.psi_pow, dev),
        psi_inv_pow=int64_tensor(t.psi_inv_pow, dev),
        stage_w=int64_tensor(t.stage_w, dev),
        stage_w_inv=int64_tensor(t.stage_w_inv, dev),
        bitrev=int64_tensor(t.bitrev, dev),
        shoup=_shoup_tables(t, dev),
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
# NTT (natural order in and out, through the bit-reversed-order transform)
# ---------------------------------------------------------------------------

def ntt(ring: Ring, a: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT. a: [..., K, n] -> [..., K, n] (eval domain)."""
    from repro_torch.kernels import ntt as NK      # NK imports this module
    return NK.ntt_br(a, ring, fwd=True).index_select(-1, ring.bitrev)


def intt(ring: Ring, a: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse NTT (includes n^-1 scaling)."""
    from repro_torch.kernels import ntt as NK
    return NK.ntt_br(a.index_select(-1, ring.bitrev), ring, fwd=False)


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

def crt_centered(params: HadesParams, residues: torch.Tensor) -> torch.Tensor:
    """Reconstruct the centered value in (-Q/2, Q/2] from residues [..., K].

    Garner's mixed-radix form: x = r_0, then for each further tower
    v_k = (r_k - x) * (q_0...q_{k-1})^-1 mod q_k and x += q_0...q_{k-1} v_k.
    Exact in int64 for Q < 2^62: x stays below q_0...q_k, and each product
    is of two numbers below 2^31 or below Q."""
    qs = params.qs
    x = residues[..., 0] % qs[0]
    M = qs[0]
    for k in range(1, len(qs)):
        q = qs[k]
        v = ((residues[..., k] - x % q) % q) * pow(M % q, q - 2, q) % q
        x = x + M * v
        M *= q
    return torch.where(x > M // 2, x - M, x)


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
