"""HOPE baseline [31]: Homomorphic OPE, stateless, via Paillier.

Comparison by randomized difference: to compare Enc(a) vs Enc(b), the
evaluator computes Enc(r*(a-b)) with a fresh r > 0 (homomorphic subtract +
scalar multiply) and a decryption oracle reveals only the SIGN of the
blinded difference.  Stateless (no client storage, no interaction during
the compare itself) — the properties Table 1 credits HOPE with.  Supports
addition, integers only (the limitation HADES lifts).
"""
from __future__ import annotations

import dataclasses
import secrets
from typing import Tuple

from repro_torch.baselines import paillier as P


@dataclasses.dataclass
class HopeContext:
    pub: P.PaillierPublicKey
    priv: P.PaillierPrivateKey
    r_bits: int = 40


def keygen(bits: int = 1024) -> HopeContext:
    pub, priv = P.keygen(bits)
    return HopeContext(pub=pub, priv=priv)


def encrypt(ctx: HopeContext, m: int) -> int:
    return P.encrypt(ctx.pub, m)


def add(ctx: HopeContext, a: int, b: int) -> int:
    return P.add(ctx.pub, a, b)


def compare(ctx: HopeContext, ct_a: int, ct_b: int) -> int:
    """-1 / 0 / +1 on plaintexts, revealing only the blinded sign."""
    pub = ctx.pub
    # Enc(a - b) = Enc(a) * Enc(b)^-1
    neg_b = P.cmul(pub, ct_b, pub.n - 1)
    diff = P.add(pub, ct_a, neg_b)
    r = secrets.randbits(ctx.r_bits) | 1
    blinded = P.cmul(pub, diff, r)
    v = P.decrypt(ctx.priv, blinded)
    if v == 0:
        return 0
    # centered representative
    return 1 if v < pub.n // 2 else -1
