"""Paillier cryptosystem (additively homomorphic) — substrate for the HOPE
baseline [31]/[24].  Python big-int arithmetic; this is a BASELINE the paper
compares against, not the contribution, so CPU bignum is the honest match
to the original (HOPE's artifact is CPU Paillier too).
"""
from __future__ import annotations

import dataclasses
import math
import secrets


def _is_probable_prime(n: int, rounds: int = 20) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        c = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(c):
            return c


@dataclasses.dataclass
class PaillierPublicKey:
    n: int
    n_sq: int
    g: int


@dataclasses.dataclass
class PaillierPrivateKey:
    lam: int
    mu: int
    pub: PaillierPublicKey


def keygen(bits: int = 1024):
    p = _random_prime(bits // 2)
    q = _random_prime(bits // 2)
    while q == p:
        q = _random_prime(bits // 2)
    n = p * q
    n_sq = n * n
    g = n + 1
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    # mu = (L(g^lam mod n^2))^-1 mod n,  L(x) = (x-1)/n
    x = pow(g, lam, n_sq)
    L = (x - 1) // n
    mu = pow(L, -1, n)
    pub = PaillierPublicKey(n=n, n_sq=n_sq, g=g)
    return pub, PaillierPrivateKey(lam=lam, mu=mu, pub=pub)


def encrypt(pub: PaillierPublicKey, m: int) -> int:
    m %= pub.n
    r = secrets.randbelow(pub.n - 1) + 1
    return (pow(pub.g, m, pub.n_sq) * pow(r, pub.n, pub.n_sq)) % pub.n_sq


def decrypt(priv: PaillierPrivateKey, ct: int) -> int:
    pub = priv.pub
    x = pow(ct, priv.lam, pub.n_sq)
    L = (x - 1) // pub.n
    return (L * priv.mu) % pub.n


def add(pub: PaillierPublicKey, ct_a: int, ct_b: int) -> int:
    return (ct_a * ct_b) % pub.n_sq


def cmul(pub: PaillierPublicKey, ct: int, k: int) -> int:
    return pow(ct, k % pub.n, pub.n_sq)
