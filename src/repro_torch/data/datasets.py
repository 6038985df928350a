"""The paper's three evaluation datasets (§6.2.1), reproduced offline.

A verbatim copy of `repro.data.datasets`, so this package imports
nothing of the JAX one; the same seed gives the same arrays.

The originals are web downloads (blockchain.com trade volume, covidtracking
national history, UCSC hg38 tables); this container is offline, so we
generate *statistically faithful* stand-ins with the exact row counts the
paper reports and value distributions matching the sources' character:

  bitcoin : 1,085 daily trade-volume floats, lognormal with regime drift
  covid19 : 340 daily case-count integers, logistic-growth + noise
  hg38    : 34,423 genomic coordinates, mixture over chromosome lengths

All values are preprocessed to fit the BFV plaintext modulus (mod 65537)
or left as floats for CKKS — exactly the preprocessing §6.2.1 describes.
Deterministic (seeded) so benchmark numbers are reproducible.
"""
from __future__ import annotations

import zlib

import numpy as np

ROW_COUNTS = {"bitcoin": 1085, "covid19": 340, "hg38": 34423}
DATASETS = tuple(ROW_COUNTS)


def _bitcoin(rng: np.random.Generator) -> np.ndarray:
    n = ROW_COUNTS["bitcoin"]
    drift = np.cumsum(rng.normal(0, 0.05, n))
    vol = np.exp(rng.normal(9.5, 0.8, n) + drift)
    return vol


def _covid19(rng: np.random.Generator) -> np.ndarray:
    n = ROW_COUNTS["covid19"]
    t = np.arange(n, dtype=np.float64)
    waves = (2e5 / (1 + np.exp(-(t - 120) / 12))
             + 1.5e5 / (1 + np.exp(-(t - 260) / 9)))
    noise = rng.lognormal(0, 0.35, n)
    return waves * noise + rng.integers(0, 2000, n)


def _hg38(rng: np.random.Generator) -> np.ndarray:
    n = ROW_COUNTS["hg38"]
    chrom_lens = np.array([248956422, 242193529, 198295559, 190214555,
                           181538259, 170805979, 159345973, 145138636,
                           138394717, 133797422, 135086622, 133275309,
                           114364328, 107043718, 101991189, 90338345,
                           83257441, 80373285, 58617616, 64444167,
                           46709983, 50818468], dtype=np.float64)
    probs = chrom_lens / chrom_lens.sum()
    chrom = rng.choice(len(chrom_lens), size=n, p=probs)
    return rng.uniform(0, chrom_lens[chrom])


def load_dataset(name: str, *, scheme: str = "bfv",
                 t: int = 65537, seed: int = 1234) -> np.ndarray:
    # crc32, NOT hash(): str hashes are randomized per process
    # (PYTHONHASHSEED), which would make every "deterministic" dataset —
    # and the whole BENCH_db.json trajectory — differ run to run
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    raw = {"bitcoin": _bitcoin, "covid19": _covid19, "hg38": _hg38}[name](rng)
    if scheme == "bfv":
        return (raw.astype(np.int64) % t).astype(np.int64)
    return raw.astype(np.float64)
