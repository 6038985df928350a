"""The benchmark's data: hg38's stand-in coordinates, made from the seed.

A frozen copy of the hg38 generator of `repro_torch/data/datasets.py`
(34,423 genomic coordinates, a mixture over the 22 autosomes' lengths)
and of the float preprocessing of `chip_smoke.py::_float_dataset` (the
coordinates scaled into [0, span] on a lattice of `step`), so that a
later change to the program cannot move the yardstick.  Unlike the
program's copy, the generator takes the run's seed: every seed draws a
column of the same size from the same distribution.

A configuration file names its column (see `Column.from_config`):

  dataset   "hg38"
  rows      rows kept (the first rows of the draw)
  scheme    "bfv": coordinates mod `modulus` (the paper's preprocessing)
            "ckks": floats on the lattice `step` in [0, `span`]
"""
from __future__ import annotations

import numpy as np

HG38_ROWS = 34423
# GRCh38 autosome lengths (chr1-chr22), as in the program's generator
HG38_CHROM_LENS = np.array([
    248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
    159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
    114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
    58617616, 64444167, 46709983, 50818468], dtype=np.float64)


def hg38_raw(rng: np.random.Generator, n: int = HG38_ROWS) -> np.ndarray:
    """n coordinates: a chromosome drawn by length, then a uniform
    position on it (`datasets._hg38` with the row count as a parameter)."""
    probs = HG38_CHROM_LENS / HG38_CHROM_LENS.sum()
    chrom = rng.choice(len(HG38_CHROM_LENS), size=n, p=probs)
    return rng.uniform(0, HG38_CHROM_LENS[chrom])


class Column:
    """One configuration's plaintext column: its values in row order, and
    the rule that turns fresh coordinates into values of the same kind
    (inserts)."""

    def __init__(self, config: dict, rng: np.random.Generator):
        if config["dataset"] != "hg38":
            raise ValueError(f"no generator for dataset "
                             f"{config['dataset']!r}")
        self.scheme = config["scheme"]
        self.step = float(config["step"])
        self.domain = tuple(config["domain"])
        raw = hg38_raw(rng)[:int(config["rows"])]
        if self.scheme == "bfv":
            self.modulus = int(config["modulus"])
        elif self.scheme == "ckks":
            # `_float_dataset`: the kept rows' largest coordinate maps to
            # the top of the span; inserts reuse the same scale
            self.scale = float(config["span"]) / raw.max()
        else:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        self.values = self.preprocess(raw)

    def preprocess(self, raw: np.ndarray) -> np.ndarray:
        """Coordinates -> column values (int64 mod t, or lattice floats)."""
        if self.scheme == "bfv":
            return raw.astype(np.int64) % self.modulus
        return np.minimum(np.round(raw * self.scale / self.step) * self.step,
                          self.domain[1])

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n fresh values from the column's distribution (an insert)."""
        return self.preprocess(hg38_raw(rng, n))
