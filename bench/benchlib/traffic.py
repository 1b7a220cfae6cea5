"""The one generator of request mixes: a traffic file's parameters and a
seed -> a stream of requests (prompt token ids, output length).

Lengths come in blocks of ``strata`` requests.  Every block holds the same
lengths, the midpoints of ``strata`` equal-probability slices of each
distribution, and the seed only orders them (prompt and output lengths
shuffled apart) and draws the token ids.  So every seed sends the same
work in another order, and any run of whole blocks has exactly the stated
distribution.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantile(spec: dict, u: float) -> int:
    """The length at probability ``u`` of a length distribution: lognormal
    (``median``, ``sigma``), loguniform or uniform (``min`` to ``max``);
    clipped to ``[min, max]``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    dist = spec["dist"]
    if dist == "lognormal":
        x = float(spec["median"]) * math.exp(float(spec["sigma"]) * NormalDist().inv_cdf(u))
    elif dist == "loguniform":
        x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return int(min(max(round(x), lo), hi))


def strata(spec: dict, n: int) -> "list[int]":
    return [quantile(spec, (i + 0.5) / n) for i in range(n)]


class Requests:
    """Request ``i`` of the stream a traffic file and a seed define:
    ``(prompt int32 array, output length)``; the same for every call."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.n = int(traffic["strata"])
        self.prompt_strata = strata(traffic["prompt"], self.n)
        self.output_strata = strata(traffic["output"], self.n)
        self._blocks: "dict[int, tuple[np.ndarray, np.ndarray]]" = {}

    @property
    def max_prompt(self) -> int:
        return max(self.prompt_strata)

    @property
    def max_output(self) -> int:
        return max(self.output_strata)

    def lengths(self, i: int) -> "tuple[int, int]":
        b, j = divmod(int(i), self.n)
        blk = self._blocks.get(b)
        if blk is None:
            rng = np.random.default_rng([self.seed, b])
            blk = self._blocks[b] = (rng.permutation(self.prompt_strata),
                                     rng.permutation(self.output_strata))
        return int(blk[0][j]), int(blk[1][j])

    def __getitem__(self, i: int) -> "tuple[np.ndarray, int]":
        plen, out = self.lengths(i)
        rng = np.random.default_rng([self.seed, int(i), 1])
        return rng.integers(0, self.vocab, size=plen, dtype=np.int32), out
