"""The one generator of traffic: requests from a mix file's parameters and
the run's seed.

Every seed gets the same work. Sizes are drawn block-stratified: each run
of ``stratum`` consecutive requests holds the distribution's quantiles at
(j + 0.5) / stratum, j = 0 .. stratum − 1, in an order the seed shuffles.
So any prefix of the stream has nearly the same prompt and output
lengths whatever the seed, and runs differ in token ids and in the order
of sizes only.

Mix keys read here: ``clients`` (a closed loop: each client submits its
next request when its last one finishes); ``prompt`` and ``output``
distributions ({"dist": "uniform" | "lognormal" | "fixed", ...});
``first_output_spread`` (the first request of each client takes a
stratified share of its drawn output, so finishes are spread from the
start); ``stratum``.
"""

from __future__ import annotations

import math
import statistics
import zlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

_NORMAL = statistics.NormalDist()


def rng(seed: int, *names: str) -> np.random.Generator:
    """A numpy generator for one purpose of one run."""
    entropy = [seed % 2**64] + [zlib.crc32(n.encode()) for n in names]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def torch_seed(seed: int, *names: str) -> int:
    """A torch generator seed for one purpose of one run."""
    return int(rng(seed, *names).integers(0, 2**62))


def quantile(dist: Dict, p: float) -> int:
    """The distribution's p-quantile as a whole number of tokens."""
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "uniform":
        return min(hi, lo + int(p * (hi - lo + 1)))
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(p))
        return int(min(hi, max(lo, round(x))))
    raise ValueError(f"unknown distribution {kind!r}")


def stratified(dist: Dict, n: int, stratum: int,
               r: np.random.Generator) -> List[int]:
    """n sizes, each block of ``stratum`` the same quantiles shuffled."""
    grid = np.array([quantile(dist, (j + 0.5) / stratum)
                     for j in range(stratum)])
    out: List[int] = []
    while len(out) < n:
        out.extend(int(x) for x in r.permutation(grid))
    return out[:n]


@dataclass
class Request:
    """One request as the traffic defines it."""

    index: int
    prompt: np.ndarray
    max_new: int


class ServeTraffic:
    """The request stream of a serving mix; ``request(i)`` is the i-th."""

    def __init__(self, mix: Dict, vocab: int, seed: int, block: int = 4096):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.stratum = int(mix.get("stratum", 64))
        self.clients = int(mix["clients"])
        self._block = block
        self._prompt: List[int] = []
        self._output: List[int] = []
        self._spread: List[float] = []
        if mix.get("first_output_spread"):
            grid = (np.arange(self.clients) + 0.5) / self.clients
            self._spread = list(rng(seed, "spread").permutation(grid))

    def _grow(self, i: int) -> None:
        while len(self._prompt) <= i:
            b = len(self._prompt) // self._block
            n = self._block
            self._prompt += stratified(self.mix["prompt"], n, self.stratum,
                                       rng(self.seed, "prompt", str(b)))
            self._output += stratified(self.mix["output"], n, self.stratum,
                                       rng(self.seed, "output", str(b)))

    def request(self, i: int) -> Request:
        self._grow(i)
        n_new = self._output[i]
        if i < len(self._spread):
            n_new = max(1, math.ceil(self._spread[i] * n_new))
        prompt = rng(self.seed, "tokens", str(i)).integers(
            0, self.vocab, self._prompt[i]).astype(np.int64)
        return Request(index=i, prompt=prompt, max_new=n_new)

    def warm_lengths(self) -> List[int]:
        """Prompt lengths that reach every padded shape the mix can give:
        the smallest, each power of two between, and the largest."""
        p = self.mix["prompt"]
        if p["dist"] == "fixed":
            return [int(p["value"])]
        lo, hi = int(p["min"]), int(p["max"])
        out, n = {lo, hi}, 1
        while n < hi:
            if n > lo:
                out.add(n)
            n *= 2
        return sorted(out)
