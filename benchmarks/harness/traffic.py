"""The one traffic generator: a traffic file's parameters and a seed give
the same requests every time.

A round is one pass over the mix's set of request lengths: `strata`
lengths spread evenly over [length_min, length_max] (the middle of each
of `strata` equal slices), in an order drawn from the seed. Every seed
gets the same set of sizes, so the seed changes the order and the
contents of the requests, not the amount of work; a window runs whole
rounds, a closed loop of one client that sends the next request when
the last has returned. Each request carries a synthetic MSA of
`msa_rows` rows drawn from the seed.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from harness.synthetic import query_sequence, synthetic_msa
from harness.weights import sub_seed


class Request(NamedTuple):
    index: int           # position in the round
    L: int
    msa: np.ndarray      # (rows, L) uint8 tokens
    seq: str             # the query's one-letter sequence


def stratified_lengths(lo: int, hi: int, strata: int) -> List[int]:
    """The middle of each of `strata` equal slices of [lo, hi]."""
    return [int(round(lo + (hi - lo) * (2 * k + 1) / (2 * strata)))
            for k in range(strata)]


def round_lengths(traffic: dict, seed: int) -> List[int]:
    lengths = stratified_lengths(traffic["length_min"],
                                 traffic["length_max"], traffic["strata"])
    order = np.random.default_rng(sub_seed(seed, "order")).permutation(
        len(lengths))
    return [lengths[i] for i in order]


def make_round(traffic: dict, seed: int) -> List[Request]:
    """The requests of one round, in the order they are sent."""
    out = []
    for i, L in enumerate(round_lengths(traffic, seed)):
        rng = np.random.default_rng(sub_seed(seed, "msa", i))
        msa = synthetic_msa(L, traffic["msa_rows"], rng)
        out.append(Request(i, L, msa, query_sequence(msa)))
    return out


def sample(n: int, k: int, seed: int, must: int) -> List[int]:
    """k positions of n drawn from the seed, `must` among them."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    rest = [int(i) for i in rng.permutation(n) if i != must]
    return sorted([must] + rest[:max(0, k - 1)])
