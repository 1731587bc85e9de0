"""The traffic generator: token batches drawn from the seed, as a traffic
file's parameters say.

Batch ``i`` of a run is a pure function of (seed, i, data rank), so the
reference draws the very batches the program was fed, and every seed
sees the same sizes.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

KINDS = ("train",)
IDS = ("uniform",)


def check(traffic: dict) -> None:
    if traffic.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {traffic.get('kind')!r} not one of "
                         f"{KINDS}")
    if traffic.get("ids") not in IDS:
        raise ValueError(f"token ids {traffic.get('ids')!r} not one of {IDS}")
    for key in ("batch", "seq", "trace_steps"):
        if int(traffic[key]) < 1:
            raise ValueError(f"traffic {key} must be >= 1")


def batch(traffic: dict, vocab: int, seed: int, index: int,
          rank: int = 0) -> np.ndarray:
    """Batch ``index`` (0-based) of data rank ``rank`` (0 on one card):
    [batch, seq + 1] token ids, int64, uniform over the vocabulary."""
    rng = np.random.default_rng([int(seed), int(index), int(rank)])
    rows, cols = int(traffic["batch"]), int(traffic["seq"]) + 1
    return rng.integers(0, vocab, size=(rows, cols), dtype=np.int64)


def batches(traffic: dict, vocab: int, seed: int,
            rank: int = 0) -> Iterator[np.ndarray]:
    index = 0
    while True:
        yield batch(traffic, vocab, seed, index, rank)
        index += 1
