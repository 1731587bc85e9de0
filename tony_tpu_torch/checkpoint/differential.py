"""Differential save planning — hash-per-leaf, rewrite only changed leaves.

On a large job the optimizer tree dominates checkpoint bytes, and big
parts of it are often byte-identical between consecutive saves: frozen
layers in a fine-tune, embedding rows whose adam moments stayed exactly
zero, experts the router never picked, EMA trees at low update rates.
The tracker hashes every leaf's encoded pieces at each save and plans a
*differential* step: unchanged leaves are not rewritten — their manifest
entries carry ``ref_step``, pointing at the step whose shard file
physically holds the bytes (always the direct owner, so chains never
need transitive walks).

Periodic compaction: every ``full_every``-th save rewrites everything
(``kind=full``), bounding how many old steps a restore can touch and
letting GC retire donors. The tracker is in-memory per process — after
a restart the first save is full, which is exactly the safe answer.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


def hash_pieces(pieces) -> tuple[str, ...]:
    """sha256 per encoded piece (the unit a shard file stores)."""
    out = []
    for piece in pieces:
        h = hashlib.sha256()
        h.update(memoryview(piece))
        out.append(h.hexdigest())
    return tuple(out)


@dataclass
class DiffPlan:
    kind: str                      # layout.KIND_FULL | KIND_DIFF
    # leaf key -> step that owns the bytes; keys absent here are WRITTEN
    # into this step's shard file.
    refs: dict[str, int] = field(default_factory=dict)

    @property
    def base_steps(self) -> list[int]:
        return sorted(set(self.refs.values()))


class DiffTracker:
    """Per-process diff state: last seen hashes + byte owner per leaf."""

    def __init__(self, full_every: int = 5, enabled: bool = True) -> None:
        self.enabled = enabled
        self.full_every = max(int(full_every), 1)
        self._hashes: dict[str, tuple[str, ...]] = {}
        self._owner: dict[str, int] = {}
        self._saves_since_full = 0

    def reset(self) -> None:
        """Forget everything — the next save is full. Called after any
        persist failure: a step that may not have landed must never be
        the byte owner a later diff references."""
        self._hashes.clear()
        self._owner.clear()
        self._saves_since_full = 0

    def plan(self, step: int, leaf_hashes: dict[str, tuple[str, ...]],
             ) -> DiffPlan:
        """Decide what ``step`` writes. ``leaf_hashes``: key -> per-piece
        hashes of the encoded bytes about to be saved."""
        force_full = (
            not self.enabled
            or not self._hashes
            or self._saves_since_full >= self.full_every - 1
        )
        refs: dict[str, int] = {}
        if not force_full:
            for key, hashes in leaf_hashes.items():
                owner = self._owner.get(key)
                # owner != step: a RE-SAVE of a step (lm_train's final
                # blocking save repeats the last in-loop save's step)
                # must rewrite, never self-reference — a self-ref diff
                # would overwrite the very shard file its bytes live in.
                if owner is not None and owner != step \
                        and self._hashes.get(key) == hashes:
                    refs[key] = owner
        for key, hashes in leaf_hashes.items():
            self._hashes[key] = hashes
            if key not in refs:
                self._owner[key] = step
        # Leaves that vanished from the tree (structure change) must not
        # linger as stale owners.
        for gone in set(self._hashes) - set(leaf_hashes):
            self._hashes.pop(gone, None)
            self._owner.pop(gone, None)
        if refs:
            self._saves_since_full += 1
            return DiffPlan(kind="diff", refs=refs)
        # No refs means every byte was (re)written — a full step however
        # it came about, so the compaction clock restarts.
        self._saves_since_full = 0
        return DiffPlan(kind="full")
