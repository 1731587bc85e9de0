"""On-disk checkpoint layout: the completeness and chain rules.

The port's own copy of the orchestrator's layout module: this is the
definition of "which steps are restorable" that ``checkpoint/manager.py``
reads, and the orchestrator's progress probe applies the same rules to the
same files, so a checkpoint the port writes is one its coordinator can
resume from.

Format v1 (pre-pipeline)::

    step_<n>/process_<i>.npz    one per process (shards + manifest)
    step_<n>/metadata.json      {"step", "num_processes"} by process 0

    complete ⇔ metadata.json parses AND all process_<i>.npz exist.

Format v2 (the staged pipeline; ``metadata.json`` carries ``"format": 2``)
adds a per-process commit sidecar written strictly AFTER the shard file::

    step_<n>/process_<i>.json   {"step", "kind": "full"|"diff",
                                 "sha256": <hex of the npz bytes>,
                                 "base_steps": [steps this diff reads]}

    complete ⇔ metadata.json parses
             AND all process_<i>.npz AND process_<i>.json exist and parse
             AND every base step named by any sidecar still has that
                 process's shard file present (an intact differential
                 chain — a diff whose base was lost is torn, and readers
                 fall back to the previous complete step instead of
                 raising).

The sidecar doubles as the per-shard integrity record: restore verifies
the npz bytes against ``sha256`` and treats a mismatch exactly like a
torn step. Readers tolerate both formats forever — an upgraded job must
restore the checkpoints its previous binary wrote.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Iterable, Mapping

log = logging.getLogger(__name__)

MARKER = "metadata.json"
LAYOUT_FORMAT = 2

# The committed-step gauge's name (docs/DEPLOY.md "Checkpointing & live
# migration"), part of the commit contract the control plane consumes.
CKPT_COMMITTED_GAUGE = "tony_ckpt_committed_step"

KIND_FULL = "full"
KIND_DIFF = "diff"


def shard_name(process_id: int) -> str:
    return f"process_{process_id}.npz"


def sidecar_name(process_id: int) -> str:
    return f"process_{process_id}.json"


def parse_metadata(raw: bytes | None) -> dict | None:
    """The step marker as a dict, or None for missing/corrupt bytes (a
    corrupt marker makes the step torn, never an exception)."""
    if raw is None:
        return None
    try:
        meta = json.loads(raw)
    except ValueError:
        return None
    return meta if isinstance(meta, dict) else None


def metadata_num_processes(meta: Mapping[str, Any] | None,
                           ambient: int) -> int:
    if meta is None:
        return ambient
    try:
        return int(meta.get("num_processes", ambient))
    except (TypeError, ValueError):
        return ambient


def parse_sidecar(raw: bytes | None) -> dict | None:
    sc = parse_metadata(raw)
    if sc is None:
        return None
    base = sc.get("base_steps", [])
    if not isinstance(base, list):
        return None
    try:
        sc["base_steps"] = [int(b) for b in base]
    except (TypeError, ValueError):
        return None
    return sc


def _chain_intact(
    store: Any,
    step: int,
    n: int,
    names: set[str],
    entries: Mapping[int, tuple[set[str], Any]],
) -> bool:
    """v2 commit check for one step: every process's sidecar present +
    parseable, and every base step it references still holds that
    process's shard bytes."""
    for p in range(n):
        if sidecar_name(p) not in names:
            return False
        sc = parse_sidecar(store.get_file(step, sidecar_name(p)))
        if sc is None:
            return False
        for base in sc["base_steps"]:
            base_names = entries.get(base, (set(), None))[0]
            if shard_name(p) not in base_names:
                return False
    return True


def complete_steps(
    store: Any,
    ambient_num_processes: int = 1,
    entries: Mapping[int, tuple[set[str], Any]] | None = None,
) -> list[int]:
    """Sorted steps that are restorable under the rules above. The
    optional ``entries`` lets callers reuse one listing pass (GC does)."""
    if entries is None:
        entries = store.step_entries()
    steps = []
    for step, (names, _) in entries.items():
        if MARKER not in names:
            continue
        meta = parse_metadata(store.get_file(step, MARKER))
        if meta is None:
            continue
        n = metadata_num_processes(meta, ambient_num_processes)
        if not all(shard_name(p) in names for p in range(n)):
            continue
        try:
            fmt = int(meta.get("format", 1))
        except (TypeError, ValueError):
            fmt = 1
        if fmt >= 2 and not _chain_intact(store, step, n, names, entries):
            continue
        steps.append(step)
    return sorted(steps)


def referenced_steps(
    store: Any,
    steps: Iterable[int],
    ambient_num_processes: int = 1,
) -> set[int]:
    """Every step whose shard bytes some step in ``steps`` still reads
    (the union of all processes' sidecar ``base_steps``) — the set GC
    must keep alive for the kept steps to stay restorable. Refs always
    point directly at the step that physically wrote the bytes, so one
    level suffices."""
    out: set[int] = set()
    for step in steps:
        meta = parse_metadata(store.get_file(step, MARKER))
        n = metadata_num_processes(meta, ambient_num_processes)
        for p in range(n):
            sc = parse_sidecar(store.get_file(step, sidecar_name(p)))
            if sc is not None:
                out.update(sc["base_steps"])
    out.difference_update(set(steps))
    return out
