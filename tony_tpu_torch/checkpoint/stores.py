"""Step storage for the checkpoint pipeline.

One small interface (``put_file`` / ``get_file`` / ``step_entries`` /
``delete_step``), two stores, as in the JAX package:
``_FsCheckpointStore`` writes tmp -> flush -> fsync -> atomic rename, so
readers never see a torn file; ``_ObjectCheckpointStore`` writes under a
``gs://`` prefix through ``cloud.default_storage()``, where each PUT is
atomic per object.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any

from tony_tpu_torch.cloud.gcs import GcsError, is_gs_uri, split_gs_uri

_STEP_RE = re.compile(r"^step_(\d+)$")


def _fsync_write(path: Path, tmp: Path, data: bytes) -> None:
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(path)  # atomic: readers never see a torn file


class _FsCheckpointStore:
    """Filesystem step storage: fsync + atomic-rename durability."""

    def __init__(self, directory: str | os.PathLike[str],
                 create: bool = True) -> None:
        self.directory = Path(directory)
        if create:
            self.directory.mkdir(parents=True, exist_ok=True)

    def put_file(self, step: int, name: str, data: bytes) -> None:
        step_dir = self.directory / f"step_{step}"
        step_dir.mkdir(parents=True, exist_ok=True)
        _fsync_write(step_dir / name, step_dir / f".tmp_{name}", data)

    def get_file(self, step: int, name: str) -> bytes | None:
        path = self.directory / f"step_{step}" / name
        try:
            return path.read_bytes()
        except OSError:
            return None

    def step_entries(self) -> dict[int, tuple[set[str], float | None]]:
        """step -> (visible file names, newest mtime). Names exclude
        in-flight tmp files; the mtime INCLUDES them — a straggler
        mid-write must read as active to the GC's quiescence check. mtime
        None: files vanishing underneath us (someone is active)."""
        out: dict[int, tuple[set[str], float | None]] = {}
        if not self.directory.is_dir():
            return out
        for child in self.directory.iterdir():
            m = _STEP_RE.match(child.name)
            if not (m and child.is_dir()):
                continue
            try:
                names = {
                    p.name for p in child.iterdir()
                    if not p.name.startswith(".")
                }
                newest: float | None = max(
                    (p.stat().st_mtime for p in child.rglob("*")),
                    default=child.stat().st_mtime,
                )
            except OSError:
                names, newest = set(), None
            out[int(m.group(1))] = (names, newest)
        return out

    def delete_step(self, step: int) -> None:
        shutil.rmtree(self.directory / f"step_{step}", ignore_errors=True)


class _ObjectCheckpointStore:
    """Object-store step storage under a gs:// prefix. PUTs are atomic per
    object, so there are no tmp names; durability is the PUT response."""

    def __init__(self, prefix: str) -> None:
        self.prefix = str(prefix).rstrip("/")

    def _store(self):
        from tony_tpu_torch.cloud import default_storage

        return default_storage()

    def put_file(self, step: int, name: str, data: bytes) -> None:
        self._store().put_bytes(f"{self.prefix}/step_{step}/{name}", data)

    def get_file(self, step: int, name: str) -> bytes | None:
        try:
            return self._store().get_bytes(
                f"{self.prefix}/step_{step}/{name}"
            )
        except GcsError as exc:
            if exc.status == 404:
                return None
            raise

    def _entries(self) -> list[tuple[int, str, float | None]]:
        _, root_key = split_gs_uri(self.prefix)
        store = self._store()
        if hasattr(store, "list_prefix_mtimes"):
            listed = store.list_prefix_mtimes(self.prefix + "/")
        else:  # minimal fakes: no timestamps -> age unknown = active
            listed = [(k, None) for k in store.list_prefix(self.prefix + "/")]
        out = []
        for key, mtime in listed:
            rel = key[len(root_key):].lstrip("/") if root_key else key
            parts = rel.split("/")
            if len(parts) != 2:
                continue
            m = _STEP_RE.match(parts[0])
            if m:
                out.append((int(m.group(1)), parts[1], mtime))
        return out

    def step_entries(self) -> dict[int, tuple[set[str], float | None]]:
        """One listing pass serves names AND quiescence stamps (the
        objects' server-side ``updated`` times). Any object with an
        unknown age makes its whole step read as active (None)."""
        out: dict[int, tuple[set[str], float | None]] = {}
        seen_none: set[int] = set()
        for step, name, mtime in self._entries():
            names, newest = out.get(step, (set(), 0.0))
            if mtime is None:
                seen_none.add(step)
            else:
                newest = max(newest or 0.0, mtime)
            out[step] = (names | {name}, newest)
        return {
            step: (names, None if step in seen_none else newest)
            for step, (names, newest) in out.items()
        }

    def delete_step(self, step: int) -> None:
        store = self._store()
        bucket, _ = split_gs_uri(self.prefix)
        for key in store.list_prefix(f"{self.prefix}/step_{step}/"):
            store.delete(f"gs://{bucket}/{key}")


def store_for(directory: str | os.PathLike[str],
              create: bool = True) -> Any:
    """The right store for a path or gs:// prefix. ``create=False`` for
    read-only consumers (a probe must not mkdir a checkpoint dir as a side
    effect of probing it)."""
    if is_gs_uri(str(directory)):
        return _ObjectCheckpointStore(str(directory))
    return _FsCheckpointStore(directory, create=create)
