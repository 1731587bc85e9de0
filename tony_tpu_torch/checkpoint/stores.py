"""Step storage for the checkpoint pipeline: the filesystem store.

One small interface (``put_file`` / ``get_file`` / ``step_entries`` /
``delete_step``). ``_FsCheckpointStore`` writes tmp -> flush -> fsync ->
atomic rename, so readers never see a torn file. ``gs://`` prefixes (the
orchestrator's object store) are not ported yet and raise.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def is_gs_uri(path: str) -> bool:
    return str(path).startswith("gs://")


def gs_not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: gs:// object storage waits for the port of the cloud "
        f"storage client (ROADMAP Queue A, item 27); use a local or "
        f"mounted directory"
    )


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


def store_for(directory: str | os.PathLike[str],
              create: bool = True) -> Any:
    """The store for a local path; a gs:// prefix raises until the object
    store is ported. ``create=False`` for read-only consumers."""
    if is_gs_uri(str(directory)):
        raise gs_not_ported(str(directory))
    return _FsCheckpointStore(directory, create=create)
