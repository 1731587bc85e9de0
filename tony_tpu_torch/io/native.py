"""ctypes binding to the native data-plane library (``native/tony_io.cc``).

The port's counterpart of the JAX package's ``io/native.py``, with its
functions, signatures and return types. The library is host code, built
from the package's own copy of the source at first use with the host C++
compiler (``$CXX``, else ``c++`` or ``g++``) and the JAX Makefile's flags,
into ``kernels.BUILD_DIR`` under a digest of the source and the flags
(written to a temporary name, then renamed, so concurrent processes are
safe).

Unlike the JAX package, where the library is an optional accelerator, the
port requires it: a missing compiler, a failed build or a library that does
not load raises from ``available()`` with the cause (the compiler's output,
say). The reader's pure-Python ``preadv`` path is reached only where a
caller patches ``available`` to return False, as the tests do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tony_io.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH."""
    env = os.environ.get("CXX")
    if env:
        return env
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler ($CXX, c++, g++): the native data-plane "
        "library of tony_tpu_torch is built from source at first use"
    )


def library_path() -> Path:
    """Where the library built from ``SOURCE`` with ``CXX_FLAGS`` lives."""
    from tony_tpu_torch import kernels

    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return kernels.BUILD_DIR / f"libtony_io-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output when the build fails."""
    out = library_path()
    if out.is_file():
        return out
    cxx = compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    except OSError as exc:
        raise RuntimeError(
            f"native data-plane build: cannot run {cxx!r}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native data-plane build failed ({cxx} exit "
            f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tony_scan_record_starts.restype = ctypes.c_int64
    lib.tony_scan_record_starts.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.tony_pread_records.restype = ctypes.c_int64
    lib.tony_pread_records.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.tony_count_records.restype = ctypes.c_int64
    lib.tony_count_records.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tony_readahead.restype = ctypes.c_int64
    lib.tony_readahead.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
    ]
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use. Raises when it cannot be
    built or loaded; a failure is not remembered, so the next call tries
    again."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _declare(ctypes.CDLL(str(path)))
            except (OSError, AttributeError) as exc:
                raise RuntimeError(
                    f"native data-plane library {path} does not load: "
                    f"{exc}") from exc
        return _lib


def available() -> bool:
    """True once the library is loaded; raises when it cannot be."""
    return _load() is not None


def scan_record_starts(chunk: bytes) -> list[int]:
    """Byte offsets of every record start after the first within ``chunk``
    (offsets follow each newline that has a successor byte)."""
    lib = _load()
    max_out = chunk.count(b"\n") + 1
    out = (ctypes.c_int64 * max_out)()
    n = lib.tony_scan_record_starts(chunk, len(chunk), out, max_out)
    return list(out[:n])


def count_records(chunk: bytes) -> int:
    """Complete newline-terminated records in ``chunk``."""
    return _load().tony_count_records(chunk, len(chunk))


def readahead(fd: int, offset: int, length: int) -> bool:
    """Kernel readahead hint (posix_fadvise WILLNEED) for a byte range of
    an open fd, given for a span before it is queued. Advisory: returns
    False when refused, and callers never depend on it."""
    return _load().tony_readahead(fd, offset, length) == 0


def pread_records(
    fd: int, offset: int, record_bytes: int, num_records: int
) -> np.ndarray | None:
    """One native pread of ``num_records`` fixed-size records from an open
    fd; returns a [n_read, record_bytes] uint8 array (short at EOF), or
    None on IO error. The caller owns the fd."""
    lib = _load()
    out = np.empty((num_records, record_bytes), dtype=np.uint8)
    n = lib.tony_pread_records(
        fd, offset, record_bytes, num_records,
        out.ctypes.data_as(ctypes.c_char_p),
    )
    if n < 0:
        return None
    return out[:n]
