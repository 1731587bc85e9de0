"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``; a library may export several
entry points (``flash_bwd.cu`` holds B2 and B3). The build runs at first
use, from the package's own sources, into ``tony_tpu_torch/_build/`` (listed
in ``.gitignore``); a library's file name carries a digest of its source,
of every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt rather than loaded stale. ``build()``
starts one ``nvcc`` per missing library, all at once, and waits for all of
them. There is no fallback: without ``nvcc``, or when a build fails, the
caller gets the error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_int64)

# entry point -> (source file, exported C function, argtypes)
KERNELS: dict[str, tuple[str, str, list]] = {
    "rms_norm": (
        "rms_norm.cu", "tony_rms_norm",
        [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    ),
    "flash_fwd": (
        "flash_fwd.cu", "tony_flash_fwd",
        [_P, _P, _P, _P, _P] + [_L] * 12 + [_I] * 6 + [_F, _I, _I, _P],
    ),
    "flash_bwd_dq": (
        "flash_bwd.cu", "tony_flash_bwd_dq",
        [_P] * 9 + [_LP] + [_I] * 6 + [_F, _I, _I, _P],
    ),
    "flash_bwd_dkv": (
        "flash_bwd.cu", "tony_flash_bwd_dkv",
        [_P] * 8 + [_LP] + [_I] * 6 + [_F, _I, _I, _P],
    ),
}

# dtype codes shared by every C entry point
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_libraries: dict = {}
_functions: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels of tony_tpu_torch are built from source at first use"
        )
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives. The digest
    covers the source, every ``csrc/*.cuh`` (a source may include any of
    them) and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def build(names=None, *, ptxas_report: dict | None = None
          ) -> dict[str, float]:
    """Compile the library of every named entry point (default: all) that
    is not built yet, one ``nvcc`` process per source, all started
    together. Returns seconds per library built, keyed by source stem
    (empty when all were present). Given a dict, ``ptxas_report`` builds
    every named library anew with ``-Xptxas -v`` and receives each one's
    compiler report (registers, shared memory, spills), keyed the same."""
    names = list(KERNELS if names is None else names)
    sources = dict.fromkeys(KERNELS[n][0] for n in names)
    todo = [src for src in sources
            if ptxas_report is not None or not library_path(src).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ("-Xptxas", "-v") if ptxas_report is not None else ()
    procs = {}
    t0 = time.perf_counter()
    for source in todo:
        out = library_path(source)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / source)]
        procs[Path(source).stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    seconds: dict[str, float] = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if ptxas_report is not None:
            ptxas_report[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def function(name: str):
    """The C entry point ``name`` (a key of ``KERNELS``), building and
    loading its library on first use."""
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            source = KERNELS[name][0]
            lib = _libraries.get(source)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(source)))
                _libraries[source] = lib
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn


def dtype_code(tensor) -> int:
    code = DTYPE_CODES.get(str(tensor.dtype))
    if code is None:
        raise ValueError(
            f"CUDA kernels take float32 or bfloat16, got {tensor.dtype}"
        )
    return code


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
