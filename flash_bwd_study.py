#!/usr/bin/env python3
"""Tile sweep and fault controls of the bf16 flash backward (B2 dq, B3
dk/dv) of tony_tpu_torch on one NVIDIA card.

    python3 flash_bwd_study.py sweep      # streamed-tile sizes
    python3 flash_bwd_study.py controls   # broken copies vs chip_smoke's checks

Both compile variants of tony_tpu_torch/csrc/flash_bwd.cu, each made by
text substitution in a copy under tony_tpu_torch/_build/study/ (the source
itself is never edited), load each in place of the built library and drive
it through the port's wrapper ``_flash_bwd_cuda`` at chip_smoke.py's two
timing shapes, q/k/v [8, 2048, 16, 64] and [8, 2048, 8, 128], bf16, causal.

sweep: B2's streamed key tile (DqBf16::kN) and B3's streamed query tile
(DkvBf16::kM) at 16, 32 and 64 rows. For each variant: ptxas's registers
and spill bytes of the bf16 kernels, chip_smoke's checks against the plain
version, and the device ms of B2 and B3 at both shapes. The shipped sizes
run first and last, so the spread between them shows the drift.

controls: copies that each drop the contribution of one streamed tile, a
fault of the kind a broken double buffer or loop bound makes. For each, the
readings of chip_smoke's two checks at both shapes (max abs error against
TOL times the largest |gradient|; row error against ROW_TOL) and which one
caught it. Exits non-zero if either check passes a control, or if the
shipped copy fails one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys

import chip_smoke

SHIPPED_TILES = {"kN": 16, "kM": 32}  # B2 keys, B3 query rows per tile
SHAPES = {"train": (8, 2048, 16, 64), "hd128": (8, 2048, 8, 128)}

# Each control: (old, new) substitutions in flash_bwd.cu. "tile" counts the
# key tiles of one B2 block, "it" the (query head, query tile) steps of one
# B3 block.
_DQ_DS = "        s[n][e] = pv * (dp[n][e] - dlt[e >> 1]);"
_DKV_DS = "        dpt[n][e] = pv * (dpt[n][e] - (j ? d2.y : d2.x));"
CONTROLS = {
    # keys 32-47 missing from every query row past 31
    "dq_drops_key_tile_2": [(_DQ_DS, _DQ_DS.replace(
        "= pv", "= tile == 2 ? 0.f : pv"))],
    # the keys nearest each query tile's diagonal missing
    "dq_drops_last_key_tile": [(_DQ_DS, _DQ_DS.replace(
        "= pv", "= tile == n_tiles - 1 ? 0.f : pv"))],
    # one 32-row query tile missing from every key block's dk/dv
    "dkv_drops_query_tile_2": [(_DKV_DS, "        if (it == 2) pv = 0.f;\n"
                                + _DKV_DS)],
    # the last 32 queries missing from every key block's dk/dv
    "dkv_drops_last_query_tile": [(
        _DKV_DS, "        if (it == total - 1) pv = 0.f;\n" + _DKV_DS)],
    # Faults confined to late rows, whose gradients are small: 16 of 1024+
    # keys missing from query rows past 1023, and 32 of 1024- queries from
    # keys past 1023.
    "dq_drops_key_tile_2_past_row_1023": [(_DQ_DS, _DQ_DS.replace(
        "= pv", "= tile == 2 && q0 >= 1024 ? 0.f : pv"))],
    "dkv_drops_query_tile_2_past_key_1023": [(
        _DKV_DS, "        if (it == 2 && k0 >= 1024) pv = 0.f;\n" + _DKV_DS)],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def sweep_variants() -> dict[str, list[tuple[str, str]]]:
    """The shipped tiles, then both streamed tiles at 16, 32 and 64 rows."""
    variants = {"shipped": []}
    for n in (16, 32, 64):
        variants[f"tiles{n}"] = [
            (f"static constexpr int {k} = {v};",
             f"static constexpr int {k} = {n};")
            for k, v in SHIPPED_TILES.items()]
    return variants


def substitute(text: str, name: str, subs) -> str:
    """``text`` with each (old, new) of ``subs`` applied; each old text
    must occur exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in flash_bwd.cu")
        text = text.replace(old, new)
    return text


def build_variants(kernels, variants: dict) -> dict[str, tuple[str, str]]:
    """Compile one copy of flash_bwd.cu per variant (see substitute), all
    nvcc processes at once. Returns name -> (library path, ptxas
    report)."""
    text = (kernels.CSRC / "flash_bwd.cu").read_text()
    out_dir = kernels.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in kernels.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    procs = {}
    for name, subs in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(substitute(text, name, subs))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n"
                               f"{report}")
        built[name] = (str(lib), report)
    return built


def use_library(kernels, lib: str) -> None:
    """Route the wrapper's B2 and B3 launches to the library at ``lib``."""
    dll = ctypes.CDLL(lib)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        _, symbol, argtypes = kernels.KERNELS[name]
        fn = getattr(dll, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        kernels._functions[name] = fn


def bf16_registers(report: str) -> dict[str, dict[str, int]]:
    return {n: f for n, f in chip_smoke.ptxas_kernels(report).items()
            if n in chip_smoke.BWD_INSTANCES and "_bf16" in n}


class Shape:
    """One timing shape's inputs from ``gen``, B1's out/lse, and the plain
    version's gradients (computed once)."""

    def __init__(self, torch, attention, gen, b, t, h, d):
        self.q, self.k, self.v, self.do = (
            torch.randn(b, t, h, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4))
        self.scale = d ** -0.5
        self.out, self.lse = attention._flash_attention_cuda(
            self.q, self.k, self.v, causal=True, scale=self.scale)
        self.want = attention._flash_bwd_plain(*self.args(), causal=True,
                                               scale=self.scale)

    def args(self):
        return self.q, self.k, self.v, self.out, self.lse, self.do

    def errors(self, torch, attention) -> dict:
        got = attention._flash_bwd_cuda(*self.args(), causal=True,
                                        scale=self.scale)
        return chip_smoke.bwd_errors(torch, got, self.want)


def verdict(errs: dict) -> dict[str, bool]:
    """Whether each of chip_smoke's checks passes these readings."""
    tol = chip_smoke.TOL[("flash_bwd", "torch.bfloat16")]
    return {
        "max_abs": all(e["max_abs_err"] <= tol * max(1.0, e["max_want"])
                       for e in errs.values()),
        "row": all(e["row_err"] <= chip_smoke.ROW_TOL
                   for e in errs.values()),
    }


def sweep(torch, kernels, attention, shapes) -> bool:
    variants = sweep_variants()
    built = build_variants(kernels, variants)
    ok = True
    for name in [*variants, "shipped"]:
        lib, report = built[name]
        use_library(kernels, lib)
        tiles = (dict(SHIPPED_TILES) if name == "shipped"
                 else dict.fromkeys(SHIPPED_TILES, int(name[5:])))
        row = {"variant": name, "tiles": tiles,
               "ptxas": bf16_registers(report)}
        for tag, s in shapes.items():
            errs = s.errors(torch, attention)
            ok &= all(verdict(errs).values())
            dq_ms, dkv_ms = chip_smoke.time_bwd_kernels(torch, attention,
                                                        *s.args())
            row[tag] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms,
                        "checks": verdict(errs)}
        log("sweep: " + json.dumps(row))
    return ok


def controls(torch, kernels, attention, shapes) -> bool:
    built = build_variants(kernels, {"shipped": [], **CONTROLS})
    ok = True
    for name, (lib, _) in built.items():
        use_library(kernels, lib)
        row = {"variant": name}
        for tag, s in shapes.items():
            errs = s.errors(torch, attention)
            passed = verdict(errs)
            row[tag] = {"errors": errs, "passes": passed}
            if name == "shipped":
                ok &= all(passed.values())
            else:
                ok &= not all(passed.values())
        log("controls: " + json.dumps(row))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("study", choices=("sweep", "controls"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_study: CUDA is not available", file=sys.stderr)
        return 1
    from tony_tpu_torch import kernels
    from tony_tpu_torch.ops import attention

    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{chip_smoke.card_line()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    shapes = {tag: Shape(torch, attention, gen, *dims)
              for tag, dims in SHAPES.items()}
    study = sweep if args.study == "sweep" else controls
    ok = study(torch, kernels, attention, shapes)
    log(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
