#!/usr/bin/env python3
"""Tile sweeps and fault controls of the bf16 flash kernels of
tony_tpu_torch on one NVIDIA card: the backward (B2 dq, B3 dk/dv) and the
forward (B1).

    python3 flash_bwd_study.py sweep         # B2/B3 streamed-tile sizes
    python3 flash_bwd_study.py controls      # broken B2/B3 vs chip_smoke
    python3 flash_bwd_study.py fwd-sweep     # B1 query and key tile sizes
    python3 flash_bwd_study.py fwd-controls  # broken B1 vs chip_smoke

Each compiles variants of tony_tpu_torch/csrc/flash_bwd.cu (or, for the
fwd- studies, flash_fwd.cu), each made by text substitution in a copy under
tony_tpu_torch/_build/study/ (the source itself is never edited), loads
each in place of the built library and drives it through the port's
wrapper (``_flash_bwd_cuda`` or ``_flash_attention_cuda``) at
chip_smoke.py's two timing shapes, q/k/v [8, 2048, 16, 64] and
[8, 2048, 8, 128], bf16, causal.

sweep: B2's streamed key tile (DqBf16::kN) and B3's streamed query tile
(DkvBf16::kM) at 16, 32 and 64 rows. fwd-sweep: B1's query rows per block
(FwdBf16::kM: 64 or 128, 16 or 32 rows per warp) and keys per streamed tile
(FwdBf16::kN: 32, 64 or 128). For each variant: ptxas's registers and spill
bytes of the bf16 kernels (fwd-sweep lists the instances that spill, which
rejects the variant at that head_dim), chip_smoke's checks against the
plain version, and the device ms of the kernels at both shapes. The
shipped sizes run first and last, so the spread between them shows the
drift.

controls / fwd-controls: copies that each drop the contribution of one
streamed tile, a fault of the kind a broken double buffer or loop bound
makes. For each, the readings of chip_smoke's checks at both shapes (B2/B3:
max abs error against TOL times the largest |gradient|, row error against
ROW_TOL; B1: max abs error of out and of lse against TOL, row error of out
against ROW_TOL) and which one caught it. Exits non-zero if chip_smoke's
checks pass a control, or if the shipped copy fails one.
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
# B1's shipped tiles: the right-hand sides in FwdBf16 (query rows per
# block, keys per streamed tile).
SHIPPED_FWD_TILES = {"kM": "D == 64 ? 128 : 64", "kN": "64"}
SHAPES = {"train": (8, 2048, 16, 64), "hd128": (8, 2048, 8, 128)}
BWD_ENTRY_POINTS = ("flash_bwd_dq", "flash_bwd_dkv")

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


# Each forward control: (old, new) substitutions in flash_fwd.cu, dropping
# p (so from both l and O) for the keys of one streamed tile; "tile" counts
# the key tiles of one B1 block, whose query rows start at q0.
_FWD_P = ("          const float pv = exp2f(fmaf(s[mt][n][e], scale_log2, "
          "neg[e >> 1]));")
FWD_CONTROLS = {
    "fwd_drops_key_tile_2": [(_FWD_P, _FWD_P.replace(
        "= exp2f", "= tile == 2 ? 0.f : exp2f"))],
    # the keys nearest each query tile's diagonal missing
    "fwd_drops_last_key_tile": [(_FWD_P, _FWD_P.replace(
        "= exp2f", "= tile == n_tiles - 1 ? 0.f : exp2f"))],
    # a fault confined to late rows, whose outputs are small
    "fwd_drops_key_tile_2_past_row_1023": [(_FWD_P, _FWD_P.replace(
        "= exp2f", "= tile == 2 && q0 >= 1024 ? 0.f : exp2f"))],
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


def fwd_sweep_variants() -> dict[str, list[tuple[str, str]]]:
    """The shipped tiles, then B1's query rows per block (64, 128) by keys
    per streamed tile (32, 64, 128), both head_dims alike."""
    variants = {"shipped": []}
    for m in (64, 128):
        for n in (32, 64, 128):
            variants[f"m{m}_n{n}"] = [
                (f"static constexpr int {k} = {SHIPPED_FWD_TILES[k]};",
                 f"static constexpr int {k} = {v};")
                for k, v in (("kM", m), ("kN", n))]
    return variants


def substitute(text: str, name: str, subs,
               source: str = "flash_bwd.cu") -> str:
    """``text`` (of ``source``) with each (old, new) of ``subs`` applied;
    each old text must occur exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {source}")
        text = text.replace(old, new)
    return text


def build_variants(kernels, variants: dict, source: str = "flash_bwd.cu"
                   ) -> dict[str, tuple[str, str]]:
    """Compile one copy of ``source`` per variant (see substitute), all
    nvcc processes at once. Returns name -> (library path, ptxas
    report)."""
    text = (kernels.CSRC / source).read_text()
    out_dir = kernels.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in kernels.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    procs = {}
    for name, subs in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(substitute(text, name, subs, source))
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


def use_library(kernels, lib: str, names=BWD_ENTRY_POINTS) -> None:
    """Route the wrapper's launches of the entry points ``names`` (default
    B2 and B3) to the library at ``lib``."""
    dll = ctypes.CDLL(lib)
    for name in names:
        _, symbol, argtypes = kernels.KERNELS[name]
        fn = getattr(dll, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        kernels._functions[name] = fn


def bf16_registers(report: str, instances=chip_smoke.BWD_INSTANCES
                   ) -> dict[str, dict[str, int]]:
    return {n: f for n, f in chip_smoke.ptxas_kernels(report).items()
            if n in instances and "_bf16" in n}


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


class FwdShape:
    """One timing shape's q/k/v from ``gen`` and the plain version's
    (out, lse), computed once."""

    def __init__(self, torch, attention, gen, b, t, h, d):
        self.q, self.k, self.v = (
            torch.randn(b, t, h, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(3))
        self.scale = d ** -0.5
        self.want = attention._flash_plain_bthd(self.q, self.k, self.v,
                                                causal=True,
                                                scale=self.scale)

    def run(self, attention):
        return attention._flash_attention_cuda(self.q, self.k, self.v,
                                               causal=True, scale=self.scale)

    def errors(self, attention) -> dict:
        return chip_smoke.fwd_errors(self.run(attention), self.want)

    def checks(self, errs: dict) -> dict[str, bool]:
        """Whether each of chip_smoke's B1 checks at this shape passes."""
        return chip_smoke.fwd_checks(errs, self.q.dtype, rows=True)

    def ms(self, torch, attention) -> float:
        return chip_smoke.device_ms(torch, lambda: self.run(attention), 10)


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


def fwd_sweep(torch, kernels, attention, shapes) -> bool:
    variants = fwd_sweep_variants()
    built = build_variants(kernels, variants, "flash_fwd.cu")
    ok = True
    for name in [*variants, "shipped"]:
        lib, report = built[name]
        use_library(kernels, lib, ("flash_fwd",))
        ptxas = bf16_registers(report, chip_smoke.FWD_INSTANCES)
        # A variant is rejected at a head_dim where its instance spills.
        row = {"variant": name, "ptxas": ptxas,
               "rejected": sorted(n for n, f in ptxas.items()
                                  if f["spill_bytes"])}
        for tag, s in shapes.items():
            checks = s.checks(s.errors(attention))
            ok &= all(checks.values())
            row[tag] = {"ms": s.ms(torch, attention), "checks": checks}
        log("fwd-sweep: " + json.dumps(row))
    return ok


def fwd_controls(torch, kernels, attention, shapes) -> bool:
    built = build_variants(kernels, {"shipped": [], **FWD_CONTROLS},
                           "flash_fwd.cu")
    ok = True
    for name, (lib, _) in built.items():
        use_library(kernels, lib, ("flash_fwd",))
        row = {"variant": name}
        for tag, s in shapes.items():
            errs = s.errors(attention)
            passed = s.checks(errs)
            row[tag] = {"errors": errs, "passes": passed}
            if name == "shipped":
                ok &= all(passed.values())
            else:
                ok &= not all(passed.values())
        log("fwd-controls: " + json.dumps(row))
    return ok


STUDIES = {"sweep": sweep, "controls": controls, "fwd-sweep": fwd_sweep,
           "fwd-controls": fwd_controls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("study", choices=tuple(STUDIES))
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
    shape = FwdShape if args.study.startswith("fwd-") else Shape
    shapes = {tag: shape(torch, attention, gen, *dims)
              for tag, dims in SHAPES.items()}
    ok = STUDIES[args.study](torch, kernels, attention, shapes)
    log(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
