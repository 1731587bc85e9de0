#!/usr/bin/env python3
"""How far bf16 causal attention's gradients lie from exact ones, row by row,
for the chain of the flash kernels (B1, then B2/B3) and for the chain of
their plain versions, at the sequence lengths of the sp path.

    python3 attention_chain_study.py

On one card: q/k/v/dO [1, T, 8, 128] bf16 from a seeded generator (K/V heads
8 and 2), T = 2048, 8192 and 16384. For out, dq, dk and dv it prints the row
error (chip_smoke.row_error: the worst ||got_r - want_r|| over max(||want_r||,
ROW_FLOOR x the RMS row norm)), the row and head where it is worst, and the
worst by band of positions, for:

- kernel_vs_plain: B1 then B2/B3 against the plain forward then the plain
  backward, each chain from its own bf16 out and lse;
- kernel_vs_truth, plain_vs_truth: each chain against fp64 attention and
  gradients computed from the same bf16 inputs with no rounding between;
- bwdkernel_on_plain_fwd_vs_plain: B2/B3 fed the plain forward's out and
  lse, against the plain backward on those same inputs.

A chain's dq at the first rows takes delta = rowsum(dO * out) from its own
bf16-rounded out, and there the gradient is a difference of nearly equal
terms; so two chains can differ there by more than chip_smoke's ROW_TOL
while each kernel, on the inputs it is given, agrees with its plain version.
Prints one JSON line per case and the card's name and power limit last.
"""

from __future__ import annotations

import json
import sys

import chip_smoke as cs

LENGTHS = (2048, 8192, 16384)
KV_HEADS = (8, 2)
HEADS, HEAD_DIM = 8, 128
BANDS = ((0, 16), (16, 256), (256, 2048), (2048, None))


def exact(torch, q, k, v, do) -> list:
    """(out, dq, dk, dv) of causal attention in fp64, one head at a time,
    with no rounding between the steps."""
    b, t, h, d = q.shape
    group = h // k.shape[2]
    k, v = (x.repeat_interleave(group, 2) for x in (k, v))
    scale = d ** -0.5
    res = [torch.empty(b, t, h, d, dtype=torch.float64, device="cuda")
           for _ in range(4)]
    visible = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    for head in range(h):
        qh, kh, vh, dh = (x[0, :, head].double() for x in (q, k, v, do))
        s = ((qh @ kh.T) * scale).masked_fill(~visible, float("-inf"))
        p = torch.softmax(s, -1)
        del s
        o = p @ vh
        ds = p * (dh @ vh.T - (dh * o).sum(-1, keepdim=True))
        res[0][0, :, head] = o
        res[1][0, :, head] = ds @ kh * scale
        res[2][0, :, head] = ds.T @ qh * scale
        res[3][0, :, head] = p.T @ dh
        del p, ds
    if group > 1:
        for i in (2, 3):
            res[i] = res[i].reshape(b, t, h // group, group, d).sum(3)
    return res


def row_profile(got, want) -> dict:
    """The row error of ``got`` against ``want`` ([B, T, H, D]), where it
    is worst, and its worst in each band of positions."""
    diff_norm = (got.double() - want.double()).norm(dim=-1)
    want_norm = want.double().norm(dim=-1)
    floor = cs.ROW_FLOOR * want_norm.square().mean().sqrt()
    err = diff_norm / want_norm.clamp(min=floor)
    t, h = err.shape[1], err.shape[2]
    at = int(err.flatten().argmax())
    bands = {f"{lo}-{min(hi or t, t)}": float(err[:, lo:hi].max())
             for lo, hi in BANDS if lo < t}
    return {"row_err": float(err.max()), "worst_pos": (at // h) % t,
            "worst_head": at % h,
            "worst_want_norm": float(want_norm.flatten()[at]),
            "floor": float(floor), "bands": bands}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_chain_study: CUDA is not available; this script "
              "runs on the card only", file=sys.stderr)
        return 1
    from tony_tpu_torch import kernels
    from tony_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    scale = HEAD_DIM ** -0.5
    for t in LENGTHS:
        for h_kv in KV_HEADS:
            q, do = (torch.randn(1, t, HEADS, HEAD_DIM, generator=gen,
                                 device="cuda").bfloat16() for _ in range(2))
            k, v = (torch.randn(1, t, h_kv, HEAD_DIM, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            out_p, lse_p = attention._flash_plain_bthd(q, k, v, causal=True,
                                                       scale=scale)
            plain = (out_p, *attention._flash_bwd_plain(
                q, k, v, out_p, lse_p, do, causal=True, scale=scale))
            chain = cs._attention_grads(torch, lambda q, k, v: (
                attention.flash_attention(q, k, v, causal=True)), q, k, v,
                do)
            bwd_on_plain = attention._flash_bwd_cuda(
                q, k, v, out_p, lse_p, do, causal=True, scale=scale)
            truth = exact(torch, q, k, v, do)
            res = {"t": t, "h_kv": h_kv}
            for i, name in enumerate(("out", "dq", "dk", "dv")):
                res[name] = {
                    "kernel_vs_plain": row_profile(chain[i], plain[i]),
                    "kernel_vs_truth": row_profile(chain[i], truth[i]),
                    "plain_vs_truth": row_profile(plain[i], truth[i])}
                if i:
                    res[name]["bwdkernel_on_plain_fwd_vs_plain"] = (
                        row_profile(bwd_on_plain[i - 1], plain[i]))
            print(json.dumps(res), flush=True)
            del plain, chain, bwd_on_plain, truth
            torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
