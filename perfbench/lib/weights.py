"""Weights from the seed, drawn on the device piece by piece.

Every piece (a leaf of one layer, one expert of an expert leaf, or a
whole unstacked leaf) has a generator of its own, seeded from (seed,
leaf, layer, expert), so any piece can be drawn alone and again: the
program's readings and the reference redraw the initial weights where
they need them instead of keeping a copy. The layout is the port's
parameter tree (per-layer leaves stacked on a leading layer axis, expert
leaves [L, E, ...]) and the scales are its initial ones; fp32, the
masters' type.
"""

from __future__ import annotations

import hashlib

import torch

from perfbench.lib.shape import Shape

# The leaves whose pieces are ones (RMSNorm weights).
ONES = frozenset({"ln1", "ln2", "final_norm"})


def leaf_table(s: Shape) -> dict[str, tuple[tuple[int, ...], float]]:
    """Dotted leaf path -> (global shape, normal scale; 0 for ones)."""
    d, h, kv, dh, f, n = s.d, s.heads, s.kv_heads, s.head_dim, s.ff, s.layers
    t = {
        "embed": ((s.vocab, d), 1.0),
        "final_norm": ((d,), 0.0),
        "unembed": ((d, s.vocab), d ** -0.5),
        "layers.ln1": ((n, d), 0.0),
        "layers.ln2": ((n, d), 0.0),
        "layers.wq": ((n, d, h, dh), d ** -0.5),
        "layers.wk": ((n, d, kv, dh), d ** -0.5),
        "layers.wv": ((n, d, kv, dh), d ** -0.5),
        "layers.wo": ((n, h, dh, d), (h * dh) ** -0.5),
    }
    if s.experts:
        e = s.experts
        t["layers.router"] = ((n, d, e), d ** -0.5)
        t["layers.w_gate"] = ((n, e, d, f), d ** -0.5)
        t["layers.w_up"] = ((n, e, d, f), d ** -0.5)
        t["layers.w_down"] = ((n, e, f, d), f ** -0.5)
    else:
        t["layers.w_gate"] = ((n, d, f), d ** -0.5)
        t["layers.w_up"] = ((n, d, f), d ** -0.5)
        t["layers.w_down"] = ((n, f, d), f ** -0.5)
    return t


def is_expert_leaf(path: str, s: Shape) -> bool:
    return bool(s.experts) and path in ("layers.w_gate", "layers.w_up",
                                        "layers.w_down")


def pieces(path: str, s: Shape):
    """The (layer, expert) index of each piece of a leaf, and the slice of
    the leaf it fills: (None, None) for an unstacked leaf."""
    if not path.startswith("layers."):
        return [((None, None), ())]
    out = []
    for layer in range(s.layers):
        if is_expert_leaf(path, s):
            out += [((layer, e), (layer, e)) for e in range(s.experts)]
        else:
            out.append(((layer, None), (layer,)))
    return out


def piece_seed(seed: int, path: str, layer, expert) -> int:
    blob = f"{int(seed)}/{path}/{layer}/{expert}".encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "little") >> 1


def fill_piece(out: torch.Tensor, seed: int, path: str, layer, expert,
               scale: float) -> torch.Tensor:
    """Draw one piece into ``out`` (in place) and return it."""
    if scale == 0.0:
        return out.fill_(1.0)
    gen = torch.Generator(device=out.device)
    gen.manual_seed(piece_seed(seed, path, layer, expert))
    return out.normal_(generator=gen).mul_(scale)


def draw_leaf(s: Shape, seed: int, path: str, device) -> torch.Tensor:
    shape, scale = leaf_table(s)[path]
    leaf = torch.empty(shape, dtype=torch.float32, device=device)
    for (layer, expert), index in pieces(path, s):
        fill_piece(leaf[index], seed, path, layer, expert, scale)
    return leaf


def draw(s: Shape, seed: int, device) -> dict:
    """The whole parameter tree, the port's layout, fp32 on ``device``."""
    tree: dict = {"layers": {}}
    for path in leaf_table(s):
        leaf = draw_leaf(s, seed, path, device)
        if path.startswith("layers."):
            tree["layers"][path.split(".", 1)[1]] = leaf
        else:
            tree[path] = leaf
    return tree


def get(tree: dict, path: str):
    node = tree
    for part in path.split("."):
        node = node[part]
    return node


def change_norms(s: Shape, seed: int, tree: dict) -> dict[str, torch.Tensor]:
    """Per leaf, ||leaf - its initial draw|| as a 0-d fp32 tensor, the
    initial weights drawn again one piece at a time beside the leaf."""
    out = {}
    for path, (_, scale) in leaf_table(s).items():
        leaf = get(tree, path).detach()
        total = torch.zeros((), dtype=torch.float32, device=leaf.device)
        for (layer, expert), index in pieces(path, s):
            now = leaf[index].float()
            start = fill_piece(torch.empty_like(now), seed, path, layer,
                               expert, scale)
            total += (now - start).square().sum()
        out[path] = total.sqrt()
    return out
