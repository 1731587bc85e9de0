"""Weights from the seed, drawn on the device piece by piece.

Every piece (a leaf of one layer, one expert of an expert leaf, or a
whole unstacked leaf) has a generator of its own, seeded from (seed,
leaf, layer, expert), so any piece can be drawn alone and again: the
program's readings and the reference redraw the initial weights where
they need them instead of keeping a copy. The layout and the scales are
the family's leaf table (``lib/family.py``): dotted paths of any depth,
each leaf split into pieces along its 0, 1 ([L, ...]) or 2 ([L, E, ...])
leading piece axes; fp32, the masters' type.

Where a function takes ``s``, it takes a shape (its family's table is
used) or a leaf table itself.
"""

from __future__ import annotations

import hashlib

import torch

from perfbench.lib import family


def leaf_table(s) -> family.LeafTable:
    """Dotted leaf path -> (global shape, normal scale or 0 for ones,
    piece axes)."""
    return s if isinstance(s, dict) else family.of(s).leaf_table(s)


def _pieces(shape: tuple, axes: int):
    if axes == 0:
        return [((None, None), ())]
    if axes == 1:
        return [((layer, None), (layer,)) for layer in range(shape[0])]
    if axes == 2:
        return [((layer, e), (layer, e)) for layer in range(shape[0])
                for e in range(shape[1])]
    raise ValueError(f"piece axes {axes!r} not 0, 1 or 2")


def pieces(path: str, s):
    """The (layer, expert) index of each piece of a leaf, and the slice of
    the leaf it fills: (None, None) for an unstacked leaf."""
    shape, _, axes = leaf_table(s)[path]
    return _pieces(shape, axes)


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


def draw_leaf(s, seed: int, path: str, device) -> torch.Tensor:
    shape, scale, axes = leaf_table(s)[path]
    leaf = torch.empty(shape, dtype=torch.float32, device=device)
    for (layer, expert), index in _pieces(shape, axes):
        fill_piece(leaf[index], seed, path, layer, expert, scale)
    return leaf


def draw(s, seed: int, device) -> dict:
    """The whole parameter tree, nested dicts in the table's order, fp32
    on ``device``."""
    tree: dict = {}
    for path in leaf_table(s):
        *parents, name = path.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = draw_leaf(s, seed, path, device)
    return tree


def get(tree: dict, path: str):
    node = tree
    for part in path.split("."):
        node = node[part]
    return node


def leaf_items(tree: dict, prefix: str = "") -> list:
    """(dotted path, leaf) of every leaf of a tree of nested dicts, in the
    tree's order."""
    out = []
    for key, val in tree.items():
        if isinstance(val, dict):
            out += leaf_items(val, f"{prefix}{key}.")
        else:
            out.append((f"{prefix}{key}", val))
    return out


def change_norms(s, seed: int, tree: dict) -> dict[str, torch.Tensor]:
    """Per leaf, ||leaf - its initial draw|| as a 0-d fp32 tensor, the
    initial weights drawn again one piece at a time beside the leaf."""
    out = {}
    for path, (shape, scale, axes) in leaf_table(s).items():
        leaf = get(tree, path).detach()
        total = torch.zeros((), dtype=torch.float32, device=leaf.device)
        for (layer, expert), index in _pieces(shape, axes):
            now = leaf[index].float()
            start = fill_piece(torch.empty_like(now), seed, path, layer,
                               expert, scale)
            total += (now - start).square().sum()
        out[path] = total.sqrt()
    return out
