"""Rotary position embeddings over interleaved feature pairs
(``x[..., 0::2]``, ``x[..., 1::2]``), as the JAX package rotates them; not
the half-split ``rotate_half`` layout. Plain PyTorch: an elementwise rotation
next to the projections needs no kernel of its own."""

from __future__ import annotations

import functools

import torch

from tony_tpu_torch.device import resolve_device


def rope_frequencies(
    head_dim: int, max_seq: int, *, theta: float = 10000.0, device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_seq, head_dim // 2], fp32, on ``device``."""
    device = resolve_device(device)
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim)
    inv = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


@functools.lru_cache(maxsize=16)
def _rope_tables(head_dim: int, max_seq: int, theta: float,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return rope_frequencies(head_dim, max_seq, theta=theta, device=device)


def cached_rope_frequencies(
    head_dim: int, max_seq: int, *, theta: float = 10000.0, device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_frequencies``, built once per (head_dim, max_seq, theta,
    device) and shared by every later call, so a decode step does not
    rebuild them. Callers must not write into the returned tables."""
    return _rope_tables(int(head_dim), int(max_seq), float(theta),
                        resolve_device(device))


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate pairs of features. x: [B, T, H, D]; cos/sin: [max_seq, D/2];
    ``positions`` ([B, T] or [T]) selects rows of the tables (default
    0..T-1)."""
    b, t, h, d = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    c = cos[positions]  # [T, D/2] or [B, T, D/2]
    s = sin[positions]
    if c.dim() == 2:
        c = c[None]
        s = s[None]
    c = c[:, :, None, :].float()
    s = s[:, :, None, :].float()
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    return torch.stack([r1, r2], dim=-1).reshape(b, t, h, d).to(x.dtype)
