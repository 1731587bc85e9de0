"""The toy family's plain reference, fp32 on the device it is given:
RMSNorm, RoPE over interleaved pairs, causal grouped-query attention
written out as a masked softmax, SwiGLU, untied head, mean next-token
cross-entropy; the global-norm clip, then ``torch.optim.AdamW`` with the
configuration's settings. It imports nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.lib import weights

EPS = 1e-6  # the port's RMSNorm epsilon


def _norm(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w


def _rotate(x, base: float):
    """x [B, T, H, D]: each pair (x[2i], x[2i+1]) turned by t / base^(2i/D)."""
    t, dim = x.shape[1], x.shape[-1]
    freq = base ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=x.device) / dim)
    angle = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = angle.cos()[None, :, None], angle.sin()[None, :, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack((even * cos - odd * sin, even * sin + odd * cos),
                       -1).flatten(-2)


def loss(s, p, tokens):
    x = p["embed"][tokens[:, :-1]]
    t = x.shape[1]
    hidden = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    share = s.query_heads // s.kv_groups
    lay = p["layers"]
    for i in range(s.depth):
        h = _norm(x, lay["ln1"][i])
        q = _rotate(torch.einsum("btd,dhk->bthk", h, lay["wq"][i]),
                    s.rotary_base)
        k = _rotate(torch.einsum("btd,dhk->bthk", h, lay["wk"][i]),
                    s.rotary_base).repeat_interleave(share, 2)
        v = torch.einsum("btd,dhk->bthk", h, lay["wv"][i]) \
            .repeat_interleave(share, 2)
        score = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(s.head_width)
        prob = score.masked_fill(hidden, float("-inf")).softmax(-1)
        o = torch.einsum("bhqs,bshk->bqhk", prob, v)
        x = x + torch.einsum("bthk,hkd->btd", o, lay["wo"][i])
        h = _norm(x, lay["ln2"][i])
        x = x + (F.silu(h @ lay["w_gate"][i]) * (h @ lay["w_up"][i])) \
            @ lay["w_down"][i]
    logits = _norm(x, p["final_norm"]) @ p["unembed"]
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())


def train(s, seed: int, batches, device, *, precision: str = "fp32") -> dict:
    """The readings ``lib/compare.py`` compares, as the Mistral family's
    reference gives them."""
    if precision != "fp32":
        raise ValueError(f"the toy reference has no {precision!r} control")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = weights.draw(s, seed, device)
    items = weights.leaf_items(params)
    leaves = [p.requires_grad_(True) for _, p in items]
    opt = torch.optim.AdamW(leaves, lr=s.lr, betas=(s.beta1, s.beta2),
                            eps=s.adam_eps, weight_decay=s.weight_decay,
                            foreach=False)
    losses, first = [], None
    for tokens in batches:
        value = loss(s, params, torch.as_tensor(tokens, device=device))
        opt.zero_grad()
        value.backward()
        losses.append(float(value.detach()))
        with torch.no_grad():
            total = torch.stack([p.grad.norm() for p in leaves]).norm()
            for p in leaves:
                p.grad.mul_(torch.clamp(s.grad_clip / total, max=1.0))
            if first is None:
                first = {path: float(p.grad.norm()) for path, p in items}
        opt.step()
    change = weights.change_norms(s, seed, params)
    return {"loss": losses, "grad": first,
            "change": {k: float(v) for k, v in change.items()}}
