"""The plain reference of the Mistral family's train step
(``families/mistral.py``): the decoder (RMSNorm, RoPE over interleaved
pairs, causal GQA attention, SwiGLU or the capacity-based top-k MoE
layer), next-token cross-entropy plus the router's balance and z losses,
the global-norm clip and AdamW, in plain PyTorch at fp32 with TF32 off.
It imports nothing of the program and takes only the benchmark's weights
and batches.

Each layer runs under ``torch.utils.checkpoint`` and the loss in blocks
of rows, so that three steps of a full-width configuration fit on one
card beside their AdamW state. ``precision="fp8"`` is the control: the
same step with every matrix product's operands, and attention's q, k, v,
rounded to float8 (e4m3 forward, e5m2 for the cotangents), one scale a
tensor, the step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.lib import weights
from perfbench.lib.shape import Shape

LOSS_ROWS = 8192  # rows of the loss a block


def exact_fp32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Round8(torch.autograd.Function):
    """x rounded to e4m3; its cotangent rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Ref:
    """The reference at one precision ("fp32" or the "fp8" control)."""

    def __init__(self, s: Shape, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.s = s
        self.low = precision == "fp8"

    def r(self, x):
        return _Round8.apply(x) if self.low else x

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def norm(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.s.eps) * w

    def rope(self, x):
        b, t, h, dh = x.shape
        inv = 1.0 / (self.s.theta ** (torch.arange(
            0, dh, 2, dtype=torch.float32, device=x.device) / dh))
        ang = torch.outer(torch.arange(t, dtype=torch.float32,
                                       device=x.device), inv)
        c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                           dim=-1).reshape(b, t, h, dh)

    def attention(self, x, lp):
        s = self.s
        b, t, d = x.shape
        h = self.norm(x, lp["ln1"])
        q = self.mm(h, lp["wq"].reshape(d, -1)).view(b, t, s.heads,
                                                     s.head_dim)
        k = self.mm(h, lp["wk"].reshape(d, -1)).view(b, t, s.kv_heads,
                                                     s.head_dim)
        v = self.mm(h, lp["wv"].reshape(d, -1)).view(b, t, s.kv_heads,
                                                     s.head_dim)
        q, k = self.rope(q), self.rope(k)
        group = s.heads // s.kv_heads
        q, k, v = (self.r(z).transpose(1, 2) for z in (q, k, v))
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        o = _sdpa(q, k, v).transpose(1, 2).reshape(b, t, -1)
        return self.mm(o, lp["wo"].reshape(-1, d))

    def swiglu(self, h, w_gate, w_up, w_down):
        return self.mm(F.silu(self.mm(h, w_gate)) * self.mm(h, w_up), w_down)

    def moe(self, x, lp):
        """The capacity-based top-k layer: softmax router, the top k
        renormalised, max(1, int(cf * tokens * k / E)) slots an expert
        filled in (choice, token) order, every first choice before any
        second, the rest dropped. Returns (out, balance, z-loss)."""
        s = self.s
        b, t, d = x.shape
        h = self.norm(x, lp["ln2"]).reshape(-1, d)
        e, k, n = s.experts, s.top_k, b * t
        logits = h @ lp["router"]
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True) \
            .clamp_min(1e-9)
        choice = idx[:, :k].t().reshape(-1)        # first choices first
        onehot = F.one_hot(choice, e)              # [k n, E]
        before = onehot.cumsum(0) - onehot
        pos = before.gather(1, choice[:, None])[:, 0]
        keep = pos < max(1, int(s.capacity_factor * n * k / e))
        token = torch.arange(n, device=x.device).repeat(k)
        gate = gates.t().reshape(-1)
        out = torch.zeros_like(h)
        for j in range(e):
            sel = keep & (choice == j)
            rows = token[sel]
            y = self.swiglu(h[rows], lp["w_gate"][j], lp["w_up"][j],
                            lp["w_down"][j])
            out = out.index_add(0, rows, y * gate[sel][:, None])
        balance = e * (onehot.float().mean(0) * probs.mean(0)).sum()
        z = torch.logsumexp(logits, dim=-1).square().mean()
        return out.view(b, t, d), balance, z

    def layer(self, x, lp):
        x = x + self.attention(x, lp)
        if self.s.experts:
            out, balance, z = self.moe(x, lp)
            return x + out, balance, z
        h = self.norm(x, lp["ln2"])
        out = self.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        zero = x.new_zeros(())
        return x + out, zero, zero

    def head_nll(self, x, final_norm, unembed, labels):
        logits = self.mm(self.norm(x, final_norm), unembed)
        return F.cross_entropy(logits, labels, reduction="sum")

    def loss(self, params, tokens):
        """Mean next-token cross-entropy of tokens [B, T+1], plus the
        router losses' layer means times their coefficients."""
        s = self.s
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        x = params["embed"][inputs]
        balances, zs = [], []
        # unbind, not indexing: one stacked gradient a leaf, not a
        # full-size zero tensor a layer.
        slices = {name: w.unbind(0) for name, w in params["layers"].items()}
        for i in range(s.layers):
            lp = {name: w[i] for name, w in slices.items()}
            x, balance, z = checkpoint(self.layer, x, lp,
                                       use_reentrant=False)
            balances.append(balance)
            zs.append(z)
        flat, lab = x.reshape(-1, s.d), labels.reshape(-1)
        nll = x.new_zeros(())
        for r in range(0, flat.shape[0], LOSS_ROWS):
            nll = nll + checkpoint(self.head_nll, flat[r:r + LOSS_ROWS],
                                   params["final_norm"], params["unembed"],
                                   lab[r:r + LOSS_ROWS], use_reentrant=False)
        total = nll / flat.shape[0]
        if s.experts:
            total = (total + s.balance_coef * torch.stack(balances).mean()
                     + s.zloss_coef * torch.stack(zs).mean())
        return total


def _sdpa(q, k, v):
    """Causal attention in fp32. On the card through the memory-efficient
    backend (the math backend would hold [B, H, T, T]), which computes
    fp32 inputs at fp32 accuracy."""
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def train(s: Shape, seed: int, batches, device, *,
          precision: str = "fp32") -> dict:
    """``len(batches)`` train steps from the seed's weights on ``batches``
    (each [B, T+1] int64). Returns
    {"loss": [per step], "grad": {leaf: ||clipped first gradient||},
    "change": {leaf: ||weights after the steps - initial||}}, floats."""
    exact_fp32()
    ref = Ref(s, precision)
    params = weights.draw(s, seed, device)
    items = weights.leaf_items(params)
    for _, p in items:
        p.requires_grad_(True)
    state = {path: (torch.zeros_like(p), torch.zeros_like(p))
             for path, p in items}
    losses, first = [], None
    for step, tokens in enumerate(batches, start=1):
        tokens = torch.as_tensor(tokens, device=device)
        loss = ref.loss(params, tokens)
        loss.backward()
        losses.append(loss.detach())
        with torch.no_grad():
            norms = torch.stack([p.grad.norm() for _, p in items])
            total = norms.norm()
            scale = torch.where(total < s.grad_clip,
                                torch.ones_like(total), s.grad_clip / total)
            if first is None:
                first = dict(zip([path for path, _ in items],
                                 (norms * scale).unbind()))
            c1 = 1 - s.beta1 ** step
            c2 = 1 - s.beta2 ** step
            for path, p in items:
                g = p.grad * scale
                m, v = state[path]
                m.mul_(s.beta1).add_(g, alpha=1 - s.beta1)
                v.mul_(s.beta2).addcmul_(g, g, value=1 - s.beta2)
                p.mul_(1 - s.lr * s.weight_decay)
                p.sub_(s.lr * (m / c1) / ((v / c2).sqrt() + s.adam_eps))
                p.grad = None
    del state
    change = weights.change_norms(s, seed, params)
    return {"loss": torch.stack(losses).tolist(),
            "grad": {k: float(v) for k, v in first.items()},
            "change": {k: float(v) for k, v in change.items()}}
