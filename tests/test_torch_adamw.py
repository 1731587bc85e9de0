"""The train step's optimizer on the CPU: ``torch.optim.AdamW(fused=True)``
with optax's global-norm clip folded into its ``grad_scale``
(``models.train.clip_scale``), one pass over the parameters, held against
the composition it replaced, the clip written out as two foreach rescales
and then the default foreach ``torch.optim.AdamW.step()``, over three steps
(parameters, both moments and the clipped ``.grad``); then the optimizer
contract the train step's callers rely on: the optimizer is AdamW with
AdamW's own step, a step pre-hook runs before the in-place update (the
checkpoint's ordering), and the JAX state layout round-trips through
``interop``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tony_tpu_torch import interop
from tony_tpu_torch.models import TransformerConfig, make_train_step
from tony_tpu_torch.models.train import clip_scale, leaves

torch.set_num_threads(1)

HYPER = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)
MAX_NORM = 0.7  # not 1: a clip that forgets to multiply by it shows
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=8, d_ff=64, max_seq=16, dtype="float32")


def _reference_clip_(grads: list[torch.Tensor], max_norm: float,
                     norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm as the train step composed it before:
    (g / norm) * max_norm unless norm < max_norm, a NaN norm clipping."""
    clip = ~(norm < max_norm)
    one = torch.ones((), dtype=norm.dtype)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))


# name -> (leaf sizes, the gradients' global norm relative to MAX_NORM
# (None: as drawn), a NaN planted, norms handed in per piece as a mesh's)
CASES = {
    "clip bites": ([(6, 8), (8,), (3, 4, 4)], 5.0, False, False),
    "clip idle": ([(6, 8), (8,), (3, 4, 4)], 0.5, False, False),
    "nan norm": ([(6, 8), (8,)], None, True, False),
    "ragged leaves": ([(7,), (1,), (13,), (3, 5), (2, 3, 3), (4,)], 3.0,
                      False, False),
    "mesh norms": ([(6, 8), (10,), (5, 3)], 2.0, False, True),
}


def _grads(rng, sizes, scale, nan):
    grads = [rng.normal(size=s).astype(np.float32) for s in sizes]
    if scale is not None:
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in grads))
        grads = [g * np.float32(scale * MAX_NORM / norm) for g in grads]
    if nan:
        grads[0].flat[3] = np.nan
    return grads


def _piece_norms(grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each leaf's norm from the norms of its two halves, as the mesh
    path's all-reduce of squared block norms gives it."""
    out = []
    for g in grads:
        flat = g.reshape(-1)
        half = flat.numel() // 2
        blocks = torch.stack([flat[:half].norm(), flat[half:].norm()])
        out.append((blocks * blocks).sum().sqrt())
    return out


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_pass_matches_clip_then_adamw(case):
    sizes, scale, nan, mesh = CASES[case]
    rng = np.random.default_rng(11)
    init = [rng.normal(size=s).astype(np.float32) for s in sizes]
    ref = [torch.tensor(x, requires_grad=True) for x in init]
    got = [torch.tensor(x, requires_grad=True) for x in init]
    ref_opt = torch.optim.AdamW(ref, **HYPER)
    opt = torch.optim.AdamW(got, **HYPER, fused=True)
    for _ in range(3):
        grads = _grads(rng, sizes, scale, nan)
        for p, q, g in zip(ref, got, grads):
            p.grad = torch.from_numpy(g.copy())
            q.grad = torch.from_numpy(g.copy())
        ref_grads = [p.grad for p in ref]
        _reference_clip_(ref_grads, MAX_NORM, _global_norm(ref_grads))
        ref_opt.step()
        got_grads = [q.grad for q in got]
        opt.grad_scale = clip_scale(
            got_grads, MAX_NORM,
            leaf_norms=_piece_norms(got_grads) if mesh else None)
        opt.step()
        # The fused step divides by norm / max_norm where the composition
        # divided by the norm and multiplied by max_norm: the clipped
        # gradients differ by an ulp, and a moment that the steps' signs
        # cancel to near 0 keeps that gap, so each array is held within
        # 1e-6 of its largest value as well as of each element.
        for p, q in zip(ref, got):
            want, have = ref_opt.state[p], opt.state[q]
            assert float(have["step"]) == float(want["step"])
            for a, b in ((q, p), (q.grad, p.grad),
                         (have["exp_avg"], want["exp_avg"]),
                         (have["exp_avg_sq"], want["exp_avg_sq"])):
                top = float(b.detach().nan_to_num().abs().max())
                torch.testing.assert_close(a.detach(), b.detach(),
                                           rtol=1e-6, atol=1e-6 * top,
                                           equal_nan=nan)
    if nan:
        assert all(torch.isnan(q).all() for q in got)
    elif scale is not None and scale > 1:
        # The clipped gradients are left in .grad: their norm is the limit.
        norm = _global_norm([q.grad for q in got])
        assert abs(float(norm) - MAX_NORM) < 1e-5


def _train(seed=0):
    init_fn, step_fn = make_train_step(TransformerConfig(**TINY),
                                       device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (2, TINY["max_seq"] + 1))
    return init_fn, step_fn, tokens


def test_the_train_step_s_optimizer_is_a_fused_adamw():
    """AdamW with AdamW's own step, so whatever stands in for that step
    (a planted fault) stands in for the train step's update."""
    init_fn, step_fn, tokens = _train()
    state = init_fn(0)
    opt = state.opt_state
    assert type(opt) is torch.optim.AdamW
    assert opt.param_groups[0]["fused"]
    state, _ = step_fn(state, tokens)
    for p in leaves(state.params):
        assert set(opt.state[p]) == {"step", "exp_avg", "exp_avg_sq"}
        assert float(opt.state[p]["step"]) == 1.0


def test_a_step_pre_hook_runs_before_the_update():
    """The checkpoint's snapshot orders the next in-place update after its
    copies with a step pre-hook (``CheckpointManager._wait_before_update``):
    the hook must see the weights and moments as they were."""
    init_fn, step_fn, tokens = _train()
    state, _ = step_fn(init_fn(0), tokens)
    opt = state.opt_state
    before = [p.detach().clone() for p in leaves(state.params)]
    moments = [opt.state[p]["exp_avg"].clone()
               for p in leaves(state.params)]
    seen = {}

    def hook(optimizer, args, kwargs):
        seen["params"] = [p.detach().clone() for p in leaves(state.params)]
        seen["moments"] = [optimizer.state[p]["exp_avg"].clone()
                           for p in leaves(state.params)]
        handle.remove()

    handle = opt.register_step_pre_hook(hook)
    state, _ = step_fn(state, tokens)
    assert all(torch.equal(a, b) for a, b in zip(seen["params"], before))
    assert all(torch.equal(a, b) for a, b in zip(seen["moments"], moments))
    assert not any(torch.equal(p.detach(), b)
                   for p, b in zip(leaves(state.params), before))


def test_interop_round_trips_the_state_after_a_step():
    init_fn, step_fn, tokens = _train()
    state, _ = step_fn(init_fn(0), tokens)
    flat = interop.train_state_to_numpy(state)
    count = interop.ADAM_STATE_PATHS[torch.optim.AdamW] + ".count"
    assert int(flat[count]) == 1
    other = interop.train_state_from_numpy(flat, init_fn(5))
    back = interop.train_state_to_numpy(other)
    assert list(back) == list(flat)
    for path in flat:
        np.testing.assert_array_equal(back[path], flat[path], err_msg=path)
    # The loaded state steps on exactly as the one it came from.
    state, _ = step_fn(state, tokens)
    other, _ = step_fn(other, tokens)
    for a, b in zip(leaves(state.params), leaves(other.params)):
        assert torch.equal(a, b)
    assert int(interop.train_state_to_numpy(other)[count]) == 2
