"""Weights between the JAX package and the port.

``params_from_numpy`` takes a JAX parameter tree as numpy arrays (what
``jax.device_get`` returns) in either layout the JAX package uses: the raw
training layout of ``init_params`` (``wq``/``wk``/``wv``, ``w_gate``/``w_up``)
or the fused ``decode_weights`` layout (``qkv``, ``gate_up``), dense or MoE
(a router [L, d, E] and expert FFN leaves [L, E, d, F] and [L, E, F, d];
fused, gate_up [L, E, d, 2F]). It checks every
shape against the config and returns the same tree as torch tensors on
``device``, so both packages compute the same function in the tests.
``params_from_npz`` reads such a tree from an ``.npz`` file whose keys are
the tree paths joined by ``/`` (``embed``, ``layers/wq``, ...).
``params_to_numpy`` goes the other way, so trained weights can be compared
with the JAX package's.

The image classifiers' trees (MNIST MLP and CNN, ResNet: dicts and lists
of numpy arrays, HWIO kernels) carry over as they are:
``image_params_from_numpy`` checks every leaf's shape against the config
and ``params_to_numpy`` takes them back.

A whole ``TrainState`` maps onto the JAX package's by path:
``train_state_leaves`` names every leaf of the port's state (step, params,
and the Adam moments' per-parameter ``step``/``exp_avg``/``exp_avg_sq``)
with the ``jax.tree_util.keystr`` path of the matching leaf of the JAX
``TrainState``: for the LM's ``torch.optim.AdamW``, optax's
``chain(clip_by_global_norm, adamw)`` state (one int32 ``count`` and the
``mu``/``nu`` trees under ``.opt_state[1][0]``); for the classifiers'
``torch.optim.Adam``, optax's ``adam`` state (the same under
``.opt_state[0]``). ``train_state_to_numpy`` and ``train_state_from_numpy``
move a state to and from ``{path: array}``; the checkpoint manager writes
and reads the same paths.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.mnist import MnistConfig, mnist_param_shapes
from tony_tpu_torch.models.resnet import ResNetConfig, resnet_param_shapes
from tony_tpu_torch.models.train import TrainState
from tony_tpu_torch.models.transformer import TransformerConfig

STEP_PATH = ".step"
# keystr path of the ScaleByAdamState in the JAX state, by the port's
# optimizer: optax.chain(clip_by_global_norm, adamw) keeps the clip's
# EmptyState first and adamw's chain holds ScaleByAdamState first;
# optax.adam's chain holds it first. AdamW subclasses Adam: the exact type
# decides.
ADAM_STATE_PATHS = {
    torch.optim.AdamW: ".opt_state[1][0]",
    torch.optim.Adam: ".opt_state[0]",
}


def _expected_shapes(cfg: TransformerConfig, fused: bool) -> dict:
    d, h, dh, f, n = (
        cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers,
    )
    hkv = cfg.kv_heads
    # MoE: the FFN leaves gain an expert axis after the layer axis, and a
    # router [L, d, E] joins them.
    ex = (cfg.n_experts,) if cfg.n_experts else ()
    if fused:
        layers = {
            "ln1": (n, d), "ln2": (n, d),
            "qkv": (n, d, h + 2 * hkv, dh), "wo": (n, h, dh, d),
            "gate_up": (n, *ex, d, 2 * f), "w_down": (n, *ex, f, d),
        }
    else:
        layers = {
            "ln1": (n, d), "ln2": (n, d),
            "wq": (n, d, h, dh), "wk": (n, d, hkv, dh), "wv": (n, d, hkv, dh),
            "wo": (n, h, dh, d),
            "w_gate": (n, *ex, d, f), "w_up": (n, *ex, d, f),
            "w_down": (n, *ex, f, d),
        }
    if cfg.n_experts:
        layers["router"] = (n, d, cfg.n_experts)
    return {
        "embed": (cfg.vocab_size, d), "final_norm": (d,),
        "unembed": (d, cfg.vocab_size), "layers": layers,
    }


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: bf16 -> f32 is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cuda") -> dict:
    """A JAX params tree of numpy arrays -> the port's dict of tensors on
    ``device``, dtypes kept. Raises on a missing key or a wrong shape."""
    device = resolve_device(device)
    want = _expected_shapes(cfg, fused="qkv" in tree["layers"])

    def convert(path, arr, shape):
        t = _to_tensor(arr, device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {shape} "
                             f"for this config")
        return t

    out = {key: convert(key, tree[key], shape)
           for key, shape in want.items() if key != "layers"}
    out["layers"] = {
        key: convert(f"layers/{key}", tree["layers"][key], shape)
        for key, shape in want["layers"].items()
    }
    return out


def params_from_npz(path, cfg: TransformerConfig, device="cuda") -> dict:
    """Read a params tree saved with ``np.savez(path, **{"embed": ...,
    "layers/wq": ..., ...})`` and convert it with ``params_from_numpy``."""
    tree: dict = {"layers": {}}
    with np.load(path) as data:
        for key in data.files:
            head, _, leaf = key.partition("/")
            if leaf:
                tree.setdefault(head, {})[leaf] = data[key]
            else:
                tree[key] = data[key]
    return params_from_numpy(tree, cfg, device)


def image_params_from_numpy(tree: dict,
                            cfg: MnistConfig | ResNetConfig,
                            device="cuda") -> dict:
    """A JAX MNIST or ResNet params tree of numpy arrays (dicts and lists)
    -> the port's same tree of tensors on ``device``. Raises on a missing
    key, a wrong length or a wrong shape for ``cfg``."""
    device = resolve_device(device)
    want = (mnist_param_shapes(cfg) if isinstance(cfg, MnistConfig)
            else resnet_param_shapes(cfg))

    def convert(path, node, shape):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(node) if isinstance(node, dict) else node!r}"
                                 f" != {sorted(shape)} for this config")
            return {k: convert(f"{path}/{k}", node[k], shape[k])
                    for k in shape}
        if isinstance(shape, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(shape):
                raise ValueError(f"{path}: not a list of {len(shape)} for "
                                 f"this config")
            return [convert(f"{path}/{i}", n, s)
                    for i, (n, s) in enumerate(zip(node, shape))]
        t = _to_tensor(node, device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {shape} "
                             f"for this config")
        return t

    return convert("", tree, want)


def params_to_numpy(params):
    """The port's params tree (dicts and lists) -> the same tree of numpy
    arrays on the host (the reverse of ``params_from_numpy`` and
    ``image_params_from_numpy``). bf16 tensors come back as float32, which
    holds them exactly."""
    if isinstance(params, dict):
        return {key: params_to_numpy(val) for key, val in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(val) for val in params]
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _param_paths(params, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, tensor) of a params tree, dict keys sorted and lists
    in order as JAX flattens them (the order of ``leaves``)."""
    if isinstance(params, dict):
        return [pt for key in sorted(params)
                for pt in _param_paths(params[key], f"{prefix}[{key!r}]")]
    if isinstance(params, list):
        return [pt for i, val in enumerate(params)
                for pt in _param_paths(val, f"{prefix}[{i}]")]
    return [(prefix, params)]


def _adam_state_path(opt: torch.optim.Optimizer) -> str:
    try:
        return ADAM_STATE_PATHS[type(opt)]
    except KeyError:
        raise ValueError(f"no JAX state layout for {type(opt).__name__}: "
                         f"AdamW or Adam") from None


def _adam_count(opt: torch.optim.Optimizer, params: list) -> int:
    """optax's single ``count`` from AdamW's per-parameter ``step``: 0 for
    an optimizer that has not stepped yet; raises unless every parameter
    agrees."""
    steps = {int(opt.state[p]["step"]) for p in params if opt.state.get(p)}
    if steps and any(not opt.state.get(p) for p in params):
        raise ValueError("AdamW holds state for only some parameters; "
                         "optax's single count cannot describe it")
    if len(steps) > 1:
        raise ValueError(f"AdamW parameters disagree on their step: "
                         f"{sorted(steps)}")
    return steps.pop() if steps else 0


def train_state_leaves(state: TrainState) -> list[tuple[str, Any]]:
    """Every leaf of the port's ``TrainState`` as (JAX keystr path, value),
    in the JAX state's flattening order. Values are the state's own
    tensors (not copies); a moment of an optimizer that has not stepped
    is a numpy array of zeros, which is what ``optax.adamw(...).init``
    holds, and the count is an int32 numpy scalar."""
    opt = state.opt_state
    params = _param_paths(state.params)
    tensors = [p for _, p in params]
    given = opt.param_groups[0]["params"]
    if len(opt.param_groups) != 1 or len(given) != len(tensors) or any(
            a is not b for a, b in zip(given, tensors)):
        raise ValueError("the optimizer's parameters are not the state's "
                         "params (in leaves() order)")
    count = _adam_count(opt, tensors)
    adam = _adam_state_path(opt)

    def moment(p, key):
        st = opt.state.get(p)
        return st[key] if st else np.zeros(tuple(p.shape), np.float32)

    out = [(STEP_PATH, state.step)]
    out += [(".params" + path, p) for path, p in params]
    out.append((adam + ".count", np.asarray(count, np.int32)))
    out += [(adam + ".mu" + path, moment(p, "exp_avg")) for path, p in params]
    out += [(adam + ".nu" + path, moment(p, "exp_avg_sq"))
            for path, p in params]
    return out


def train_state_placements(state: TrainState) -> dict[str, Any]:
    """{keystr path: parallel.sharding.Placement} of every leaf of a
    data-parallel state (``make_train_step(cfg, mesh)``): params and their
    moments by their parameter's placement. Empty for a single-device
    state; the step and the count are always whole."""
    if state.placements is None:
        return {}
    adam = _adam_state_path(state.opt_state)
    out = {}
    for path, placement in _param_paths(state.placements):
        for prefix in (".params", adam + ".mu", adam + ".nu"):
            out[prefix + path] = placement
    return out


def _host_array(value) -> np.ndarray:
    if torch.is_tensor(value):
        t = value.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return np.array(value)


def train_state_to_numpy(state: TrainState) -> dict[str, np.ndarray]:
    """{JAX keystr path: numpy array} of every leaf of ``state`` (copies on
    the host; bf16 comes back as float32, which holds it exactly)."""
    return {path: _host_array(v) for path, v in train_state_leaves(state)}


def load_train_state(state: TrainState,
                     values: dict[str, torch.Tensor]) -> TrainState:
    """Copy ``values`` ({path: tensor}, all of ``train_state_leaves``'s
    paths) into ``state``'s own tensors, in place, and set AdamW's
    per-parameter state from the count and moments: the optimizer keeps
    pointing at the same parameter tensors. Raises on a missing path or
    a shape or dtype that differs from the state's."""
    opt = state.opt_state
    params = _param_paths(state.params)
    adam = _adam_state_path(opt)
    count_path = adam + ".count"

    def value(path, like: torch.Tensor) -> torch.Tensor:
        if path not in values:
            raise ValueError(f"no value for leaf {path!r}")
        v = values[path]
        if tuple(v.shape) != tuple(like.shape) or v.dtype != like.dtype:
            raise ValueError(
                f"leaf {path!r}: {tuple(v.shape)} {v.dtype} does not match "
                f"the state's {tuple(like.shape)} {like.dtype}")
        return v

    if count_path not in values:
        raise ValueError(f"no value for leaf {count_path!r}")
    count = int(values[count_path])
    group = opt.param_groups[0]
    with torch.no_grad():
        state.step.copy_(value(STEP_PATH, state.step))
        for path, p in params:
            p.copy_(value(".params" + path, p))
            st = opt.state[p]
            if not st:
                on_param = group.get("capturable") or group.get("fused")
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_param else "cpu")
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            st["step"].fill_(count)
            st["exp_avg"].copy_(value(adam + ".mu" + path, p))
            st["exp_avg_sq"].copy_(value(adam + ".nu" + path, p))
    return state


def train_state_from_numpy(flat: dict, state: TrainState) -> TrainState:
    """Load ``{JAX keystr path: numpy array}`` (e.g. ``train_state_to_numpy``
    of another state, or a JAX ``TrainState`` flattened with
    ``jax.tree_util.keystr`` paths) into ``state`` in place."""
    device = state.step.device
    return load_train_state(state, {path: _to_tensor(arr, device)
                                    for path, arr in flat.items()})
