"""Weights between the JAX package and the port.

``params_from_numpy`` takes a JAX parameter tree as numpy arrays (what
``jax.device_get`` returns) in either layout the JAX package uses: the raw
training layout of ``init_params`` (``wq``/``wk``/``wv``, ``w_gate``/``w_up``)
or the fused ``decode_weights`` layout (``qkv``, ``gate_up``). It checks every
shape against the config and returns the same tree as torch tensors on
``device``, so both packages compute the same function in the tests.
``params_from_npz`` reads such a tree from an ``.npz`` file whose keys are
the tree paths joined by ``/`` (``embed``, ``layers/wq``, ...).
``params_to_numpy`` goes the other way, so trained weights can be compared
with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.transformer import TransformerConfig


def _expected_shapes(cfg: TransformerConfig, fused: bool) -> dict:
    d, h, dh, f, n = (
        cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers,
    )
    hkv = cfg.kv_heads
    if fused:
        layers = {
            "ln1": (n, d), "ln2": (n, d),
            "qkv": (n, d, h + 2 * hkv, dh), "wo": (n, h, dh, d),
            "gate_up": (n, d, 2 * f), "w_down": (n, f, d),
        }
    else:
        layers = {
            "ln1": (n, d), "ln2": (n, d),
            "wq": (n, d, h, dh), "wk": (n, d, hkv, dh), "wv": (n, d, hkv, dh),
            "wo": (n, h, dh, d),
            "w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d),
        }
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
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE parameters wait for a later slice of the port"
        )
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


def params_to_numpy(params: dict) -> dict:
    """The port's params tree -> the same tree of numpy arrays on the host
    (the reverse of ``params_from_numpy``). bf16 tensors come back as
    float32, which holds them exactly."""
    def convert(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {key: (params_to_numpy(val) if isinstance(val, dict)
                  else convert(val))
            for key, val in params.items()}
