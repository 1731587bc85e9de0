"""The port's parallel layer held against the JAX package's on the CPU.

In the test process, with no process group: ``MeshSpec`` (auto-factoring,
validation, the multi-slice rules), ``logical_spec``, ``with_logical_
constraint`` and the placement of every parameter leaf (the piece each mesh
position holds) against JAX's ``NamedSharding`` of the same roles. Then one
launch of two gloo ranks (``torch_ranks.launch``) runs the five collectives
on seeded inputs; JAX runs the same functions under ``shard_map`` on two
virtual CPU devices. Gathers, the reduce-scatter, the all-to-all and the
halos agree exactly, the means to rtol 1e-6.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tony_tpu.checkpoint.manager import _normalize_index
from tony_tpu.models import TransformerConfig as JaxConfig
from tony_tpu.models import init_params as jax_init_params
from tony_tpu.models import param_roles as jax_param_roles
from tony_tpu.models.train import _sharding_for_tree
from tony_tpu.parallel import collectives as jax_coll
from tony_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tony_tpu.parallel.mesh import build_mesh as jax_build_mesh
from tony_tpu.parallel.sharding import LOGICAL_RULES as JAX_RULES
from tony_tpu.parallel.sharding import logical_spec as jax_logical_spec
from tony_tpu_torch.models import TransformerConfig, param_roles
from tony_tpu_torch.parallel import (
    AXES,
    LOGICAL_RULES,
    MeshSpec,
    logical_spec,
    shard_pytree,
    with_logical_constraint,
)
from tony_tpu_torch.parallel.mesh import check_slices
from torch_ranks import TINY, launch


def _outcome(fn):
    """The shape a spec factory gives, or the error type it raises."""
    try:
        return fn().shape
    except ValueError as exc:
        return type(exc)


AUTO_CASES = [
    (1, {}), (2, {}), (4, {}), (6, {}), (8, {}), (12, {}), (16, {}),
    (8, {"dp": 2}), (8, {"tp": 4}), (8, {"pp": 2, "tp": 2}),
    (8, {"ep": 2}), (16, {"dp": 2, "pp": 4}), (8, {"dp": 3}),
    (8, {"dp": 2, "pp": 1, "ep": 1, "sp": 2, "tp": 2}),
    (8, {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 2}),
    (6, {"tp": 3}), (7, {}),
]


@pytest.mark.parametrize("n,fixed", AUTO_CASES,
                         ids=[f"{n}-{f}" for n, f in AUTO_CASES])
def test_mesh_spec_auto_matches_jax(n, fixed):
    want = _outcome(lambda: JaxMeshSpec.auto(n, **fixed))
    assert _outcome(lambda: MeshSpec.auto(n, **fixed)) == want


@pytest.mark.parametrize("shape,n", [
    ((1, 1, 1, 1, 1), None), ((2, 1, 1, 1, 2), 4), ((2, 1, 1, 1, 2), 8),
    ((0, 1, 1, 1, 1), None), ((1, 1, -1, 1, 1), 1),
])
def test_mesh_spec_validate_matches_jax(shape, n):
    want = _outcome(lambda: JaxMeshSpec(*shape).validate(n))
    assert _outcome(lambda: MeshSpec(*shape).validate(n)) == want
    assert MeshSpec(*shape).num_devices == JaxMeshSpec(*shape).num_devices


@pytest.mark.parametrize("shape,n,slices", [
    ((4, 1, 1, 1, 2), 8, 2), ((2, 2, 1, 1, 2), 8, 2),
    ((8, 1, 1, 1, 1), 8, 4), ((1, 1, 1, 1, 8), 8, 2),
    ((2, 1, 1, 2, 2), 8, 4), ((3, 1, 1, 1, 2), 6, 4),
    ((6, 1, 1, 1, 1), 6, 3),
])
def test_multi_slice_rules_match_jax(shape, n, slices):
    """The JAX package's build_mesh refuses the same multi-slice layouts
    as the port's check (both validate the spec against n first)."""
    def jax_side():
        jax_build_mesh(JaxMeshSpec(*shape), jax.devices()[:n],
                       num_slices=slices)
        return MeshSpec(*shape)

    def port_side():
        spec = MeshSpec(*shape).validate(n)
        check_slices(spec, n, slices)
        return spec

    assert _outcome(port_side) == _outcome(jax_side)


def test_auto_spec_of_a_multi_slice_world_matches_jax():
    mesh = jax_build_mesh(None, jax.devices()[:8], num_slices=4)
    assert MeshSpec.auto(8, dp=4).shape == tuple(mesh.devices.shape)
    assert AXES == tuple(mesh.axis_names)


ROLE_CASES = [
    ("batch", "seq", "embed"), ("batch", None), (None,), (),
    ("layers", "embed_fsdp", "heads", None), ("layers", "expert", "mlp"),
    ("vocab", "kv", "stage"), ("heads",),
]


@pytest.mark.parametrize("roles", ROLE_CASES, ids=str)
def test_logical_spec_matches_jax(roles):
    assert logical_spec(*roles) == tuple(jax_logical_spec(*roles))


def test_unknown_role_raises_like_jax():
    for fn in (logical_spec, jax_logical_spec):
        with pytest.raises(KeyError, match="unknown logical axis 'head'"):
            fn("batch", "head")
    assert logical_spec("batch", rules={"batch": "tp"}) == ("tp",)
    assert LOGICAL_RULES == JAX_RULES


def test_with_logical_constraint_checks_roles_and_returns_x():
    """No compiler to hint: the tensor comes back as it is, unknown roles
    still raise."""
    x = torch.ones(2, 3)
    assert with_logical_constraint(x, "batch", "embed") is x
    with pytest.raises(KeyError, match="unknown logical axis"):
        with_logical_constraint(x, "batch", "embeds")


class _Position:
    """One mesh position, for ``place``: the sizes of a ``MeshSpec`` and
    this position's coordinates (a stand-in for a DeviceMesh rank)."""

    def __init__(self, spec: MeshSpec, coords: tuple[int, ...]):
        self.spec, self.coords = spec, coords

    def size(self, dim: int) -> int:
        return self.spec.shape[dim]

    def get_local_rank(self, name: str) -> int:
        return self.coords[AXES.index(name)]


@pytest.mark.parametrize("shape", [(2, 1, 1, 1, 1), (3, 1, 1, 1, 1),
                                   (2, 2, 1, 1, 2), (1, 1, 2, 1, 4),
                                   (8, 1, 1, 1, 1)])
def test_placements_match_jax_shardings(shape):
    """Every leaf's piece at every mesh position is the index JAX's
    ``_sharding_for_tree`` gives that device (dims the axes do not divide
    replicate, e.g. d 32 over dp 3)."""
    jcfg = JaxConfig(**TINY)
    params = jax.device_get(jax_init_params(jax.random.key(0), jcfg))
    spec = JaxMeshSpec(*shape)
    jmesh = jax_build_mesh(spec, jax.devices()[:spec.num_devices])
    shardings = _sharding_for_tree(params, jax_param_roles(jcfg), jmesh)
    roles = param_roles(TransformerConfig(**TINY))
    tparams = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
                   else {kk: torch.from_numpy(np.array(vv))
                         for kk, vv in v.items()})
               for k, v in params.items()}
    devices = np.asarray(jmesh.devices)
    for coords in np.ndindex(*shape):
        pos = _Position(MeshSpec(*shape), coords)
        local, placements = shard_pytree(tparams, roles, pos)
        flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
        for path, sharding in flat:
            keys = [p.key for p in path]
            leaf = params
            pl, piece = placements, local
            for key in keys:
                leaf, pl, piece = leaf[key], pl[key], piece[key]
            want = _normalize_index(
                sharding.devices_indices_map(leaf.shape)[devices[coords]],
                leaf.shape)
            assert [list(i) for i in pl.index] == want, (keys, coords)
            region = tuple(slice(a, b) for a, b in want)
            np.testing.assert_array_equal(piece.numpy(),
                                          np.asarray(leaf)[region])


def _inputs(rng) -> dict[str, list[np.ndarray]]:
    shapes = {"pmean_a": (3, 5), "pmean_b": (7,), "pmean_c": (2, 2, 3),
              "gather": (3, 4, 2), "scatter": (3, 6, 2), "a2a": (4, 3),
              "halo": (2, 6)}
    return {k: [rng.standard_normal(s).astype(np.float32) for _ in range(2)]
            for k, s in shapes.items()}


def _per_device(axis: str, body, *xs):
    """Run ``body`` on device r's inputs (xs[i][r]) under shard_map over a
    2-device mesh whose ``axis`` spans them; returns per-device outputs."""
    jmesh = jax_build_mesh(JaxMeshSpec(**{axis: 2}), jax.devices()[:2])
    stacked = [np.stack(x) for x in xs]

    def wrapped(*local):
        out = body(*(x[0] for x in local))
        return jax.tree.map(lambda o: o[None], out)

    out = jax.shard_map(wrapped, mesh=jmesh,
                        in_specs=tuple(P(axis) for _ in xs),
                        out_specs=P(axis), check_vma=False)(*stacked)
    return jax.tree.map(np.asarray, out)


def test_collectives_in_two_gloo_ranks_match_shard_map(tmp_path):
    rng = np.random.default_rng(11)
    inp = _inputs(rng)
    path = tmp_path / "inputs.npz"
    np.savez(path, **{f"{k}_{r}": v[r] for k, v in inp.items()
                      for r in range(2)})
    results = launch("collectives", tmp_path, args=(path,))
    assert [r["rank"] for r in results] == [0, 1]
    got = [dict(np.load(tmp_path / f"collectives.{r}.npz")) for r in range(2)]

    for axis in ("dp", "ep"):
        want = _per_device(axis, lambda a, b, c: jax_coll.pmean_gradients(
            {"a": a, "nested": [b, c]}),
            inp["pmean_a"], inp["pmean_b"], inp["pmean_c"])
        for r in range(2):
            for key, ref in (("a", want["a"]), ("b", want["nested"][0]),
                             ("c", want["nested"][1])):
                np.testing.assert_allclose(got[r][f"pmean_{axis}_{key}"],
                                           ref[r], rtol=1e-6, atol=0)
    checks = {
        "gather": _per_device("tp", lambda x: jax_coll.all_gather_tp(
            x, axis=1), inp["gather"]),
        "scatter": _per_device("tp", lambda x: jax_coll.reduce_scatter_tp(
            x, axis=1), inp["scatter"]),
        "a2a": _per_device("ep", lambda x: jax_coll.all_to_all_ep(
            x, split_axis=0, concat_axis=1), inp["a2a"]),
    }
    halo = _per_device("sp", lambda x: jax_coll.ring_halo_exchange(
        x, "sp", halo=2, axis=1), inp["halo"])
    checks["halo_prev"], checks["halo_next"] = halo
    for name, want in checks.items():
        for r in range(2):
            assert got[r][name].shape == want[r].shape, name
            np.testing.assert_array_equal(got[r][name], want[r],
                                          err_msg=name)
