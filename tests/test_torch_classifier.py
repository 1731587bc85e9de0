"""The port's image classifiers held against the JAX package on the CPU.

The same numpy-seeded inputs and the same weights (the JAX init converted
with ``interop.image_params_from_numpy``) go through both packages:
MNIST MLP and CNN logits, a tiny ResNet at an even and an odd image size
(JAX's asymmetric "SAME" padding of the strided convs and the stem's max
pool), ResNet-50's parameter tree, GroupNorm, the uint8 decode, and
``make_image_classifier_step``: three steps against JAX's, ``steps_per_call``
3 against three single steps, dp 2 on two gloo ranks against JAX's step on
the whole batch, and a classifier checkpoint both ways between the two
``CheckpointManager``s. Tolerances are stated in each test.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.checkpoint import CheckpointManager as JaxManager
from tony_tpu.models import mnist as jax_mnist
from tony_tpu.models import resnet as jax_resnet
from tony_tpu.models.train import make_image_classifier_step as jax_step
from tony_tpu.ops import softmax_cross_entropy as jax_ce
from tony_tpu.parallel.mesh import MeshSpec, build_mesh
from tony_tpu_torch.checkpoint import CheckpointManager
from tony_tpu_torch.interop import (
    image_params_from_numpy,
    params_to_numpy,
    train_state_to_numpy,
)
from tony_tpu_torch.models import (
    MnistConfig,
    ResNetConfig,
    make_classifier_step,
    make_image_classifier_step,
    mnist_apply,
    resnet_apply,
    resnet_init,
)
from tony_tpu_torch.models import resnet as port_resnet
from tony_tpu_torch.models.train import leaves
from tony_tpu_torch.ops import softmax_cross_entropy
from torch_ranks import launch

torch.set_num_threads(1)

LR = 1e-3
TINY_RESNET = dict(depth=18, width=8, n_classes=4, dtype="float32")


@pytest.fixture(scope="module")
def mesh():
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    with jax.sharding.set_mesh(mesh):
        yield mesh


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@functools.cache
def _model(kind: str):
    """(JAX config, port config, JAX init, JAX apply, port apply, image
    shape of a batch, classes) of the MNIST MLP or CNN or the tiny ResNet,
    all fp32. The JAX functions are jitted once (eager JAX is slow here)."""
    if kind == "resnet":
        jc, tc = (jax_resnet.ResNetConfig(**TINY_RESNET),
                  ResNetConfig(**TINY_RESNET))
        return (jc, tc, jax.jit(lambda k: jax_resnet.resnet_init(k, jc)),
                jax.jit(lambda p, x: jax_resnet.resnet_apply(p, x, jc)),
                lambda p, x: resnet_apply(p, x, tc), (4, 32, 32, 3), 4)
    jc = jax_mnist.MnistConfig(arch=kind, dtype="float32")
    tc = MnistConfig(arch=kind, dtype="float32")
    shape = (8, 784) if kind == "mlp" else (8, 28, 28, 1)
    return (jc, tc, jax.jit(lambda k: jax_mnist.mnist_init(k, jc)),
            jax.jit(lambda p, x: jax_mnist.mnist_apply(p, x, jc)),
            lambda p, x: mnist_apply(p, x, tc), shape, 10)


def _batches(shape, classes, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape).astype(np.float32),
             rng.integers(0, classes, shape[:1]).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_mnist_logits_match_jax(arch):
    """fp32, atol 1e-5."""
    jc, tc, jinit, japply, tapply, shape, _ = _model(arch)
    params = jax.device_get(jinit(jax.random.key(0)))
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(japply(params, jnp.asarray(x)))
    got = tapply(image_params_from_numpy(params, tc, "cpu"),
                 torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_logits_match_jax(size):
    """Depth 18, width 8, fp32, atol 1e-4: at 32 the stride-2 convs and the
    max pool pad (0, 1), at 33 (1, 1); the stem pads (2, 3) and (3, 3)."""
    jc, tc, jinit, japply, tapply, _, _ = _model("resnet")
    params = jax.device_get(jinit(jax.random.key(0)))
    x = np.random.default_rng(2).normal(size=(2, size, size, 3)).astype(
        np.float32)
    want = np.asarray(japply(params, jnp.asarray(x)))
    got = tapply(image_params_from_numpy(params, tc, "cpu"),
                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_same_padding_is_jax_s():
    assert port_resnet.same_padding(224, 7, 2) == (2, 3)
    assert port_resnet.same_padding(28, 3, 2) == (0, 1)
    assert port_resnet.same_padding(33, 3, 2) == (1, 1)
    assert port_resnet.same_padding(56, 1, 2) == (0, 0)
    assert port_resnet.same_padding(56, 3, 1) == (1, 1)


def test_resnet50_tree_matches_jax():
    """ResNet-50 at width 64 and 1000 classes: every leaf's path and
    shape, and the parameter count, as JAX's init gives them."""
    jc = jax_resnet.ResNetConfig(depth=50)
    want = jax.eval_shape(lambda k: jax_resnet.resnet_init(k, jc),
                          jax.random.key(0))
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    params = resnet_init(ResNetConfig(depth=50), device="cpu")
    got = {path: tuple(t.shape) for path, t in zip(
        _port_paths(params), leaves(params))}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == \
        sum(math.prod(s) for s in want.values())
    assert all(t.dtype == torch.float32 for t in leaves(params))


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _port_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _port_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def test_group_norm_matches_jax():
    """fp32 within 2e-5 of JAX's ``_group_norm``; bf16 activations within
    0.15 of it (JAX's own bounds: bf16 rounding of input and output)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 8, 8, 32)) * 3 + 1.5).astype(np.float32)
    gn = {"scale": rng.normal(size=(32,)).astype(np.float32),
          "bias": rng.normal(size=(32,)).astype(np.float32)}
    want = np.asarray(jax_resnet._group_norm(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in gn.items()}, 8))
    tgn = {k: torch.from_numpy(v) for k, v in gn.items()}
    got = port_resnet._group_norm(torch.from_numpy(x), tgn, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    got16 = port_resnet._group_norm(torch.from_numpy(x).bfloat16(), tgn, 8)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want, atol=0.15)


def test_uint8_decode_equals_prescaled_float():
    """rtol and atol 1e-4, as the JAX package's test holds its own."""
    cfg = ResNetConfig(**TINY_RESNET)
    params = resnet_init(cfg, torch.Generator().manual_seed(0), "cpu")
    raw = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                            dtype=np.uint8)
    u8 = resnet_apply(params, torch.from_numpy(raw), cfg)
    f32 = resnet_apply(params, torch.from_numpy(raw).float() / 255.0, cfg)
    np.testing.assert_allclose(u8.numpy(), f32.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_unsupported_depth_raises():
    with pytest.raises(ValueError, match="unsupported depth"):
        ResNetConfig(depth=42).plan
    with pytest.raises(ValueError, match="unsupported depth"):
        resnet_init(ResNetConfig(depth=42), device="cpu")


def test_image_params_from_numpy_checks_shapes():
    jc, tc, jinit, *_ = _model("resnet")
    params = jax.device_get(jinit(jax.random.key(0)))
    params["stages"][1][0]["proj"] = np.zeros((1, 1, 8, 8), np.float32)
    with pytest.raises(ValueError, match=r"/stages/1/0/proj: shape"):
        image_params_from_numpy(params, tc, "cpu")
    params["stages"][1] = params["stages"][1][:1]
    with pytest.raises(ValueError, match="not a list of 2"):
        image_params_from_numpy(params, tc, "cpu")


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_three_steps_match_jax(kind, mesh):
    """Three steps of both packages' ``make_image_classifier_step`` (adam,
    lr 1e-3) from the same weights on the same batches.

    * loss and accuracy of every step: rtol 1e-5;
    * the first step's gradient of every leaf: within 1e-5 of the leaf's
      largest gradient (fp32 reordering in the convolutions' backward,
      which reaches a few 1e-6 on single elements);
    * every state leaf after three steps (params, moments, count, step):
      the same paths, the count and step equal, and the params and moments
      within atol 1e-4, rtol 1e-5. Adam's first steps are sign-like: where
      a gradient lies within a few eps (1e-8) of zero, a rounding-level
      difference in it moves that weight by a good fraction of lr, so the
      weights cannot be held to the gradients' tolerance (measured worst
      5.2e-5 on the tiny ResNet, 1.4e-5 on the CNN).
    """
    jc, tc, jinit, japply, tapply, shape, classes = _model(kind)
    batches = _batches(shape, classes, 3)
    j_init, j_step = jax_step(jinit, japply, mesh, learning_rate=LR)
    jstate = j_init(jax.random.key(0))
    params = jax.device_get(jstate.params)
    t_init, t_step = make_image_classifier_step(None, tapply, device="cpu",
                                                learning_rate=LR)
    tstate = t_init(params=image_params_from_numpy(params, tc, "cpu"))

    x0, y0 = batches[0]
    # Eager JAX for the gradient (the JAX applies are jitted): XLA's fusion
    # of the whole gradient reorders GroupNorm's E[x^2] - E[x]^2 once more.
    eager = (jax_resnet.resnet_apply if kind == "resnet"
             else jax_mnist.mnist_apply)
    jgrads = jax.tree_util.tree_leaves(jax.grad(
        lambda p: jax_ce(eager(p, x0, jc), y0))(params))
    tleaves = leaves(tstate.params)
    tgrads = torch.autograd.grad(softmax_cross_entropy(
        tapply(tstate.params, torch.from_numpy(x0)), torch.from_numpy(y0)),
        tleaves)
    for jg, tg in zip(jgrads, tgrads):
        jg = np.asarray(jg)
        assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()

    for x, y in batches:
        jstate, jm = j_step(jstate, x, y)
        tstate, tm = t_step(tstate, x, y)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), rtol=1e-5)
    want, got = _jax_flat(jstate), train_state_to_numpy(tstate)
    assert set(got) == set(want)
    for path in want:
        if got[path].ndim == 0:
            assert int(got[path]) == int(want[path]) == 3, path
        else:
            np.testing.assert_allclose(got[path], want[path], atol=1e-4,
                                       rtol=1e-5, err_msg=path)


def test_adam_on_the_same_gradients_is_optax_adam():
    """The port's optimizer (``torch.optim.Adam`` as the classifier step
    configures it) fed the gradients JAX's would see gives optax.adam's
    weights: rtol 1e-6, atol 1e-7 over three steps."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 7)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1))
              .astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    opt = optax.adam(LR)
    jp, js = p0, opt.init(p0)
    t_init, _ = make_image_classifier_step(None, None, device="cpu",
                                           learning_rate=LR)
    state = t_init(params={k: torch.from_numpy(v) for k, v in p0.items()})
    for g in grads:
        upd, js = opt.update(g, js)
        jp = optax.apply_updates(jp, upd)
        for key, t in state.params.items():
            t.grad = torch.from_numpy(g[key])
        state.opt_state.step()
    got = params_to_numpy(state.params)
    for key in p0:
        np.testing.assert_allclose(got[key], np.asarray(jp[key]), rtol=1e-6,
                                   atol=1e-7)


def test_steps_per_call_three_equals_three_single_steps():
    """Bit for bit: the call loops over the stacked batches."""
    cfg = MnistConfig(arch="cnn", dtype="float32")
    batches = _batches((8, 28, 28, 1), 10, 3, seed=3)
    init1, step1 = make_classifier_step(cfg, device="cpu")
    init3, step3 = make_classifier_step(cfg, device="cpu", steps_per_call=3)
    s1, s3 = init1(0), init3(0)
    for x, y in batches:
        s1, m1 = step1(s1, x, y)
    s3, m3 = step3(s3, np.stack([x for x, _ in batches]),
                   np.stack([y for _, y in batches]))
    assert int(s3.step) == 3
    for key in ("loss", "accuracy"):
        assert float(m3[key]) == float(m1[key])
    a, b = train_state_to_numpy(s1), train_state_to_numpy(s3)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=path)
    assert step3.stepstats.steps_per_call == 3


def test_dp2_in_two_gloo_ranks_matches_jax_on_the_whole_batch(tmp_path,
                                                              mesh):
    """``make_classifier_step`` (the CNN, fp32) over a dp=2 mesh of two
    gloo ranks, each fed its half of every batch, against JAX's one-device
    step on the whole batch from the same weights (the port's init at seed
    0): losses and accuracies rtol 1e-5 on both ranks, both ranks' states
    bit-equal, and the state within three_steps' tolerance of JAX's."""
    batches = _batches((8, 28, 28, 1), 10, 3, seed=4)
    np.savez(tmp_path / "batches.npz",
             images=np.stack([x for x, _ in batches]),
             labels=np.stack([y for _, y in batches]))
    results = launch("classifier_dp", tmp_path,
                     args=(tmp_path / "batches.npz",))
    cfg = MnistConfig(arch="cnn", dtype="float32")
    init_fn, _ = make_classifier_step(cfg, device="cpu")
    params = params_to_numpy(init_fn(0).params)
    jc = jax_mnist.MnistConfig(arch="cnn", dtype="float32")
    j_init, j_step = jax_step(
        lambda key: params, lambda p, x: jax_mnist.mnist_apply(p, x, jc),
        mesh, learning_rate=LR)
    jstate = j_init(jax.random.key(0))
    jmetrics = []
    for x, y in batches:
        jstate, m = j_step(jstate, x, y)
        jmetrics.append({k: float(v) for k, v in m.items()})
    states = [dict(np.load(tmp_path / f"classifier_dp.{r}.npz"))
              for r in range(2)]
    for r in results:
        for got, want in zip(r["metrics"], jmetrics):
            for key in ("loss", "accuracy"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    want = _jax_flat(jstate)
    assert set(states[0]) == set(want)
    for path in want:
        np.testing.assert_array_equal(states[0][path], states[1][path])
        np.testing.assert_allclose(states[0][path], want[path], atol=1e-4,
                                   rtol=1e-5, err_msg=path)


def test_classifier_checkpoint_cross_restores_both_ways(tmp_path, mesh):
    """JAX's manager writes a JAX classifier state (the tiny ResNet after a
    step) and the port's restores it into a port state in place, every
    leaf equal under JAX's keystr paths; the port's manager writes the
    port's state after one more step and JAX's restores it, every leaf
    equal."""
    jc, tc, jinit, japply, tapply, shape, classes = _model("resnet")
    batches = _batches(shape, classes, 2, seed=5)
    j_init, j_step = jax_step(jinit, japply, mesh, learning_rate=LR)
    jstate, _ = j_step(j_init(jax.random.key(0)), *batches[0])
    JaxManager(tmp_path / "jax").save(1, jstate, blocking=True)
    want = _jax_flat(jstate)

    t_init, t_step = make_image_classifier_step(
        lambda gen: resnet_init(tc, gen, "cpu"), tapply, device="cpu",
        learning_rate=LR)
    template = t_init(7)
    state = CheckpointManager(tmp_path / "jax").restore(template)
    assert state is template
    got = train_state_to_numpy(state)
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)

    state, _ = t_step(state, *batches[1])
    CheckpointManager(tmp_path / "port").save(2, state, blocking=True)
    restored = JaxManager(tmp_path / "port").restore(
        j_init(jax.random.key(1)))
    back, mine = _jax_flat(restored), train_state_to_numpy(state)
    assert set(back) == set(mine)
    for path in mine:
        np.testing.assert_array_equal(back[path], mine[path], err_msg=path)
