"""ResNet-50 in the port (models/resnet.py, workloads/train_resnet.py)
against the JAX package's ``models/resnet.py`` and its twin.

Width 16 and 10 classes (the stages keep ResNet-50's widths), batch 4, at
32x32 (the last stage is 1x1) and at the odd 37x37, on weights drawn once
from a seed and handed to both sides as numpy arrays.

Precision. At random init the training forward is badly conditioned: each
block subtracts a large channel mean from its conv's output, and the last
stages take their statistics over a few values. Two f32 evaluations that
only sum in another order (the JAX package's and the port's, or the port's
against itself in f64) then differ in their gradients by percents, far
past any tolerance a parity test could hold them to. So the training-mode
comparisons run in f64 on both sides: the port's ResNet keeps f64 for an
f64 model, and the JAX package's, which writes ``jnp.float32`` for its
statistics and its pool, runs under ``jax.enable_x64`` with a ``jnp``
whose ``float32`` is ``float64`` handed to its module (nothing in the
package changes). There the two agree to about 1e-8. In f32 the eval
logits are held at the zoo's tolerance, and the training outputs are held
to be no farther from the f64 result than the JAX package's own f32 ones.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from hivedscheduler_tpu.models import resnet as JR
from hivedscheduler_tpu_torch.models import convert, resnet, transformer
from hivedscheduler_tpu_torch.workloads import train_resnet

FWD = {"atol": 2e-4, "rtol": 2e-3}  # tests/test_model_zoo.py's tolerance
GRAD = {"atol": 2e-3, "rtol": 2e-2}
LOSS_TOL, STATS_TOL = 1e-4, 1e-5
SIZES = (32, 37)
BATCH, CLASSES, WIDTH = 4, 10, 16
# The port's f32 training outputs against the f64 result, as a multiple of
# the JAX package's f32 distance from it (both are f32 evaluations of one
# function in other summation orders).
F32_NOISE_FACTOR = 4.0
F32_TRAIN_SIZE = 32


class _Jnp64:
    """``jax.numpy`` whose ``float32`` is ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_f64():
    """The JAX package's ResNet computing in f64 throughout."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JR, "jnp", _Jnp64())
        yield


def flat(tree, prefix=()):
    """{path: numpy array} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        a = tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        return {prefix: a}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


def batch(size):
    rng = np.random.default_rng(size)
    return (rng.standard_normal((BATCH, size, size, 3)),
            rng.integers(0, CLASSES, BATCH))


@pytest.fixture(scope="module")
def weights():
    """(params, stats) as numpy f64 trees: the port's init from seed 0."""
    config = resnet.ResNetConfig(CLASSES, WIDTH, torch.float32)
    params, stats = resnet.init(config, torch.Generator().manual_seed(0), "cpu")
    as64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), convert.params_to_numpy(t))
    return as64(params), as64(stats)


def _jax_run(config, training=True):
    def run(p, s, x, y):
        out = {"eval": JR.forward(p, s, x, config)[0]}
        if training:
            (out["loss"], out["stats"]), out["grads"] = jax.value_and_grad(
                JR.loss_fn, has_aux=True)(p, s, x, y, config)
            out["train"] = JR.forward(p, s, x, config, train=True)[0]
        return out
    return jax.jit(run)


def _port_run(params_np, stats_np, size, dtype):
    config = resnet.ResNetConfig(CLASSES, WIDTH, dtype)
    params = convert.params_from_jax(params_np, "cpu", dtype)
    stats = convert.params_from_jax(stats_np, "cpu", dtype)
    images, labels = batch(size)
    images = torch.from_numpy(images).to(dtype)
    labels = torch.from_numpy(labels)
    for t in transformer.leaves(params):
        t.requires_grad_(True)
    loss, new_stats = resnet.loss_fn(params, stats, images, labels, config)
    loss.backward()
    with torch.no_grad():
        train = resnet.forward(params, stats, images, config, train=True)[0]
        evals = resnet.forward(params, stats, images, config)[0]
    return {"loss": loss.detach(), "stats": new_stats,
            "grads": resnet.tree_map(lambda t: t.grad, params), "train": train, "eval": evals}


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX package's outputs by (dtype, size): f64, and f32 (its
    training outputs at 32x32 only, to keep the file's compile time down)."""
    params, stats = weights
    out = {}
    with jax_f64():
        run = _jax_run(JR.ResNetConfig(CLASSES, WIDTH, jnp.float64))
        for size in SIZES:
            out["f64", size] = jax.tree.map(np.asarray, run(params, stats, *batch(size)))
    config = JR.ResNetConfig(CLASSES, WIDTH, jnp.float32)
    p32, s32 = (jax.tree.map(lambda a: a.astype(np.float32), t) for t in (params, stats))
    for size in SIZES:
        images, labels = batch(size)
        run = _jax_run(config, training=size == F32_TRAIN_SIZE)
        out["f32", size] = jax.tree.map(np.asarray, run(p32, s32, images.astype(np.float32),
                                                        labels))
    return out


@pytest.fixture(scope="module")
def port(weights):
    params, stats = weights
    return {(name, size): _port_run(params, stats, size, dtype)
            for name, dtype in (("f64", torch.float64), ("f32", torch.float32))
            for size in SIZES}


def _close(got, want, atol, rtol):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=rtol,
                                   err_msg=str(path))


def test_tree_layout_matches_jax(weights):
    shapes = jax.eval_shape(lambda: JR.init(JR.ResNetConfig(CLASSES, WIDTH, jnp.float32),
                                            jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda s: np.empty(s.shape, s.dtype), shapes)
    for got, want in zip(weights, shapes):
        got, want = flat(got), flat(want)
        assert got.keys() == want.keys()
        assert all(got[p].shape == want[p].shape for p in want)
    params, _ = weights
    assert len(params["stages"]) == len(resnet.STAGES)
    assert [len(s) for s in params["stages"]] == list(resnet.STAGES)
    assert all(("proj" in b) == (i == 0) for s in params["stages"] for i, b in enumerate(s))


def test_init_laws():
    params, stats = resnet.init(resnet.ResNetConfig(), torch.Generator().manual_seed(1), "cpu")
    for path, a in flat(params).items():
        if path[-1] in ("conv", "conv1", "conv2", "conv3", "proj"):
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            assert a.std() == pytest.approx((2 / fan_in) ** 0.5, rel=0.05), path
        elif path[-1] == "scale":
            assert (a == 1).all()
        elif path[-1] == "bias":
            assert (a == 0).all()
    assert params["head"].shape == (2048, 1000)
    assert params["head"].std().item() == pytest.approx(2048 ** -0.5, rel=0.02)
    for path, a in flat(stats).items():
        assert (a == (0 if path[-1] == "mean" else 1)).all(), path
    assert all(t.dtype == torch.float32 for t in transformer.leaves(params))


def test_conversion_round_trip_is_bitwise(weights):
    for tree in weights:
        tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
        back = convert.params_to_numpy(convert.params_from_jax(tree, "cpu"))
        got, want = flat(back), flat(tree)
        assert got.keys() == want.keys()
        for p in want:
            assert got[p].dtype == np.float32 and got[p].tobytes() == want[p].tobytes(), p
    params = convert.params_from_jax(weights[0], "cpu")
    assert isinstance(params["stages"], list) and isinstance(params["stages"][0], list)
    assert len(transformer.leaves(params)) == len(flat(weights[0]))


@pytest.mark.parametrize("n", [8, 9, 32, 37])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_same_padding_matches_xla(k, stride, n):
    rng = np.random.default_rng(k * 100 + stride * 10 + n)
    x = rng.standard_normal((2, n, n, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    pads = jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")[0]
    assert resnet.same_pads(n, k, stride) == tuple(pads)
    want = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.conv(xt, torch.from_numpy(w), stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [8, 9, 16, 19, 112])
def test_max_pool_same_padding_matches_xla(n):
    x = np.random.default_rng(n).standard_normal((2, n, n, 3)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                            (1, 2, 2, 1), "SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.max_pool(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    # PyTorch's symmetric padding shifts the windows at even sizes.
    sym = F.max_pool2d(xt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert (sym.shape != want.shape or not np.array_equal(sym, want)) == (n % 2 == 0)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    rng = np.random.default_rng(3)
    x = (3 + 2 * rng.standard_normal((4, 6, 6, 8))).astype(np.float32)
    p = {"scale": rng.random(8).astype(np.float32) + 0.5,
         "bias": rng.standard_normal(8).astype(np.float32)}
    s = {"mean": rng.standard_normal(8).astype(np.float32),
         "var": rng.random(8).astype(np.float32) + 0.5}
    want_y, want_s = JR._bn(x, p, s, train)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    y, new_s = resnet.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), t(p), t(s), train)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    _close(new_s, want_s, 1e-6, 1e-6)
    if not train:
        assert all(new_s[k].numpy().tobytes() == s[k].tobytes() for k in s)
        return
    # The biased variance and the reference's momentum, 0.9 on the history.
    x64 = x.astype(np.float64)
    mean, var = x64.mean((0, 1, 2)), x64.var((0, 1, 2))  # numpy's var is the biased one
    np.testing.assert_allclose(new_s["mean"].numpy(), 0.9 * s["mean"] + 0.1 * mean, rtol=1e-5)
    np.testing.assert_allclose(new_s["var"].numpy(), 0.9 * s["var"] + 0.1 * var, rtol=1e-5)
    assert not new_s["mean"].requires_grad


@pytest.mark.parametrize("size", SIZES)
def test_eval_logits_match_jax_f32(reference, port, size):
    np.testing.assert_allclose(port["f32", size]["eval"].numpy(), reference["f32", size]["eval"],
                               **FWD)


@pytest.mark.parametrize("size", SIZES)
def test_training_matches_jax_f64(reference, port, size):
    got, want = port["f64", size], reference["f64", size]
    for key in ("train", "eval"):
        np.testing.assert_allclose(got[key].numpy(), want[key], **FWD)
    assert abs(got["loss"].item() - float(want["loss"])) < LOSS_TOL
    _close(got["stats"], want["stats"], STATS_TOL, 0)
    _close(got["grads"], want["grads"], GRAD["atol"], GRAD["rtol"])


def _rel(got, want):
    """Norm-wise relative distance of two trees, all leaves together."""
    got, want = flat(got), flat(want)
    num = sum(float(((got[p] - want[p]) ** 2).sum()) for p in want)
    den = sum(float((want[p].astype(np.float64) ** 2).sum()) for p in want)
    return (num / den) ** 0.5


def test_f32_training_is_no_noisier_than_jax_f32(reference, port):
    exact = reference["f64", F32_TRAIN_SIZE]
    mine, theirs = port["f32", F32_TRAIN_SIZE], reference["f32", F32_TRAIN_SIZE]
    for key in ("loss", "train", "stats", "grads"):
        noise = _rel(theirs[key], exact[key])
        assert _rel(mine[key], exact[key]) <= F32_NOISE_FACTOR * noise + 1e-6, key


def test_sgd_is_optax_sgd():
    rng = np.random.default_rng(5)
    # f32 values (convert.params_from_jax reads through f32), stepped in f64.
    normal = lambda shape: rng.standard_normal(shape).astype(np.float32).astype(np.float64)
    tree = {"a": normal((3, 4)), "stages": [[{"w": normal(5)}]]}
    grads = [jax.tree.map(lambda a: normal(a.shape), tree) for _ in range(3)]
    opt = optax.sgd(0.1, momentum=0.9)
    with jax.enable_x64(True):
        want, state = tree, opt.init(tree)
        for g in grads:
            updates, state = opt.update(g, state, want)
            want = jax.tree.map(np.asarray, optax.apply_updates(want, updates))
    params = convert.params_from_jax(tree, "cpu", torch.float64)
    sgd = train_resnet.make_optimizer(params)
    for g in grads:
        for t, gt in zip(transformer.leaves(params),
                         transformer.leaves(convert.params_from_jax(g, "cpu", torch.float64))):
            t.grad = gt
        sgd.step()
    _close(resnet.tree_map(lambda t: t.detach(), params), want, 1e-12, 1e-12)


def test_train_resnet_main_on_cpu(capsys):
    records = train_resnet.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                 "--image-size", "32"])
    out = capsys.readouterr().out
    assert [r["step"] for r in records] == [0, 1]
    assert np.isfinite(records[0]["loss"])
    assert abs(records[0]["loss"] - np.log(1000)) < 1.5
    assert all(set(r["launches"].values()) == {0} for r in records)
    assert "step 0 loss" in out and "img/s" in out
    summary = [line for line in out.splitlines() if line.startswith("resnet summary ")]
    assert len(summary) == 1 and '"bn_stats_digest"' in summary[0]
