"""The captured training steps of hivedscheduler_tpu_torch (the owner
``models/train.step_graphs`` and each model's ``captured_step``), driven on
the CPU with a stand-in for the CUDA graph capture that re-runs the
captured function at each replay, as tests/test_torch_decode_graph.py
drives the decode step's owner. Each model's steps through the owner equal
its eager ``train_step``'s bit for bit; the Llama steps are also held to
the JAX package's ``train_step`` (its Pallas kernels in interpret mode) at
tests/test_torch_train.py's tolerance."""

import dataclasses
import functools
import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import train as JTR
from hivedscheduler_tpu.models import transformer as JT
from hivedscheduler_tpu.ops import attention as JA
from hivedscheduler_tpu_torch.models import bert, checkpoint, convert, mixtral, resnet
from hivedscheduler_tpu_torch.models import train as TTR
from hivedscheduler_tpu_torch.models import transformer as TT
from hivedscheduler_tpu_torch.ops import attention as TA
from hivedscheduler_tpu_torch.workloads import train_bert, train_mixtral, train_mnist, train_resnet

RTOL = 2e-4  # tests/test_torch_train.py's, for the losses against JAX
ADAM = importlib.import_module("torch.optim.adam")  # its capturable check's device list
STEPS = 3


def rerun_capture(fn, dtype=torch.float32):
    """``train._capture`` on the CPU: nothing runs at the capture (a real
    one executes nothing on the card); each replay runs ``fn`` again and
    writes its loss (of ``dtype``) into the graph's output tensor."""
    static = torch.zeros((), dtype=dtype)

    def replay():
        static.copy_(fn())

    return replay, static


@pytest.fixture(autouse=True)
def deterministic():
    """The CPU's threaded embedding backward (``index_put_`` with
    accumulate) adds in no fixed order, so two eager runs differ in their
    last bits; the bitwise comparisons take its deterministic kernel (the
    card's is sort-based, deterministic as it is)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture
def owner_on_cpu(monkeypatch):
    monkeypatch.setattr(TTR, "_graphed", lambda t: True)
    monkeypatch.setattr(TTR, "_capture", rerun_capture)


def rows(seed, shape, high):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, high, size=shape))


def gqa_config():
    """A small GQA Llama (4 heads over 2 KV heads, head_dim 32) at S 256,
    the flash dispatch's length, under the "flash" remat policy, on both
    sides."""
    shape = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
                 max_seq_len=256, remat=True, remat_policy="flash")
    return (JT.TransformerConfig(dtype=jnp.float32, **shape),
            TT.TransformerConfig(dtype=torch.float32, **shape))


# Each model: (make() -> (params, optimizer, state), the eager step and the
# captured step as step(params, optimizer, state, i) -> (loss, state), the
# batches made from the step's index i).


def _llama():
    _, config = gqa_config()
    params = TT.init(config, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    return config, params


def _llama_steps():
    config, _ = _llama()

    def make():
        params = _llama()[1]
        return params, TTR.make_optimizer(params), None

    def step(fn):
        return lambda p, o, s, i: (fn(p, o, rows(i, (2, 256), 512).int(), config, "cpu"), s)

    return make, step(TTR.train_step), step(TTR.captured_step)


def _bert_steps():
    config = bert.tiny()

    def make():
        params = bert.init(config, torch.Generator().manual_seed(1), "cpu")
        return params, train_bert.make_optimizer(params), None

    def step(fn):
        def run(p, o, s, i):
            tokens, targets = train_bert.masked_batch(np.random.default_rng(i), 2, 64,
                                                      config.vocab_size)
            return fn(p, o, tokens, targets, config), s
        return run

    return make, step(train_bert.train_step), step(train_bert.captured_step)


def _mixtral_steps():
    config = mixtral.tiny()

    def make():
        params = mixtral.init(config, torch.Generator().manual_seed(2), "cpu", torch.float32)
        return params, train_mixtral.make_optimizer(params), None

    def step(fn):
        return lambda p, o, s, i: (fn(p, o, rows(i, (2, 64), config.vocab_size), config), s)

    return make, step(train_mixtral.train_step), step(train_mixtral.captured_step)


RESNET = resnet.ResNetConfig(num_classes=10, width=16, dtype=torch.float64)


def _resnet_steps():
    def make():
        params, stats = resnet.init(RESNET, torch.Generator().manual_seed(3), "cpu")
        params, stats = (convert.params_from_jax(convert.params_to_numpy(t), "cpu", torch.float64)
                         for t in (params, stats))
        return params, train_resnet.make_optimizer(params), stats

    def step(fn):
        def run(p, o, s, i):
            images, labels = train_resnet.synthetic_batch(np.random.default_rng(i), 2, 32,
                                                          RESNET.num_classes)
            return fn(p, s, o, images.double(), labels, RESNET)
        return run

    return make, step(train_resnet.train_step), step(train_resnet.captured_step)


def _mnist_steps():
    rng = np.random.default_rng(0)
    init = train_mnist.init(rng)
    x, y = (torch.from_numpy(a) for a in train_mnist.synthetic_data(rng, 64))

    def make():
        params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
        return params, train_mnist.make_optimizer(params), None

    def step(fn):
        return lambda p, o, s, i: (fn(p, o, x, y), s)  # full batch: one input every step

    return make, step(train_mnist.train_step), step(train_mnist.captured_step)


MODELS = {"llama": _llama_steps, "bert": _bert_steps, "mixtral": _mixtral_steps,
          "resnet_f64": _resnet_steps, "mnist": _mnist_steps}


def trajectory(make, step, n=STEPS):
    params, opt, state = make()
    losses = []
    for i in range(n):
        loss, state = step(params, opt, state, i)
        losses.append(loss)
    return losses, params, state, opt


@pytest.mark.parametrize("name", sorted(MODELS))
def test_owner_steps_equal_the_eager_steps_bitwise(owner_on_cpu, monkeypatch, name):
    if name == "resnet_f64":
        monkeypatch.setattr(TTR, "_capture", functools.partial(rerun_capture,
                                                               dtype=torch.float64))
    make, eager, captured = MODELS[name]()
    ref_losses, ref_params, ref_state, _ = trajectory(make, eager)
    captures, replays = TTR.StepGraphs.captures, TTR.StepGraphs.replays
    losses, params, state, _ = trajectory(make, captured)
    assert TTR.StepGraphs.captures == captures + 1
    assert TTR.StepGraphs.replays == replays + STEPS - 1
    assert [float(x) for x in losses] == [float(x) for x in ref_losses]
    assert all(torch.equal(a, b) for a, b in zip(losses, ref_losses))
    for a, b in zip(TT.leaves(params), TT.leaves(ref_params), strict=True):
        assert torch.equal(a, b)
    if state is not None:
        for a, b in zip(TT.leaves(state), TT.leaves(ref_state), strict=True):
            assert torch.equal(a, b)


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(JA, "INTERPRET", True)
    monkeypatch.setattr(JA, "pallas_wanted", lambda: True)


def test_owner_llama_losses_match_jax(owner_on_cpu, jax_pallas):
    jcfg, tcfg = gqa_config()
    jparams = JT.init(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    opt = JTR.make_optimizer()
    state = opt.init(jparams)
    jstep = jax.jit(functools.partial(JTR.train_step, config=jcfg, optimizer=opt))
    topt = TTR.make_optimizer(tparams)
    ref, got = [], []
    for i in range(STEPS):
        toks = rows(10 + i, (2, 256), 512)
        jparams, state, loss = jstep(jparams, state, jnp.asarray(toks.numpy(), jnp.int32))
        ref.append(float(loss))
        got.append(float(TTR.captured_step(tparams, topt, toks, tcfg, "cpu")))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_one_capture_a_shape(owner_on_cpu):
    config, params = _llama()
    opt = TTR.make_optimizer(params)
    owner = TTR.step_graphs(params, opt)
    captures, replays = TTR.StepGraphs.captures, TTR.StepGraphs.replays
    for seq in (256, 256, 128, 256, 128):
        TTR.captured_step(params, opt, rows(seq, (1, seq), 512), config, "cpu")
    assert TTR.StepGraphs.captures == captures + 2  # S 256, then S 128
    assert TTR.StepGraphs.replays == replays + 3
    assert TTR.step_graphs(params, opt) is owner and len(owner._graphs) == 2
    # Another optimizer over the same tree is another owner.
    assert TTR.step_graphs(params, TTR.make_optimizer(params)) is not owner


def test_the_returned_loss_is_not_overwritten(owner_on_cpu):
    config, params = _llama()
    opt = TTR.make_optimizer(params)
    losses = [TTR.captured_step(params, opt, rows(i, (2, 256), 512), config, "cpu")
              for i in range(STEPS)]
    copies = [float(x) for x in losses]
    TTR.captured_step(params, opt, rows(9, (2, 256), 512), config, "cpu")
    assert [float(x) for x in losses] == copies and len(set(copies)) == STEPS


def test_the_owner_goes_with_the_weights_and_the_optimizer(monkeypatch):
    # A graph refers to no Python object (the stand-in that re-runs the
    # step would hold the optimizer through the step's closure).
    monkeypatch.setattr(TTR, "_graphed", lambda t: True)
    monkeypatch.setattr(TTR, "_capture", lambda fn: ((lambda: None), torch.zeros(())))
    config, params = _llama()
    opt = TTR.make_optimizer(params)
    TTR.captured_step(params, opt, rows(0, (1, 256), 512), config, "cpu")
    owner = weakref.ref(TTR.step_graphs(params, opt))
    n = len(TTR._STEP_GRAPHS)
    # A new optimizer over the same weights: the old one's owner goes with it.
    opt = TTR.make_optimizer(params)
    gc.collect()
    assert owner() is None and len(TTR._STEP_GRAPHS) == n - 1
    TTR.captured_step(params, opt, rows(0, (1, 256), 512), config, "cpu")
    owner = weakref.ref(TTR.step_graphs(params, opt))
    del opt
    params["layers"].pop("wq")  # with the optimizer gone, one leaf freed is enough
    gc.collect()
    assert owner() is None and len(TTR._STEP_GRAPHS) == n - 1


def test_resnet_stats_tree_keeps_its_identity(owner_on_cpu):
    make, eager, captured = _resnet_steps()
    params, opt, stats = make()
    first = stats
    leaves = TT.leaves(stats)
    ref_losses, _, ref_stats, _ = trajectory(make, eager, 2)
    for i in range(2):
        _, stats = captured(params, opt, stats, i)
        assert stats is first
    assert all(a is b for a, b in zip(TT.leaves(stats), leaves))  # the same tensors
    for a, b in zip(TT.leaves(stats), TT.leaves(ref_stats), strict=True):
        assert torch.equal(a, b)
    assert float(stats["stem"]["var"].sub(1).abs().max()) > 0  # the new statistics
    # A call with another tree of the same shapes: its values go in first.
    other = {"stem": {k: v.clone() for k, v in ref_stats["stem"].items()},
             "stages": [[{k: {kk: vv.clone() for kk, vv in v.items()} for k, v in blk.items()}
                         for blk in stage] for stage in ref_stats["stages"]]}
    _, out = captured(params, opt, other, 2)
    assert out is first


def test_replays_add_the_launches_the_capture_counted(monkeypatch):
    # A capture runs the step's Python once (the wrappers count as they
    # record their launches, which execute nothing) and a replay runs none:
    # the owner takes back the capture's counts and adds them at each
    # replay. Here the stand-in capture runs the Python of a stateless toy
    # step whose "wrappers" count 2 forward and 1 dQ launch.
    monkeypatch.setattr(TTR, "_graphed", lambda t: True)

    def capture_runs_python(fn):
        return (lambda: None), fn()

    monkeypatch.setattr(TTR, "_capture", capture_runs_python)

    def toy(x):
        TA.flash_attention.launches += 2
        TA.flash_bwd_dq.launches += 1
        return x.sum()

    params = {"w": torch.ones(3)}
    owner = TTR.step_graphs(params, torch.optim.SGD([params["w"]], lr=0.1))
    before = TA.kernel_launches()
    for _ in range(4):  # warm-up and capture, then three replays
        owner.step("toy", toy, params, (torch.ones(2),))
    after = TA.kernel_launches()
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 8, "flash_bwd_dkdv": 0, "flash_bwd_dq": 4}


def test_the_leaves_hold_each_steps_gradients(owner_on_cpu):
    make, eager, captured = _llama_steps()
    params, opt, _ = make()
    ref_params, ref_opt, _ = make()
    for i in range(STEPS):
        captured(params, opt, None, i)
        eager(ref_params, ref_opt, None, i)
        for a, b in zip(TT.leaves(params), TT.leaves(ref_params)):
            assert torch.equal(a.grad, b.grad)


def test_make_optimizer_is_capturable_on_plain_cuda_leaves_only(monkeypatch):
    _, params = _llama()
    assert not TTR.make_optimizer(params).param_groups[0]["capturable"]  # CPU leaves
    monkeypatch.setattr(ADAM, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])
    opt = TTR.make_optimizer(params, capturable_step=True)
    assert opt.param_groups[0]["capturable"]
    assert TTR.capturable([torch.zeros(1)]) is False


def test_a_capturable_checkpoint_resumes_the_captured_step(owner_on_cpu, monkeypatch, tmp_path):
    # AdamW with capturable=True keeps its step count as an f32 tensor on
    # the parameters' device (the card; here the CPU, let through the
    # supported-device check): saved, restored into a fresh optimizer, and
    # the same next step from a fresh owner's warm-up as from the live
    # owner's replay.
    monkeypatch.setattr(ADAM, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])
    config = dataclasses.replace(gqa_config()[1], n_layers=1)

    def model(seed):
        params = TT.init(config, torch.Generator().manual_seed(seed), "cpu", dtype=torch.float32)
        return params, TTR.make_optimizer(params, capturable_step=True)

    params, opt = model(0)
    for i in range(2):
        TTR.captured_step(params, opt, rows(i, (1, 256), 512), config, "cpu")
    step = opt.state[TT.leaves(params)[0]]["step"]
    assert step.dtype == torch.float32 and float(step) == 2
    ckpt = checkpoint.TrainCheckpointer(str(tmp_path))
    ckpt.save(2, params, opt)
    fresh, fresh_opt = model(1)
    TTR.step_graphs(fresh, fresh_opt)
    n = len(TTR._STEP_GRAPHS)
    ckpt.restore(fresh, fresh_opt)
    assert len(TTR._STEP_GRAPHS) == n - 1  # the load dropped the fresh owner
    restored = fresh_opt.state[TT.leaves(fresh)[0]]["step"]
    assert restored.dtype == torch.float32 and float(restored) == 2
    captures = TTR.StepGraphs.captures
    live = TTR.captured_step(params, opt, rows(5, (1, 256), 512), config, "cpu")
    resumed = TTR.captured_step(fresh, fresh_opt, rows(5, (1, 256), 512), config, "cpu")
    assert TTR.StepGraphs.captures == captures + 1  # the live step replayed
    assert torch.equal(live, resumed)
    for a, b in zip(TT.leaves(params), TT.leaves(fresh), strict=True):
        assert torch.equal(a, b)


def test_tree_digest_tells_trees_apart(monkeypatch):
    # Summed a part at a time (here parts of 2048 elements, so that a leaf
    # spans several): equal trees agree, one flipped bit anywhere does not.
    monkeypatch.setattr(TTR, "_DIGEST_PART", 2048)
    tree = {"a": torch.randn(5000, generator=torch.Generator().manual_seed(0)),
            "b": [torch.arange(7, dtype=torch.float64), torch.ones(3, 3, dtype=torch.bfloat16)]}
    copy = {"a": tree["a"].clone(), "b": [t.clone() for t in tree["b"]]}
    assert TTR.tree_digest(tree) == TTR.tree_digest(copy)
    for leaf, i in ((copy["a"], 4097), (copy["b"][0], 6), (copy["b"][1], 4)):
        flat = leaf.view(-1)
        words = flat.view(torch.int16 if leaf.element_size() == 2 else
                          torch.int32 if leaf.element_size() == 4 else torch.int64)
        words[i] ^= 1
        assert TTR.tree_digest(tree) != TTR.tree_digest(copy)
        words[i] ^= 1
    assert TTR.tree_digest(tree) == TTR.tree_digest(copy)
