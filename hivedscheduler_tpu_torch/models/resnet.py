"""ResNet-50 (BASELINE config 2: one host's cards, data parallel).

Counterpart of ``hivedscheduler_tpu/models/resnet.py``. Functional, like
the JAX package's: ``init`` returns ``(params, batch_stats)``, ``forward``
takes images ``[B, H, W, 3]`` and returns ``(logits, new_stats)``. The
trees are the JAX package's (``stem``, ``stages`` as a list of stages, each
a list of block dicts with ``proj``/``bn_proj`` on a stage's first block,
``head``), so ``models/convert.py`` carries parameters and batch stats
across leaf for leaf.

Layout. The activations run in ``channels_last``: ``images.permute(0, 3,
1, 2)`` of a contiguous NHWC batch already has those strides, and every
conv, pad and pool keeps them. The conv weights stay HWIO in the tree, the
JAX layout, so conversion and checkpoints need no transpose; each conv
permutes its weight to OIHW ``channels_last`` in the same copy that casts
the f32 master to the compute dtype, which the JAX package pays for too
(``w.astype(x.dtype)``).

The convs are ``F.conv2d`` (cuDNN on the card): the JAX package computes
them with XLA's ``lax.conv_general_dilated``, not in a Pallas kernel, so
no conv here is a kernel port, and ResNet launches none of the port's
kernels. SAME padding is applied as XLA computes it: total =
max((ceil(n / s) - 1) * s + k - n, 0), low = total // 2, high = the rest.
At stride 2 and an even size that is asymmetric (the stem's 7x7/2, every
3x3/2 and the 3x3/2 max-pool), which PyTorch's symmetric ``padding``
cannot express, so those go through ``F.pad`` (the pool with -inf, as
``reduce_window``'s init value) and then a conv or pool with no padding.

Batch norm is written out in the JAX package's order, not
``nn.BatchNorm2d`` (whose running variance is the unbiased one and whose
momentum weighs the batch, not the history): statistics in f32 over (N, H,
W) with the biased variance, new stats = 0.9 * old + 0.1 * batch (no
gradient), y = (x - mean) * rsqrt(var + 1e-5) * scale + bias in f32, cast
back to x's dtype; in eval the stored stats. On an active mesh the
statistics are the global batch's, as GSPMD computes ``jnp.mean`` and
``jnp.var`` over a batch sharded on (dp, fsdp): each rank's sum is summed
over the batch axes (``sharding.all_reduce_sum``, whose backward sums the
ranks' gradients too) for the mean, and a second reduction of the squared
deviations gives the variance. The parameters are replicated DTensors
(parallelism is batch-only, as in the JAX package), and
``sharding.reduce_gradients`` and ``sharding.mean_over_batch`` finish the
step, so each leaf's gradient is that of the global mean loss and the
running stats come out equal on every rank.

An f64 model (``dtype=torch.float64``, f64 leaves) keeps f64 throughout,
statistics included. The tests use it: at random init the training
forward is so ill-conditioned (each block's deviations from a large
channel mean, statistics over a few values at the last stage) that two f32
evaluations that only sum in another order, the JAX package's and this
one, differ in their gradients by percents, while in f64 they agree to
about 1e-8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import Device, resolve_device
from ..parallel import sharding

Params = Dict[str, Any]

# (blocks per stage) for ResNet-50
STAGES = (3, 4, 6, 3)
STAGE_WIDTHS = (256, 512, 1024, 2048)
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16


def init(config: ResNetConfig, generator: torch.Generator, device: Device = None
         ) -> Tuple[Params, Params]:
    """(params, batch_stats) in f32, drawn from ``generator`` (on
    ``device``) in the JAX tree's order with its laws: convs normal *
    sqrt(2 / fan_in) in HWIO, BN scale 1 and bias 0, stats mean 0 and var
    1, the head normal / sqrt(2048)."""
    device = resolve_device(device)

    def normal(shape, scale):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(generator=generator).mul_(scale)

    def conv(k, cin, cout):
        return normal((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))

    def bn(c):
        return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}

    def stats(c):
        return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    params: Params = {"stem": {"conv": conv(7, 3, config.width), "bn": bn(config.width)},
                      "stages": []}
    batch_stats: Params = {"stem": stats(config.width), "stages": []}
    cin = config.width
    for n_blocks, cout in zip(STAGES, STAGE_WIDTHS):
        mid = cout // 4
        stage_p: List[Params] = []
        stage_s: List[Params] = []
        for b in range(n_blocks):
            block_p = {"conv1": conv(1, cin, mid), "bn1": bn(mid),
                       "conv2": conv(3, mid, mid), "bn2": bn(mid),
                       "conv3": conv(1, mid, cout), "bn3": bn(cout)}
            block_s = {"bn1": stats(mid), "bn2": stats(mid), "bn3": stats(cout)}
            if b == 0:
                block_p["proj"] = conv(1, cin, cout)
                block_p["bn_proj"] = bn(cout)
                block_s["bn_proj"] = stats(cout)
            stage_p.append(block_p)
            stage_s.append(block_s)
            cin = cout
        params["stages"].append(stage_p)
        batch_stats["stages"].append(stage_s)
    params["head"] = normal((STAGE_WIDTHS[-1], config.num_classes), 1 / math.sqrt(STAGE_WIDTHS[-1]))
    return params, batch_stats


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def distribute(params: Params, mesh: Any) -> Params:
    """A whole parameter tree (the same on every rank) as DTensors
    replicated on ``mesh``'s parameter sub-mesh: every logical axis is
    None."""
    pmesh = sharding.param_mesh(mesh)
    return tree_map(
        lambda t: sharding.distribute(t, sharding.placements_for((None,) * t.dim(), pmesh),
                                      pmesh), params)


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded for a SAME window where the padding is
    asymmetric; returns (x, the symmetric (h, w) padding left for the op)."""
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of ``x`` [N, C, H, W] (channels_last) by an HWIO weight,
    in ``x``'s dtype."""
    w = w.permute(3, 2, 0, 1).to(dtype=x.dtype, memory_format=torch.channels_last)
    x, padding = _pad_same(x, w.shape[2], stride)
    return F.conv2d(x, w, stride=stride, padding=padding)


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """``reduce_window(max, -inf, SAME)`` over H and W."""
    x, padding = _pad_same(x, k, stride, float("-inf"))
    return F.max_pool2d(x, k, stride, padding=padding)


def batch_mean(t: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """Per-channel mean of ``t`` [N, C, H, W] over (N, H, W): over the
    global batch on an active mesh (each rank's sum summed over the batch
    axes, whose backward sums too; every batch shard holds as many rows)."""
    total, count = t.sum(dim=(0, 2, 3)), t.numel() // t.shape[1]
    if sharding.is_active(mesh):
        total = sharding.all_reduce_sum(total, mesh, sharding.BATCH_AXES)
        count *= sharding.axes_size(sharding.BATCH_AXES, mesh)
    return total / count


def batch_norm(x: torch.Tensor, p: Params, s: Params, train: bool, mesh: Any = None
               ) -> Tuple[torch.Tensor, Params]:
    """Batch norm over (N, H, W) of ``x`` [N, C, H, W]; returns (y in x's
    dtype, new_stats). In training the statistics are the batch's (the
    global batch's on an active mesh): the mean, then the biased variance
    as the mean of the squared deviations, in f32 (f64 for f64 ``x``)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    view = (1, -1, 1, 1)
    if train:
        mean = batch_mean(x32, mesh)
        xc = x32 - mean.view(view)
        var = batch_mean(xc.square(), mesh)
        with torch.no_grad():
            new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                     "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var, new_s = s["mean"], s["var"], s
        xc = x32 - mean.view(view)
    inv = torch.rsqrt(var + BN_EPS) * p["scale"]
    return (xc * inv.view(view) + p["bias"].view(view)).to(x.dtype), new_s


def forward(params: Params, stats: Params, images: torch.Tensor, config: ResNetConfig,
            train: bool = False, mesh: Any = None) -> Tuple[torch.Tensor, Params]:
    """(logits [B, num_classes] f32, new_stats) of ``images`` [B, H, W, 3];
    on an active mesh this rank's rows, with the global batch's
    statistics."""
    p = sharding.to_local(params) if sharding.is_active(mesh) else params
    x = images.permute(0, 3, 1, 2).to(config.dtype)  # NCHW view, channels_last strides
    x = conv(x, p["stem"]["conv"], stride=2)
    x, stem_s = batch_norm(x, p["stem"]["bn"], stats["stem"], train, mesh)
    x = max_pool(F.relu(x))

    new_stats: Params = {"stem": stem_s, "stages": []}
    for stage_idx, (stage, stage_stats) in enumerate(zip(p["stages"], stats["stages"])):
        new_stage = []
        for b, (block, bs) in enumerate(zip(stage, stage_stats)):
            stride = 2 if (b == 0 and stage_idx > 0) else 1
            y, s1 = batch_norm(conv(x, block["conv1"]), block["bn1"], bs["bn1"], train, mesh)
            y, s2 = batch_norm(conv(F.relu(y), block["conv2"], stride), block["bn2"], bs["bn2"],
                               train, mesh)
            y, s3 = batch_norm(conv(F.relu(y), block["conv3"]), block["bn3"], bs["bn3"], train,
                               mesh)
            new_bs = {"bn1": s1, "bn2": s2, "bn3": s3}
            shortcut = x
            if "proj" in block:
                shortcut, new_bs["bn_proj"] = batch_norm(conv(x, block["proj"], stride),
                                                         block["bn_proj"], bs["bn_proj"], train,
                                                         mesh)
            x = F.relu(y + shortcut)
            new_stage.append(new_bs)
        new_stats["stages"].append(new_stage)

    pooled = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3))  # global pool
    return pooled @ p["head"], new_stats


def loss_fn(params: Params, stats: Params, images: torch.Tensor, labels: torch.Tensor,
            config: ResNetConfig, train: bool = True, mesh: Any = None
            ) -> Tuple[torch.Tensor, Params]:
    """(mean -log_softmax at ``labels``, new_stats). On an active mesh the
    mean is over this rank's rows: ``sharding.mean_over_batch`` gives the
    global one and ``sharding.reduce_gradients`` its gradient."""
    logits, new_stats = forward(params, stats, images, config, train, mesh)
    ll = F.log_softmax(logits, dim=-1).gather(-1, labels[:, None])
    return -ll.mean(), new_stats
