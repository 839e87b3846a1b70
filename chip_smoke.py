#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``hivedscheduler_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile] [--kernels-only]

Phases, in order, one result line each; any failed check raises and the
script exits non-zero (``--kernels-only`` stops after phase 3 and prints
neither the kernels line nor the last line, since no main path ran):

1. device  - needs CUDA; the card's name and power limit from nvidia-smi.
2. build   - compiles every kernel under hivedscheduler_tpu_torch/ops/csrc.
3. kernels - each kernel's wrapper against its plain PyTorch version on the
             card, at the main path's shapes and the edge cases (B2 at
             S8192, so that a tile never reads across a batch; a ragged
             S1000; S100, shorter than one tile; non-causal; f32; head_dim
             32/64/128), with the tolerances below; times the kernel, the
             plain version and the library call that computes the same
             function (a yardstick only: the port never calls it). The
             forward is timed at the serving shape, B4 S2048, and at the
             training shape, B1 S8192, where the backward kernels are
             checked and timed too; there a second launch of each kernel
             must give bitwise-equal outputs. The perf harness's shapes
             (8 heads without GQA at B2 S8192, B1 S16384 and B1 S32768)
             are held too, and Llama-3-8B's attention as one rank of a tp
             gang holds it at B1 S8192 (H16/Hkv4, H8/Hkv2, H4/Hkv1 for tp
             2, 4, 8), where all three kernels are also timed. So is
             Ulysses' per-rank attention in the longctx twin's meshes (tp 4,
             the rest sp: H4/Hkv1, H2/Hkv2, H1/Hkv1 for 8, 16 and 32
             cards), held and timed at B1 S32768 and timed again at B1
             S131072, the twin's default length, beside SDPA. The plain
             versions run one (batch row, KV head) block at a time, which
             is what the card holds at S32768, and one query head at a
             time where a group's f32 scores would pass 8 GiB. BERT-large's
             attention (non-causal, head_dim 64, S512: B8 H16 as one batch
             shard of its twin, B8 H8 as its tp 2 rank) and one microbatch
             of the pipeline twin's stage on four cards (B2 S4096 H16/Hkv4,
             causal) are held and timed with all three kernels too, and so
             is Mixtral's training batch (B4 S4096 H32/Hkv8 D128, causal),
             a tp 4 serving rank's prefill (B4 S2048 H8/Hkv2 D128,
             causal) and a Mixtral fsdp 2 x ep 2 serving rank's (B2 S2048
             H32/Hkv8 D128, causal) are held and timed beside SDPA.
4. serve   - full-width, 32-layer Llama-3-8B in bf16 with random weights
             from --seed: requests of batch 4 x prompt 2048 x 32 greedy new
             tokens through the serving entry point, after a warm-up request
             of the same shape (it captures the decode step's CUDA graph; no
             timed request may capture). Launch counts are set
             to 0 just before and read just after; every prefill layer must
             launch the flash kernel. Against the uncached ``forward()``
             over prompt + generated tokens, the first new token must be
             its argmax in >= 3 of 4 rows, and every generated token's logit
             must be within MAX_LOGIT_GAP of its position's best. Then the
             int8-quantized weights serve one request of the same traffic
             after a warm-up of that shape (its TTFT and decode rate beside
             bf16's); every prefill layer must launch the flash kernel; its
             tokens go to phase 8. The bf16 and the int8 request's prompts
             are then served once more through the eager decode loop (the
             captured step's plain version), whose tokens must equal the
             graph's; a ``decode_graph`` line gives the capture's ms, the
             replays, ms a step of both against the step's bound
             (``decode_bound``: weights and the whole cache read once) and
             both tok/s. Phases 6, 7 and 11 (b) do the same.
5. train   - after serving's weights are freed. (a) a tiny f32 model (4/2
             heads, head_dim 32, S 256, remat "flash") takes 2 AdamW steps
             on the card (the first captures the step's CUDA graph, the
             second replays it) and 2 on the CPU from the same weights: the
             losses, the step-1 gradients and the parameters must agree
             within TRAIN_TOL. (b) Llama-3-8B at full width, depth cut to 8
             layers, f32 master weights, bf16 compute, capturable AdamW,
             remat "flash", batch 1 x 8192 tokens from --seed: first 6
             steps of the eager plain version (``train.train_step``), then
             from the same seed 2 warm-up and 4 timed steps through the
             training entry point, every step a replay of the graph the
             first one captured (``train.captured_step``; the two trees do
             not fit the card together). Launch counts are set to 0 before
             and read after (a replay counts what its capture recorded);
             every step must launch the forward, dK/dV and dQ kernels once
             a layer (the forward once, not twice: the "flash" policy keeps
             its outputs). Losses must be finite, the first near ln(vocab)
             + 0.5, the last below the first; only the first step captures.
             The train-graph gate: the captured losses and the final
             parameters' digest (``train.tree_digest``) equal the eager
             run's bit for bit. The parameters after the warm-up steps are
             copied to the host for phase 8.
6. workloads - the jobs as the scheduler launches them. A one-pod,
             one-card bind info and the pod's HIVED_TPU_ENV block go to the
             pod's launcher (``workloads/launch.py``), which starts this
             script's ``--workloads-job`` as the pod's process with its
             per-card block (which must be the process's own); there, a
             token file of uint32 ids from --seed and the
             training entry point (``train.main``) at Llama-3-8B's full
             width, depth cut to WORKLOAD["layers"] (2; 1 when the disk
             cannot hold the checkpoint), ``--data``, batch 1 x 8192, 3
             steps, each launching every kernel once a layer; the state
             saved with ``TrainCheckpointer`` into a temporary directory
             (bytes, write and read seconds printed) and restored into
             fresh parameters and a fresh AdamW, which must equal the live
             ones bit for bit, as must one more captured step on each (the
             live graph's replay, the restored state's first capture). Then the
             serving entry point (``serve.main --ckpt``) on that checkpoint,
             whose greedy tokens must equal ``serve.run_request``'s on the
             trainer's parameters cast to bf16, and ``serve.main --ckpt
             --int8``, whose tokens must equal ``serve.run_request``'s on
             ``quantize.quantize_params`` of the trainer's f32 masters (after
             a warm-up request on them), and so must the eager loop's; every
             prefill layer must launch the flash kernel.
7. perf    - the perf harness (``models/perf.main``, its training steps
             replayed from captured graphs) with its decode,
             long-context and zoo stages, its artifact in a temporary file:
             no error or rejected row and no zoo error dict, every MFU in
             (0, 1], finite losses, the artifact written, and the train
             step and the attention benchmark launching all three kernels.
             The zoo (BERT-large 8 x 512, ResNet-50 64 x 224^2, the bench
             model's decode at batch 8 after 128 tokens) prints its rows;
             its BERT steps launch the forward twice a layer and each
             backward once, a step; its ResNet and decode launch none (the
             128-token prefill is shorter than the flash dispatch's 256, in
             both packages, so it runs the plain attention). The
             train-graph gate at the harness's model, seeds and shape (4
             eager steps, then 4 captured from the same weights). The
             harness's model then serves the zoo's decode shape (8 x 128 x
             32) through ``serve.run_request``, graph against eager.
8. sharded - a one-rank NCCL group (TCP store on 127.0.0.1) and the 6-axis
             mesh over it; NCCL's all-gather, reduce-scatter and all-reduce
             once each (the model skips collectives over one rank, so the
             steps below communicate nothing), then the step's calls
             (funcol's all-gather, reduce-scatter, all-reduce by sum and by
             max; c10d's in-place all-reduce; Ulysses' all-to-all,
             funcol's, in ``_AllToAll``, and ``_AllReduceSum``, each with
             its backward; a batched send and
             receive to itself) captured in one CUDA graph by the decode
             step's capture (``generate._capture``) and replayed on fresh
             inputs, each output equal to its input: the one capture of
             NCCL a one-card run can show; phase 5's model, seed and batch
             through the sharded step (``init_sharded``, ``shard_batch``,
             its DTensor AdamW capturable): 6 eager steps
             (``train.train_step``), then from the same seed 6 through
             ``make_train_step``, each a replay of the rank's graph after
             the first (one capture), 2 warm-up steps whose every leaf's
             bytes after them must equal phase 5's, then 4 timed: the 6
             losses and the parameters' digest must equal phase 5's
             captured run's and the eager mesh steps', bit for bit, each
             step launching every kernel once a layer
             (``[train_graph]`` line ``sharded_llama3_8b_8_layers``); its
             mean step ms is printed beside phase 5's.
             Then, after a warm-up request at the timed shape (it captures
             the mesh's decode step), phase 4's first prompt through the
             sharded serving path at 32 layers, decoding from the captured
             step with no capture: its 32 greedy tokens must equal phase
             4's, every prefill layer launching the flash kernel; then
             ``serve.build(..., int8=True, mesh=...)`` quantizes on the mesh
             and serves phase 4's int8 prompt the same way, whose 32 tokens
             must equal phase 4's int8 tokens bit for bit. Each is served
             once more through the eager mesh loop, whose tokens must
             equal the graph's (``decode_graph`` lines ``sharded`` and
             ``sharded_int8``). With two cards or more, a 2-rank
             (4 with four cards) NCCL gang of the tiny model
             (``tools/dryrun.py``, every row that fits: at 4 ranks the
             sequence rows ``fsdp_sp_tp`` and ``ulysses-sp``, sp 2 x tp 2
             under Ulysses, and the pipeline rows ``pp`` and ``pp-x-sp``
             too), each row's step through the owner of the captured steps
             (its warm-up, then one capture on every rank), must come
             within 5e-3 of the one-process loss, each rank launching each
             kernel as often as its row asks (once a layer; on a pipeline
             stage once a layer of the stage a microbatch). With four cards, the
             training gangs: each rank is this script's
             ``--train-gang-job NAME``, started by the pod's launcher on a
             four-card bind info, which runs the twin eagerly (its plain
             version), then through its entry point, every step after the
             first a replay of the rank's captured graph with the step's
             collectives inside: each rank's captured losses (and digests,
             where the twin prints them) must equal its eager run's bit
             for bit, with one capture; each rank logs capture ms, replays
             and peak. First the f64 gate: phase 12 (a)'s small ResNet in
             f64 at dp 4 (8 x 32^2, 3 SGD steps) against one card at the
             same global batch, eager and captured on each side: the
             losses, every parameter and running statistic within
             F64_GANG_TOL. Then the longctx twin (tp 4), GANG_STEPS (5)
             steps as every twin takes, its losses within GANG_TOL of the
             same model, seeds and batches on one card; so does the
             Mixtral twin (ep 4 x fsdp 1: two experts a
             rank, every rank holding all 4 rows; 2 layers, 4 x 4096),
             each rank launching the kernels as phase 11 (c) does (a
             replay counting what its capture recorded; the dryrun's
             ``ep-moe`` row launches none: Mixtral tiny's heads of 16); the
             ResNet twin runs at dp 4 (BASELINE config 2: 32 images of
             224^2 a card) against one card at batch 128 on the
             same seeds, its first loss (before any update) within
             GANG_TOL, the later ones logged with their gaps (in bf16 at
             random init a step of SGD moves them by more than rounding;
             the f64 gate holds the updates), its batch norm's running
             stats equal on the four ranks (their digest), with
             ``--profile`` each rank's idle share over one replay. Each
             training gang logs its first replay's ms and the mean of the
             replays after it beside one card's over the same steps. Then the
             serving gangs (SERVE_GANGS): Llama-3-8B (32 layers, 4 x 2048,
             32 greedy tokens, 2 requests) at tp 4 in bf16 and with
             ``--int8``, and Mixtral-8x7B (16 layers, the same traffic) at
             ``serve.mesh_layout``'s fsdp 2 x ep 2. The launcher starts this
             script's ``--serve-gang-job`` on each card, which runs
             ``serve.main`` with the gang's argv (every decode step replayed
             from the rank's captured graph, its collectives inside: one
             capture in the first request, none in the second), then
             serves the last request's prompt again through the eager mesh
             loop on the same weights: the rank's captured tokens must
             equal its eager tokens (the teacher-forced logit gaps are
             logged beside). Against the same argv on one card: the first
             new token agrees in >= 3 of 4 rows, every rank launches the
             flash kernel once a layer a request, the ranks' int8 shard
             digests are those of one card's quantized tree's tp blocks;
             TTFT, decode rate, ms a step against the rank's bound and peak
             memory a rank beside one card's. Last, the pipeline twin
             (Llama-3-8B's widths at 8 layers, batch 8 x 4096 in 4
             microbatches) at pp 2 x tp 2, then at pp 2 x sp 2 (``--sp 2``:
             Ulysses' all-to-alls inside each rank's graph, its kernels at
             B2 S4096 H16/Hkv4), both held as the longctx gang is to one
             one-card run. ``--gangs`` runs some of these (GANGS: dryrun,
             train, serve, pipeline, pipeline_ulysses). A last ``gang`` line gives
             each gang's kernel launches on each rank (the dryrun's rows
             and the training gangs': the four-card runs' launches by
             path). With one card, the summary records ``"nccl_ranks": 1``.
9. longctx - the long-context twin (``workloads/train_longctx.py``, on one
             card its steps from a captured graph) at
             Llama-3-8B's full width, depth cut to 2 layers, 3 steps of
             one 32768-token row from the twin's seeds (on one card sp is 1, so the
             kernels run at B1 S32768 H32). Every step must launch each
             kernel once a layer; losses finite and falling; step ms and
             tokens/s printed.
10. bert   - (a) a small f32 BERT (2 layers, d 128, 4 heads of 32, S256,
             non-causal: it reaches the kernels, which BERT tiny's S128
             and head_dim 16 do not) takes 2 AdamW steps of the BERT twin's
             step (``workloads/train_bert.py``) on the card and on the CPU
             from the same weights, held within TRAIN_TOL; (b) BERT-large at
             its published size (24 layers, d 1024, 16 heads, vocab 30522,
             S512), f32 masters, bf16 compute, full remat, batch 8 x 512
             with 15% masked: 6 eager steps, then from the same weights 2
             warm-up and 4 timed steps of the twin's ``captured_step`` on
             one fixed batch (the first captures): every step launches the
             forward kernel twice a layer (48) and each backward kernel once
             (24), losses finite and falling, the train-graph gate; step
             ms, tokens/s and peak memory printed. (a)'s card steps go
             through ``captured_step`` too, as do 11 (a)'s and 12 (a)'s.
11. mixtral - after phase 10's weights are freed. (a) a small f32
             Mixtral (2 layers, d 128, 4 heads of 32, 2 KV heads, 4 experts,
             top-2, S256: it reaches the kernels, which Mixtral tiny's
             head_dim 16 does not) takes 2 steps of the twin's step
             (``workloads/train_mixtral.py``, full remat) on the card and on
             the CPU from the same weights, held within TRAIN_TOL, each card
             step launching the forward twice a layer and each backward
             once; greedy tokens from one prompt through the ``ffn`` hook
             must be equal on both. (b) ``mixtral_8x7b`` served at every
             published width (vocab 32000, d 4096, 32/8 heads of 128, d_ff
             14336, 8 experts, top-2, capacity 1.25, theta 1e6), depth cut
             to 16 layers (46.96 GB in bf16; 32 would not fit one card):
             phase 4's traffic (batch 4 x prompt 2048 x 32 greedy tokens,
             2 requests after a warm-up of that shape) through
             ``serve.run_request``, the routed FFN inside the captured step;
             every prefill layer launches the forward kernel, the tokens are
             in range, and the prefill's last logits lie within
             MAX_LOGIT_GAP of an uncached ``forward()`` over the same prompt
             (the same tokens, so the same capacity); TTFT, decode rate and
             peak memory printed. (c) the twin's job at every width, depth
             cut to 2 layers (3,164,688,384 parameters), 4 x 4096 tokens a
             step from the twin's seeds, 2 warm-up and 4 timed steps, run
             once with ``--plain`` (eager) and once captured: each
             captured step launches the forward 4 times and each backward
             twice, losses finite, the first within LOSS_BAND of ln(32000)
             + 0.5 + the aux term, the last below the first, the
             train-graph gate on the twin's summary line; step ms,
             tokens/s and peak memory printed.
12. zoo    - (a) a small f64 ResNet (width 16, 10 classes, batch 4 x 32^2)
             takes 2 SGD steps of the ResNet twin's step on the card and on
             the CPU from the same weights: the losses, the step-1
             gradients, the parameters and the batch norm's running stats
             within TRAIN_TOL, no kernel launched. f64, not f32: at this
             shape the training forward's f32 rounding alone moves the
             gradients by percents (``tests/test_torch_resnet.py``). (b) the
             ResNet-50 twin (``workloads/train_resnet.py``) through the pod's
             launcher on phase 6's one-card bind info, at its published
             shape (32 x 224^2, 1000 classes, bf16), 2 warm-up and 4 timed
             steps (the reference's 20 cut to 6 for time): losses finite, the
             first within LOSS_BAND of ln(1000), the running stats moved
             from (0, 1); step ms, images/s and peak memory printed; run
             first with ``--plain`` (eager), then captured, the
             train-graph gate on the summaries' losses and digests
             (parameters and running stats). (c) the MNIST twin
             (``workloads/train_mnist.py``) on the card: 100 steps, the
             last loss below the first, ``done`` printed; then its steps
             from its seeds eagerly and captured in this process, the
             captured losses = the twin's, the train-graph gate.

Each train-graph gate prints a ``[train_graph]`` line: the model, capture
ms, captures and replays, captured and eager ms a step, peak GiB of each,
the losses of each, whether they and the digests are equal, and with
``--profile`` the captured step's idle share (phases 5, 7, 10, 11 (c), 12
(b) and (c)). Each phase logs its seconds. The lines before the last are nvidia-smi's
name and power limit, then one JSON object with each kernel's numbers (its
``launches_by_path``: serve, train, workloads, perf, sharded, longctx,
bert, mixtral, zoo: the perf harness's zoo stage with phase 12); the last
line is ``{"ok": true, "device": {...}}``, as it is after ``--gang-only``'s gangs
(its ``count`` the cards seen). Each
kernel's ``tp_shapes`` holds its numbers at phase 3's per-rank tp shapes,
``sp_shapes`` at the Ulysses per-rank shapes, ``bert_shapes`` at BERT's,
``pp_shapes`` at the pipeline stage's and ``mixtral_shapes`` at Mixtral's
training batch (B4 S4096 H32/Hkv8); the forward's ``serve_tp4_shape`` at a
tp 4 serving rank's prefill (B4 S2048 H8/Hkv2) and ``serve_ep_shape`` at a
Mixtral fsdp 2 x ep 2 serving rank's (B2 S2048 H32/Hkv8). In the kernels line, the forward's
``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``, ``library_ms`` and
``tflops`` are taken at the serving shape and ``ms_train``,
``plain_ms_train``, ``bound_ms_train``, ``bound_by_train``,
``library_ms_train`` and ``tflops_train`` at the training shape; the
backward kernels' numbers are at the training shape. Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# Kernel vs plain version. bf16: both take f32 scores and an f32 softmax;
# they differ by the summation order of QK^T and PV and by __expf, which can
# move an unnormalised probability across a bf16 rounding boundary (one bf16
# ulp is 2^-8 relative) and the output by about one bf16 ulp of |O| <= 1.
TOL_BF16 = {"o_max": 2e-2, "o_mean": 2e-3, "lse_max": 1e-3}
# f32: the same arithmetic in f32 throughout; only the order of sums and
# __expf's ~2 ulp differ.
TOL_F32 = {"o_max": 1e-4, "o_mean": 1e-5, "lse_max": 1e-4}

# Backward kernels vs their plain versions, as max and mean |delta| over
# max |reference| of each of dQ, dK, dV. bf16: the kernels round P and dS to
# bf16 (2^-9 relative) before P^T dO, dS^T Q and dS K, where the plain
# version keeps f32 (the JAX kernels' arithmetic), and both round their
# outputs to bf16, so one bf16 ulp (<= 2^-8 of max) can separate an element.
TOL_BWD_BF16 = {"max": 2e-2, "mean": 2e-3}
# f32: the same arithmetic; only the order of sums and expf's ulps differ.
TOL_BWD_F32 = {"max": 1e-4, "mean": 1e-5}

# Generated token vs forward()'s best logit at its position, on bf16 logits
# of magnitude < 16: 0.25 is four bf16 ulps there, the noise of two bf16
# paths through 32 layers (measured: at most 0.0625 at the 7% of decoded
# positions where the two argmaxes differ), while random weights put a
# random token's logit some 5 below the best.
MAX_LOGIT_GAP = 0.25

SERVE = {"batch": 4, "prompt": 2048, "new_tokens": 32, "requests": 2}
# Phase 4's int8 request: the bf16 requests' traffic, one request after a
# short warm-up (phase 8 serves its prompt again on a one-rank mesh).
INT8 = {"batch": 4, "prompt": 2048, "new_tokens": 32}

TRAIN = {"model": "llama3_8b", "layers": 8, "batch": 1, "seq": 8192, "warmup": 2,
         "timed": 4, "remat_policy": "flash"}
TINY_TRAIN = {"batch": 2, "seq": 256, "steps": 2}
# Tiny card-vs-CPU training, f32 throughout: the kernels sum in another
# order than the CPU's plain versions (~1e-6 relative). The step-1
# gradients are held leaf by leaf to the JAX package's 1e-4 of max |CPU|.
# The parameters after both steps are held only on the mean: Adam's update
# is about lr * sign(g) for each element, so a gradient near 0 that the two
# sides round to opposite signs moves its parameter 2 lr apart, however
# close the gradients are. The losses agree to 1e-4. Batch norm's running
# stats (phase 12, f64) are held leaf by leaf to 1e-6 of max |CPU|: a step
# of SGD at lr 0.1 on the small model throws its activations, and so its
# variances, far from 1.
TRAIN_TOL = {"loss": 1e-4, "grad_max_rel": 1e-4, "param_mean": 1e-6, "stats_max_rel": 1e-6}
# First loss of random init: logits of unit variance give about
# ln(vocab) + 0.5.
LOSS_BAND = 1.5

# Phase 6: the training job at Llama-3-8B's widths, depth cut to 2 layers so
# that its checkpoint (f32 weights and AdamW's two moments, 12 bytes a
# parameter) is some 18 GB of disk; "samples" rows of the token file.
WORKLOAD = {"model": "llama3_8b", "layers": 2, "batch": 1, "seq": 8192, "steps": 3,
            "samples": 6, "timeout_s": 600}
SERVE_CKPT = {"batch": 4, "prompt": 2048, "new_tokens": 8}
# Phase 8: Llama-3-8B's attention as one rank of a tp gang holds it (32/8
# heads over tp), held and timed in phase 3; the one-rank sharded serving
# request (phase 4's first prompt, its first new tokens).
TP_HEADS = {2: (16, 4), 4: (8, 2), 8: (4, 1)}
# Ulysses' per-rank attention in the longctx twin's meshes (tp 4, the rest
# sp): cards -> (sp, query heads, KV heads) of the local full-sequence call.
# At sp 4 and 8 the KV heads are first expanded to the query heads.
SP_SHAPES = {8: (2, 4, 1), 16: (4, 2, 2), 32: (8, 1, 1)}
# Held against the plain versions at SP_CHECK_SEQ; timed at the twin's
# default length too, where the plain version's [S, S] scores (68 GB a
# head) cannot exist.
SP_CHECK_SEQ, SP_TIME_SEQ = 32768, 131072
SHARDED_SERVE = {"batch": 4, "prompt": 2048, "new_tokens": 32}
# The serving gangs on four cards, each serve.main's argv against the same
# argv on one card: Llama-3-8B at 32 layers at tp 4 x fsdp 1 (every rank
# holds the 4 rows and a quarter of the heads), in bf16 and with --int8, and
# Mixtral-8x7B at phase 11 (b)'s 16 layers on mesh_layout's fsdp 2 x ep 2
# (each rank 2 of the rows and 4 of the 8 experts, gathered over fsdp a
# layer at a time). The first new token must agree with one card's in >= 3
# of 4 rows (the gang sums in another order).
_LLAMA_GANG = ["--model", "llama3_8b", "--batch", "4", "--prompt-len", "2048",
               "--new-tokens", "32", "--temperature", "0", "--requests", "2"]
SERVE_GANGS = {
    "serve": _LLAMA_GANG,
    "serve_int8": _LLAMA_GANG + ["--int8"],
    "serve_mixtral": ["--model", "mixtral_8x7b", "--layers", "16", "--batch", "4",
                      "--prompt-len", "2048", "--new-tokens", "32", "--temperature", "0",
                      "--requests", "2"],
}
# A tp 4 serving rank's prefill attention (Llama-3-8B's 32/8 heads over tp
# 4, phase 4's 4 x 2048) and a Mixtral fsdp 2 x ep 2 rank's (2 of the 4
# rows, every head): held and timed in phase 3.
SERVE_TP4_SHAPE = (4, 2048, 8, 2, 128, True)
SERVE_EP_SHAPE = (2, 2048, 32, 8, 128, True)
# Phase 3's attention at the shapes this slice's paths give the kernels:
# BERT-large (non-causal, 16 heads of 64, S512) as one batch shard of the
# twin holds it (B8) and as its tp 2 rank (H8), and one microbatch of the
# pipeline twin's stage on four cards (pp 2 x tp 2, batch 8 in M 4: B2,
# S4096, Llama-3-8B's heads over tp 2). name -> (B, S, H, Hkv, D, causal).
BERT_SHAPES = {"bert_b8_h16": (8, 512, 16, 16, 64, False),
               "bert_tp2_b8_h8": (8, 512, 8, 8, 64, False)}
PP_SHAPES = {"pp2_tp2_stage_mb": (2, 4096, 16, 4, 128, True)}
# Mixtral's training batch (the twin's 4 rows x 4096 on one card or one ep
# group): the kernels' new shape in phase 11; serving's prefill is phase 4's.
MIXTRAL_SHAPES = {"mixtral_train_b4_s4096": (4, 4096, 32, 8, 128, True)}
# The env block the scheduler writes for a one-pod gang (pod_tpu_env's keys).
POD_ENV = {"TPU_VISIBLE_CHIPS": "0", "TPU_WORKER_ID": "0", "JAX_PROCESS_ID": "0",
           "TPU_WORKER_HOSTNAMES": "localhost", "JAX_COORDINATOR_ADDRESS": "localhost:8476",
           "JAX_NUM_PROCESSES": "1"}
# Its pod-bind-info annotation (wire form): one pod on this node, card 0.
POD_BIND_INFO = {"node": "localhost", "leafCellIsolation": [0], "cellChain": "h100-32",
                 "affinityGroupBindInfo": [{"podPlacements": [
                     {"physicalNode": "localhost", "physicalLeafCellIndices": [0]}]}]}
# Phase 9: the longctx twin at Llama-3-8B's widths, depth cut to 2 layers.
LONGCTX = {"model": "llama8b", "layers": 2, "seq": 32768, "steps": 3}
# A gang's loss against one card's on the same bf16 model and tokens: tp
# reorders the row-parallel products' sums (bf16 activations, about 2^-8
# relative each), which moves a mean over 32767 targets near 12 by some
# 1e-3.
GANG_TOL = 1e-2
# Phase 10: (a) a small f32 BERT that reaches the kernels (S256, head_dim
# 32), two steps on the card and the CPU; (b) BERT-large at its published
# size (24 layers, d 1024, 16 heads, vocab 30522, S512), batch 8 x 512 (one
# batch shard of the twin), 2 warm-up and 4 timed steps.
BERT_SMALL = {"config": dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                             max_seq_len=256), "batch": 2, "steps": 2}
BERT_LARGE = {"batch": 8, "warmup": 2, "timed": 4}
# The pipeline twin on four cards (pp 2 x tp 2): Llama-3-8B's widths at
# phase 5's depth, batch 8 x 4096 in 4 microbatches, against the same
# model, seeds and batches on one card.
PIPELINE = {"model": "llama8b", "layers": 8, "batch": 8, "seq": 4096, "microbatches": 4}
# The pipeline gangs: name -> sp. pp 2 x tp 2, and pp 2 x sp 2, whose
# attention over sp is Ulysses' on the card ("auto": 32 heads and 8 KV heads
# divide by sp 2), each rank's kernels at B2 S4096 H16/Hkv4.
PIPELINE_GANGS = {"pipeline": 1, "pipeline_ulysses": 2}
# What --gang-only runs, in this order (--gangs picks some): the dryrun's
# rows, the training gangs, the serving gangs, the pipeline gangs.
GANGS = ("dryrun", "train", "serve", *PIPELINE_GANGS)
# Steps of each four-card training twin (and of its one-card run): the
# capture, the first replay, then the replays whose mean is the gang's step.
GANG_STEPS = 5
# Phase 11: (a) a small f32 Mixtral that reaches the kernels (S256, head_dim
# 32), two twin steps on the card and the CPU, then 8 greedy tokens; (b)
# Mixtral-8x7B's widths served at 16 layers (46.96 GB of bf16 weights); (c)
# the twin's job at 2 layers (f32 masters and AdamW: 50.6 GB), 4 x 4096.
MIXTRAL_SMALL = {"config": dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=256, n_experts=4, max_seq_len=256), "batch": 2,
                 "steps": 2, "new_tokens": 8}
MIXTRAL_SERVE = {"model": "mixtral_8x7b", "layers": 16, "batch": 4, "prompt": 2048,
                 "new_tokens": 32, "requests": 2}
MIXTRAL_TRAIN = {"layers": 2, "warmup": 2, "timed": 4}
# Phase 12: (a) a small f64 ResNet, two twin steps on the card and the CPU;
# (b) the ResNet-50 twin at its published shape; (c) the MNIST twin. The
# four-card gang: the twin at dp 4 against one card at the global batch.
RESNET_SMALL = {"config": dict(num_classes=10, width=16), "batch": 4, "size": 32, "steps": 2}
RESNET = {"batch": 32, "size": 224, "warmup": 2, "timed": 4}
RESNET_GANG = {"batch": 32, "steps": GANG_STEPS}
# The four-card f64 gate: phase 12 (a)'s small ResNet in f64 at dp 4 (a
# global batch of 8, two images a card) against one card at the global
# batch, over 3 SGD steps, eager and captured on each side. In f64 the two
# sides differ by the order of the batch's sums alone (2^-53 a rounding,
# grown by this ill-conditioned forward and by SGD's steps); in f32 that
# order moves the gradients by percents, and batch norm over each rank's
# own images moves the loss by more than 1e-2 (tests/test_torch_resnet_gang.py's
# control). Relative to each leaf's largest |value| (losses: to the loss).
RESNET_F64_GANG = {"config": dict(num_classes=10, width=16), "batch": 8, "size": 32,
                   "steps": 3}
F64_GANG_TOL = {"loss_rel": 1e-8, "leaf_max_rel": 1e-6}
# Phase 7's train-graph gate at the perf harness's model: steps of each run
# (the captured run's first captures, the rest replay).
PERF_GRAPH_STEPS = 4


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    by CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Matrix products of [S, D] by [D, S] size that each flash kernel does over
# the (q, k) pairs the mask keeps: forward QK^T and PV; dK/dV S, dV, dP and
# dK; dQ S, dP and dQ.
FLASH_PRODUCTS = {"fwd": 2, "dkdv": 4, "dq": 3}


def flash_flops(kind, b, s, h, d, causal) -> int:
    pairs = s * (s + 1) // 2 if causal else s * s
    return FLASH_PRODUCTS[kind] * 2 * d * pairs * b * h


def flash_bound_ms(kind, b, s, h, hkv, d, causal, dtype) -> tuple:
    """Least time for one flash kernel on this card: the larger of its
    operations over the peak rate of their type and its bytes over the
    memory rate, each input read once and each output written once. The
    forward reads q, k, v and writes o and LSE; each backward kernel reads
    q, k, v, dO, LSE and Delta and writes dK and dV, or dQ."""
    import torch

    from hivedscheduler_tpu_torch.models import perf

    elt = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes, row_bytes = elt * d * b * s * h, elt * d * b * s * hkv, 4 * b * h * s
    if kind == "fwd":
        nbytes = 2 * q_bytes + 2 * kv_bytes + row_bytes
    else:
        nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
        nbytes += 2 * kv_bytes if kind == "dkdv" else q_bytes
    peak = perf.H100_BF16_FLOPS if dtype == torch.bfloat16 else perf.H100_F32_FLOPS
    t_ops = flash_flops(kind, b, s, h, d, causal) / peak
    t_bytes = nbytes / perf.H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The most f32 score bytes one plain-version block may hold ([heads, S, S]);
# its probabilities and their gradient take as much again each.
PLAIN_BLOCK_BYTES = 8 * 2**30


def head_blocks(b, h, hkv, s):
    """(batch rows, query heads, KV head, LSE rows, last) of each block the
    plain versions run on: one (batch row, KV head) at a time, and one query
    head at a time where the group's f32 [S, S] scores would pass
    ``PLAIN_BLOCK_BYTES`` (4.3 GB a head at S32768: a 4-head group's
    scores and probabilities would not fit the card). ``last`` marks a
    (batch row, KV head)'s last block: its dK/dV sum over all of them."""
    grp = h // hkv
    step = grp if grp * 4 * s * s <= PLAIN_BLOCK_BYTES else 1
    for i in range(b):
        for g in range(hkv):
            for j in range(g * grp, (g + 1) * grp, step):
                yield (slice(i, i + 1), slice(j, j + step), slice(g, g + 1),
                       slice(i * h + j, i * h + j + step), j + step == (g + 1) * grp)


def check_fwd(name, q, k, v, causal, out, lse) -> dict:
    """The forward kernel's (out, lse) against its plain version on the same
    inputs, block by block (``head_blocks``); raises past TOL_BF16 or
    TOL_F32."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as A

    b, s, h, d = q.shape
    o_max = o_sum = lse_max = 0.0
    for rows, qh, kh, lrows, _ in head_blocks(b, h, k.shape[2], s):
        ref_out, ref_lse = A.flash_attention_reference(q[rows, :, qh], k[rows, :, kh],
                                                       v[rows, :, kh], causal)
        d_o = (out[rows, :, qh].float() - ref_out.float()).abs()
        o_max, o_sum = max(o_max, d_o.max().item()), o_sum + d_o.sum().item()
        lse_max = max(lse_max, (lse[lrows] - ref_lse).abs().max().item())
        del ref_out, ref_lse, d_o
    tol = TOL_BF16 if q.dtype == torch.bfloat16 else TOL_F32
    fields = {
        "case": name, "shape": [b, s, h, k.shape[2], d], "causal": causal,
        "dtype": str(q.dtype).replace("torch.", ""),
        "o_max_abs_err": o_max, "o_mean_abs_err": o_sum / out.numel(),
        "lse_max_abs_err": lse_max, "tol": tol,
    }
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if (fields["o_max_abs_err"] > tol["o_max"] or fields["o_mean_abs_err"] > tol["o_mean"]
            or fields["lse_max_abs_err"] > tol["lse_max"]):
        raise AssertionError(f"kernel disagrees with its plain version: {fields}")
    return fields


def time_fwd(q, k, v, causal) -> dict:
    """Device times of the forward kernel, its plain version (one call after
    one warm-up) and SDPA, with the kernel's bound and rate."""
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as A

    b, s, h, d = q.shape
    hkv = k.shape[2]
    fields = {"kernel_ms": cuda_ms(lambda: A.flash_attention(q, k, v, causal), 20)}
    fields["plain_ms"] = cuda_ms(lambda: A.flash_attention_reference(q, k, v, causal), 1,
                                 warmup=1)
    # Library yardstick: SDPA on [B, H, S, D] with K/V already repeated to H
    # heads (prepared outside the timed region).
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    fields["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 20
    )
    fields["bound_ms"], fields["bound_by"] = flash_bound_ms("fwd", b, s, h, hkv, d, causal,
                                                            q.dtype)
    fields["kernel_tflops"] = (
        flash_flops("fwd", b, s, h, d, causal) / (fields["kernel_ms"] * 1e-3) / 1e12
    )
    return fields


def phase_kernels(seed: int) -> dict:
    """Flash forward kernel vs its plain version at the serving shape, the
    serving gangs' ranks' and the edge cases; returns the numbers of the
    main-path case for the kernels line, the tp 4 rank's under
    ``serve_tp4`` and the fsdp 2 x ep 2 rank's under ``serve_ep``."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as A

    # (name, B, S, H, Hkv, D, causal, dtype, timed)
    cases = [
        ("main_path", 4, 2048, 32, 8, 128, True, torch.bfloat16, True),
        ("serve_tp4", *SERVE_TP4_SHAPE, torch.bfloat16, True),
        ("serve_ep", *SERVE_EP_SHAPE, torch.bfloat16, True),
        ("b2_s8192_causal", 2, 8192, 32, 8, 128, True, torch.bfloat16, False),
        ("b2_full", 2, 2048, 32, 8, 128, False, torch.bfloat16, True),
        ("ragged_causal", 2, 1000, 32, 8, 128, True, torch.bfloat16, False),
        ("ragged_full", 2, 1000, 32, 8, 128, False, torch.bfloat16, False),
        ("short_causal", 2, 100, 8, 2, 128, True, torch.bfloat16, False),
        ("bf16_full_d64", 2, 1000, 8, 2, 64, False, torch.bfloat16, False),
        ("bf16_causal_d32", 1, 300, 4, 2, 32, True, torch.bfloat16, False),
        ("f32_ragged_causal", 2, 1000, 32, 8, 128, True, torch.float32, False),
        ("f32_full_d64", 1, 512, 8, 2, 64, False, torch.float32, False),
        # The perf harness's shapes (phase 7): its attention bench and its
        # "268m" model (8 heads, no GQA) at 8k, 16k and 32k tokens.
        ("perf_attention", 2, 8192, 8, 8, 128, True, torch.bfloat16, False),
        ("perf_long_context", 1, 16384, 8, 8, 128, True, torch.bfloat16, False),
        ("perf_long_context_32k", 1, 32768, 8, 8, 128, True, torch.bfloat16, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kept = {}
    for name, b, s, h, hkv, d, causal, dtype, timed in cases:
        q = torch.randn(b, s, h, d, device="cuda", dtype=dtype, generator=gen)
        k = torch.randn(b, s, hkv, d, device="cuda", dtype=dtype, generator=gen)
        v = torch.randn(b, s, hkv, d, device="cuda", dtype=dtype, generator=gen)
        out, lse = A.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        fields = check_fwd(name, q, k, v, causal, out, lse)
        if timed:
            fields.update(time_fwd(q, k, v, causal))
        log("kernels", **fields)
        if name in ("main_path", "serve_tp4", "serve_ep"):
            kept[name] = fields
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return {**kept.pop("main_path"), **kept}


def bwd_stats(q, k, v, do, lse, delta, causal, dq, dk, dv) -> dict:
    """Max |delta|, sum |delta| and max |reference| of each gradient against
    the plain versions, block by block (``head_blocks``; a KV head's dK/dV
    summed over its query-head blocks before it is compared)."""
    from hivedscheduler_tpu_torch.ops import attention as A

    b, s, h, _ = q.shape
    stats = {grad: [0.0, 0.0, 0.0] for grad in ("dq", "dk", "dv")}

    def add(grad, got, ref):
        diff = (got.float() - ref.float()).abs()
        st = stats[grad]
        st[0], st[1] = max(st[0], diff.max().item()), st[1] + diff.sum().item()
        st[2] = max(st[2], ref.float().abs().max().item())

    ref_dk = ref_dv = None
    for rows, qh, kh, lrows, last in head_blocks(b, h, k.shape[2], s):
        qb, kb, vb, dob = q[rows, :, qh], k[rows, :, kh], v[rows, :, kh], do[rows, :, qh]
        add("dq", dq[rows, :, qh],
            A.flash_bwd_dq_reference(qb, kb, vb, dob, lse[lrows], delta[lrows], causal))
        # K/V in f32 (exactly their values: the plain version computes in
        # f32 throughout) keep the group's partial dK/dV unrounded, so that
        # their sum rounds once, as the whole group's does.
        part_dk, part_dv = A.flash_bwd_dkdv_reference(qb, kb.float(), vb.float(), dob,
                                                      lse[lrows], delta[lrows], causal)
        ref_dk = part_dk if ref_dk is None else ref_dk + part_dk
        ref_dv = part_dv if ref_dv is None else ref_dv + part_dv
        del part_dk, part_dv
        if last:
            add("dk", dk[rows, :, kh], ref_dk.to(dk.dtype))
            add("dv", dv[rows, :, kh], ref_dv.to(dv.dtype))
            ref_dk = ref_dv = None
    return stats


def time_bwd(q, k, v, out, do, lse, delta, causal) -> dict:
    """Device times of the Delta pre-pass, the two backward kernels, their
    plain versions (one call after one warm-up: the allocator's cache was
    just emptied) and SDPA's whole backward, with each kernel's bound."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as A

    b, s, h, d = q.shape
    hkv = k.shape[2]
    times = {}
    # The Delta pre-pass runs before both kernels; SDPA's backward includes
    # its own.
    delta_ms = cuda_ms(lambda: A.flash_bwd_delta(out, do), 5)
    for kind, kernel, plain in (
        ("dkdv", A.flash_bwd_dkdv, A.flash_bwd_dkdv_reference),
        ("dq", A.flash_bwd_dq, A.flash_bwd_dq_reference),
    ):
        ms = cuda_ms(lambda: kernel(q, k, v, do, lse, delta, causal), 5)
        plain_ms = cuda_ms(lambda: plain(q, k, v, do, lse, delta, causal), 1, warmup=1)
        torch.cuda.empty_cache()
        bound, by = flash_bound_ms(kind, b, s, h, hkv, d, causal, q.dtype)
        times[kind] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "tflops": flash_flops(kind, b, s, h, d, causal) / (ms * 1e-3) / 1e12}
    # Library yardstick: SDPA's backward on [B, H, S, D] with K/V repeated,
    # timed alone (the forward runs once, outside the timed region).
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    times["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 5
    )
    kernels_ms = times["dkdv"]["ms"] + times["dq"]["ms"]
    log("kernels", case="bwd_timing", shape=[b, s, h, hkv, d], causal=causal,
        dtype=str(q.dtype).replace("torch.", ""), dkdv=times["dkdv"], dq=times["dq"],
        delta_ms=delta_ms, sdpa_backward_ms=times["library_ms"], kernels_sum_ms=kernels_ms,
        kernels_sum_with_delta_ms=kernels_ms + delta_ms)
    return times


def phase_kernels_bwd(seed: int) -> dict:
    """The dK/dV and dQ kernels vs their plain versions; returns the
    main-path numbers for the kernels line. The main-path case is the
    training step's attention, B1 S8192: there the forward kernel is held to
    its plain version too, and all three kernels are timed."""
    import torch

    from hivedscheduler_tpu_torch.ops import attention as A

    # (name, B, S, H, Hkv, D, causal, dtype). B2 and the ragged and short
    # lengths catch a tile that reads across a batch or past S.
    cases = [
        ("bwd_main_path", TRAIN["batch"], TRAIN["seq"], 32, 8, 128, True, torch.bfloat16),
        ("bwd_b2_causal", 2, TRAIN["seq"], 32, 8, 128, True, torch.bfloat16),
        ("bwd_b2_ragged_causal", 2, 1000, 32, 8, 128, True, torch.bfloat16),
        ("bwd_ragged_causal", 1, 1000, 32, 8, 128, True, torch.bfloat16),
        ("bwd_short_causal", 2, 100, 8, 2, 128, True, torch.bfloat16),
        ("bwd_full", 1, 2048, 32, 8, 128, False, torch.bfloat16),
        ("bwd_bf16_full_d64", 2, 1000, 8, 2, 64, False, torch.bfloat16),
        ("bwd_f32_ragged_causal_d64", 1, 1000, 8, 2, 64, True, torch.float32),
        ("bwd_f32_full_d128", 1, 512, 8, 2, 128, False, torch.float32),
        ("bwd_bf16_causal_d32", 1, 300, 4, 2, 32, True, torch.bfloat16),
        ("bwd_perf_attention", 2, 8192, 8, 8, 128, True, torch.bfloat16),
        ("bwd_perf_long_context", 1, 16384, 8, 8, 128, True, torch.bfloat16),
        ("bwd_perf_long_context_32k", 1, 32768, 8, 8, 128, True, torch.bfloat16),
    ] + [(f"bwd_tp{tp}", TRAIN["batch"], TRAIN["seq"], h, hkv, 128, True, torch.bfloat16)
         for tp, (h, hkv) in TP_HEADS.items()
         ] + [(f"bwd_sp_cards{cards}", 1, SP_CHECK_SEQ, h, hkv, 128, True, torch.bfloat16)
              for cards, (_, h, hkv) in SP_SHAPES.items()
              ] + [(f"bwd_{label}", b, s, h, hkv, d, causal, torch.bfloat16)
                   for label, (b, s, h, hkv, d, causal) in {**BERT_SHAPES, **PP_SHAPES,
                                                            **MIXTRAL_SHAPES}.items()]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    main = {"tp_shapes": [], "sp_shapes": [], "bert_shapes": [], "pp_shapes": [],
            "mixtral_shapes": []}
    for name, b, s, h, hkv, d, causal, dtype in cases:
        q = torch.randn(b, s, h, d, device="cuda", dtype=dtype, generator=gen)
        k = torch.randn(b, s, hkv, d, device="cuda", dtype=dtype, generator=gen)
        v = torch.randn(b, s, hkv, d, device="cuda", dtype=dtype, generator=gen)
        do = torch.randn(b, s, h, d, device="cuda", dtype=dtype, generator=gen)
        out, lse = A.flash_attention(q, k, v, causal)
        delta = A.flash_bwd_delta(out, do)
        dk, dv = A.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
        dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        if name == "bwd_main_path":
            main["fwd"] = check_fwd("fwd_train_path", q, k, v, causal, out, lse)
            # No atomics: a second launch of each kernel gives the same bits.
            out2, lse2 = A.flash_attention(q, k, v, causal)
            dk2, dv2 = A.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
            dq2 = A.flash_bwd_dq(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise AssertionError("forward kernel: two launches on the same inputs differ")
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)):
                raise AssertionError("backward kernels: two launches on the same inputs differ")
            log("kernels", case="repeat_bitwise_equal", kernels=["fwd", "dkdv", "dq"],
                shape=[b, s, h, hkv, d])
            del out2, lse2, dk2, dv2, dq2
            torch.cuda.empty_cache()
            main["fwd"].update(time_fwd(q, k, v, causal))
            log("kernels", **main["fwd"])
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_F32
        fields = {"case": name, "shape": [b, s, h, hkv, d], "causal": causal,
                  "dtype": str(dtype).replace("torch.", ""), "tol": tol}
        for grad, got in (("dq", dq), ("dk", dk), ("dv", dv)):
            if got.shape != (q if grad == "dq" else k).shape or got.dtype != dtype:
                raise AssertionError(f"{name}: {grad} {tuple(got.shape)} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite {grad}")
        stats = bwd_stats(q, k, v, do, lse, delta, causal, dq, dk, dv)
        for grad, got in (("dq", dq), ("dk", dk), ("dv", dv)):
            max_err, sum_err, scale = stats[grad]
            fields[f"{grad}_max_abs_err"] = max_err
            fields[f"{grad}_max_rel"] = max_err / scale
            fields[f"{grad}_mean_rel"] = sum_err / got.numel() / scale
            if fields[f"{grad}_max_rel"] > tol["max"] or fields[f"{grad}_mean_rel"] > tol["mean"]:
                raise AssertionError(f"backward kernel disagrees with its plain version: {fields}")
        log("kernels", **fields)
        del dk, dv, dq
        torch.cuda.empty_cache()
        if name == "bwd_main_path":
            main["dkdv_max_abs_err"] = max(fields["dk_max_abs_err"], fields["dv_max_abs_err"])
            main["dq_max_abs_err"] = fields["dq_max_abs_err"]
            main.update(time_bwd(q, k, v, out, do, lse, delta, causal))
        elif name.startswith(("bwd_tp", "bwd_bert", "bwd_pp", "bwd_mixtral")):
            # One rank of a tp gang, BERT's attention, a pipeline stage's
            # microbatch, Mixtral's batch: the forward held and all three timed.
            fwd = check_fwd(name.replace("bwd_", "fwd_"), q, k, v, causal, out, lse)
            torch.cuda.empty_cache()
            fwd.update(time_fwd(q, k, v, causal))
            log("kernels", **fwd)
            label = name[len("bwd_"):]
            group = next(g for g in GROUPS if label.startswith(g))
            row = {"tp": int(label[2:])} if group == "tp" else {"label": label}
            main[f"{group}_shapes"].append({
                **row, "shape": [b, s, h, hkv, d], "causal": causal, "fwd": fwd,
                "dkdv_max_abs_err": max(fields["dk_max_abs_err"], fields["dv_max_abs_err"]),
                "dq_max_abs_err": fields["dq_max_abs_err"],
                **time_bwd(q, k, v, out, do, lse, delta, causal)})
        elif name.startswith("bwd_sp"):
            # One rank of a longctx gang under Ulysses: the forward held
            # too; all three timed here and at SP_TIME_SEQ.
            cards = int(name[len("bwd_sp_cards"):])
            fwd = check_fwd(name.replace("bwd_", "fwd_"), q, k, v, causal, out, lse)
            log("kernels", **fwd)
            torch.cuda.empty_cache()
            main["sp_shapes"].append({
                "cards": cards, "sp": SP_SHAPES[cards][0], "tp": 4,
                "fwd_max_abs_err": fwd["o_max_abs_err"],
                "dkdv_max_abs_err": max(fields["dk_max_abs_err"], fields["dv_max_abs_err"]),
                "dq_max_abs_err": fields["dq_max_abs_err"],
                **time_sp(q, k, v, out, do, lse, delta, causal, gen)})
            log("kernels", case=f"sp_timing_cards{cards}", **main["sp_shapes"][-1])
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return main


def time_sp(q, k, v, out, do, lse, delta, causal, gen) -> dict:
    """Ulysses' per-rank shape: each kernel's device time and bound at the
    checked length and at SP_TIME_SEQ, the plain versions' at the checked
    length (block by block, as they are held), SDPA's forward and whole
    backward at SP_TIME_SEQ (K/V repeated to the query heads)."""
    import torch
    import torch.nn.functional as F

    from hivedscheduler_tpu_torch.ops import attention as A

    b, s, h, d = q.shape
    hkv = k.shape[2]
    blocks = list(head_blocks(b, h, hkv, s))

    def plain(fn):
        def run():
            for rows, qh, kh, lrows, _ in blocks:
                fn(q[rows, :, qh], k[rows, :, kh], v[rows, :, kh], do[rows, :, qh],
                   lse[lrows], delta[lrows])
        return run

    kernels = {
        "fwd": (lambda: A.flash_attention(q, k, v, causal),
                plain(lambda q_, k_, v_, *_: A.flash_attention_reference(q_, k_, v_, causal))),
        "dkdv": (lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, causal),
                 plain(lambda *a: A.flash_bwd_dkdv_reference(*a, causal))),
        "dq": (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, causal),
               plain(lambda *a: A.flash_bwd_dq_reference(*a, causal))),
    }
    times = {}
    for kind, (kernel, ref) in kernels.items():
        bound, by = flash_bound_ms(kind, b, s, h, hkv, d, causal, q.dtype)
        times[kind] = {"ms_check": cuda_ms(kernel, 5), "plain_ms_check": cuda_ms(ref, 1, warmup=1),
                       "bound_ms_check": bound, "bound_by_check": by}
        torch.cuda.empty_cache()
    # The twin's default length: new inputs, the kernels and SDPA only.
    S = SP_TIME_SEQ
    qt, dot = (torch.randn(b, S, h, d, device="cuda", dtype=q.dtype, generator=gen)
               for _ in range(2))
    kt, vt = (torch.randn(b, S, hkv, d, device="cuda", dtype=q.dtype, generator=gen)
              for _ in range(2))
    ot, lt = A.flash_attention(qt, kt, vt, causal)
    dt = A.flash_bwd_delta(ot, dot)
    for kind, kernel in (("fwd", lambda: A.flash_attention(qt, kt, vt, causal)),
                         ("dkdv", lambda: A.flash_bwd_dkdv(qt, kt, vt, dot, lt, dt, causal)),
                         ("dq", lambda: A.flash_bwd_dq(qt, kt, vt, dot, lt, dt, causal))):
        bound, by = flash_bound_ms(kind, b, S, h, hkv, d, causal, q.dtype)
        times[kind].update(ms=cuda_ms(kernel, 3), bound_ms=bound, bound_by=by)
    qs = qt.transpose(1, 2).contiguous().requires_grad_()
    ks = kt.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
    vs = vt.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
    library_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal), 3)
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    dos = dot.transpose(1, 2).contiguous()
    library_bwd = cuda_ms(lambda: torch.autograd.grad(so, (qs, ks, vs), dos, retain_graph=True), 3)
    del qt, kt, vt, dot, ot, lt, dt, qs, ks, vs, so, dos
    torch.cuda.empty_cache()
    return {"shape": [b, S, h, hkv, d], "checked_shape": [b, s, h, hkv, d], **times,
            "library_fwd_ms": library_fwd, "library_bwd_ms": library_bwd}


def phase_serve(seed: int, profile: bool, model: str = "llama3_8b",
                device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import quantize, transformer
    from hivedscheduler_tpu_torch.ops import attention as A

    device = torch.device(device)
    t0 = time.perf_counter()
    config, params = serve.build(model, seed, device)
    torch.cuda.synchronize()
    log("serve", step="init", model=model, n_layers=config.n_layers,
        d_model=config.d_model, seconds=time.perf_counter() - t0,
        weights_gib=torch.cuda.memory_allocated() / 2**30)

    rng = np.random.default_rng(seed + 1)

    def prompt(batch, length):
        return torch.from_numpy(
            serve.synthetic_tokens(rng, batch, length, config.vocab_size)
        ).to(device)

    # Warm-up at the timed shape: cuBLAS handles, the kernel library's first
    # load, the decode step's capture.
    _reset_graph_counts()
    warm = serve.run_request(params, prompt(SERVE["batch"], SERVE["prompt"]), config,
                             SERVE["new_tokens"])

    prompts = [prompt(SERVE["batch"], SERVE["prompt"]) for _ in range(SERVE["requests"])]
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention.launches = 0
    results = [serve.run_request(params, p, config, SERVE["new_tokens"]) for p in prompts]
    launches = A.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(r["captures"] for r in results):
        raise AssertionError("a timed request captured a decode graph")
    check_decode_graph("serve", params, config, prompts[-1], SERVE["new_tokens"], results[-1],
                       warm["capture_ms"])
    if launches != config.n_layers * SERVE["requests"]:
        raise AssertionError(
            f"flash kernel launched {launches} times for {SERVE['requests']} "
            f"prefills of {config.n_layers} layers"
        )
    for r, res in enumerate(results):
        toks = res["tokens"]
        if toks.shape != (SERVE["batch"], SERVE["new_tokens"]):
            raise AssertionError(f"request {r}: tokens of shape {tuple(toks.shape)}")
        if not ((toks >= 0) & (toks < config.vocab_size)).all():
            raise AssertionError(f"request {r}: token ids out of range")
        log("serve", step="request", request=r, **SERVE,
            ttft_ms=res["ttft_ms"], decode_tok_s=res["decode_tok_s"],
            flash_launches=res["flash_launches"])

    # The uncached forward() over the prompt and the generated tokens, teacher
    # forced: its argmax at the prompt's last position must be the first new
    # token, and at each later position the next one (this holds the KV-cache
    # decode path against the flash path). bf16 near-ties may flip a few, so
    # each generated token's forward() logit must lie within MAX_LOGIT_GAP of
    # that row's best; a wrong cache position, mask or RoPE offset picks
    # tokens whose logit lies about as far below the best as a random one's.
    toks = results[-1]["tokens"]
    full = torch.cat([prompts[-1], toks[:, :-1]], dim=1)
    with torch.inference_mode():
        logits = transformer.forward(params, full, config)[:, SERVE["prompt"] - 1:]
    if not torch.isfinite(logits).all():
        raise AssertionError("forward() logits are not finite")
    pred = logits.argmax(-1)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - logits.gather(-1, toks[..., None])[..., 0]  # 0 where agreed
    del logits
    agree = int((pred[:, 0] == toks[:, 0]).sum())
    decode_agree = (pred[:, 1:] == toks[:, 1:]).float().mean().item()
    if agree < 3:
        raise AssertionError(f"first token agrees with forward() argmax in {agree}/4 rows")
    if gap.max().item() > MAX_LOGIT_GAP:
        raise AssertionError(
            f"a generated token's forward() logit lies {gap.max().item()} below the best"
        )
    log("serve", step="check", first_token_agrees_rows=agree,
        decode_tokens_agree=decode_agree, max_logit_gap=gap.max().item(),
        median_top2_margin=(top2[..., 0] - top2[..., 1]).median().item(),
        peak_memory_gib=peak_gib)

    if profile:
        profile_request(params, prompts[-1], config, results[-1])

    qparams = quantize.quantize_params(params)
    del params
    torch.cuda.empty_cache()
    _reset_graph_counts()
    warm = serve.run_request(qparams, prompt(INT8["batch"], INT8["prompt"]), config,
                             INT8["new_tokens"])  # warm-up at the timed shape, as for bf16
    int8_prompt = prompt(INT8["batch"], INT8["prompt"])
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention.launches = 0
    res = serve.run_request(qparams, int8_prompt, config, INT8["new_tokens"])
    int8_launches = A.flash_attention.launches
    int8_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if int8_launches != config.n_layers:
        raise AssertionError(f"int8 request launched the flash kernel {int8_launches} times")
    if not ((res["tokens"] >= 0) & (res["tokens"] < config.vocab_size)).all():
        raise AssertionError("int8 request: token ids out of range")
    log("serve", step="int8", **INT8, ttft_ms=res["ttft_ms"],
        decode_tok_s=res["decode_tok_s"], flash_launches=int8_launches,
        peak_memory_gib=int8_peak_gib, captures=res["captures"],
        bf16_ttft_ms=results[-1]["ttft_ms"], bf16_decode_tok_s=results[-1]["decode_tok_s"])
    check_decode_graph("serve_int8", qparams, config, int8_prompt, INT8["new_tokens"], res,
                       warm["capture_ms"])
    return {"launches": launches + int8_launches, "results": results,
            "prompt0": prompts[0].cpu(), "tokens0": results[0]["tokens"].cpu(),
            "int8_prompt": int8_prompt.cpu(), "int8_tokens": res["tokens"].cpu()}


def phase_train(seed: int, profile: bool) -> dict:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import train as entry
    from hivedscheduler_tpu_torch.models import convert, perf, train, transformer
    from hivedscheduler_tpu_torch.ops import attention as A
    from hivedscheduler_tpu_torch.serve import synthetic_tokens

    # (a) tiny: the autograd wiring through the f32 kernels against the CPU.
    config = dataclasses.replace(transformer.tiny(), remat=True, remat_policy="flash")
    cpu_params = transformer.init(config, torch.Generator().manual_seed(seed), "cpu",
                                  dtype=torch.float32)
    card_params = convert.params_from_jax(convert.params_to_numpy(cpu_params), device="cuda")
    toks = torch.from_numpy(synthetic_tokens(np.random.default_rng(seed + 3), TINY_TRAIN["batch"],
                                             TINY_TRAIN["seq"], config.vocab_size))

    def run_tiny(params, tokens):
        """The steps' records and the step-1 gradients (on the CPU)."""
        recs, grads = [], None
        for rec in entry.run(params, config, tokens, TINY_TRAIN["steps"]):
            recs.append(rec)
            if grads is None:
                grads = [t.grad.detach().cpu().clone() for t in transformer.leaves(params)]
        return recs, grads

    cpu_recs, cpu_grads = run_tiny(cpu_params, toks)
    card_recs, card_grads = run_tiny(card_params, toks.cuda())
    loss_gap = max(abs(a["loss"] - c["loss"]) for a, c in zip(cpu_recs, card_recs))
    grad_rel = max(((a - c).abs().max() / a.abs().max().clamp_min(1e-30)).item()
                   for a, c in zip(cpu_grads, card_grads))
    diffs = [(a.detach() - c.detach().cpu()).abs()
             for a, c in zip(transformer.leaves(cpu_params), transformer.leaves(card_params))]
    param_mean = sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs)
    fields = {"losses_cpu": [r["loss"] for r in cpu_recs],
              "losses_card": [r["loss"] for r in card_recs], "loss_gap": loss_gap,
              "grad_max_rel": grad_rel, "param_max_abs_diff": max(d.max().item() for d in diffs),
              "param_mean_abs_diff": param_mean, "tol": TRAIN_TOL,
              "launches_per_step": [r["launches"] for r in card_recs]}
    for r in card_recs:
        if set(r["launches"].values()) != {config.n_layers}:
            raise AssertionError(f"tiny train step launches {r['launches']}, not {config.n_layers} each")
    if (loss_gap > TRAIN_TOL["loss"] or grad_rel > TRAIN_TOL["grad_max_rel"]
            or param_mean > TRAIN_TOL["param_mean"]):
        raise AssertionError(f"tiny training on the card disagrees with the CPU: {fields}")
    log("train", step="tiny_card_vs_cpu", **fields)
    del card_params, cpu_params

    # (b) Llama-3-8B widths, depth cut to 8 layers, through the entry point:
    # first the eager plain version from the same seed and batch, whose
    # losses and final digest the captured steps must repeat (two trees of
    # 8 layers and their AdamW do not fit the card together).
    steps = TRAIN["warmup"] + TRAIN["timed"]
    config, params = entry.build(TRAIN["model"], seed, "cuda", TRAIN["layers"],
                                 TRAIN["remat_policy"])
    tokens = torch.from_numpy(synthetic_tokens(np.random.default_rng(seed + 1), TRAIN["batch"],
                                               TRAIN["seq"], config.vocab_size)).cuda()
    optimizer = train.make_optimizer(params)
    eager = run_steps(lambda: train.train_step(params, optimizer, tokens, config),
                      lambda: params, steps)
    del params, optimizer
    _free_card()
    t0 = time.perf_counter()
    config, params = entry.build(TRAIN["model"], seed, "cuda", TRAIN["layers"],
                                 TRAIN["remat_policy"])
    n_param = perf.n_params(params)
    torch.cuda.synchronize()
    log("train", step="init", model=TRAIN["model"], n_layers=config.n_layers,
        d_model=config.d_model, n_params=n_param, seconds=time.perf_counter() - t0,
        weights_gib=torch.cuda.memory_allocated() / 2**30)
    optimizer = train.make_optimizer(params)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    _reset_train_graph_counts()
    recs = list(entry.run(params, config, tokens, TRAIN["warmup"], optimizer=optimizer))
    # Phase 8's reference: every leaf's bytes after the warm-up steps, on
    # the host (the card does not hold a second 8-layer AdamW state).
    after_warmup = [t.detach().cpu() for t in transformer.leaves(params)]
    for r in entry.run(params, config, tokens, TRAIN["timed"], optimizer=optimizer):
        recs.append({**r, "step": len(recs)})
    launches = entry.kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for r in recs:
        log("train", step=f"step_{r['step']}", **{k: v for k, v in r.items() if k != "step"})
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    expected = float(np.log(config.vocab_size)) + 0.5
    if abs(losses[0] - expected) > LOSS_BAND:
        raise AssertionError(f"first loss {losses[0]} is not within {LOSS_BAND} of {expected}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
    for r in recs:
        if set(r["launches"].values()) != {config.n_layers}:
            raise AssertionError(
                f"train step {r['step']} launched {r['launches']}; each kernel must launch "
                f"{config.n_layers} times (the forward once a layer under remat 'flash')"
            )
    if [r["captured"] for r in recs] != [True] + [False] * (len(recs) - 1):
        raise AssertionError(f"captures by step: {[r['captured'] for r in recs]}; only the "
                             "first step may capture")
    timed = recs[TRAIN["warmup"]:]
    step_ms = sum(r["step_ms"] for r in timed) / len(timed)
    tok_s = TRAIN["batch"] * TRAIN["seq"] / (step_ms * 1e-3)
    flops_tok = perf.flops_per_token(config, n_param, TRAIN["seq"])
    summary = {"n_params": n_param, "losses": losses, "step_ms_mean": step_ms,
               "step_ms": [r["step_ms"] for r in timed], "tokens_per_s": tok_s,
               "flops_per_token": flops_tok, "bf16_peak_share": flops_tok * tok_s / perf.H100_BF16_FLOPS,
               "peak_memory_gib": peak_gib, "launches": launches}
    log("train", step="summary", **{k: v for k, v in summary.items() if k != "losses"})
    captured = {"losses": losses, "step_ms": [r["step_ms"] for r in recs],
                "digest": train.tree_digest(params), "peak_gib": peak_gib}
    check_train_graph("llama3_8b_8_layers", eager, captured, TRAIN["warmup"],
                      profile and (lambda: profile_train_step(params, optimizer, tokens, config,
                                                              step_ms)))
    del params, optimizer, tokens
    _free_card()
    return {**summary, "after_warmup": after_warmup, "digest": captured["digest"]}


def _equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


def _tree_equal(a, b) -> bool:
    from hivedscheduler_tpu_torch.models import transformer

    return all(_equal(x, y) for x, y in zip(transformer.leaves(a), transformer.leaves(b)))


def _reset_launches() -> None:
    from hivedscheduler_tpu_torch.ops import attention as A

    A.flash_attention.launches = A.flash_bwd_dkdv.launches = A.flash_bwd_dq.launches = 0


def _reset_graph_counts() -> None:
    from hivedscheduler_tpu_torch.models import generate

    generate.Decoder.captures = generate.Decoder.replays = 0
    generate.Decoder.capture_s = 0.0


def _reset_train_graph_counts() -> None:
    from hivedscheduler_tpu_torch.models import train

    train.StepGraphs.captures = train.StepGraphs.replays = 0
    train.StepGraphs.capture_s = 0.0


def _free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def run_steps(step, tree, steps: int) -> dict:
    """``steps`` calls of ``step()`` (one training step; returns its loss),
    each timed on the host clock around a device sync, then the digest of
    ``tree()`` after them (``models/train.tree_digest``, taken on the
    card) and the peak memory: one side of a phase's train-graph gate."""
    import torch

    from hivedscheduler_tpu_torch.models import train

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": step_ms, "digest": train.tree_digest(tree()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def check_train_graph(model: str, eager: dict, captured: dict, timed_from: int = 1,
                      profile=None) -> dict:
    """The train-graph gate of one model: over the phase's steps, the
    captured run's losses and the digest of its final parameters (and
    state) equal the eager run's bit for bit (the two run one after the
    other from the same seed: at 8B widths two trees do not fit), with one
    capture, made at the first step; ``timed_from`` on, every step is a
    replay. ``eager`` and ``captured`` are ``run_steps``'s fields (the
    captured run's step ms from ``timed_from`` on are the replays'; the
    eager run's from 1 on, its first step paying the lazy set-up).
    The graphs' counts are this process's (``StepGraphs``) unless
    ``captured["graph"]`` gives them (a launched child's). ``profile()``,
    when given, profiles one more captured step and returns its idle
    share. Logs the ``train_graph`` line and returns its fields."""
    from hivedscheduler_tpu_torch.models import train

    def mean(xs):
        return sum(xs) / len(xs)

    graph = captured.get("graph") or {
        "captures": train.StepGraphs.captures, "replays": train.StepGraphs.replays,
        "capture_ms": train.StepGraphs.capture_s * 1e3}
    captured_ms = mean(captured["step_ms"][timed_from:])
    eager_ms = mean(eager["step_ms"][1:])
    fields = {
        "model": model, "steps": len(captured["losses"]), **graph,
        "captured_ms_step": captured_ms, "eager_ms_step": eager_ms,
        "speedup": eager_ms / captured_ms, "peak_gib": captured["peak_gib"],
        "eager_peak_gib": eager["peak_gib"],
        "losses_equal": captured["losses"] == eager["losses"],
        "digest_equal": captured["digest"] == eager["digest"],
        "losses": captured["losses"], "eager_losses": eager["losses"],
    }
    if not (fields["losses_equal"] and fields["digest_equal"]):
        raise AssertionError(f"{model}: the captured steps differ from the eager steps: {fields}")
    if (graph["captures"], graph["replays"]) != (1, len(captured["losses"]) - 1):
        raise AssertionError(f"{model}: {graph['captures']} captures and {graph['replays']} "
                             "replays: one capture, at the first step, then replays")
    fields["idle_share"] = profile() if profile else None
    log("train_graph", **fields)
    return fields


def decode_bound(params, config, batch: int, s_max: int, mesh=None) -> dict:
    """Least time of one decode step on this card: the larger of its bytes
    over the memory rate (every weight read once, the embedding's B rows
    only, and the K and V of all ``s_max`` cache slots, which the step
    attends over) and its products over the bf16 peak (2 operations a
    weight a row). On an active mesh, one rank's step: ``batch`` is its
    rows, the weights are what its products read, its local shards
    gathered whole over fsdp where they shard there (counted from
    ``to_local``, since a DTensor's ``numel`` is global), and the cache is
    its rows and KV heads. ``gathered_bytes``: what the rank receives over
    fsdp a step, each leaf once (part of the weight bytes; the embedding
    table's besides). ``upcast_bytes``: what the eager einsum's f32 copy of
    K writes and reads on top, not counted in the bound."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from hivedscheduler_tpu_torch.models import generate, perf, transformer
    from hivedscheduler_tpu_torch.parallel import sharding

    def used(t):
        """(elements this rank's products read, of them received over fsdp)."""
        if not isinstance(t, DTensor):
            return t.numel(), 0
        local = t.to_local().numel()
        over_fsdp = dict(zip(t.device_mesh.mesh_dim_names, t.placements)).get("fsdp")
        n = sharding.axes_size("fsdp", mesh) if isinstance(over_fsdp, Shard) else 1
        return local * n, local * (n - 1)

    embed = params["embed"]
    read = [t for t in transformer.leaves(params) if t is not embed]
    if config.tied_embeddings:
        read.append(embed)
    weights = (sum(used(t)[0] * t.element_size() for t in read)
               + batch * config.d_model * embed.element_size())
    gathered = sum(used(t)[1] * t.element_size() for t in transformer.leaves(params))
    kv = config.n_kv_heads
    if sharding.is_active(mesh) and generate._heads_local(config, batch, mesh):
        kv //= sharding.axes_size("tp", mesh)
    elems = config.n_layers * batch * s_max * kv * config.head_dim
    cache = 2 * elems * (torch.finfo(config.dtype).bits // 8)
    products = 2 * batch * sum(used(t)[0] for t in read)
    t_bytes = (weights + cache) / perf.H100_BYTES_PER_S
    t_ops = products / perf.H100_BF16_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "weight_bytes": weights, "gathered_bytes": gathered, "cache_bytes": cache,
            "upcast_bytes": 8 * elems}


def check_decode_graph(phase: str, params, config, prompt, new_tokens: int, graph: dict,
                       capture_ms: float, ffn=None, mesh=None) -> None:
    """One request through the eager plain loop (``plain=True``) at the
    graph request's shape and prompt (on ``mesh``: this rank's rows): its
    tokens must equal the graph's. Logs the ``decode_graph`` line:
    captures, their time (the warm-up's), replays since
    ``_reset_graph_counts``, ms a step of both against the step's bound,
    tok/s of both."""
    import torch

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import generate

    replays, captures = generate.Decoder.replays, generate.Decoder.captures
    plain = serve.run_request(params, prompt, config, new_tokens, mesh=mesh, ffn=ffn, plain=True)
    if not torch.equal(plain["tokens"], graph["tokens"]):
        rows = (plain["tokens"] != graph["tokens"]).any(1).nonzero().flatten().tolist()
        raise AssertionError(f"{phase}: the captured decode's tokens differ from the eager "
                             f"loop's in rows {rows}")
    b, t = prompt.shape
    bound = decode_bound(params, config, b, t + new_tokens, mesh)
    step_ms = 1e3 * b / graph["decode_tok_s"]
    log("decode_graph", path=phase, batch=b, prompt=t, new_tokens=new_tokens,
        captures=captures, capture_ms=capture_ms, replays=replays,
        step_ms=step_ms, eager_step_ms=1e3 * b / plain["decode_tok_s"], **bound,
        bound_share=bound["bound_ms"] / step_ms,
        graph_tok_s=graph["decode_tok_s"], eager_tok_s=plain["decode_tok_s"],
        tokens_equal_eager=True)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_workloads(seed: int) -> dict:
    """The jobs as the scheduler launches them (see the module docstring,
    phase 6): the pod's launcher (``workloads/launch.py``) on a one-pod,
    one-card bind info and the scheduler's env block starts this script's
    ``--workloads-job`` as the pod's one process, which runs the training
    job, its checkpoint and resume, and the serving job. Returns each
    kernel's launches in the two entry points' runs, as the job counted
    them."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        bind_info = os.path.join(workdir, "pod-bind-info.json")
        with open(bind_info, "w") as f:
            json.dump(POD_BIND_INFO, f)
        env = dict(os.environ, HIVED_TPU_ENV="".join(f'{k}: "{v}"\n' for k, v in POD_ENV.items()))
        cmd = [sys.executable, "-m", "hivedscheduler_tpu_torch.workloads.launch",
               "--bind-info", bind_info, "--master-port", str(_free_port()),
               "--timeout", str(WORKLOAD["timeout_s"]), "--",
               "chip_smoke", "--workloads-job", workdir, "--seed", str(seed)]
        proc = subprocess.run(cmd, env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE, text=True,
                              timeout=WORKLOAD["timeout_s"] + 60)
        print(proc.stdout, end="", flush=True)  # the job's own lines
        if proc.returncode != 0:
            raise AssertionError(f"the launched workloads job exited {proc.returncode}")
        results = [json.loads(line)["workloads_job"] for line in proc.stdout.splitlines()
                   if line.startswith('{"workloads_job"')]
        if len(results) != 1:
            raise AssertionError("the launched workloads job printed no result")
        return results[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def workloads_job(seed: int, workdir: str) -> dict:
    """The pod's process of phase 6, started by the launcher: the training
    job from a token file, its checkpoint, a bitwise resume, and the
    serving job on the checkpoint. Returns each kernel's launches in the
    two entry points' runs."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch import train as entry
    from hivedscheduler_tpu_torch.models import checkpoint, perf, quantize, train, transformer
    from hivedscheduler_tpu_torch.utils.data import TokenFileDataset

    launched = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES", "RANK", "LOCAL_RANK",
                                               "WORLD_SIZE", "MASTER_ADDR")}
    if launched != {"CUDA_VISIBLE_DEVICES": "0", "RANK": "0", "LOCAL_RANK": "0",
                    "WORLD_SIZE": "1", "MASTER_ADDR": "localhost"}:
        raise AssertionError(f"the launcher's per-card block is not this process's: {launched}")
    log("workloads", step="launched", **launched)
    # Disk for the checkpoint: f32 weights and two f32 moments.
    layers, config = WORKLOAD["layers"], None
    free = shutil.disk_usage(workdir).free
    for layers in (WORKLOAD["layers"], 1):
        config = dataclasses.replace(transformer.llama3_8b(), n_layers=layers)
        need = 12 * perf.n_params(transformer.init(config, torch.Generator(), "meta"))
        if need * 1.1 < free:
            break
    else:
        raise AssertionError(f"{free} bytes free cannot hold a {need}-byte checkpoint")
    log("workloads", step="disk", free_bytes=free, checkpoint_bytes_needed=need,
        layers=layers)

    tokens = np.random.default_rng(seed).integers(
        0, config.vocab_size, size=WORKLOAD["samples"] * WORKLOAD["seq"] + 1,
        dtype=np.uint32)
    data = os.path.join(workdir, "tokens.bin")
    tokens.tofile(data)

    _reset_launches()
    t0 = time.perf_counter()
    job = entry.main(["--model", WORKLOAD["model"], "--layers", str(layers),
                      "--batch", str(WORKLOAD["batch"]), "--seq", str(WORKLOAD["seq"]),
                      "--steps", str(WORKLOAD["steps"]), "--data", data,
                      "--seed", str(seed)])
    train_launches = entry.kernel_launches()
    losses = [r["loss"] for r in job.records]
    if os.environ.get("JAX_PROCESS_ID") != "0" or os.environ.get("JAX_NUM_PROCESSES") != "1":
        raise AssertionError("HIVED_TPU_ENV was not lifted into the environment")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    for r in job.records:
        if set(r["launches"].values()) != {layers}:
            raise AssertionError(f"train step {r['step']} launched {r['launches']}, "
                                 f"not {layers} each")
    log("workloads", step="train", layers=layers, losses=losses,
        step_ms=[r["step_ms"] for r in job.records], launches=train_launches,
        seconds=time.perf_counter() - t0)

    ckdir = os.path.join(workdir, "ckpt")
    ckpt = checkpoint.TrainCheckpointer(ckdir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(WORKLOAD["steps"], job.params, job.optimizer)
    write_s = time.perf_counter() - t0
    nbytes = _dir_bytes(ckdir)
    with torch.no_grad():
        served_ref = transformer.cast(job.params, config.dtype)  # what was saved, in bf16
        # What --int8 must serve: the saved f32 masters quantized (copies:
        # the step after the resume below moves the live masters).
        int8_ref = transformer.cast(quantize.quantize_params(job.params), config.dtype)

    fresh = transformer.init(config, torch.Generator(device="cuda").manual_seed(seed + 7),
                             "cuda", dtype=torch.float32)
    fresh_opt = train.make_optimizer(fresh)
    t0 = time.perf_counter()
    _, _, step = ckpt.restore(fresh, fresh_opt)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    live_state = job.optimizer.state_dict()["state"]
    rest_state = fresh_opt.state_dict()["state"]
    if not (step == WORKLOAD["steps"] and _tree_equal(job.params, fresh)
            and all(_equal(live_state[i][k], rest_state[i][k])
                    for i in live_state for k in live_state[i])):
        raise AssertionError("restored parameters or AdamW state differ from the saved ones")
    batch = torch.from_numpy(
        TokenFileDataset(data, WORKLOAD["seq"] - 1, np.uint32).gather([0])).cuda()
    # The captured step on each: the live trainer's graph replays, the
    # restored state's owner warms up and captures (its AdamW's step count
    # came back onto the card from the checkpoint).
    captures = train.StepGraphs.captures
    live_loss = train.captured_step(job.params, job.optimizer, batch, job.config)
    rest_loss = train.captured_step(fresh, fresh_opt, batch, job.config)
    if train.StepGraphs.captures != captures + 1:
        raise AssertionError("the live trainer's step after the save did not replay its graph")
    if not (torch.equal(live_loss, rest_loss) and _tree_equal(job.params, fresh)):
        raise AssertionError(f"a step after resume differs: loss {live_loss.item()} live, "
                             f"{rest_loss.item()} restored")
    log("workloads", step="checkpoint", bytes=nbytes, write_s=write_s, read_s=read_s,
        write_gb_s=nbytes / write_s / 1e9, read_gb_s=nbytes / read_s / 1e9,
        resume_bitwise=True, loss_after_resume=live_loss.item())
    del job, fresh, fresh_opt, live_state, rest_state, batch
    torch.cuda.empty_cache()

    prompt = torch.from_numpy(serve.synthetic_tokens(
        np.random.default_rng(seed + 1), SERVE_CKPT["batch"], SERVE_CKPT["prompt"],
        config.vocab_size)).cuda()
    launches = dict(train_launches)
    # The serving job on the checkpoint, in bf16 and with --int8: its tokens
    # must be the live masters' (cast to bf16; quantized from f32).
    for flags, live in (([], served_ref), (["--int8"], int8_ref)):
        out = io.StringIO()
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            results = serve.main(["--model", WORKLOAD["model"], "--layers", str(layers),
                                  "--ckpt", ckdir, "--batch", str(SERVE_CKPT["batch"]),
                                  "--prompt-len", str(SERVE_CKPT["prompt"]),
                                  "--new-tokens", str(SERVE_CKPT["new_tokens"]),
                                  "--temperature", "0", "--requests", "1",
                                  "--seed", str(seed), *flags])
        serve_launches = entry.kernel_launches()
        serve_s = time.perf_counter() - t0
        print(out.getvalue(), end="", flush=True)
        if f"restored checkpoint step {WORKLOAD['steps']} " not in out.getvalue():
            raise AssertionError("serve.main did not print the restored step")
        if serve_launches["flash_fwd"] != layers:
            raise AssertionError(f"serving prefill launched the flash kernel "
                                 f"{serve_launches['flash_fwd']} times for {layers} layers")
        _reset_graph_counts()
        warm = serve.run_request(live, prompt, config, SERVE_CKPT["new_tokens"])  # capture
        ref = serve.run_request(live, prompt, config, SERVE_CKPT["new_tokens"])
        if not torch.equal(results[0]["tokens"], ref["tokens"]):
            raise AssertionError(f"tokens served {flags} from the checkpoint differ from the "
                                 "trainer's parameters' tokens")
        check_decode_graph("workloads_int8" if flags else "workloads", live, config, prompt,
                           SERVE_CKPT["new_tokens"], ref, warm["capture_ms"])
        log("workloads", step="serve", int8=bool(flags), **SERVE_CKPT,
            ttft_ms=results[0]["ttft_ms"], decode_tok_s=results[0]["decode_tok_s"],
            tokens_equal_live=True, launches=serve_launches, seconds=serve_s)
        launches = {k: launches[k] + serve_launches[k] for k in launches}
        del results, ref, warm
        torch.cuda.empty_cache()
    del served_ref, int8_ref
    torch.cuda.empty_cache()
    return launches


def phase_perf(profile: bool) -> tuple:
    """The perf harness with its optional stages; fails on any error or
    rejected row, a zoo error dict, an MFU outside (0, 1], a non-finite
    loss, a missing artifact or a kernel that a stage did not launch as it
    should. Returns each kernel's launches over the harness's run outside
    the zoo stage and inside it."""
    import math

    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import bert, perf, train, transformer
    from hivedscheduler_tpu_torch.ops import attention as A

    workdir = tempfile.mkdtemp(prefix="chip_smoke_perf_")
    knobs = {"HIVED_PERF_DECODE": "1", "HIVED_PERF_LONGCTX": "1", "HIVED_PERF_ZOO": "1",
             "HIVED_PERF_ARTIFACT": os.path.join(workdir, "perf.json")}
    saved_env = dict(os.environ)
    try:
        os.environ.update(knobs)
        _reset_launches()
        t0 = time.perf_counter()
        result = perf.main([])
        launches = A.kernel_launches()
        seconds = time.perf_counter() - t0
        rows = [result] + result["long_context"] + result["decode_sweep"] + [result["zoo"]]
        bad = [r for r in rows if "error" in r or "mfu_rejected" in r]
        if bad:
            raise AssertionError(f"perf rows failed: {bad}")
        zoo = result["zoo"]
        zoo_launches = {k: sum(n[k] for n in zoo["launches"].values()) for k in launches}
        # One warm-up and 4 timed calls a stage; BERT-large's full remat
        # runs the forward twice a layer.
        layers = bert.bert_large().n_layers
        want = {"bert": {"flash_fwd": 5 * 2 * layers, "flash_bwd_dkdv": 5 * layers,
                         "flash_bwd_dq": 5 * layers},
                "resnet": dict.fromkeys(launches, 0), "decode": dict.fromkeys(launches, 0)}
        if zoo["launches"] != want:
            raise AssertionError(f"perf zoo launched {zoo['launches']}, not {want}")
        for row, value in zoo.items():
            if row != "launches" and not (math.isfinite(value) and value > 0):
                raise AssertionError(f"perf zoo row {row} = {value}")
        for r in [result] + result["long_context"]:
            if not (r.get("mfu") is not None and 0 < r["mfu"] <= 1):
                raise AssertionError(f"perf row without an MFU in (0, 1]: {r}")
            if r.get("loss") is None or not math.isfinite(r["loss"]):
                raise AssertionError(f"perf row with a non-finite loss: {r}")
        if not os.path.exists(knobs["HIVED_PERF_ARTIFACT"]):
            raise AssertionError("perf wrote no artifact")
        for stage in ("launches", "attention_launches"):
            if 0 in result[stage].values():
                raise AssertionError(f"perf {stage}: a kernel did not launch: {result[stage]}")
        with open(knobs["HIVED_PERF_ARTIFACT"]) as f:
            artifact = json.load(f)
        if "zoo" not in artifact:
            raise AssertionError("perf's artifact holds no zoo rows")
        log("perf", step="zoo", **zoo)
        log("perf", seconds=seconds, launches=launches, zoo_launches=zoo_launches,
            artifact_keys=sorted(artifact), capture_ms=result["capture_ms"])
        # The train-graph gate at the harness's model, seeds and shape: the
        # eager steps, then the captured ones, from the same weights.
        config, batch, seq = perf.bench_config(True)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, config.vocab_size, size=(batch, seq))).cuda()
        runs = {}
        for plain in (True, False):
            _reset_train_graph_counts()
            params = transformer.init(config, torch.Generator(device="cuda").manual_seed(0),
                                      "cuda", dtype=torch.float32)
            optimizer = train.make_optimizer(params)
            step = train.train_step if plain else train.captured_step
            runs[plain] = run_steps(lambda: step(params, optimizer, tokens, config),
                                    lambda: params, PERF_GRAPH_STEPS)
            if plain:
                del params, optimizer
                _free_card()
        fields = check_train_graph(
            "perf_" + os.environ.get("HIVED_PERF_MODEL", "268m"), runs[True], runs[False],
            profile=profile and (lambda: profile_train_step(
                params, optimizer, tokens, config, result["step_time_ms"],
                window="perf_train_step")))
        log("perf", step="train_graph", harness_step_ms=result["step_time_ms"],
            harness_capture_ms=result["capture_ms"], mfu=result.get("mfu"),
            gate_captured_ms_step=fields["captured_ms_step"])
        del params, optimizer, tokens
        _free_card()
        # The harness's decode (its model and weights, the zoo's batch 8
        # after 128 tokens, 32 new) through the serving entry point: a
        # warm-up that captures, a timed request, the eager loop's tokens.
        config = perf.bench_config(True)[0]
        params = perf._flagship_params(config, torch.device("cuda"))
        prompt = torch.from_numpy(np.random.default_rng(6).integers(
            0, config.vocab_size, size=(8, 128))).cuda()
        _reset_graph_counts()
        warm = serve.run_request(params, prompt, config, 32)
        res = serve.run_request(params, prompt, config, 32)
        check_decode_graph("perf", params, config, prompt, 32, res, warm["capture_ms"])
        del params
        return {k: launches[k] - zoo_launches[k] for k in launches}, zoo_launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        os.environ.clear()
        os.environ.update(saved_env)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_capture_probe(mesh, seed: int) -> None:
    """The port's collectives over the one-rank NCCL group captured in one
    CUDA graph by the decode step's capture (``generate._capture``: a
    warm-up run on a side stream, then the capture) and replayed on fresh
    inputs: funcol's all-gather, reduce-scatter and all-reduce by sum and
    by max (the decode and training steps'), c10d's in-place all-reduce
    (``reduce_gradients``'), funcol's all-to-all (``_exchange``) inside
    ``_AllToAll`` (Ulysses') and ``_AllReduceSum`` (batch norm's sums and
    the router's), each forward and backward, the backward issued from
    autograd's engine, and a send and receive to itself in one batch
    (``_shift``, ring's). Each replay's
    outputs must be its inputs. The pipeline's own hops (a blocking send,
    then a receive) cannot pair with themselves: the four-card pipeline
    gang is their check."""
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch.models import generate
    from hivedscheduler_tpu_torch.parallel import sharding

    x = torch.zeros(4096, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(4096, dtype=torch.float32, device="cuda", requires_grad=True)
    u = torch.zeros(4096, dtype=torch.float32, device="cuda", requires_grad=True)

    def collectives():
        y = x.clone()
        dist.all_reduce(y, group=mesh.get_group("dp"))
        w.grad = u.grad = None
        total = sharding._AllReduceSum.apply(w, mesh, "dp")
        total.backward(x.float())
        swapped = sharding._AllToAll.apply(u, mesh, "sp")
        swapped.backward(x.float())
        return torch.cat([sharding._all_gather(x, 0, mesh, "fsdp"),
                          sharding._reduce_scatter(x, 0, mesh, "fsdp"),
                          sharding._all_reduce(x, mesh, "tp"),
                          sharding._all_reduce(x, mesh, "tp", "max"),
                          y, sharding._exchange(x, mesh, "sp"),
                          total.detach().to(x.dtype), w.grad.to(x.dtype),
                          swapped.detach().to(x.dtype), u.grad.to(x.dtype),
                          sharding._shift(x, mesh, "pp", 1)])

    replay, out = generate._capture(collectives, lambda: None)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    replays = 3
    for _ in range(replays):
        x.copy_(torch.randn(x.shape, device="cuda", generator=gen))
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, device="cuda", generator=gen).to(x.dtype))
            u.copy_(torch.randn(u.shape, device="cuda", generator=gen).to(x.dtype))
        replay()
        if not torch.equal(out, torch.cat([x.repeat(6), w.detach().to(x.dtype), x,
                                           u.detach().to(x.dtype), x, x])):
            raise AssertionError("a captured NCCL collective over one rank did not return "
                                 "its replay's input")
    torch.cuda.synchronize()
    log("sharded", step="nccl_capture", collectives=[
        "all_gather", "reduce_scatter", "all_reduce_sum", "all_reduce_max",
        "c10d_all_reduce_in_place", "funcol_all_to_all_single", "all_reduce_sum_autograd",
        "all_reduce_sum_backward", "all_to_all_autograd", "all_to_all_backward",
        "batch_isend_irecv_self"],
        elements=x.numel(), dtype="bfloat16", replays=replays, outputs_equal_inputs=True,
        nccl=".".join(map(str, torch.cuda.nccl.version())), torch=torch.__version__)


def phase_sharded(seed: int, profile: bool, served: dict, trained: dict) -> dict:
    """The sharded paths on a one-rank NCCL mesh (see the module docstring,
    phase 8); returns each kernel's launches and the step times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch import train as entry
    from hivedscheduler_tpu_torch.models import train, transformer
    from hivedscheduler_tpu_torch.ops import attention as A
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.parallel import sharding

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(pmesh.MeshConfig(), "cuda")
        # The model skips collectives over one rank, so on this mesh it
        # communicates nothing: each collective it uses runs once here.
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        for name, got in (("all_gather", sharding._all_gather(x, 0, mesh, "fsdp")),
                          ("reduce_scatter", sharding._reduce_scatter(x, 0, mesh, "fsdp")),
                          ("all_reduce", sharding._all_reduce(x, mesh, "tp", "max"))):
            if not torch.equal(got, x):
                raise AssertionError(f"NCCL {name} over one rank changed its input")
        nccl_capture_probe(mesh, seed)
        # (a) Phase 5's model, seed and batch through the sharded step:
        # first the eager mesh step (the plain version), then the step from
        # the rank's captured graph, from the same seed (two trees of 8
        # layers and their AdamW do not fit the card together). The DTensor
        # AdamW is capturable on the card: phase 5's arithmetic.
        config = dataclasses.replace(transformer.llama3_8b(), n_layers=TRAIN["layers"],
                                     remat=True, remat_policy=TRAIN["remat_policy"])
        tokens = torch.from_numpy(serve.synthetic_tokens(
            np.random.default_rng(seed + 1), TRAIN["batch"], TRAIN["seq"], config.vocab_size))
        tokens = sharding.shard_batch(tokens, mesh).cuda()
        steps = TRAIN["warmup"] + TRAIN["timed"]
        params, optimizer = train.init_sharded(
            config, mesh, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        eager = run_steps(lambda: train.train_step(params, optimizer, tokens, config, "cuda",
                                                   mesh), lambda: params, steps)
        del params, optimizer
        _free_card()
        t0 = time.perf_counter()
        params, optimizer = train.init_sharded(
            config, mesh, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        if not all(g["capturable"] for g in optimizer.param_groups):
            raise AssertionError("the mesh's DTensor AdamW is not capturable on the card")
        step = train.make_train_step(config, mesh, optimizer)
        torch.cuda.synchronize()
        log("sharded", step="init", mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
            seconds=time.perf_counter() - t0, weights_gib=torch.cuda.memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()  # the captured steps alone: the main path's count
        _reset_train_graph_counts()
        recs = []
        for i in range(steps):
            if i == TRAIN["warmup"]:
                # The bitwise gate: after the same steps, every leaf as phase 5's.
                for host, leaf in zip(trained["after_warmup"], transformer.leaves(params)):
                    if not _equal(host, leaf.detach().to_local().cpu()):
                        raise AssertionError("a sharded leaf differs from the unsharded step's")
            before = A.kernel_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = float(step(params, tokens))
            torch.cuda.synchronize()
            after = A.kernel_launches()
            recs.append({"loss": loss, "step_ms": (time.perf_counter() - t1) * 1e3,
                         "launches": {k: after[k] - before[k] for k in after}})
        train_launches = entry.kernel_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [r["loss"] for r in recs]
        captured = {"losses": losses, "step_ms": [r["step_ms"] for r in recs],
                    "digest": train.tree_digest(params), "peak_gib": peak_gib}
        if losses != trained["losses"] or captured["digest"] != trained["digest"]:
            raise AssertionError(f"sharded captured losses {losses} (or the parameters' "
                                 f"digest) differ from the unsharded captured run's "
                                 f"{trained['losses']}")
        for r in recs:
            if set(r["launches"].values()) != {config.n_layers}:
                raise AssertionError(f"sharded step launched {r['launches']}, not "
                                     f"{config.n_layers} each")
        timed = [r["step_ms"] for r in recs[TRAIN["warmup"]:]]
        step_ms = sum(timed) / len(timed)
        log("sharded", step="train", losses=losses, bitwise_equal_unsharded=True,
            digest_equal_unsharded=True, step_ms=[r["step_ms"] for r in recs],
            step_ms_mean=step_ms, unsharded_step_ms_mean=trained["step_ms_mean"],
            ratio=step_ms / trained["step_ms_mean"], peak_memory_gib=peak_gib,
            launches=train_launches)
        check_train_graph("sharded_llama3_8b_8_layers", eager, captured, TRAIN["warmup"],
                          profile and (lambda: profile_train_step(
                              params, optimizer, tokens, config, step_ms,
                              window="sharded_train_step", mesh=mesh)))
        del params, optimizer, step, tokens
        torch.cuda.empty_cache()

        # (b) Phase 4's first prompt, then (c) its int8 prompt through the
        # sharded serving path (int8 quantized on the mesh, its max's
        # collectives over one rank skipped): phase 4's tokens, decoded
        # from the mesh's captured step.
        serve_launches = dict.fromkeys(train_launches, 0)
        for int8, served_prompt, served_tokens in (
                (False, served["prompt0"], served["tokens0"]),
                (True, served["int8_prompt"], served["int8_tokens"])):
            path = "sharded_int8" if int8 else "sharded"
            t0 = time.perf_counter()
            config, params = serve.build("llama3_8b", seed, "cuda", int8=int8, mesh=mesh)
            prompt = sharding.shard_batch(served_prompt, mesh).cuda()
            warm_prompt = sharding.shard_batch(torch.from_numpy(serve.synthetic_tokens(
                np.random.default_rng(seed + 3), *served_prompt.shape, config.vocab_size)),
                mesh).cuda()
            # A warm-up request at the timed shape first, as phase 4 runs
            # one: it captures the decode step, so the timed request does not.
            _reset_graph_counts()
            warm = serve.run_request(params, warm_prompt, config, SHARDED_SERVE["new_tokens"],
                                     mesh=mesh)
            _reset_launches()
            res = serve.run_request(params, prompt, config, SHARDED_SERVE["new_tokens"],
                                    mesh=mesh)
            launches = entry.kernel_launches()
            if warm["captures"] != 1 or res["captures"]:
                raise AssertionError(f"{path}: the warm-up captured {warm['captures']} decode "
                                     f"graphs and the timed request {res['captures']}")
            if not torch.equal(res["tokens"].cpu(), served_tokens):
                raise AssertionError(f"{path} serving tokens differ from phase 4's")
            if launches["flash_fwd"] != config.n_layers:
                raise AssertionError(f"{path} prefill launched the flash kernel "
                                     f"{launches['flash_fwd']} times for {config.n_layers} layers")
            log("sharded", step="serve_int8" if int8 else "serve", **SHARDED_SERVE,
                ttft_ms=res["ttft_ms"], decode_tok_s=res["decode_tok_s"],
                tokens_equal_unsharded=True, captures=res["captures"], launches=launches,
                seconds=time.perf_counter() - t0)
            check_decode_graph(path, params, config, prompt, SHARDED_SERVE["new_tokens"], res,
                               warm["capture_ms"], mesh=mesh)
            if profile and not int8:
                profile_request(params, prompt, config, res, SHARDED_SERVE["new_tokens"], mesh,
                                window="sharded_")
            serve_launches = {k: serve_launches[k] + launches[k] for k in launches}
            del params
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    ranks = phase_gang(profile)  # (c) gangs across cards, where the machine has them
    log("sharded", step="summary", nccl_ranks=ranks, step_ms_mean=step_ms,
        unsharded_step_ms_mean=trained["step_ms_mean"])
    return {k: train_launches[k] + serve_launches[k] for k in train_launches}


# One step line of the twin (phase 12's ResNet-50 through the launcher).
_TWIN_STEP = re.compile(
    r"step (\d+) loss ([-\d.]+) \(([\d.]+) ms, \d+ (?:tok|img)/s, launches (\{[^}]*\})\)")


def launch_pod(module: str, argv: list, ranks: int) -> str:
    """``module`` started by the pod's launcher on a one-pod bind info of
    ``ranks`` cards, one process per card; prints and returns the ranks'
    standard output (one pipe)."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    try:
        bind_info = os.path.join(workdir, "pod-bind-info.json")
        cards = list(range(ranks))
        with open(bind_info, "w") as f:
            json.dump({**POD_BIND_INFO, "leafCellIsolation": cards, "affinityGroupBindInfo": [
                {"podPlacements": [{"physicalNode": "localhost",
                                    "physicalLeafCellIndices": cards}]}]}, f)
        proc = subprocess.run(
            [sys.executable, "-m", "hivedscheduler_tpu_torch.workloads.launch",
             "--bind-info", bind_info, "--master-port", str(_free_port()), "--timeout", "600",
             "--", module, *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, text=True,
            timeout=660)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the launched {module} gang exited {proc.returncode}")
    return proc.stdout


def resnet_summaries(stdout: str) -> list:
    """Each rank's ``resnet summary {...}`` line of the ResNet twin."""
    return [json.loads(line[len("resnet summary "):]) for line in stdout.splitlines()
            if line.startswith("resnet summary ")]


def check_gang(name: str, one: list, ranks_records: list, launches, gated_steps=None,
               **fields) -> None:
    """Hold a launched gang's steps (each rank's records of its captured
    run) to the one-card run ``one``: every rank reports the same loss,
    within GANG_TOL of one card's in the first ``gated_steps`` steps (all
    by default; the rest are logged with their gaps), and launched each
    kernel ``launches`` times a step (a number, or one per kernel; a replay
    counts what its capture recorded); logs the step times (a step's: its
    slowest rank's; the mean from step 1 on, the replays; the first
    replay's, and the mean of the replays after it, the gang's step, beside
    one card's over the same steps). Returns each kernel's launches on
    each rank over the gang's run."""
    ranks = len(ranks_records)
    if any(len(recs) != len(one) for recs in ranks_records):
        raise AssertionError(f"{name}: {[len(r) for r in ranks_records]} steps from {ranks} "
                             f"ranks, not {len(one)} each")
    losses, step_ms, parted = [], [], []
    for i, r in enumerate(one):
        mine = [recs[i] for recs in ranks_records]
        got = {st["loss"] for st in mine}
        if len(got) != 1:
            raise AssertionError(f"{name} step {i}: the ranks report different losses {got}")
        losses.append(got.pop())
        if (gated_steps is None or i < gated_steps) and abs(losses[-1] - r["loss"]) > GANG_TOL:
            parted.append(f"{name} step {i}: gang loss {losses[-1]} vs one card {r['loss']}")
        step_ms.append(max(st["step_ms"] for st in mine))
        for st in mine:
            want = launches if isinstance(launches, dict) else dict.fromkeys(st["launches"],
                                                                             launches)
            if st["launches"] != want:
                raise AssertionError(f"{name} step {i}: a rank launched {st['launches']}, "
                                     f"not {launches}")
    def mean(xs):
        return sum(xs) / len(xs)

    later_ms = mean(step_ms[2:])
    one_later_ms = mean([r["step_ms"] for r in one[2:]])
    log("gang", step=name, ranks=ranks, losses=losses, losses_one_card=[r["loss"] for r in one],
        loss_gaps=[abs(a - r["loss"]) for a, r in zip(losses, one)], tol=GANG_TOL,
        gated_steps=gated_steps or len(one), step_ms=step_ms, first_replay_ms=step_ms[1], replays_after_first_ms_mean=later_ms,
        one_card_replays_after_first_ms_mean=one_later_ms,
        speedup_after_first_replay=one_later_ms / later_ms,
        launches_per_rank_step=launches, **fields)
    if parted:  # after the line above, so that a failing gate leaves its figures
        raise AssertionError(parted[0])
    return {k: [sum(st["launches"][k] for st in recs) for recs in ranks_records]
            for k in ranks_records[0][0]["launches"]}


def _twin_summary(prefix: str, stdout: str) -> dict:
    """The twin's one ``<prefix> summary {...}`` line."""
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith(prefix + " summary ")]
    return json.loads(line[len(prefix) + len(" summary "):])


def _quiet_main(prefix: str, main, argv: list) -> tuple:
    """A twin's ``main(argv)`` in this process, its output printed after it
    ran; returns (its records, its summary line's fields)."""
    import contextlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        records = main(argv)
    print(printed.getvalue(), end="", flush=True)
    return records, _twin_summary(prefix, printed.getvalue())


def _longctx_argv() -> list:
    return ["--model", LONGCTX["model"], "--layers", str(LONGCTX["layers"]),
            "--seq", str(LONGCTX["seq"]), "--steps", str(GANG_STEPS)]


def _pipeline_argv(sp: int = 1) -> list:
    pl = PIPELINE
    return ["--model", pl["model"], "--layers", str(pl["layers"]), "--batch", str(pl["batch"]),
            "--seq", str(pl["seq"]), "--microbatches", str(pl["microbatches"]),
            "--steps", str(GANG_STEPS), "--sp", str(sp)]


def _mixtral_argv() -> list:
    return ["--layers", str(MIXTRAL_TRAIN["layers"]), "--steps", str(GANG_STEPS)]


def _resnet_argv(batch: int) -> list:
    return ["--batch", str(batch), "--steps", str(RESNET_GANG["steps"])]


def resnet_f64_run(plain: bool, mesh, device) -> dict:
    """RESNET_F64_GANG's steps, the twin's ``train_step`` (``plain``) or
    ``captured_step``, on ``mesh`` (this rank's rows of each global batch)
    or on one card (None: the whole batch). Returns the losses, the
    parameters' and running stats' digests, and their host copies."""
    import torch

    # cuDNN may pick an f64 backward that adds with atomics, which no two
    # runs repeat bit for bit, captured or not (tests/test_torch_cuda.py's
    # deterministic_cudnn): the eager and captured runs are compared bitwise.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _resnet_f64_steps(plain, mesh, device)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _resnet_f64_steps(plain: bool, mesh, device) -> dict:
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import convert, resnet, train, transformer
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.workloads import train_resnet

    g = RESNET_F64_GANG
    config = resnet.ResNetConfig(**g["config"], dtype=torch.float64)
    params, stats = resnet.init(config, torch.Generator().manual_seed(0), "cpu")
    params, stats = (convert.params_from_jax(convert.params_to_numpy(t), device, torch.float64)
                     for t in (params, stats))
    if mesh is not None:
        params = resnet.distribute(params, mesh)
    optimizer = train_resnet.make_optimizer(params)
    step = train_resnet.train_step if plain else train_resnet.captured_step
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(g["steps"]):
        images, labels = train_resnet.synthetic_batch(rng, g["batch"], g["size"],
                                                      config.num_classes)
        images = images.double()
        if mesh is not None:
            images, labels = (sharding.shard_batch(t, mesh) for t in (images, labels))
        loss, stats = step(params, stats, optimizer, images.to(device), labels.to(device),
                           config, mesh)
        losses.append(float(loss))
    return {"losses": losses, "digest": train.tree_digest(params),
            "stats_digest": train_resnet.stats_summary(stats)["bn_stats_digest"],
            "leaves": [sharding.to_local(t).detach().cpu().numpy()
                       for t in transformer.leaves(params) + transformer.leaves(stats)]}


def profile_resnet_step(batch: int, size: int, unprofiled_ms: float, window: str,
                        mesh=None) -> float:
    """The ResNet-50 twin's model, seeds and first batch (on ``mesh``,
    this rank's rows of it): the capture, a replay, then one replay under
    the profiler; returns its idle share against ``unprofiled_ms``."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import resnet
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.workloads import train_resnet

    config = resnet.ResNetConfig()
    params, stats = resnet.init(config, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n = 1 if mesh is None else sharding.axes_size(sharding.BATCH_AXES, mesh)
    if mesh is not None:
        params = resnet.distribute(params, mesh)
    optimizer = train_resnet.make_optimizer(params)
    images, labels = train_resnet.synthetic_batch(np.random.default_rng(1), batch * n, size,
                                                  config.num_classes)
    if mesh is not None:
        images, labels = (sharding.shard_batch(t, mesh) for t in (images, labels))
    images, labels = images.cuda(), labels.cuda()

    def resnet_step():
        return train_resnet.captured_step(params, stats, optimizer, images, labels, config,
                                          mesh)[0]

    for _ in range(2):
        float(resnet_step())
    return profile_step(resnet_step, unprofiled_ms, window)


def train_gang_job(name: str, profile: bool = False, gang_dir: str = None) -> dict:
    """One rank of the training gang ``name``, started by the pod's
    launcher with its per-card block: the twin's steps eagerly (its plain
    version), then through its entry point (on the card each step after
    the first a replay of the rank's captured graph, the step's
    collectives inside), each from the twin's seeds. ``resnet_f64``: the
    small f64 ResNet of RESNET_F64_GANG instead (rank 0 writes its host
    leaves to ``gang_dir``). With ``profile``, the ResNet-50 rank's device
    time by kernel over one more replay (every rank, in step). Returns
    each run's records, losses, digests, graph counts and peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import train
    from hivedscheduler_tpu_torch.parallel import mesh as pmesh
    from hivedscheduler_tpu_torch.workloads import (train_longctx, train_mixtral, train_pp,
                                                    train_resnet)
    from hivedscheduler_tpu_torch.workloads.common import bootstrap_distributed, lift_env_block

    lift_env_block()  # the card grant, before anything initialises CUDA
    device = resolve_device(None)
    bootstrap_distributed(device)
    n = pmesh.world_size()

    def run(plain: bool) -> dict:
        if name == "resnet_f64":
            out = resnet_f64_run(plain, pmesh.make_mesh(pmesh.MeshConfig(dp=n), device), device)
            leaves = out.pop("leaves")
            if dist.get_rank() == 0:
                np.savez(os.path.join(gang_dir, f"gang_{'eager' if plain else 'captured'}.npz"),
                         *leaves)
            return out
        if name == "mixtral":
            records, summary = _quiet_main("mixtral", train_mixtral.main,
                                           _mixtral_argv() + ["--plain"] * plain)
            return {"records": records, "digest": summary["params_digest"]}
        if name == "resnet":
            records, summary = _quiet_main("resnet", train_resnet.main,
                                           _resnet_argv(RESNET_GANG["batch"])
                                           + ["--plain"] * plain)
            return {"records": records, "digest": summary["params_digest"],
                    "stats_digest": summary["bn_stats_digest"]}
        if name == "longctx":
            return {"records": train_longctx.main(_longctx_argv() + ["--plain"] * plain)}
        sp = PIPELINE_GANGS[name]
        return {"records": train_pp.main(_pipeline_argv(sp) + ["--plain"] * plain)}

    runs = {}
    for plain in (True, False):
        _reset_train_graph_counts()
        torch.cuda.reset_peak_memory_stats()
        out = run(plain)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["graph"] = {"captures": train.StepGraphs.captures,
                        "replays": train.StepGraphs.replays,
                        "capture_ms": train.StepGraphs.capture_s * 1e3}
        if "records" in out:
            out["losses"] = [r["loss"] for r in out["records"]]
        runs["eager" if plain else "captured"] = out
        _free_card()
    result = {"rank": dist.get_rank(), **runs}
    if profile and name == "resnet":
        steps = runs["captured"]["records"][1:]
        result["idle_share"] = profile_resnet_step(
            RESNET_GANG["batch"], train_resnet.IMAGE_SIZE,
            sum(r["step_ms"] for r in steps) / len(steps), f"resnet50_dp{n}_rank{dist.get_rank()}",
            pmesh.make_mesh(pmesh.MeshConfig(dp=n), device))
    dist.barrier()  # no rank's store goes while a peer still reads it
    dist.destroy_process_group()
    return result


def job_results(stdout: str, key: str) -> list:
    """Every rank's ``{"<key>": {...}}`` result in the ranks' shared pipe,
    each found where it opens, not by line: one rank's object can land on
    the line that another's ends (the four processes write one pipe)."""
    decoder = json.JSONDecoder()
    marker = '{"' + key + '"'
    results, i = [], stdout.find(marker)
    while i >= 0:
        obj, end = decoder.raw_decode(stdout, i)
        results.append(obj[key])
        i = stdout.find(marker, end)
    return results


def launch_train_gang(name: str, ranks: int, profile: bool = False, gang_dir: str = None
                      ) -> list:
    """The training gang ``name`` through the pod's launcher, each rank
    this script's ``--train-gang-job``; returns each rank's result, having
    held every rank's captured run to its own eager run: the same losses
    (and digests, where the twin prints them) bit for bit, one capture (at
    the first step) and a replay a later step."""
    out = launch_pod("chip_smoke", ["--train-gang-job", name]
                     + (["--gang-dir", gang_dir] if gang_dir else [])
                     + (["--profile"] if profile else []), ranks)
    jobs = sorted(job_results(out, "train_gang_job"), key=lambda job: job["rank"])
    if len(jobs) != ranks:
        raise AssertionError(f"training gang {name}: {len(jobs)} results from {ranks} ranks")
    for job in jobs:
        eager, captured = job["eager"], job["captured"]
        where = f"training gang {name}, rank {job['rank']}"
        for key in ("losses", "digest", "stats_digest"):
            if eager.get(key) != captured.get(key):
                raise AssertionError(f"{where}: the captured run's {key} {captured.get(key)} "
                                     f"differ from the eager run's {eager.get(key)}")
        steps = len(captured["losses"])
        if (captured["graph"]["captures"], captured["graph"]["replays"]) != (1, steps - 1):
            raise AssertionError(f"{where}: {captured['graph']} over {steps} steps: one "
                                 "capture, at the first step, then replays")
        if eager["graph"]["captures"]:
            raise AssertionError(f"{where}: the eager run captured {eager['graph']}")
    return jobs


def _gang_fields(jobs: list) -> dict:
    """Each rank's captured-run numbers for a gang's log line."""
    def mean(xs):
        return sum(xs) / len(xs)

    return {"captured_losses_equal_eager_every_rank": True,
            "captures_per_rank": [job["captured"]["graph"]["captures"] for job in jobs],
            "replays_per_rank": [job["captured"]["graph"]["replays"] for job in jobs],
            "capture_ms_per_rank": [job["captured"]["graph"]["capture_ms"] for job in jobs],
            "peak_gib_per_rank": [job["captured"]["peak_gib"] for job in jobs],
            "eager_peak_gib_per_rank": [job["eager"]["peak_gib"] for job in jobs],
            "eager_step_ms_mean_per_rank": [
                mean([r["step_ms"] for r in job["eager"]["records"][1:]])
                if "records" in job["eager"] else None for job in jobs]}


def resnet_f64_gate(ranks: int) -> None:
    """The four-card f64 ResNet gradient gate (RESNET_F64_GANG): one card
    in this process, eager and captured (bitwise equal), then the gang at
    dp ``ranks`` through the launcher (each rank's captured run bitwise its
    eager run, the ranks' digests equal), held to one card within
    F64_GANG_TOL: the losses, and every parameter and running statistic
    after the last step."""
    import numpy as np
    import torch

    one = {}
    for plain in (True, False):
        _reset_train_graph_counts()
        one[plain] = resnet_f64_run(plain, None, torch.device("cuda"))
    if (one[True]["losses"], one[True]["digest"], one[True]["stats_digest"]) != (
            one[False]["losses"], one[False]["digest"], one[False]["stats_digest"]):
        raise AssertionError("the small f64 ResNet's captured steps differ from its eager steps "
                             "on one card")
    _free_card()
    gang_dir = tempfile.mkdtemp(prefix="chip_smoke_f64_")
    try:
        jobs = launch_train_gang("resnet_f64", ranks, gang_dir=gang_dir)
        gang = {}
        for run in ("eager", "captured"):
            with np.load(os.path.join(gang_dir, f"gang_{run}.npz")) as saved:
                gang[run] = [saved[f"arr_{i}"] for i in range(len(saved.files))]
    finally:
        shutil.rmtree(gang_dir, ignore_errors=True)
    for key in ("digest", "stats_digest"):
        if len({job["captured"][key] for job in jobs}) != 1:
            raise AssertionError(f"resnet_f64 dp {ranks}: the ranks' {key}s differ")
    want = one[False]
    losses = jobs[0]["captured"]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
    leaf_rel = {run: max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
                         for g, w in zip(gang[run], want["leaves"], strict=True))
                for run in gang}
    fields = {"ranks": ranks, **RESNET_F64_GANG, "losses": losses,
              "losses_one_card": want["losses"], "loss_max_rel": loss_rel,
              "leaf_max_rel": leaf_rel["captured"], "eager_leaf_max_rel": leaf_rel["eager"],
              "tol": F64_GANG_TOL, "one_card_captured_equal_eager": True, **_gang_fields(jobs)}
    if loss_rel > F64_GANG_TOL["loss_rel"] or max(leaf_rel.values()) > F64_GANG_TOL["leaf_max_rel"]:
        raise AssertionError(f"resnet_f64 dp {ranks} vs one card: {fields}")
    log("gang", step="resnet_f64_gate", **fields)


def pipeline_gangs(ranks: int, names) -> dict:
    """The pipeline twin's gangs ``names`` (of PIPELINE_GANGS) in turn,
    each held by ``check_gang`` to one one-card reference, run first here
    through the twin's ``run`` on an inactive mesh (the twin itself refuses
    an odd card count). Returns each gang's kernel launches on each rank."""
    import torch

    from hivedscheduler_tpu_torch.workloads import train_pp

    pl = PIPELINE
    config = dataclasses.replace(train_pp.MODELS[pl["model"]](), max_seq_len=pl["seq"],
                                 n_layers=pl["layers"], remat=True, remat_policy="flash",
                                 pp_microbatches=pl["microbatches"])
    one = train_pp.run(config, None, torch.device("cuda"), GANG_STEPS, pl["batch"], pl["seq"])
    _free_card()
    launches = {}
    for name in names:
        jobs = launch_train_gang(name, ranks)
        mesh = train_pp.mesh_config(ranks, PIPELINE_GANGS[name], config.n_kv_heads)
        # Each stage holds layers / pp layers and runs each once a microbatch
        # (at sp 2 Ulysses' one call a layer at the full sequence, H / sp
        # heads; ring's local step, plain torch, would launch none).
        launches[name] = check_gang(
            name, one, [job["captured"]["records"] for job in jobs],
            pl["layers"] // mesh.pp * pl["microbatches"], mesh=dataclasses.asdict(mesh),
            steps=GANG_STEPS, **pl, **_gang_fields(jobs))
    return launches


def train_gang(ranks: int, profile: bool = False) -> dict:
    """The four-card training gangs: the f64 gate first, then the longctx,
    Mixtral and ResNet-50 twins (:func:`phase_gang` runs the pipeline's
    last), each on one card in this process and as a gang through the
    launcher
    (``launch_train_gang``: every rank's captured run bitwise its eager
    run), the gang's captured steps held to one card by ``check_gang``.
    Returns each gang's kernel launches on each rank over its captured
    run."""
    from hivedscheduler_tpu_torch.workloads import train_longctx, train_mixtral, train_resnet

    resnet_f64_gate(ranks)

    one = train_longctx.main(_longctx_argv())  # this process, card 0
    _free_card()
    jobs = launch_train_gang("longctx", ranks)
    mesh = train_longctx.mesh_config(ranks, train_longctx.MODELS[LONGCTX["model"]]().n_kv_heads)
    # tp 4 keeps whole GQA groups on each rank: the kernels run once a layer.
    launches = {}
    launches["longctx"] = check_gang(
        "longctx", one, [job["captured"]["records"] for job in jobs], LONGCTX["layers"],
        mesh=dataclasses.asdict(mesh),
        tokens_per_s_one_card=LONGCTX["seq"] / (one[-1]["step_ms"] * 1e-3), **_gang_fields(jobs))

    # The Mixtral twin at ep 4 x fsdp 1: every rank holds all 4 rows, as
    # one card does, and runs two of the eight experts.
    layers = MIXTRAL_TRAIN["layers"]
    one = train_mixtral.main(_mixtral_argv())  # this process, card 0
    _free_card()
    jobs = launch_train_gang("mixtral", ranks)
    launches["mixtral"] = check_gang(
        "mixtral", one, [job["captured"]["records"] for job in jobs],
        {"flash_fwd": 2 * layers, "flash_bwd_dkdv": layers, "flash_bwd_dq": layers},
        mesh=dataclasses.asdict(train_mixtral.mesh_config(ranks)), layers=layers,
        batch=[train_mixtral.ROWS_PER_SHARD, train_mixtral.SEQ], **_gang_fields(jobs))

    # The ResNet twin at dp 4 (BASELINE config 2) against one card at the
    # global batch: the same images, so batch norm's statistics must be the
    # global batch's, equal on every rank (their digest). Only the first
    # step's loss, before any update, is held to GANG_TOL: in bf16 at random
    # init a step of SGD at lr 0.1 moves the loss by more than two
    # summation orders' rounding (0.03 apart after one step on four H100s);
    # the f64 gate above holds the gang's gradients and updates.
    rg = RESNET_GANG
    one = train_resnet.main(_resnet_argv(rg["batch"] * ranks))
    _free_card()
    jobs = launch_train_gang("resnet", ranks, profile)
    if len({job["captured"]["stats_digest"] for job in jobs}) != 1:
        raise AssertionError(f"resnet dp {ranks}: the ranks' running stats differ")
    launches["resnet"] = check_gang(
        "resnet", one, [job["captured"]["records"] for job in jobs], 0, gated_steps=1,
        mesh={"dp": ranks}, batch_per_card=rg["batch"], image_size=train_resnet.IMAGE_SIZE,
        bn_stats_equal_on_ranks=True,
        images_per_s_one_card=rg["batch"] * ranks / (one[-1]["step_ms"] * 1e-3),
        idle_share_per_rank=[job.get("idle_share") for job in jobs], **_gang_fields(jobs))
    return launches


def phase_gang(profile: bool = False, gangs=GANGS) -> int:
    """Gangs across cards, where the machine has two or more (see the
    module docstring, phase 8), those of ``gangs`` (of GANGS; all by
    default): every dryrun row that fits as an NCCL gang of 2 ranks, or 4
    with four cards (the sequence rows then launch the kernels on every
    rank, and the pipeline rows on every stage); with four cards, also the
    training gangs (:func:`train_gang`: the f64 ResNet gate, then the
    longctx, Mixtral and ResNet-50 twins as the scheduler would start them
    on a pod granted four cards, each step from the rank's captured graph),
    the serving gangs (:func:`serve_gang`), then the pipeline twin at
    pp 2 x tp 2 and last at pp 2 x sp 2 (:func:`pipeline_gangs`), and a
    last line of every gang's kernel launches a rank. Returns the ranks of
    the gang (1, and nothing run, on one card)."""
    import torch

    from hivedscheduler_tpu_torch.tools import dryrun

    count = torch.cuda.device_count()
    if count < 2:
        return 1
    ranks = 4 if count >= 4 else 2
    launches = {}
    if "dryrun" in gangs:
        result = dryrun.dryrun(ranks, device="cuda")
        log("gang", step="dryrun", ranks=ranks, **result)
        for row, per_rank in result["launches"].items():
            # Every row attends through the kernels on every rank (the
            # sequence rows through Ulysses' full-sequence call): once a
            # layer, and on a pipeline stage once a layer of the stage a
            # microbatch.
            if any(set(n.values()) != {result["expected"][row]} for n in per_rank):
                raise AssertionError(f"dryrun row {row}: kernel launches {per_rank}, "
                                     f"not {result['expected'][row]} each")
            # The row's one step came from the owner: its warm-up, then the capture.
            if result["captures"][row] != [1] * ranks:
                raise AssertionError(f"dryrun row {row}: captures {result['captures'][row]}, "
                                     "not one a rank")
        launches.update({f"dryrun_{row}": {k: [n[k] for n in per_rank] for k in per_rank[0]}
                         for row, per_rank in result["launches"].items()})
    if ranks < 4:
        return ranks
    if "train" in gangs:
        launches.update(train_gang(ranks, profile))
    if "serve" in gangs:
        serve_gang(ranks, profile)
    # The pipeline at pp 2 x sp 2 (Ulysses) last, so that a gang that stops
    # costs none of the others' results.
    pipelines = [name for name in PIPELINE_GANGS if name in gangs]
    if pipelines:
        launches.update(pipeline_gangs(ranks, pipelines))
    # Each gang's kernels on each rank: the four-card runs' launches_by_path.
    log("gang", step="kernels", launches_by_path=launches)
    return ranks


_INT8_DIGEST = re.compile(r"serving int8-quantized linears, local shards sha256 ([0-9a-f]{64})")


def tp_block_digests(params, tp: int) -> list:
    """The ``quantize.shard_digest`` of each tp rank's block of a one-card
    int8 tree, at tp x fsdp 1: each int8 leaf split over tp along the dim
    the rule table maps to tp."""
    from hivedscheduler_tpu_torch.models import quantize, transformer
    from hivedscheduler_tpu_torch.parallel import sharding

    axes = quantize.quantized_axes(transformer.logical_axes(transformer.llama3_8b()))

    def block(leaf, names, r):
        if isinstance(leaf, dict):
            return {k: block(v, names[k], r) for k, v in leaf.items()}
        for d, axis in enumerate(sharding.spec_for(names)):
            if axis == "tp":
                leaf = leaf.chunk(tp, dim=d)[r]
        return leaf

    return [quantize.shard_digest({k: block(params[k], axes[k], r) for k in ("layers", "lm_head")})
            for r in range(tp)]


def _argv_value(argv: list, flag: str, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def serve_gang_job(name: str, profile: bool = False) -> dict:
    """One rank of the serving gang ``SERVE_GANGS[name]``, started by the
    pod's launcher with its per-card block: ``serve.main`` with the gang's
    argv (its decode steps replayed from the rank's captured graph), then
    the weights rebuilt from the seed as ``serve.main`` built them and the
    last request's prompt (``serve.main``'s draws, in its order) served
    captured again (its tokens must be ``serve.main``'s; the peak memory of
    the weights, the cache and the graph's pool is taken over it) and
    through the eager mesh loop (``plain=True``), and teacher-forced on
    the captured tokens through eager one-token chunks: each captured
    token's logit against the eager step's best. With ``profile``, the
    device time by kernel over one more request (every rank, in step).
    Returns the rank's numbers (``peak_gib``: ``serve.main``'s, its
    weights' init included); the caller gates them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import generate
    from hivedscheduler_tpu_torch.parallel import sharding
    from hivedscheduler_tpu_torch.parallel.mesh import make_mesh, world_size

    argv = SERVE_GANGS[name]
    results = serve.main(argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()  # serve.main's weights, owner and graphs are gone
    model, seed = _argv_value(argv, "--model"), int(_argv_value(argv, "--seed", 0))
    layers = _argv_value(argv, "--layers")
    new_tokens = int(_argv_value(argv, "--new-tokens"))
    captured = results[-1]["tokens"]
    device = captured.device
    layout = serve.mesh_layout(model, world_size())
    mesh = make_mesh(layout, device)
    config, params = serve.build(model, seed, device, "--int8" in argv,
                                 layers and int(layers), None, mesh)
    ffn = serve.decode_hook(config)
    per = layout.dp * layout.fsdp
    batch = max(int(_argv_value(argv, "--batch")) // per, 1) * per
    rng = np.random.default_rng(seed + 1)
    for _ in results:
        prompt = serve.synthetic_tokens(rng, batch, int(_argv_value(argv, "--prompt-len")),
                                        config.vocab_size)
    prompt = sharding.shard_batch(torch.from_numpy(prompt), mesh).to(device)
    # The last request again from a fresh capture on the rebuilt weights
    # (their tokens must be serve.main's), then through the eager loop.
    torch.cuda.reset_peak_memory_stats()
    again = serve.run_request(params, prompt, config, new_tokens, mesh=mesh, ffn=ffn)
    serving_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if profile:  # the idle share against serve.main's last request, which captured nothing
        profile_request(params, prompt, config, results[-1], new_tokens, mesh,
                        window=f"{name}_rank{dist.get_rank()}_", ffn=ffn)
    eager = serve.run_request(params, prompt, config, new_tokens, mesh=mesh, ffn=ffn, plain=True)
    b, t = prompt.shape
    with torch.inference_mode():
        cache = generate.init_cache(config, b, t + new_tokens, device, mesh)
        logits, cache = generate.prefill(params, prompt, cache, config, mesh=mesh, ffn=ffn)
        gaps = []
        for i in range(new_tokens):
            token = captured[:, i]
            gaps.append((logits.amax(-1) - logits.gather(-1, token[:, None])[:, 0]).max().item())
            if i + 1 < new_tokens:
                logits, cache = generate.prefill(params, token[:, None], cache, config,
                                                 chunked=True, mesh=mesh, ffn=ffn)
    bound = decode_bound(params, config, b, t + new_tokens, mesh)
    out = {
        "rank": dist.get_rank(), "batch_rank": sharding.batch_rank(mesh), "rows": b,
        "requests": [{"ttft_ms": r["ttft_ms"], "decode_tok_s": r["decode_tok_s"],
                      "decode_s": b * (new_tokens - 1) / r["decode_tok_s"],
                      "flash_launches": r["flash_launches"], "captures": r["captures"],
                      "capture_ms": r["capture_ms"], "first": r["tokens"][:, 0].tolist()}
                     for r in results],
        "rebuilt_tokens_equal": bool(torch.equal(captured, again["tokens"])),
        "tokens_equal_eager": bool(torch.equal(captured, eager["tokens"])),
        "first_agree_eager_rows": int((captured[:, 0] == eager["tokens"][:, 0]).sum()),
        "max_logit_gap_vs_eager": max(gaps),
        "step_ms": 1e3 * b / results[-1]["decode_tok_s"],
        "eager_step_ms": 1e3 * b / eager["decode_tok_s"], "peak_gib": peak_gib,
        "serving_peak_gib": serving_peak_gib, **bound,
    }
    del params, cache
    dist.barrier()  # no rank's store goes while a peer still reads it
    dist.destroy_process_group()
    return out


def serve_gang(ranks: int, profile: bool = False) -> None:
    """The serving gangs (``SERVE_GANGS``) through the pod's launcher, each
    rank this script's ``--serve-gang-job``, against the same argv on one
    card in this process. Gates: every rank's captured tokens equal its
    eager loop's, one capture in the first request and none after, a flash
    launch a layer a rank a request, the first token of >= 3 of 4 rows as
    one card's (the ranks holding a row agreeing), the int8 shards'
    digests those of one card's tp blocks. Logs TTFT, decode rate, ms a
    step against a rank's bound, capture ms and peak memory a rank."""
    import torch

    from hivedscheduler_tpu_torch import serve

    for name, argv in SERVE_GANGS.items():
        model, int8 = _argv_value(argv, "--model"), "--int8" in argv
        torch.cuda.reset_peak_memory_stats()
        one = serve.main(argv)  # this process, card 0
        one_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        want_digests = None
        if int8:
            config, params = serve.build(model, 0, one[-1]["tokens"].device, int8=True)
            want_digests = sorted(tp_block_digests(params, ranks))
            del params
            torch.cuda.empty_cache()
        out = launch_pod("chip_smoke", ["--serve-gang-job", name]
                         + (["--profile"] if profile else []), ranks)
        jobs = job_results(out, "serve_gang_job")
        if len(jobs) != ranks:
            raise AssertionError(f"serving gang {name}: {len(jobs)} results from {ranks} ranks")
        layers = int(_argv_value(argv, "--layers", serve.MODELS[model]().n_layers))
        for job in jobs:
            where = f"serving gang {name}, rank {job['rank']}"
            if not job["rebuilt_tokens_equal"]:
                raise AssertionError(f"{where}: the rebuilt weights' captured tokens are not "
                                     f"serve.main's")
            if not job["tokens_equal_eager"]:
                raise AssertionError(f"{where}: the captured decode's tokens differ from the "
                                     f"rank's eager loop's (first token in "
                                     f"{job['first_agree_eager_rows']} rows; max logit gap "
                                     f"{job['max_logit_gap_vs_eager']})")
            captures = [r["captures"] for r in job["requests"]]
            if captures != [1] + [0] * (len(one) - 1):
                raise AssertionError(f"{where}: decode graphs captured {captures} a request")
            if {r["flash_launches"] for r in job["requests"]} != {layers}:
                raise AssertionError(f"{where}: flash launches "
                                     f"{[r['flash_launches'] for r in job['requests']]}, not "
                                     f"{layers} a request")
        requests = []
        for r, res in enumerate(one):
            want = res["tokens"][:, 0].tolist()
            got = {}
            for job in jobs:
                for i, token in enumerate(job["requests"][r]["first"]):
                    row = job["batch_rank"] * job["rows"] + i
                    if got.setdefault(row, token) != token:
                        raise AssertionError(f"serving gang {name} request {r}: the ranks "
                                             f"holding row {row} made different tokens")
            agree = sum(got[i] == w for i, w in enumerate(want))
            if sorted(got) != list(range(len(want))) or agree < 3:
                raise AssertionError(f"serving gang {name} request {r}: first tokens {got} "
                                     f"agree with one card's {want} in {agree}/4 rows")
            new_tokens = res["tokens"].shape[1]
            requests.append({
                "request": r, "first_tokens_agree_rows": agree,
                "ttft_ms": max(job["requests"][r]["ttft_ms"] for job in jobs),
                "decode_tok_s": len(want) * (new_tokens - 1)
                / max(job["requests"][r]["decode_s"] for job in jobs),
                "one_card_ttft_ms": res["ttft_ms"], "one_card_decode_tok_s": res["decode_tok_s"]})
        fields = {}
        if int8:
            digests = sorted(_INT8_DIGEST.findall(out))
            if digests != want_digests:
                raise AssertionError(f"serving gang: the ranks' int8 digests {digests} are not "
                                     f"one card's tp blocks' {want_digests}")
            fields["int8_digests_equal_one_card_blocks"] = True
        last = requests[-1]
        log("gang", step=name, ranks=ranks,
            mesh=dataclasses.asdict(serve.mesh_layout(model, ranks)), argv=argv,
            requests=requests, flash_launches_per_rank_request=layers,
            captured_tokens_equal_eager_every_rank=True,
            max_logit_gap_vs_eager=max(job["max_logit_gap_vs_eager"] for job in jobs),
            step_ms_per_rank=[job["step_ms"] for job in jobs],
            eager_step_ms_per_rank=[job["eager_step_ms"] for job in jobs],
            capture_ms_per_rank=[job["requests"][0]["capture_ms"] for job in jobs],
            **{key: jobs[0][key] for key in ("bound_ms", "bound_by", "weight_bytes",
                                             "gathered_bytes", "cache_bytes")},
            peak_gib_per_rank=max(job["peak_gib"] for job in jobs),
            serving_peak_gib_per_rank=max(job["serving_peak_gib"] for job in jobs),
            one_card_peak_gib=one_peak,
            ttft_speedup=last["one_card_ttft_ms"] / last["ttft_ms"],
            decode_speedup=last["decode_tok_s"] / last["one_card_decode_tok_s"], **fields)


def phase_longctx() -> dict:
    """The long-context twin (``workloads/train_longctx.py``) on this card
    (see the module docstring, phase 9; its seeds are the twin's own);
    returns each kernel's launches."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.ops import attention as A
    from hivedscheduler_tpu_torch.workloads import train_longctx

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    recs = train_longctx.main(["--model", LONGCTX["model"], "--layers", str(LONGCTX["layers"]),
                               "--seq", str(LONGCTX["seq"]), "--steps", str(LONGCTX["steps"])])
    launches = A.kernel_launches()
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite longctx loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"longctx loss did not fall: {losses}")
    for r in recs:
        if set(r["launches"].values()) != {LONGCTX["layers"]}:
            raise AssertionError(f"longctx step {r['step']} launched {r['launches']}, not "
                                 f"{LONGCTX['layers']} each")
    timed = recs[1:]  # the first step pays for cuBLAS's and the allocator's warm-up
    step_ms = sum(r["step_ms"] for r in timed) / len(timed)
    log("longctx", **LONGCTX, losses=losses, step_ms=[r["step_ms"] for r in recs],
        step_ms_mean=step_ms, tokens_per_s=LONGCTX["seq"] / (step_ms * 1e-3),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    torch.cuda.empty_cache()
    return launches


def remat_launches(n_layers: int) -> dict:
    """Each kernel's launches in one training step under full remat: the
    forward twice a layer, each backward once."""
    return {"flash_fwd": 2 * n_layers, "flash_bwd_dkdv": n_layers, "flash_bwd_dq": n_layers}


def small_card_vs_cpu(phase: str, cpu_params, card_params, make_optimizer, step,
                      n_steps: int, want: dict) -> dict:
    """``n_steps`` of ``step(params, optimizer, device) -> loss`` from the
    same weights on the CPU and on the card: the losses, the step-1
    gradients and the parameters after the steps must agree within
    TRAIN_TOL, and each card step must launch each kernel as ``want`` says.
    Logs the fields."""
    from hivedscheduler_tpu_torch.models import transformer
    from hivedscheduler_tpu_torch.ops import attention as A

    def run(params, device):
        opt = make_optimizer(params)
        losses, grads, launches = [], None, []
        for _ in range(n_steps):
            before = A.kernel_launches()
            losses.append(float(step(params, opt, device)))
            after = A.kernel_launches()
            launches.append({k: after[k] - before[k] for k in after})
            if grads is None:
                grads = [t.grad.detach().cpu().clone() for t in transformer.leaves(params)]
        return losses, grads, launches

    cpu_losses, cpu_grads, _ = run(cpu_params, "cpu")
    card_losses, card_grads, card_launches = run(card_params, "cuda")
    loss_gap = max(abs(a - c) for a, c in zip(cpu_losses, card_losses))
    grad_rel = max(((a - c).abs().max() / a.abs().max().clamp_min(1e-30)).item()
                   for a, c in zip(cpu_grads, card_grads))
    diffs = [(a.detach() - c.detach().cpu()).abs()
             for a, c in zip(transformer.leaves(cpu_params), transformer.leaves(card_params))]
    param_mean = sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs)
    fields = {"losses_cpu": cpu_losses, "losses_card": card_losses, "loss_gap": loss_gap,
              "grad_max_rel": grad_rel, "param_mean_abs_diff": param_mean, "tol": TRAIN_TOL,
              "launches_per_step": card_launches}
    if any(n != want for n in card_launches):
        raise AssertionError(f"small {phase} step launches {card_launches}, not {want}")
    if (loss_gap > TRAIN_TOL["loss"] or grad_rel > TRAIN_TOL["grad_max_rel"]
            or param_mean > TRAIN_TOL["param_mean"]):
        raise AssertionError(f"{phase} on the card disagrees with the CPU: {fields}")
    log(phase, step="small_card_vs_cpu", **fields)
    return fields


def phase_bert(seed: int, profile: bool) -> dict:
    """BERT (see the module docstring, phase 10): (a) a small f32 BERT on the
    card against the CPU; (b) BERT-large at its published size through the
    twin's step, with ``profile`` its device time by kernel over one more
    step. Returns each kernel's launches in (b)."""
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import bert, convert, perf, train
    from hivedscheduler_tpu_torch.ops import attention as A
    from hivedscheduler_tpu_torch.workloads import train_bert

    # (a) Small enough to run on the CPU, large enough to reach the kernels
    # (S >= 256, head_dim 32): two steps from the same weights on each side.
    config = bert.BertConfig(**BERT_SMALL["config"], dtype=torch.float32)
    cpu_params = bert.init(config, torch.Generator().manual_seed(seed), "cpu")
    card_params = convert.params_from_jax(convert.params_to_numpy(cpu_params), device="cuda")
    tokens, targets = train_bert.masked_batch(np.random.default_rng(seed + 5), BERT_SMALL["batch"],
                                              config.max_seq_len, config.vocab_size)
    small_card_vs_cpu(
        "bert", cpu_params, card_params, train_bert.make_optimizer,
        lambda params, opt, device: train_bert.captured_step(params, opt, tokens.to(device),
                                                             targets.to(device), config),
        BERT_SMALL["steps"], remat_launches(config.n_layers))
    del card_params, cpu_params

    # (b) BERT-large, nothing cut, on one fixed masked batch: the eager plain
    # version first, then the captured steps from the same weights.
    config = bert.bert_large()
    tokens, targets = train_bert.masked_batch(np.random.default_rng(seed + 6), BERT_LARGE["batch"],
                                              train_bert.SEQ, config.vocab_size)
    tokens, targets = tokens.cuda(), targets.cuda()
    params = bert.init(config, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    optimizer = train_bert.make_optimizer(params)
    eager = run_steps(lambda: train_bert.train_step(params, optimizer, tokens, targets, config),
                      lambda: params, BERT_LARGE["warmup"] + BERT_LARGE["timed"])
    del params, optimizer
    _free_card()
    t0 = time.perf_counter()
    params = bert.init(config, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    optimizer = train_bert.make_optimizer(params)
    torch.cuda.synchronize()
    log("bert", step="init", n_layers=config.n_layers, d_model=config.d_model,
        n_params=perf.n_params(params), seconds=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    _reset_train_graph_counts()
    recs = []
    for i in range(BERT_LARGE["warmup"] + BERT_LARGE["timed"]):
        before = A.kernel_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(train_bert.captured_step(params, optimizer, tokens, targets, config))
        step_ms = (time.perf_counter() - t1) * 1e3
        after = A.kernel_launches()
        recs.append({"loss": loss, "step_ms": step_ms,
                     "launches": {k: after[k] - before[k] for k in after}})
        log("bert", step=f"step_{i}", **recs[-1])
    launches = A.kernel_launches()
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite BERT loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"BERT loss did not fall on a fixed batch: {losses}")
    want = {"flash_fwd": 2 * config.n_layers, "flash_bwd_dkdv": config.n_layers,
            "flash_bwd_dq": config.n_layers}
    for r in recs:
        if r["launches"] != want:
            raise AssertionError(f"BERT-large step launched {r['launches']}, not {want}")
    timed = [r["step_ms"] for r in recs[BERT_LARGE["warmup"]:]]
    step_ms = sum(timed) / len(timed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("bert", step="summary", **BERT_LARGE, losses=losses, step_ms=timed, step_ms_mean=step_ms,
        tokens_per_s=BERT_LARGE["batch"] * train_bert.SEQ / (step_ms * 1e-3),
        peak_memory_gib=peak_gib, launches=launches)
    captured = {"losses": losses, "step_ms": [r["step_ms"] for r in recs],
                "digest": train.tree_digest(params), "peak_gib": peak_gib}
    check_train_graph(
        "bert_large", eager, captured, BERT_LARGE["warmup"],
        profile and (lambda: profile_step(
            lambda: train_bert.captured_step(params, optimizer, tokens, targets, config),
            step_ms, "bert_step")))
    del params, optimizer
    _free_card()
    return launches


def phase_mixtral(seed: int, profile: bool) -> dict:
    """Mixtral (see the module docstring, phase 11): (a) a small f32 Mixtral
    on the card against the CPU; (b) Mixtral-8x7B's widths served at 16
    layers; (c) the twin's job at 2 layers. With ``profile``, device time
    by kernel over one more request and one more step. Returns each
    kernel's launches in (b) and (c)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import serve
    from hivedscheduler_tpu_torch.models import convert, generate, mixtral, perf
    from hivedscheduler_tpu_torch.ops import attention as A
    from hivedscheduler_tpu_torch.workloads import train_mixtral

    # (a) Two twin steps from the same weights on each side, then greedy
    # tokens through the ffn hook.
    sm = MIXTRAL_SMALL
    config = mixtral.MixtralConfig(**sm["config"], dtype=torch.float32)
    cpu_params = mixtral.init(config, torch.Generator().manual_seed(seed), "cpu")
    card_params = convert.params_from_jax(convert.params_to_numpy(cpu_params), device="cuda")
    rng = np.random.default_rng(seed + 7)
    tokens = torch.from_numpy(serve.synthetic_tokens(rng, sm["batch"], config.max_seq_len,
                                                     config.vocab_size))
    small_card_vs_cpu(
        "mixtral", cpu_params, card_params, train_mixtral.make_optimizer,
        lambda params, opt, device: train_mixtral.captured_step(params, opt, tokens.to(device),
                                                                config),
        sm["steps"], remat_launches(config.n_layers))
    ffn = mixtral.decode_ffn(config)
    new = [generate.generate(params, tokens.to(device), config, sm["new_tokens"],
                             ffn=ffn)[:, config.max_seq_len:].cpu()
           for params, device in ((cpu_params, "cpu"), (card_params, "cuda"))]
    if not torch.equal(*new):
        raise AssertionError(f"greedy tokens differ: CPU {new[0].tolist()}, card {new[1].tolist()}")
    log("mixtral", step="small_greedy_tokens_equal", tokens=new[1].tolist())
    del card_params, cpu_params

    # (b) Serving at every width, 16 layers, phase 4's traffic.
    sv = MIXTRAL_SERVE
    t0 = time.perf_counter()
    config, params = serve.build(sv["model"], seed, "cuda", layers=sv["layers"])
    ffn = serve.decode_hook(config)
    torch.cuda.synchronize()
    log("mixtral", step="serve_init", n_layers=config.n_layers, n_params=perf.n_params(params),
        weights_gib=torch.cuda.memory_allocated() / 2**30, seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(seed + 8)

    def prompt(batch, length):
        return torch.from_numpy(serve.synthetic_tokens(rng, batch, length,
                                                       config.vocab_size)).cuda()

    _reset_graph_counts()
    warm = serve.run_request(params, prompt(sv["batch"], sv["prompt"]), config,
                             sv["new_tokens"], ffn=ffn)  # warm-up at the timed shape
    prompts = [prompt(sv["batch"], sv["prompt"]) for _ in range(sv["requests"])]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    results = [serve.run_request(params, p, config, sv["new_tokens"], ffn=ffn) for p in prompts]
    serve_launches = A.kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(r["captures"] for r in results):
        raise AssertionError("a timed Mixtral request captured a decode graph")
    check_decode_graph("mixtral", params, config, prompts[-1], sv["new_tokens"], results[-1],
                       warm["capture_ms"], ffn=ffn)
    if serve_launches["flash_fwd"] != config.n_layers * sv["requests"]:
        raise AssertionError(f"Mixtral prefill launched the flash kernel "
                             f"{serve_launches['flash_fwd']} times for {sv['requests']} "
                             f"prefills of {config.n_layers} layers")
    for r, res in enumerate(results):
        toks = res["tokens"]
        if toks.shape != (sv["batch"], sv["new_tokens"]):
            raise AssertionError(f"request {r}: tokens of shape {tuple(toks.shape)}")
        if not ((toks >= 0) & (toks < config.vocab_size)).all():
            raise AssertionError(f"request {r}: token ids out of range")
        log("mixtral", step="request", request=r, ttft_ms=res["ttft_ms"],
            decode_tok_s=res["decode_tok_s"], flash_launches=res["flash_launches"])
    # The prefill's last logits against the uncached forward() over the same
    # prompt: the same tokens, so the same capacity and routing.
    with torch.inference_mode():
        cache = generate.init_cache(config, sv["batch"], sv["prompt"], "cuda")
        last, _ = generate.prefill(params, prompts[-1], cache, config, ffn=ffn)
        del cache
        full = mixtral.forward(params, prompts[-1], config)[0][:, -1]
    gap = (last - full).abs().max().item()
    if not (torch.isfinite(last).all() and gap <= MAX_LOGIT_GAP):
        raise AssertionError(f"prefill logits lie {gap} from forward()'s (limit {MAX_LOGIT_GAP})")
    argmax_agree = int((last.argmax(-1) == full.argmax(-1)).sum())
    log("mixtral", step="serve_summary", **sv, launches=serve_launches,
        prefill_vs_forward_max_abs=gap, argmax_agree_rows=argmax_agree,
        peak_memory_gib=peak_gib)
    if profile:
        profile_request(params, prompts[-1], config, results[-1], sv["new_tokens"],
                        window="mixtral_", ffn=ffn)
    del params, last, full
    torch.cuda.empty_cache()

    # (c) The twin's job, 2 layers at every width: its eager plain version
    # (--plain), then the captured steps from the same seeds (one tree and
    # its AdamW is 50.6 GB).
    tr = MIXTRAL_TRAIN
    argv = ["--layers", str(tr["layers"]), "--steps", str(tr["warmup"] + tr["timed"])]
    runs = {}
    for plain in (True, False):
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        _reset_train_graph_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            recs = train_mixtral.main(argv + ["--plain"] * plain)
        print(printed.getvalue(), end="", flush=True)
        summary = json.loads(printed.getvalue().split("mixtral summary ", 1)[1].splitlines()[0])
        runs[plain] = {"losses": summary["losses"], "step_ms": [r["step_ms"] for r in recs],
                       "digest": summary["params_digest"],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    train_launches = A.kernel_launches()
    peak_gib = runs[False]["peak_gib"]
    losses = [r["loss"] for r in recs]
    base = mixtral.mixtral_8x7b()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite Mixtral loss: {losses}")
    expected = float(np.log(base.vocab_size)) + 0.5 + 0.01 * tr["layers"]
    if abs(losses[0] - expected) > LOSS_BAND:
        raise AssertionError(f"first loss {losses[0]} is not within {LOSS_BAND} of {expected}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral loss did not fall: {losses}")
    want = {"flash_fwd": 2 * tr["layers"], "flash_bwd_dkdv": tr["layers"],
            "flash_bwd_dq": tr["layers"]}
    for r in recs:
        if r["launches"] != want:
            raise AssertionError(f"Mixtral step {r['step']} launched {r['launches']}, not {want}")
    timed = [r["step_ms"] for r in recs[tr["warmup"]:]]
    step_ms = sum(timed) / len(timed)
    rows = train_mixtral.ROWS_PER_SHARD
    log("mixtral", step="train_summary", **tr, batch=[rows, train_mixtral.SEQ], losses=losses,
        step_ms=timed, step_ms_mean=step_ms,
        tokens_per_s=rows * train_mixtral.SEQ / (step_ms * 1e-3), peak_memory_gib=peak_gib,
        launches=train_launches)
    _free_card()

    def profile_mixtral():
        config = dataclasses.replace(base, n_layers=tr["layers"])
        params = mixtral.init(config, torch.Generator(device="cuda").manual_seed(seed), "cuda",
                              torch.float32)
        optimizer = train_mixtral.make_optimizer(params)
        tokens = torch.from_numpy(serve.synthetic_tokens(
            np.random.default_rng(seed + 9), rows, train_mixtral.SEQ, base.vocab_size)).cuda()
        for _ in range(2):  # the capture, then a replay
            float(train_mixtral.captured_step(params, optimizer, tokens, config))
        return profile_step(lambda: train_mixtral.captured_step(params, optimizer, tokens, config),
                            step_ms, "mixtral_step")

    check_train_graph("mixtral_8x7b_2_layers", runs[True], runs[False], tr["warmup"],
                      profile and profile_mixtral)
    _free_card()
    return {k: serve_launches[k] + train_launches[k] for k in train_launches}


def phase_zoo(seed: int, profile: bool) -> dict:
    """The zoo's other models (see the module docstring, phase 12): (a) a
    small f64 ResNet on the card against the CPU; (b) the ResNet-50 twin
    through the pod's launcher at its published shape, with ``profile`` its
    device time by kernel over one more step in this process; (c) the MNIST
    twin on the card. Returns each kernel's launches (none is expected)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hivedscheduler_tpu_torch.models import convert, resnet, transformer
    from hivedscheduler_tpu_torch.ops import attention as A
    from hivedscheduler_tpu_torch.workloads import train_mnist, train_resnet

    _reset_launches()
    # (a) Two twin steps from the same f64 weights on each side; the running
    # stats are carried from step to step on each side and compared after.
    sm = RESNET_SMALL
    config = resnet.ResNetConfig(**sm["config"], dtype=torch.float64)
    params, stats = resnet.init(config, torch.Generator().manual_seed(seed), "cpu")
    side = {device: [convert.params_from_jax(convert.params_to_numpy(t), device, torch.float64)
                     for t in (params, stats)] for device in ("cpu", "cuda")}
    images, labels = train_resnet.synthetic_batch(np.random.default_rng(seed + 10), sm["batch"],
                                                  sm["size"], config.num_classes)
    images = images.double()

    def step(p, opt, device):
        loss, side[device][1] = train_resnet.captured_step(p, side[device][1], opt,
                                                           images.to(device), labels.to(device),
                                                           config)
        return loss

    small_card_vs_cpu("zoo", side["cpu"][0], side["cuda"][0], train_resnet.make_optimizer, step,
                      sm["steps"], dict.fromkeys(A.kernel_launches(), 0))
    pairs = list(zip(transformer.leaves(side["cpu"][1]), transformer.leaves(side["cuda"][1])))
    stats_rel = max(((c - g.cpu()).abs().max() / c.abs().max()).item() for c, g in pairs)
    if stats_rel > TRAIN_TOL["stats_max_rel"]:
        raise AssertionError(f"small ResNet's running stats: card vs CPU {stats_rel} of max")
    log("zoo", step="small_stats_card_vs_cpu", max_rel=stats_rel,
        max_abs_diff=max((c - g.cpu()).abs().max().item() for c, g in pairs),
        largest=max(c.abs().max().item() for c, _ in pairs), tol=TRAIN_TOL["stats_max_rel"])
    del side

    # (b) The ResNet-50 twin through the pod's launcher, one card: its eager
    # plain version (--plain), then the captured steps from the same seeds.
    rn = RESNET
    runs = {}
    for plain in (True, False):
        out = launch_pod("hivedscheduler_tpu_torch.workloads.train_resnet",
                         ["--batch", str(rn["batch"]), "--image-size", str(rn["size"]),
                          "--steps", str(rn["warmup"] + rn["timed"])] + ["--plain"] * plain, 1)
        steps = [m.groups() for m in _TWIN_STEP.finditer(out)]
        summary = resnet_summaries(out)
        if len(steps) != rn["warmup"] + rn["timed"] or len(summary) != 1:
            raise AssertionError(f"the ResNet twin printed {len(steps)} steps and "
                                 f"{len(summary)} summaries")
        runs[plain] = {"losses": summary[0]["losses"],
                       "step_ms": [float(st[2]) for st in steps],
                       "digest": (summary[0]["params_digest"], summary[0]["bn_stats_digest"]),
                       "peak_gib": summary[0]["peak_memory_gib"], "graph": summary[0]["graph"]}
    losses = [float(st[1]) for st in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite ResNet loss: {losses}")
    if abs(losses[0] - np.log(1000)) > LOSS_BAND:
        raise AssertionError(f"first ResNet loss {losses[0]} is not within {LOSS_BAND} of ln(1000)")
    if not (summary[0]["bn_mean_abs_max"] > 0 and summary[0]["bn_var_dev_max"] > 0):
        raise AssertionError(f"the running stats did not move from (0, 1): {summary[0]}")
    timed = [float(st[2]) for st in steps[rn["warmup"]:]]
    step_ms = sum(timed) / len(timed)
    log("zoo", step="resnet50", **rn, losses=losses, step_ms=timed, step_ms_mean=step_ms,
        images_per_s=rn["batch"] / (step_ms * 1e-3),
        **{k: v for k, v in summary[0].items() if k not in ("losses", "graph")})

    check_train_graph("resnet50", runs[True], runs[False], rn["warmup"],
                      profile and (lambda: profile_resnet_step(rn["batch"], rn["size"], step_ms,
                                                               "resnet50_step")))
    _free_card()

    # (c) The MNIST twin on the card (its steps replay one captured graph),
    # then the gate: the twin's steps from its seeds, eager and captured.
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        losses = train_mnist.main([])
    print(printed.getvalue(), end="", flush=True)
    if not (printed.getvalue().splitlines()[-1] == "done" and losses[-1] < losses[0]):
        raise AssertionError(f"MNIST: losses {losses[0]} -> {losses[-1]}")
    log("zoo", step="mnist", steps=len(losses), first_loss=losses[0], last_loss=losses[-1])
    runs = {}
    for plain in (True, False):
        _reset_train_graph_counts()
        rng = np.random.default_rng(0)  # main's weights, then its data
        params = {k: torch.from_numpy(v).cuda() for k, v in train_mnist.init(rng).items()}
        x, y = (torch.from_numpy(a).cuda() for a in train_mnist.synthetic_data(rng))
        optimizer = train_mnist.make_optimizer(params)
        step = train_mnist.train_step if plain else train_mnist.captured_step
        runs[plain] = run_steps(lambda: step(params, optimizer, x, y), lambda: params,
                                len(losses))
    if runs[False]["losses"] != losses:
        raise AssertionError("the MNIST twin's losses differ from its own steps' replayed")
    check_train_graph("mnist_mlp", runs[True], runs[False])
    launches = A.kernel_launches()
    if set(launches.values()) != {0}:
        raise AssertionError(f"the zoo's ResNet and MNIST launched {launches}")
    return launches


def device_time_rows(prof) -> list:
    """(device ms, kernel name, launches) by kernel, largest first. User
    annotations (``Optimizer.step``'s range) are not kernels: their device
    time is their kernels' again."""
    from torch.autograd import DeviceType

    return sorted(
        ((ev.self_device_time_total / 1e3, ev.key, ev.count) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
         and not getattr(ev, "is_user_annotation", False)),
        reverse=True,
    )


def port_kernel_rows(rows) -> list:
    """The rows of the port's own kernels, wherever they rank."""
    return [{"kernel": m.group(0), "ms": ms, "calls": n, "ms_per_call": ms / n}
            for ms, k, n in rows for m in [re.search(r"flash_\w+<\d+>", k)] if m]


def profile_train_step(params, optimizer, tokens, config, unprofiled_ms: float,
                       window: str = "train_step", mesh=None) -> float:
    """Device time by kernel over one training step, a replay of the
    captured step (sharded on ``mesh``); the idle share (returned) is taken
    against the mean unprofiled step time."""
    from hivedscheduler_tpu_torch.models import train

    return profile_step(lambda: train.captured_step(params, optimizer, tokens, config,
                                                    tokens.device, mesh),
                        unprofiled_ms, window)


def profile_step(step, unprofiled_ms: float, window: str) -> float:
    """Device time by kernel over one call of ``step`` (a training step that
    returns its loss); the idle share (returned) is taken against
    ``unprofiled_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step())
        torch.cuda.synchronize()
    rows = device_time_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    idle = 1 - busy_ms / unprofiled_ms
    log("profile", window=window, wall_ms_unprofiled=unprofiled_ms,
        device_busy_ms=busy_ms, idle_share=idle,
        kernel_launches=sum(r[2] for r in rows),
        top=[{"kernel": k[:90], "ms": ms, "calls": n} for ms, k, n in rows[:14]],
        port_kernels=port_kernel_rows(rows))
    return idle


def profile_request(params, prompt, config, unprofiled: dict, new_tokens: int = SERVE["new_tokens"],
                    mesh=None, window: str = "", ffn=None) -> None:
    """Device time by kernel over one request (sharded on ``mesh``), prefill
    and decode apart (torch.profiler, kernel events only). The idle share is
    taken against the same request's wall time without the profiler
    (``unprofiled``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hivedscheduler_tpu_torch.models import generate

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    stream = generate.generate_stream(params, prompt, config, new_tokens, mesh=mesh, ffn=ffn)
    with profile(activities=activities) as prefill:
        next(stream)
        torch.cuda.synchronize()
    replays = generate.Decoder.replays
    with profile(activities=activities) as decode:
        for _ in stream:
            pass
        torch.cuda.synchronize()
    replays = {"prefill": 0, "decode": generate.Decoder.replays - replays}
    walls = {
        "prefill": unprofiled["ttft_ms"],
        "decode": 1e3 * prompt.shape[0] * (new_tokens - 1) / unprofiled["decode_tok_s"],
    }
    for name, prof in (("prefill", prefill), ("decode", decode)):
        rows = device_time_rows(prof)
        busy_ms = sum(r[0] for r in rows)
        log("profile", window=window + name, wall_ms_unprofiled=walls[name],
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / walls[name],
            kernel_launches=sum(r[2] for r in rows), graph_replays=replays[name],
            top=[{"kernel": k[:90], "ms": ms, "calls": n} for ms, k, n in rows[:10]],
            port_kernels=port_kernel_rows(rows))


def sp_shapes(kb: dict, kind: str) -> list:
    """One kernel's numbers at phase 3's Ulysses per-rank shapes, for the
    kernels line: held at the checked length, timed there (``*_check``,
    with the plain version) and at SP_TIME_SEQ, where the plain version
    cannot run (``plain_ms`` null). ``library_ms``: SDPA's forward for the
    forward kernel, its whole backward for the backward ones."""
    return [{"cards": r["cards"], "sp": r["sp"], "tp": r["tp"], "shape": r["shape"],
             "checked_shape": r["checked_shape"], "max_abs_err": r[f"{kind}_max_abs_err"],
             "plain_ms": None, **r[kind],
             "library_ms": r["library_fwd_ms" if kind == "fwd" else "library_bwd_ms"]}
            for r in kb["sp_shapes"]]


# Phase 3's shape groups that hold and time all three kernels.
GROUPS = ("tp", "bert", "pp", "mixtral")


def rank_shapes(kb: dict, group: str, kind: str) -> list:
    """One kernel's numbers at phase 3's per-rank shapes of ``group`` ("tp":
    a tp gang's rank; "bert": BERT-large's attention; "pp": a pipeline
    stage's microbatch; "mixtral": Mixtral's training batch), for the
    kernels line. ``library_ms``: SDPA's
    forward for the forward kernel, its whole backward for the backward
    ones."""
    rows = []
    for r in kb[f"{group}_shapes"]:
        if kind == "fwd":
            nums = {key: r["fwd"][src] for key, src in (
                ("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                ("bound_by", "bound_by"), ("library_ms", "library_ms"))}
            err = r["fwd"]["o_max_abs_err"]
        else:
            nums = {key: r[kind][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
            nums["library_ms"] = r["library_ms"]
            err = r[f"{kind}_max_abs_err"]
        name = {"tp": r["tp"]} if group == "tp" else {"label": r["label"], "causal": r["causal"]}
        rows.append({**name, "shape": r["shape"], "max_abs_err": err, **nums})
    return rows


def print_ok(torch) -> None:
    """The last line: the run passed, on these cards."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description="smoke run of the port on one card")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel over one request, "
                             "over one training step and over one step of the "
                             "perf harness's model, unsharded and sharded, "
                             "over one BERT-large step, over Mixtral's "
                             "request and step, over one ResNet-50 step and, "
                             "on four cards, over a request on each serving "
                             "gang's rank")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel checks and timings (phase 3)")
    parser.add_argument("--gang-only", action="store_true",
                        help="build, then only the gangs across cards (phase 8's last part); "
                             "needs two cards or more")
    parser.add_argument("--gangs", default=",".join(GANGS),
                        help=f"with --gang-only, a comma list of {GANGS} (default: all)")
    parser.add_argument("--workloads-job", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--serve-gang-job", metavar="NAME", help=argparse.SUPPRESS)
    parser.add_argument("--train-gang-job", metavar="NAME", help=argparse.SUPPRESS)
    parser.add_argument("--gang-dir", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.workloads_job:  # phase 6's pod process, started by the launcher
        print(json.dumps({"workloads_job": workloads_job(args.seed, args.workloads_job)}),
              flush=True)
        return 0
    if args.train_gang_job:  # a training gang's rank, started by the launcher
        result = train_gang_job(args.train_gang_job, args.profile, args.gang_dir)
        sys.stdout.flush()  # the result goes to the shared pipe in a write of its own
        print(json.dumps({"train_gang_job": result}), flush=True)
        return 0
    if args.serve_gang_job:  # a serving gang's rank, started by the launcher
        result = serve_gang_job(args.serve_gang_job, args.profile)
        sys.stdout.flush()
        print(json.dumps({"serve_gang_job": result}), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    from hivedscheduler_tpu_torch.ops import _build

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log("phase", name=name, seconds=time.perf_counter() - t0)
        return out

    log("build", seconds=_build.build_all(), sources=[s.name for s in _build.sources()])
    if args.gang_only:
        gangs = [g for g in args.gangs.split(",") if g]
        if set(gangs) - set(GANGS):
            raise SystemExit(f"--gangs: unknown {sorted(set(gangs) - set(GANGS))}; of {GANGS}")
        if timed("gang", phase_gang, args.profile, gangs) < 2:
            raise AssertionError("--gang-only needs two cards or more")
        print(smi)
        print_ok(torch)
        return 0
    k = timed("kernels", phase_kernels, args.seed)
    kb = timed("kernels_bwd", phase_kernels_bwd, args.seed)
    if args.kernels_only:
        print(smi)
        return 0
    s = timed("serve", phase_serve, args.seed, args.profile)
    t = timed("train", phase_train, args.seed, args.profile)
    w = timed("workloads", phase_workloads, args.seed)
    p, zoo = timed("perf", phase_perf, args.profile)
    sh = timed("sharded", phase_sharded, args.seed, args.profile, s, t)
    lc = timed("longctx", phase_longctx)
    bt = timed("bert", phase_bert, args.seed, args.profile)
    mx = timed("mixtral", phase_mixtral, args.seed, args.profile)
    zo = timed("zoo", phase_zoo, args.seed, args.profile)
    zoo = {k: zoo[k] + zo[k] for k in zoo}  # the perf harness's zoo stage and phase 12

    source = "hivedscheduler_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": source + "flash_fwd.cu",
        "replaces": "hivedscheduler_tpu/ops/attention.py:133",
        "launches": (s["launches"] + t["launches"]["flash_fwd"] + w["flash_fwd"] + p["flash_fwd"]
                     + sh["flash_fwd"] + lc["flash_fwd"] + bt["flash_fwd"] + mx["flash_fwd"]
                     + zoo["flash_fwd"]),
        "launches_by_path": {"serve": s["launches"], "train": t["launches"]["flash_fwd"],
                             "workloads": w["flash_fwd"], "perf": p["flash_fwd"],
                             "sharded": sh["flash_fwd"], "longctx": lc["flash_fwd"],
                             "bert": bt["flash_fwd"], "mixtral": mx["flash_fwd"],
                             "zoo": zoo["flash_fwd"]},
        # Held at the serving shape and at the training shape.
        "max_abs_err": max(k["o_max_abs_err"], kb["fwd"]["o_max_abs_err"]),
        **{key + suffix: fields[src] for suffix, fields in (("", k), ("_train", kb["fwd"]))
           for key, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                            ("bound_ms", "bound_ms"), ("bound_by", "bound_by"),
                            ("library_ms", "library_ms"), ("tflops", "kernel_tflops"))},
        # The four-card serving gangs' ranks' prefills: tp 4, fsdp 2 x ep 2.
        **{f"{name}_shape": {"shape": list(shape[:5]), "causal": shape[5],
                             "max_abs_err": k[name]["o_max_abs_err"],
                             **{key: k[name][src] for key, src in (
                                 ("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                                 ("bound_ms", "bound_ms"), ("bound_by", "bound_by"),
                                 ("library_ms", "library_ms"), ("tflops", "kernel_tflops"))}}
           for name, shape in (("serve_tp4", SERVE_TP4_SHAPE), ("serve_ep", SERVE_EP_SHAPE))},
        # One rank of a tp gang at the training shape (phase 3).
        **{f"{group}_shapes": rank_shapes(kb, group, "fwd") for group in GROUPS},
        "sp_shapes": sp_shapes(kb, "fwd"),
    }]
    for name, kind, line in (("flash_bwd_dkdv", "dkdv", 201), ("flash_bwd_dq", "dq", 278)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source + "flash_bwd.cu",
            "replaces": f"hivedscheduler_tpu/ops/attention.py:{line}",
            "launches": (t["launches"][name] + w[name] + p[name] + sh[name] + lc[name] + bt[name]
                         + mx[name] + zoo[name]),
            "launches_by_path": {"train": t["launches"][name], "workloads": w[name],
                                 "perf": p[name], "sharded": sh[name], "longctx": lc[name],
                                 "bert": bt[name], "mixtral": mx[name], "zoo": zoo[name]},
            "max_abs_err": kb[f"{kind}_max_abs_err"],
            "ms": kb[kind]["ms"],
            "plain_ms": kb[kind]["plain_ms"],
            "bound_ms": kb[kind]["bound_ms"],
            "bound_by": kb[kind]["bound_by"],
            # SDPA's whole backward (dQ, dK and dV in one call): compare it
            # with the two kernels' sum.
            "library_ms": kb["library_ms"],
            **{f"{group}_shapes": rank_shapes(kb, group, kind) for group in GROUPS},
            "sp_shapes": sp_shapes(kb, kind),
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print_ok(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
