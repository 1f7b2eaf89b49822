#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc/``, checks
in their SASS that the conv, flash and fused CE kernels run on the tensor
cores (the bf16 forms of the flash, CE and conv kernels on bf16 m16n8k16
HMMAs, the conv's fed by ldmatrix; the warpgroup-product forms of the bf16
flash forward and backward, CE, conv_moments and conv_apply on bf16 HGMMAs
and no HMMA), holds each kernel
against its plain
PyTorch version on the card, f32 and, for every kernel but the scatter,
bf16 (AMP; the bf16 forms also against f64, beside the plain bf16
version's error) (the
conv kernels also against an f64 conv, beside cuDNN's f32 one, and for
bitwise equal moments across two runs; the flash kernels at head dims 12 to
512, with a rich bias, and against an f64 attention, beside the plain
version's f32 one, and the bf16 wgmma backward 50 times against its first
run: dk, dv, dbias bitwise, dq within its stated bound; the fused CE kernel at ragged T, D and V, for bitwise
equal results across two runs, and against an f64 projection and CE, beside
the plain version's f32 one), times
it (the conv kernels at each of ResNet-50's distinct fused geometries,
read from the fusion's record of the built program; the flash forward at
the served and the training shape), and then drives the port's main paths
at full width, each with the kernels' launch counts set to 0 just before
it and read just after:

* serving BERT-base (vocab 30522, seq 128, d_model 768, d_ff 3072, 12
  heads, 12 layers; random weights from seed 11): layers -> Program ->
  Executor (startup on the card) -> io.save_inference_model ->
  ServingEngine -> Predictor -> op interpreter -> kernels;
* training Transformer-base (vocab 30000/30000, seq 256, d_model 512,
  d_ff 2048, 8 heads, 6+6 layers, dropout 0.1, Adam 1e-4, 128 x 256 tokens
  per step; random weights from seed 11): layers -> Program ->
  optimizer.minimize (autodiff + adam ops) -> Executor -> forward ops ->
  torch.autograd backward through the kernels' autograd Functions ->
  adam, for 3 warm-up and 20 timed steps on one fixed batch, in f32
  (phase ``train``) and under ``fluid.amp.decorate`` (``amp_train``: bf16
  products, the bf16 forms of the flash, LayerNorm and fused CE kernels,
  f32 parameters and Adam state);
* training ResNet-50 (224 x 224 x 3, 1000 classes, batch 128, Adam 1e-4;
  random weights from seed 11) the same way, with the executor's epilogue
  fusion turning 49 of its 53 conv -> BN (+ add)(+ relu) chains into the
  fused-conv kernels, for 3 warm-up and 10 timed steps;
* evaluating ResNet-50 through ``main.clone(for_test=True)`` at batch 128
  (the inference kernel at the same 49 sites);
* both again under ``fluid.amp.decorate`` (``resnet_amp_train``,
  ``resnet_amp_eval``: the clone marked with ``fluid.amp.enable_bf16``;
  bf16 convs and activations through the bf16 forms of the three
  fused-conv kernels, f32 parameters, statistics and Adam state);
* training DeepFM (100,000 x 32 fused table, 26 fields, K = 16, MLP 400 x
  3, 13 dense features, batch 32768, Adam 1e-4; random weights from seed
  11) the same way: its ``embedding(is_sparse=True)`` gives a (rows,
  values) gradient, which Adam densifies through the row scatter-add
  kernel, once per step, for 3 warm-up and 20 timed steps, in f32
  (``deepfm_train``) and under ``fluid.amp.decorate``
  (``deepfm_amp_train``: bf16 MLP products, the f32 table and scatter);
* training BERT-base pretraining (config 4: the masked-LM head over the
  fused projection + CE and the next-sentence head; random weights from
  seed 11) at 128 x 128 tokens with dropout 0.1 under
  ``fluid.amp.decorate(Adam(1e-4))`` as ``bench.py:192-198,225-231``
  trains it, and under Lamb(1e-4) with ``accumulate_steps=2`` and
  ``fluid.memory_optimize`` (``bert_pretrain``: the bf16 flash, LayerNorm
  and CE kernels at BERT's shapes, the flash and CE on their wgmma forms,
  the recompute's forwards counted from the remat segments);
* serving generation at GPT-2 small's widths (the repo's ``transformer_lm``:
  vocab 50257, d_model 768, d_ff 3072, 12 heads, 12 layers, 1024
  positions, 163,000,320 parameters; random weights from seed 11): the
  step program saved with ``save_inference_model`` and its
  ``decode_spec.json`` -> ``ServingEngine(dir, decode=True, ...)`` ->
  ``DecodeBatcher`` (slot recycling; in a second arm chunked prefill,
  speculative decode with the full program as draft, and the prefix
  cache) -> step and chunk dispatches, captured over the replica's own
  caches -> the LayerNorm forward kernel, and the flash forward in the
  draft's passes; 64 requests in a closed loop of 16; each arm's
  dispatch wall, busy share and memory beside an interpreted batcher's
  and engine's;
* the serving front door over those two directories: ``serving.Router``
  over two worker processes (``python -m paddle_tpu_torch.serving.worker``,
  each one ``ServingEngine`` on ``cuda:0``, every rung captured before
  READY) -> ``rpc`` frames -> the engines above; BERT-base 400 requests
  in a closed loop of 32 beside the in-process numbers, the CPU check,
  one trace stitched across the processes (``router_serve``); a burst of
  64 with one worker SIGKILLed, its respawn and the flight dump's audit
  (``router_chaos``); GPT-2-small decode through two workers with the
  prefix cache, SIGKILLed mid-decode (``router_decode``). Each worker's
  launches are read in that process (its ``stats`` verb and exit line);
* the attention seq2seq NMT model at its reference width
  (``models.machine_translation``: vocabulary 10000/10000, sequence 50,
  bi-GRU encoder and GRU decoder 512 wide, one attention head of 512;
  random weights from seed 11): training at batch 128 x 50 tokens under
  Adam(1e-3) (``mt_train``: the GRUs' steps on the tape, the flash
  forward and backward at head dim 512, captured), beam decode (beam 4,
  50 steps) in a While loop on the trained weights at batch 64
  (``mt_decode``: interpreted, the loop reads its condition on the host;
  a flash forward at Tq = 1 against 50 keys every trip), and the beam and
  greedy programs served one-shot through ``ServingEngine(ladder=(1, 2,
  4, 8))`` over a ``ProgramPredictor`` (``mt_serve``: 256 requests of 1-4
  sentences in a closed loop of 16, then 64 greedy; solo equals batched
  at rung 4, bitwise);
* the Fluid benchmark's stacked LSTM (``models.stacked_lstm``'s
  ``stacked_lstm_net`` at its defaults: a 30000 x 512 table, three
  512-wide LSTMs over 80 steps, the later two reversed, max-pooled, 2
  classes; 30,057,474 parameters; random weights from seed 11) trained at
  batch 128 with random lengths under Adam(1e-3) (``lstm_train``: each
  LSTM step on the tape, captured; no port kernel: the table is 512
  wide);
* semantic role labeling with its CRF at the book chapter's widths
  (``models.label_semantic_roles.srl_crf(word_dim=32, hidden_dim=512,
  depth=8)``) trained at batch 128 x 16 (``srl_train``: its three narrow
  dense tables' lookup backward on the row scatter-add kernel, 3 launches
  a step, captured), then ``crf_decoding`` through its
  ``clone(for_test=True)``;
* SSD (``models.ssd.ssd_lite`` at its defaults: 5 classes, 3 x 64 x 64, 4
  boxes, 240 priors, 91,846 trainable parameters; random weights from
  seed 11) trained at batch 128 under Adam(2e-3) (``ssd_train``: the
  bipartite match, the encoded targets and the hard-negative-mined
  multibox loss on the tape, captured; no port kernel: the epilogue
  fusion's four 3x3 stride-2 trunk sites are declined by the fused conv's
  gate), then decode + NMS and ``detection_map`` through its
  ``clone(for_test=True)`` (``ssd_eval``);
* DCGAN (Radford et al. 2016) at its LSUN widths (``build_dcgan``: G from
  z [100, 1, 1] through 4x4 transposed convs 1024-512-256-128 to 3 x 64 x
  64, D through 4x4 convs 128-256-512-1024; 12.7 M + 11.0 M parameters;
  random weights from seed 11) trained at batch 128 under Adam(2e-4,
  beta1 0.5) in three programs over one scope, each captured: G's images,
  a D step, a G step through D (``dcgan_train``; no port kernel: the
  transposed convs are cuDNN's, and the epilogue fusion declines D's 4x4
  stride-2 sites).
* the streaming loop at DeepFM's config 5 widths: ``stream_check`` (the
  streaming trainer at batch 64 on the card and on the CPU from one
  state over the same five stream batches: each loss, each published
  version, the card's version loaded on the CPU bitwise, a captured
  dropout step after a generator restore bitwise); ``stream_train``
  (``AsyncExecutor.run`` over five sealed files through the C++ queue,
  then ``StreamingTrainer`` at batch 32768 tail-following the part files
  a producer thread appends, 3 + 20 steps, a version every 5 hot-swapped
  by ``ModelPublisher`` into a ``ServingEngine`` under a closed loop of
  requests: ingest rows/s, step ms and busy share, snapshot and writer
  ms, staleness, p99 inside and outside swap windows, 0 dropped, the
  held-out loss falling; one scatter-add a launching step); and
  ``stream_fleet`` (two workers behind the router driven by
  ``FleetPublisher`` through ``RouterTarget``: two-phase rounds answering
  bitwise as an in-process predictor of the version, a corrupt version
  refused at prepare, and the trainer CLI SIGKILLed inside a publish,
  its torn version invisible and the restart's replay counted).

Before each training path, ``train_check``, ``amp_train_check``,
``resnet_train_check``, ``resnet_amp_train_check``, ``deepfm_train_check``
and ``deepfm_amp_train_check`` run one full-width step (at batch 2, 2, 2,
2, 64 and 64) on the card and the same step with the port on the CPU from
the same weights and feed (the AMP checks also f32 steps on the CPU and on
the card: the loss and each quantity that separates AMP from f32 must lie
within half the CPU's AMP-vs-f32 distance of its AMP step, where the
card's f32 step must not, and every kernel with a bf16 form must have
launched in bf16, the flash forward and CE on their wgmma forms;
ResNet-50's AMP step, chaotic at random init, is held
so op by op, each op run on the CPU AMP chain's own inputs);
``bert_pretrain_check`` holds BERT pretraining at batch 2 the same way in
four arms (f32 Adam, AMP Adam, Lamb, Lamb with accumulation and remat:
the loss change over each update too), and ``optimizer_check`` trains
DeepFM three steps under each new update op and the parameter averages
against the CPU, the scatter-add launched once a step where the
optimizer densifies the table's sparse gradient; ``mt_train_check``
holds one NMT step at batch 2 (loss, every gradient, the Adam update)
against the CPU, and ``mt_decode`` its first 16 decoded sentences under a
near-tie rule (the beams each step kept exact up to a row's first step
whose K-th and (K+1)-th candidates lie within 2e-4 + 1e-5 x |score| on
the CPU, the
sentences and scores of the rows with no such step), on the trained
weights and on the initial ones with the output projection 1000x;
``lstm_train_check`` holds one full-width stacked-LSTM step at batch 2
and ``srl_check`` one SRL step at batch 128 against the CPU (the loss,
every gradient and Adam update), ``srl_check`` also the Viterbi paths of
the for_test clone under a near-tie rule; ``rnn_zoo_check`` one step of
each other builder of the group at its defaults (the book's sentiment
and recommender models, fit_a_line, CTC OCR, word2vec under nce and
hsigmoid) against the CPU; ``narrow_scatter_check`` holds the scatter
kernel at SRL's three table shapes against its plain version and times
it; ``detection_ops_check`` runs each of the 26 detection op types at its
published model's size (SSD300 VOC's decode and NMS at batch 8, a Faster
R-CNN RPN and its RoI ops at 800 x 1333, YOLOv3-416's three heads,
R-FCN's position-sensitive pooling, Mask R-CNN's mask targets) on the
card against the port on the CPU (floats within 1e-5, gradients within
1e-5 relative L2, discrete outputs equal), and ``ssd_train_check`` one
``ssd_lite`` step at batch 4 (the loss, every gradient and Adam update,
the bipartite match and the mined negatives; ``ssd_eval`` holds the
clone's detections against the CPU under a near-tie rule and its mAP
against the CPU's on the card's detections); ``srl_check`` also scores
its paths with ``chunk_eval`` (IOB) and ``rnn_zoo_check`` decodes
``crnn_ctc``'s eval clone with ``ctc_greedy_decoder`` and scores it with
``edit_distance`` (both against the CPU under a near-tie rule);
``misc_nn_ops_check`` runs each of the 52 op types of ``misc_ops`` and
``nn_ops`` that came last (group_norm at ResNet-50's stage 1, lrn at
AlexNet's conv1, conv3d and pool3d at C3D's first block, the DeepLab-v3+
4x upsample, ``sample_logits`` at BERT's vocabulary, ...) on the card
against the CPU (floats within 1e-5, gradients within 1e-5 relative L2,
integers equal; the random ops each held to its own draw);
``sdpa_check`` holds the ``scaled_dot_product_attention`` layer at
Transformer-base widths, forward and backward, on the flash kernels
against the CPU; ``debug_ops_check`` holds ``Print``'s text and
``py_func``'s values in a training step against the CPU, and both
programs interpreted; ``dcgan_train_check`` one D and one G step of
full-width DCGAN at batch 4 against the CPU; before decode,
``decode_check`` holds four step
dispatches and
a chunk against the CPU, out-of-range cache positions, and the ids of
solo, batched, chunked and speculative decode.

The executor runs each main path as the reference does, one compiled step
per (program, feed signature, fetch set): the first run of a key is
interpreted, the second captured as one CUDA graph, every later run a
replay; the decode tier's step and chunk dispatches too, over the caches
the batcher lends (written in place), captured in the engine's warmup.
Phase ``capture_check`` (before the timed phases) holds four captured
steps of each main-path program (Transformer-base f32 and AMP, ResNet-50
AMP train and eval, DeepFM, BERT-base serving) against four interpreted
ones from the same state and generator state, within twice the distance
of two interpreted runs, and runs each one's first call under
``torch.cuda.set_sync_debug_mode("error")``; seven steps under
``exponential_decay`` (the rate of the replays bitwise the interpreted
run's); decode step and chunk dispatches over lent caches; five fresh
eval clones through one executor (``memory_reserved`` flat: dead keys'
graphs are released); two keys of one executor replayed in turns (one
pool, one fetch arena); and holds a decode step over an unlent cache and
a merged-sparse step to ``captured: false`` with their reasons. Each timed
phase prints ``captured`` and ``reason``; ``amp_train``,
``resnet_amp_train`` and ``deepfm_train`` also time interpreted steps in
the same call, and ``amp_train`` captured steps with
``PADDLE_TPU_FUSED_OPT=1``. A replay launches no kernel from Python, so
the exact launch counts hold for the interpreted and captured steps, and
each profiled replay must launch the device kernels of the table, kind by
kind, of the key's profiled first step. Each phase prints one JSON
line; any failure raises and exits non-zero. The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``. Without CUDA, or
outside the repository, it exits non-zero and prints no result.
"""

import contextlib
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, f32 FLOP/s on the CUDA
# cores (the LayerNorm and scatter kernels do their arithmetic there, in
# f32), and TF32 FLOP/s on the tensor cores, where the conv, flash and fused
# CE kernels run each f32 product as three TF32 products (3xTF32)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
# bf16 tensor-core FLOP/s (dense): the AMP forms of the flash and fused CE
# kernels run one bf16 product per product
BF16_FLOPS = 989e12

BERT = dict(vocab=30522, seq=128, d_model=768, d_ff=3072, heads=12,
            layers=12)
# Transformer-base as paddle_tpu's bench.py trains it (:174-177, :229)
TRANSFORMER = dict(src_vocab=30000, trg_vocab=30000, seq_len=256,
                   d_model=512, d_ff=2048, n_head=8, n_layer=6)
TRAIN_BATCH = 128
# the bf16 kernels' timing shapes (``_bf16_kernel_timing``): the AMP
# Transformer step's (its encoder self-attention, the smoothed CE)
TRANSFORMER_TIMING = dict(batch=TRAIN_BATCH, seq=TRANSFORMER["seq_len"],
                          heads=TRANSFORMER["n_head"],
                          d_model=TRANSFORMER["d_model"],
                          vocab=TRANSFORMER["trg_vocab"], dropout=0.0,
                          ce_eps=0.1, ce_bias=False)
# ResNet-50 as paddle_tpu's bench.py trains it (BASELINE config 2,
# :200-207, :229), in f32 and under AMP (bench.py:225-231)
RESNET = dict(depth=50, class_num=1000, image_shape=(3, 224, 224))
RESNET_BATCH = 128
# DeepFM as paddle_tpu's bench.py trains it (BASELINE config 5, :208-214,
# :229), in f32 and under AMP (bench.py:225-231); the fused table is 32
# wide
DEEPFM = dict(sparse_feature_dim=100000, num_fields=26, embedding_size=16,
              dense_dim=13, hidden_sizes=(400, 400, 400))
DEEPFM_WIDTH = 32
DEEPFM_BATCH = 32768
SEED = 11
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "layer_norm_fwd",
           "layer_norm_bwd", "fused_ce_fwd", "conv_moments", "bn_apply",
           "conv_apply", "scatter_add")
BF16_FORMS = KERNELS[:8]  # the kernels with a bf16 form (not the scatter)
# the kernels whose bf16 form has a second, warpgroup-product (wgmma) form,
# routed by shape; ``wgmma_launches`` on each wrapper counts it
WGMMA_FORMS = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd",
               "conv_moments", "conv_apply")


# the main paths that run under fluid.amp: every launch of a kernel with a
# bf16 form is a bf16 launch there (their phases check it)
AMP_PATHS = ("amp_train", "resnet_amp_train", "resnet_amp_eval",
             "deepfm_amp_train", "bert_pretrain", "dygraph_train")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


# the helpers whose wall seconds the ``phase_seconds`` line adds beside
# the phases' (where the phases that call them spend their time)
TIMED_HELPERS = ("_capture_case", "_decode_capture_case", "_clone_evals",
                 "_interleaved_keys", "_flash_bwd_repeat", "_decode_arm",
                 "_interpreted_replica_memory", "_step_copies",
                 "_decode_profile", "_cpu_verdict", "_serve_arm")


def time_phases(ns, out):
    """Wrap every ``phase_*`` function of the module namespace ``ns`` and
    each of TIMED_HELPERS it has, so that each call adds its wall seconds
    and one call to ``out[name]`` ([seconds, calls]; a helper's seconds
    are also inside its phase's). ``paddle_tpu_torch/tools/phase_times.py``
    applies it to another checkout's script."""
    names = [n for n in ns if n.startswith("phase_")]
    for name in names + [n for n in TIMED_HELPERS if n in ns]:
        fn = ns[name]
        if not callable(fn):
            continue

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                got = out.setdefault(_name, [0.0, 0])
                got[0] += time.perf_counter() - t0
                got[1] += 1
        ns[name] = timed


def time_ms(fn, iters=50, warmup=5):
    """Median device time of ``fn`` over ``iters`` runs, each between its
    own pair of CUDA events. A sleep kernel queued first keeps the stream
    busy while the host enqueues every run, so host-side launch overhead
    stays out of the intervals."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def kernel_fns():
    """name -> the wrapper whose ``launches`` counts that kernel (and,
    for BF16_FORMS, whose ``bf16_launches`` counts its bf16 form), in the
    order of ``ops.KERNEL_WRAPPERS`` (KERNELS')."""
    import importlib

    from paddle_tpu_torch import ops

    return {name: getattr(importlib.import_module(
        "paddle_tpu_torch.ops." + mod), name)
        for name, mod in ops.KERNEL_WRAPPERS}


def reset_counts():
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    for name in BF16_FORMS:
        fns[name].bf16_launches = 0
    for name in WGMMA_FORMS:
        fns[name].wgmma_launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def read_bf16_counts():
    fns = kernel_fns()
    return {name: fns[name].bf16_launches for name in BF16_FORMS}


def read_wgmma_counts():
    fns = kernel_fns()
    return {name: fns[name].wgmma_launches for name in WGMMA_FORMS}


def wgmma_part(counts, amp):
    """The launches of WGMMA_FORMS that a run of ``counts`` launches makes
    in their wgmma form: all of them on the AMP paths (every flash forward
    of the AMP Transformer has 256 keys and heads of 64, BERT's 128 keys
    and heads of 64; every flash backward heads of 64 and a padding mask
    or none; every CE a D that is a multiple of 8, 512 or 768; every
    conv_moments of ResNet-50's AMP training step and every conv_apply of
    its AMP eval C and O multiples of 64 and Wo <= 56), none in f32."""
    return {name: counts[name] if amp else 0 for name in WGMMA_FORMS}


def bf16_part(counts, amp):
    """The launches of BF16_FORMS that a run of ``counts`` launches makes
    in bf16: all of them under AMP, none in f32."""
    return {name: counts[name] if amp else 0 for name in BF16_FORMS}


def per_run(**counts):
    """Launches of every kernel in one run of a path (0 unless named)."""
    return dict(dict.fromkeys(KERNELS, 0), **counts)


def exe_runs(exe):
    """An executor's runs over its cache entries: ``interpreted`` and
    ``captures`` launch the kernels from Python (into the graph, for a
    capture), a replay launches none from Python."""
    tot = dict.fromkeys(("interpreted", "captures", "replays"), 0)
    for entry in exe._cache.values():
        for k in tot:
            tot[k] += entry.runs[k]
    return tot


def launching_runs(exe):
    runs = exe_runs(exe)
    return runs["interpreted"] + runs["captures"]


def counted_step(exe, program, per_step, amp, label, wgmma=None, **kw):
    """``exe.run(program, **kw)`` with the port's launch counts held: a run
    that interprets or captures the step launches ``per_step`` (under AMP
    all of it in bf16, the WGMMA_FORMS on their wgmma form, or as
    ``wgmma(counts, amp)`` gives), a replay none from Python (its kernels
    are held by name in the profiler, see ``check_replay_kernels``).
    Returns (outputs, seconds, replayed)."""
    wgmma = wgmma or wgmma_part
    replays = exe_runs(exe)["replays"]
    before = read_counts(), read_bf16_counts(), read_wgmma_counts()
    t = time.perf_counter()
    out = exe.run(program, **kw)
    dt = time.perf_counter() - t
    after = read_counts(), read_bf16_counts(), read_wgmma_counts()
    replayed = exe_runs(exe)["replays"] > replays
    want = per_run() if replayed else per_step
    per, per_bf16, per_wgmma = ({k: a[k] - b[k] for k in a}
                                for a, b in zip(after, before))
    check(per == want and per_bf16 == bf16_part(want, amp)
          and per_wgmma == wgmma(want, amp),
          "%s launches %s (bf16 %s, wgmma %s) != %s"
          % (label, per, per_bf16, per_wgmma, want))
    return out, dt, replayed


def check_replay_kernels(phase, interpreted, replayed):
    """Each replayed step launches, kind by kind, the device kernels of the
    port's table that an interpreted step of the same key launched (whose
    wrapper launches are counted exactly): both per step, from the
    profiler."""
    bad = {k: (interpreted.get(k, 0), replayed.get(k, 0)) for k in KERNELS
           if interpreted.get(k, 0) != replayed.get(k, 0)}
    check(not bad, "%s: replayed kernels by kind differ from an "
          "interpreted step's: %s" % (phase, bad))


@contextlib.contextmanager
def mma_sync_route(mod, route):
    """``mod``'s bf16 route function ``route`` (fwd_form, bwd_form,
    apply_form, moments_form, ce_form) sending every call to the mma.sync
    form while the block runs: both forms of a kernel in one call, for
    checks and timings."""
    saved = getattr(mod, route)
    setattr(mod, route, lambda *a, **k: (
        "mma_sync" if route == "ce_form" else ("mma_sync", "forced")))
    try:
        yield
    finally:
        setattr(mod, route, saved)


@contextlib.contextmanager
def plain_flash_bwd():
    """The flash attention Function's backward takes the plain version
    (``attention_bwd_plain``, dq summed by a matrix product, no atomics)
    on the card while the block runs: a Transformer step whose every
    reduction has a fixed order, for ``capture_check``'s bitwise control.
    The stand-in carries the counters ``read_counts`` reads, at 0."""
    from paddle_tpu_torch.ops import flash_attention as fa

    saved = fa.flash_attention_bwd

    def plain(*args, **kwargs):
        return fa.attention_bwd_plain(*args, **kwargs)

    plain.launches = plain.bf16_launches = plain.wgmma_launches = 0
    fa.flash_attention_bwd = plain
    try:
        yield
    finally:
        fa.flash_attention_bwd = saved


def max_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def check_close(phase, case, pairs, tol, **extra):
    """Emit one line per case with each tensor's max abs and relative
    error; fail if any max abs error exceeds tol * max(1, max |want|)."""
    errs, ok = {}, True
    for name, got, want in pairs:
        a, r = max_err(got, want)
        errs[name] = {"max_abs_err": a, "max_rel_err": r}
        ok = ok and a <= tol * max(1.0, want.abs().max().item())
    emit(dict({"phase": phase, "case": case, "errors": errs,
               "tol": "%g * max(1, max|plain|)" % tol}, **extra))
    check(ok, "%s %s: errors %s above tolerance" % (phase, case, errs))
    return max(e["max_abs_err"] for e in errs.values())


def bound(nbytes, flops, flops_s=F32_FLOPS):
    """(least ms, "bytes" or "operations"): nbytes at the HBM rate against
    flops at ``flops_s``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flops_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def bf16_bound(nbytes, flops):
    """The bound of a bf16 form (rows 1-6, 9 under AMP): its flops at the
    bf16 tensor-core rate or its bytes."""
    return bound(nbytes, flops, BF16_FLOPS)


def tensor_core_bound(nbytes, flops):
    """The bound of the conv, flash and fused CE kernels (rows 1-6, 9, 10,
    12): their 3 x flops TF32 tensor-core operations (3xTF32) or their bytes, and
    beside it the bound of the same work on the f32 FMA pipes."""
    bnd, by = bound(nbytes, 3 * flops, TF32_FLOPS)
    return bnd, by, bound(nbytes, flops)[0]


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: " + smi.stderr)
    line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": line,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_lib = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": per_lib, "nvcc": _build.nvcc_path()})
    _sass_check(_build)


# library, kernel template, instantiations it has: the kernels whose
# products must run on the tensor cores
SASS_KERNELS = (("fused_conv", "conv_kernel", 2),
                ("flash_attention_fwd", "flash_fwd_kernel", 36),
                ("flash_attention_bwd", "flash_bwd_kernel", 24),
                ("fused_ce_fwd", "fused_ce_kernel", 8))
# library, kernel template, bf16 instantiations, and whether each must load
# its fragments by ldmatrix (LDSM): each must run its products as bf16
# m16n8k16 HMMAs with f32 accumulators
SASS_BF16 = (("flash_attention_fwd", "flash_fwd_kernel", 18, False),
             ("flash_attention_bwd", "flash_bwd_kernel", 12, False),
             ("fused_ce_fwd", "fused_ce_kernel", 4, False),
             ("fused_conv", "conv_kernel", 8, True))
BF16_HMMA = "HMMA.16816.F32.BF16"
# library, kernel stem, instantiations: the warpgroup-product forms of the
# bf16 flash forward and backward (head-dim widths 64 and 128), fused CE,
# conv_apply and conv_moments (one or two consumer warpgroups, x read in
# NCHW or from its channels-last copy). Each must
# run its products as bf16 HGMMAs (wgmma) and hold no HMMA.16816 of its
# own: an mma.sync left in the hot loop would hide behind a passing count
SASS_WGMMA = (("flash_attention_fwd", "flash_fwd_wgmma_kernel", 2),
              ("flash_attention_bwd", "flash_bwd_wgmma_kernel", 2),
              ("fused_ce_fwd", "fused_ce_wgmma_kernel", 1),
              ("fused_conv_wgmma", "conv_apply_wgmma_kernel", 4),
              ("fused_conv_wgmma", "conv_moments_wgmma_kernel", 4))


# library, the mangled stem of the instantiations that move 16 bytes a
# lane, how many there are, the kind of instruction and the mark of its
# 128-bit form each must hold: the scatter's float4 reduction (VEC 4;
# REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU on sm_90a), the LayerNorm forward's
# 16-byte loads (f32 and bf16, every VPL; LDG.E.128.CONSTANT) and the bf16
# LayerNorm backward's register-resident form's 16-byte loads of x and dy
# and stores of dx (every VPL)
SASS_WIDE = (("scatter_add", "scatter_add_kernelILi4E", 1, "RED", "F32x4"),
             ("layer_norm_fwd", "layer_norm_fwd_kernelIfLb1E", 7, "LDG",
              ".128"),
             ("layer_norm_fwd", "layer_norm_fwd_kernelI13__nv_bfloat16Lb1E",
              7, "LDG", ".128"),
             ("layer_norm_bwd", "layer_norm_bwd_regs", 4, "LDG", ".128"),
             ("layer_norm_bwd", "layer_norm_bwd_regs", 4, "STG", ".128"))


def _sass_functions(_build, lib):
    """{mangled kernel name: [mnemonics]} from cuobjdump's SASS of ``lib``."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build._lib_path(lib)],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, "cuobjdump failed: " + sass.stderr[-2000:])
    fns = {}
    for fn in sass.stdout.split("Function : ")[1:]:
        ops = []
        for ln in fn.splitlines()[1:]:
            tok = ln.split()
            if len(tok) > 1 and tok[0].startswith("/*"):
                ops.append(tok[2] if tok[1].startswith("@") and len(tok) > 2
                           else tok[1])
        fns[fn.split(None, 1)[0]] = ops
    return fns


def _sass_check(_build):
    """Every instantiation of the conv kernel (conv_moments' and
    conv_apply's), of the flash forward and backward kernels (every
    head-dim width, f32 and bf16, padding-mask and per-query bias) and of
    the fused CE kernel (16- or 4-byte copies of x and of W) must carry its
    products on the tensor cores: cuobjdump's SASS of each built library
    shows HMMA instructions in each. Every float4 instantiation of the
    scatter kernel must hold a 128-bit reduction, and every 16-byte
    instantiation of the LayerNorm forward a 128-bit global load, and
    every register-resident instantiation of the bf16 LayerNorm backward
    128-bit global loads and stores (``SASS_WIDE``); the mnemonics found
    are printed. Every bf16
    instantiation of the flash kernels, of the fused CE kernel and of the
    conv kernel must hold ``HMMA.16816.F32.BF16``, the conv kernel's also
    ``LDSM`` (ldmatrix) (``SASS_BF16``); the warpgroup-product forms of the
    flash forward and backward, the fused CE, conv_apply and conv_moments
    must hold bf16 ``HGMMA`` and no ``HMMA.16816`` (``SASS_WGMMA``)."""
    for lib, kernel, n_inst in SASS_KERNELS:
        hmma = {name: sum(op.startswith("HMMA") for op in ops)
                for name, ops in _sass_functions(_build, lib).items()
                if kernel in name}
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "instantiations": len(hmma), "hmma_per_instantiation": hmma})
        check(len(hmma) >= n_inst and all(hmma.values()),
              "%s instantiations without HMMA: %s" % (kernel, hmma))
    for lib, kernel, n_inst, ldsm in SASS_BF16:
        fns = {name: ops for name, ops in _sass_functions(_build, lib).items()
               if kernel in name and "__nv_bfloat16" in name}
        bf16 = {name: sum(op.startswith(BF16_HMMA) for op in ops)
                for name, ops in fns.items()}
        ldsms = {name: sum(op.startswith("LDSM") for op in ops)
                 for name, ops in fns.items()}
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "dtype": "bf16", "instantiations": len(bf16),
              "mnemonic": BF16_HMMA, "count_per_instantiation": bf16,
              "ldsm_per_instantiation": ldsms})
        check(len(bf16) == n_inst and all(bf16.values()),
              "%s bf16 instantiations without %s: %s"
              % (kernel, BF16_HMMA, bf16))
        check(not ldsm or all(ldsms.values()),
              "%s bf16 instantiations without LDSM: %s" % (kernel, ldsms))
    for lib, kernel, n_inst in SASS_WGMMA:
        fns = {name: ops for name, ops in _sass_functions(_build, lib).items()
               if kernel in name}
        hgmma = {name: sum(op.startswith("HGMMA") and ".BF16" in op
                           for op in ops) for name, ops in fns.items()}
        hmma = {name: sum(op.startswith("HMMA.16816") for op in ops)
                for name, ops in fns.items()}
        emit({"phase": "sass", "library": lib, "kernel": kernel,
              "dtype": "bf16", "instantiations": len(fns),
              "hgmma_bf16_per_instantiation": hgmma,
              "hmma_16816_per_instantiation": hmma})
        check(len(fns) == n_inst and all(hgmma.values())
              and not any(hmma.values()),
              "%s instantiations without bf16 HGMMA or with HMMA.16816: "
              "%s, %s" % (kernel, hgmma, hmma))
    for lib, stem, n_inst, kind, wide in SASS_WIDE:
        fns = _sass_functions(_build, lib)
        found = {name: sorted({op for op in ops if op.startswith(kind)})
                 for name, ops in fns.items() if stem in name}
        others = sorted({op for name, ops in fns.items() if stem not in name
                         for op in ops if op.startswith(kind)})
        emit({"phase": "sass", "library": lib, "kernel": stem,
              "instantiations": len(found), kind.lower(): found,
              "other_instantiations": others})
        check(len(found) == n_inst and all(
            any(wide in op for op in ops) for ops in found.values()),
            "%s instantiations without a 128-bit %s: %s"
            % (stem, kind, found))


def _padding_bias(torch, gen, b, tk, dev):
    lengths = torch.randint(1, tk + 1, (b,), generator=gen)
    return torch.where(torch.arange(tk)[None] < lengths[:, None], 0.0,
                       -1e9).to(dev)


def _rich_bias(torch, gen, b, h, tq, tk, dev):
    """A bias with one offset per (b, h, t, j), as relative positions give:
    the kernels read it by strides."""
    return torch.randn(b, h, tq, tk, generator=gen).to(dev)


def phase_flash_check(torch, dev, lse_tol=1e-4):
    """Kernel vs plain version at the served shape and the causal cases.
    bf16: the plain version runs in f32 on the same bf16 inputs. lse is f32
    in every form (f32 sums of the same products) and is held to
    ``lse_tol`` absolute in each."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED)
    b, t, h = 8, BERT["seq"], BERT["heads"]
    d = BERT["d_model"] // h
    cases = [
        # name, B, Tq, Tk, H, D, causal, bias (None, "key" padding mask,
        # "full" one offset per logit), dtype, tolerance
        ("bert_f32", b, t, t, h, d, False, "key", torch.float32, 1e-4),
        ("bert_bf16", b, t, t, h, d, False, "key", torch.bfloat16, 2e-2),
        ("causal_square", 2, 128, 128, 4, 64, True, None, torch.float32,
         1e-4),
        ("causal_tq_lt_tk", 2, 64, 128, 4, 64, True, None, torch.float32,
         1e-4),
        ("causal_tq_gt_tk", 2, 128, 64, 4, 64, True, None, torch.float32,
         1e-4),
        # head dims 16 (width 16) and 512 (the columns split over 4 warps)
        ("d16_causal_129", 2, 129, 129, 4, 16, True, None, torch.float32,
         1e-4),
        ("d16_bf16", 2, 65, 65, 4, 16, False, "key", torch.bfloat16, 2e-2),
        ("d512_padded", 2, 65, 100, 2, 512, False, "key", torch.float32,
         1e-4),
        ("d512_bf16_causal", 1, 96, 96, 1, 512, True, None, torch.bfloat16,
         2e-2),
        # a rich bias, and head dim 12 (padded to 16 by the wrapper)
        ("d12_full_bias_causal", 2, 65, 100, 3, 12, True, "full",
         torch.float32, 1e-4),
        ("d64_full_bias_bf16", 2, 128, 128, 4, 64, False, "full",
         torch.bfloat16, 2e-2),
        # the decode tier's draft pass: GPT-2 small's heads over the
        # draft's 16 positions at the top batch rung
        ("draft_causal_16", 8, DRAFT_SEQ, DRAFT_SEQ, GPT2["n_head"],
         GPT2["d_model"] // GPT2["n_head"], True, None, torch.float32,
         1e-4),
    ]
    errs = {}
    for name, b_, tq, tk, h_, d_, causal, bias_kind, dtype, tol in cases:
        q, k, v = (torch.randn(b_, n, h_ * d_, generator=gen).to(dev, dtype)
                   for n in (tq, tk, tk))
        bias = None
        if bias_kind == "key":
            bias = _padding_bias(torch, gen, b_, tk, dev)[:, None, None, :]
        elif bias_kind == "full":
            bias = _rich_bias(torch, gen, b_, h_, tq, tk, dev)
        out, lse = fa.flash_attention_fwd(q, k, v, h_, bias, causal)
        want, want_lse = fa.attention_plain(q.float(), k.float(), v.float(),
                                            h_, bias, causal)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        live = want_lse > -1e30  # rows that see at least one key
        lse_err = (lse - want_lse)[live].abs().max().item()
        check(torch.equal(lse <= -1e30, ~live), name + ": masked rows differ")
        emit({"phase": "flash_attention_fwd", "case": name,
              "shape": [b_, tq, tk, h_, d_], "causal": causal,
              "bias": bias_kind, "dtype": str(dtype), "max_abs_err": err,
              "lse_err": lse_err, "tol": tol, "lse_tol": lse_tol})
        check(err <= tol and lse_err <= lse_tol,
              "flash %s error %g (lse %g) > %g" % (name, err, lse_err, tol))
        errs[name] = err
    # bf16 (AMP) at the training shape, the encoder's call: key padding
    # bias and dropout 0.1, against the plain version on the same bf16
    # inputs and seed, which rounds the same normalised weights: 2^-7 *
    # max(1, max|plain|) for out (a sum in another order may round the
    # other way), lse_tol for lse
    b, t, h = TRAIN_BATCH, TRANSFORMER["seq_len"], TRANSFORMER["n_head"]
    d = TRANSFORMER["d_model"] // h
    q, k, v = (torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    bias = _padding_bias(torch, gen, b, t, dev)
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, h, bias, False, 0.1, seed)
    want, want_lse = fa.attention_plain(q, k, v, h, bias, False, 0.1, seed)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    errs["train_bf16_dropout_0.1"] = check_close(
        "flash_attention_fwd", "train_bf16_dropout_0.1",
        [("out", out, want)], 2.0 ** -7, shape=[b, t, t, h, d], bias="key",
        dropout=0.1, dtype="bf16", lse_err=lse_err, lse_tol=lse_tol)
    check(lse_err <= lse_tol, "flash train_bf16_dropout_0.1: lse error %g"
          % lse_err)
    return errs


# the LayerNorm forward's timed shapes, (rows, D): BERT-base served at the
# top batch rung (8 x 128 tokens), and Transformer-base trained (32
# launches a step)
LN_SERVED = (8 * BERT["seq"], BERT["d_model"])
LN_TRAINED = (TRAIN_BATCH * TRANSFORMER["seq_len"], TRANSFORMER["d_model"])
# (rows, D, gamma and beta, x 16-byte aligned): the two timed shapes, a
# ragged count at the served width, then every instantiation family of
# the kernel (ops/fused_layer_norm.py ln_fwd_plan): register-resident
# 16-byte at 512 and 1000, single-element at 1, 3 and 37, looped at 4096
# and 5000, single-element and looped from an unaligned x
LN_CASES = [LN_SERVED + (True, True), LN_TRAINED + (True, True),
            (1000, 768, True, True),
            (1000, 512, True, True), (1000, 512, False, True),
            (1000, 1, True, True), (1000, 3, True, True),
            (1000, 37, False, True), (1000, 1000, True, True),
            (1000, 4096, True, True), (1000, 5000, True, True),
            (1000, 768, True, False)]


def _ln_f64(x, g, b, eps):
    """LayerNorm over the last axis in float64 (the yardstick of the f32
    check)."""
    x = x.double()
    xc = x - x.mean(dim=-1, keepdim=True)
    y = xc / (((xc * xc).mean(dim=-1, keepdim=True) + eps) ** 0.5)
    if g is not None:
        y = y * g.double()
    if b is not None:
        y = y + b.double()
    return y


def phase_ln_check(torch, dev):
    """Kernel vs plain version (in f32 on the same inputs), f32 and bf16,
    at each of ``LN_CASES``. f32: y against an f64 LayerNorm of the same
    inputs, within 1e-5 absolute or, where the plain version's own
    rounding is larger (a row whose mean is large against its spread),
    within the plain version's error against f64; the distance to the
    plain version is printed beside. bf16: y within one bf16 ulp of the
    plain version (2^-8 relative to |y|, at least 2^-8 absolute), since the
    kernel rounds y once to bf16. Mean and var are f32 in both: 1e-4
    absolute. Fails unless the plans ``_ln_fwd_timing`` times (f32, at
    ``LN_SERVED`` and ``LN_TRAINED``) are among those checked."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, checked = {}, set()
    for rows, d, affine, aligned in LN_CASES:
        g = torch.randn(d, generator=gen).to(dev) if affine else None
        bb = torch.randn(d, generator=gen).to(dev) if affine else None
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows * d + 1, generator=gen) * 2 + 0.5).to(
                dev, dtype)
            x = (x[:-1] if aligned else x[1:]).view(rows, d)
            y, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
            wy, wm, wv = fln.layer_norm_plain(x.float(), g, bb, 1e-5)
            torch.cuda.synchronize()
            dy = (y.float() - wy).abs()
            f64 = {}
            if dtype == torch.float32:
                exact = _ln_f64(x, g, bb, 1e-5)
                f64 = {"kernel": (y.double() - exact).abs().max().item(),
                       "plain": (wy.double() - exact).abs().max().item()}
                y_ok = f64["kernel"] <= max(1e-5, f64["plain"])
                del exact
            else:
                y_ok = bool((dy <= 2.0 ** -8 * wy.abs().clamp_min(1.0)).all())
            e = (dy.max().item(), (mean - wm).abs().max().item(),
                 (var - wv).abs().max().item())
            name = "%dx%d_%s%s%s" % (rows, d, str(dtype).split(".")[1],
                                     "" if affine else "_noaffine",
                                     "" if aligned else "_unaligned")
            plan = fln.ln_fwd_plan(rows, d, dtype, sms, aligned)
            checked.add((rows, d, dtype, plan))
            emit({"phase": "layer_norm_fwd", "case": name,
                  "plan": list(plan),
                  "max_abs_err_y": e[0], "max_abs_err_mean": e[1],
                  "max_abs_err_var": e[2], "y_within_tol": y_ok,
                  "max_abs_err_y_vs_f64": f64 or None,
                  "tol_y": "against f64: kernel <= max(1e-5, plain)"
                  if dtype == torch.float32 else "2^-8 rel",
                  "tol_stats": 1e-4})
            check(y_ok and e[1] <= 1e-4 and e[2] <= 1e-4,
                  "layer_norm %s errors %s" % (name, e))
            errs[name] = max(e)
            del x, y, mean, var, wy, wm, wv, dy
    for rows, d in (LN_SERVED, LN_TRAINED):
        timed = fln.ln_fwd_plan(rows, d, torch.float32, sms)
        check((rows, d, torch.float32, timed) in checked,
              "layer_norm %dx%d: the timed plan %s is not checked"
              % (rows, d, list(timed)))
    return errs


def phase_flash_bwd_check(torch, dev):
    """The flash kernels through their autograd Function (forward with
    dropout, backward) against autograd of the plain version on the same
    inputs and the same dropout seed, f32, TF32 off: first at the training
    path's own shape and configurations (B=128, T=Tk=256, H=8, D=64; the
    encoder self, decoder self and cross calls with dropout 0.1, and
    without dropout with the key bias requiring grad), then at ragged
    extras. dq is summed across key tiles with atomics, in no fixed order;
    tolerance 2e-4 * max(1, max|plain|) on out, dq, dk, dv and dbias."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED)
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    h = TRANSFORMER["n_head"]
    d = TRANSFORMER["d_model"] // h
    cases = [
        # name, B, Tq, Tk, H, D, causal, bias ("key", "key1" broadcast
        # over B, "full" one offset per logit, "+grad": it requires grad),
        # dropout rate
        ("enc_self_bias_grad", b, t, t, h, d, False, "key+grad", 0.0),
        ("dec_self_causal", b, t, t, h, d, True, None, 0.0),
        ("enc_self_dropout_0.1", b, t, t, h, d, False, "key+grad", 0.1),
        ("dec_self_causal_dropout_0.1", b, t, t, h, d, True, None, 0.1),
        ("dec_cross_dropout_0.1", b, t, t, h, d, False, "key", 0.1),
        ("causal_tq_lt_tk", 2, 64, 128, 4, 64, True, None, 0.0),
        ("causal_tq_gt_tk", 2, 128, 64, 4, 64, True, "key", 0.0),
        ("ragged_100x77_d32", 3, 100, 77, 2, 32, False, "key1+grad", 0.0),
        ("causal_d128_dropout_0.1", 2, 96, 96, 2, 128, True, "key", 0.1),
        ("d16_causal_tq_gt_tk", 2, 129, 64, 4, 16, True, None, 0.0),
        ("d16_bias_grad_dropout_0.1", 2, 65, 65, 4, 16, False, "key+grad",
         0.1),
        ("d512_bias_grad", 1, 70, 129, 2, 512, False, "key+grad", 0.0),
        ("d512_causal_dropout_0.1", 1, 96, 96, 1, 512, True, None, 0.1),
        ("d12_full_bias_grad_dropout_0.1", 2, 65, 100, 3, 12, False,
         "full+grad", 0.1),
        ("causal_full_bias_grad", 4, 256, 256, 8, 64, True, "full+grad",
         0.0),
    ]
    errs = {}
    for i, (name, b_, tq, tk, h_, d_, causal, bias_kind, rate) in \
            enumerate(cases):
        q, k, v, dout = (torch.randn(b_, n, h_ * d_, generator=gen).to(dev)
                         for n in (tq, tk, tk, tq))
        kb = None
        if bias_kind is not None and bias_kind.startswith("full"):
            kb = _rich_bias(torch, gen, b_, h_, tq, tk, dev)
        elif bias_kind is not None:
            kb = _padding_bias(torch, gen, b_, tk, dev)
            if bias_kind.startswith("key1"):
                kb = kb[:1]
        bias_grad = bias_kind is not None and bias_kind.endswith("+grad")
        seed = (torch.tensor([1000 + i], dtype=torch.int64, device=dev)
                if rate > 0 else None)
        inputs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kbk = kb.clone().requires_grad_(bias_grad) if kb is not None \
            else None
        out = fa._FlashAttention.apply(*inputs, kbk, seed, h_, causal, rate)
        wrt = inputs + ([kbk] if bias_grad else [])
        grads = torch.autograd.grad(out, wrt, dout)
        plain_in = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kbp = kb.clone().requires_grad_(bias_grad) if kb is not None \
            else None
        want, _ = fa.attention_plain(*plain_in, h_, kbp, causal, rate, seed)
        pwrt = plain_in + ([kbp] if bias_grad else [])
        want_grads = torch.autograd.grad(want, pwrt, dout)
        torch.cuda.synchronize()
        pairs = [("out", out, want)] + list(zip(
            ("dq", "dk", "dv", "dbias"), grads, want_grads))
        errs[name] = check_close(
            "flash_attention_bwd", name, pairs, 2e-4,
            shape=[b_, tq, tk, h_, d_], causal=causal, bias=bias_kind,
            dropout=rate)
        del out, grads, want, want_grads, plain_in, inputs
    errs.update(_flash_bf16_check(torch, dev, gen))
    _flash_f64_check(torch, dev)
    _flash_bwd_repeat(torch, dev)
    return errs


def _flash_bwd_repeat(torch, dev, runs=50):
    """The bf16 wgmma flash backward at the training shape (padding mask,
    dropout 0.1, dbias), ``runs`` times against its first run: dk, dv and
    dbias bitwise equal every time (each is summed by one block in a fixed
    order); dq, summed over the Tk / 64 key blocks by f32 atomics in no
    fixed order and rounded to bf16 once, within one bf16 ulp of the
    larger value plus 2 (n - 1) 2^-24 of the element's sum of |terms|
    (scale * sum_j |dS_ij| |K_j|, dS from the plain backward). Prints how
    often and how far dq moved."""
    import paddle_tpu_torch.ops.flash_attention as tfa

    gen = torch.Generator().manual_seed(SEED)
    b, t, h, d = 8, 256, 8, 64
    q, k, v, dout = (torch.randn(b, t, h * d, generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    bias = _padding_bias(torch, gen, b, t, dev)
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    out, lse = tfa.flash_attention_fwd(q, k, v, h, bias, False, 0.1, seed)
    split = [tfa._split(x, h) for x in (q, k, v, out)]
    ds = tfa.mha_bwd_plain(*split, lse, tfa._split(dout, h),
                           tfa._plain_bias(bias), False, dropout_rate=0.1,
                           seed=seed)[3]
    terms = (torch.matmul(ds.to(torch.bfloat16).float().abs(),
                          split[1].float().abs()) / d ** 0.5
             ).transpose(1, 2).reshape(b, t, h * d)
    n0 = tfa.flash_attention_bwd.wgmma_launches
    first = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, bias, False,
                                    0.1, seed, want_dbias=True)
    dq0 = first[0].float()
    differ = moved = most = 0
    worst, ratio = 0.0, 0.0
    for _ in range(runs - 1):
        got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, bias,
                                      False, 0.1, seed, want_dbias=True)
        differ += not all(torch.equal(g, f) for g, f in zip(got[1:],
                                                            first[1:]))
        diff = (got[0].float() - dq0).abs()
        bound = (2 ** -7 * torch.maximum(got[0].float().abs(), dq0.abs())
                 + 2 * (-(-t // 64) - 1) * 2 ** -24 * terms)
        n = int((diff > 0).sum())
        moved += n > 0
        most = max(most, n)
        worst = max(worst, float(diff.max()))
        over = torch.where(bound > 0, diff / bound.clamp_min(1e-30),
                           torch.where(diff > 0, float("inf"), 0.0))
        ratio = max(ratio, float(over.max()))
    torch.cuda.synchronize()
    emit({"phase": "flash_bwd_repeat", "shape": [b, t, h, d], "runs": runs,
          "form": "wgmma",
          "wgmma_launches": tfa.flash_attention_bwd.wgmma_launches - n0,
          "dk_dv_dbias_runs_differing": differ,
          "dq_runs_differing": moved, "dq_elements_differing_max": most,
          "dq_max_abs_diff": worst, "dq_max_diff_over_bound": ratio})
    check(differ == 0 and ratio <= 1.0
          and tfa.flash_attention_bwd.wgmma_launches - n0 == runs,
          "flash_bwd_repeat: dk/dv/dbias differed in %d runs, dq at %g of "
          "its bound" % (differ, ratio))


# the flash kernels' bf16 (AMP) cases: name, B, Tq, Tk, H, D, causal, bias,
# dropout, the forward's form, the backward's form: the training path's
# three calls, then every width family, then the wgmma forms' route
# boundaries (Tk 16, 255, 256, 257, 512; causal Tq < Tk, and Tq > Tk with
# rows that see no key; D 16, 64, 128, 136; padding and rich bias; dropout
# on and off)
FLASH_BF16_CASES = [
    ("enc_self_bf16_dropout_0.1", TRAIN_BATCH, 256, 256, 8, 64, False,
     "key+grad", 0.1, "wgmma", "wgmma"),
    ("dec_self_causal_bf16_dropout_0.1", TRAIN_BATCH, 256, 256, 8, 64, True,
     None, 0.1, "wgmma", "wgmma"),
    ("dec_cross_bf16_dropout_0.1", TRAIN_BATCH, 256, 256, 8, 64, False, "key",
     0.1, "wgmma", "wgmma"),
    ("d16_causal_tq_gt_tk_bf16", 2, 129, 64, 4, 16, True, None, 0.0,
     "wgmma", "wgmma"),
    ("d128_bf16_dropout_0.1", 2, 96, 96, 2, 128, True, "key", 0.1, "wgmma",
     "wgmma"),
    ("d512_bias_grad_bf16", 1, 70, 129, 2, 512, False, "key+grad", 0.0,
     "mma_sync", "mma_sync"),
    ("d12_full_bias_grad_bf16", 2, 65, 100, 3, 12, False, "full+grad", 0.1,
     "mma_sync", "mma_sync"),
    ("tk16_bf16", 2, 100, 16, 4, 64, False, "key", 0.0, "wgmma", "wgmma"),
    ("tk255_bf16_dropout_0.1", 2, 100, 255, 4, 64, False, "key", 0.1,
     "wgmma", "wgmma"),
    ("tk257_bf16_dropout_0.1", 2, 100, 257, 4, 64, False, "key", 0.1,
     "mma_sync", "wgmma"),
    ("causal_tq_lt_tk256_bf16", 2, 64, 256, 4, 64, True, None, 0.0,
     "wgmma", "wgmma"),
    ("d16_tk256_bias_grad_bf16", 2, 100, 256, 4, 16, False, "key+grad", 0.0,
     "wgmma", "wgmma"),
    ("d128_tk256_causal_bf16_dropout_0.1", 2, 256, 256, 2, 128, True, None,
     0.1, "wgmma", "wgmma"),
    ("d136_tk256_bf16", 2, 100, 256, 2, 136, False, "key", 0.0, "mma_sync",
     "mma_sync"),
    ("tk512_bias_grad_bf16_dropout_0.1", 2, 100, 512, 4, 64, False,
     "key+grad", 0.1, "mma_sync", "wgmma"),
    ("d64_causal_tq_gt_tk_bf16_dropout_0.1", 2, 300, 100, 2, 64, True, None,
     0.1, "wgmma", "wgmma"),
    ("d128_tk512_causal_tq_lt_tk_bf16", 2, 200, 512, 2, 128, True, "key",
     0.0, "mma_sync", "wgmma"),
    ("d64_full_bias_grad_bf16", 2, 100, 256, 2, 64, False, "full+grad", 0.0,
     "mma_sync", "mma_sync"),
]


def _flash_bf16_check(torch, dev, gen):
    """The bf16 forms (AMP) against the plain versions on the same bf16
    inputs and seed: the forward kernel against ``attention_plain``, the
    backward kernel against ``attention_bwd_plain`` from the kernel
    forward's out and lse. out, dq, dk and dv within 2^-7 * max(1,
    max|plain|) (one bf16 step either way: the products sum in f32 in
    other orders and may round the other way), the f32 dbias within 1e-4
    * max(1, max|plain|), the forward's lse within 1e-4 where a row sees
    a key. Each case's forward and backward must run the forms it names
    (``wgmma_launches``). Returns the cases' largest errors."""
    from paddle_tpu_torch.ops import flash_attention as fa

    errs = {}
    for i, (name, b_, tq, tk, h_, d_, causal, bias_kind, rate, form,
            bwd) in enumerate(FLASH_BF16_CASES):
        q, k, v, dout = (torch.randn(b_, n, h_ * d_, generator=gen).to(
            dev, torch.bfloat16) for n in (tq, tk, tk, tq))
        kb = None
        if bias_kind is not None and bias_kind.startswith("full"):
            kb = _rich_bias(torch, gen, b_, h_, tq, tk, dev)
        elif bias_kind is not None:
            kb = _padding_bias(torch, gen, b_, tk, dev)
        want_db = bias_kind is not None and bias_kind.endswith("+grad")
        seed = (torch.tensor([2000 + i], dtype=torch.int64, device=dev)
                if rate > 0 else None)
        n_wgmma = fa.flash_attention_fwd.wgmma_launches
        out, lse = fa.flash_attention_fwd(q, k, v, h_, kb, causal, rate, seed)
        ran = ("wgmma" if fa.flash_attention_fwd.wgmma_launches > n_wgmma
               else "mma_sync")
        check(ran == form, "flash bf16 %s ran the %s form, not %s"
              % (name, ran, form))
        want, want_lse = fa.attention_plain(q, k, v, h_, kb, causal, rate,
                                            seed)
        n_wgmma = fa.flash_attention_bwd.wgmma_launches
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, h_, kb, causal,
                                     rate, seed, want_dbias=want_db)
        ran_bwd = ("wgmma" if fa.flash_attention_bwd.wgmma_launches > n_wgmma
                   else "mma_sync")
        check(ran_bwd == bwd, "flash bf16 %s: the backward ran the %s form, "
              "not %s" % (name, ran_bwd, bwd))
        ref = fa.attention_bwd_plain(q, k, v, out, lse, dout, h_, kb, causal,
                                     rate, seed, want_dbias=want_db)
        torch.cuda.synchronize()
        check(all(x.dtype == torch.bfloat16 for x in (out,) + got[:3]),
              "flash bf16 %s: dtypes %s" % (name, [x.dtype
                                                   for x in got[:3]]))
        pairs = [("out", out, want)] + list(zip(("dq", "dk", "dv"), got[:3],
                                                ref[:3]))
        live = want_lse > -1e30
        lse_err = (lse - want_lse)[live].abs().max().item()
        errs[name] = check_close(
            "flash_attention_bwd", name, pairs, 2.0 ** -7,
            shape=[b_, tq, tk, h_, d_], causal=causal, bias=bias_kind,
            dropout=rate, dtype="bf16", forward_form=ran,
            backward_form=ran_bwd, lse_err=lse_err)
        check(lse_err <= 1e-4 and torch.equal(lse <= -1e30, ~live),
              "flash bf16 %s: lse error %g" % (name, lse_err))
        if want_db:
            check_close("flash_attention_bwd", name + "_dbias",
                        [("dbias", got[3], ref[3])], 1e-4, dtype="f32")
        del q, k, v, dout, out, lse, want, want_lse, got, ref
    return errs


def _flash_f64_check(torch, dev):
    """At the training shape (the encoder self-attention call, key
    padding bias) the kernels' out, dq, dk and dv and the plain version's
    f32 ones (cuBLAS, TF32 off) against the plain version in f64 on the
    same f32 inputs, by max abs and relative L2 error; fails if the
    kernels' error is more than twice the plain f32 one in either (a
    single TF32 pass would be about 1000 times off). Then the bf16 forms
    (the backward's wgmma form) on the same inputs rounded to bf16,
    against f64 on those: the kernels' errors at most 1.5 times the plain
    bf16 version's."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 2)
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    h = TRANSFORMER["n_head"]
    d = TRANSFORMER["d_model"] // h
    q, k, v, dout = (torch.randn(b, t, h * d, generator=gen).to(dev)
                     for _ in range(4))
    kb = _padding_bias(torch, gen, b, t, dev)

    def run(fn, dtype):
        ins = [x.to(dtype).clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(ins, kb.to(dtype))
        return [out.detach()] + list(torch.autograd.grad(
            out, ins, dout.to(dtype)))

    def plain(ins, bias):
        return fa.attention_plain(*ins, h, bias)[0]

    exact = run(plain, torch.float64)
    ref = run(plain, torch.float32)
    got = run(lambda ins, bias: fa._FlashAttention.apply(
        *ins, bias, None, h, False, 0.0), torch.float32)
    torch.cuda.synchronize()

    def errs(x, want):
        dd = x.double() - want
        return {"max_abs_err": dd.abs().max().item(),
                "rel_l2": (dd.norm() / want.norm()).item()}

    names = ("out", "dq", "dk", "dv")
    kernel = {n: errs(g, e) for n, g, e in zip(names, got, exact)}
    plain_f32 = {n: errs(r, e) for n, r, e in zip(names, ref, exact)}
    emit({"phase": "flash_attention_f64", "shape": [b, t, t, h, d],
          "bias": "key", "kernel": kernel, "plain_f32": plain_f32,
          "ratio": {n: {e: kernel[n][e] / plain_f32[n][e]
                        for e in kernel[n]} for n in names},
          "tol": "kernel <= 2 x plain f32, each error"})
    check(all(kernel[n][e] <= 2 * plain_f32[n][e] for n in names
              for e in kernel[n]),
          "flash errors against f64 %s, plain f32 %s" % (kernel, plain_f32))

    # bf16 (AMP): the same call on the inputs rounded to bf16, the bf16
    # kernels and the plain bf16 version against f64 on those inputs
    qb, kbf, vb, db = (x.to(torch.bfloat16) for x in (q, k, v, dout))
    ins = [x.double().requires_grad_(True) for x in (qb, kbf, vb)]
    o64 = fa.attention_plain(*ins, h, kb.double())[0]
    exact = [o64.detach()] + list(torch.autograd.grad(o64, ins,
                                                      db.double()))
    runs = []
    n_wgmma = fa.flash_attention_bwd.wgmma_launches
    for fwd, bwd in ((fa.attention_plain, fa.attention_bwd_plain),
                     (fa.flash_attention_fwd, fa.flash_attention_bwd)):
        o, lse = fwd(qb, kbf, vb, h, kb)
        runs.append([o] + list(bwd(qb, kbf, vb, o, lse, db, h, kb)[:3]))
    torch.cuda.synchronize()
    check(fa.flash_attention_bwd.wgmma_launches == n_wgmma + 1,
          "flash bf16 f64: the backward did not run its wgmma form")
    plain_bf = {n: errs(r, e) for n, r, e in zip(names, runs[0], exact)}
    kernel = {n: errs(g, e) for n, g, e in zip(names, runs[1], exact)}
    emit({"phase": "flash_attention_f64", "shape": [b, t, t, h, d],
          "bias": "key", "dtype": "bf16", "kernel": kernel,
          "plain_bf16": plain_bf,
          "ratio": {n: {e: kernel[n][e] / plain_bf[n][e]
                        for e in kernel[n]} for n in names},
          "tol": "kernel <= 1.5 x plain bf16, each error"})
    check(all(kernel[n][e] <= 1.5 * plain_bf[n][e] for n in names
              for e in kernel[n]),
          "flash bf16 errors against f64 %s, plain bf16 %s"
          % (kernel, plain_bf))


def phase_ln_bwd_check(torch, dev):
    """The LayerNorm kernels through their autograd Function against
    autograd of the plain version, f32: dx, dgamma, dbeta within 1e-4 *
    max(1, max|plain|) (dgamma/dbeta sum all rows, in another order); then
    bf16, one case per form of the backward's plan."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED)
    rows = TRAIN_BATCH * TRANSFORMER["seq_len"]
    cases = [("train_%dx512" % rows, rows, 512, (True, True)),
             ("ragged_1000x768_gamma", 1000, 768, (True, False)),
             ("rows3x512_no_affine", 3, 512, (False, False))]
    errs = {}
    for name, n, d, affine in cases:
        x = (torch.randn(n, d, generator=gen) * 2 + 0.5).to(dev)
        dy = torch.randn(n, d, generator=gen).to(dev)
        g = torch.randn(d, generator=gen).to(dev) if affine[0] else None
        bb = torch.randn(d, generator=gen).to(dev) if affine[1] else None
        outs = []
        for via_kernel in (True, False):
            xs = x.clone().requires_grad_(True)
            gs = g.clone().requires_grad_(True) if g is not None else None
            bs = bb.clone().requires_grad_(True) if bb is not None else None
            if via_kernel:
                y = fln._FusedLN.apply(xs, gs, bs, 1e-5)[0]
            else:
                y = fln.layer_norm_plain(xs, gs, bs, 1e-5)[0]
            wrt = [t for t in (xs, gs, bs) if t is not None]
            outs.append(torch.autograd.grad(y, wrt, dy))
        torch.cuda.synchronize()
        names = ["dx"] + (["dgamma"] if g is not None else []) + (
            ["dbeta"] if bb is not None else [])
        errs[name] = check_close("layer_norm_bwd", name,
                                 list(zip(names, outs[0], outs[1])), 1e-4,
                                 shape=[n, d])
    # bf16 (AMP) x and dy with f32 gamma and beta: dx is bf16, rounded once
    # from f32 by both (2^-8 * max(1, max|plain|)); dgamma, dbeta f32
    # (1e-4); two kernel runs bitwise equal. One case per form of
    # ln_bwd_plan: the row in registers at 2, 3 and 4 vectors a lane (D =
    # 1000: 125 of 128 vectors), the looped form on 16-byte vectors (D =
    # 2048, wider than 4 a lane) and on single elements (D = 77).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n, d, vec, vpl in (
            ("train_%dx512_bf16" % rows, rows, 512, 8, 2),
            ("ragged_1000x768_bf16", 1000, 768, 8, 3),
            ("ragged_1000x1000_bf16", 1000, 1000, 8, 4),
            ("looped_1000x2048_bf16", 1000, 2048, 8, 0),
            ("ragged_1000x77_bf16", 1000, 77, 1, 0)):
        plan = fln.ln_bwd_plan(n, d, torch.bfloat16, sms)
        check(plan[:2] == (vec, vpl), "ln_bwd_plan %s: %s" % (name, plan))
        x = (torch.randn(n, d, generator=gen) * 2 + 0.5).to(dev,
                                                            torch.bfloat16)
        dy = torch.randn(n, d, generator=gen).to(dev, torch.bfloat16)
        g = torch.randn(d, generator=gen).to(dev)
        bb = torch.randn(d, generator=gen).to(dev)
        outs = []
        for via_kernel in (True, False):
            ins = [t.clone().requires_grad_(True) for t in (x, g, bb)]
            fn = fln._FusedLN.apply if via_kernel else fln.layer_norm_plain
            y = fn(*ins, 1e-5)[0]
            outs.append(torch.autograd.grad(y, ins, dy))
        _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
        runs = [fln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)
                for _ in range(2)]
        torch.cuda.synchronize()
        check(outs[0][0].dtype == torch.bfloat16, "layer_norm_bwd bf16 dx")
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              "layer_norm_bwd %s differs between two runs" % name)
        errs[name] = check_close("layer_norm_bwd", name,
                                 [("dx", outs[0][0], outs[1][0])], 2.0 ** -8,
                                 shape=[n, d], dtype="bf16",
                                 plan=list(plan))
        check_close("layer_norm_bwd", name + "_params",
                    list(zip(("dgamma", "dbeta"), outs[0][1:], outs[1][1:])),
                    1e-4, shape=[n, d], dtype="f32", plan=list(plan))
    return errs


# the fused CE kernel's ragged cases: name, T, D, V, bias, eps. T is never a
# multiple of the 128-row tile; V % 4 != 0 takes the 4-byte W copies, D %
# 4 != 0 the 4-byte x copies, D % 32 != 0 a ragged k chunk
CE_CASES = [("bias_1000x512x1000", 1000, 512, 1000, True, 0.1),
            ("eps0_777x72x300", 777, 72, 300, True, 0.0),
            ("v30001_1000x512x30001", 1000, 512, 30001, True, 0.1),
            ("v999_333x72x999", 333, 72, 999, False, 0.1),
            ("d75_200x75x1000", 200, 75, 1000, False, 0.1),
            ("d37_129x37x257", 129, 37, 257, True, 0.1)]


# the bf16 cases beside CE_CASES at the wgmma form's route boundaries (D
# not a multiple of 64, one 8-column slab, D above the old resident-x 512)
# and at BERT pretraining's MLM head (D 768, V 30522 = 8 x 3815 + 2, its W
# read through the copy into 16-byte rows), in full and at ragged rows
CE_BF16_CASES = [("v304_777x72x304", 777, 72, 304, True, 0.0),
                 ("d40_129x40x256", 129, 40, 256, False, 0.1),
                 ("v8_300x512x8", 300, 512, 8, True, 0.1),
                 ("d520_257x520x1000", 257, 520, 1000, True, 0.1),
                 ("bert_16384x768x30522", 16384, 768, 30522, True, 0.0),
                 ("d768_4097x768x30522", 4097, 768, 30522, True, 0.1)]


def _ce_form_ran(fce, n_wgmma, calls):
    """The bf16 form the last ``calls`` launches ran, from the wgmma
    count before them."""
    got = fce.fused_ce_fwd.wgmma_launches - n_wgmma
    check(got in (0, calls), "fused_ce_fwd: %d of %d launches on wgmma"
          % (got, calls))
    return "wgmma" if got else "mma_sync"


def _ce_wants_wgmma(d, v):
    """The shapes the wgmma form takes (contiguous tensors, x aligned):
    every D that is a multiple of 8, at any V."""
    return d % 8 == 0


def _ce_inputs(torch, gen, dev, t, d, v, with_bias):
    """x, w, b (or None) and y on the card, with the labels of rows 0 and 1
    at 0 and V - 1 and row 2 of x zero (all its logits equal without a
    bias)."""
    x = torch.randn(t, d, generator=gen)
    x[2] = 0.0
    w = torch.randn(d, v, generator=gen) / d ** 0.5
    b = torch.randn(v, generator=gen).to(dev) if with_bias else None
    y = torch.randint(0, v, (t,), generator=gen)
    y[0], y[1] = 0, v - 1
    return x.to(dev), w.to(dev), b, y.to(dev)


def phase_ce_check(torch, dev):
    """The fused CE kernel against the plain projection + closed-form CE
    (loss and lse, within 2e-5 * max(1, max|plain|)), at the slice's shape
    and at the ragged ``CE_CASES``, each run twice for bitwise equal
    results; its autograd Function (kernel forward, chunked backward)
    against autograd of the plain version (dx, dW within 1e-4 *
    max(1, max|plain|)); then ``fused_ce_f64``."""
    from paddle_tpu_torch.ops import fused_ce as fce

    gen = torch.Generator().manual_seed(SEED)
    rows = TRAIN_BATCH * TRANSFORMER["seq_len"]
    d, v = TRANSFORMER["d_model"], TRANSFORMER["trg_vocab"]
    cases = [("train_%dx%dx%d" % (rows, d, v), rows, d, v, False, 0.1)]
    errs = {}
    for name, t, d_, v_, with_bias, eps in cases + CE_CASES:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        loss, lse = fce.fused_ce_fwd(x, w, b, y, eps)
        again = fce.fused_ce_fwd(x, w, b, y, eps)
        want, want_lse = fce.linear_smooth_ce_plain(x, w, b, y, eps)
        torch.cuda.synchronize()
        same = torch.equal(loss, again[0]) and torch.equal(lse, again[1])
        errs[name] = check_close("fused_ce_fwd", name,
                                 [("loss", loss, want), ("lse", lse,
                                                         want_lse)],
                                 2e-5, shape=[t, d_, v_], eps=eps,
                                 bias=with_bias, bitwise_repeat=same,
                                 plan=list(fce.split_plan(
                                     t, v_, torch.cuda.get_device_properties(
                                         dev).multi_processor_count)))
        check(same, "fused_ce_fwd %s: two runs differ" % name)
        del want, want_lse, x, w, b, y, loss, lse, again
    # the Function: kernel forward + chunked backward, at 4,096 rows
    t = 4096
    x = torch.randn(t, d, generator=gen).to(dev)
    w = (torch.randn(d, v, generator=gen) / d ** 0.5).to(dev)
    y = torch.randint(0, v, (t,), generator=gen).to(dev)
    g = torch.randn(t, generator=gen).to(dev)
    grads = []
    for via_kernel in (True, False):
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if via_kernel:
            loss = fce._FusedCE.apply(xs, ws, None, y, 0.1)
        else:
            loss = fce.linear_smooth_ce_plain(xs, ws, None, y, 0.1)[0]
        grads.append(torch.autograd.grad(loss, (xs, ws), g))
    torch.cuda.synchronize()
    check_close("fused_ce_fwd", "function_grads_%dx%dx%d" % (t, d, v),
                list(zip(("dx", "dw"), grads[0], grads[1])), 1e-4,
                shape=[t, d, v])
    del grads
    # bf16 (AMP) x, W and b: the bf16 forms against the plain version,
    # which forms f32 logits from the same bf16 operands, at the training
    # shape, the ragged cases and BERT's MLM head (the wgmma form where D
    # is a multiple of 8; else the mma.sync form, whose D % 8 != 0 takes
    # element-wise copies), loss and lse within 2e-5 * max(1, max|plain|),
    # each twice, each on the form the route names
    for name, t, d_, v_, with_bias, eps in cases + CE_CASES + CE_BF16_CASES:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        b = b.to(torch.bfloat16) if b is not None else None
        n_wgmma = fce.fused_ce_fwd.wgmma_launches
        loss, lse = fce.fused_ce_fwd(x, w, b, y, eps)
        again = fce.fused_ce_fwd(x, w, b, y, eps)
        ran = _ce_form_ran(fce, n_wgmma, 2)
        want, want_lse = fce.linear_smooth_ce_plain(x, w, b, y, eps)
        torch.cuda.synchronize()
        same = torch.equal(loss, again[0]) and torch.equal(lse, again[1])
        errs[name + "_bf16"] = check_close(
            "fused_ce_fwd", name + "_bf16",
            [("loss", loss, want), ("lse", lse, want_lse)], 2e-5,
            shape=[t, d_, v_], eps=eps, bias=with_bias, dtype="bf16",
            bitwise_repeat=same, form=ran)
        check(same, "fused_ce_fwd %s bf16: two runs differ" % name)
        check(ran == ("wgmma" if _ce_wants_wgmma(d_, v_) else "mma_sync"),
              "fused_ce_fwd %s bf16 ran the %s form" % (name, ran))
        del want, want_lse, x, w, b, y, loss, lse, again
    _ce_f64_check(torch, dev)
    return errs


def _ce_f64(torch, x, w, b, y, eps):
    """The projection and the closed-form smoothed CE in float64."""
    z = torch.matmul(x.double(), w.double())
    if b is not None:
        z = z + b.double()
    lse = torch.logsumexp(z, dim=-1)
    zy = z.gather(1, y.long()[:, None])[:, 0]
    return lse - (1.0 - eps) * zy - eps * z.mean(dim=-1), lse


def _ce_f64_check(torch, dev):
    """The kernel's loss and lse and the plain version's f32 ones (cuBLAS,
    TF32 off) against the projection and CE in f64 on the same f32 inputs,
    by max abs and relative L2 error, at 4,096 rows of the training width
    (D 512, V 30000) and at 4,097 rows of each ragged case; fails if the
    kernel's error is more than twice the plain f32 one in either (a single
    TF32 product would be 54-530 times off, as the CPU emulation shows).
    Then the bf16 forms on x and W rounded to bf16, against f64 on those
    values: at most 1.5 times the plain version's errors (f32 logits from
    the same bf16 operands): the wgmma form at the training width (the
    case that chose its chunk depth, ``fused_ce.WGMMA_CHUNK_K``), with a
    bias at 4,097 rows, at V 30001 (V % 8 != 0, W read through its copy)
    and at BERT's MLM head's D 768 and V 30522 with a bias at 4,097 rows
    (the same depth holds there), and the mma.sync form at D 75."""
    from paddle_tpu_torch.ops import fused_ce as fce

    gen = torch.Generator().manual_seed(SEED + 3)
    d, v = TRANSFORMER["d_model"], TRANSFORMER["trg_vocab"]
    cases = [("train_4096x%dx%d" % (d, v), 4096, d, v, False, 0.1)] + [
        (name.split("_")[0] + "_4097x%dx%d" % (d_, v_), 4097, d_, v_, bias,
         eps) for name, _, d_, v_, bias, eps in CE_CASES]
    cases += [(cases[0][0] + "_bf16",) + cases[0][1:],
              ("bias_4097x%dx1000_bf16" % d, 4097, d, 1000, True, 0.1),
              ("v30001_4097x%dx30001_bf16" % d, 4097, d, 30001, True, 0.1),
              ("bert_4097x768x30522_bf16", 4097, 768, 30522, True, 0.0),
              ("d75_4097x75x1000_bf16", 4097, 75, 1000, False, 0.1)]
    for name, t, d_, v_, with_bias, eps in cases:
        x, w, b, y = _ce_inputs(torch, gen, dev, t, d_, v_, with_bias)
        bf16 = name.endswith("_bf16")
        if bf16:  # the f64 reference takes the same bf16 values
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
            b = b.to(torch.bfloat16) if b is not None else None
        exact = _ce_f64(torch, x, w, b, y, eps)
        n_wgmma = fce.fused_ce_fwd.wgmma_launches
        got = fce.fused_ce_fwd(x, w, b, y, eps)
        ran = _ce_form_ran(fce, n_wgmma, 1)
        check(ran == ("wgmma" if bf16 and _ce_wants_wgmma(d_, v_)
                      else "mma_sync"),
              "fused_ce_f64 %s ran the %s form" % (name, ran))
        ref = fce.linear_smooth_ce_plain(x, w, b, y, eps)
        torch.cuda.synchronize()

        def errs(out, want):
            dd = out.double() - want
            return {"max_abs_err": dd.abs().max().item(),
                    "rel_l2": (dd.norm() / want.norm()).item()}

        names = ("loss", "lse")
        kernel = {n: errs(g, e) for n, g, e in zip(names, got, exact)}
        plain = {n: errs(r, e) for n, r, e in zip(names, ref, exact)}
        ratio = {n: {e: kernel[n][e] / max(plain[n][e], 1e-30)
                     for e in kernel[n]} for n in names}
        limit = 1.5 if bf16 else 2.0
        emit({"phase": "fused_ce_f64", "case": name, "shape": [t, d_, v_],
              "bias": with_bias, "eps": eps, "form": ran,
              "chunk_k": fce.WGMMA_CHUNK_K if ran == "wgmma" else None,
              "kernel": kernel,
              "plain_bf16" if bf16 else "plain_f32": plain, "ratio": ratio,
              "tol": "kernel <= %g x plain, each error" % limit})
        check(all(kernel[n][e] <= limit * plain[n][e] for n in names
                  for e in kernel[n]),
              "fused_ce %s errors against f64 %s, plain %s"
              % (name, kernel, plain))
        del x, w, b, y, exact, got, ref


def phase_timing(torch, dev):
    """Each kernel at the served shapes (the top batch rung, 8 x 128
    tokens, f32), beside its plain version, one PyTorch library call as a
    yardstick (timed here only; the port never calls it), and its bound."""
    gen = torch.Generator().manual_seed(SEED)
    rows = flash_kernel_timing(torch, dev, gen)
    rows.update(_train_kernel_timing(torch, dev, gen))
    rows.update(_conv_kernel_timing(torch, dev))
    rows.update(bandwidth_kernel_timing(torch, dev))
    _add_bandwidth_plans(torch, dev, rows)
    for name, r in _bf16_kernel_timing(torch, dev, gen).items():
        rows[name]["bf16"] = r
    for name, r in rows.items():
        emit(dict({"phase": "timing", "kernel": name}, **r))
    return rows


def flash_kernel_timing(torch, dev, gen):
    """The flash kernels (rows 1-6), f32, key padding bias, through
    :func:`flash_shape_timing`: the forward at BERT-base's served shape (8
    x 128 tokens, 12 heads of 64) with the training shape's row in
    ``trained_shape``, and the backward at Transformer-base's training
    shape (128 x 256 tokens, 8 heads of 64, the encoder self-attention
    call). ``tools/flash_ab.py`` times another checkout's kernels through
    this function."""
    h = BERT["heads"]
    fwd, _ = flash_shape_timing(torch, dev, gen, 8, BERT["seq"], BERT["seq"],
                                h, BERT["d_model"] // h)
    # the training shape: the step launches each 18 times
    t, h = TRANSFORMER["seq_len"], TRANSFORMER["n_head"]
    fwd["trained_shape"], bwd = flash_shape_timing(
        torch, dev, gen, TRAIN_BATCH, t, t, h, TRANSFORMER["d_model"] // h,
        bwd=True, iters=20)
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def flash_shape_timing(torch, dev, gen, b, tq, tk, h, d, bwd=False,
                       iters=50, backend=False, lse_tol=1e-4):
    """The f32 flash kernels at one shape [B, Tq, Tk, H, D] with a key
    padding bias [B, 1, 1, Tk]: the forward (and with ``bwd`` the
    backward) first held against the plain version on the same inputs
    (out and lse within 1e-4 absolute, ``phase_flash_check``'s f32 bound;
    dq, dk and dv within 2e-4 x max(1, max|plain|),
    ``phase_flash_bwd_check``'s), then timed beside the plain version,
    beside ``F.scaled_dot_product_attention`` (timed here only; the port
    never calls it; with ``backend`` the SDPA backend it took) and beside
    its bound. Returns the forward's row and the backward's (or None),
    each with its ``max_abs_err``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    hd = h * d
    q = torch.randn(b, tq, hd, generator=gen).to(dev)
    k, v = (torch.randn(b, tk, hd, generator=gen).to(dev) for _ in range(2))
    dout = torch.randn(b, tq, hd, generator=gen).to(dev) if bwd else None
    mask = _padding_bias(torch, gen, b, tk, dev)[:, None, None, :]
    shape = [b, tq, tk, h, d]
    case = "timing_%dx%dx%dx%dx%d" % tuple(shape)

    def split(x):
        return x.view(b, -1, h, d).transpose(1, 2)

    out, lse = fa.flash_attention_fwd(q, k, v, h, mask)
    plain_in = [x.clone().requires_grad_(bwd) for x in (q, k, v)]
    want, want_lse = fa.attention_plain(*plain_in, h, mask)
    torch.cuda.synchronize()
    live = want_lse > -1e30  # rows that see at least one key
    err = (out - want).abs().max().item()
    lse_err = (lse - want_lse)[live].abs().max().item()
    emit({"phase": "flash_attention_fwd", "case": case, "shape": shape,
          "bias": "key", "dtype": "torch.float32", "max_abs_err": err,
          "lse_err": lse_err, "tol": 1e-4, "lse_tol": lse_tol})
    check(torch.equal(lse <= -1e30, ~live), case + ": masked rows differ")
    check(err <= 1e-4 and lse_err <= lse_tol,
          "flash %s error %g (lse %g) > 1e-4" % (case, err, lse_err))
    lib = [split(x) for x in (q, k, v)]
    nbytes = 4 * (2 * b * tq * hd + 2 * b * tk * hd + b * tk + b * h * tq)
    flops = 4 * b * h * tq * tk * d
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    fwd = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, h, mask),
                   iters=iters),
        plain_ms=time_ms(lambda: fa.attention_plain(q, k, v, h, mask),
                         iters=iters),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            *lib, attn_mask=mask), iters=iters),
        library="F.scaled_dot_product_attention",
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma, shape=shape,
        bytes=nbytes, flops=flops, max_abs_err=err, lse_err=lse_err)
    if backend:
        fwd["library_backend"] = _sdpa_backend(torch, lambda: (
            F.scaled_dot_product_attention(*lib, attn_mask=mask)))
    if not bwd:
        return fwd, None
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, h, mask)[:3]
    want_grads = torch.autograd.grad(want, plain_in, dout, retain_graph=True)
    torch.cuda.synchronize()
    err = check_close("flash_attention_bwd", case, list(zip(
        ("dq", "dk", "dv"), grads, want_grads)), 2e-4, shape=shape,
        bias="key")
    del grads, want_grads
    lib_in = [x.detach().requires_grad_(True) for x in lib]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask)
    lib_dout = split(dout)

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_in, lib_dout,
                                   retain_graph=True)

    nbytes = 4 * (4 * b * tq * hd + 4 * b * tk * hd + b * h * tq + b * tk)
    flops = 10 * b * h * tq * tk * d
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    row = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, h,
                                                  mask), iters=20),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            want, plain_in, dout, retain_graph=True), iters=20),
        library_ms=time_ms(lib_bwd, iters=20),
        library="F.scaled_dot_product_attention backward (autograd)",
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma, shape=shape,
        bytes=nbytes, flops=flops, max_abs_err=err)
    if backend:
        row["library_backend"] = _sdpa_backend(torch, lib_bwd)
    return fwd, row


def _bf16_kernel_timing(torch, dev, gen, only=None, cfg=None):
    """The bf16 forms (AMP) of rows 1-9 at Transformer-base's training
    shapes, each beside its plain version on the same bf16 inputs, one
    PyTorch call on bf16 as a yardstick (timed here only; the port never
    calls it) and its bound: the flash kernels (encoder call, key padding
    bias) against ``F.scaled_dot_product_attention`` forward and backward,
    the LayerNorm kernels against ``F.layer_norm`` forward and backward,
    and the fused CE against the bf16 projection alone. The flash and CE
    bounds take their products at the bf16 tensor-core rate, the
    LayerNorm's their f32 arithmetic on the FMA pipes, all against their
    bytes (each input read once, each output written once). The flash
    forward, flash backward and CE rows also time the mma.sync form on the
    same inputs (``mma_sync_ms``). ``only``: the rows to time (all by default; the
    inputs are drawn alike either way). ``cfg``: the shapes
    (TRANSFORMER_TIMING by default; BERT_TIMING: BERT pretraining's, the
    flash kernels with dropout 0.1, the CE unsmoothed with a bias).
    ``tools/flash_ab.py`` times another checkout's flash forward and CE
    through this function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    def want(name):
        return only is None or name in only

    def on_mma_sync(mod, route, fn, **kw):
        """fn's time with ``mod``'s bf16 route (``route``: fwd_form,
        bwd_form or ce_form) sending it to the mma.sync form, for the two
        forms in one call; None where the package has no such route."""
        if getattr(mod, route, None) is None:
            return None
        with mma_sync_route(mod, route):
            return time_ms(fn, **kw)

    bf = torch.bfloat16
    rows = {}
    cfg = cfg or TRANSFORMER_TIMING
    b, t, h, hd = cfg["batch"], cfg["seq"], cfg["heads"], cfg["d_model"]
    d = hd // h
    p = cfg["dropout"]
    seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
    drop = (False, p, seed)  # causal, dropout rate, seed
    q, k, v, dout = (torch.randn(b, t, hd, generator=gen).to(dev, bf)
                     for _ in range(4))
    kb = _padding_bias(torch, gen, b, t, dev)
    out, lse = fa.flash_attention_fwd(q, k, v, h, kb, *drop)
    mask = kb[:, None, None, :].to(bf)

    def split(x):
        return x.view(b, t, h, d).transpose(1, 2)

    lib_in = [split(x).detach().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                             dropout_p=p)
    nbytes = 2 * 4 * b * t * hd + 4 * (b * t + b * h * t)
    bnd, by = bf16_bound(nbytes, 4 * b * h * t * t * d)
    if want("flash_attention_fwd"):
        rows["flash_attention_fwd"] = dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, h, kb, *drop),
                       iters=20),
            plain_ms=time_ms(lambda: fa.attention_plain(q, k, v, h, kb,
                                                        *drop), iters=20),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                split(q), split(k), split(v), attn_mask=mask, dropout_p=p),
                iters=20),
            library="F.scaled_dot_product_attention (bf16)",
            mma_sync_ms=on_mma_sync(
                fa, "fwd_form",
                lambda: fa.flash_attention_fwd(q, k, v, h, kb, *drop),
                iters=20),
            bound_ms=bnd, bound_by=by, shape=[b, t, t, h, d], bytes=nbytes)
    nbytes = 2 * 8 * b * t * hd + 4 * (b * h * t + b * t)
    bnd, by = bf16_bound(nbytes, 10 * b * h * t * t * d)
    if want("flash_attention_bwd"):
        rows["flash_attention_bwd"] = dict(
            ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                      dout, h, kb, *drop),
                       iters=20),
            mma_sync_ms=on_mma_sync(
                fa, "bwd_form", lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, dout, h, kb, *drop), iters=20),
            plain_ms=time_ms(lambda: fa.attention_bwd_plain(
                q, k, v, out, lse, dout, h, kb, *drop), iters=10),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, lib_in, split(dout), retain_graph=True), iters=20),
            library="F.scaled_dot_product_attention backward (bf16, autograd)",
            bound_ms=bnd, bound_by=by, shape=[b, t, t, h, d], bytes=nbytes)
    del q, k, v, dout, out, lse, lib_in, lib_out

    n = b * t
    x = torch.randn(n, hd, generator=gen).to(dev, bf)
    dy = torch.randn(n, hd, generator=gen).to(dev, bf)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
    nbytes = 2 * 2 * n * hd + 4 * (2 * n + 2 * hd)
    bnd, by = bound(nbytes, 8 * n * hd)
    if want("layer_norm_fwd"):
        rows["layer_norm_fwd"] = dict(
            ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
            plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
            library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g.to(bf),
                                                    bb.to(bf), 1e-5)),
            library="F.layer_norm (bf16)", bound_ms=bnd, bound_by=by,
            shape=[n, hd], bytes=nbytes)
    p_in = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
            bb.clone().requires_grad_(True)]
    p_out = fln.layer_norm_plain(*p_in, 1e-5)[0]
    l_in = [x.clone().requires_grad_(True),
            g.to(bf).clone().requires_grad_(True),
            bb.to(bf).clone().requires_grad_(True)]
    l_out = F.layer_norm(l_in[0], (hd,), l_in[1], l_in[2], 1e-5)
    nbytes = 2 * 3 * n * hd + 4 * (2 * n + 3 * hd)
    bnd, by = bound(nbytes, 12 * n * hd)
    if want("layer_norm_bwd"):
        rows["layer_norm_bwd"] = dict(
            ms=time_ms(lambda: fln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)),
            plain_ms=time_ms(lambda: torch.autograd.grad(p_out, p_in, dy,
                                                          retain_graph=True)),
            library_ms=time_ms(lambda: torch.autograd.grad(l_out, l_in, dy,
                                                           retain_graph=True)),
            library="F.layer_norm backward (bf16, autograd)",
            bound_ms=bnd, bound_by=by, shape=[n, hd], bytes=nbytes)
    del x, dy, p_in, p_out, l_in, l_out

    vv, eps = cfg["vocab"], cfg["ce_eps"]
    x = torch.randn(n, hd, generator=gen).to(dev, bf)
    w = (torch.randn(hd, vv, generator=gen) / hd ** 0.5).to(dev, bf)
    cb = (torch.randn(vv, generator=gen).to(dev, bf) if cfg["ce_bias"]
          else None)
    y = torch.randint(0, vv, (n,), generator=gen).to(dev)
    nbytes = 2 * (n * hd + hd * vv + (vv if cfg["ce_bias"] else 0)) \
        + 4 * 3 * n
    bnd, by = bf16_bound(nbytes, 2 * n * hd * vv)
    if want("fused_ce_fwd"):
        rows["fused_ce_fwd"] = dict(
            ms=time_ms(lambda: fce.fused_ce_fwd(x, w, cb, y, eps), iters=10,
                       warmup=2),
            plain_ms=time_ms(lambda: fce.linear_smooth_ce_plain(x, w, cb, y,
                                                                eps),
                             iters=10, warmup=2),
            library_ms=time_ms(lambda: torch.matmul(x, w), iters=10, warmup=2),
            library="torch.matmul(x, w) on bf16, projection only",
            form=fce.ce_form(x, w),
            mma_sync_ms=on_mma_sync(
                fce, "ce_form",
                lambda: fce.fused_ce_fwd(x, w, cb, y, eps), iters=10,
                warmup=2),
            bound_ms=bnd, bound_by=by, shape=[n, hd, vv], bytes=nbytes)
    return rows


def _train_kernel_timing(torch, dev, gen):
    """The LayerNorm backward and fused CE kernels at
    Transformer-base's training shapes (128 x 256 tokens, f32), each beside
    its plain version, one PyTorch call as a yardstick (timed here only; the
    port never calls it) and its bound. The CE's yardstick is its projection
    alone, ``torch.matmul(x, w)`` (cuBLAS SGEMM, TF32 off); no single call
    computes the fused function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_layer_norm as fln

    rows = {}
    b, t = TRAIN_BATCH, TRANSFORMER["seq_len"]
    hd = TRANSFORMER["d_model"]

    # LayerNorm backward: one [B*T, 512] normalisation (the step launches
    # it 32 times at this shape; the forward is _ln_fwd_timing's)
    n = b * t
    x = torch.randn(n, hd, generator=gen).to(dev)
    dy = torch.randn(n, hd, generator=gen).to(dev)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
    p_in = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
            bb.clone().requires_grad_(True)]
    p_out = fln.layer_norm_plain(*p_in, 1e-5)[0]
    l_in = [x.clone().requires_grad_(True), g.clone().requires_grad_(True),
            bb.clone().requires_grad_(True)]
    l_out = F.layer_norm(l_in[0], (hd,), l_in[1], l_in[2], 1e-5)
    nbytes = 4 * (3 * n * hd + 2 * n + 3 * hd)
    flops = 12 * n * hd
    bnd, by = bound(nbytes, flops)
    rows["layer_norm_bwd"] = dict(
        ms=time_ms(lambda: fln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)),
        plain_ms=time_ms(lambda: torch.autograd.grad(p_out, p_in, dy,
                                                      retain_graph=True)),
        library_ms=time_ms(lambda: torch.autograd.grad(l_out, l_in, dy,
                                                       retain_graph=True)),
        library="F.layer_norm backward (autograd)",
        bound_ms=bnd, bound_by=by, shape=[n, hd], bytes=nbytes, flops=flops)
    del p_out, p_in, l_out, l_in

    # fused CE forward: the loss head, [B*T, 512] x [512, 30000]
    v = TRANSFORMER["trg_vocab"]
    x = torch.randn(n, hd, generator=gen).to(dev)
    w = (torch.randn(hd, v, generator=gen) / hd ** 0.5).to(dev)
    y = torch.randint(0, v, (n,), generator=gen).to(dev)
    nbytes = 4 * (n * hd + hd * v + n + 2 * n)
    flops = 2 * n * hd * v
    bnd, by, bnd_fma = tensor_core_bound(nbytes, flops)
    rows["fused_ce_fwd"] = dict(
        ms=time_ms(lambda: fce.fused_ce_fwd(x, w, None, y, 0.1), iters=10,
                   warmup=2),
        plain_ms=time_ms(lambda: fce.linear_smooth_ce_plain(x, w, None, y,
                                                            0.1),
                         iters=10, warmup=2),
        library_ms=time_ms(lambda: torch.matmul(x, w), iters=10, warmup=2),
        library="torch.matmul(x, w), projection only (cuBLAS SGEMM, TF32 "
                "off)",
        bound_ms=bnd, bound_by=by, bound_ms_f32_fma=bnd_fma,
        plan=list(fce.split_plan(n, v, torch.cuda.get_device_properties(
            dev).multi_processor_count)),
        shape=[n, hd, v], bytes=nbytes, flops=flops)
    return rows


def build_bert_classifier(fluid):
    """The served model: BERT-base encoder + [CLS] classifier head
    (user code, as in ``paddle_tpu/models/bert.py:90-93``)."""
    L = fluid.layers
    s = BERT["seq"]
    input_ids = L.data("input_ids", shape=[s], dtype="int64")
    segment_ids = L.data("segment_ids", shape=[s], dtype="int64")
    input_len = L.data("input_len", shape=[], dtype="int64")
    x = fluid.models.bert.bert_encoder(
        input_ids, segment_ids, input_len, s, BERT["vocab"], BERT["d_model"],
        BERT["d_ff"], BERT["heads"], BERT["layers"], dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    pooled = L.fc(cls, size=BERT["d_model"], act="tanh", name="pooler")
    return L.softmax(L.fc(pooled, size=2, name="cls_out"))


def phase_serve(torch, smi_line, n_requests=1000, in_flight=32):
    """The main path. ``n_requests`` requests of 1-4 rows arrive in a
    closed loop that keeps ``in_flight`` of them outstanding (a few seconds
    of traffic, so the rate and p99 rest on a thousand samples). Launch
    counts are zeroed just before it and read just after; the CPU
    comparison runs the plain versions and launches nothing. The saved
    model directory is kept and returned third, with the seeded feeds and
    the rate and latencies (for the router phases), for the caller to
    delete."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED)
    s = BERT["seq"]
    feeds = []
    for _ in range(n_requests):
        n = int(rng.randint(1, 5))
        feeds.append({
            "input_ids": rng.randint(0, BERT["vocab"], (n, s)),
            "segment_ids": rng.randint(0, 2, (n, s)),
            "input_len": rng.randint(1, s + 1, (n,))})

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        prob = build_bert_classifier(fluid)
    startup.random_seed = SEED
    exe = fluid.Executor()  # default place: CUDAPlace(0)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        model_dir = tempfile.mkdtemp(prefix="bert_base_")
        fluid.io.save_inference_model(
            model_dir, ["input_ids", "segment_ids", "input_len"], [prob],
            exe, main_program=main)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    del scope
    t_setup = time.perf_counter() - t0

    engine = fluid.serving.ServingEngine(model_dir, num_replicas=1,
                                         max_batch_size=8)
    try:
        t0 = time.perf_counter()
        warmed = engine.warmup()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        futures = []
        for i, f in enumerate(feeds):
            if i >= in_flight:
                futures[i - in_flight].result(timeout=300)
            futures.append(engine.submit(f))
        results = [f.result(timeout=300)[0] for f in futures]
        wall = time.perf_counter() - t0
        snap = engine.metrics()
    finally:
        engine.shutdown()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    # each (replica, rung) key interprets its first run and captures its
    # second (both in warmup); every later dispatch is a replay
    runs = dict.fromkeys(("interpreted", "captures", "replays"), 0)
    replicas = [w.predictor for w in engine._workers]
    for pred in replicas:
        for k, n in exe_runs(pred._exe).items():
            runs[k] += n
    launching = runs["interpreted"] + runs["captures"]
    step_report = replicas[0]._exe.step_report(replicas[0]._program)
    for pred in replicas:
        pred.close()
    dispatches = 2 * warmed + snap["batches"]

    for f, r in zip(feeds, results):
        check(r.shape == (f["input_ids"].shape[0], 2),
              "served shape %s" % (r.shape,))
        check(np.isfinite(r).all(), "non-finite probabilities")
        check(np.abs(r.sum(1) - 1.0).max() <= 1e-5, "rows do not sum to 1")

    # two requests against the port on the CPU, same weights (plain versions)
    config = fluid.inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    cpu = fluid.inference.Predictor(config)
    cpu_err = 0.0
    for i in (0, n_requests - 1):
        want, = cpu.run(feeds[i])
        cpu_err = max(cpu_err, float(np.abs(results[i] - want).max()))
    check(read_counts() == launches, "the CPU check launched a kernel")
    phase_profile(torch, fluid, model_dir, feeds)

    lat = snap["latency_s"]
    emit({"phase": "serve", "model": "bert_base_classifier", "config": BERT,
          "params": n_params, "requests": n_requests,
          "arrival": "closed loop", "in_flight": in_flight,
          "rows": int(sum(f["input_ids"].shape[0] for f in feeds)),
          "requests_per_s": n_requests / wall, "wall_s": wall,
          "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3,
          "batches": snap["batches"], "avg_batch_size": snap["avg_batch_size"],
          "batch_occupancy": snap["batch_occupancy"], "warmup_runs": warmed,
          "warmup_s": t_warm, "setup_s": t_setup, "dispatches": dispatches,
          "captured": step_report["captured"],
          "reason": step_report["reason"], "runs": runs,
          "peak_memory_bytes": peak,
          "launches": launches, "cpu_max_abs_err": cpu_err,
          "device": smi_line})
    check(snap["requests_completed"] == n_requests
          and snap["requests_failed"] == 0, "requests failed: %s" % snap)
    check(cpu_err <= 1e-4, "served vs CPU error %g > 1e-4" % cpu_err)
    check(step_report["captured"] and launching == 2 * warmed
          and runs["replays"] == snap["batches"],
          "serve: runs %s, %d warmed rungs, %d batches (%s)"
          % (runs, warmed, snap["batches"], step_report))
    check(launches["flash_attention_fwd"] == BERT["layers"] * launching,
          "flash launches %d != %d layers x %d launching dispatches"
          % (launches["flash_attention_fwd"], BERT["layers"], launching))
    check(launches["layer_norm_fwd"] == (2 * BERT["layers"] + 1) * launching,
          "layer_norm launches %d != %d x %d launching dispatches"
          % (launches["layer_norm_fwd"], 2 * BERT["layers"] + 1,
             launching))
    return (launches,
            {"flash_attention_fwd": BERT["layers"] * runs["replays"],
             "layer_norm_fwd": (2 * BERT["layers"] + 1) * runs["replays"]},
            {"model_dir": model_dir, "feeds": feeds,
             "requests_per_s": n_requests / wall,
             "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3})


def phase_profile(torch, fluid, model_dir, feeds, runs=20):
    """Where one 8-row dispatch's time goes: device time of every CUDA
    kernel by kind (torch.profiler), against the host wall time of the
    same number of runs made without the profiler, whose CPU tracing
    slows the host; after the main path, so its launches are not
    counted."""
    from torch.profiler import ProfilerActivity, profile

    pred = fluid.inference.Predictor(model_dir)
    batch = {k: np.concatenate([f[k] for f in feeds])[:8] for k in feeds[0]}
    pred.run(batch)  # call 1: interpreted
    pred.run(batch)  # captured
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        pred.run(batch)  # fetches to numpy: ends synchronised
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            pred.run(batch)
        prof_wall = time.perf_counter() - t0
    kinds = {"flash_attention_fwd": 0.0, "layer_norm_fwd": 0.0, "gemm": 0.0,
             "other": 0.0}
    n_kernels = 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        n_kernels += e.count
        name = e.key.lower()
        kind = ("flash_attention_fwd" if "flash_fwd_" in name
                else "layer_norm_fwd" if "layer_norm_fwd_kernel" in name
                else "gemm" if ("gemm" in name or "cutlass" in name
                                or "xmma" in name) else "other")
        kinds[kind] += us
    per_run = {k: v / runs / 1e3 for k, v in kinds.items()}
    busy = sum(per_run.values())
    wall_ms = wall / runs * 1e3
    step_report = pred._exe.step_report(pred._program)
    pred.close()
    check(step_report["captured"] and step_report["replays"] == 2 * runs,
          "profile: %s" % step_report)
    emit({"phase": "profile", "rows": 8, "runs": runs,
          "captured": step_report["captured"],
          "reason": step_report["reason"], "step_report": step_report,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "wall_ms_per_dispatch": wall_ms,
          "profiled_wall_ms_per_dispatch": prof_wall / runs * 1e3,
          "device_ms_per_dispatch": per_run,
          "kernels_per_dispatch": n_kernels / runs,
          "device_busy_share": busy / wall_ms if wall_ms else None})


def _optimizer(fluid, amp, lr=1e-4):
    """Adam(1e-4), under ``fluid.amp.decorate`` when ``amp`` (as
    paddle_tpu's bench.py:225-231 wraps it); ``lr`` may be a schedule's
    Variable."""
    opt = fluid.optimizer.Adam(learning_rate=lr)
    return fluid.amp.decorate(opt) if amp else opt


def build_transformer(fluid, dropout_rate, amp=False, schedule=None):
    """Transformer-base with Adam(1e-4), as paddle_tpu's bench.py trains
    it, in fresh programs, in f32 or under ``amp.decorate``; with
    ``schedule(layers)``, Adam at that learning-rate schedule (the spec's
    ``extras["lr"]``). Returns (main, startup, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.transformer.transformer_base(
            dropout_rate=dropout_rate, **TRANSFORMER)
        lr = 1e-4
        if schedule is not None:
            lr = spec.extras["lr"] = schedule(fluid.layers)
        _optimizer(fluid, amp, lr).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, spec


PER_STEP = per_run(flash_attention_fwd=3 * TRANSFORMER["n_layer"],
                   flash_attention_bwd=3 * TRANSFORMER["n_layer"],
                   layer_norm_fwd=5 * TRANSFORMER["n_layer"] + 2,
                   layer_norm_bwd=5 * TRANSFORMER["n_layer"] + 2,
                   fused_ce_fwd=1)


CAPTURE_STEPS = 4
# interpreted runs of a capture case, and of one whose step takes the flash
# backward: it sums dq by f32 atomics in no fixed order, so two runs of a
# Transformer step differ (by 2.8e-6 to 1.6e-5 rel L2, and now and then by
# far less), and the captured run is held to the largest distance of the
# interpreted runs' pairs
INTERPRETED_RUNS = 2
INTERPRETED_RUNS_ATOMIC = 4
# relative L2 a captured step may add beyond twice the distance between
# two interpreted runs: a few f32 ulps
F32_ROUNDING = 1e-6


def _capture_runs(torch, fluid, main, feed, fetch, scope, start, gen_state,
                  cache, donate=True, sync_check=False, steps=CAPTURE_STEPS):
    """``steps`` runs of ``main`` with a fresh executor from the state
    ``start`` and the generator state ``gen_state``. ``sync_check``: call
    1 runs under ``torch.cuda.set_sync_debug_mode("error")`` on feeds
    staged on the card, fetching tensors, so that any wait on the host in
    the step raises (the fetches' host copy comes after). Returns (fetches
    per step, the state after, the step report, the launches of each
    run)."""
    from paddle_tpu_torch.core.executor import RNG_KEY, to_numpy

    for n, t in start.items():
        scope.set(n, t.clone())
    scope.get(RNG_KEY).set_state(gen_state)
    exe = fluid.Executor()
    outs, launches = [], []
    for i in range(steps):
        before = read_counts()
        if i == 0 and sync_check:
            staged = {n: torch.as_tensor(np.asarray(v)).to(exe.device)
                      for n, v in feed.items()}
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = exe.run(main, feed=staged, fetch_list=fetch,
                              scope=scope, return_numpy=False,
                              donate_state=donate)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got = [to_numpy(t) for t in got]
        else:
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          use_program_cache=cache, donate_state=donate)
        outs.append([np.asarray(g, np.float64) for g in got])
        after = read_counts()
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    # compared on the card: a host copy of the whole state would cost more
    # than the steps
    state = {n: scope.get(n).detach().clone() for n in start}
    report = exe.step_report(main)
    exe.close()
    return outs, state, report, launches


def _capture_case(torch, fluid, name, main, startup, feed, fetch,
                  donate=True, scope=None, steps=CAPTURE_STEPS, exact=(),
                  bitwise=False, runs=INTERPRETED_RUNS):
    """One program of ``capture_check``: ``steps`` captured steps (call 1
    under the sync check) against ``runs`` runs of as many interpreted
    ones (``use_program_cache=False``), all from one copied
    state and one generator state. The captured run's fetches of every
    step and state tensors, taken together (relative L2), must lie within
    twice the largest distance between two interpreted runs plus
    F32_ROUNDING of the first interpreted run, and the fetches at the
    indices ``exact`` must equal its own bitwise; the capture call
    launches what call 1 launched, and the replays nothing from Python.
    ``bitwise``: every run must equal the first interpreted one bitwise (a
    program whose reductions all have a fixed order). Returns the captured
    distance."""
    from paddle_tpu_torch.core.executor import RNG_KEY

    if scope is None:
        scope = fluid.Scope()
        fluid.Executor().run(startup, scope=scope)
    start = {v.name: scope.get(v.name).clone() for v in main.list_vars()
             if v.persistable and v.name in scope}
    gen_state = scope.get(RNG_KEY).get_state()
    torch.cuda.reset_peak_memory_stats()
    interp = [_capture_runs(torch, fluid, main, feed, fetch, scope, start,
                            gen_state, False, donate, steps=steps)
              for _ in range(runs)]
    cap = _capture_runs(torch, fluid, main, feed, fetch, scope, start,
                        gen_state, True, donate, sync_check=True,
                        steps=steps)
    peak = torch.cuda.max_memory_allocated()

    def sums(a, b):
        """(sum (x - y)^2, sum y^2) of each fetch of each step and each
        state tensor, in f64."""
        out = [(torch.from_numpy(x), torch.from_numpy(y))
               for sa, sb in zip(a[0], b[0]) for x, y in zip(sa, sb)]
        out += [(a[1][n].double(), b[1][n].double()) for n in sorted(start)]
        return [(float(torch.square(x - y).sum()), float(torch.square(y).sum()))
                for x, y in out]

    def dist(a, b):
        """Relative L2 over every fetch of every step and every state
        tensor at once: one statistic, steady where the per-tensor ones
        are set by a few elements (Adam moves an element whose gradient
        is within rounding of zero by up to twice the learning rate).
        Also the largest per-tensor one."""
        parts = sums(a, b)
        num, den = sum(p[0] for p in parts), sum(p[1] for p in parts)
        return (float(np.sqrt(num / max(den, 1e-300))),
                max(float(np.sqrt(n / max(d, 1e-300))) for n, d in parts))

    ii = [dist(x, y) for x, y in itertools.combinations(interp, 2)]
    d_ii, w_ii = max(p[0] for p in ii), max(p[1] for p in ii)
    d_ci, w_ci = dist(cap, interp[0])
    report = cap[2]
    emit({"phase": "capture_check", "case": name,
          "captured": report["captured"], "reason": report["reason"],
          "step_report": report, "kernels_captured": cap[3][1],
          "kernels_call1": cap[3][0], "replay_launches": cap[3][2:],
          "graph_pool_bytes": report["pool_bytes"],
          "peak_memory_bytes": peak, "steps": steps,
          "exact_fetches": {str(i): [float(np.asarray(o[i]).reshape(-1)[0])
                                     for o in cap[0]] for i in exact},
          "state_tensors": len(start),
          "interpreted_runs": runs,
          "interpreted_pairs": [p[0] for p in ii],
          "interpreted_vs_interpreted": d_ii,
          "captured_vs_interpreted": d_ci,
          "per_tensor_max": {"interpreted_vs_interpreted": w_ii,
                             "captured_vs_interpreted": w_ci},
          "tol": ("every run bitwise equal" if bitwise else
                  "captured vs interpreted <= 2 x the largest interpreted "
                  "vs interpreted + %g (rel L2)" % F32_ROUNDING),
          "sync_debug_call1": "error"})
    check(report["captured"] and (report["interpreted"], report["captures"],
                                  report["replays"]) == (1, 1, steps - 2),
          "capture_check %s: %s" % (name, report))
    for i in exact:
        check(all(np.array_equal(c[i], w[i])
                  for c, w in zip(cap[0], interp[0][0])),
              "capture_check %s: fetch %d of the replays %s != the "
              "interpreted run's %s" % (name, i, [c[i] for c in cap[0]],
                                        [w[i] for w in interp[0][0]]))
    check(cap[3][1] == cap[3][0] and not any(cap[3][2:]),
          "capture_check %s launches %s" % (name, cap[3]))
    check(d_ci == d_ii == 0.0 if bitwise
          else d_ci <= 2 * d_ii + F32_ROUNDING,
          "capture_check %s: captured vs interpreted %g, interpreted vs "
          "interpreted %s" % (name, d_ci, [p[0] for p in ii]))
    return d_ci


def _declined_case(torch, fluid, name, run, program, want):
    """A program the capture rule keeps interpreted: two runs, then its
    step report must name the reason ``want``."""
    exe = fluid.Executor()
    for _ in range(2):
        run(exe)
    report = exe.step_report(program)
    exe.close()
    emit({"phase": "capture_check", "case": name,
          "captured": report["captured"], "reason": report["reason"],
          "step_report": report})
    check(not report["captured"] and report["reason"].startswith(want)
          and report["interpreted"] == 2,
          "capture_check %s: %s" % (name, report))


def _decode_programs(fluid, cfg):
    """The step and chunk programs of ``cfg`` over one scope on the card
    (the step's startup initialises the weights both read): (scope,
    {"step": (main, spec, fetch names), "chunk": ...})."""
    tr = fluid.models.transformer
    progs = {}
    scope = fluid.Scope()
    for name, build in (("step", tr.transformer_lm_step),
                        ("chunk", tr.transformer_lm_chunk)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fetch_vars, spec = build(**cfg)
        startup.random_seed = SEED
        if name == "step":
            fluid.Executor().run(startup, scope=scope)
        progs[name] = (main, spec, [v.name for v in fetch_vars])
    return scope, progs


def _decode_capture_case(torch, fluid, scope, progs, b=4, c=64,
                         dispatches=8, k=4):
    """Step and chunk dispatches at GPT-2-small widths over lent caches
    (one fixed set of [b, c], written in place), alternating, with tokens
    and positions from a seed (some positions out of range, the chunk's
    pad lanes at C): each captured (from its second run) against the same
    sequence interpreted twice (``use_program_cache=False``), from the
    same caches. The logits of every dispatch and the final caches must
    lie within twice the interpreted-vs-interpreted distance plus
    F32_ROUNDING; each program interprets once, captures once and replays
    after, the capture launching what call 1 did and a replay nothing from
    Python. ``scope``, ``progs``: :func:`_decode_programs`'s."""
    from paddle_tpu_torch.core.opimpl.attention_ops import lendable_cache

    names = [cf["feed"] for cf in progs["step"][1]["cache_feeds"]]
    rng = np.random.RandomState(SEED)
    seq = []
    for i in range(dispatches):
        kind = "chunk" if i % 2 else "step"
        shape = (b, k) if kind == "chunk" else (b,)
        tok = rng.randint(0, GPT2["vocab"], shape).astype("int64")
        if kind == "chunk":
            # each row's lanes write distinct cells (two writes to one cell
            # land in no fixed order, and the batcher never makes them):
            # positions of [0, C + 2), the last two columns' sometimes as
            # their wrapping aliases -2 and -1, the last lane a pad at C
            pos = np.stack([rng.permutation(c + 2)[:k] for _ in range(b)])
            alias = (pos >= c - 2) & (pos < c) & (rng.rand(b, k) < 0.5)
            pos = np.where(alias, pos - c, pos).astype("int32")
            pos[:, -1] = c
        else:
            pos = rng.randint(0, c, shape).astype("int32")
        seq.append((kind, tok, pos))
    start = [torch.randn(b, c, GPT2["d_model"], device="cuda")
             for _ in names]

    def run(cache_on):
        exes = {n: fluid.Executor() for n in progs}
        caches = {}
        for n, t in zip(names, start):
            caches[n] = lendable_cache(b, c, (GPT2["d_model"],),
                                       torch.float32, t.device)
            caches[n].copy_(t)
        logits, launches = [], []
        for kind, tok, pos in seq:
            main, spec, fetch = progs[kind]
            feed = dict(caches)
            feed[spec["token_feed"]], feed[spec["pos_feed"]] = tok, pos
            before = read_counts()
            outs = exes[kind].run(main, feed=feed, fetch_list=fetch,
                                  scope=scope, return_numpy=False,
                                  use_program_cache=cache_on,
                                  _lend=tuple(names))
            after = read_counts()
            launches.append({n: after[n] - before[n] for n in after
                             if after[n] != before[n]})
            check(all(o is caches[n] for o, n in zip(outs[1:], names)),
                  "decode capture: a lent cache was not fetched back as "
                  "itself")
            lg = outs[0].double().cpu()
            if kind == "chunk":   # pad lanes (pos >= C): NaN, ignored
                lg[torch.from_numpy(pos >= c)] = 0.0
            logits.append(lg)
        reports = {kind: exes[kind].step_report(progs[kind][0])
                   for kind in progs}
        pool = sum(e.pool_bytes or 0 for x in exes.values()
                   for e in x._cache.values())
        for x in exes.values():
            x.close()
        return (logits + [caches[n].double().cpu() for n in names],
                reports, launches, pool)

    i1, i2 = run(False), run(False)
    cap = run(True)

    def dist(a, b_):
        num = sum(float(torch.square(x - y).sum()) for x, y in zip(a, b_))
        den = sum(float(torch.square(y).sum()) for y in b_)
        return float(np.sqrt(num / max(den, 1e-300)))

    d_ii, d_ci = dist(i2[0], i1[0]), dist(cap[0], i1[0])
    bitwise = all(torch.equal(x, y) for x, y in zip(cap[0], i1[0]))
    emit({"phase": "capture_check", "case": "decode_lent",
          "config": GPT2, "batch": b, "ctx": c, "chunk": k,
          "dispatches": dispatches,
          "step_report": cap[1]["step"], "chunk_report": cap[1]["chunk"],
          "launches": cap[2], "graph_pool_bytes": cap[3],
          "interpreted_vs_interpreted": d_ii, "captured_vs_interpreted": d_ci,
          "bitwise_equal": bitwise,
          "tol": "captured <= 2 x interpreted + %g (rel L2)" % F32_ROUNDING})
    per = {"layer_norm_fwd": 2 * GPT2["n_layer"] + 1}
    for kind in progs:
        r = cap[1][kind]
        check(r["captured"] and r["reason"] == "admitted"
              and (r["interpreted"], r["captures"], r["replays"])
              == (1, 1, dispatches // 2 - 2),
              "capture_check decode_lent %s: %s" % (kind, r))
    check(cap[2][:4] == [per, per, per, per] and not any(cap[2][4:]),
          "capture_check decode_lent launches %s" % cap[2])
    check(d_ci <= 2 * d_ii + F32_ROUNDING,
          "capture_check decode_lent: captured vs interpreted %g, "
          "interpreted vs interpreted %g" % (d_ci, d_ii))
    return d_ci


def _clone_evals(torch, fluid, main, startup, spec, n=5):
    """C7: ``n`` evaluations through one executor, each of a fresh
    ``main.clone(for_test=True)`` (interpreted, captured, replayed) that is
    dropped after: the executor releases each dead clone's graph, so the
    device memory reserved (after ``empty_cache``) stays flat from the
    second evaluation on."""
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(2, np.random.RandomState(SEED))
    reserved, entries = [], []
    for _ in range(n):
        test = main.clone(for_test=True)
        for _ in range(3):
            exe.run(test, feed=feed, fetch_list=[spec.loss.name],
                    scope=scope)
        check(exe.step_report(test)["graph"], "clone eval not captured")
        del test
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        entries.append(len(exe._cache))
    exe.run(startup, scope=scope)   # a live program: the reap runs
    released = exe.step_report(startup)["released"]
    exe.close()
    emit({"phase": "capture_check", "case": "clone_evals", "evals": n,
          "reserved_bytes": reserved, "entries": entries,
          "released": released})
    check(max(reserved[1:]) <= reserved[1] and released == n,
          "capture_check clone_evals: reserved %s, released %d of %d"
          % (reserved, released, n))


def _interleaved_keys(torch, fluid, rounds=3):
    """Two keys of one executor (BERT-base serving at 2 and 8 rows) share
    its graph pool and fetch arena: their replays, interleaved, against
    the same feeds interpreted, within F32_ROUNDING (rel L2)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        prob = build_bert_classifier(fluid)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    s = BERT["seq"]

    def feed(n):
        return {"input_ids": rng.randint(0, BERT["vocab"], (n, s)),
                "segment_ids": rng.randint(0, 2, (n, s)),
                "input_len": rng.randint(1, s + 1, (n,))}

    feeds = [feed(n) for _ in range(rounds + 2) for n in (2, 8)]
    exe, ref = fluid.Executor(), fluid.Executor()
    worst = 0.0
    for f in feeds:
        got, = exe.run(main, feed=f, fetch_list=[prob], scope=scope,
                       donate_state=False)
        want, = ref.run(main, feed=f, fetch_list=[prob], scope=scope,
                        donate_state=False, use_program_cache=False)
        worst = max(worst, float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want)))
    runs = exe_runs(exe)
    arena = exe._pool.arena.numel() if exe._pool.arena is not None else 0
    exe.close()
    emit({"phase": "capture_check", "case": "interleaved_keys",
          "rows": [2, 8], "runs": runs, "max_rel_l2": worst,
          "fetch_arena_bytes": arena})
    check(runs == {"interpreted": 2, "captures": 2,
                   "replays": len(feeds) - 4} and worst <= F32_ROUNDING,
          "capture_check interleaved_keys: runs %s, rel L2 %g"
          % (runs, worst))


def phase_capture_check(torch):
    """Before the timed phases: each main-path program captured against
    the same steps interpreted (``_capture_case``), at full width and
    small batches: Transformer-base f32 and AMP (batch 2, dropout 0.1),
    the f32 one again with the flash backward's plain version, bitwise
    (``plain_flash_bwd``: the control that the spread is dq's atomics),
    ResNet-50 AMP train (batch 2) and its AMP eval clone, DeepFM f32
    (batch 64) and BERT-base serving (one rung of 8 rows, as the
    Predictor runs it: ``donate_state=False``); Transformer-base under
    ``exponential_decay`` (7 steps: the rate of 5 replays bitwise the
    interpreted run's); the decode step and chunk programs at GPT-2-small
    widths over lent caches (``_decode_capture_case``); fresh eval clones through one
    executor (``_clone_evals``, C7); two keys of one executor replayed in
    turns (``_interleaved_keys``: one pool, one fetch arena); then a
    decode step over an unlent cache and a DeepFM step with merged sparse
    rows, which the rule keeps interpreted with their reasons."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.backward import require_merged_sparse

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    dist = {}
    for amp in (False, True):
        main, startup, spec = build_transformer(fluid, 0.1, amp=amp)
        name = "transformer_amp" if amp else "transformer"
        dist[name] = _capture_case(
            torch, fluid, name, main, startup, spec.sample_batch(2, rng),
            [spec.loss], runs=INTERPRETED_RUNS_ATOMIC)
    _clone_evals(torch, fluid, main, startup, spec)
    # the control: the f32 step with the plain flash backward (no atomics)
    # captures bitwise equal to its interpreted runs, so the interpreted
    # runs' spread above is the dq atomics' order and nothing of the
    # capture's (a race in a replay would show here)
    main, startup, spec = build_transformer(fluid, 0.1)
    with plain_flash_bwd():
        dist["transformer_plain_bwd"] = _capture_case(
            torch, fluid, "transformer_plain_bwd", main, startup,
            spec.sample_batch(2, rng), [spec.loss], bitwise=True)
    # Adam at exponential_decay: the step counter and the rate stay on
    # the card, the counter written in place; the rate of 5 replays
    # equals the interpreted run's. With the plain flash backward the
    # whole step is held bitwise: with the dq atomics, runs of this case
    # lie 5e-7 to 1.5e-5 apart, and twice the largest of four runs' six
    # distances did not always cover a fifth run
    main, startup, spec = build_transformer(
        fluid, 0.1, schedule=lambda L: L.exponential_decay(1e-4, 2, 0.5))
    with plain_flash_bwd():
        dist["transformer_exp_decay"] = _capture_case(
            torch, fluid, "transformer_exp_decay", main, startup,
            spec.sample_batch(2, rng), [spec.loss, spec.extras["lr"]],
            steps=7, exact=(1,), bitwise=True)
    main, startup, test, spec = build_resnet(fluid, amp=True)
    feed = spec.sample_batch(2, rng)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    dist["resnet_amp_train"] = _capture_case(
        torch, fluid, "resnet_amp_train", main, startup, feed,
        [spec.loss, spec.fetches["acc"]], scope=scope)
    fluid.amp.enable_bf16(test)
    logits = [op.input("X").name for op in test.global_block().ops
              if op.type == "softmax"][0]
    dist["resnet_amp_eval"] = _capture_case(
        torch, fluid, "resnet_amp_eval", test, startup, feed,
        [spec.loss.name, spec.fetches["acc"].name, logits], scope=scope)
    del scope
    main, startup, spec = build_deepfm(fluid)
    dist["deepfm"] = _capture_case(torch, fluid, "deepfm", main, startup,
                                   spec.sample_batch(64, rng), [spec.loss])
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        prob = build_bert_classifier(fluid)
    startup.random_seed = SEED
    s = BERT["seq"]
    feed = {"input_ids": rng.randint(0, BERT["vocab"], (8, s)),
            "segment_ids": rng.randint(0, 2, (8, s)),
            "input_len": rng.randint(1, s + 1, (8,))}
    dist["bert_serving"] = _capture_case(
        torch, fluid, "bert_serving", main, startup, feed, [prob],
        donate=False)

    # the decode programs at GPT-2-small widths (random weights)
    scope, progs = _decode_programs(fluid, GPT2)
    dist["decode_lent"] = _decode_capture_case(torch, fluid, scope, progs)
    _interleaved_keys(torch, fluid)
    # declined: a decode step over a fed (unlent) cache, and a sparse step
    # whose rows are merged
    main, dspec, fetch = progs["step"]
    b, c = 4, 64
    feed = {cf["feed"]: torch.zeros(b, c, GPT2["d_model"], device="cuda")
            for cf in dspec["cache_feeds"]}
    feed[dspec["token_feed"]] = np.zeros((b,), "int64")
    feed[dspec["pos_feed"]] = np.zeros((b,), "int32")
    _declined_case(torch, fluid, "decode_step_unlent",
                   lambda exe: exe.run(main, feed=feed, fetch_list=fetch,
                                       scope=scope, return_numpy=False),
                   main, "op 'kv_cache_write': fed cache copied per dispatch")
    main, startup, spec = build_deepfm(fluid)
    require_merged_sparse(main)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    feed = spec.sample_batch(64, rng)
    _declined_case(torch, fluid, "deepfm_merge_sparse",
                   lambda exe: exe.run(main, feed=feed,
                                       fetch_list=[spec.loss], scope=scope),
                   main, "op 'autodiff' merges sparse rows")
    emit({"phase": "capture_check", "captured_vs_interpreted": dist,
          "seconds": time.perf_counter() - t0})


def phase_train_check(torch, smi_line, batch=2):
    """One full-width step (dropout 0) on the card and the same step with
    the port on the CPU (plain versions), from the same weights and feed
    (f32, TF32 off): loss, the global grad norm and five named parameters'
    grad norms agree within 1e-4 relative, and every parameter's gradient
    within 1e-2 in relative L2 error (|card - CPU| / |CPU|), which a wrong
    direction or a wrong gradient in any parameter exceeds by far. An
    element-wise bound cannot hold across the whole net: a ReLU input
    within rounding of 0 may take another sign on the card than on the
    CPU, which moves that unit's column of the FFN weight gradient by one
    token's whole contribution. It reports those sign flips and the
    largest element-wise error (over the parameter's max |CPU grad|)."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_transformer(fluid, dropout_rate=0.0)
    names = [p.name for p in main.all_parameters()]
    gb = main.global_block()
    relu_in = [op.input("X").name for op in gb.ops if op.type == "relu"]
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in names] + relu_in
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    seq = TRANSFORMER["seq_len"]
    feed["src_len"] = np.array([seq, seq * 3 // 4][:batch], "int64")
    feed["trg_len"] = np.array([seq, seq * 2 // 3][:batch], "int64")

    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == PER_STEP, "train_check launches %s != %s"
          % (counts, PER_STEP))

    cpu_scope = fluid.Scope()
    cexe = fluid.Executor(fluid.CPUPlace())
    cexe.run(startup, scope=cpu_scope)
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    t0 = time.perf_counter()
    cpu = cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    check(read_counts() == counts, "the CPU step launched a kernel")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    n_p = len(names)
    gnorm = [float(np.sqrt(sum(float(np.square(g.astype("f8")).sum())
                               for g in run[1:1 + n_p])))
             for run in (gpu, cpu)]
    last = TRANSFORMER["n_layer"] - 1
    named = ["src_word_emb", "enc0_attn.q", "dec%d_cross.k" % last,
             "dec%d_ffn_fc1.w" % last, "out_proj.w"]
    norms = {}
    for n in named:
        i = 1 + names.index(n)
        norms[n] = [float(np.linalg.norm(run[i].astype("f8")))
                    for run in (gpu, cpu)]
    l2, elem = {}, {}
    for n, g, c in zip(names, gpu[1:1 + n_p], cpu[1:1 + n_p]):
        diff = np.abs(g.astype("f8") - c)
        l2[n] = float(np.linalg.norm(diff)) / max(
            float(np.linalg.norm(c.astype("f8"))), 1e-30)
        elem[n] = (float(diff.max()) / max(float(np.abs(c).max()), 1e-30),
                   [int(i) for i in np.unravel_index(diff.argmax(),
                                                     diff.shape)])
    worst_l2 = max(l2, key=l2.get)
    worst_elem = max(elem, key=lambda n: elem[n][0])
    flips = {}
    for n, a, c in zip(relu_in, gpu[1 + n_p:], cpu[1 + n_p:]):
        at = np.argwhere((a > 0) != (c > 0))
        if len(at):
            flips[n] = {"count": len(at), "units": sorted(
                {int(i[-1]) for i in at}), "max_abs_input": max(
                max(abs(float(a[tuple(i)])), abs(float(c[tuple(i)])))
                for i in at)}
    errs = {"loss": rel(float(gpu[0]), float(cpu[0])),
            "grad_norm": rel(*gnorm)}
    errs.update({"grad_norm:" + n: rel(*v) for n, v in norms.items()})
    emit({"phase": "train_check", "batch": batch, "config": TRANSFORMER,
          "dropout": 0.0, "loss_gpu": float(gpu[0]),
          "loss_cpu": float(cpu[0]), "grad_norm_gpu": gnorm[0],
          "grad_norm_cpu": gnorm[1], "named_grad_norms": norms,
          "rel_errors": errs, "tol_rel": 1e-4, "grads_compared": n_p,
          "grad_rel_l2_max": l2[worst_l2], "grad_rel_l2_param": worst_l2,
          "tol_rel_l2": 1e-2, "grad_max_elem": elem[worst_elem][0],
          "grad_max_elem_param": worst_elem,
          "grad_max_elem_index": elem[worst_elem][1],
          "relu_sign_flips": flips, "launches": counts,
          "cpu_step_s": cpu_s, "device": smi_line})
    check(np.isfinite([float(gpu[0]), gnorm[0]]).all(),
          "non-finite loss or grads on the card")
    check(max(errs.values()) <= 1e-4, "train_check errors %s" % errs)
    check(l2[worst_l2] <= 1e-2, "train_check: %s gradient off by %g (rel L2)"
          % (worst_l2, l2[worst_l2]))
    return errs


# An AMP check compares, per fetched quantity (a scalar by its relative
# difference, an array by its relative L2), the card's AMP step with the
# port's CPU AMP step, beside the CPU's AMP-vs-f32 distance and the CPU AMP
# step's own rounding sensitivity (its distance from the step on the
# parameters scaled by 1 + 2^-20, a few f32 ulps). A quantity separates
# AMP from f32 where AMP_SENSITIVITY_FACTOR x that sensitivity is below
# AMP_MARGIN x the AMP-vs-f32 distance, and so does the loss, which the
# card's forward reproduces far closer than the sensitivity (0.0 against
# it at 1.2e-6 on Transformer-base): the card must lie within AMP_MARGIN x
# the distance, where an f32 step lands at about the whole of it. Where
# the sensitivity is as large as the distance (a bf16 step at 12 layers is
# chaotic) the card is held to the larger of the distance and
# AMP_SENSITIVITY_FACTOR x the sensitivity. The card's f32 step, put
# through the same verdict, must fail it.
AMP_SENSITIVITY_FACTOR = 3.0
AMP_MARGIN = 0.5


def _amp_verdict(names, gpu, amp, f32, pert):
    """The verdict on a card step's fetches ``gpu`` against the CPU AMP
    step's ``amp``, as the comment above sets out: {"card", "ref",
    "sens"}: {name: the card's distance, the CPU's AMP-vs-f32 distance,
    the CPU AMP step's sensitivity}; "separating": the names held within
    AMP_MARGIN of the AMP-vs-f32 distance; "not_nearer_than_f32": the
    names whose card distance is not below it; "outside": the names
    outside their limit."""
    def dist(xs):
        return {n: _rel_l2(np.asarray(x), np.asarray(a))
                for n, x, a in zip(names, xs, amp)}

    card, ref, sens = dist(gpu), dist(f32), dist(pert)
    sep = [n for n in names if n == "loss" or
           AMP_SENSITIVITY_FACTOR * sens[n] < AMP_MARGIN * ref[n]]
    limit = {n: AMP_MARGIN * ref[n] if n in sep
             else max(ref[n], AMP_SENSITIVITY_FACTOR * sens[n])
             for n in names}
    return {"card": card, "ref": ref, "sens": sens, "separating": sep,
            "not_nearer_than_f32": sorted(n for n in names
                                          if not card[n] < ref[n]),
            "outside": sorted(n for n in names if not card[n] <= limit[n])}


def _amp_report(v, control):
    """The fields a check phase prints of its verdict ``v`` and of the
    card f32 step's ``control``: the three distances, the separating
    names with their distances, medians and maxima of the card's over the
    other two, and what the control's verdict found outside."""
    card, ref, sens = v["card"], v["ref"], v["sens"]
    names = list(card)
    out = {"card_vs_cpu_amp": card, "cpu_amp_vs_f32": ref,
           "cpu_amp_sensitivity": sens,
           "separating": {n: {"card": card[n], "amp_vs_f32": ref[n],
                              "control_f32_card": control["card"][n]}
                          for n in v["separating"]},
           "not_nearer_than_f32": v["not_nearer_than_f32"],
           "outside_tol": v["outside"],
           "control_f32_card_outside": control["outside"],
           "tol": "separating (loss; %g x sensitivity < %g x AMP-vs-f32): "
                  "card <= %g x CPU AMP vs f32; else card <= max(CPU AMP "
                  "vs f32, %g x sensitivity); the card's f32 step must "
                  "fail" % (AMP_SENSITIVITY_FACTOR, AMP_MARGIN, AMP_MARGIN,
                            AMP_SENSITIVITY_FACTOR)}
    for key, base in (("card_over_amp_vs_f32", ref),
                      ("card_over_sensitivity", sens)):
        r = [card[n] / max(base[n], 1e-30) for n in names]
        out[key] = {"median": float(np.median(r)), "max": max(r),
                    "max_name": names[int(np.argmax(r))]}
    for key, d in (("card_vs_cpu_amp", card), ("cpu_amp_vs_f32", ref),
                   ("cpu_amp_sensitivity", sens)):
        out[key + "_median"] = float(np.median(list(d.values())))
    return out


def _amp_checks(phase, v, control):
    check(not v["outside"], "%s: outside tolerance: %s"
          % (phase, v["outside"]))
    check(control["outside"], "%s: the card's f32 step passed the AMP "
          "check" % phase)


def _float_state_dtypes(torch, scope):
    """The dtypes of the floating tensors a scope holds (parameters and
    optimizer state)."""
    return sorted({str(scope.get(n).dtype) for n in scope.var_names()
                   if isinstance(scope.get(n), torch.Tensor)
                   and scope.get(n).is_floating_point()})


def _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                   want_counts, wgmma=wgmma_part):
    """One step of the AMP-marked ``main`` on the card, then from the same
    parameters one f32 step on the card (the control), one AMP and one
    f32 step with the port on the CPU, and one CPU AMP step on the
    parameters scaled by 1 + 2^-20. The card's AMP step must launch
    ``want_counts``, its kernels with a bf16 form all in bf16; its f32
    step the same counts, none in bf16 (the wgmma forms' launches as
    ``wgmma(counts, amp)`` gives). Returns a dict of the fetches
    ("gpu", "gpu_f32", "amp", "f32", "pert"), the card scope's floating
    dtypes after its AMP step ("dtypes"), the AMP step's launches
    ("counts", "bf16_counts") and the CPU steps' seconds ("cpu_s")."""
    params, out, cpu_s = None, {}, {}
    for key, amp in (("gpu", True), ("gpu_f32", False)):
        (fluid.amp.enable_bf16 if amp else fluid.amp.disable_bf16)(main)
        scope = fluid.Scope()
        exe = fluid.Executor()  # CUDAPlace(0)
        exe.run(startup, scope=scope)
        if params is None:
            params = {n: scope.get(n).cpu().numpy() for n in names}
        else:
            fluid.bridge.load_program_params(scope, params, main)
        reset_counts()
        out[key] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        counts, bf16 = read_counts(), read_bf16_counts()
        wgmma_n = read_wgmma_counts()
        check(counts == want_counts and bf16 == bf16_part(counts, amp)
              and wgmma_n == wgmma(counts, amp),
              "AMP check %s launches %s (bf16 %s, wgmma %s) != %s" % (
                  key, counts, bf16, wgmma, want_counts))
        if amp:
            out.update(dtypes=_float_state_dtypes(torch, scope),
                       counts=counts, bf16_counts=bf16, wgmma_counts=wgmma_n)
    for key, amp, scale in (("amp", True, 1.0), ("f32", False, 1.0),
                            ("pert", True, 1.0 + 2.0 ** -20)):
        (fluid.amp.enable_bf16 if amp else fluid.amp.disable_bf16)(main)
        cpu_scope = fluid.Scope()
        cexe = fluid.Executor(fluid.CPUPlace())
        cexe.run(startup, scope=cpu_scope)
        fluid.bridge.load_program_params(
            cpu_scope, {n: (v * np.float32(scale)).astype(v.dtype)
                        for n, v in params.items()}, main, "cpu")
        t0 = time.perf_counter()
        out[key] = cexe.run(main, feed=feed, fetch_list=fetch,
                            scope=cpu_scope)
        cpu_s[key] = time.perf_counter() - t0
    fluid.amp.enable_bf16(main)
    check(read_counts() == counts, "a CPU step launched a kernel")
    out["cpu_s"] = cpu_s
    return out


def phase_amp_train_check(torch, smi_line, batch=2):
    """One full-width Transformer-base step under ``fluid.amp.decorate``
    (dropout 0, batch 2) on the card, and from the same weights and feed
    the same step in f32 on the card and with the port on the CPU under
    AMP, in f32, and under AMP on the parameters scaled by 1 + 2^-20. The
    card runs the bf16 forms of the flash, LayerNorm and fused CE kernels
    (counted per dtype), the CPU their plain versions, which round where
    the kernels do. The loss and every parameter's gradient are held as
    the comment above ``AMP_SENSITIVITY_FACTOR`` sets out, and the card's
    f32 step must fail that verdict. Every parameter and Adam moment must
    still be f32 after the step."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_transformer(fluid, dropout_rate=0.0,
                                            amp=True)
    names = [p.name for p in main.all_parameters()]
    gb = main.global_block()
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in names]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    seq = TRANSFORMER["seq_len"]
    feed["src_len"] = np.array([seq, seq * 3 // 4][:batch], "int64")
    feed["trg_len"] = np.array([seq, seq * 2 // 3][:batch], "int64")
    r = _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                       PER_STEP)
    runs = [r[k] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(["loss"] + names, r["gpu"], *runs)
    control = _amp_verdict(["loss"] + names, r["gpu_f32"], *runs)
    gpu = r["gpu"]
    emit(dict({"phase": "amp_train_check", "batch": batch,
               "config": TRANSFORMER, "dropout": 0.0,
               "precision": "bf16 (fluid.amp.decorate)",
               "loss_gpu": float(gpu[0]), "loss_gpu_f32": float(
                   r["gpu_f32"][0]), "loss_cpu_amp": float(r["amp"][0]),
               "loss_cpu_f32": float(r["f32"][0]),
               "loss_cpu_amp_perturbed": float(r["pert"][0]),
               "state_dtypes": r["dtypes"], "launches": r["counts"],
               "bf16_launches": r["bf16_counts"],
               "wgmma_launches": r["wgmma_counts"],
               "cpu_amp_step_s": r["cpu_s"]["amp"],
               "cpu_f32_step_s": r["cpu_s"]["f32"], "device": smi_line},
              **_amp_report(v, control)))
    check(np.isfinite([float(gpu[0])]).all() and all(
        np.isfinite(g).all() for g in gpu[1:]),
        "non-finite loss or grads on the card")
    _amp_checks("amp_train_check", v, control)
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])
    return v["card"]


_MARKS = (("flash_fwd_", "flash_attention_fwd"),  # both forms' kernels
          ("flash_bwd_", "flash_attention_bwd"),  # both forms, the prep
          ("conv_apply_wgmma_kernel", "conv_apply"),
          ("conv_moments_wgmma_kernel", "conv_moments"),
          # the wgmma forms' channels-last copy, named for its reader
          ("nchw_to_nhwc_kernel<false>", "conv_apply"),
          ("nchw_to_nhwc_kernel<true>", "conv_moments"),
          ("layer_norm_fwd_kernel", "layer_norm_fwd"),
          ("layer_norm_bwd_", "layer_norm_bwd"),
          ("fused_ce_", "fused_ce_fwd"),
          ("moments_reduce", "conv_moments"),
          ("bn_apply_kernel", "bn_apply"),
          ("scatter_add_kernel", "scatter_add"))
_CUDNN_MARKS = ("convolve", "conv2d", "_conv", "dgrad", "wgrad", "fprop",
                "winograd", "implicit_gemm", "cudnn")


def _kernel_kind(name):
    """The kind of a device kernel by its (lower-case) name: one of the
    port's kernels (``conv_kernel<BM, KS, STRIDE, VEC, APPLY>``: APPLY false
    is conv_moments' main launch, true conv_apply's; the wgmma forms' own
    kernels count with their wrapper's), a cuDNN convolution, a
    GEMM, a row gather (``index_select``, indexing), or other."""
    if "conv_kernel<" in name:
        args = name.split("conv_kernel<", 1)[1].split(">", 1)[0]
        apply = args.replace(" ", "").split(",")[-1]
        check(apply in ("true", "false"), "conv kernel name %r" % name)
        return "conv_apply" if apply == "true" else "conv_moments"
    kind = next((k for m, k in _MARKS if m in name), None)
    if kind is not None:
        return kind
    if any(m in name for m in _CUDNN_MARKS):
        return "cudnn_conv"
    if ("gemm" in name or "cutlass" in name or "xmma" in name
            or "nvjet" in name):  # nvjet: cuBLAS's Hopper bf16 GEMMs
        return "gemm"
    if "indexselect" in name or "gather" in name or "index_kernel" in name:
        return "gather"
    return "other"


def _profile_steps(torch, run_step, steps, counts=None):
    """Device ms per step by kind over ``steps`` training steps under
    torch.profiler, kernels per step, the profiled wall per step, and the
    eight costliest kernels of kind "other" as [name, ms, launches] per
    step; ``counts`` (a dict) gets the device kernels per step by kind (the
    profiler sees the kernels a CUDA graph replays). The window is guarded
    at both edges (``profile_edge``; its kernels are left out): late in a
    whole run an unguarded window read a replayed BERT step one flash and
    one or two LayerNorm kernels short."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_edge(torch, prof)
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        wall = time.perf_counter() - t0
        profile_edge(torch, prof)
    kinds = dict.fromkeys(("gemm", "cudnn_conv", "gather") + KERNELS
                          + ("other",), 0.0)
    n_kernels = 0
    other = []
    for e in prof.key_averages():
        if (not str(getattr(e, "device_type", "")).endswith("CUDA")
                or "spin_kernel" in e.key):   # the edges' guards
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        n_kernels += e.count
        kind = _kernel_kind(e.key.lower())
        kinds[kind] += us
        if counts is not None:
            counts[kind] = counts.get(kind, 0) + e.count / steps
        if kind == "other":
            other.append([e.key[:120], us / steps / 1e3, e.count / steps])
    return ({k: v / steps / 1e3 for k, v in kinds.items()},
            n_kernels / steps, wall / steps * 1e3,
            sorted(other, key=lambda r: -r[1])[:8])


def _interpreted_beside(torch, fluid, startup, run_step, steps,
                        by_op_steps=0):
    """``steps`` timed interpreted steps (``use_program_cache=False``)
    after one untimed, then one profiled, on a scope of their own from the
    same startup (the captured steps then train the model the later
    checks read, as many steps as before): the step ms, device ms, busy
    share and kernels a step beside the captured ones of the same call.
    ``by_op_steps``: also the device time by op kind over that many
    (``_profile_by_op_kind``; a replay runs no ops)."""
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    losses = []

    def step():
        return run_step(exe, False, scope, losses)

    step()
    times = [step() for _ in range(steps)]
    device_ms, kernels, _, _ = _profile_steps(torch, step, 1)
    med = statistics.median(times)
    busy = sum(device_ms.values())
    out = {"steps": steps, "step_ms_median": med * 1e3,
           "step_ms": [x * 1e3 for x in times], "device_ms": busy,
           "device_busy_share": busy / (med * 1e3),
           "kernels_per_step": kernels, "losses": losses}
    if by_op_steps:
        dev, _, _, _ = _profile_steps(torch, step, by_op_steps)
        out["by_op"], out["top_host"] = _profile_by_op_kind(
            torch, step, by_op_steps, dev)
    exe.close()
    return out


def _captured_steps(torch, run_step, steps):
    """The same for ``steps`` captured steps (replays) after the key's
    call 1 and capture have run."""
    times = [run_step() for _ in range(steps)]
    device_ms, kernels, _, _ = _profile_steps(torch, run_step, 1)
    med = statistics.median(times)
    busy = sum(device_ms.values())
    return {"steps": steps, "step_ms_median": med * 1e3,
            "step_ms": [x * 1e3 for x in times], "device_ms": busy,
            "device_busy_share": busy / (med * 1e3),
            "kernels_per_step": kernels}


def phase_train(torch, smi_line, flash_ms, warmup=3, steps=20,
                prof_steps=3, amp=False, interp_steps=0):
    """The main path: Transformer-base trained with dropout 0.1 and
    Adam(1e-4) at 128 x 256 tokens per step on one fixed batch (an
    overfit check), in f32 (phase ``train``) or under
    ``fluid.amp.decorate`` (``amp_train``: the bf16 forms of the flash,
    LayerNorm and fused CE kernels). The executor interprets the key's
    first step, captures the second as one CUDA graph and replays it from
    then on. Launch counts are zeroed just before the first step and read
    after the last; every interpreted or captured step must launch each
    kernel exactly PER_STEP times, under AMP all of them in bf16 and in
    f32 none (counted per dtype), every replay none from Python, and each
    profiled replay the device kernels of the table, kind by kind, that
    the profiled first step launched. The flash kernels' profiled ms per
    step is printed beside ``flash_ms`` (the ``timing`` phase's ms at the
    training shape, in the run's dtype) times their launches per step.
    ``interp_steps``: that many interpreted steps
    (``use_program_cache=False``, on a scope of their own), timed and
    profiled beside the captured ones; then (AMP) captured steps with
    ``PADDLE_TPU_FUSED_OPT=1``."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, spec = build_transformer(fluid, dropout_rate=0.1,
                                            amp=amp)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(TRAIN_BATCH, np.random.RandomState(SEED))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s, runs = [], [], {"launched": 0, "replayed": 0}

    def run_step(ex=exe, cache=True, sc=scope, out=losses):
        (loss,), dt, replayed = counted_step(
            ex, main, PER_STEP, amp, "step %d" % len(out), feed=feed,
            fetch_list=[spec.loss], scope=sc, use_program_cache=cache)
        runs["replayed" if replayed else "launched"] += 1
        out.append(float(loss))  # to numpy: ends synchronised
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    interp = None
    if interp_steps:
        interp = _interpreted_beside(torch, fluid, startup, run_step,
                                     interp_steps)
    # call 1 (interpreted) profiled: the kernels a counted step launches
    call1 = {}
    _profile_steps(torch, run_step, 1, counts=call1)
    for i in range(warmup - 1 + steps):
        dt = run_step()
        if i >= warmup - 1:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels_per_step, prof_wall_ms, top_other = _profile_steps(
        torch, run_step, prof_steps, counts=replay)
    report = exe.step_report(main)
    fused = None
    if interp_steps and amp:
        os.environ["PADDLE_TPU_FUSED_OPT"] = "1"
        try:
            run_step()  # the fused key's call 1
            run_step()  # its capture
            fused = _captured_steps(torch, run_step, 5)
            fused["step_report"] = exe.step_report(main)
            fused["groups"] = len(exe._last[id(main)].plan)
        finally:
            del os.environ["PADDLE_TPU_FUSED_OPT"]
    launches = read_counts()
    exe.close()
    peak_all = torch.cuda.max_memory_allocated()

    tokens = TRAIN_BATCH * TRANSFORMER["seq_len"]
    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    flops = spec.flops_per_example * TRAIN_BATCH
    q1, _, q3 = statistics.quantiles(step_s, n=4)
    phase = "amp_train" if amp else "train"
    emit({"phase": phase, "model": "transformer_base",
          "precision": "bf16 (fluid.amp.decorate)" if amp else "f32",
          "config": dict(TRANSFORMER, dropout_rate=0.1), "params": n_params,
          "batch": TRAIN_BATCH, "tokens_per_step": tokens,
          "optimizer": "Adam(1e-4)", "captured": report["captured"],
          "reason": report["reason"], "step_report": report,
          "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "tokens_per_s": tokens / med,
          "tokens_per_s_range": [tokens / max(step_s), tokens / min(step_s)],
          "tokens_per_s_iqr": [tokens / q3, tokens / q1],
          "model_tflops_per_s": flops / med / 1e12,
          "losses": losses, "peak_memory_bytes": peak,
          "peak_memory_bytes_with_fused_opt": peak_all,
          "device_ms_per_step": device_ms,
          "kernels_per_step": kernels_per_step,
          "top_other_kernels": top_other,
          "profiled_wall_ms_per_step": prof_wall_ms,
          "device_busy_share": busy / (med * 1e3),
          "interpreted": interp, "fused_opt": fused,
          "kernels_by_kind": {"call1": call1, "replay": replay},
          "fused_ce_share_of_device": device_ms["fused_ce_fwd"] / busy,
          "flash_ms_per_step": {
              name: {"profiled": device_ms[name],
                     "timing_x_launches": flash_ms[name] * PER_STEP[name]}
              for name in ("flash_attention_fwd", "flash_attention_bwd")},
          "launches": launches, "bf16_launches": read_bf16_counts(),
          "wgmma_launches": read_wgmma_counts(),
          "launches_per_step": PER_STEP, "steps_by_kind": runs,
          "setup_s": setup_s, "device": smi_line})
    check(report["captured"] and report["replays"] >= steps,
          "%s not captured: %s" % (phase, report))
    check_replay_kernels(phase, call1, replay)
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(device_ms["flash_attention_fwd"] > 0
          and device_ms["flash_attention_bwd"] > 0,
          "profiled flash kernels not recognised: %s" % device_ms)
    check(launches == {k: n * runs["launched"] for k, n in PER_STEP.items()},
          "train launches %s" % launches)
    if amp:
        dtypes = _float_state_dtypes(torch, scope)
        check(dtypes == ["torch.float32"], "AMP state dtypes %s" % dtypes)
    return launches, {k: n * runs["replayed"] for k, n in PER_STEP.items()}


# ---------------------------------------------------------------------------
# ResNet-50: the fused conv + BN (+ residual)(+ relu) kernels
# ---------------------------------------------------------------------------

# ResNet-50's own conv -> BN geometries at batch 128: name, C_in, C_out, k,
# stride, H = W, residual, relu
CONV_GEOMS = [
    ("reduce_1x1_256to64_56", 256, 64, 1, 1, 56, False, True),
    ("body_3x3_64to64_56", 64, 64, 3, 1, 56, False, True),
    ("expand_1x1_64to256_56_res", 64, 256, 1, 1, 56, True, True),
    ("shortcut_1x1s2_256to512_56", 256, 512, 1, 2, 56, False, False),
    ("body_3x3_512to512_7", 512, 512, 3, 1, 7, False, True),
]
RESNET_PER_STEP = per_run(conv_moments=49, bn_apply=49)
RESNET_PER_EVAL = per_run(conv_apply=49)
# the four chains outside supported_geometry, which replay their ops
RESNET_DECLINED = [((64, 3, 7, 7), [2, 2]), ((128, 128, 3, 3), [2, 2]),
                   ((256, 256, 3, 3), [2, 2]), ((512, 512, 3, 3), [2, 2])]


def _conv_case(torch, gen, dev, c, o, k, stride, hw, residual,
               n=RESNET_BATCH):
    """x, w (He-scaled), gamma, beta, moving mean, moving var, residual."""
    ho = (hw - 1) // stride + 1

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    return (randn(n, c, hw, hw), randn(o, c, k, k) * (2.0 / (c * k * k))
            ** 0.5, rand(o) + 0.5, randn(o) * 0.1, randn(o) * 0.1,
            rand(o) + 0.5, randn(n, o, ho, ho) if residual else None)


def phase_fused_conv_check(torch, dev, eps=1e-5, momentum=0.9, tol=1e-4):
    """The three fused-conv kernels against their plain versions at
    ResNet-50's geometries, batch 128, f32, TF32 off: conv_moments (co, and
    the moments as mean and mean square), bn_apply on the plain co, the
    training forward through ``fused_conv_bn_act`` (y, mean_out, var_out,
    saved mean and variance) against the unfused math, ``_FusedTrain``'s
    backward (dx, dw, dgamma, dbeta, dres) against autograd through the
    plain composition (cuDNN's conv), with dy zeroed on both sides where
    the two forwards' relu masks differ (their count is emitted), and
    conv_apply (inference). Tolerance tol * max(1, max|plain|): the conv
    sums up to 4,608 products per output and the moments 401,408 outputs
    per channel, in other orders than cuDNN and torch.sum. Then the moments
    must be bitwise equal across two runs, and at the 3x3 geometries the
    conv's error against an f64 conv at most twice cuDNN's f32 one
    (:func:`_conv_f64_check`). Each geometry also checks the bf16 forms
    (:func:`_fused_conv_bf16_check`), and the bf16 conv_apply's wgmma form
    runs at every fused geometry of ResNet-50
    (:func:`_conv_apply_geometry_check`). Returns the f32 and the bf16
    forms' max abs errors, each {kernel: error}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = dict.fromkeys(("conv_moments", "bn_apply", "conv_apply"), 0.0)
    bf16 = dict(errs)
    for name, c, o, k, stride, hw, residual, relu in CONV_GEOMS:
        x, w, g, b, mean, var, res = _conv_case(torch, gen, dev, c, o, k,
                                                stride, hw, residual)
        pad = (k - 1) // 2
        shape = dict(x=list(x.shape), w=list(w.shape), stride=stride,
                     residual=residual, relu=relu)
        co, s1, s2 = fc.conv_moments(x, w, stride)
        wco, ws1, ws2 = fc.conv_moments_plain(x, w, stride)
        count = wco.numel() // o
        torch.cuda.synchronize()
        errs["conv_moments"] = max(errs["conv_moments"], check_close(
            "fused_conv_check", name, [("co", co, wco),
                                   ("mean", s1 / count, ws1 / count),
                                   ("mean_sq", s2 / count, ws2 / count)],
            tol, check="conv_moments", **shape))
        again = fc.conv_moments(x, w, stride)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((co, s1, s2), again)),
              "%s: conv_moments differs between two runs" % name)
        del co, again
        if k == 3:
            _conv_f64_check(torch, name, x[:8], w, stride)
        bm, bv = fc.bn_stats(wco)
        scale, shift = fc._scale_shift(g, b, bm, bv, eps)
        y = fc.bn_apply(wco, scale, shift, res, relu)
        want = fc.bn_apply_plain(wco, scale, shift, res, relu)
        torch.cuda.synchronize()
        errs["bn_apply"] = max(errs["bn_apply"], check_close(
            "fused_conv_check", name, [("y", y, want)], tol,
            check="bn_apply", **shape))
        del y, want

        outs = fc.fused_conv_bn_act(
            x, w, g, b, mean, var, strides=(stride, stride),
            paddings=(pad, pad), eps=eps, momentum=momentum,
            act="relu" if relu else None, residual=res)
        want = [fc.epilogue_reference(wco, g, b, res, None, None, eps, relu),
                momentum * mean + (1 - momentum) * bm,
                momentum * var + (1 - momentum) * bv, bm, bv]
        torch.cuda.synchronize()
        check_close("fused_conv_check", name, list(zip(
            ("y", "mean_out", "var_out", "saved_mean", "saved_var"), outs,
            want)), tol, check="fused_conv_bn_act_train", **shape)
        del outs, want

        # both forwards first: the kernel's co differs from cuDNN's in the
        # last bits, which flips a few relus, and a flip moves one gradient
        # element by its whole dy; dy is zeroed on both sides where the two
        # relu masks differ, so the rest is held element-wise. The kernel's
        # mask is the one its backward applies: the epilogue recomputed on
        # its co (bn_apply's forward output may round the other way)
        outs = []
        for kernel in (True, False):
            ins = [t.clone().requires_grad_(True)
                   for t in (x, w, g, b, res) if t is not None]
            r = ins[4] if residual else None
            if kernel:
                out = fc._FusedTrain.apply(ins[0], ins[1], ins[2], ins[3], r,
                                           stride, eps, relu)[0]
            else:
                out = fc.epilogue_reference(
                    F.conv2d(ins[0], ins[1], stride=stride, padding=pad),
                    ins[2], ins[3], r, None, None, eps, relu)
            outs.append((out, ins))
        dy = torch.randn(wco.shape, generator=gen, device=dev)
        flips = None
        if relu:
            co = fc.conv_moments(x, w, stride)[0]  # bit-equal to the saved
            keep = (fc.epilogue_reference(co, g, b, res, None, None, eps,
                                          relu) > 0) == (outs[1][0] > 0)
            del co
            flips = int((~keep).sum())
            dy = dy * keep
            del keep
        grads = [torch.autograd.grad(out, ins, dy) for out, ins in outs]
        del outs
        torch.cuda.synchronize()
        check_close("fused_conv_check", name, list(zip(
            ("dx", "dw", "dgamma", "dbeta", "dres"), *grads)), tol,
            check="_FusedTrain_backward", relu_flips=flips,
            elements=dy.numel(), **shape)
        del grads, dy, wco

        scale, shift = fc._scale_shift(g, b, mean, var, eps)
        y = fc.conv_apply(x, w, scale, shift, res, relu, stride)
        want = fc.conv_apply_plain(x, w, scale, shift, res, relu, stride)
        torch.cuda.synchronize()
        errs["conv_apply"] = max(errs["conv_apply"], check_close(
            "fused_conv_check", name, [("y", y, want)], tol,
            check="conv_apply", **shape))
        del y, want
        _fused_conv_bf16_check(torch, name, shape, x, w, g, b, mean, var,
                               res, stride, relu, eps, bf16)
        del x, res
    _conv_apply_geometry_check(torch, dev, bf16)
    return errs, bf16


def _moments_bf16_check(torch, name, xb, wb, stride, errs, shape):
    """The bf16 conv_moments on bf16 inputs in the form its route names
    and, where that is the wgmma form, in the mma.sync form too, against
    its plain version (the f32 conv rounded once, the moments of the
    rounded co): co within one bf16 ulp, 2^-7 of max(1, max|plain|); the
    moments within 1e-5 of an f64 sum over the kernel's own stored co
    (relative to sum |co| and to sum co^2); co and the moments bitwise
    equal across two runs. ``shape``: the geometry's keys for each line.
    Updates ``errs`` (kernel -> max abs error); returns the plain co and
    the route's form."""
    from paddle_tpu_torch.ops import fused_conv as fc

    wco = fc.conv_moments_plain(xb, wb, stride)[0]
    form = fc.moments_form(xb, wb, stride)[0]
    for run in ((form, "mma_sync") if form == "wgmma" else (form,)):
        n_wgmma = fc.conv_moments.wgmma_launches
        with (mma_sync_route(fc, "moments_form") if run != form
              else contextlib.nullcontext()):
            co, s1, s2 = fc.conv_moments(xb, wb, stride)
            again = fc.conv_moments(xb, wb, stride)
        torch.cuda.synchronize()
        check(fc.conv_moments.wgmma_launches - n_wgmma
              == (2 if run == "wgmma" else 0),
              "%s bf16 conv_moments did not run its %s form" % (name, run))
        c = co.double()
        sums = (c.sum((0, 2, 3)), (c * c).sum((0, 2, 3)))
        rel = [((got.double() - want).abs() / scale_).max().item()
               for got, want, scale_ in (
                   (s1, sums[0], c.abs().sum((0, 2, 3))),
                   (s2, sums[1], sums[1]))]
        emit(dict({"phase": "fused_conv_check", "case": name + "_bf16",
                   "check": "conv_moments_bf16_sums_" + run,
                   "sum_rel_err": rel[0], "sum_sq_rel_err": rel[1],
                   "tol": "1e-5 of sum|co| and of sum co^2, f64 over the "
                          "kernel's own co"}, **shape))
        check(max(rel) <= 1e-5, "%s bf16 moments (%s) %s" % (name, run,
                                                              rel))
        check(all(torch.equal(p, q) for p, q in zip((co, s1, s2), again)),
              "%s: bf16 conv_moments (%s) differs between two runs"
              % (name, run))
        del c, sums, again
        errs["conv_moments"] = max(errs["conv_moments"], check_close(
            "fused_conv_check", name + "_bf16", [("co", co, wco)], 2.0 ** -7,
            check="conv_moments_bf16_" + run, **shape))
        del co
    return wco, form


def _fused_conv_bf16_check(torch, name, shape, x, w, g, b, mean, var, res,
                           stride, relu, eps, errs):
    """The bf16 forms (ResNet-50 under fluid.amp) of the three kernels on
    the bf16 roundings of one geometry's inputs, against their plain
    versions (the f32 conv rounded once; the affine, then the residual add,
    each rounded to bf16): co and y within one bf16 ulp, 2^-7 of
    max(1, max|plain|); the moments within 1e-5 of an f64 sum over the
    kernel's own stored co (relative to sum |co| and to sum co^2), bitwise
    equal across two runs; co against an f64 conv of the same bf16 inputs
    at most 1.5x the plain bf16 version's error (:func:`_conv_f64_check`);
    conv_moments and conv_apply in both their forms (the wgmma form their
    routes name here, and the mma.sync form). Updates ``errs`` (kernel ->
    max abs error)."""
    from paddle_tpu_torch.ops import fused_conv as fc

    tol = 2.0 ** -7
    xb, wb = x.bfloat16(), w.bfloat16()
    rb = res.bfloat16() if res is not None else None
    wco = _moments_bf16_check(torch, name, xb, wb, stride, errs, shape)[0]
    _conv_f64_check(torch, name + "_bf16", xb[:8], wb, stride)
    bm, bv = fc.bn_stats(wco)
    scale, shift = fc._scale_shift(g, b, bm, bv, eps)
    y = fc.bn_apply(wco, scale, shift, rb, relu)
    want = fc.bn_apply_plain(wco, scale, shift, rb, relu)
    torch.cuda.synchronize()
    errs["bn_apply"] = max(errs["bn_apply"], check_close(
        "fused_conv_check", name + "_bf16", [("y", y, want)], tol,
        check="bn_apply_bf16", **shape))
    del y, want, wco
    scale, shift = fc._scale_shift(g, b, mean, var, eps)
    want = fc.conv_apply_plain(xb, wb, scale, shift, rb, relu, stride)
    for form in ("wgmma", "mma_sync"):
        n_wgmma = fc.conv_apply.wgmma_launches
        if form == "wgmma":
            y = fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
        else:
            with mma_sync_route(fc, "apply_form"):
                y = fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
        torch.cuda.synchronize()
        check((fc.conv_apply.wgmma_launches > n_wgmma) == (form == "wgmma"),
              "%s bf16 conv_apply did not run its %s form" % (name, form))
        errs["conv_apply"] = max(errs["conv_apply"], check_close(
            "fused_conv_check", name + "_bf16", [("y", y, want)], tol,
            check="conv_apply_bf16_" + form, **shape))


def _conv_f64_check(torch, name, x, w, stride, apply=False):
    """The conv kernel's co against F.conv2d in float64 on the same inputs,
    by max abs error and relative L2 error, beside a yardstick on the same
    inputs. f32: cuDNN's f32 conv (TF32 off), and the kernel's error at
    most twice its in either (3xTF32 with f32 accumulation should match
    f32; a single TF32 product would be about 1000 times off). bf16: the
    plain bf16 version (the f32 conv rounded once), and the kernel's error
    at most 1.5x its (both are the bf16 rounding of co). ``apply``: the
    kernel is conv_apply with scale 1 and shift 0 (no residual, no relu),
    whose y is then its rounded conv, in the form its route names."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    pad = (w.shape[2] - 1) // 2
    exact = F.conv2d(x.double(), w.double(), stride=stride, padding=pad)

    def errs(t):
        d = t.double() - exact
        return {"max_abs_err": d.abs().max().item(),
                "rel_l2": (d.norm() / exact.norm()).item()}

    if apply:
        o = w.shape[0]
        ones = torch.ones(o, device=x.device)
        got = errs(fc.conv_apply(x, w, ones, ones * 0, None, False, stride))
    else:
        got = errs(fc.conv_moments(x, w, stride)[0])
    if x.dtype == torch.bfloat16:
        lib, what, factor = errs(fc.conv_moments_plain(x, w, stride)[0]), \
            "plain_bf16", 1.5
    else:
        lib, what, factor = errs(F.conv2d(x, w, stride=stride,
                                          padding=pad)), "cudnn_f32", 2.0
    emit({"phase": "fused_conv_check", "case": name, "check": "f64",
          "kernel_name": "conv_apply" if apply else "conv_moments",
          "x": list(x.shape), "w": list(w.shape),
          "K": w.shape[1] * w.shape[2] * w.shape[3], "kernel": got,
          what: lib, "ratio": {e: got[e] / max(lib[e], 1e-300) for e in got},
          "tol": "kernel <= %g x %s, each error" % (factor, what)})
    check(all(got[e] <= factor * lib[e] for e in got),
          "%s: conv error %s against f64, %s %s" % (name, got, what, lib))


# the wgmma conv_moments' masking cases beside ResNet-50's geometries:
# name, N, C, O, k, stride, H = W. Slots of a tile that no output pixel
# fills hold values that are not zero, and the moments must skip them:
# rows past Ho in the last row tile (30x30: rows of 8, rows 30-31 read
# input row 29 through the dy = 0 tap), images past N in the last image
# tile (7x7: tiles of 5 images), a stage's slots past the box (14x14:
# 196 of 256, read through the channels-last copy, 196 % 8 != 0), pixels
# past H*W in the last 256-pixel tile of the NCHW path (28x28: 784 = 3 x
# 256 + 16), and a 1x1 stride-2 conv's copy of every other pixel
WGMMA_MOMENTS_CASES = [
    ("rows_past_ho_3x3_64to64_30", 4, 64, 64, 3, 1, 30),
    ("images_past_n_3x3_512to512_7_n7", 7, 512, 512, 3, 1, 7),
    ("copy_path_1x1_1024to256_14", 3, 1024, 256, 1, 1, 14),
    ("nchw_ragged_1x1_512to128_28", 3, 512, 128, 1, 1, 28),
    ("stride2_1x1s2_256to512_56", 3, 256, 512, 1, 2, 56),
]


def _conv_apply_geometry_check(torch, dev, errs):
    """The bf16 conv_apply and conv_moments at every distinct fused
    geometry of ResNet-50 (read from the fusion's record, batch 128, a
    residual and relu where a site of the geometry has them), in the form
    their routes name, which must be the wgmma form at every one:
    conv_apply's y against the plain bf16 version within one bf16 ulp,
    2^-7 of max(1, max|plain|), and its rounded conv against an f64 conv
    of the same bf16 inputs (8 images) at most 1.5x the plain bf16
    version's error (:func:`_conv_f64_check`); conv_moments in both its
    forms (:func:`_moments_bf16_check`), there and at
    ``WGMMA_MOMENTS_CASES``. Updates ``errs`` (kernel -> max abs error)."""
    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for name, n, c, o, k, stride, hw in WGMMA_MOMENTS_CASES:
        x, w = _conv_case(torch, gen, dev, c, o, k, stride, hw, False,
                          n=n)[:2]
        xb, wb = x.bfloat16(), w.bfloat16()
        del x, w
        form = _moments_bf16_check(torch, name, xb, wb, stride, errs, dict(
            x=list(xb.shape), w=list(wb.shape), stride=stride))[1]
        check(form == "wgmma", "conv_moments %s: form %s" % (name, form))
        del xb, wb
    geoms = resnet_conv_geometries()
    for (c, o, k, stride, hw), g in geoms.items():
        residual, relu = g["residual"] > 0, g["relu"] > 0
        x, w, gm, b, mean, var, res = _conv_case(torch, gen, dev, c, o, k,
                                                 stride, hw, residual)
        xb, wb = x.bfloat16(), w.bfloat16()
        rb = res.bfloat16() if res is not None else None
        del x, w, res
        scale, shift = fc._scale_shift(gm, b, mean, var, 1e-5)
        name = "%dx%d%s_%dto%d_%d" % (k, k, "s2" if stride == 2 else "", c,
                                      o, hw)
        form = fc.apply_form(xb, wb, stride, rb)
        check(form[0] == "wgmma", "conv_apply %s: form %s" % (name, form))
        n_wgmma = fc.conv_apply.wgmma_launches
        y = fc.conv_apply(xb, wb, scale, shift, rb, relu, stride)
        want = fc.conv_apply_plain(xb, wb, scale, shift, rb, relu, stride)
        torch.cuda.synchronize()
        check(fc.conv_apply.wgmma_launches == n_wgmma + 1,
              "conv_apply %s did not launch its wgmma form" % name)
        errs["conv_apply"] = max(errs["conv_apply"], check_close(
            "fused_conv_check", name + "_bf16", [("y", y, want)], 2.0 ** -7,
            check="conv_apply_bf16_wgmma", x=list(xb.shape),
            w=list(wb.shape), stride=stride, residual=residual, relu=relu,
            sites=g["sites"]))
        del y, want
        _conv_f64_check(torch, name + "_bf16_wgmma", xb[:8], wb, stride,
                        apply=True)
        form = _moments_bf16_check(torch, name, xb, wb, stride, errs, dict(
            x=list(xb.shape), w=list(wb.shape), stride=stride,
            sites=g["sites"]))[1]
        check(form == "wgmma", "conv_moments %s: form %s" % (name, form))
        del xb, wb, rb


def resnet_conv_geometries():
    """ResNet-50's distinct fused-conv geometries, read from the epilogue
    fusion's record of the built training program: {(C, O, k, stride, H):
    {"sites", "residual", "relu"}} over the sites the gate admits, in the
    order they first appear (H is the input's height and width)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import fused_ops
    from paddle_tpu_torch.ops import fused_conv as fc

    main, _, _, spec = build_resnet(fluid)
    ops, _ = fused_ops(main, [spec.loss.name])
    geoms = {}
    for op in ops:
        if op.type != "fused_conv2d":
            continue
        xs = (RESNET_BATCH,) + tuple(op.input("Input").shape[1:])
        ws = op.input("Filter").shape
        if not fc.gate(xs, ws, op.attr("strides"), op.attr("paddings"),
                       op.attr("dilations"), op.attr("groups"))["admitted"]:
            continue
        key = (int(xs[1]), int(ws[0]), int(ws[2]), int(op.attr("strides")[0]),
               int(xs[2]))
        g = geoms.setdefault(key, {"sites": 0, "residual": 0, "relu": 0})
        g["sites"] += 1
        g["residual"] += op.input("Residual") is not None
        g["relu"] += op.attr("act") == "relu"
    return geoms


def _on_mma_sync(route, fn):
    """fn's time with the bf16 fused conv's ``route`` (apply_form,
    moments_form) sending it to its mma.sync form."""
    from paddle_tpu_torch.ops import fused_conv as fc

    with mma_sync_route(fc, route):
        return time_ms(fn, iters=20)


def _conv_geometry_timing(torch, dev, gen):
    """Rows 10 and 12 at every distinct fused geometry of ResNet-50 at batch
    128 beside their plain versions, F.conv2d (cuDNN, TF32 off) and the
    bound, in f32 and in bf16 (the AMP forms, beside cuDNN's bf16 conv and
    the bf16 bound: products at 989 TFLOP/s against bf16 x, w and out;
    the bf16 conv_moments and conv_apply in both their forms, the wgmma
    form their routes name and the mma.sync form); one line per geometry
    and one with the sums weighted by sites.
    conv_apply takes a residual and relu where any site of the geometry
    does. Returns (the body's timings, the site-weighted sums)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_conv as fc

    geoms = resnet_conv_geometries()
    n = RESNET_BATCH
    names = ("conv_moments", "conv_apply", "conv_moments_plain",
             "conv_apply_plain", "f_conv2d", "bound", "conv_moments_bf16",
             "conv_moments_mma_sync_bf16", "conv_apply_bf16",
             "conv_apply_mma_sync_bf16",
             "conv_moments_plain_bf16", "conv_apply_plain_bf16",
             "f_conv2d_bf16", "bound_bf16")
    total = dict.fromkeys(names, 0.0)
    body = None
    for (c, o, k, stride, hw), g in geoms.items():
        residual, relu = g["residual"] > 0, g["relu"] > 0
        x, w, gm, b, mean, var, res = _conv_case(torch, gen, dev, c, o, k,
                                                 stride, hw, residual)
        scale, shift = fc._scale_shift(gm, b, mean, var, 1e-5)
        pad = (k - 1) // 2
        ho = (hw - 1) // stride + 1
        out = n * o * ho * ho
        conv_flops = 2 * out * c * k * k
        nbytes = 4 * (x.numel() + w.numel() + out + 2 * o)
        bnd, by, bnd_fma = tensor_core_bound(nbytes, conv_flops)
        t = dict(
            conv_moments=time_ms(lambda: fc.conv_moments(x, w, stride),
                                 iters=20),
            conv_apply=time_ms(lambda: fc.conv_apply(
                x, w, scale, shift, res, relu, stride), iters=20),
            conv_moments_plain=time_ms(
                lambda: fc.conv_moments_plain(x, w, stride), iters=20),
            conv_apply_plain=time_ms(lambda: fc.conv_apply_plain(
                x, w, scale, shift, res, relu, stride), iters=20),
            f_conv2d=time_ms(lambda: F.conv2d(x, w, stride=stride,
                                              padding=pad), iters=20),
            bound=bnd)
        xb, wb = x.bfloat16(), w.bfloat16()
        rb = res.bfloat16() if res is not None else None
        nbytes_bf16 = 2 * (x.numel() + w.numel() + out) + 4 * 2 * o
        t.update(
            conv_moments_bf16=time_ms(lambda: fc.conv_moments(xb, wb, stride),
                                      iters=20),
            conv_moments_mma_sync_bf16=_on_mma_sync(
                "moments_form", lambda: fc.conv_moments(xb, wb, stride)),
            conv_apply_bf16=time_ms(lambda: fc.conv_apply(
                xb, wb, scale, shift, rb, relu, stride), iters=20),
            conv_apply_mma_sync_bf16=_on_mma_sync(
                "apply_form", lambda: fc.conv_apply(
                    xb, wb, scale, shift, rb, relu, stride)),
            conv_moments_plain_bf16=time_ms(
                lambda: fc.conv_moments_plain(xb, wb, stride), iters=20),
            conv_apply_plain_bf16=time_ms(lambda: fc.conv_apply_plain(
                xb, wb, scale, shift, rb, relu, stride), iters=20),
            f_conv2d_bf16=time_ms(lambda: F.conv2d(xb, wb, stride=stride,
                                                   padding=pad), iters=20),
            bound_bf16=bf16_bound(nbytes_bf16, conv_flops)[0])
        for key in names:
            total[key] += g["sites"] * t[key]
        emit(dict({"phase": "conv_geometry",
                   "geometry": "%dx%d%s %d->%d @%d" % (
                       k, k, " s2" if stride == 2 else "", c, o, hw),
                   "x": [n, c, hw, hw], "w": [o, c, k, k], "stride": stride,
                   "sites": g["sites"], "residual_sites": g["residual"],
                   "relu_sites": g["relu"], "apply_residual": residual,
                   "apply_relu": relu, "bound_by": by,
                   "bound_ms_f32_fma": bnd_fma, "flops": conv_flops,
                   "bytes": nbytes,
                   "conv_moments_tflops": conv_flops / t["conv_moments"]
                   / 1e9,
                   "moments_over_f_conv2d": t["conv_moments"]
                   / t["f_conv2d"],
                   "apply_over_f_conv2d": t["conv_apply"] / t["f_conv2d"],
                   "bytes_bf16": nbytes_bf16,
                   "bound_by_bf16": bf16_bound(nbytes_bf16, conv_flops)[1],
                   "moments_bf16_over_f_conv2d_bf16":
                       t["conv_moments_bf16"] / t["f_conv2d_bf16"],
                   "apply_bf16_over_f_conv2d_bf16":
                       t["conv_apply_bf16"] / t["f_conv2d_bf16"],
                   "moments_form_bf16": fc.moments_form(xb, wb, stride)[0],
                   "apply_form_bf16": fc.apply_form(xb, wb, stride, rb)[0]},
                  **t))
        if (c, o, k, stride, hw) == (64, 64, 3, 1, 56):
            body = dict(t, bound_by=by, bound_ms_f32_fma=bnd_fma,
                        shape=[n, c, hw, hw, o, k], bytes=nbytes,
                        flops=conv_flops, bytes_bf16=nbytes_bf16,
                        bound_by_bf16=bf16_bound(nbytes_bf16,
                                                 conv_flops)[1])
        del x, w, res, xb, wb, rb
    sites = sum(g["sites"] for g in geoms.values())
    emit({"phase": "conv_geometry_sum", "geometries": len(geoms),
          "sites": sites, "site_weighted_ms": total})
    check(sites == RESNET_PER_STEP["conv_moments"] and body is not None,
          "fused-conv geometries: %d sites, body found %s" % (
              sites, body is not None))
    return body, total


def _conv_kernel_timing(torch, dev):
    """The three fused-conv kernels, batch 128, f32: rows 10 and 12 on the
    3x3 64 -> 64 body at 56x56 (and at every fused geometry of ResNet-50,
    see :func:`_conv_geometry_timing`), row 11 on the 256-channel expand at
    56x56 with residual and relu. The library yardstick of rows 10 and 12
    is cuDNN's F.conv2d alone (TF32 off): no single PyTorch call computes
    the conv with its moments or with a folded BN. Their bound is the
    tensor cores' (3xTF32), the f32 FMA bound beside it."""
    from paddle_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    body, total = _conv_geometry_timing(torch, dev, gen)
    rows = {}
    for name, lib in (("conv_moments", "moments"),
                      ("conv_apply", "folded BN")):
        rows[name] = dict(
            ms=body[name], plain_ms=body[name + "_plain"],
            library_ms=body["f_conv2d"],
            library="F.conv2d alone (cuDNN, TF32 off): conv only, no " + lib,
            bound_ms=body["bound"], bound_by=body["bound_by"],
            bound_ms_f32_fma=body["bound_ms_f32_fma"], shape=body["shape"],
            bytes=body["bytes"], flops=body["flops"],
            site_weighted_ms=total[name],
            bf16=dict(ms=body[name + "_bf16"],
                      plain_ms=body[name + "_plain_bf16"],
                      library_ms=body["f_conv2d_bf16"],
                      library="F.conv2d alone on bf16 (cuDNN): conv only, "
                              "no " + lib,
                      bound_ms=body["bound_bf16"],
                      bound_by=body["bound_by_bf16"], shape=body["shape"],
                      bytes=body["bytes_bf16"], flops=body["flops"],
                      site_weighted_ms=total[name + "_bf16"],
                      site_weighted_library_ms=total["f_conv2d_bf16"],
                      site_weighted_bound_ms=total["bound_bf16"]))
    for name in ("conv_moments", "conv_apply"):
        rows[name]["bf16"].update(
            mma_sync_ms=body[name + "_mma_sync_bf16"],
            site_weighted_mma_sync_ms=total[name + "_mma_sync_bf16"])
    n, hw = RESNET_BATCH, 56
    o = 256
    co = torch.randn(n, o, hw, hw, generator=gen, device=dev)
    res = torch.randn(n, o, hw, hw, generator=gen, device=dev)
    scale = torch.rand(o, generator=gen, device=dev) + 0.5
    shift = torch.randn(o, generator=gen, device=dev)
    nbytes = 4 * (3 * co.numel() + 2 * o)
    bnd, by = bound(nbytes, 3 * co.numel())
    rows["bn_apply"] = dict(
        ms=time_ms(lambda: fc.bn_apply(co, scale, shift, res, True)),
        plain_ms=time_ms(lambda: fc.bn_apply_plain(co, scale, shift, res,
                                                   True)),
        library_ms=None, library="none: no single PyTorch call applies a "
        "per-channel affine, a residual add and relu",
        bound_ms=bnd, bound_by=by, shape=[n, o, hw, hw], bytes=nbytes,
        flops=3 * co.numel())
    cob, resb = co.bfloat16(), res.bfloat16()
    nbytes = 2 * 3 * co.numel() + 4 * 2 * o
    bnd, by = bound(nbytes, 3 * co.numel())
    rows["bn_apply"]["bf16"] = dict(
        ms=time_ms(lambda: fc.bn_apply(cob, scale, shift, resb, True)),
        plain_ms=time_ms(lambda: fc.bn_apply_plain(cob, scale, shift, resb,
                                                   True)),
        library_ms=None, library="none: no single PyTorch call applies a "
        "per-channel affine, a residual add and relu",
        bound_ms=bnd, bound_by=by, shape=[n, o, hw, hw], bytes=nbytes,
        flops=3 * co.numel())
    return rows


# ---------------------------------------------------------------------------
# DeepFM: sparse (rows, values) gradients and the row scatter-add kernel
# ---------------------------------------------------------------------------

DEEPFM_PER_STEP = per_run(scatter_add=1)


def _deepfm_rows(torch, kind, n, v, seed):
    """int32 ids for ``n`` slots of a ``v``-row table: uniform, in
    [-2v, 2v) (wrap and drop), all on row 7, or Zipf-skewed (exponent 1.2,
    folded into [0, v): the shape of real CTR id traffic)."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        r = rng.randint(0, v, n)
    elif kind == "wrap_drop":
        r = rng.randint(-2 * v, 2 * v, n)
    elif kind == "one_row":
        r = np.full(n, 7)
    else:
        r = (rng.zipf(1.2, n) - 1) % v
    return torch.from_numpy(r.astype("i4"))


def phase_scatter_check(torch, dev, tol=1e-5):
    """The scatter kernel against its plain version (``index_add``, f32) on
    the card at the DeepFM shape (851,968 slots into a 100000 x 32 table):
    the densify form into zeros, the SGD form into a non-zero table, rows
    in [-2V, 2V), every slot on one row, and Zipf-skewed rows. Both sum a
    row's duplicates with atomics in no fixed order, so they are held to
    tol * max(1, sum over the row's slots of |vals|), the scale of a few
    ulp per duplicate; each is also measured against an f64 sum."""
    from paddle_tpu_torch.ops import scatter as sc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    v, k = DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH
    n = DEEPFM_BATCH * DEEPFM["num_fields"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    # name, ids, non-zero table, K, table 16-byte aligned, merged first
    # (sort=True: duplicates summed, their slots parked on the sentinel V)
    cases = [("deepfm_densify_uniform", "uniform", False, k, True, False),
             ("sgd_nonzero_base", "uniform", True, k, True, False),
             ("wrap_drop", "wrap_drop", False, k, True, False),
             ("one_row", "one_row", False, k, True, False),
             ("zipf_1.2", "zipf", False, k, True, False),
             ("zipf_1.2_sorted", "zipf", False, k, True, True),
             ("zipf_1.2_k4_unaligned", "zipf", True, 4, False, False),
             ("zipf_1.2_k33", "zipf", True, 33, True, False)]
    for i, (name, kind, nonzero, k, aligned, sort) in enumerate(cases):
        rows = _deepfm_rows(torch, kind, n, v, SEED + i).to(dev)
        vals = torch.randn(n, k, generator=gen, device=dev)
        base = (torch.randn(v, k, generator=gen, device=dev) if nonzero
                else torch.zeros(v, k, device=dev))
        if aligned:
            got = sc.scatter_add_rows(base, rows, vals, sort=sort)
        else:  # added in place into a table one float past an alignment
            got = torch.empty(v * k + 1, device=dev)[1:].view(v, k)
            got.copy_(base)
            sc.scatter_add_rows(got, rows, vals, sort=sort, inplace=True)
        want = sc.scatter_add_plain(base, rows, vals)
        exact = sc.scatter_add_plain(base.double(), rows, vals.double())
        mass = sc.scatter_add_plain(torch.zeros(v, k, device=dev), rows,
                                    vals.abs())
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = (err / mass.clamp_min(1.0)).max().item()
        r = rows.long()
        r = torch.where(r < 0, r + v, r)
        hot = torch.bincount(r[(r >= 0) & (r < v)], minlength=v).max().item()
        errs[name] = err.max().item()
        emit({"phase": "scatter_check", "case": name, "rows": kind,
              "shape": [v, k, n], "nonzero_base": nonzero, "sort": sort,
              "plan": list(sc.scatter_plan(n, k, aligned, sms)),
              "max_abs_err": errs[name], "max_err_over_row_mass": rel,
              "kernel_vs_f64": (got.double() - exact).abs().max().item(),
              "plain_vs_f64": (want.double() - exact).abs().max().item(),
              "hottest_row_slots": hot,
              "tol": "%g * max(1, sum over the row's slots of |vals|)" % tol})
        check(rel <= tol, "scatter %s: error %g of the row mass > %g"
              % (name, rel, tol))
        del got, want, exact, mass
    return errs


def _scatter_kernel_timing(torch, dev, batch=DEEPFM_BATCH):
    """Row 13 at the DeepFM shape: ``batch`` x 26 uniform ids (851,968 at
    the training batch) into the 100000 x 32 f32 table, added in place as
    the densify adds them (the table stays allocated, so every run adds
    into it). Beside it the plain version,
    one ``index_add_`` on the in-range int64 rows as the library
    yardstick (timed here only; the port never calls it), the bound, and
    the kernel on Zipf-skewed ids with their own bound (the bytes of the
    rows they touch)."""
    from paddle_tpu_torch.ops import scatter as sc

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    v, k = DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH
    n = batch * DEEPFM["num_fields"]
    rows = _deepfm_rows(torch, "uniform", n, v, SEED).to(dev)
    zipf = _deepfm_rows(torch, "zipf", n, v, SEED).to(dev)
    rows64 = rows.long()
    vals = torch.randn(n, k, generator=gen, device=dev)
    out = torch.zeros(v, k, device=dev)
    nbytes = 4 * (n * k + n + 2 * v * k)
    bnd, by = bound(nbytes, n * k)
    touched = int(torch.unique(zipf).numel())
    z_bytes = 4 * (n * k + n + 2 * touched * k)
    z_bnd, _ = bound(z_bytes, n * k)
    row = dict(
        ms=time_ms(lambda: sc.scatter_add(out, rows, vals)),
        plain_ms=time_ms(lambda: sc.scatter_add_plain(out, rows, vals,
                                                      inplace=True)),
        library_ms=time_ms(lambda: out.index_add_(0, rows64, vals)),
        library="Tensor.index_add_ (int64 rows, all in range)",
        zipf_ms=time_ms(lambda: sc.scatter_add(out, zipf, vals)),
        zipf_bound_ms=z_bnd, zipf_rows_touched=touched, zipf_bytes=z_bytes,
        bound_ms=bnd, bound_by=by, shape=[v, k, n], bytes=nbytes,
        flops=n * k)
    return {"scatter_add": row}


def _ln_fwd_timing(torch, dev):
    """Row 7, f32, at the served shape ``LN_SERVED`` with the training
    shape ``LN_TRAINED`` in ``trained_shape``: each beside its plain
    version, ``F.layer_norm`` as a yardstick (timed here only; the port
    never calls it) and its bound."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED + 3)
    out = {}
    for key, (n, hd) in (("served", LN_SERVED), ("trained", LN_TRAINED)):
        x = torch.randn(n, hd, generator=gen).to(dev)
        g = torch.randn(hd, generator=gen).to(dev)
        bb = torch.randn(hd, generator=gen).to(dev)
        nbytes = 4 * (2 * n * hd + 2 * hd + 2 * n)
        flops = 8 * n * hd
        bnd, by = bound(nbytes, flops)
        out[key] = dict(
            ms=time_ms(lambda: fln.layer_norm_fwd(x, g, bb, 1e-5)),
            plain_ms=time_ms(lambda: fln.layer_norm_plain(x, g, bb, 1e-5)),
            library_ms=time_ms(lambda: F.layer_norm(x, (hd,), g, bb, 1e-5)),
            library="F.layer_norm", bound_ms=bnd, bound_by=by,
            shape=[n, hd], bytes=nbytes, flops=flops)
    out["served"]["trained_shape"] = out["trained"]
    return {"layer_norm_fwd": out["served"]}


def bandwidth_kernel_timing(torch, dev):
    """Rows 7 and 13, the kernels bound by bytes: ``_ln_fwd_timing`` and
    ``_scatter_kernel_timing``, through the wrappers' own API only, so
    ``tools/bandwidth_ab.py`` times another checkout's kernels through this
    function."""
    rows = _ln_fwd_timing(torch, dev)
    rows.update(_scatter_kernel_timing(torch, dev))
    return rows


def ln_bwd_bf16_timing(torch, dev):
    """Row 8's bf16 form at Transformer-base's training shape
    ``LN_TRAINED`` (bf16 x and dy, f32 gamma), through the wrappers' own
    API only, beside ``F.layer_norm``'s backward on the same bf16 inputs:
    ``tools/bandwidth_ab.py`` times another checkout's kernel through this
    function."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layer_norm as fln

    gen = torch.Generator().manual_seed(SEED + 4)
    n, hd = LN_TRAINED
    bf = torch.bfloat16
    x = torch.randn(n, hd, generator=gen).to(dev, bf)
    dy = torch.randn(n, hd, generator=gen).to(dev, bf)
    g = torch.randn(hd, generator=gen).to(dev)
    bb = torch.randn(hd, generator=gen).to(dev)
    _, mean, var = fln.layer_norm_fwd(x, g, bb, 1e-5)
    l_in = [x.clone().requires_grad_(True),
            g.to(bf).clone().requires_grad_(True),
            bb.to(bf).clone().requires_grad_(True)]
    l_out = F.layer_norm(l_in[0], (hd,), l_in[1], l_in[2], 1e-5)
    return {"ms": time_ms(lambda: fln.layer_norm_bwd(x, g, mean, var, dy,
                                                     1e-5)),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                l_out, l_in, dy, retain_graph=True)),
            "shape": [n, hd]}


def _add_bandwidth_plans(torch, dev, rows):
    """The plans rows 7 and 13 ran under in ``bandwidth_kernel_timing``,
    into their rows (``plan``)."""
    from paddle_tpu_torch.ops import fused_layer_norm as fln
    from paddle_tpu_torch.ops import scatter as sc

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ln = rows["layer_norm_fwd"]
    for r, (n, hd) in ((ln, LN_SERVED), (ln["trained_shape"], LN_TRAINED)):
        r["plan"] = list(fln.ln_fwd_plan(n, hd, torch.float32, sms))
    v, k, n = rows["scatter_add"]["shape"]
    rows["scatter_add"]["plan"] = list(sc.scatter_plan(n, k, True, sms))


def build_deepfm(fluid, amp=False):
    """DeepFM with Adam(1e-4), as paddle_tpu's bench.py trains it, in fresh
    programs, in f32 or under ``amp.decorate``. Returns (main, startup,
    spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.deepfm.deepfm(**DEEPFM)
        _optimizer(fluid, amp).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, spec


def phase_deepfm_train_check(torch, smi_line, batch=64, lr=1e-4,
                             grad_tol=1e-5):
    """One full-width DeepFM step at batch 64 on the card and with the
    port on the CPU from the same weights and feed (f32, TF32 off): the
    loss within 1e-5 relative, ``prob`` within 1e-5 absolute; the sparse
    grad of the table with equal rows and its values within ``grad_tol``
    in relative L2, and each parameter's Adam first moment after the step
    ((1 - beta1) * g, the table's being the kernel's densify) within
    ``grad_tol`` in relative L2: these see the gradient's magnitude, which
    Adam's first update all but drops. Each parameter's update (after -
    before) within 1e-3 in relative L2 and within lr on every element:
    that update is about lr * sign(g), so an element whose gradient is
    within rounding of zero may part by up to lr. The padding columns
    17..31 of the table must stay exactly zero on both."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_deepfm(fluid)
    gb = main.global_block()
    names = [p.name for p in main.all_parameters()]
    moment1 = {o.input("Param").name: o.input("Moment1").name
               for o in gb.ops if o.type == "adam"}
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    fetch = [spec.loss, spec.fetches["prob"], gb.var("fm_table@GRAD@ROWS"),
             gb.var("fm_table@GRAD")]
    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == DEEPFM_PER_STEP, "deepfm_train_check launches %s != %s"
          % (counts, DEEPFM_PER_STEP))
    gpu_after = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    gpu_m1 = {n: gpu_scope.get(m).cpu().numpy() for n, m in moment1.items()}

    cpu_scope = fluid.Scope()
    cexe = fluid.Executor(fluid.CPUPlace())
    cexe.run(startup, scope=cpu_scope)
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    t0 = time.perf_counter()
    cpu = cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    check(read_counts() == counts, "the CPU step launched a kernel")
    cpu_after = {n: cpu_scope.get(n).numpy() for n in names}
    cpu_m1 = {n: cpu_scope.get(m).numpy() for n, m in moment1.items()}

    upd = {}
    for n in names:
        du_g, du_c = gpu_after[n] - params[n], cpu_after[n] - params[n]
        upd[n] = (float(np.linalg.norm(du_g - du_c)) / max(
            float(np.linalg.norm(du_c)), 1e-30),
            float(np.abs(du_g - du_c).max()))
    m1 = {n: _rel_l2(gpu_m1[n], cpu_m1[n]) for n in moment1}
    rows_equal = bool(np.array_equal(gpu[2], cpu[2]))
    errs = {"loss": abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            "prob": float(np.abs(gpu[1] - cpu[1]).max()),
            "sparse_grad_rel_l2": _rel_l2(gpu[3], cpu[3]),
            "moment1_rel_l2_max": max(m1.values())}
    used = DEEPFM["embedding_size"] + 1
    pad_zero = [not a["fm_table"][:, used:].any()
                for a in (gpu_after, cpu_after)]
    worst = max(upd, key=lambda n: upd[n][0])
    emit({"phase": "deepfm_train_check", "batch": batch, "config": DEEPFM,
          "loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
          "errors": errs, "sparse_grad_rows_equal": rows_equal,
          "sparse_grad_slots": int(cpu[2].shape[0]),
          "moment1_rel_l2": m1,
          "update_rel_l2": {n: e[0] for n, e in upd.items()},
          "update_max_abs": {n: e[1] for n, e in upd.items()},
          "worst_update_param": worst, "padding_zero": pad_zero,
          "tol": "loss 1e-5 rel, prob 1e-5 abs, sparse grad and first "
                 "moments %g rel L2, updates 1e-3 rel L2 and lr per "
                 "element" % grad_tol, "launches": counts,
          "cpu_step_s": cpu_s, "device": smi_line})
    check(np.isfinite(gpu[1]).all(), "non-finite prob on the card")
    check(errs["loss"] <= 1e-5 and errs["prob"] <= 1e-5,
          "deepfm_train_check errors %s" % errs)
    check(rows_equal, "the sparse grad's rows differ")
    check(errs["sparse_grad_rel_l2"] <= grad_tol
          and errs["moment1_rel_l2_max"] <= grad_tol,
          "deepfm_train_check gradients %s, moments %s" % (errs, m1))
    check(all(e[0] <= 1e-3 and e[1] <= lr for e in upd.values()),
          "deepfm_train_check updates %s" % upd)
    check(all(pad_zero), "padding columns moved: %s" % pad_zero)
    return errs


def phase_deepfm_amp_train_check(torch, smi_line, batch=64):
    """One full-width DeepFM step under ``fluid.amp.decorate`` (batch 64)
    on the card, and from the same weights and feed the same step in f32
    on the card and with the port on the CPU under AMP, in f32 and under
    AMP on the parameters scaled by 1 + 2^-20: the MLP's products run bf16
    through ``mul``, the gathered rows go on in bf16, and the table's
    (rows, values) gradient and the scatter-add kernel stay f32. The
    loss, ``prob``, the sparse gradient's values and each dense
    parameter's gradient are held as ``amp_train_check`` holds its
    quantities, and the card's f32 step must fail that verdict; the
    sparse rows must be equal; every parameter and Adam moment must still
    be f32 after the step."""
    import paddle_tpu_torch as fluid

    main, startup, spec = build_deepfm(fluid, amp=True)
    gb = main.global_block()
    names = [p.name for p in main.all_parameters()]
    dense = [n for n in names if n != "fm_table"]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    fetch = [spec.loss, spec.fetches["prob"], gb.var("fm_table@GRAD@ROWS"),
             gb.var("fm_table@GRAD")] + [gb.var(n + "@GRAD") for n in dense]
    r = _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                       DEEPFM_PER_STEP)
    keep = [i for i in range(len(fetch)) if i != 2]  # not the sparse rows
    quantities = ["loss", "prob", "fm_table@GRAD"] + [
        n + "@GRAD" for n in dense]
    runs = [[r[k][i] for i in keep] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(quantities, [r["gpu"][i] for i in keep], *runs)
    control = _amp_verdict(quantities, [r["gpu_f32"][i] for i in keep],
                           *runs)
    gpu = r["gpu"]
    rows_equal = bool(np.array_equal(gpu[2], r["amp"][2]))
    emit(dict({"phase": "deepfm_amp_train_check", "batch": batch,
               "config": DEEPFM, "precision": "bf16 (fluid.amp.decorate)",
               "loss_gpu": float(gpu[0]),
               "loss_gpu_f32": float(r["gpu_f32"][0]),
               "loss_cpu_amp": float(r["amp"][0]),
               "loss_cpu_f32": float(r["f32"][0]),
               "sparse_grad_rows_equal": rows_equal,
               "state_dtypes": r["dtypes"], "launches": r["counts"],
               "cpu_amp_step_s": r["cpu_s"]["amp"],
               "cpu_f32_step_s": r["cpu_s"]["f32"], "device": smi_line},
              **_amp_report(v, control)))
    check(np.isfinite(gpu[1]).all(), "non-finite prob on the card")
    check(rows_equal, "the sparse grad's rows differ")
    _amp_checks("deepfm_amp_train_check", v, control)
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])
    return v["card"]


def _op_kind(op):
    if op.attr("is_optimizer_op"):
        return "optimizer_ops"
    return "autodiff" if op.type == "autodiff" else "forward_ops"


def _profile_by_op_kind(torch, run_step, steps, device_ms):
    """Device ms per step of the forward ops and of the optimizer ops (Adam,
    the densify's scatter included): the kernels launched inside a
    torch.profiler range around each op the executor runs. The backward
    runs on autograd's device thread, outside those ranges, so the
    autodiff op's share is the rest of ``device_ms`` (the per-kernel total
    of the same number of steps). Also the host ops with the most self CPU
    time, as [name, ms per step, calls per step]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import paddle_tpu_torch.core.executor as ex

    run_op = ex.run_op

    def traced(env, op):
        with record_function("ptt_ops/" + _op_kind(op)):
            run_op(env, op)

    ex.run_op = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run_step()
    finally:
        ex.run_op = run_op
    by_op = dict.fromkeys(("forward_ops", "optimizer_ops"), 0.0)
    for e in prof.events():
        kind = e.name[len("ptt_ops/"):]
        if kind in by_op and e.device_type == DeviceType.CPU:
            by_op[kind] += e.device_time_total / steps / 1e3
    by_op["autodiff"] = sum(device_ms.values()) - sum(by_op.values())
    host = sorted(((e.key[:80], e.self_cpu_time_total / steps / 1e3,
                    e.count / steps) for e in prof.key_averages()
                   if not e.key.startswith("ptt_ops/")),
                  key=lambda r: -r[1])[:10]
    return by_op, [list(r) for r in host]


def phase_deepfm_train(torch, smi_line, warmup=3, steps=20, prof_steps=2,
                       amp=False, interp_steps=0):
    """The main path: DeepFM (BASELINE config 5) trained with Adam(1e-4) at
    batch 32768 on one fixed batch from ``spec.sample_batch(32768,
    RandomState(0))``, staged on the card once, in f32 (phase
    ``deepfm_train``) or under ``fluid.amp.decorate`` (``deepfm_amp_train``:
    bf16 MLP products, the f32 table and scatter), captured from the
    key's second step on as in ``phase_train``. Launch counts are zeroed
    just before the first step and read after the last; every interpreted
    or captured step must launch the scatter kernel exactly once and
    nothing else of the port's, every replay none from Python and,
    profiled, the first step's device kernels kind by kind.
    ``interp_steps``: that many interpreted steps first, timed beside the
    captured ones, and the device time by op kind from them (a replay
    runs no ops)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.framework import torch_dtype

    t0 = time.perf_counter()
    main, startup, spec = build_deepfm(fluid, amp=amp)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    gb = main.global_block()
    # one fixed batch, staged on the card once in the vars' dtypes (ids
    # and labels int32 under the port's 32-bit convention)
    feed = {name: torch.from_numpy(a).to(exe.device,
                                         torch_dtype(gb.var(name).dtype))
            for name, a in spec.sample_batch(
                DEEPFM_BATCH, np.random.RandomState(0)).items()}
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s, runs = [], [], {"launched": 0, "replayed": 0}

    def run_step(ex=exe, cache=True, sc=scope, out=losses):
        (loss,), dt, replayed = counted_step(
            ex, main, DEEPFM_PER_STEP, False, "deepfm step %d" % len(out),
            feed=feed, fetch_list=[spec.loss], scope=sc,
            use_program_cache=cache)
        runs["replayed" if replayed else "launched"] += 1
        out.append(float(loss))  # to numpy: ends synchronised
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    interp, by_op, top_host = None, None, None
    if interp_steps:
        interp = _interpreted_beside(torch, fluid, startup, run_step,
                                     interp_steps, prof_steps)
        by_op, top_host = interp.pop("by_op"), interp.pop("top_host")
    call1 = {}
    _profile_steps(torch, run_step, 1, counts=call1)
    for i in range(warmup - 1 + steps):
        dt = run_step()
        if i >= warmup - 1:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels_per_step, prof_wall_ms, top_other = _profile_steps(
        torch, run_step, prof_steps, counts=replay)
    step_report = exe.step_report(main)
    launches = read_counts()
    exe.close()

    adam = [o for o in gb.ops if o.type == "adam"
            and o.input("Param").name == "fm_table"][0]
    table = scope.get("fm_table")
    used = DEEPFM["embedding_size"] + 1
    pad_zero = not bool(table[:, used:].any())
    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    flops = spec.flops_per_example * DEEPFM_BATCH
    emit({"phase": "deepfm_amp_train" if amp else "deepfm_train",
          "model": "deepfm", "config": DEEPFM,
          "table": [DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH],
          "params": n_params, "batch": DEEPFM_BATCH,
          "dtype": "bf16 (fluid.amp.decorate)" if amp else "float32",
          "optimizer": "Adam(1e-4)", "captured": step_report["captured"],
          "reason": step_report["reason"], "step_report": step_report,
          "interpreted": interp,
          "kernels_by_kind": {"call1": call1, "replay": replay},
          "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "examples_per_s": DEEPFM_BATCH / med,
          "model_tflops_per_s": flops / med / 1e12,
          "losses": losses, "peak_memory_bytes": peak,
          "device_ms_per_step": device_ms,
          "interpreted_device_ms_per_step_by_op_kind": by_op,
          "interpreted_top_host_ops_ms_per_step": top_host,
          "kernels_per_step": kernels_per_step,
          "top_other_kernels": top_other,
          "profiled_wall_ms_per_step": prof_wall_ms,
          "device_busy_share": busy / (med * 1e3),
          "kernel_choice": adam.attrs.get("_kernel_choice"),
          "padding_zero": pad_zero,
          "launches": launches, "launches_per_step": DEEPFM_PER_STEP,
          "steps_by_kind": runs, "setup_s": setup_s, "device": smi_line})
    phase = "deepfm_amp_train" if amp else "deepfm_train"
    check(step_report["captured"] and step_report["replays"] >= steps,
          "%s not captured: %s" % (phase, step_report))
    check_replay_kernels(phase, call1, replay)
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(adam.attrs.get("_kernel_choice", {}).get("kernel")
          == "cuda_scatter_add", "adam's kernel choice %s"
          % adam.attrs.get("_kernel_choice"))
    check(pad_zero, "the table's padding columns moved")
    check(launches == {k: n * runs["launched"]
                       for k, n in DEEPFM_PER_STEP.items()},
          "deepfm_train launches %s" % launches)
    return launches, {k: n * runs["replayed"]
                      for k, n in DEEPFM_PER_STEP.items()}


# ---------------------------------------------------------------------------
# BERT-base pretraining, and the optimizers' sparse routes
# ---------------------------------------------------------------------------

# BERT-base pretraining as paddle_tpu's bench.py trains it (BASELINE
# config 4, :192-198, under fluid.amp.decorate(Adam(1e-4)), :225-231)
BERT_PRETRAIN_BATCH = 128
# an interpreted or captured step without remat: a flash forward and
# backward a layer (self-attention), a LayerNorm forward and backward at
# the embeddings, twice a layer and at the MLM transform, one fused CE
BERT_PER_STEP = per_run(flash_attention_fwd=BERT["layers"],
                        flash_attention_bwd=BERT["layers"],
                        layer_norm_fwd=2 * BERT["layers"] + 2,
                        layer_norm_bwd=2 * BERT["layers"] + 2,
                        fused_ce_fwd=1)
# BERT pretraining's kernel shapes: 128 x 128 tokens, 12 heads of 64,
# attention dropout 0.1; the MLM head's CE over 30522 words, with a bias,
# unsmoothed
BERT_TIMING = dict(batch=BERT_PRETRAIN_BATCH, seq=BERT["seq"],
                   heads=BERT["heads"], d_model=BERT["d_model"],
                   vocab=BERT["vocab"], dropout=0.1, ce_eps=0.0,
                   ce_bias=True)
# the kernel behind each op type: (forward, backward)
_OP_KERNELS = {"flash_attention": ("flash_attention_fwd",
                                   "flash_attention_bwd"),
               "layer_norm": ("layer_norm_fwd", "layer_norm_bwd"),
               "fused_linear_smooth_ce": ("fused_ce_fwd", None)}


def build_bert_pretrain(fluid, dropout_rate, opt="adam", amp=False,
                        accumulate_steps=None, remat=False, lr=1e-4):
    """BERT-base pretraining (``models.bert.bert_base`` at config 4) in
    fresh programs, minimized by Adam or Lamb at ``lr`` (under
    ``amp.decorate`` when ``amp``), with ``accumulate_steps`` and, with
    ``remat``, ``fluid.memory_optimize``. Returns (main, startup, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.bert.bert_base(
            vocab_size=BERT["vocab"], seq_len=BERT["seq"],
            d_model=BERT["d_model"], d_ff=BERT["d_ff"],
            n_head=BERT["heads"], n_layer=BERT["layers"],
            dropout_rate=dropout_rate)
        o = {"adam": fluid.optimizer.Adam,
             "lamb": fluid.optimizer.Lamb}[opt](learning_rate=lr)
        (fluid.amp.decorate(o) if amp else o).minimize(
            spec.loss, accumulate_steps=accumulate_steps)
    if remat:
        fluid.memory_optimize(main)
    main.random_seed = startup.random_seed = SEED
    return main, startup, spec


def bert_feed(spec, batch):
    """A fixed batch: random ids, key lengths from half the sequence to
    all of it (the first row full), 15% of the positions weighted in the
    MLM loss."""
    rng = np.random.RandomState(SEED)
    feed = spec.sample_batch(batch, rng)
    seq = BERT["seq"]
    lens = rng.randint(seq // 2, seq + 1, batch)
    lens[0] = seq
    feed["input_len"] = lens.astype("int64")
    feed["mlm_weights"] = (rng.rand(batch, seq) < 0.15).astype("float32")
    return feed


def program_launches(main, fetch_names):
    """The launches of one interpreted or captured step of ``main``, read
    from the op list the Executor runs: each flash_attention op a flash
    forward and backward, each layer_norm over the last axis a LayerNorm
    forward and backward, each fused_linear_smooth_ce a CE forward, and
    the forwards once more for each such op inside a rematerialized
    segment (``executor.remat_segments``: the backward recomputes a
    segment whole)."""
    from paddle_tpu_torch.core.executor import remat_segments, step_plan

    ops = step_plan(main, fetch_names, False)[0]
    inside = {i for s, (e, _) in remat_segments(ops, fetch_names).items()
              for i in range(s, e)}
    counts = per_run()
    for i, op in enumerate(ops):
        kernels = _OP_KERNELS.get(op.type)
        if kernels is None or (op.type == "layer_norm" and op.attr(
                "begin_norm_axis", 1) != len(op.input("X").shape) - 1):
            continue
        counts[kernels[0]] += 2 if i in inside else 1
        if kernels[1] is not None:
            counts[kernels[1]] += 1
    return counts


def _bert_runs(torch, fluid, main, startup, feed, fetches, per_step,
               cpu_runs=True):
    """``len(fetches)`` runs of ``main`` on the card from a fresh startup
    (call 1 interpreted, call 2 captured, later ones replays; each launch
    count held by ``counted_step``, f32), then, with ``cpu_runs``, the
    same runs with the port on the CPU from the card's initial parameters.
    Returns (card outputs, CPU outputs or None, initial parameters, the
    card's parameters after each run, the card's step report after each
    run, the CPU's seconds)."""
    names = [p.name for p in main.all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    params = {n: scope.numpy(n).copy() for n in names}
    gpu, after, reports = [], [], []
    for i, fetch in enumerate(fetches):
        out, _, _ = counted_step(exe, main, per_step, False, "run %d" % i,
                                 feed=feed, fetch_list=fetch, scope=scope)
        gpu.append(out)
        after.append({n: scope.numpy(n).copy() for n in names})
        reports.append(exe.step_report(main))
    exe.close()
    if not cpu_runs:
        return gpu, None, params, after, reports, 0.0
    cpu_scope = fluid.Scope()
    cexe = fluid.Executor(fluid.CPUPlace())
    cexe.run(startup, scope=cpu_scope)
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    t0 = time.perf_counter()
    counts = read_counts()
    cpu = [cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
           for fetch in fetches]
    check(read_counts() == counts, "a CPU step launched a kernel")
    return gpu, cpu, params, after, reports, time.perf_counter() - t0


def _grad_errors(names, gpu, cpu):
    """(relative loss error, {param: grad relative L2}) of one run's
    [loss] + grads fetches."""
    loss = abs(float(gpu[0]) - float(cpu[0])) / max(abs(float(cpu[0])),
                                                    1e-30)
    return loss, {n: _rel_l2(g, c) for n, g, c in zip(names, gpu[1:],
                                                       cpu[1:])}


def phase_bert_pretrain_check(torch, smi_line, batch=2, lamb_lr=1e-3):
    """One full-width BERT-base pretraining step (batch 2, dropout 0) on
    the card against the same step with the port on the CPU, from the
    same weights and feed (f32, TF32 off), in four arms:

    * ``adam_f32``: the loss within 1e-4 relative, every gradient within
      1e-2 relative L2 (``train_check``'s bounds);
    * ``adam_amp``: under ``fluid.amp.decorate``, held by the AMP verdict
      (``_amp_verdict``, as ``amp_train_check``): every flash, LayerNorm
      and CE launch bf16, the flash and CE ones on their wgmma forms, the
      card's f32 step must fail the verdict;
    * ``lamb``: Lamb(1e-3): the step's loss and gradients as ``adam_f32``,
      and the loss change over the update (a second run on the same
      batch) within 1e-2 of the CPU's: the update's first-order effect;
    * ``lamb_acc2_remat``: Lamb with ``accumulate_steps=2`` under
      ``memory_optimize``: run 1 only accumulates (the card's parameters
      bitwise unchanged), run 2 applies, run 3 reads the loss after it;
      held to ``lamb``'s CPU runs, from the same initial parameters
      (checked bitwise): runs 1-2 to its step (two equal micro-steps
      average to the same gradient, and run 2 still sees the initial
      parameters), the loss change from run 1 to 3 to its loss change; the
      step captured, and the launches those the segments give
      (``program_launches``).

    Launch counts are exact in every arm."""
    import paddle_tpu_torch as fluid

    arms, lamb_cpu = {}, None
    for arm, kw in (("adam_f32", {}),
                    ("lamb", dict(opt="lamb", lr=lamb_lr)),
                    ("lamb_acc2_remat", dict(opt="lamb", lr=lamb_lr,
                                             accumulate_steps=2,
                                             remat=True))):
        main, startup, spec = build_bert_pretrain(fluid, 0.0, **kw)
        names = [p.name for p in main.all_parameters()]
        gb = main.global_block()
        grads = [spec.loss] + [gb.var(n + "@GRAD") for n in names]
        fetches = {"adam_f32": [grads], "lamb": [grads, [spec.loss]],
                   "lamb_acc2_remat": [grads, grads, [spec.loss]]}[arm]
        per_step = program_launches(main, [v.name for v in grads])
        if "remat" not in arm:
            check(per_step == BERT_PER_STEP, "%s: the program launches %s, "
                  "not %s" % (arm, per_step, BERT_PER_STEP))
        feed = bert_feed(spec, batch)
        acc = arm == "lamb_acc2_remat"
        gpu, cpu, params, after, reports, cpu_s = _bert_runs(
            torch, fluid, main, startup, feed, fetches, per_step,
            cpu_runs=not acc)
        if arm == "lamb":
            lamb_cpu = (cpu, [params[n] for n in names])
        elif acc:  # lamb's CPU runs: grads, grads again, the loss after
            check(all(np.array_equal(params[n], p0) for n, p0 in zip(
                names, lamb_cpu[1])), "%s: the initial parameters differ "
                "from lamb's" % arm)
            cpu = [lamb_cpu[0][0], lamb_cpu[0][0], lamb_cpu[0][1]]
        report = reports[min(1, len(reports) - 1)]  # the grads key's
        errs = [_grad_errors(names, g, c) for g, c in zip(gpu, cpu)
                if len(g) > 1]
        r = {"loss_gpu": [float(g[0]) for g in gpu],
             "loss_cpu": [float(c[0]) for c in cpu],
             "loss_rel_err": [e[0] for e in errs],
             "grad_rel_l2_max": [max(e[1].values()) for e in errs],
             "grad_rel_l2_param": [max(e[1], key=e[1].get) for e in errs],
             "launches_per_step": per_step, "captured": report["captured"],
             "runs": {k: report[k] for k in ("interpreted", "captures",
                                             "replays")},
             "cpu_s": cpu_s}
        if acc:
            r["cpu_runs_of"] = "lamb"
        if arm != "adam_f32":
            d_gpu = float(gpu[-1][0]) - float(gpu[0][0])
            d_cpu = float(cpu[-1][0]) - float(cpu[0][0])
            r.update(loss_change_gpu=d_gpu, loss_change_cpu=d_cpu,
                     loss_change_rel_err=abs(d_gpu - d_cpu) / max(
                         abs(d_cpu), 1e-30))
        if arm == "lamb_acc2_remat":
            r["frozen_after_run_1"] = all(
                np.array_equal(after[0][n], params[n]) for n in names)
            r["moved_after_run_2"] = all(
                not np.array_equal(after[1][n], params[n]) for n in names
                if not n.startswith("pos_emb"))
        arms[arm] = r
        check(np.isfinite(r["loss_gpu"]).all() and all(
            np.isfinite(g).all() for run in gpu for g in run[1:]),
            "%s: non-finite loss or grads on the card" % arm)
        check(max(r["loss_rel_err"]) <= 1e-4
              and max(r["grad_rel_l2_max"]) <= 1e-2,
              "%s: loss errors %s, grads %s" % (
                  arm, r["loss_rel_err"], r["grad_rel_l2_max"]))
        if "loss_change_rel_err" in r:
            check(r["loss_change_rel_err"] <= 1e-2 and r["loss_change_cpu"]
                  < 0, "%s: loss change %g on the card, %g on the CPU"
                  % (arm, r["loss_change_gpu"], r["loss_change_cpu"]))
        if arm == "lamb_acc2_remat":
            check(r["frozen_after_run_1"] and r["moved_after_run_2"],
                  "%s: run 1 moved a parameter or run 2 left one" % arm)
            check(report["captured"] and report["captures"] == 1,
                  "%s not captured: %s" % (arm, report))
        del gpu, cpu, params, after

    # AMP Adam: the verdict of amp_train_check
    main, startup, spec = build_bert_pretrain(fluid, 0.0, amp=True)
    names = [p.name for p in main.all_parameters()]
    gb = main.global_block()
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in names]
    r = _amp_step_runs(torch, fluid, main, startup, bert_feed(spec, batch),
                       fetch, names, BERT_PER_STEP)
    runs = [r[k] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(["loss"] + names, r["gpu"], *runs)
    control = _amp_verdict(["loss"] + names, r["gpu_f32"], *runs)
    arms["adam_amp"] = dict(
        {"loss_gpu": float(r["gpu"][0]), "loss_cpu_amp": float(r["amp"][0]),
         "loss_cpu_f32": float(r["f32"][0]), "state_dtypes": r["dtypes"],
         "launches": r["counts"], "bf16_launches": r["bf16_counts"],
         "wgmma_launches": r["wgmma_counts"], "cpu_s": r["cpu_s"]},
        **_amp_report(v, control))
    emit({"phase": "bert_pretrain_check", "batch": batch,
          "config": dict(BERT, dropout_rate=0.0), "arms": arms,
          "tol": "loss 1e-4 rel, grads 1e-2 rel L2, the loss change over "
                 "an update 1e-2 rel; AMP: the amp_train_check verdict",
          "device": smi_line})
    check(np.isfinite([float(r["gpu"][0])]).all(),
          "adam_amp: non-finite loss on the card")
    _amp_checks("bert_pretrain_check adam_amp", v, control)
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])
    return arms


def phase_bert_pretrain(torch, smi_line, warmup=3, steps=10, prof_steps=2):
    """The main path: BERT-base pretraining at batch 128 x 128 tokens with
    dropout 0.1 under ``fluid.amp.decorate``, captured from the key's
    second step on, on one fixed batch (an overfit check), in two arms:
    ``adam``, Adam(1e-4) as ``bench.py:192-198,225-231`` trains it, and
    ``lamb_acc2_remat``, Lamb(1e-4) with ``accumulate_steps=2`` under
    ``memory_optimize`` (a micro-step of the same 16,384 tokens; the
    recompute launches the forwards of each segment again). Per arm: wall
    and device ms a (micro-)step, tokens/s, busy share, the fused CE
    forward's share of the device time, peak memory allocated (the arm
    alone: the peak statistics reset before it), the kernels a step, and
    the launches of each bf16 form; every interpreted or captured step
    launches ``program_launches`` exactly, all bf16, the flash and CE ones
    on wgmma; each replay the first step's kernels by kind."""
    import paddle_tpu_torch as fluid

    out, launched, replayed = {}, per_run(), per_run()
    for arm, kw in (("adam", {}),
                    ("lamb_acc2_remat", dict(opt="lamb", accumulate_steps=2,
                                             remat=True))):
        t0 = time.perf_counter()
        main, startup, spec = build_bert_pretrain(fluid, 0.1, amp=True,
                                                  **kw)
        per_step = program_launches(main, [spec.loss.name])
        scope = fluid.Scope()
        exe = fluid.Executor()  # CUDAPlace(0)
        exe.run(startup, scope=scope)
        feed = bert_feed(spec, BERT_PRETRAIN_BATCH)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = torch.cuda.memory_allocated()
        setup_s = time.perf_counter() - t0
        losses, step_s, runs = [], [], {"launched": 0, "replayed": 0}

        def run_step():
            (loss,), dt, rep = counted_step(
                exe, main, per_step, True, "%s step %d" % (arm, len(losses)),
                feed=feed, fetch_list=[spec.loss],
                scope=scope)
            runs["replayed" if rep else "launched"] += 1
            losses.append(float(loss))
            return dt

        reset_counts()
        micro = 2 if kw.get("accumulate_steps") else 1
        call1 = {}
        _profile_steps(torch, run_step, 1, counts=call1)
        for i in range(warmup * micro - 1 + steps * micro):
            dt = run_step()
            if i >= warmup * micro - 1:
                step_s.append(dt)
        peak = torch.cuda.max_memory_allocated()
        replay = {}
        device_ms, kernels, prof_wall, top_other = _profile_steps(
            torch, run_step, prof_steps * micro, counts=replay)
        report = exe.step_report(main)
        launches, bf16 = read_counts(), read_bf16_counts()
        wgmma = read_wgmma_counts()
        exe.close()
        del scope
        med = statistics.median(step_s)
        busy = sum(device_ms.values())
        tokens = BERT_PRETRAIN_BATCH * BERT["seq"]
        out[arm] = {
            "optimizer": {"adam": "Adam(1e-4)",
                          "lamb_acc2_remat": "Lamb(1e-4), accumulate_steps"
                          "=2, memory_optimize"}[arm],
            "captured": report["captured"], "reason": report["reason"],
            "step_report": report, "micro_steps_per_update": micro,
            "warmup_steps": warmup * micro, "steps": len(step_s),
            "step_ms_median": med * 1e3, "step_ms": [x * 1e3 for x in step_s],
            "tokens_per_s": tokens / med,
            "model_tflops_per_s": spec.flops_per_example
            * BERT_PRETRAIN_BATCH / med / 1e12,
            "device_ms_per_step": device_ms, "device_ms": busy,
            "device_busy_share": busy / (med * 1e3),
            "ce_device_share": device_ms["fused_ce_fwd"] / busy,
            "kernels_per_step": kernels, "kernels_by_kind": {
                "call1": call1, "replay": replay},
            "profiled_wall_ms_per_step": prof_wall,
            "top_other_kernels": top_other, "losses": losses,
            "state_bytes": state, "peak_memory_bytes": peak,
            "peak_above_state_bytes": peak - state,
            "launches": launches, "bf16_launches": bf16,
            "wgmma_launches": wgmma, "launches_per_step": per_step,
            "steps_by_kind": runs, "setup_s": setup_s}
        check(report["captured"] and report["replays"] >= steps,
              "bert_pretrain %s not captured: %s" % (arm, report))
        check_replay_kernels("bert_pretrain " + arm, call1, replay)
        check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
        check(losses[-1] < losses[0], "%s: loss did not fall: %s"
              % (arm, losses))
        check(launches == {k: n * runs["launched"]
                           for k, n in per_step.items()},
              "bert_pretrain %s launches %s" % (arm, launches))
        for k, n in per_step.items():
            launched[k] += n * runs["launched"]
            replayed[k] += n * runs["replayed"]
    a, b = out["adam"], out["lamb_acc2_remat"]
    emit({"phase": "bert_pretrain", "model": "bert_base (pretraining)",
          "precision": "bf16 (fluid.amp.decorate)",
          "config": dict(BERT, dropout_rate=0.1),
          "batch": BERT_PRETRAIN_BATCH, "arms": out,
          "remat_over_adam": {
              "micro_step_ms": b["step_ms_median"] / a["step_ms_median"],
              "peak_above_state": b["peak_above_state_bytes"]
              / a["peak_above_state_bytes"]},
          "device": smi_line})
    return launched, replayed, out["adam"]


def phase_bert_kernel_timing(torch, dev):
    """Rows 1-9's bf16 forms at BERT pretraining's shapes (BERT_TIMING),
    each beside its plain version, its library call and its bound, as
    ``timing`` times them at the Transformer's."""
    rows = _bf16_kernel_timing(torch, dev, torch.Generator().manual_seed(
        SEED), cfg=BERT_TIMING)
    for name, r in rows.items():
        r["launches_per_step"] = BERT_PER_STEP[name]
        emit(dict({"phase": "bert_kernel_timing", "kernel": name}, **r))
    return rows


# DeepFM under each new update op: (name, optimizer, densifies its sparse
# grad through the scatter-add); RMSProp twice, plain and centered
OPTIMIZER_CHECKS = (
    ("lars_momentum", lambda o: o.LarsMomentum(1e-3, 0.9), True),
    ("adagrad", lambda o: o.Adagrad(1e-2), False),
    ("adamax", lambda o: o.Adamax(1e-3), True),
    ("decayed_adagrad", lambda o: o.DecayedAdagrad(1e-2), True),
    ("adadelta", lambda o: o.Adadelta(1.0), True),
    ("rmsprop", lambda o: o.RMSProp(1e-3), True),
    ("rmsprop_centered", lambda o: o.RMSProp(1e-3, momentum=0.5,
                                              centered=True), True),
    ("ftrl", lambda o: o.Ftrl(1e-2), True),
    ("lamb", lambda o: o.Lamb(1e-3), True),
    ("model_average", lambda o: o.Adam(1e-3), True),
    ("ema", lambda o: o.Adam(1e-3), True))


def phase_optimizer_check(torch, smi_line, batch=64, steps=3):
    """DeepFM at full width (config 5: its fused table
    ``embedding(is_sparse=True)``) at batch 64 takes ``steps`` steps under
    each new update op on the card (captured from the second step, but
    Adagrad's sparse branch, which picks the touched rows on the host)
    and with the port on the CPU from the same weights and feed: every
    step's loss within 1e-4 relative (the first 1e-5), and each
    parameter's update over the steps (after - before) within 1e-2
    relative L2. The densifying optimizers launch the scatter-add once a
    step (interpreted and captured steps; ``_kernel_choice``
    ``cuda_scatter_add``), Adagrad never. ModelAverage and
    ExponentialMovingAverage (over Adam) are held through ``apply``: the
    applied parameters' distance from the trained ones within 1e-2
    relative L2 of the CPU's, and ``restore`` gives the trained
    parameters back bitwise. Beside it, row 13 timed at this shape."""
    import paddle_tpu_torch as fluid

    results = {}
    for name, make, densifies in OPTIMIZER_CHECKS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            spec = fluid.models.deepfm.deepfm(**DEEPFM)
            make(fluid.optimizer).minimize(spec.loss)
            avg = None
            if name == "model_average":
                avg = fluid.optimizer.ModelAverage(0.15)
                avg._append_average_ops(main)
            elif name == "ema":
                avg = fluid.optimizer.ExponentialMovingAverage(0.9)
                avg.update(main)
        main.random_seed = startup.random_seed = SEED
        names = [p.name for p in main.all_parameters()]
        upd_op = [o for o in main.global_block().ops
                  if o.attr("is_optimizer_op") and o.input("Param")
                  is not None and o.input("Param").name == "fm_table"][0]
        feeds = [spec.sample_batch(batch, np.random.RandomState(SEED + i))
                 for i in range(steps)]
        per_step = per_run(scatter_add=1) if densifies else per_run()
        got = {}
        for side in ("gpu", "cpu"):
            scope = fluid.Scope()
            exe = fluid.Executor(None if side == "gpu" else fluid.CPUPlace())
            exe.run(startup, scope=scope)
            if side == "gpu":
                params = {n: scope.numpy(n).copy() for n in names}
                reset_counts()
            else:
                fluid.bridge.load_program_params(scope, params, main, "cpu")
            losses = []
            for i, feed in enumerate(feeds):
                if side == "gpu":
                    (loss,), _, _ = counted_step(
                        exe, main, per_step, False, "%s step %d" % (name, i),
                        feed=feed, fetch_list=[spec.loss], scope=scope)
                else:
                    loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                                    scope=scope)
                losses.append(float(loss))
            trained = {n: scope.numpy(n).copy() for n in names}
            applied = None
            if avg is not None:
                with avg.apply(exe, scope=scope):
                    applied = {n: scope.numpy(n).copy() for n in names}
                restored = all(np.array_equal(scope.numpy(n), trained[n])
                               for n in names)
                check(restored, "%s: restore on the %s did not give the "
                      "trained parameters back" % (name, side))
            got[side] = dict(losses=losses, trained=trained, applied=applied,
                             choice=upd_op.attr("_kernel_choice"))
            if side == "gpu":
                got[side].update(report=exe.step_report(main),
                                 launches=read_counts())
            exe.close()
        g, c = got["gpu"], got["cpu"]
        loss_err = [abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(g["losses"], c["losses"])]
        upd = {n: _rel_l2(g["trained"][n] - params[n],
                          c["trained"][n] - params[n]) for n in names}
        r = {"losses_gpu": g["losses"], "losses_cpu": c["losses"],
             "loss_rel_err": loss_err, "update_rel_l2": upd,
             "update_rel_l2_max": max(upd.values()),
             "kernel_choice": g["choice"], "scatter_launches":
             g["launches"]["scatter_add"], "captured": g["report"][
                 "captured"], "reason": g["report"]["reason"],
             "runs": {k: g["report"][k] for k in ("interpreted",
                                                  "captures", "replays")}}
        if avg is not None:
            ap = {n: _rel_l2(g["applied"][n] - g["trained"][n],
                             c["applied"][n] - c["trained"][n])
                  for n in names}
            r["applied_rel_l2_max"] = max(ap.values())
        results[name] = r
        check(loss_err[0] <= 1e-5 and max(loss_err) <= 1e-4,
              "optimizer_check %s: losses %s" % (name, loss_err))
        check(r["update_rel_l2_max"] <= 1e-2, "optimizer_check %s: updates "
              "%s" % (name, upd))
        check(r.get("applied_rel_l2_max", 0.0) <= 1e-2,
              "optimizer_check %s: applied averages %s" % (name, r))
        want_choice = {"kernel": "cuda_scatter_add"} if densifies else None
        check(g["choice"] == want_choice, "optimizer_check %s: the table's "
              "update recorded %s" % (name, g["choice"]))
        check(r["captured"] == (name != "adagrad"),
              "optimizer_check %s: captured %s (%s)"
              % (name, r["captured"], r["reason"]))
        launched = g["report"]["interpreted"] + g["report"]["captures"]
        check(r["scatter_launches"] == (launched if densifies else 0),
              "optimizer_check %s: %d scatter launches in %d launching "
              "steps" % (name, r["scatter_launches"], launched))
    timing = _scatter_kernel_timing(torch, torch.device("cuda", 0),
                                    batch=batch)["scatter_add"]
    emit({"phase": "optimizer_check", "model": "deepfm", "config": DEEPFM,
          "batch": batch, "steps": steps, "optimizers": results,
          "scatter_timing": timing,
          "tol": "losses 1e-4 rel (step 1 1e-5), updates and applied "
                 "averages 1e-2 rel L2, restore bitwise",
          "device": smi_line})
    return timing


def build_resnet(fluid, amp=False):
    """ResNet-50 with Adam(1e-4), as paddle_tpu's bench.py trains it, in
    fresh programs (under ``fluid.amp.decorate`` when ``amp``), and its
    for_test clone (which drops the AMP mark, as in the reference).
    Returns (main, startup, test, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.resnet.resnet_imagenet(**RESNET)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        (fluid.amp.decorate(opt) if amp else opt).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, main.clone(for_test=True), spec


def _rel_l2(a, b):
    return float(np.linalg.norm(a.astype("f8") - b)) / max(
        float(np.linalg.norm(b.astype("f8"))), 1e-30)


def _elem_err(a, b):
    return float(np.abs(a.astype("f8") - b).max()) / max(
        float(np.abs(b).max()), 1.0)


def _over_sensitivity(errs, tol):
    """The names in ``errs`` ({name: (card's error from the CPU, the CPU's
    own distance from its run on the input scaled by 1 + 2^-20)}) whose
    error passes the larger of ``tol`` and 5x that rounding sensitivity:
    the bound of a step whose f32 rounding is amplified (ResNet-50's and
    DCGAN's batch-statistic BNs)."""
    return sorted(n for n, (e, s) in errs.items() if e > max(tol, 5 * s))


def phase_resnet_train_check(torch, smi_line, batch=2):
    """One full-width ResNet-50 step (224 x 224, 1000 classes, batch 2) on
    the card and with the port on the CPU from the same weights and feed
    (f32, TF32 off), plus a second CPU step on the input scaled by
    1 + 2^-20 (a few ulps), which measures how far f32 rounding alone moves
    each quantity. Randomly initialised ResNet-50 with batch statistics has
    an exploding input-to-gradient Jacobian, so each quantity is held to
    the larger of its stated tolerance and 5x that rounding sensitivity:
    the loss to 1e-4 relative, every gradient to 1e-2 in relative L2 error,
    the BN moving statistics after the step to 1e-4 of max(1, max|CPU|).
    ReLU sign flips between card and CPU are counted at every ReLU
    output."""
    import paddle_tpu_torch as fluid

    main, startup, _, spec = build_resnet(fluid)
    names = [p.name for p in main.all_parameters()]
    trainable = [p.name for p in main.all_parameters() if p.trainable]
    moving = [n for n in names if n not in set(trainable)]
    gb = main.global_block()
    relu_out = [op.output("Out").name for op in gb.ops if op.type == "relu"]
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in trainable] + relu_out
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))

    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == RESNET_PER_STEP, "resnet_train_check launches %s != %s"
          % (counts, RESNET_PER_STEP))
    gpu_moving = [gpu_scope.get(n).cpu().numpy() for n in moving]

    cpu_runs, cpu_s = [], []
    for scale in (1.0, 1.0 + 2.0 ** -20):
        cpu_scope = fluid.Scope()
        cexe = fluid.Executor(fluid.CPUPlace())
        cexe.run(startup, scope=cpu_scope)
        fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
        f = dict(feed, img=(feed["img"] * np.float32(scale)).astype("f4"))
        t0 = time.perf_counter()
        out = cexe.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
        cpu_s.append(time.perf_counter() - t0)
        cpu_runs.append((out, [cpu_scope.get(n).numpy() for n in moving]))
    check(read_counts() == counts, "the CPU steps launched a kernel")
    (cpu, cpu_moving), (pert, pert_moving) = cpu_runs

    n_t = len(trainable)
    loss = (abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            abs(float(pert[0]) - float(cpu[0])) / abs(float(cpu[0])))
    grads = {n: (_rel_l2(g, c), _rel_l2(p, c)) for n, g, c, p in zip(
        trainable, gpu[1:1 + n_t], cpu[1:1 + n_t], pert[1:1 + n_t])}
    stats = {n: (_elem_err(g, c), _elem_err(p, c)) for n, g, c, p in zip(
        moving, gpu_moving, cpu_moving, pert_moving)}
    flips = {"card_vs_cpu": 0, "perturbed_cpu_vs_cpu": 0, "elements": 0}
    for g, c, p in zip(gpu[1 + n_t:], cpu[1 + n_t:], pert[1 + n_t:]):
        flips["card_vs_cpu"] += int(((g > 0) != (c > 0)).sum())
        flips["perturbed_cpu_vs_cpu"] += int(((p > 0) != (c > 0)).sum())
        flips["elements"] += int(c.size)

    worst_g = max(grads, key=lambda n: grads[n][0])
    worst_s = max(stats, key=lambda n: stats[n][0])
    bad = (_over_sensitivity({"loss": loss}, 1e-4)
           + _over_sensitivity(grads, 1e-2) + _over_sensitivity(stats, 1e-4))
    emit({"phase": "resnet_train_check", "batch": batch, "config": RESNET,
          "loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
          "loss_rel_err": loss[0], "loss_rel_sensitivity": loss[1],
          "grads_compared": n_t,
          "grad_rel_l2_max": grads[worst_g][0], "grad_rel_l2_param": worst_g,
          "grad_rel_l2_median": float(np.median([e for e, _ in
                                                 grads.values()])),
          "grad_sensitivity_max": max(s for _, s in grads.values()),
          "grad_sensitivity_median": float(np.median([s for _, s in
                                                      grads.values()])),
          "grads_past_1e-2": sum(e > 1e-2 for e, _ in grads.values()),
          "moving_stats_compared": len(moving),
          "moving_err_max": stats[worst_s][0], "moving_err_param": worst_s,
          "moving_sensitivity_max": max(s for _, s in stats.values()),
          "relu_sign_flips": flips,
          "tol": "max(stated, 5 x sensitivity): loss 1e-4 rel, grads 1e-2 "
                 "rel L2, moving stats 1e-4 of max(1, max|cpu|)",
          "over_tolerance": bad, "launches": counts, "cpu_step_s": cpu_s,
          "device": smi_line})
    check(np.isfinite(float(gpu[0])), "non-finite loss on the card")
    check(not bad, "resnet_train_check: over tolerance: %s" % bad)
    return loss[0]


# A whole AMP step of randomly initialised ResNet-50 is chaotic: scaling
# the parameters by 1 + 2^-20 moves the CPU AMP step's gradients by 1.1
# relative L2 (median over the 161 gradients, 224 x 224 at batch 2 and
# 16) and its loss by 0.1-0.6%, as far as AMP moves them from f32 (1.25,
# 0.3-0.8%): every bf16 rounding flip is amplified through 53 batch-
# statistic BNs, and no quantity separates AMP from f32. So the card is
# held to the CPU op by op ("forced"): every forward op of the step runs
# once on the inputs the CPU's AMP chain gave it, with the VJP of one
# seeded cotangent, on the card and on the CPU, under AMP and (the control
# and the yardstick) in f32 on the widened inputs. Over all outputs, and
# over all input gradients, the card lies within AMP_MARGIN of the CPU's
# AMP-vs-f32 distance of the CPU's AMP values, and no single quantity
# further than max(its AMP-vs-f32 distance, FORCED_FLOOR); the card's f32
# control must fail.
FORCED_FLOOR = 1e-5  # relative L2: two f32 computations of one op


def _forced_chain(torch, main, fetch_names, params, feed, amp=True):
    """The forward ops of ``main``'s step (fused as the executor runs them)
    and, for each, its inputs as the port's chain on the CPU (AMP unless
    ``amp`` is false) computes them from ``params`` and ``feed``."""
    from paddle_tpu_torch.core import op_registry as reg
    from paddle_tpu_torch.core.executor import fused_ops, to_tensor

    ops, _ = fused_ops(main, fetch_names)
    ops = ops[:[o.type for o in ops].index("autodiff")]
    gb = main.global_block()
    cpu = torch.device("cpu")
    env = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    env.update({n: to_tensor(v, cpu, gb.var(n)) for n, v in feed.items()})
    env[reg.DEVICE_KEY] = cpu
    env[reg.RNG_KEY] = torch.Generator().manual_seed(SEED)
    inputs = []
    with torch.no_grad(), reg.amp_scope(amp):
        for op in ops:
            inputs.append({n: env[n] for n in op.input_arg_names
                           if n in env})
            reg.run_op(env, op)
    return ops, inputs


def _forced_run(torch, ops, inputs, device, amp, cts, fault=None,
                flips=None):
    """Each op once on its recorded inputs (on ``device``; floating inputs
    widened to f32 unless ``amp``), with the VJP of the cotangents ``cts``
    ({(op index, output name): CPU tensor}; filled with seeded normals in
    the outputs' dtypes on first use), each zeroed where ``flips`` ({(op
    index, output name): bool CPU tensor}) is set. ``fault(op, env)``, if
    given, is applied to each op's outputs (a planted fault the check must
    catch). Returns {(op index, type, "out" or "grad", name): f32 CPU
    tensor}."""
    from paddle_tpu_torch.core import op_registry as reg

    gen = torch.Generator().manual_seed(SEED + 7)
    out = {}
    for i, (op, ins) in enumerate(zip(ops, inputs)):
        env = {reg.DEVICE_KEY: device,
               reg.RNG_KEY: torch.Generator(device=device).manual_seed(SEED)}
        leaves = {}
        for n, t in ins.items():
            if isinstance(t, torch.Tensor):
                t = t.to(device)
                if t.is_floating_point():
                    t = (t if amp else t.float()).detach().requires_grad_(True)
                    leaves[n] = t
            env[n] = t
        with reg.amp_scope(amp):
            reg.run_op(env, op)
        if fault is not None:
            fault(op, env)
        outs = {n: env[n] for n in op.output_arg_names
                if isinstance(env.get(n), torch.Tensor)
                and env[n].is_floating_point()}
        pairs = []
        for n, t in outs.items():
            out[(i, op.type, "out", n)] = t.detach().float().cpu()
            if t.requires_grad:
                if (i, n) not in cts:
                    cts[(i, n)] = torch.randn(t.shape, generator=gen).to(
                        t.dtype)
                ct = cts[(i, n)]
                if flips and (i, n) in flips:
                    ct = ct.masked_fill(flips[(i, n)], 0)
                pairs.append((t, ct.to(device, t.dtype)))
        grads = torch.autograd.grad(
            [p[0] for p in pairs], list(leaves.values()),
            [p[1] for p in pairs], allow_unused=True) if pairs and leaves \
            else [None] * len(leaves)
        for (n, t), g in zip(leaves.items(), grads):
            out[(i, op.type, "grad", n)] = torch.zeros(t.shape) if g is None \
                else g.detach().float().cpu()
        del env, leaves, outs, pairs, grads
    return out


def _forced_verdict(card, amp, f32):
    """Distances (relative L2) of ``card`` and ``f32`` from ``amp`` per
    quantity and aggregated per kind ("out", "grad"), and the quantities
    and kinds outside their limits (see the comment above FORCED_FLOOR)."""
    per, agg = {}, {}
    for key, want in amp.items():
        wn = float(want.double().norm())
        dc = float((card[key].double() - want.double()).norm())
        df = float((f32[key].double() - want.double()).norm())
        per[key] = (dc / max(wn, 1e-30), df / max(wn, 1e-30))
        a = agg.setdefault(key[2], [0.0, 0.0, 0.0])
        a[0] += dc * dc
        a[1] += df * df
        a[2] += wn * wn
    agg = {k: {"card": (c / w) ** 0.5, "amp_vs_f32": (f / w) ** 0.5}
           for k, (c, f, w) in agg.items()}
    outside = ["%d:%s:%s:%s" % k for k, (c, f) in per.items()
               if not c <= max(f, FORCED_FLOOR)]
    outside += [k for k, a in agg.items()
                if not a["card"] <= AMP_MARGIN * a["amp_vs_f32"]]
    worst = max(per, key=lambda k: per[k][0] / max(per[k][1], FORCED_FLOOR))
    return {"aggregate": agg, "outside": outside, "quantities": len(per),
            "worst": {"name": "%d:%s:%s:%s" % worst, "card": per[worst][0],
                      "amp_vs_f32": per[worst][1]}}


# The QAT step (f32) is held op by op as the AMP step is: a whole step's
# gradients move by 1.35 relative L2 (median) when its input is scaled by
# 1 + 2^-20, since a fake-quant rounds to a 255-level grid and each
# rounding flip is amplified through the batch-statistic BNs, so no
# whole-step limit can fail a wrong gradient. Each forward op runs once
# on the inputs the CPU's chain gave it, with the VJP of one seeded
# cotangent, on the card and on the CPU, both in f32 with TF32 off. On
# identical inputs the fake-quant ops agree bitwise (each step of the
# quantize-dequantize is one correctly rounded f32 operation on both, and
# round is half to even on both) and the convs, BNs and the rest to f32
# accumulation order (about 1e-6). A fused conv's ReLU is the exception:
# where one side's output is exactly 0 and the other's is not, rounding
# flipped a ReLU decision, and one such flip moves the BN bias gradient of
# its channel by a cotangent element (4e-3 relative L2 over an op). So the
# cotangent is zeroed at those positions on both sides and the VJPs run
# again (``_forced_flips``): each side then differentiates through the
# same mask. A fake-quant left out moves its output by its quantization
# error (about 1e-2 at 8 bits) and a zeroed straight-through gradient
# moves the input gradient by 1. So every output (unmasked) and input
# gradient of every op lies within QAT_FORCED_TOL relative L2 of the
# CPU's, and the two planted faults, run on the card, must each fail it.
QAT_FORCED_TOL = 1e-4


def _qat_faults(torch):
    """The planted faults of the forced QAT check: {name: fault(op, env)}
    for ``_forced_run``, each on every fake-quant op: "identity_fake_quant"
    (Out is X: no quantization) and "zero_ste" (Out's value right, its
    gradient zero)."""
    def identity(op, env):
        if op.type.startswith("fake_"):
            env[op.output("Out").name] = env[op.input("X").name]

    def zero_ste(op, env):
        if op.type.startswith("fake_"):
            out = op.output("Out").name
            env[out] = env[out].detach()

    return {"identity_fake_quant": identity, "zero_ste": zero_ste}


def _forced_flips(card, cpu):
    """{(op index, output name): bool tensor} of the positions where
    exactly one of ``card`` and ``cpu`` (``_forced_run``'s) holds an output
    of exactly 0, for the outputs that have any."""
    flips = {}
    for key, want in cpu.items():
        if key[2] == "out":
            f = (card[key] == 0) ^ (want == 0)
            if bool(f.any()):
                flips[(key[0], key[3])] = f
    return flips


def _forced_f32_verdict(card, cpu, tol):
    """Relative L2 of each quantity of ``card`` from ``cpu`` (both
    ``_forced_run``'s), the quantities past ``tol``, the worst, and the
    worst by op type and kind."""
    per, by_type = {}, {}
    for key, want in cpu.items():
        d = float((card[key].double() - want.double()).norm())
        w = float(want.double().norm())
        per[key] = d / w if w > 0 else (0.0 if d == 0 else float("inf"))
        k = "%s:%s" % (key[1], key[2])
        by_type[k] = max(by_type.get(k, 0.0), per[key])
    worst = max(per, key=per.get)
    return {"quantities": len(per), "worst": {"name": "%d:%s:%s:%s" % worst,
                                             "rel_l2": per[worst]},
            "worst_by_type": by_type,
            "outside": ["%d:%s:%s:%s" % k for k, e in per.items()
                        if not e <= tol]}


def phase_resnet_amp_train_check(torch, smi_line, batch=2):
    """One full-width ResNet-50 step (224 x 224, 1000 classes, batch 2)
    under ``fluid.amp.decorate`` on the card against the port's CPU AMP
    step from the same weights and feed. The card's AMP step must launch
    conv_moments and bn_apply 49 times each, all in bf16, and its f32 step
    (the control) the same in f32; every parameter and Adam moment stays
    f32; the loss and gradients are finite. The whole step's distances
    (``_amp_verdict``: card vs CPU AMP, CPU AMP vs f32, CPU AMP vs
    CPU AMP on parameters scaled by 1 + 2^-20) are printed: the step is
    chaotic (see the comment above FORCED_FLOOR). The card is held op by
    op: ``_forced_verdict`` on the card's AMP ops, which must pass, and on
    its f32 ops, which must fail."""
    import paddle_tpu_torch as fluid

    main, startup, _, spec = build_resnet(fluid, amp=True)
    names = [p.name for p in main.all_parameters()]
    trainable = [p.name for p in main.all_parameters() if p.trainable]
    gb = main.global_block()
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in trainable]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    t0 = time.perf_counter()
    r = _amp_step_runs(torch, fluid, main, startup, feed, fetch, names,
                       RESNET_PER_STEP)
    step_s = time.perf_counter() - t0
    runs = [r[k] for k in ("amp", "f32", "pert")]
    v = _amp_verdict(["loss"] + trainable, r["gpu"], *runs)
    control = _amp_verdict(["loss"] + trainable, r["gpu_f32"], *runs)
    gpu = r["gpu"]
    check(np.isfinite([float(gpu[0])]).all() and all(
        np.isfinite(g).all() for g in gpu[1:]),
        "non-finite loss or grads on the card")
    check(r["dtypes"] == ["torch.float32"], "AMP state dtypes %s"
          % r["dtypes"])

    t0 = time.perf_counter()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    params = {n: scope.get(n).numpy() for n in names}
    ops, inputs = _forced_chain(torch, main, [spec.loss.name], params,
                                feed)
    dev = fluid.CUDAPlace(0).torch_device()
    cts = {}
    cpu = torch.device("cpu")
    forced = {"amp": _forced_run(torch, ops, inputs, cpu, True, cts),
              "f32": _forced_run(torch, ops, inputs, cpu, False, cts),
              "card": _forced_run(torch, ops, inputs, dev, True, cts),
              "card_f32": _forced_run(torch, ops, inputs, dev, False, cts)}
    fv = _forced_verdict(forced["card"], forced["amp"], forced["f32"])
    fc_ = _forced_verdict(forced["card_f32"], forced["amp"], forced["f32"])
    forced_s = time.perf_counter() - t0
    del forced, inputs
    emit({"phase": "resnet_amp_train_check", "batch": batch,
          "config": RESNET, "precision": "bf16 (fluid.amp.decorate)",
          "loss_gpu": float(gpu[0]), "loss_gpu_f32": float(r["gpu_f32"][0]),
          "loss_cpu_amp": float(r["amp"][0]),
          "loss_cpu_f32": float(r["f32"][0]),
          "loss_cpu_amp_perturbed": float(r["pert"][0]),
          "state_dtypes": r["dtypes"], "launches": r["counts"],
          "bf16_launches": r["bf16_counts"],
          "cpu_amp_step_s": r["cpu_s"]["amp"],
          "cpu_f32_step_s": r["cpu_s"]["f32"], "whole_step_s": step_s,
          "whole_step": {k: w for k, w in _amp_report(v, control).items()
                         if k not in ("card_vs_cpu_amp", "cpu_amp_vs_f32",
                                      "cpu_amp_sensitivity")},
          "forced_ops": len(ops), "forced_s": forced_s,
          "forced_card": fv, "forced_card_f32_control": fc_,
          "tol": "forced: per kind card <= %g x CPU AMP vs f32, per "
                 "quantity card <= max(CPU AMP vs f32, %g); the card's f32 "
                 "ops must fail" % (AMP_MARGIN, FORCED_FLOOR),
          "device": smi_line})
    check(not fv["outside"], "resnet_amp_train_check: forced ops outside "
          "tolerance: %s" % fv["outside"][:20])
    check(fc_["outside"], "resnet_amp_train_check: the card's f32 ops "
          "passed the AMP check")
    return fv


def phase_resnet_train(torch, smi_line, conv_site_ms, warmup=3, steps=10,
                       prof_steps=2, amp=False, f32_step=None,
                       interp_steps=0):
    """The main path: ResNet-50 trained with Adam(1e-4) at batch 128 (224
    x 224 x 3, 1000 classes) on one fixed batch, in f32 (phase
    ``resnet_train``) or under ``fluid.amp.decorate`` (``resnet_amp_train``:
    bf16 convs and activations, the bf16 forms of the fused-conv kernels,
    f32 parameters and Adam state), captured from the key's second step
    on as in ``phase_train``. Launch counts are zeroed just before the
    first step and read after the last; every interpreted or captured step
    must launch conv_moments and bn_apply 49 times each and nothing else of
    the port's, under AMP all in bf16, conv_moments all on its wgmma form,
    and in f32 none, every replay none from Python and, profiled, the
    first step's device kernels kind by kind. ``interp_steps``: that many
    interpreted steps first, timed beside the captured ones. The fusion
    report must hold 53
    sites, the four declined ones those of RESNET_DECLINED, each for its
    geometry. The profiled conv_moments ms per step is printed beside
    ``conv_site_ms``, the sum of its per-geometry times weighted by sites
    (phase ``conv_geometry``), and under AMP the f32 step's summary
    ``f32_step`` beside the AMP one. Returns (launches, the trained model,
    the step's summary)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import fused_ops

    t0 = time.perf_counter()
    main, startup, test, spec = build_resnet(fluid, amp)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(RESNET_BATCH, np.random.RandomState(SEED))
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters()
                   if p.trainable)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, step_s, runs = [], [], {"launched": 0, "replayed": 0}

    def run_step(ex=exe, cache=True, sc=scope, out=losses):
        (loss,), dt, replayed = counted_step(
            ex, main, RESNET_PER_STEP, amp, "resnet step %d" % len(out),
            feed=feed, fetch_list=[spec.loss], scope=sc,
            use_program_cache=cache)
        runs["replayed" if replayed else "launched"] += 1
        out.append(float(loss))  # to numpy: ends synchronised
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    interp = None
    if interp_steps:
        interp = _interpreted_beside(torch, fluid, startup, run_step,
                                     interp_steps)
    call1 = {}
    _profile_steps(torch, run_step, 1, counts=call1)
    for i in range(warmup - 1 + steps):
        dt = run_step()
        if i >= warmup - 1:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels_per_step, prof_wall_ms, top_other = _profile_steps(
        torch, run_step, prof_steps, counts=replay)
    step_report = exe.step_report(main)
    launches = read_counts()
    exe.close()

    ops, report = fused_ops(main, [spec.loss.name])
    sites = [o for o in ops if o.type == "fused_conv2d"]
    declined = [(tuple(o.input("Filter").shape), list(o.attr("strides")))
                for o in sites if not o.attrs["_kernel_choice"]["admitted"]]
    reasons = [o.attrs["_kernel_choice"]["reason"] for o in sites
               if not o.attrs["_kernel_choice"]["admitted"]]
    kernels_used = sorted({o.attrs["_kernel_choice"]["kernel"]
                           for o in sites})

    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    flops = spec.flops_per_example * RESNET_BATCH
    q1, _, q3 = statistics.quantiles(step_s, n=4)
    phase = "resnet_amp_train" if amp else "resnet_train"
    summary = {"step_ms_median": med * 1e3,
               "images_per_s": RESNET_BATCH / med,
               "device_ms": busy, "device_ms_per_step": device_ms,
               "kernels_per_step": kernels_per_step,
               "device_busy_share": busy / (med * 1e3),
               "peak_memory_bytes": peak}
    emit({"phase": phase, "model": "resnet50",
          "config": RESNET, "params": n_params, "batch": RESNET_BATCH,
          "dtype": "bf16 (fluid.amp.decorate)" if amp else "float32",
          "optimizer": "Adam(1e-4)", "captured": step_report["captured"],
          "reason": step_report["reason"], "step_report": step_report,
          "interpreted": interp,
          "kernels_by_kind": {"call1": call1, "replay": replay},
          "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "step_ms": [x * 1e3 for x in step_s],
          "images_per_s": RESNET_BATCH / med,
          "images_per_s_range": [RESNET_BATCH / max(step_s),
                                 RESNET_BATCH / min(step_s)],
          "images_per_s_iqr": [RESNET_BATCH / q3, RESNET_BATCH / q1],
          "model_tflops_per_s": flops / med / 1e12,
          "losses": losses, "peak_memory_bytes": peak,
          "device_ms_per_step": device_ms,
          "kernels_per_step": kernels_per_step,
          "top_other_kernels": top_other,
          "profiled_wall_ms_per_step": prof_wall_ms,
          "device_busy_share": busy / (med * 1e3),
          "conv_moments_ms_per_step": {
              "profiled": device_ms["conv_moments"],
              "site_weighted_timing": conv_site_ms},
          "fusion": {"sites": len(report.fused), "refused":
                     [str(r) for r in report.refused],
                     "kernel_sites": len(sites) - len(declined),
                     "declined": declined, "declined_reasons": reasons,
                     "kernels": kernels_used},
          "launches": launches, "bf16_launches": read_bf16_counts(),
          "wgmma_launches": read_wgmma_counts(),
          "launches_per_step": RESNET_PER_STEP, "steps_by_kind": runs,
          "f32_step": f32_step, "setup_s": setup_s, "device": smi_line})
    check(step_report["captured"] and step_report["replays"] >= steps,
          "%s not captured: %s" % (phase, step_report))
    check_replay_kernels(phase, call1, replay)
    check(len(report.fused) == len(sites) == 53 and not report.refused,
          "fusion report: %s" % report.summary())
    check(declined == RESNET_DECLINED
          and kernels_used == ["cuda_fused_conv", "unfused_replay"],
          "declined sites %s, kernels %s" % (declined, kernels_used))
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(device_ms["conv_moments"] > 0 and device_ms["conv_apply"] == 0,
          "profiled conv kernels not recognised: %s" % device_ms)
    check(launches == {k: n * runs["launched"]
                       for k, n in RESNET_PER_STEP.items()},
          "resnet_train launches %s" % launches)
    if amp:
        dtypes = _float_state_dtypes(torch, scope)
        check(dtypes == ["torch.float32"], "AMP state dtypes %s" % dtypes)
    replayed = {k: n * runs["replayed"] for k, n in RESNET_PER_STEP.items()}
    return (launches, replayed), (exe, scope, main, test, spec, feed), \
        summary


def phase_resnet_eval(torch, smi_line, trained, passes=5, small=2,
                      amp=False):
    """The main path: the trained model's ``main.clone(for_test=True)`` at
    batch 128 (moving statistics, the inference kernel at the 49 admitted
    sites), each pass launching conv_apply 49 times and nothing else of
    the port's; then the same clone at batch 2 on the card and with the
    port on the CPU from the card's trained weights. f32 (``resnet_eval``):
    logits within 1e-4 of max(1, max|CPU|), loss within 1e-4 relative,
    accuracy equal. Under AMP (``resnet_amp_eval``) the clone, which drops
    the mark as in the reference, is marked with ``fluid.amp.enable_bf16``:
    conv_apply launches in bf16, every launch in its wgmma form
    (``wgmma_launches``), and the logits and loss lie within
    AMP_MARGIN of the CPU's bf16-vs-f32 eval distance of the CPU's bf16
    eval (relative L2). The clone is captured from its second pass on, as
    in ``phase_train``. Returns (launches, wgmma launches, replayed
    passes) of the passes."""
    import paddle_tpu_torch as fluid

    exe, scope, main, test, spec, feed = trained
    if amp:
        check(not getattr(test, "_amp_bf16", False),
              "the for_test clone kept the AMP mark")
        fluid.amp.enable_bf16(test)
    logits = [op.input("X").name for op in test.global_block().ops
              if op.type == "softmax"][0]
    fetch = [spec.loss.name, spec.fetches["acc"].name, logits]
    pass_s, runs = [], {"launched": 0, "replayed": 0}
    reset_counts()
    call1, replay = {}, {}

    def run_pass():
        _, dt, replayed = counted_step(
            exe, test, RESNET_PER_EVAL, amp, "eval pass", feed=feed,
            fetch_list=fetch[:2], scope=scope)
        runs["replayed" if replayed else "launched"] += 1
        pass_s.append(dt)

    _profile_steps(torch, run_pass, 1, counts=call1)
    for _ in range(passes + 1):
        run_pass()
    _profile_steps(torch, run_pass, 1, counts=replay)
    del pass_s[-1]  # the profiled pass
    step_report = exe.step_report(test)
    launches, bf16_launches = read_counts(), read_bf16_counts()
    wgmma_launches = read_wgmma_counts()
    phase = "resnet_amp_eval" if amp else "resnet_eval"
    check(step_report["captured"] and step_report["replays"] >= passes,
          "%s not captured: %s" % (phase, step_report))
    check_replay_kernels(phase, call1, replay)
    check(launches == {k: n * runs["launched"]
                       for k, n in RESNET_PER_EVAL.items()},
          "%s launches %s" % (phase, launches))

    small_feed = {k: v[:small] for k, v in feed.items()}
    gpu = exe.run(test, feed=small_feed, fetch_list=fetch, scope=scope)
    params = {p.name: scope.get(p.name).cpu().numpy()
              for p in main.all_parameters()}
    cpu_scope = fluid.Scope()
    fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    cexe = fluid.Executor(fluid.CPUPlace())
    before = read_counts()
    cpu = cexe.run(test, feed=small_feed, fetch_list=fetch, scope=cpu_scope)
    cpu_f32 = None
    if amp:
        fluid.amp.disable_bf16(test)
        cpu_f32 = cexe.run(test, feed=small_feed, fetch_list=fetch,
                           scope=cpu_scope)
        fluid.amp.enable_bf16(test)
    check(read_counts() == before, "the CPU eval launched a kernel")
    exe.close()
    med = statistics.median(pass_s[2:])
    line = {"phase": phase, "model": "resnet50", "config": RESNET,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "captured": step_report["captured"],
            "reason": step_report["reason"], "step_report": step_report,
            "passes_by_kind": runs,
            "kernels_by_kind": {"call1": call1, "replay": replay},
            "precision": "bf16 (clone + fluid.amp.enable_bf16)" if amp
            else "f32", "batch": RESNET_BATCH, "passes": passes,
            "pass_ms_median": med * 1e3,
            "pass_ms": [x * 1e3 for x in pass_s],
            "images_per_s": RESNET_BATCH / med,
            "small_batch": small, "loss_gpu": float(gpu[0]),
            "loss_cpu": float(cpu[0]), "acc_gpu": float(gpu[1]),
            "acc_cpu": float(cpu[1]), "launches": launches,
            "bf16_launches": bf16_launches, "wgmma_launches": wgmma_launches,
            "launches_per_pass": RESNET_PER_EVAL, "device": smi_line}
    if amp:
        card = {"loss": _rel_l2(gpu[0], cpu[0]),
                "logits": _rel_l2(gpu[2], cpu[2])}
        ref = {"loss": _rel_l2(cpu_f32[0], cpu[0]),
               "logits": _rel_l2(cpu_f32[2], cpu[2])}
        emit(dict(line, card_vs_cpu_bf16=card, cpu_bf16_vs_f32=ref,
                  loss_cpu_f32=float(cpu_f32[0]),
                  tol="card <= %g x CPU bf16 vs f32 (rel L2)" % AMP_MARGIN))
        check(all(card[n] <= AMP_MARGIN * ref[n] for n in card),
              "resnet_amp_eval: card %s, CPU bf16 vs f32 %s" % (card, ref))
        return launches, wgmma_launches, runs["replayed"]
    errs = {"loss": abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            "logits": _elem_err(gpu[2], cpu[2])}
    emit(dict(line, errors=errs, tol=1e-4))
    check(max(errs.values()) <= 1e-4, "resnet_eval errors %s" % errs)
    check(float(gpu[1]) == float(cpu[1]), "accuracy differs")
    return launches, wgmma_launches, runs["replayed"]


# GPT-2 small's published widths (Radford et al. 2019, the ``gpt2`` config:
# n_embd 768, n_head 12, n_layer 12, n_inner 3072, vocab_size 50257,
# n_positions 1024) on the repo's transformer_lm architecture (pre-norm,
# ReLU FFN, untied bias-free output projection)
GPT2 = dict(vocab=50257, d_model=768, d_ff=3072, n_head=12, n_layer=12,
            ctx_cap=1024, pos_cap=1024)
GPT2_PARAMS = 163000320
DRAFT_SEQ = 16
# launches of one step or chunk dispatch, and of one draft pass (the full
# causal program: its 12 attention layers take the flash forward)
PER_DISPATCH = per_run(layer_norm_fwd=2 * GPT2["n_layer"] + 1)
PER_DRAFT_PASS = per_run(layer_norm_fwd=2 * GPT2["n_layer"] + 1,
                         flash_attention_fwd=GPT2["n_layer"])
SYSTEM_PREFIX = 128


def build_lm_family(fluid, place):
    """The weight-sharing ``transformer_lm`` family at GPT-2-small widths
    in one scope on ``place``, random weights from seed 11 (the full
    program's startup): predictors of the step and chunk programs and the
    draft (the full program at seq 16, pruned to its logits, so no loss is
    computed), the specs, and the programs for the CPU copy."""
    from paddle_tpu_torch.inference import ProgramPredictor

    tr = fluid.models.transformer
    full_cfg = {k: v for k, v in GPT2.items() if k != "ctx_cap"}
    built = {}
    for name, build in (
            ("full", lambda: tr.transformer_lm(seq_len=DRAFT_SEQ, **full_cfg)),
            ("step", lambda: tr.transformer_lm_step(**GPT2)),
            ("chunk", lambda: tr.transformer_lm_chunk(**GPT2))):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            built[name] = (main, startup, build())
    full_main, full_start, spec = built["full"]
    full_start.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(place).run(full_start, scope=scope)
    logits = spec.extras["logits"]
    draft_main = full_main.prune([logits])
    op_types = [op.type for op in draft_main.global_block().ops]
    check("softmax_with_cross_entropy" not in op_types
          and op_types.count("flash_attention") == GPT2["n_layer"],
          "the pruned draft program's ops: %s" % sorted(set(op_types)))
    fam = {"scope": scope, "place": place, "programs": {},
           "n_params": sum(int(np.prod(p.shape))
                           for p in full_main.all_parameters()),
           "param_names": [p.name for p in full_main.all_parameters()]}
    for name in ("step", "chunk"):
        main, _startup, (fetch_vars, dspec) = built[name]
        feeds = [dspec["token_feed"], dspec["pos_feed"]] \
            + [c["feed"] for c in dspec["cache_feeds"]]
        fam["programs"][name] = (main, feeds, fetch_vars)
        fam[name] = ProgramPredictor(main, feeds, fetch_vars, scope=scope,
                                     place=place)
        fam[name + "_spec"] = dspec
    fam["programs"]["draft"] = (draft_main, ["ids"],
                                [draft_main.global_block().var(logits)])
    fam["draft"] = ProgramPredictor(*fam["programs"]["draft"], scope=scope,
                                    place=place)
    fam["logits"] = logits
    return fam


def _dispatch(pred, spec, caches, tokens, pos):
    """One step or chunk dispatch: (logits, the updated caches)."""
    feed = dict(caches)
    feed[spec["token_feed"]] = tokens
    feed[spec["pos_feed"]] = pos
    outs = pred.run(feed, return_numpy=False)
    return outs[0], {cf["feed"]: o
                     for cf, o in zip(spec["cache_feeds"], outs[1:])}


def _zero_caches(torch, spec, b, c, device):
    return {cf["feed"]: torch.zeros(b, c, GPT2["d_model"], device=device)
            for cf in spec["cache_feeds"]}


def _rel_l2_t(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _greedy_run(fluid, fam, reqs, ctx, **kw):
    """Greedy ids of ``reqs`` [(prompt, max_new)] through one
    ``DecodeBatcher`` driven on the calling thread at batch rung 4."""
    bat = fluid.serving.DecodeBatcher(fam["step"], fam["step_spec"],
                                      ladder=(4,), ctx_ladder=(ctx,),
                                      start=False, **kw)
    futs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
    bat.drive()
    check(bat.draft_failures == 0, "a draft pass raised")
    return [[int(t) for t in f.result(0)] for f in futs], bat


def phase_decode_check(torch, smi_line, tol=1e-4):
    """The decode tier at GPT-2-small widths against the port on the CPU
    and against itself (f32, TF32 off):

    * four teacher-forced step dispatches and one chunk dispatch of K = 16
      on the card and on the CPU from the same weights: logits within
      ``tol`` in relative L2 (and the carried caches);
    * exact launches: 25 ``layer_norm_fwd`` a step or chunk dispatch, 25 +
      12 ``flash_attention_fwd`` a draft pass;
    * the draft (the pruned full program, whose causal attention is the
      flash forward) at [8, 16] over histories of at most 16 tokens, where
      its positions are the target's: logits within ``tol`` of the CPU's
      and of the target's step logits, and each proposal the plain
      chain's next token, or a miss at a position whose top-2 margin is
      within 10x their largest difference;
    * ``kv_cache_write`` at positions -1 (wraps), C and C + 3 (drop) on
      the card, out of place and in place into a lent cache, bitwise as on
      the CPU, with no device assert;
    * a request decoded alone and batched with strangers: bitwise the
      same ids at one (batch rung, ctx rung);
    * plain step-only, chunked-prefill and speculative decode: the same
      greedy ids, or a divergence at a position whose top-2 margin is
      within 10x the largest step-vs-chunk logit difference (a tie under
      another product shape, not a fault)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.opimpl.attention_ops import (
        cache_write, cache_write_, lendable_cache)

    t0 = time.perf_counter()
    fam = build_lm_family(fluid, fluid.CUDAPlace(0))
    dev = fam["place"].torch_device()
    check(fam["n_params"] == GPT2_PARAMS, "%d parameters, not %d"
          % (fam["n_params"], GPT2_PARAMS))
    cpu_scope = fluid.Scope()
    for n in fam["param_names"]:
        cpu_scope.set(n, fam["scope"].get(n).cpu())
    cpu = {name: fluid.inference.ProgramPredictor(
        *fam["programs"][name], scope=cpu_scope, place=fluid.CPUPlace())
        for name in ("step", "chunk", "draft")}
    setup_s = time.perf_counter() - t0

    # (1) four steps and a chunk of 16, card against CPU
    rng = np.random.RandomState(SEED)
    b, c, k = 4, 64, 16
    toks = rng.randint(0, GPT2["vocab"], (b, 4 + k)).astype("int64")
    sspec, cspec = fam["step_spec"], fam["chunk_spec"]
    side = {"gpu": (fam["step"], fam["chunk"], dev),
            "cpu": (cpu["step"], cpu["chunk"], torch.device("cpu"))}
    logits, caches, counts = {}, {}, []
    for key, (step, chunk, d) in side.items():
        cache = _zero_caches(torch, sspec, b, c, d)
        outs = []
        for t in range(4):
            reset_counts()
            lg, cache = _dispatch(step, sspec, cache, toks[:, t],
                                  np.full((b,), t, "int32"))
            outs.append(lg)
            counts.append((key, "step", read_counts()))
        reset_counts()
        lg, cache = _dispatch(chunk, cspec, cache, toks[:, 4:],
                              np.tile(np.arange(4, 4 + k, dtype="int32"),
                                      (b, 1)))
        outs.append(lg.reshape(b * k, -1))
        counts.append((key, "chunk", read_counts()))
        logits[key] = torch.cat([o.cpu() for o in outs])
        caches[key] = cache
    for key, kind, n in counts:
        want = PER_DISPATCH if key == "gpu" else per_run()
        check(n == want, "decode_check %s %s dispatch launched %s"
              % (key, kind, n))
    l2 = _rel_l2_t(logits["gpu"], logits["cpu"])
    max_abs = float((logits["gpu"] - logits["cpu"]).abs().max())
    cache_l2 = max(_rel_l2_t(caches["gpu"][n], caches["cpu"][n])
                   for n in caches["cpu"])
    check(bool(torch.isfinite(logits["gpu"]).all()), "non-finite logits")

    draft = fluid.serving.DraftLM(fam["draft"], fam["logits"], DRAFT_SEQ,
                                  lbl_feed=None)

    # (3) out-of-range cache positions on the card
    gen = torch.Generator().manual_seed(SEED)
    cache0 = torch.randn(4, c, GPT2["d_model"], generator=gen)
    rows = torch.randn(4, 3, GPT2["d_model"], generator=gen)
    pos = torch.tensor([[-1, 0, 1], [c, c, c], [c + 3, 2, c], [5, -c, 7]],
                       dtype=torch.int32)
    got = cache_write(cache0.to(dev), rows.to(dev), pos.to(dev))
    lent = lendable_cache(4, c, (GPT2["d_model"],), torch.float32, dev)
    lent.copy_(cache0)
    lent_got = cache_write_(lent, rows.to(dev), pos.to(dev))
    torch.cuda.synchronize()
    want = cache_write(cache0, rows, pos)
    check(torch.equal(got.cpu(), want) and lent_got is lent
          and torch.equal(lent.cpu(), want), "kv_cache_write out of range: "
          "the card (out of place or in place) differs from the CPU")
    check(torch.equal(want[0, c - 1], rows[0, 0])
          and torch.equal(want[1], cache0[1])
          and torch.equal(want[2, 2], rows[2, 1])
          and torch.equal(want[3, 0], rows[3, 1]),
          "kv_cache_write did not wrap -1 and -C or drop C and C + 3")

    # (4) solo vs batched with strangers, one (batch rung, ctx rung)
    prompt = list(rng.randint(0, GPT2["vocab"], 40))
    strangers = [(list(rng.randint(0, GPT2["vocab"], n)), m)
                 for n, m in ((23, 9), (9, 16), (57, 5))]
    solo, _ = _greedy_run(fluid, fam, [(prompt, 16)], 128)
    batched, _ = _greedy_run(fluid, fam, [(prompt, 16)] + strangers, 128)
    check(batched[0] == solo[0], "solo %s != batched %s"
          % (solo[0], batched[0]))

    # (5) plain vs chunked prefill vs speculative decode
    reqs = [(prompt, 16)] + [(p, 16) for p, _m in strangers]
    ladder = {"ladder": (4, 8, 16, 32, 64)}
    prefill = dict(ladder, predictor=fam["chunk"], spec=cspec)
    plain, _ = _greedy_run(fluid, fam, reqs, 128)
    chunked, cb = _greedy_run(fluid, fam, reqs, 128, prefill=prefill)
    spec_ids, sb = _greedy_run(
        fluid, fam, reqs, 128, prefill=prefill,
        speculative={"draft": draft, "k": 4})
    # teacher-forced along the plain chain: every fed position through
    # step dispatches and through one chunk dispatch
    fed = [p + ids[:-1] for (p, _m), ids in zip(reqs, plain)]
    cap = 128
    step_lg = torch.zeros(len(fed), cap, GPT2["vocab"])
    cache = _zero_caches(torch, sspec, len(fed), cap, dev)
    for t in range(max(len(f) for f in fed)):
        tk = np.array([f[t] if t < len(f) else 0 for f in fed], "int64")
        ps = np.array([t if t < len(f) else cap for f in fed], "int32")
        lg, cache = _dispatch(fam["step"], sspec, cache, tk, ps)
        step_lg[:, t] = lg.cpu()
    tk = np.zeros((len(fed), cap), "int64")
    ps = np.full((len(fed), cap), cap, "int32")
    for r, f in enumerate(fed):
        tk[r, :len(f)] = f
        ps[r, :len(f)] = np.arange(len(f))
    chunk_lg, _ = _dispatch(fam["chunk"], cspec,
                            _zero_caches(torch, sspec, len(fed), cap, dev),
                            tk, ps)
    chunk_lg = chunk_lg.cpu()
    diffs = [float((step_lg[r, :len(f)] - chunk_lg[r, :len(f)]).abs().max())
             for r, f in enumerate(fed)]
    divergences = []
    for arm, ids in (("chunked", chunked), ("speculative", spec_ids)):
        for r, ((p, _m), want, got) in enumerate(zip(reqs, plain, ids)):
            if got == want:
                continue
            j = next(i for i, (a, w) in enumerate(zip(got, want)) if a != w)
            top2 = torch.topk(step_lg[r, len(p) - 1 + j], 2).values
            margin = float(top2[0] - top2[1])
            divergences.append({"arm": arm, "request": r, "token": j,
                                "margin": margin,
                                "step_vs_chunk_max_diff": diffs[r]})
            check(margin <= 10 * diffs[r],
                  "%s decode diverged from plain at request %d token %d "
                  "with top-2 margin %g > 10 x %g" % (arm, r, j, margin,
                                                       diffs[r]))

    # (6) the draft where its positions are the target's (histories of at
    # most DRAFT_SEQ tokens, here the 9-token request's along its plain
    # chain, one pass at the top rung of 8): its logits on the card
    # against the CPU and against the target's teacher-forced step logits,
    # and its proposals against the plain chain's next tokens
    r = 2
    chain = fed[r] + plain[r][-1:]
    hists = [chain[:n] for n in range(len(reqs[r][0]), DRAFT_SEQ + 1)]
    check(len(hists) == 8, "%d draft histories" % len(hists))
    ids = np.zeros((len(hists), DRAFT_SEQ), "int64")
    for j, h in enumerate(hists):
        ids[j, :len(h)] = h
    draft_lg = {key: torch.as_tensor(pred.run({"ids": ids},
                                              return_numpy=False)[0]).cpu()
                for key, pred in (("gpu", fam["draft"]),
                                  ("cpu", cpu["draft"]))}
    draft_l2 = _rel_l2_t(draft_lg["gpu"], draft_lg["cpu"])
    at = torch.tensor([len(h) - 1 for h in hists])
    last = draft_lg["gpu"][torch.arange(len(hists)), at]
    target = step_lg[r, at]
    draft_vs_target = _rel_l2_t(last, target)
    reset_counts()
    replays = exe_runs(fam["draft"]._exe)["replays"]
    proposed = [t for t, in draft.propose(hists, 1)]
    draft_counts = read_counts()
    # the draft program is captured: a replayed pass launches nothing from
    # Python (its kernels were counted when it was interpreted or captured)
    replayed = exe_runs(fam["draft"]._exe)["replays"] > replays
    check(draft_counts == (per_run() if replayed else PER_DRAFT_PASS),
          "a draft pass (replayed: %s) launched %s"
          % (replayed, draft_counts))
    draft_misses = []
    for j, h in enumerate(hists):
        if proposed[j] == chain[len(h)]:
            continue
        top2 = torch.topk(target[j], 2).values
        margin = float(top2[0] - top2[1])
        diff = float((last[j] - target[j]).abs().max())
        draft_misses.append({"history": len(h), "margin": margin,
                             "draft_vs_target_max_diff": diff})
        check(margin <= 10 * diff,
              "the draft proposed %d, not the plain chain's %d, after %d "
              "tokens with top-2 margin %g > 10 x %g"
              % (proposed[j], chain[len(h)], len(h), margin, diff))
    # speculative decode of that request alone, up to DRAFT_SEQ tokens:
    # the draft sees the target's positions (reported, not held)
    _ids, shb = _greedy_run(
        fluid, fam, [(reqs[r][0], DRAFT_SEQ - len(reqs[r][0]))], 128,
        prefill=prefill, speculative={"draft": draft, "k": 4})
    cm, sm, shm = cb.metrics(), sb.metrics(), shb.metrics()
    emit({"phase": "decode_check", "config": GPT2,
          "params": fam["n_params"], "batch": b, "ctx": c, "chunk": k,
          "logits_rel_l2": l2, "logits_max_abs_err": max_abs,
          "caches_rel_l2": cache_l2, "tol_rel_l2": tol,
          "launches_per_dispatch": PER_DISPATCH["layer_norm_fwd"],
          "draft_pass_launches": draft_counts,
          "draft_logits_rel_l2": draft_l2,
          "draft_logits_max_abs_err": float(
              (draft_lg["gpu"] - draft_lg["cpu"]).abs().max()),
          "draft_vs_target_rel_l2": draft_vs_target,
          "draft_proposals": proposed, "draft_misses": draft_misses,
          "short_spec_accepted": shm["spec_accepted"],
          "short_spec_rejected": shm["spec_rejected"],
          "solo_equals_batched": True, "plain_ids": plain,
          "chunked_equal": chunked == plain,
          "speculative_equal": spec_ids == plain,
          "divergences": divergences,
          "step_vs_chunk_max_diff": max(diffs),
          "chunked_dispatches": cm["decode_steps"],
          "spec_accepted": sm["spec_accepted"],
          "spec_rejected": sm["spec_rejected"],
          "setup_s": setup_s, "device": smi_line})
    check(l2 <= tol and cache_l2 <= tol and draft_l2 <= tol
          and draft_vs_target <= tol,
          "decode_check: card vs CPU rel L2 %g (caches %g, draft %g; draft "
          "vs target %g) > %g" % (l2, cache_l2, draft_l2, draft_vs_target,
                                  tol))
    return fam


def decode_workload(rng, n=64):
    """``n`` requests behind one 128-token system prefix: 80% bodies of
    16-64 tokens with max_new 32, every fifth a body of 256-512 with
    max_new 128 (random ids from ``rng``)."""
    prefix = list(rng.randint(0, GPT2["vocab"], SYSTEM_PREFIX))
    reqs = []
    for i in range(n):
        long = i % 5 == 4
        body = rng.randint(256, 513) if long else rng.randint(16, 65)
        reqs.append((prefix + list(rng.randint(0, GPT2["vocab"], body)),
                     128 if long else 32))
    return reqs


def _decode_kind(name):
    if "spin_kernel" in name:
        return "guard"   # profile_edge's
    kind = _kernel_kind(name)
    if kind != "other":
        return kind
    for mark in ("copy", "softmax", "index", "reduce", "elementwise"):
        if mark in name:
            return mark
    return "other"


class _Interpreted:
    """A predictor whose every dispatch is interpreted
    (``use_program_cache=False``), a lent cache still written in place:
    the decode tier without the capture, beside it in the same call."""

    _lends_feeds = True

    def __init__(self, pred):
        self.pred = pred
        self.fetch_names = pred.fetch_names
        self.feed_names = pred.feed_names
        self.device = pred.device

    def clone(self):
        return _Interpreted(self.pred.clone())

    def run(self, feed, return_numpy=True, _lend=()):
        p = self.pred
        return p._exe.run(p._program, feed=feed, fetch_list=p._fetch_vars,
                          scope=p._scope, return_numpy=return_numpy,
                          use_program_cache=False, donate_state=False,
                          _lend=_lend)


def _exe_memory(*exes):
    """(graph pool bytes, fetch arena bytes) the executors' captures
    reserved."""
    pool = sum(e.pool_bytes or 0 for x in exes for e in x._cache.values())
    arena = sum(x._pool.arena.numel() for x in exes
                if x._pool.arena is not None)
    return pool, arena


def _decode_profile(torch, make_batcher, reqs, skip, window):
    """Device ms per dispatch by kernel kind over dispatches [skip, skip +
    window) of ``reqs`` through a fresh batcher, warmed up (every geometry
    twice), driven on this thread: once timed by the host clock, once more
    under torch.profiler (whose CPU tracing slows the host); busy share =
    device time / the unprofiled wall of the same dispatches. Also the
    device memory reserved after the warmup (after ``empty_cache``), the
    port's kernels by kind in the profiled window (each dispatch's and
    each draft pass's, whether interpreted or replayed from a graph), the
    ids, and the batcher (``make_batcher()`` returns (batcher, draft or
    None))."""
    from torch.profiler import ProfilerActivity, profile

    def drive(prof):
        gc.collect()   # the last window's batcher and its graphs
        bat, draft = make_batcher()
        bat.warmup()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        futs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
        bat.drive(max_steps=skip)
        passes = draft.passes if draft is not None else 0
        torch.cuda.synchronize()
        with (prof if prof is not None else contextlib.nullcontext()):
            profile_edge(torch, prof)
            t0 = time.perf_counter()
            n = bat.drive(max_steps=window)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            profile_edge(torch, prof)
        passes = (draft.passes if draft is not None else 0) - passes
        bat.drive()
        check(n == window and all(f.done() for f in futs),
              "profile window: %d dispatches of %d" % (n, window))
        ids = [[int(t) for t in f.result(0)] for f in futs]
        return wall, reserved, passes, ids, bat

    wall, reserved, _, ids, _bat = drive(None)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof_wall, _, passes, ids2, bat = drive(prof)
    check(ids2 == ids, "the profiled window's ids differ from the timed "
          "one's")
    kinds, counts, n_kernels = {}, {}, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kind = _decode_kind(e.key.lower())
        if kind == "guard":
            continue
        kinds[kind] = kinds.get(kind, 0.0) + us
        counts[kind] = counts.get(kind, 0) + e.count
        n_kernels += e.count
    device_ms = sum(kinds.values()) / 1e3
    want = {k: window * PER_DISPATCH[k] + passes * PER_DRAFT_PASS[k]
            for k in KERNELS}
    got = {k: counts.get(k, 0) for k in KERNELS}
    check(got == want,
          "decode profile window: the port's kernels %s != %d dispatches "
          "and %d draft passes' %s" % (got, window, passes, want))
    return {"requests": len(reqs), "dispatches": [skip, skip + window],
            "wall_ms_per_dispatch": wall / window * 1e3,
            "profiled_wall_ms_per_dispatch": prof_wall / window * 1e3,
            "device_ms_per_dispatch": {k: v / window / 1e3
                                       for k, v in sorted(kinds.items())},
            "kernels_per_dispatch": n_kernels / window,
            "kernel_launches_by_kind_per_dispatch": {
                k: v / window for k, v in sorted(counts.items())},
            "draft_passes_in_window": passes,
            "device_busy_share": device_ms / (wall * 1e3),
            "reserved_after_warmup_bytes": reserved,
            "step_report": bat.step_report(), "ids": ids}


# a profiled decode window's guards, inside the profiler at each edge:
# PROFILE_GUARD_KERNELS launches of ``torch.cuda._sleep(1)`` (kernel
# ``spin_kernel``, left out of the window's sums), a synchronize and
# PROFILE_EDGE_S seconds. Late in a whole run, windows without them read
# about a dozen kernels short, the kinds of a step's first kernels (1
# LayerNorm, 3 GEMMs, 2 gathers ...), in the interpreted and the captured
# window alike; alone they read exact, and the device's times, mapped to
# the host clock, ran up to 0.49 ms past the synchronize that waited for
# them (``tools/capture_diag.py window``)
PROFILE_GUARD_KERNELS = 256
PROFILE_EDGE_S = 0.005


def profile_edge(torch, prof):
    """The guard at an edge of a profiled window (none where ``prof`` is
    None)."""
    if prof is None:
        return
    for _ in range(PROFILE_GUARD_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(PROFILE_EDGE_S)


def _settled_memory(torch):
    """(reserved, allocated) device bytes once dead objects (an earlier
    engine's graphs) are collected and the allocator's free blocks
    returned. A difference of two reserved readings undercounts where new
    tensors reuse free blocks of segments still held; the allocated one
    counts live tensors only (a graph pool's freed scratch is reserved,
    not allocated)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return np.array([torch.cuda.memory_reserved(),
                     torch.cuda.memory_allocated()])


def _interpreted_replica_memory(torch, fluid, model_dir, **engine_kw):
    """The device memory (reserved, allocated) an engine's replica adds by
    the end of its warmup when every dispatch is interpreted
    (``_Interpreted`` step and chunk predictors): its weights and rung
    caches, no graph."""
    from paddle_tpu_torch.inference import Predictor

    base = _settled_memory(torch)
    kw = dict(engine_kw)
    if "decode_prefill" in kw:
        kw["decode_prefill"] = dict(kw["decode_prefill"], predictor=(
            _Interpreted(kw["decode_prefill"]["predictor"])))
    model = Predictor(model_dir)
    eng = fluid.serving.ServingEngine(
        _Interpreted(model), decode=fluid.serving.load_decode_spec(model_dir),
        **kw)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        memory = (_settled_memory(torch) - base).tolist()
    finally:
        eng.shutdown()
    return memory, warm_s


def _decode_arm(torch, fluid, model_dir, reqs, in_flight, chunk=None,
                **engine_kw):
    """One engine over the saved step program serving ``reqs`` in a closed
    loop of ``in_flight`` outstanding requests, after ``warmup()`` (every
    geometry twice: interpreted, then captured). ``chunk``: the chunk
    predictor the engine's ``decode_prefill`` names, whose runs in this
    arm are counted. Returns the ids and the arm's numbers, among them
    the runs of the step and chunk executors and the memory the replica
    reserves after its warmup."""
    base = _settled_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    chunk_before = exe_runs(chunk._exe) if chunk is not None else None
    eng = fluid.serving.ServingEngine(model_dir, decode=True, **engine_kw)
    try:
        t0 = time.perf_counter()
        warmed = eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        memory = (_settled_memory(torch) - base).tolist()
        futs = []
        t0 = time.perf_counter()
        for i, (p, n) in enumerate(reqs):
            if i >= in_flight:
                futs[i - in_flight].result(timeout=600)
            futs.append(eng.submit(p, max_new_tokens=n))
        outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
        wall = time.perf_counter() - t0
        snap = eng.metrics()
        report_text = eng.metrics_report()
        geometries = eng.compiled_shape_counts()
        draft_failures = eng.draft_failures
        dec = eng._decoders[0]
        reports = dec.step_report()
        step_exe = dec._predictor._exe
        runs = {"step": exe_runs(step_exe)}
        exes = [step_exe]
        if chunk is not None:
            after = exe_runs(chunk._exe)
            runs["chunk"] = {k: after[k] - chunk_before[k] for k in after}
            exes.append(chunk._exe)
        pool, arena = _exe_memory(*exes)
    finally:
        eng.shutdown()
    check(draft_failures == 0, "%d draft passes raised" % draft_failures)
    peak = torch.cuda.max_memory_allocated()
    for (p, n), ids in zip(reqs, outs):
        check(len(ids) == n and all(0 <= t < GPT2["vocab"] for t in ids),
              "a request returned %d ids, not %d in range" % (len(ids), n))
    tokens = sum(len(ids) for ids in outs)
    check(snap["requests_completed"] == len(reqs)
          and snap["requests_failed"] == 0, "decode requests failed: %s"
          % snap)
    dispatches = 2 * warmed + snap["decode_steps"]
    for name, r in reports.items():
        check(r is not None and r["captured"]
              and r["reason"] == "admitted"
              and "decode0_%s_captured" % name in report_text,
              "decode %s program not captured: %s" % (name, r))
    check(sum(sum(r.values()) for r in runs.values()) == dispatches
          and sum(r["replays"] for r in runs.values()) > 0,
          "decode runs %s != %d dispatches" % (runs, dispatches))
    return outs, {
        "requests": len(reqs), "in_flight": in_flight, "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "requests_per_s": len(reqs) / wall,
        "ttft_ms": {k: v * 1e3 for k, v in snap["ttft_s"].items()},
        "tpot_ms": {k: v * 1e3 for k, v in snap["tpot_s"].items()},
        "latency_ms": {k: v * 1e3 for k, v in snap["latency_s"].items()},
        "dispatches": snap["decode_steps"],
        "prefill_chunks": snap["prefill_chunks"],
        "prefill_tokens": snap["prefill_tokens"],
        "slot_occupancy": snap["slot_occupancy"],
        "prefix_hits": snap["prefix_hits"],
        "prefix_tokens_reused": snap["prefix_tokens_reused"],
        "prefix_evictions": snap["prefix_evictions"],
        "spec_accepted": snap["spec_accepted"],
        "spec_rejected": snap["spec_rejected"],
        "spec_accept_rate": snap["spec_accept_rate"],
        "warmup_geometries": warmed, "warmup_dispatches": 2 * warmed,
        "warmup_s": warm_s, "geometries": geometries,
        "step_captured": reports["step"]["captured"],
        "chunk_captured": (reports["chunk"]["captured"]
                           if "chunk" in reports else None),
        "runs": runs,
        "replica_after_warmup_bytes": dict(zip(("reserved", "allocated"),
                                               memory)),
        "graph_pool_bytes": pool, "fetch_arena_bytes": arena,
        "peak_memory_bytes": peak}


def _step_copies(torch, fam, b=8, ctxs=(256, 1024), unlent_ctx=256,
                 dispatches=10):
    """Device ms by kind a step dispatch at batch ``b`` (torch.profiler
    over ``dispatches``): captured over lent caches (the in-place write,
    position-major caches) at each ctx rung of ``ctxs``, whether the copy
    kernels still grow with B x C; and at ``unlent_ctx`` interpreted over
    fed, unlent ones (the out-of-place write that copies every cache, and
    ``cached_attention``'s products copying their row-major operands)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core.opimpl.attention_ops import lendable_cache

    spec, pred = fam["step_spec"], fam["step"]
    d = GPT2["d_model"]
    out = {}
    for c, mode in ([(c, "captured_lent") for c in ctxs]
                    + [(unlent_ctx, "interpreted_unlent")]):
        if mode == "captured_lent":
            caches = {cf["feed"]: lendable_cache(b, c, (d,), torch.float32,
                                                 pred.device)
                      for cf in spec["cache_feeds"]}
            kw = {"_lend": tuple(caches)}
        else:
            caches = {cf["feed"]: torch.zeros(b, c, d, device=pred.device)
                      for cf in spec["cache_feeds"]}
            kw = {}
        feed = dict(caches)
        feed[spec["token_feed"]] = np.zeros((b,), "int64")
        feed[spec["pos_feed"]] = np.arange(b, dtype="int32")
        for _ in range(3):   # interpreted, captured, replayed
            pred.run(feed, return_numpy=False, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profile_edge(torch, prof)
            for _ in range(dispatches):
                pred.run(feed, return_numpy=False, **kw)
            torch.cuda.synchronize()
            profile_edge(torch, prof)
        kinds, counts = {}, {}
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kind = _decode_kind(e.key.lower())
            if kind == "guard":
                continue
            kinds[kind] = kinds.get(kind, 0.0) + us
            counts[kind] = counts.get(kind, 0) + e.count
        out["%s_b%d_c%d" % (mode, b, c)] = {
            "copy_ms_per_dispatch": kinds.get("copy", 0.0)
            / dispatches / 1e3,
            "copy_kernels_per_dispatch": counts.get("copy", 0)
            / dispatches,
            "device_ms_per_dispatch": sum(kinds.values())
            / dispatches / 1e3,
            "cache_bytes": 2 * GPT2["n_layer"] * b * c * d * 4}
    return out


def phase_decode(torch, smi_line, fam, n_requests=64, in_flight=16,
                 keep_dir=False):
    """The main path: ``ServingEngine(model_dir, decode=True, ...)`` over a
    ``save_inference_model`` directory of the step program with its
    ``decode_spec.json``, serving ``decode_workload`` in two arms: plain
    step-only decode, then chunked prefill + speculative decode (k = 4,
    the full program at seq 16 over the same weights as draft) + the
    prefix cache. Every step and chunk geometry is captured in the
    engine's warmup over the replica's own caches, and each dispatch
    after is a replay. Launch counts are zeroed just before the first
    engine and read after the second: every interpreted or captured step
    or chunk run launches 25 ``layer_norm_fwd`` from Python, every such
    draft pass 25 more and 12 ``flash_attention_fwd``; a replay launches
    none from Python and the same kernels from its graph
    (``graph_replayed_launches``), which the profile windows hold by kind.
    Then, for each arm, a window of a replay of 8 short requests through a
    captured batcher and through an interpreted one
    (``use_program_cache=False``): wall and device ms per dispatch, busy
    share, memory after warmup, ids (equal). The windows' batchers run at
    ctx rung 256 only (the short requests need no more), to keep their
    warmups' captures few. With ``keep_dir`` the saved step directory is
    kept and returned third, for the caller to delete."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED + 1)
    reqs = decode_workload(rng, n_requests)
    model_dir = tempfile.mkdtemp(prefix="gpt2_step_")
    step_main, feeds, fetch_vars = fam["programs"]["step"]
    t0 = time.perf_counter()
    with fluid.scope_guard(fam["scope"]):
        fluid.io.save_inference_model(model_dir, feeds, fetch_vars,
                                      fluid.Executor(fam["place"]),
                                      main_program=step_main)
    fluid.serving.save_decode_spec(model_dir, fam["step_spec"])
    save_s = time.perf_counter() - t0
    prefill = {"predictor": fam["chunk"], "spec": fam["chunk_spec"]}
    draft = fluid.serving.DraftLM(fam["draft"], fam["logits"], DRAFT_SEQ,
                                  lbl_feed=None)
    fast = {"decode_prefill": prefill,
            "decode_speculative": {"draft": draft, "k": 4},
            "prefix_cache": {"max_bytes": 1 << 30}}

    draft_before = exe_runs(fam["draft"]._exe)
    reset_counts()
    plain_ids, plain = _decode_arm(torch, fluid, model_dir, reqs, in_flight)
    fast_ids, fast_arm = _decode_arm(torch, fluid, model_dir, reqs,
                                     in_flight, chunk=fam["chunk"], **fast)
    launches = read_counts()
    passes = draft.passes
    after = exe_runs(fam["draft"]._exe)
    draft_runs = {k: after[k] - draft_before[k] for k in after}
    draft_report = fam["draft"]._exe.step_report(fam["programs"]["draft"][0])
    for arm, kw in ((plain, {}), (fast_arm, fast)):
        memory, arm["interpreted_warmup_s"] = _interpreted_replica_memory(
            torch, fluid, model_dir, **kw)
        arm["interpreted_replica_after_warmup_bytes"] = dict(zip(
            ("reserved", "allocated"), memory))
    if not keep_dir:
        shutil.rmtree(model_dir)
    copies = _step_copies(torch, fam)

    runs = [r for arm in (plain, fast_arm) for r in arm["runs"].values()]
    launching = sum(r["interpreted"] + r["captures"] for r in runs)
    replays = sum(r["replays"] for r in runs)
    draft_launching = draft_runs["interpreted"] + draft_runs["captures"]
    want = {k: launching * PER_DISPATCH[k] + draft_launching
            * PER_DRAFT_PASS[k] for k in KERNELS}
    replayed = {k: replays * PER_DISPATCH[k] + draft_runs["replays"]
                * PER_DRAFT_PASS[k] for k in KERNELS}
    same = sum(a == b for a, b in zip(plain_ids, fast_ids))

    short = [r for i, r in enumerate(decode_workload(
        np.random.RandomState(SEED + 2), 10)) if i % 5 != 4]

    def batcher(interpreted, spec):
        def make():
            step = _Interpreted(fam["step"]) if interpreted else fam["step"]
            kw, dr = {}, None
            if spec:
                chunk = (_Interpreted(fam["chunk"]) if interpreted
                         else fam["chunk"])
                dr = fluid.serving.DraftLM(
                    _Interpreted(fam["draft"]) if interpreted
                    else fam["draft"], fam["logits"], DRAFT_SEQ,
                    lbl_feed=None)
                kw = {"prefill": {"predictor": chunk,
                                  "spec": fam["chunk_spec"]},
                      "speculative": {"draft": dr, "k": 4},
                      "prefix_cache": {"max_bytes": 1 << 30}}
            return fluid.serving.DecodeBatcher(
                step, fam["step_spec"], ladder=(1, 2, 4, 8),
                ctx_ladder=(256,), start=False, **kw), dr
        return make

    for name, arm, spec, skip, window in (("plain", plain, False, 8, 40),
                                          ("fast", fast_arm, True, 4, 12)):
        arm["profile"] = _decode_profile(torch, batcher(False, spec), short,
                                         skip, window)
        arm["profile_interpreted"] = _decode_profile(
            torch, batcher(True, spec), short, skip, window)
        check(arm["profile"]["ids"] == arm["profile_interpreted"]["ids"],
              "decode %s: the captured batcher's ids differ from the "
              "interpreted one's" % name)
        for key in ("profile", "profile_interpreted"):
            arm[key]["ids_equal_captured_interpreted"] = True
            del arm[key]["ids"]
    for name, arm in (("plain", plain), ("fast", fast_arm)):
        emit(dict({"phase": "decode", "arm": name, "config": GPT2,
                   "params": fam["n_params"], "ladder": [1, 2, 4, 8],
                   "system_prefix": SYSTEM_PREFIX, "device": smi_line},
                  **arm))
    emit({"phase": "decode", "launches": launches, "want": want,
          "graph_replayed_launches": replayed,
          "step_chunk_launching_runs": launching,
          "step_chunk_replays": replays, "draft_passes": passes,
          "draft_runs": draft_runs,
          "draft_captured": draft_report["captured"],
          "draft_reason": draft_report["reason"],
          "step_captured": plain["step_captured"]
          and fast_arm["step_captured"],
          "chunk_captured": fast_arm["chunk_captured"],
          "requests_with_equal_ids": same, "save_s": save_s,
          "step_dispatch_copies": copies})
    check(launches == want, "decode launches %s != %s" % (launches, want))
    check(same == len(reqs), "plain and fast arms' ids differ in %d of %d "
          "requests" % (len(reqs) - same, len(reqs)))
    check(passes > 0 and fast_arm["spec_accepted"] > 0
          and fast_arm["prefix_hits"] > 0
          and fast_arm["prefill_chunks"] > 0,
          "the fast arm skipped a fast path: %s" % fast_arm)
    if keep_dir:  # the step directory, for the router phases to delete
        return launches, replayed, model_dir
    return launches, replayed


# ---------------------------------------------------------------------------
# the serving front door: a router over worker processes on the card
# ---------------------------------------------------------------------------

ROUTER_WORKERS = 2
ROUTER_LADDER = (1, 2, 4, 8)
ROUTER_REQUESTS = 400
ROUTER_IN_FLIGHT = 32
ROUTER_CPU_CHECKED = 8
ROUTER_BURST = 64
ROUTER_DECODE_REQUESTS = 32
ROUTER_DECODE_MAX_NEW = 16
ROUTER_TIMEOUT_S = 300.0
ROUTER_DEVICE = "cuda:0"  # where every worker must say it serves


def compute_apps():
    """[pid, used MiB] of each compute process nvidia-smi lists. In a
    container nvidia-smi cannot map a process to this PID namespace and
    reports another pid (on the sandboxed H100: 1 for every process), so
    the checks count the processes and their memory rather than match
    pids."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, "nvidia-smi --query-compute-apps failed: "
          + r.stderr)
    apps = []
    for line in r.stdout.strip().splitlines():
        pid, _, mib = (p.strip() for p in line.partition(","))
        if pid.isdigit():
            apps.append([int(pid), float(mib)
                         if mib.replace(".", "", 1).isdigit() else None])
    return apps


def _check_compute_apps(torch, phase, apps, workers):
    """nvidia-smi lists one compute process a live worker, plus this one
    when it holds a CUDA context, and no other."""
    own = int(torch.cuda.is_initialized())
    check(len(apps) == workers + own,
          "%s: nvidia-smi lists %d compute processes %s, want %d workers "
          "+ %d" % (phase, len(apps), apps, workers, own))


def worker_kernels(router):
    """Each live worker's kernel report through its ``stats`` verb: the
    device, executor runs, batches and launch counters read in that
    process (a worker is a process this script did not start)."""
    from paddle_tpu_torch.serving import rpc

    reports = []
    for w in router._workers:
        sock = rpc.connect(w.address, timeout=60.0)
        try:
            rpc.send_msg(sock, {"type": "stats"})
            header, _ = rpc.recv_msg(sock)
        finally:
            sock.close()
        reports.append(header["kernels"])
    return reports


def _check_worker(phase, report, per_launch, geometries, dispatches,
                  live=False):
    """One worker's counters against its path's identities: ``--warmup``
    interpreted and captured each of its ``geometries`` once, every
    later dispatch (``dispatches``: its engine batches or decode steps)
    replayed the graph; each launching run launches ``per_launch`` and
    nothing else. ``live``: read while the worker dispatches, so one
    replay may not be counted as a dispatch yet. Returns (launching
    runs, replays)."""
    runs = report["runs"]
    launching = runs["interpreted"] + runs["captures"]
    want = {k: per_launch.get(k, 0) * launching for k in KERNELS}
    check(report["device"] == ROUTER_DEVICE,
          "%s: a worker served on %s" % (phase, report["device"]))
    check(runs["interpreted"] == runs["captures"] == geometries
          and 0 <= runs["replays"] - report[dispatches] <= int(live),
          "%s: worker %d runs %s, %d geometries, %d %s" % (
              phase, report["pid"], runs, geometries, report[dispatches],
              dispatches))
    check(report["launches"] == want, "%s: worker %d launches %s != %s"
          % (phase, report["pid"], report["launches"], want))
    return launching, runs["replays"]


def _path_counts(per_launch, launching, replays):
    return ({k: per_launch.get(k, 0) * launching for k in KERNELS},
            {k: per_launch.get(k, 0) * replays for k in KERNELS})


BERT_PER_DISPATCH = {"flash_attention_fwd": BERT["layers"],
                     "layer_norm_fwd": 2 * BERT["layers"] + 1}


def phase_router_serve(torch, smi_line, bert, fleet):
    """The main path through the front door: ``Router(bert_dir,
    num_workers=2, worker_args=["--warmup", "--ladder", "1,2,4,8"])``,
    each worker one ``ServingEngine`` on ``cuda:0`` over the BERT-base
    directory ``serve`` saved, tracing and flight-recording into
    ``fleet``'s directories. ``ROUTER_REQUESTS`` of ``serve``'s seeded
    requests (1-4 rows) in a closed loop of 32 through one
    ``RouterClient``; then ``ROUTER_CPU_CHECKED`` of them one at a time
    (the answers ``router_chaos`` repeats after its kill) against the
    port on the CPU, and one traced request. Each worker's launch
    counters, read through its ``stats`` verb, obey ``serve``'s
    identities. The fleet stays up for ``router_chaos``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import flight, trace
    from paddle_tpu_torch.serving import Router, RouterClient

    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the fleet
    fleet["flight_env"] = os.environ.get(flight.ENV_FLIGHT_DIR)
    os.environ[flight.ENV_FLIGHT_DIR] = fleet["flight_dir"]
    router = Router(bert["model_dir"], num_workers=ROUTER_WORKERS,
                    worker_args=["--warmup", "--ladder",
                                 ",".join(map(str, ROUTER_LADDER))],
                    worker_env={"PADDLE_TPU_TRACE": fleet["trace_dir"],
                                "PADDLE_TPU_FLIGHT": fleet["flight_dir"]})
    fleet["router"] = router
    fleet["feeds_burst"] = bert["feeds"][ROUTER_REQUESTS:ROUTER_REQUESTS
                                         + ROUTER_BURST]
    t0 = time.perf_counter()
    router.start()
    spawn_s = time.perf_counter() - t0
    client = RouterClient(router.address, pool_size=ROUTER_IN_FLIGHT)
    fleet["client"] = client
    apps = compute_apps()
    pids = [w.pid for w in router._workers]
    feeds = bert["feeds"][:ROUTER_REQUESTS]
    done = {}

    def timed(i):
        t_sub = time.perf_counter()
        fut = client.submit(feeds[i], timeout_s=ROUTER_TIMEOUT_S)
        fut.add_done_callback(
            lambda f, i=i: done.__setitem__(i, time.perf_counter() - t_sub))
        return fut

    t0 = time.perf_counter()
    futs = []
    for i in range(len(feeds)):
        if i >= ROUTER_IN_FLIGHT:
            futs[i - ROUTER_IN_FLIGHT].result(ROUTER_TIMEOUT_S)
        futs.append(timed(i))
    results = [f.result(ROUTER_TIMEOUT_S)[0] for f in futs]
    wall = time.perf_counter() - t0
    lat = sorted(done.values())
    snap = router.metrics_.snapshot()
    for f, r in zip(feeds, results):
        check(r.shape == (f["input_ids"].shape[0], 2) and np.isfinite(r).all()
              and np.abs(r.sum(1) - 1.0).max() <= 1e-5,
              "router_serve: a reply of shape %s does not sum to 1"
              % (r.shape,))
    # the checked requests, one at a time, against the port on the CPU
    checked = list(range(0, ROUTER_REQUESTS,
                         ROUTER_REQUESTS // ROUTER_CPU_CHECKED))
    fleet["checked"] = [feeds[i] for i in checked]
    fleet["before"] = [client.predict(f, timeout_s=ROUTER_TIMEOUT_S)[0]
                       for f in fleet["checked"]]
    config = fluid.inference.AnalysisConfig(bert["model_dir"])
    config.disable_gpu()
    cpu = fluid.inference.Predictor(config)
    cpu_err = max(float(np.abs(got - cpu.run(f)[0]).max())
                  for f, got in zip(fleet["checked"], fleet["before"]))
    loop_err = max(float(np.abs(results[i] - cpu.run(feeds[i])[0]).max())
                   for i in checked)
    # one traced request: the client, the door and the dispatch hop
    # record here, the worker queue, the batch and the run in the worker
    served = [r["served"] for r in worker_kernels(router)]
    trace.start(trace_dir=fleet["trace_dir"])
    try:
        client.predict(feeds[1], timeout_s=ROUTER_TIMEOUT_S)
    finally:
        tracer = trace.stop()
    roots = [s for s in tracer.drain() if s["name"] == "client.predict"]
    reports = worker_kernels(router)
    fleet["traced_worker"] = next(
        i for i, (r, n) in enumerate(zip(reports, served))
        if r["served"] > n)
    fleet["trace_id"] = roots[0]["trace_id"] if len(roots) == 1 else None
    fleet["serve_reports"] = reports
    launching = replays = 0
    for r in reports:
        a, b = _check_worker("router_serve", r, BERT_PER_DISPATCH,
                             len(ROUTER_LADDER), "batches")
        launching, replays = launching + a, replays + b
    check(read_counts() == per_run(),
          "router_serve: this process launched a kernel: %s" % read_counts())
    emit({"phase": "router_serve", "model": "bert_base_classifier",
          "workers": ROUTER_WORKERS, "ladder": list(ROUTER_LADDER),
          "requests": ROUTER_REQUESTS, "arrival": "closed loop",
          "in_flight": ROUTER_IN_FLIGHT, "spawn_s": spawn_s,
          "requests_per_s": ROUTER_REQUESTS / wall, "wall_s": wall,
          "client_p50_ms": lat[len(lat) // 2] * 1e3,
          "client_p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3,
          "router_latency_ms": {k: v * 1e3 for k, v in
                                snap["latency_s"].items()},
          "in_process_serve": {k: bert[k] for k in
                               ("requests_per_s", "p50_ms", "p99_ms")},
          "rerouted": snap["rerouted"], "door_shed": snap["door_shed"],
          "cpu_checked": len(checked), "cpu_max_abs_err": cpu_err,
          "closed_loop_cpu_max_abs_err": loop_err,
          "ready": [w.ready[-1] for w in router._workers],
          "compute_apps_mib": apps, "worker_reports": reports,
          "traced_roots": len(roots), "device": smi_line})
    check(snap["requests_completed"] == ROUTER_REQUESTS
          and snap["requests_failed"] == 0,
          "router_serve: requests failed: %s" % snap)
    check(max(cpu_err, loop_err) <= 1e-4,
          "router_serve: served vs CPU error %g > 1e-4"
          % max(cpu_err, loop_err))
    check(all(w.ready[-1]["device"] == ROUTER_DEVICE
              for w in router._workers),
          "router_serve: READY lines %s" % [w.ready for w in
                                             router._workers])
    _check_compute_apps(torch, "router_serve", apps, len(pids))
    check(len(roots) == 1, "router_serve: %d traced roots" % len(roots))
    return _path_counts(BERT_PER_DISPATCH, launching, replays)


def phase_router_chaos(torch, smi_line, fleet):
    """``paddle_tpu_torch/tools/chaos_router.py``'s drill on the
    ``router_serve`` fleet: a burst of ``ROUTER_BURST`` requests with the
    worker that did not serve the traced request SIGKILLed as soon as it
    holds one of them in flight; the drill's verdict requires that the
    kill caught at least one request there and that the router rerouted
    at least one (the summary's ``victim_in_flight`` and ``rerouted``).
    Every accepted request must end in a result or a typed error; the
    killed process is reaped and respawned (it recaptures its graphs in
    its warmup), after which the checked requests answer bitwise as
    before the kill and nvidia-smi lists one process per live worker.
    Then the fleet shuts down: the router's flight dump holds a
    ``request.outcome`` for each request and the ``worker.respawn``; each
    worker's exit line names ``cuda:0`` and its counters obey ``serve``'s
    identities; and the traced request's spans, from this process and the
    worker, stitch into one trace (``obs.trace.load_dir``), written as a
    chrome trace."""
    sys.path.insert(0, os.path.join(REPO, "paddle_tpu_torch", "tools"))
    import chaos_router
    from paddle_tpu_torch.obs import flight, trace

    router, client = fleet["router"], fleet["client"]
    reset_counts()
    victim = 1 - fleet["traced_worker"]
    survivor_before = worker_kernels(router)[1 - victim]
    t0 = time.perf_counter()
    summary, outs, probes = chaos_router.drill(
        router, client, fleet["feeds_burst"], True, ROUTER_TIMEOUT_S,
        probes=fleet["checked"], victim=victim)
    drill_s = time.perf_counter() - t0
    killed = summary["killed_pid"]
    respawned = router._workers[victim]
    respawn_ready = respawned.ready[-1]
    apps = compute_apps()
    live = [w.pid for w in router._workers]
    reaped = not os.path.exists("/proc/%d" % killed)
    router.shutdown()
    client.close()
    dump = flight.load(flight.dump_path())
    audit = chaos_router.audit_flight(dump, summary, len(fleet["checked"]),
                                      kill=True)
    summary["flight"] = audit
    ok = chaos_router.verdict(summary)
    prev = fleet.pop("flight_env")
    if prev is None:
        os.environ.pop(flight.ENV_FLIGHT_DIR, None)
    else:
        os.environ[flight.ENV_FLIGHT_DIR] = prev
    same = sum(np.array_equal(a[0], b) for a, b in zip(probes,
                                                       fleet["before"]))
    exits = {i: w.exits for i, w in enumerate(router._workers)}
    launching = replays = 0
    survivor = exits[1 - victim][-1]
    a, b = _check_worker("router_chaos", survivor, BERT_PER_DISPATCH,
                         len(ROUTER_LADDER), "batches")
    base = survivor_before["runs"]
    launching += a - base["interpreted"] - base["captures"]
    replays += b - base["replays"]
    a, b = _check_worker("router_chaos", exits[victim][-1],
                         BERT_PER_DISPATCH, len(ROUTER_LADDER), "batches")
    launching, replays = launching + a, replays + b
    # the traced request, stitched across this process and a worker
    spans = trace.load_dir(fleet["trace_dir"])
    tid = fleet["trace_id"]
    tspans = [s for s in spans if s["trace_id"] == tid]
    names = sorted({s["name"] for s in tspans})
    ids = {s["span_id"] for s in tspans}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    chrome_path = os.path.join(REPO, "chiprun_out", "router_trace.json")
    with open(chrome_path, "w") as f:
        json.dump(trace.chrome_trace(tspans), f)
    check(read_counts() == per_run(),
          "router_chaos: this process launched a kernel: %s" % read_counts())
    emit({"phase": "router_chaos", "burst": ROUTER_BURST,
          "victim": victim, "drill_s": drill_s, "summary": summary,
          "probes_bitwise_equal": same, "killed_pid_reaped": reaped,
          "respawned_ready": respawn_ready, "live_pids": live,
          "compute_apps_mib": apps, "exit_reports": exits,
          "trace": {"spans": len(tspans), "names": names,
                    "pids": len({s["pid"] for s in tspans}),
                    "chrome_trace": chrome_path,
                    "chrome_trace_bytes": os.path.getsize(chrome_path)},
          "device": smi_line})
    check(ok, "router_chaos: the drill's verdict failed: %s" % summary)
    check(summary["accepted"] == summary["completed"]
          + sum(summary["typed_errors"].values()),
          "router_chaos: accepted %d != completed + typed" %
          summary["accepted"])
    check(summary["respawns"] >= 1 and respawned.pid != killed and reaped,
          "router_chaos: no reaped respawn of %d" % killed)
    check(same == len(fleet["checked"]),
          "router_chaos: %d of %d checked answers moved after the respawn"
          % (len(fleet["checked"]) - same, len(fleet["checked"])))
    # the killed worker's memory went back to the card: one compute
    # process a live worker
    _check_compute_apps(torch, "router_chaos", apps, len(live))
    check(len(exits[1 - victim]) == 1 and len(exits[victim]) == 1,
          "router_chaos: exit lines %s" % exits)
    check({"client.predict", "router.door", "router.dispatch",
           "worker.queue", "engine.batch", "executor.run"} <= set(names)
          and all(s["parent_id"] in ids for s in tspans
                  if s["parent_id"] is not None),
          "router_chaos: the traced request's spans %s do not stitch"
          % names)
    return _path_counts(BERT_PER_DISPATCH, launching, replays)


GPT2_PER_DISPATCH = {"layer_norm_fwd": 2 * GPT2["n_layer"] + 1}


def phase_router_decode(torch, smi_line, step_dir):
    """The decode tier through the front door: two workers on the
    GPT-2-small step directory ``decode`` saved (with its
    ``decode_spec.json``), ``PADDLE_TPU_PREFIX_CACHE_MB=1024`` and
    ``PADDLE_TPU_DECODE_MAX_NEW=16``, each capturing its 28 step
    geometries in ``--warmup``; then ``chaos_decode.py``'s drill at
    ``decode``'s workload (``decode_workload`` at its seed, 32 prompts
    behind one 128-token prefix, 16 new tokens): a cold pass, a hot pass,
    a burst with worker 0 SIGKILLed mid-decode (with at least one request
    in flight there, and at least one rerouted), and a pass after the
    respawn, each sent as one burst. Every completed reply equals its
    cold-pass reply bitwise; each worker's 25 LayerNorm forwards a
    launching step dispatch (the step program's attention is the plain
    ``cached_attention``: no flash launch) and its replays equal its
    decode steps."""
    sys.path.insert(0, os.path.join(REPO, "paddle_tpu_torch", "tools"))
    import chaos_decode
    from paddle_tpu_torch.serving import Router, RouterClient, decode_batcher

    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 1)
    prompts = [p for p, _ in decode_workload(rng, ROUTER_DECODE_REQUESTS)]
    router = Router(step_dir, num_workers=ROUTER_WORKERS,
                    worker_args=["--warmup", "--ladder",
                                 ",".join(map(str, ROUTER_LADDER))],
                    worker_env={"PADDLE_TPU_PREFIX_CACHE_MB": "1024",
                                "PADDLE_TPU_DECODE_MAX_NEW":
                                    str(ROUTER_DECODE_MAX_NEW)})
    t0 = time.perf_counter()
    router.start()
    spawn_s = time.perf_counter() - t0
    client = RouterClient(router.address, pool_size=ROUTER_DECODE_REQUESTS)
    before_kill = {}
    try:
        summary, passes = chaos_decode.decode_drill(
            router, client, prompts, ROUTER_DECODE_REQUESTS,
            ROUTER_DECODE_MAX_NEW, True, ROUTER_TIMEOUT_S, concurrent=True,
            before_kill=lambda: before_kill.update(
                report=worker_kernels(router)[0]))
        client.close()
    finally:
        router.shutdown()
    ok = chaos_decode.verdict(summary)
    geometries = len(ROUTER_LADDER) * len(decode_batcher.default_ctx_ladder(
        decode_batcher.load_decode_spec(step_dir)))
    launching = replays = 0
    reports = [w.exits[-1] for w in router._workers if w.exits] + \
        [before_kill["report"]]
    for i, r in enumerate(reports):
        a, b = _check_worker("router_decode", r, GPT2_PER_DISPATCH,
                             geometries, "decode_steps",
                             live=i == len(reports) - 1)
        launching, replays = launching + a, replays + b
    check(read_counts() == per_run(),
          "router_decode: this process launched a kernel: %s"
          % read_counts())
    tok = {k: v["tokens"] / v["seconds"] for k, v in passes.items()}
    emit({"phase": "router_decode", "config": GPT2,
          "workers": ROUTER_WORKERS, "requests": ROUTER_DECODE_REQUESTS,
          "max_new": ROUTER_DECODE_MAX_NEW, "system_prefix": SYSTEM_PREFIX,
          "spawn_s": spawn_s, "passes": passes, "tokens_per_s": tok,
          "summary": summary, "geometries": geometries,
          "worker_reports": reports,
          "killed_worker_report_read_before_the_kill":
              before_kill["report"]["pid"], "device": smi_line})
    check(ok, "router_decode: the drill's verdict failed: %s" % summary)
    check(len(reports) == 3, "router_decode: %d worker reports (want the "
          "killed worker's, read before the kill, and two exit lines)"
          % len(reports))
    return _path_counts(GPT2_PER_DISPATCH, launching, replays)


# ---------------------------------------------------------------------------
# attention seq2seq NMT (models.machine_translation) at its reference width
# ---------------------------------------------------------------------------

# machine_translation.py:51-52,100-102's defaults
def _card_cpu_step(fluid, main, startup, spec, feed, per_step, label,
                   extra=()):
    """One step of ``main`` on the card and with the port on the CPU from
    the card's initial parameters: the card's step launches ``per_step``
    exactly, the CPU's none. Fetches the loss, every parameter's gradient
    and ``extra``. Returns (names, initial params, {side: (fetches,
    params after)}, {side: seconds})."""
    gb = main.global_block()
    names = [p.name for p in main.all_parameters()
             if gb.has_var(p.name + "@GRAD")]  # not BN's moving statistics
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in names] + list(extra)
    runs, secs = {}, {}
    for side in ("gpu", "cpu"):
        scope = fluid.Scope()
        exe = fluid.Executor(None if side == "gpu" else fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if side == "gpu":
            params = _mt_params(scope, main)
        else:
            fluid.bridge.load_program_params(scope, params, main, "cpu")
        before = read_counts()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        secs[side] = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in read_counts().items()}
        check(counts == (per_step if side == "gpu" else per_run()),
              "%s %s step launched %s" % (label, side, counts))
        runs[side] = (out, _mt_params(scope, main))
        exe.close()
    return names, params, runs, secs


def _train_path(torch, fluid, smi_line, phase, main, startup, spec, feed,
                per_step, tokens, warmup, steps, prof_steps, extra):
    """A main path's training run on the card: ``main`` on one fixed
    ``feed``, captured from the key's second step on, ``warmup`` + ``steps``
    timed steps and ``prof_steps`` profiled replays; every interpreted or
    captured step launches ``per_step``. Emits the phase's line (``extra``
    merged in) and returns (launches, replayed launches, scope)."""
    t0 = time.perf_counter()
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = torch.cuda.memory_allocated()
    setup_s = time.perf_counter() - t0
    losses, step_s, runs = [], [], {"launched": 0, "replayed": 0}

    def run_step():
        (loss,), dt, rep = counted_step(
            exe, main, per_step, False, "%s step %d" % (phase, len(losses)),
            feed=feed, fetch_list=[spec.loss], scope=scope)
        runs["replayed" if rep else "launched"] += 1
        losses.append(float(loss))
        return dt

    reset_counts()
    call1 = {}
    _profile_steps(torch, run_step, 1, counts=call1)
    for i in range(warmup - 1 + steps):
        dt = run_step()
        if i >= warmup - 1:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels, prof_wall, top_other = _profile_steps(
        torch, run_step, prof_steps, counts=replay)
    report = exe.step_report(main)
    launches = read_counts()
    exe.close()
    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    emit(dict({"phase": phase, "batch": len(next(iter(feed.values()))),
               "precision": "f32", "captured": report["captured"],
               "reason": report["reason"], "step_report": report,
               "warmup_steps": warmup, "steps": len(step_s),
               "step_ms_median": med * 1e3,
               "step_ms": [x * 1e3 for x in step_s],
               "step_ms_spread": (max(step_s) - min(step_s)) * 1e3,
               "tokens_per_s": tokens / med, "device_ms_per_step": device_ms,
               "device_ms": busy, "device_busy_share": busy / (med * 1e3),
               "kernels_per_step": kernels, "kernels_by_kind": {
                   "call1": call1, "replay": replay},
               "profiled_wall_ms_per_step": prof_wall,
               "top_other_kernels": top_other, "losses": losses,
               "state_bytes": state, "peak_memory_bytes": peak,
               "peak_above_state_bytes": peak - state,
               "launches_per_launching_step": per_step,
               "launches": launches, "steps_by_kind": runs,
               "setup_s": setup_s, "device": smi_line}, **extra))
    check(report["captured"] and report["replays"] >= steps,
          "%s not captured: %s" % (phase, report))
    check_replay_kernels(phase, call1, replay)
    check(np.isfinite(losses).all(), "%s: non-finite loss: %s"
          % (phase, losses))
    check(losses[-1] < losses[0], "%s: loss did not fall: %s"
          % (phase, losses))
    check(launches == {k: n * runs["launched"] for k, n in per_step.items()},
          "%s launches %s" % (phase, launches))
    return (launches, {k: n * runs["replayed"] for k, n in per_step.items()},
            scope)


MT = dict(src_vocab=10000, trg_vocab=10000, seq_len=50, emb_dim=512,
          hid_dim=512)
MT_BEAM = 4
MT_TRAIN_BATCH = 128
MT_DECODE_BATCH = 64
MT_LR = 1e-3
# a train step: the decoder's attention, one flash forward and backward
MT_PER_STEP = per_run(flash_attention_fwd=1, flash_attention_bwd=1)
# a beam (or greedy) decode run: one flash forward a While trip
MT_PER_DECODE = per_run(flash_attention_fwd=MT["seq_len"])
# two extensions whose scores lie closer than this may be ordered
# differently by the card and the CPU (f32 sums in other orders, the
# 3xTF32 flash forward); the sentence scores agree within it
MT_NEAR_TIE = 2e-4
# the CPU side of the decode comparison on the trained weights: its first
# rows (they all meet a near tie a few steps in); the sharpened arm holds
# the whole batch
MT_CPU_ROWS = 16
# the factor on the initial output projection in the decode check's second
# arm: the initial logits' spread is a few thousandths, this makes it a few
# units
MT_SHARPEN = 1000.0


def build_mt(fluid):
    """The train program (``seq2seq_attention`` + Adam(MT_LR)) and the
    beam and greedy decode programs, each in fresh programs with fresh
    names; the decode programs read the train program's ``mt_*``
    parameters by name. Returns a dict."""
    mt = fluid.models.machine_translation
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        spec = mt.seq2seq_attention(**MT)
        fluid.optimizer.Adam(learning_rate=MT_LR).minimize(spec.loss)
    out = {"main": main, "startup": startup, "spec": spec}
    for key, fn, kw in (("beam", mt.seq2seq_attention_infer,
                         {"beam_size": MT_BEAM}),
                        ("greedy", mt.seq2seq_attention_greedy_infer, {})):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            fluid.unique_name.switch()
            out[key] = (prog, list(fn(**dict(MT, **kw))))
    return out


def mt_feed(spec, batch, seed=SEED):
    """A fixed batch: random ids, source and target lengths from a fifth
    of the sequence to all of it (the first row full)."""
    rng = np.random.RandomState(seed)
    feed = spec.sample_batch(batch, rng)
    seq = MT["seq_len"]
    for name in ("src_len", "trg_len"):
        lens = rng.randint(seq // 5, seq + 1, batch)
        lens[0] = seq
        feed[name] = lens.astype("int64")
    return feed


def _mt_params(scope, program):
    return {p.name: scope.numpy(p.name).copy()
            for p in program.all_parameters()}


def phase_mt_train_check(torch, smi_line, batch=2):
    """One full-width NMT train step (batch 2) on the card and with the
    port on the CPU from the same weights and feed (f32, TF32 off): the
    loss within 1e-4 relative, every gradient within 1e-2 relative L2
    (``train_check``'s bounds), and the Adam update of every parameter
    (after - before) within 1e-2 relative L2: Adam's first step moves an
    element by about the rate times the sign of its gradient, so a
    gradient within rounding of zero may flip its update, which the
    phase counts. The card's step launches one flash forward and
    backward; the CPU's none."""
    import paddle_tpu_torch as fluid

    m = build_mt(fluid)
    names, params, runs, secs = _card_cpu_step(
        fluid, m["main"], m["startup"], m["spec"], mt_feed(m["spec"], batch),
        MT_PER_STEP, "mt_train_check")
    (gpu, gpu_after), (cpu, cpu_after) = runs["gpu"], runs["cpu"]
    loss_err, grad_l2 = _grad_errors(names, gpu, cpu)
    upd_l2, flips = {}, {}
    for n in names:
        dg, dc = gpu_after[n] - params[n], cpu_after[n] - params[n]
        upd_l2[n] = _rel_l2(dg, dc.astype("f8"))
        flips[n] = int(np.count_nonzero(np.sign(dg) != np.sign(dc)))
    worst_g = max(grad_l2, key=grad_l2.get)
    worst_u = max(upd_l2, key=upd_l2.get)
    emit({"phase": "mt_train_check", "batch": batch, "config": MT,
          "optimizer": "Adam(%g)" % MT_LR, "loss_gpu": float(gpu[0]),
          "loss_cpu": float(cpu[0]), "loss_rel_err": loss_err,
          "grads_compared": len(names), "grad_rel_l2_max": grad_l2[worst_g],
          "grad_rel_l2_param": worst_g, "update_rel_l2_max": upd_l2[worst_u],
          "update_rel_l2_param": worst_u,
          "update_sign_flips": sum(flips.values()),
          "update_elements": int(sum(p.size for p in params.values())),
          "launches": MT_PER_STEP, "cpu_step_s": secs["cpu"],
          "gpu_step_s": secs["gpu"],
          "tol": "loss 1e-4 rel, grads and Adam updates 1e-2 rel L2",
          "device": smi_line})
    check(np.isfinite(float(gpu[0])) and all(
        np.isfinite(g).all() for g in gpu[1:]),
        "mt_train_check: non-finite loss or grads on the card")
    check(loss_err <= 1e-4 and grad_l2[worst_g] <= 1e-2
          and upd_l2[worst_u] <= 1e-2,
          "mt_train_check: loss %g, %s grad %g, %s update %g" % (
              loss_err, worst_g, grad_l2[worst_g], worst_u, upd_l2[worst_u]))


def phase_mt_train(torch, smi_line, warmup=3, steps=10, prof_steps=2):
    """The main path: the NMT train program at batch 128 x 50 tokens,
    Adam(MT_LR), on one fixed batch, captured from the key's second step
    on: 3 warm-up and 10 timed steps. Prints target tokens/s, ms a step
    (median and every step), busy share, peak memory, ``captured`` and
    ``reason``, device ms by kernel kind, and the kernels a step by kind
    for the interpreted first step and a replay (held equal kind by kind
    for the port's kernels); every interpreted or captured step launches
    MT_PER_STEP exactly, a replay none from Python. Returns (launches,
    replayed launches, ``build_mt``'s programs, the trained scope)."""
    import paddle_tpu_torch as fluid

    m = build_mt(fluid)
    launches, replayed, scope = _train_path(
        torch, fluid, smi_line, "mt_train", m["main"], m["startup"],
        m["spec"], mt_feed(m["spec"], MT_TRAIN_BATCH), MT_PER_STEP,
        MT_TRAIN_BATCH * MT["seq_len"], warmup, steps, prof_steps,
        {"model": "seq2seq_attention", "config": MT,
         "optimizer": "Adam(%g)" % MT_LR,
         "flash_launches_per_step": {
             "interpreted": {k: MT_PER_STEP[k] for k in KERNELS[:2]},
             "captured": {k: MT_PER_STEP[k] for k in KERNELS[:2]},
             "replay_from_python": {k: 0 for k in KERNELS[:2]}}})
    return launches, replayed, m, scope


def _margin_hook(margins):
    """The port's ``beam_search_step`` impl, also recording each step's
    [B] margins into ``margins``: (the gap between a row's K-th and
    (K+1)-th best extensions, |the K-th's score|)."""
    from paddle_tpu_torch.core import op_registry
    from paddle_tpu_torch.core.opimpl.decode_ops import (beam_candidates,
                                                         top_k_stable)

    impl = op_registry.OP_IMPLS["beam_search_step"]

    def hooked(env, op):
        impl(env, op)
        ins = [env[op.input(s_).name]
               for s_ in ("PreIds", "PreScores", "Scores")]
        k = ins[2].shape[1]
        top, _ = top_k_stable(beam_candidates(*ins, op.attr("end_id")),
                              k + 1)
        margins.append(((top[:, k - 1] - top[:, k]).cpu().numpy(),
                        top[:, k - 1].abs().cpu().numpy()))

    return hooked


@contextlib.contextmanager
def _swap_impl(op_type, impl):
    from paddle_tpu_torch.core import op_registry

    saved = op_registry.OP_IMPLS[op_type]
    op_registry.OP_IMPLS[op_type] = impl
    try:
        yield
    finally:
        op_registry.OP_IMPLS[op_type] = saved


def _decode_fetch(prog, outs):
    """The decode outputs and ``beam_search_decode``'s recorded arrays
    (ids and parents, [T, B, K]: slot t is step t's selection)."""
    op = next(o for o in prog.global_block().ops
              if o.type == "beam_search_decode")
    return list(outs) + [op.input("IdsArray"), op.input("ParentsArray")]


def beam_prefixes(ids_arr, par_arr, t, b):
    """Row ``b``'s K beams after step ``t`` of a beam decode's recorded
    arrays ([T, B, K], slot s step s's selection), each as its tokens of
    steps 0..t (followed back through the parents), sorted: the set the
    step kept, whatever the beams' order."""
    out = []
    for j in range(ids_arr.shape[2]):
        toks, p = [], j
        for s_ in range(t, -1, -1):
            toks.append(int(ids_arr[s_, b, p]))
            p = int(par_arr[s_, b, p])
        out.append(tuple(reversed(toks)))
    return sorted(out)


def near_tie_verdict(got, want, margins, tol):
    """One beam decode against another: ``got``/``want`` its (ids [B, K,
    T], scores [B, K], ids array, parents array) fetches, ``margins`` the
    ``want`` side's per step ([B] gaps between the K-th and (K+1)-th best
    extension, [B] |K-th score|). Two candidates closer than ``tol`` +
    1e-5 x |score| may be ordered differently by the two sides (a score
    sums a step's f32 log-probability into it at every step). Per row,
    the beams each step kept (``beam_prefixes``, so an order swap of
    near-equal beams is no difference) must agree at every step before
    the row's first such near tie; a row with none must also decode the
    same sentences (as a set) with the same sorted scores within that
    bound. Returns the verdict's counts (``ok`` whether it holds)."""
    margin = np.stack([g for g, _ in margins])      # [T, B]
    near_at = margin < tol + 1e-5 * np.stack([a for _, a in margins])
    out = {"rows": int(want[0].shape[0]), "near_tie_rows": 0,
           "near_tie_first_steps": [], "rows_fully_compared": 0,
           "steps_compared": 0, "ok": True, "score_max_abs_err": 0.0,
           "min_margin": float(margin.min()),
           "median_margin": float(np.median(margin)), "tol": tol}
    for b in range(out["rows"]):
        near = np.nonzero(near_at[:, b])[0]
        first = int(near[0]) if near.size else margin.shape[0]
        same = all(beam_prefixes(got[2], got[3], t, b)
                   == beam_prefixes(want[2], want[3], t, b)
                   for t in range(first))
        out["steps_compared"] += first
        if near.size:
            out["near_tie_rows"] += 1
            out["near_tie_first_steps"].append(first)
        else:
            w = np.sort(want[1][b])
            diff = np.abs(np.sort(got[1][b]) - w)
            err = float(diff.max())
            out["score_max_abs_err"] = max(out["score_max_abs_err"], err)
            same = same and bool((diff <= tol + 1e-5 * np.abs(w)).all()) \
                and sorted(
                map(tuple, got[0][b].tolist())) == sorted(
                map(tuple, want[0][b].tolist()))
            out["rows_fully_compared"] += 1
        out["ok"] = out["ok"] and bool(same)
    return out


def _cpu_verdict(fluid, prog, fetch, scope, feed, card):
    """``near_tie_verdict`` of the card's decode ``card`` (fetches of
    ``feed``'s rows) against the port on the CPU from ``scope``'s
    parameters, margins from the CPU run. Returns (verdict, CPU s)."""
    cpu_scope = fluid.Scope()
    fluid.bridge.load_numpy_params(cpu_scope, _mt_params(scope, prog), "cpu",
                                   prog)
    margins = []
    t0 = time.perf_counter()
    with _swap_impl("beam_search_step", _margin_hook(margins)):
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed=feed, fetch_list=fetch, scope=cpu_scope)
    return (near_tie_verdict(card, cpu, margins, MT_NEAR_TIE),
            time.perf_counter() - t0)


def phase_mt_decode(torch, smi_line, m, scope, runs=3):
    """The beam program (``seq2seq_attention_infer``, beam 4, 50 steps) at
    batch 64 on the trained scope: interpreted (``captured`` false, with
    its reason: the While reads its condition on the host before every
    trip), one warm-up and ``runs`` timed runs (wall ms a batch), one
    profiled (device ms by kind, busy share); each run launches exactly 50
    flash forwards and nothing else of the table. The first MT_CPU_ROWS
    rows against the port on the CPU from the same weights
    (``near_tie_verdict``), and the whole batch (256 beam rows) again
    from the initial weights (the startup run) with the output projection
    scaled by MT_SHARPEN. A few Adam steps move the output weights of the
    tokens of the trained batch alike, so the trained model's best
    candidates lie within the tolerance of each other a few steps in (it
    compares those steps); the random initial logits, spread to a few
    units, keep most candidates apart, so there the rule compares the
    decode of most rows whole."""
    import paddle_tpu_torch as fluid

    prog, outs = m["beam"]
    fetch = _decode_fetch(prog, outs)
    feed = {k: v for k, v in mt_feed(m["spec"], MT_DECODE_BATCH,
                                     SEED + 2).items()
            if k in ("src_ids", "src_len")}
    rows = {k: v[:MT_CPU_ROWS] for k, v in feed.items()}
    exe = fluid.Executor()  # CUDAPlace(0)
    reset_counts()

    def run(on=scope, batch=feed):
        before = read_counts()
        t0 = time.perf_counter()
        got = exe.run(prog, feed=batch, fetch_list=fetch, scope=on)
        dt = time.perf_counter() - t0
        per = {k: v - before[k] for k, v in read_counts().items()}
        check(per == MT_PER_DECODE, "mt_decode run launched %s" % per)
        return got, dt

    card, _ = run()
    wall = [run()[1] for _ in range(runs)]
    device_ms, kernels, prof_wall, top_other = _profile_steps(
        torch, lambda: run()[1], 1)
    report = exe.step_report(prog)
    sharp = fluid.Scope()
    fluid.Executor().run(m["startup"], scope=sharp)
    sharp.set("mt_out_fc_w", sharp.get("mt_out_fc_w") * MT_SHARPEN)
    card_sharp, _ = run(sharp)
    launches = read_counts()
    n_runs = runs + 3
    exe.close()
    verdicts, cpu_s = {}, {}
    for key, on, batch, got in (
            ("trained", scope, rows,
             [card[0][:MT_CPU_ROWS], card[1][:MT_CPU_ROWS],
              card[2][:, :MT_CPU_ROWS], card[3][:, :MT_CPU_ROWS]]),
            ("sharpened", sharp, feed, card_sharp)):
        verdicts[key], cpu_s[key] = _cpu_verdict(fluid, prog, fetch, on,
                                                 batch, got)
    check(read_counts() == launches, "the CPU decode launched a kernel")
    med = statistics.median(wall)
    busy = sum(device_ms.values())
    emit({"phase": "mt_decode", "model": "seq2seq_attention_infer",
          "config": dict(MT, beam_size=MT_BEAM, max_out_len=MT["seq_len"]),
          "batch": MT_DECODE_BATCH, "captured": report["captured"],
          "reason": report["reason"], "step_report": report,
          "runs": n_runs, "wall_ms_per_batch": med * 1e3,
          "wall_ms": [x * 1e3 for x in wall],
          "sentences_per_s": MT_DECODE_BATCH / med,
          "device_ms_per_batch": device_ms, "device_ms": busy,
          "device_busy_share": busy / (med * 1e3),
          "kernels_per_batch": kernels,
          "profiled_wall_ms_per_batch": prof_wall,
          "top_other_kernels": top_other,
          "flash_fwd_per_run": MT_PER_DECODE["flash_attention_fwd"],
          "launches": launches, "cpu_s": cpu_s,
          "cpu_rows": {"trained": MT_CPU_ROWS, "sharpened": MT_DECODE_BATCH},
          "verdicts": verdicts, "device": smi_line})
    check(not report["captured"] and report["reason"].startswith(
        "op 'while_block'"), "mt_decode: %s" % report)
    check(card[0].shape == (MT_DECODE_BATCH, MT_BEAM, MT["seq_len"])
          and np.isfinite(card[1]).all(), "mt_decode: outputs %s"
          % (card[0].shape,))
    check(all(v["ok"] for v in verdicts.values()),
          "mt_decode: card vs CPU %s" % verdicts)
    check(launches == {k: n * n_runs for k, n in MT_PER_DECODE.items()},
          "mt_decode launches %s" % launches)
    return launches, per_run()


def _serve_arm(torch, fluid, prog, outs, scope, reqs, in_flight, k):
    """``reqs`` one-shot through ``ServingEngine(ladder=(1, 2, 4, 8))``
    over a ``ProgramPredictor`` of ``prog`` in a closed loop of
    ``in_flight``: requests/s, p50, p99, the batches, launches."""
    pred = fluid.inference.ProgramPredictor(
        prog, ["src_ids", "src_len"], outs, scope=scope)
    engine = fluid.serving.ServingEngine(pred, num_replicas=1,
                                         ladder=(1, 2, 4, 8))
    before = read_counts()
    try:
        t0 = time.perf_counter()
        warmed = engine.warmup()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        futures = []
        for i, f in enumerate(reqs):
            if i >= in_flight:
                futures[i - in_flight].result(timeout=300)
            futures.append(engine.submit(f))
        results = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t0
        snap = engine.metrics()
    finally:
        engine.shutdown()
    report = pred.step_report()
    runs = exe_runs(pred._exe)
    pred.close()
    launches = {n: v - before[n] for n, v in read_counts().items()}
    for f, (ids, sc) in zip(reqs, results):
        n = f["src_ids"].shape[0]
        want = (n, k, MT["seq_len"]) if k > 1 else (n, MT["seq_len"])
        check(ids.shape == want and sc.shape == want[:-1]
              and np.isfinite(sc).all(), "served %s, %s" % (ids.shape,
                                                            sc.shape))
    lat = snap["latency_s"]
    dispatches = 2 * warmed + snap["batches"]
    check(snap["requests_completed"] == len(reqs)
          and snap["requests_failed"] == 0, "requests failed: %s" % snap)
    check(not report["captured"] and runs == {
        "interpreted": dispatches, "captures": 0, "replays": 0},
        "mt_serve: %s, runs %s, %d dispatches" % (report, runs, dispatches))
    check(launches == {n: v * dispatches for n, v in MT_PER_DECODE.items()},
          "mt_serve launches %s for %d dispatches" % (launches, dispatches))
    return {"requests": len(reqs), "in_flight": in_flight,
            "rows": int(sum(f["src_ids"].shape[0] for f in reqs)),
            "requests_per_s": len(reqs) / wall, "wall_s": wall,
            "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3,
            "batches": snap["batches"],
            "avg_batch_size": snap["avg_batch_size"],
            "batch_occupancy": snap["batch_occupancy"],
            "warmup_runs": 2 * warmed, "warmup_s": t_warm,
            "captured": report["captured"], "reason": report["reason"],
            "runs": runs, "dispatches": dispatches, "launches": launches}


def _solo_vs_batched(fluid, prog, outs, scope, reqs):
    """A request served alone and the same request among three others,
    all at rung 4 (``ladder=(4,)``): bitwise equal ids and scores."""
    pred = fluid.inference.ProgramPredictor(
        prog, ["src_ids", "src_len"], outs, scope=scope)
    engine = fluid.serving.ServingEngine(pred, num_replicas=1, ladder=(4,),
                                         max_wait_ms=50)
    try:
        solo = engine.submit(reqs[0]).result(timeout=300)
        futs = [engine.submit(r) for r in reqs[:4]]
        batched = [f.result(timeout=300) for f in futs]
    finally:
        engine.shutdown()
    pred.close()
    return all(np.array_equal(a, b) for a, b in zip(solo, batched[0]))


def phase_mt_serve(torch, smi_line, m, scope, n_requests=256, in_flight=16,
                   n_greedy=64):
    """The beam program served one-shot: ``n_requests`` requests of 1-4
    sentences (lengths 10-50) in a closed loop of ``in_flight`` through
    ``ServingEngine(ladder=(1, 2, 4, 8))`` over a ``ProgramPredictor`` on
    the trained scope (every dispatch interpreted: the While), then
    ``n_greedy`` through the greedy program the same way. Every dispatch,
    warm-up included, launches 50 flash forwards and nothing else of the
    table. A 1-sentence request served alone and among three others at
    rung 4 gives bitwise equal ids and scores (beam program)."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED + 3)
    seq = MT["seq_len"]
    reqs = []
    for _ in range(n_requests):
        n = int(rng.randint(1, 5))
        reqs.append({"src_ids": rng.randint(2, MT["src_vocab"], (n, seq)),
                     "src_len": rng.randint(seq // 5, seq + 1, (n,))})
    singles = [{k: v[:1] for k, v in r.items()} for r in reqs[:4]]
    reset_counts()
    arms = {"beam": _serve_arm(torch, fluid, *m["beam"], scope, reqs,
                               in_flight, MT_BEAM),
            "greedy": _serve_arm(torch, fluid, *m["greedy"], scope,
                                 reqs[:n_greedy], in_flight, 1)}
    launches = read_counts()
    bitwise = _solo_vs_batched(fluid, *m["beam"], scope, singles)
    emit({"phase": "mt_serve", "model": "seq2seq_attention_infer",
          "config": dict(MT, beam_size=MT_BEAM), "arrival": "closed loop",
          "ladder": [1, 2, 4, 8], "arms": arms, "launches": launches,
          "solo_equals_batched_at_rung_4": bitwise, "device": smi_line})
    check(bitwise, "mt_serve: solo != batched at rung 4")
    return launches, per_run()


def mt_flash_timing(torch, dev):
    """The f32 flash kernels at the NMT model's shapes (one head of 512,
    50 keys, a per-key padding bias [B, 1, 1, 50]) through
    :func:`flash_shape_timing`, each held against its plain version
    first: the forward and backward at the train step's [128, 50, 50] and
    the forward at a decode step's (Tq = 1, batch x beam = 256 rows), with
    the SDPA backend each took."""
    gen = torch.Generator().manual_seed(SEED)
    d, tk = MT["hid_dim"], MT["seq_len"]
    fwd, bwd = flash_shape_timing(torch, dev, gen, MT_TRAIN_BATCH, tk, tk, 1,
                                  d, bwd=True, backend=True)
    decode, _ = flash_shape_timing(torch, dev, gen, MT_DECODE_BATCH * MT_BEAM,
                                   1, tk, 1, d, backend=True)
    rows = {"flash_attention_fwd": {"train": fwd, "decode": decode},
            "flash_attention_bwd": {"train": bwd}}
    for name, r in rows.items():
        emit({"phase": "mt_flash_timing", "kernel": name, "shapes": r})
    return rows


def _sdpa_backend(torch, fn):
    """The SDPA backend one call of ``fn`` took, named from the device
    kernels the profiler saw: ``flash``, ``efficient``, ``cudnn`` or
    ``math``, with the kernels' names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profile_edge(torch, prof)  # late in a run the first records drop
        fn()
        profile_edge(torch, prof)
    names = sorted({e.key for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")
                    and "spin_kernel" not in e.key})  # the edges' guards
    low = " ".join(names).lower()
    kind = ("flash" if "flash" in low else "efficient" if (
        "fmha" in low or "efficient" in low or "mem_eff" in low)
        else "cudnn" if "cudnn" in low else "math")
    return {"backend": kind, "kernels": [n[:80] for n in names[:6]]}


# ---------------------------------------------------------------------------
# The RNN and sequence group: the stacked LSTM at full width (the main path
# of the group), SRL with its CRF (the narrow dense lookups' backward on the
# scatter-add kernel), the other book builders, word2vec's sampled losses
# ---------------------------------------------------------------------------

# the Fluid benchmark's stacked_dynamic_lstm (``models/stacked_lstm.py``
# defaults): 30000 words, embeddings and LSTMs 512 wide (gates 2048), 3
# stacked, the later two reversed, 80 steps, 2 classes
STACKED_LSTM = dict(dict_size=30000, emb_dim=512, hid_dim=512,
                    stacked_num=3, class_num=2, seq_len=80)
LSTM_BATCH = 128
LSTM_LR = 1e-3
# emb 512 does not divide into 128 lanes: the path runs no port kernel
LSTM_PER_STEP = per_run()
# SRL at the book chapter's widths (tests/book/test_label_semantic_roles.py:
# word_dim 32, hidden_dim 512, depth 8); the rest at the builder's
# defaults (500 words, 50 predicates, 20 labels, 16 steps)
SRL = dict(word_dim=32, hidden_dim=512, depth=8)
SRL_BATCH = 128
SRL_LR = 1e-3
# its three tables ([500, 32], [50, 32], [2, 32]) are dense and narrow: one
# scatter-add a table a step (the lookups' backward)
SRL_PER_STEP = per_run(scatter_add=3)
SRL_TABLES = ((500, 32), (50, 32), (2, 32))
# two Viterbi candidates closer than this (+ 1e-5 x |score|) may be
# ordered differently by the card and the CPU
SRL_NEAR_TIE = 2e-4
# the other builders at their defaults: (builder, kwargs, batch, launches a
# step); ngram_lm's shared table is sparse, densified by Adam through the
# scatter-add once a step; nce's negatives come from its op's seed (fixed
# at NCE_SEED on both sides), so the card and the CPU take the same ones
RNN_ZOO = (
    ("understand_sentiment", "books", {}, 64, per_run(scatter_add=1)),
    ("recommender_system", "books", {}, 256, per_run(scatter_add=5)),
    ("fit_a_line", "books", {}, 256, per_run()),
    ("crnn_ctc", "ocr_ctc", {}, 32, per_run()),
    ("ngram_lm", "word2vec", {"loss_type": "nce"}, 256,
     per_run(scatter_add=1)),
    ("ngram_lm", "word2vec", {"loss_type": "hsigmoid"}, 256,
     per_run(scatter_add=1)),
)
NCE_SEED = 7
STEP_TOL = ("loss 1e-4 rel, grads 1e-2 rel L2, Adam updates 1e-2 rel L2 "
            "where no sign flipped; a flip only where the gradient is "
            "within the sides' largest difference of 0")


def _build_trained(fluid, module, fn, kw, lr):
    """``fluid.models.<module>.<fn>(**kw)`` + Adam(lr) in fresh programs
    with fresh names: (main, startup, spec)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        spec = getattr(getattr(fluid.models, module), fn)(**kw)
        fluid.optimizer.Adam(learning_rate=lr).minimize(spec.loss)
    return main, startup, spec


def seq_feed(spec, batch, seq, name, low, seed=SEED):
    """A fixed batch of ``spec``'s feeds with its length feed ``name``
    drawn from [low, seq] (the first row full)."""
    rng = np.random.RandomState(seed)
    feed = spec.sample_batch(batch, rng)
    lens = rng.randint(low, seq + 1, batch)
    lens[0] = seq
    feed[name] = lens.astype("int64")
    return feed


def _step_verdict(names, params, runs):
    """The loss's relative error, every gradient's relative L2 and every
    Adam update's (after - before): a dict; ``ok`` under train_check's
    bounds (loss 1e-4 relative, gradients 1e-2 relative L2) and the
    update's. Adam's first step moves an element by about the rate times
    the sign of its gradient, so where a gradient is within the two
    sides' difference of zero its update may flip sign: a flip is allowed
    only there (|CPU gradient| <= the parameter's largest gradient
    difference; a sparse gradient, one value row per id, bounds no
    element), and the updates of the elements that did not flip must
    agree within 1e-2 relative L2."""
    (gpu, gpu_after), (cpu, cpu_after) = runs["gpu"], runs["cpu"]
    n = len(names)
    loss_err, grad_l2 = _grad_errors(names, gpu[:n + 1], cpu[:n + 1])
    upd_l2, flips, unexplained = {}, 0, {}
    for i, p in enumerate(names):
        dg, dc = gpu_after[p] - params[p], cpu_after[p] - params[p]
        flip = np.sign(dg) != np.sign(dc)
        upd_l2[p] = _rel_l2(np.where(flip, 0.0, dg),
                            np.where(flip, 0.0, dc).astype("f8"))
        flips += int(np.count_nonzero(flip))
        gg, gc = np.asarray(gpu[1 + i]), np.asarray(cpu[1 + i])
        if gg.shape == dg.shape:
            noise = float(np.abs(gg.astype("f8") - gc).max())
            bad = int(np.count_nonzero(flip & (np.abs(gc) > noise)))
            if bad:
                unexplained[p] = bad
    worst_g = max(grad_l2, key=grad_l2.get)
    worst_u = max(upd_l2, key=upd_l2.get)
    finite = np.isfinite(float(gpu[0])) and all(
        np.isfinite(np.asarray(g)).all() for g in gpu[1:n + 1])
    return {"loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
            "loss_rel_err": loss_err, "grads_compared": n,
            "grad_rel_l2_max": grad_l2[worst_g],
            "grad_rel_l2_param": worst_g,
            "update_rel_l2_max": upd_l2[worst_u],
            "update_rel_l2_param": worst_u, "update_sign_flips": flips,
            "update_flips_beyond_grad_noise": unexplained,
            "update_elements": int(sum(p.size for p in params.values())),
            "finite": bool(finite),
            "ok": bool(finite and loss_err <= 1e-4
                       and grad_l2[worst_g] <= 1e-2
                       and upd_l2[worst_u] <= 1e-2 and not unexplained)}


def phase_lstm_train_check(torch, smi_line, batch=2):
    """One full-width stacked-LSTM step (``stacked_lstm_net`` at its
    defaults, Adam(LSTM_LR), batch 2, one row full and one of random
    length) on the card and with the port on the CPU from the same
    weights and feed (f32, TF32 off): the loss, every gradient and every
    Adam update under ``_step_verdict``'s bounds. No port kernel
    launches: the 512-wide table is gathered by ``index_select``."""
    import paddle_tpu_torch as fluid

    main, startup, spec = _build_trained(
        fluid, "stacked_lstm", "stacked_lstm_net", STACKED_LSTM, LSTM_LR)
    feed = seq_feed(spec, batch, STACKED_LSTM["seq_len"], "lengths",
                    STACKED_LSTM["seq_len"] // 5)
    names, params, runs, secs = _card_cpu_step(
        fluid, main, startup, spec, feed, LSTM_PER_STEP, "lstm_train_check")
    v = _step_verdict(names, params, runs)
    emit(dict({"phase": "lstm_train_check", "batch": batch,
               "config": STACKED_LSTM, "optimizer": "Adam(%g)" % LSTM_LR,
               "lengths": feed["lengths"].tolist(),
               "parameters": v["update_elements"],
               "launches": LSTM_PER_STEP, "cpu_step_s": secs["cpu"],
               "gpu_step_s": secs["gpu"],
               "tol": STEP_TOL, "device": smi_line}, **v))
    check(v["ok"], "lstm_train_check: %s" % v)


def phase_lstm_train(torch, smi_line, warmup=3, steps=10, prof_steps=2):
    """The group's main path: ``stacked_lstm_net`` at its defaults
    (30000 x 512 table, three 512-wide LSTMs over 80 steps, the later two
    reversed), Adam(LSTM_LR), batch 128 with random lengths, captured from
    the key's second step on: 3 warm-up and 10 timed steps. Prints ms a
    step, tokens/s (128 x 80 a step), busy share, kernels a step by kind
    (interpreted first step and a replay), device ms by kind (GEMMs,
    gather, other: the LSTM steps' elementwise kernels and Adam), peak
    memory above the state, and ``capture_rule``'s verdict. Returns
    (launches, replayed launches)."""
    import paddle_tpu_torch as fluid

    main, startup, spec = _build_trained(
        fluid, "stacked_lstm", "stacked_lstm_net", STACKED_LSTM, LSTM_LR)
    feed = seq_feed(spec, LSTM_BATCH, STACKED_LSTM["seq_len"], "lengths",
                    STACKED_LSTM["seq_len"] // 5)
    n_params = int(sum(np.prod(p.shape) for p in main.all_parameters()))
    launches, replayed, _ = _train_path(
        torch, fluid, smi_line, "lstm_train", main, startup, spec, feed,
        LSTM_PER_STEP, LSTM_BATCH * STACKED_LSTM["seq_len"], warmup, steps,
        prof_steps, {"model": "stacked_lstm_net", "config": STACKED_LSTM,
                     "parameters": n_params,
                     "valid_tokens_per_step": int(feed["lengths"].sum()),
                     "optimizer": "Adam(%g)" % LSTM_LR})
    return launches, replayed


def build_srl(fluid):
    """SRL (``srl_crf(**SRL)``) + Adam(SRL_LR) and its
    ``clone(for_test=True)``: (main, startup, spec, test program)."""
    main, startup, spec = _build_trained(
        fluid, "label_semantic_roles", "srl_crf", SRL, SRL_LR)
    return main, startup, spec, main.clone(for_test=True)


def srl_feed(spec, batch, seed=SEED):
    return seq_feed(spec, batch, 16, "length", 8, seed)


def viterbi_margins(emission, transition, length):
    """The CPU side's Viterbi decisions in f64 (the reference's recursion,
    ``loss_ops.py:121-170``): per row, the smallest gap between the best
    and the second-best candidate over the decisions its best path takes
    (each kept step's back-pointer and the final state), beside the
    path's |score|."""
    e = emission.astype("f8")
    t = transition.astype("f8")
    start, end, w = t[0], t[1], t[2:]
    b, t_max, d = e.shape
    gaps, scores = np.full(b, np.inf), np.zeros(b)
    for r in range(b):
        n = int(length[r])
        v = start + e[r, 0]
        back, gap_at = [], []
        for s in range(1, n):
            cand = v[:, None] + w                       # [prev, cur]
            srt = np.sort(cand, axis=0)
            back.append(np.argmax(cand, axis=0))
            gap_at.append(srt[-1] - srt[-2])
            v = srt[-1] + e[r, s]
        fin = np.sort(v + end)
        state = int(np.argmax(v + end))
        g = fin[-1] - fin[-2]
        for s in range(len(back) - 1, -1, -1):
            g = min(g, gap_at[s][state])
            state = int(back[s][state])
        gaps[r], scores[r] = g, abs(fin[-1])
    return gaps, scores


def srl_decode_verdict(card, cpu, gaps, scores, length, tol=SRL_NEAR_TIE):
    """The card's Viterbi paths against the CPU's: a row whose decisions
    all clear ``tol`` + 1e-5 x |score| must decode the same path over its
    length (0 past it on both); a row with a near tie may differ. Fewer
    than half the rows may meet one. Returns the counts (``ok``)."""
    near = gaps < tol + 1e-5 * scores
    same = np.array([np.array_equal(card[r], cpu[r])
                     for r in range(card.shape[0])])
    return {"rows": int(card.shape[0]), "near_tie_rows": int(near.sum()),
            "rows_equal": int(same.sum()),
            "rows_differing": int((~same).sum()),
            "rows_differing_without_near_tie": int((~same & ~near).sum()),
            "min_gap": float(gaps.min()), "median_gap": float(
                np.median(gaps)), "tol": tol,
            "steps_compared": int(length[~near].sum()),
            "ok": bool(not (~same & ~near).any()
                       and near.sum() < card.shape[0] / 2)}


# the Fluid book's chunk_eval over SRL's labels: IOB, with
# ceil((label_dict_len - 1) / 2) chunk types (label_dict_len 20)
SRL_CHUNK_TYPES = 10
CHUNK_SLOTS = ("precision", "recall", "f1", "num_infer_chunks",
               "num_label_chunks", "num_correct_chunks")


def srl_chunk_eval(fluid, test, decoded):
    """``chunk_eval`` (IOB, SRL_CHUNK_TYPES) of the decoded paths against
    the label feed over the lengths, appended to the for_test clone: its
    six output names."""
    gb = test.global_block()
    with fluid.program_guard(test, fluid.Program()):
        outs = fluid.layers.chunk_eval(
            gb.var(decoded), gb.var("label"), "IOB", SRL_CHUNK_TYPES,
            gb.var("length"))
    return [o.name for o in outs]


def chunk_verdict(fluid, card_paths, feed, card, cpu, paths_equal):
    """The card's ``chunk_eval`` outputs against ``chunk_eval`` on the CPU
    over the card's own paths (equal: the op on both sides), and against
    the CPU run's where every path decoded equal (its own paths)."""
    L = fluid.layers
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        fluid.unique_name.switch()
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False)
             for k, a in (("inf", card_paths), ("label", feed["label"]),
                          ("length", feed["length"]))}
        outs = L.chunk_eval(v["inf"], v["label"], "IOB", SRL_CHUNK_TYPES,
                            v["length"])
    # in the default scope, where later card phases capture: the scope
    # keeps a generator per device (``executor.rng_name``)
    on_card_paths = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"inf": card_paths, "label": feed["label"],
                    "length": feed["length"]}, fetch_list=list(outs))
    same_op = all(np.array_equal(a, b) for a, b in zip(card, on_card_paths))
    same_run = all(np.array_equal(a, b) for a, b in zip(card, cpu))
    return {"card": {k: np.asarray(x).item() for k, x in zip(CHUNK_SLOTS,
                                                              card)},
            "cpu_run": {k: np.asarray(x).item() for k, x in zip(CHUNK_SLOTS,
                                                                cpu)},
            "equal_to_cpu_on_card_paths": same_op,
            "equal_to_cpu_run": same_run, "paths_equal": paths_equal,
            "ok": bool(same_op and (same_run or not paths_equal))}


def phase_srl_check(torch, smi_line, batch=SRL_BATCH):
    """SRL at the book chapter's widths (``srl_crf(word_dim=32,
    hidden_dim=512, depth=8)``) at batch 128: one training step on the
    card and with the port on the CPU from the same weights and feed, the
    CRF loss, every gradient and Adam update under ``_step_verdict``'s
    bounds, the card's step launching the scatter-add kernel exactly 3
    times (the three narrow tables' backward) and recording
    ``cuda_scatter_add`` on each lookup, the CPU's ``plain_scatter_add``;
    then ``crf_decoding`` through ``clone(for_test=True)`` on both sides
    from the card's updated weights: the paths under
    ``srl_decode_verdict`` (near ties from the CPU side's f64 Viterbi),
    and ``chunk_eval`` (IOB, as the Fluid book scores SRL) of the paths
    against the labels under ``chunk_verdict``."""
    import paddle_tpu_torch as fluid

    main, startup, spec, test = build_srl(fluid)
    feed = srl_feed(spec, batch)
    lookups = [op for op in main.global_block().ops
               if op.type == "lookup_table"]
    check([tuple(op.input("W").shape) for op in lookups]
          == list(SRL_TABLES), "srl tables %s" % [
              op.input("W").shape for op in lookups])
    decoded = spec.fetches["decoded"]
    emission = next(op for op in main.global_block().ops
                    if op.type == "crf_decoding").input("Emission")
    chunks = srl_chunk_eval(fluid, test, decoded.name)
    names, params, runs, secs = _card_cpu_step(
        fluid, main, startup, spec, feed, SRL_PER_STEP, "srl_check")
    choices = [op.attr("_kernel_choice") for op in lookups]
    v = _step_verdict(names, params, runs)
    check(choices == [{"kernel": "plain_scatter_add"}] * 3,
          "srl_check: the CPU run's lookups recorded %s" % choices)
    # the card's updated weights on both sides, one decode each
    weights = runs["gpu"][1]
    outs = {}
    for side, place in (("gpu", None), ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        fluid.bridge.load_program_params(
            scope, weights, main, None if side == "gpu" else "cpu")
        exe = fluid.Executor(place)
        before = read_counts()
        outs[side] = exe.run(test, feed=feed, fetch_list=[
            decoded.name, emission.name] + chunks, scope=scope)
        check(read_counts() == before, "srl decode launched a kernel")
        exe.close()
    gaps, scores = viterbi_margins(outs["cpu"][1], weights["crfw"],
                                   feed["length"])
    dv = srl_decode_verdict(outs["gpu"][0], outs["cpu"][0], gaps, scores,
                            feed["length"])
    cv = chunk_verdict(fluid, outs["gpu"][0], feed, outs["gpu"][2:],
                       outs["cpu"][2:], dv["rows_differing"] == 0)
    emit(dict({"phase": "srl_check", "batch": batch, "config": SRL,
               "tables": [list(t) for t in SRL_TABLES],
               "optimizer": "Adam(%g)" % SRL_LR, "launches": SRL_PER_STEP,
               "kernel_choice_cpu": choices, "cpu_step_s": secs["cpu"],
               "gpu_step_s": secs["gpu"], "decode": dv, "chunk_eval": cv,
               "tol": STEP_TOL + "; paths equal but at near ties; "
                      "chunk_eval's counts equal the CPU's on the card's "
                      "paths, and the CPU run's where the paths are equal",
               "device": smi_line}, **v))
    check(v["ok"], "srl_check step: %s" % v)
    check(dv["ok"], "srl_check decode: %s" % dv)
    check(cv["ok"], "srl_check chunk_eval: %s" % cv)


def phase_srl_train(torch, smi_line, warmup=3, steps=10, prof_steps=2,
                    passes=5):
    """SRL's training path at batch 128 x 16 tokens, Adam(SRL_LR),
    captured: every interpreted or captured step launches the scatter-add
    kernel exactly 3 times; then ``crf_decoding`` through
    ``clone(for_test=True)`` on the trained weights, captured too (ms a
    batch of 128, the paths inside [0, 20) and 0 past each row's
    length). Returns (launches, replayed launches)."""
    import paddle_tpu_torch as fluid

    main, startup, spec, test = build_srl(fluid)
    feed = srl_feed(spec, SRL_BATCH)
    n_params = int(sum(np.prod(p.shape) for p in main.all_parameters()))
    launches, replayed, scope = _train_path(
        torch, fluid, smi_line, "srl_train", main, startup, spec, feed, SRL_PER_STEP,
        SRL_BATCH * 16, warmup, steps, prof_steps,
        {"model": "srl_crf", "config": SRL, "parameters": n_params,
         "tables": [list(t) for t in SRL_TABLES],
         "optimizer": "Adam(%g)" % SRL_LR})
    exe = fluid.Executor()
    decoded = spec.fetches["decoded"].name
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, = exe.run(test, feed=feed, fetch_list=[decoded], scope=scope)
        times.append(time.perf_counter() - t0)
    report = exe.step_report(test)
    exe.close()
    live = np.arange(16)[None, :] < feed["length"][:, None]
    emit({"phase": "srl_train", "case": "decode", "batch": SRL_BATCH,
          "passes": passes, "ms": [x * 1e3 for x in times],
          "ms_median_after_capture": statistics.median(times[2:]) * 1e3,
          "captured": report["captured"], "reason": report["reason"],
          "device": smi_line})
    check(path.shape == (SRL_BATCH, 16) and (path >= 0).all()
          and (path < 20).all() and not path[~live].any(),
          "srl decode paths out of range")
    return launches, replayed


def levenshtein(a, b):
    d = np.arange(len(b) + 1, dtype=np.int64)
    for i, ca in enumerate(a):
        prev, d[0] = d.copy(), i + 1
        for j, cb in enumerate(b):
            d[j + 1] = min(prev[j + 1] + 1, d[j] + 1, prev[j] + (ca != cb))
    return int(d[len(b)])


def ctc_decode_check(fluid, main, feed, weights):
    """``crnn_ctc``'s eval clone decoded as PaddlePaddle's
    ``ocr_recognition`` CTC model decodes it (``ctc_greedy_decoder`` over
    the logits, blank = the last class) and scored with ``edit_distance``
    against the labels, on the card and with the port on the CPU from the
    card's trained weights. A row whose every step's top two logits lie
    more than twice the largest card-vs-CPU logit difference apart on the
    CPU takes the same argmax on both sides, so its ids, length and
    distance must be equal; a row with a nearer tie may differ. Each card
    distance equals a plain Levenshtein of the card's own ids."""
    L = fluid.layers
    test = main.clone(for_test=True)
    gb = test.global_block()
    ctc = next(op for op in gb.ops if op.type == "warpctc")
    logits = ctc.input("Logits")
    with fluid.program_guard(test, fluid.Program()):
        ids, lens = L.ctc_greedy_decoder(gb.var(logits.name),
                                         blank=ctc.attr("blank"))
        dist, _ = L.edit_distance(ids, gb.var("label"), normalized=False,
                                  input_length=lens,
                                  label_length=gb.var("label_len"))
    fetch = [ids, lens, dist, logits.name]
    outs = {}
    for side, place in (("gpu", None), ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        fluid.bridge.load_program_params(
            scope, weights, main, None if side == "gpu" else "cpu")
        exe = fluid.Executor(place)
        outs[side] = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
        exe.close()
    (gi, gl, gd, glog), (ci, cl, cd, clog) = outs["gpu"], outs["cpu"]
    err = float(np.abs(glog - clog).max())
    top2 = np.sort(clog, axis=-1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]).min(axis=1)
    near = gap <= 2 * err
    same = np.array([np.array_equal(gi[r], ci[r]) and gl[r] == cl[r]
                     and gd[r, 0] == cd[r, 0] for r in range(gi.shape[0])])
    lev = all(levenshtein(gi[r, :gl[r]], feed["label"][r, :feed[
        "label_len"][r]]) == gd[r, 0] for r in range(gi.shape[0]))
    return {"rows": int(gi.shape[0]), "logits_max_abs_err": err,
            "min_gap": float(gap.min()), "near_tie_rows": int(near.sum()),
            "rows_equal": int(same.sum()),
            "rows_differing_without_near_tie": int((~same & ~near).sum()),
            "mean_distance_card": float(gd.mean()),
            "mean_distance_cpu": float(cd.mean()),
            "distances_are_levenshtein": bool(lev),
            "ok": bool(lev and not (~same & ~near).any())}


def phase_rnn_zoo_check(torch, smi_line):
    """The group's other builders at their defaults, one Adam(1e-3) step
    each on the card and with the port on the CPU from the same weights
    and feed: ``understand_sentiment`` (its [500, 32] table's backward on
    the scatter-add, 1 launch), ``recommender_system`` (five 16-wide
    tables, 5 launches), ``fit_a_line``, ``crnn_ctc`` (conv + bi-GRU +
    CTC over 62 steps) and ``ngram_lm`` under nce and hsigmoid (the
    sparse shared table densified by Adam through the scatter-add, 1
    launch); nce's negatives from its op's seed, fixed on both sides. The
    loss, gradients and updates under ``_step_verdict``'s bounds;
    ``crnn_ctc``'s eval clone also decoded and scored
    (``ctc_decode_check``); then
    one card step of nce with the executor's generator (seed 0): finite.
    Returns the launches."""
    import paddle_tpu_torch as fluid

    total = per_run()
    for fn, module, kw, batch, per_step in RNN_ZOO:
        main, startup, spec = _build_trained(fluid, module, fn, kw, 1e-3)
        label = "rnn_zoo_check %s%s" % (fn, "".join(
            " " + str(v) for v in kw.values()))
        nce = [op for op in main.global_block().ops if op.type == "nce"]
        for op in nce:
            op.attrs["seed"] = NCE_SEED
        feed = spec.sample_batch(batch, np.random.RandomState(SEED))
        names, params, runs, secs = _card_cpu_step(
            fluid, main, startup, spec, feed, per_step, label)
        v = _step_verdict(names, params, runs)
        total = {k: total[k] + per_step[k] for k in total}
        line = {"phase": "rnn_zoo_check", "builder": fn, "kwargs": kw,
                "batch": batch, "launches": per_step,
                "cpu_step_s": secs["cpu"], "gpu_step_s": secs["gpu"],
                "tol": STEP_TOL, "device": smi_line}
        if fn == "crnn_ctc":
            line["decode"] = ctc_decode_check(fluid, main, feed,
                                              runs["gpu"][1])
            check(line["decode"]["ok"], "%s decode: %s"
                  % (label, line["decode"]))
        if nce:
            for op in nce:
                op.attrs["seed"] = 0
            scope = fluid.Scope()
            exe = fluid.Executor()
            exe.run(startup, scope=scope)
            before = read_counts()
            loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                            scope=scope)
            check(read_counts() == {k: before[k] + per_step[k]
                                    for k in before},
                  "%s seed 0 launches" % label)
            total = {k: total[k] + per_step[k] for k in total}
            exe.close()
            line["seed_0_loss"] = float(loss)
            check(np.isfinite(float(loss)), "%s seed 0 loss %s"
                  % (label, loss))
        emit(dict(line, **v))
        check(v["ok"], "%s: %s" % (label, v))
    return total


def phase_narrow_scatter_check(torch, dev, tol=1e-5):
    """Row 13 at SRL's three tables ([500, 32], [50, 32], [2, 32]) with
    128 x 16 uniform ids each, into zero tables as the lookups' backward
    adds them (the [2, 32] mark table takes about a thousand duplicates a
    row, the per-block sort's worst case): the kernel against its plain
    version within ``tol`` x max(1, the row's |vals| sum) (as
    ``scatter_check``), then timed beside the plain version and one
    ``index_add_`` (int64 rows; timed here only), with its bound (each
    id, val and table element read or written once) and its launches a
    SRL step. Returns ({shape name: row}, max abs error)."""
    from paddle_tpu_torch.ops import scatter as sc

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = SRL_BATCH * 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = {}, 0.0
    for i, (v, k) in enumerate(SRL_TABLES):
        ids = _deepfm_rows(torch, "uniform", n, v, SEED + 20 + i).to(dev)
        vals = torch.randn(n, k, generator=gen, device=dev)
        zero = torch.zeros(v, k, device=dev)
        before = read_counts()["scatter_add"]
        got = sc.scatter_add_rows(zero, ids, vals)
        check(read_counts()["scatter_add"] == before + 1,
              "narrow scatter %dx%d did not launch once" % (v, k))
        want = sc.scatter_add_plain(zero, ids, vals)
        mass = sc.scatter_add_plain(zero, ids, vals.abs())
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = (err / mass.clamp_min(1.0)).max().item()
        worst = max(worst, err.max().item())
        hot = int(torch.bincount(ids.long(), minlength=v).max().item())
        out = torch.zeros(v, k, device=dev)
        ids64 = ids.long()
        nbytes = 4 * (n * k + n + 2 * v * k)
        bnd, by = bound(nbytes, n * k)
        name = "%dx%d" % (v, k)
        rows[name] = dict(
            ms=time_ms(lambda: sc.scatter_add(out, ids, vals)),
            plain_ms=time_ms(lambda: sc.scatter_add_plain(out, ids, vals,
                                                          inplace=True)),
            library_ms=time_ms(lambda: out.index_add_(0, ids64, vals)),
            library="Tensor.index_add_ (int64 rows, all in range)",
            bound_ms=bnd, bound_by=by, shape=[v, k, n], bytes=nbytes,
            flops=n * k, launches_per_srl_step=1, max_abs_err=err.max().item(),
            max_err_over_row_mass=rel, hottest_row_slots=hot,
            plan=list(sc.scatter_plan(n, k, True, sms)))
        emit(dict({"phase": "narrow_scatter_check", "case": name,
                   "tol": "%g * max(1, sum over the row's slots of |vals|)"
                   % tol}, **rows[name]))
        check(rel <= tol, "narrow scatter %s: error %g of the row mass > %g"
              % (name, rel, tol))
    return rows, worst


# ---------------------------------------------------------------------------
# detection: the 26 detection ops at their published sizes, and SSD
# (models.ssd.ssd_lite) trained, served through its for_test clone and
# scored. No port kernel lies on this path (the trunk's four 3x3 stride-2
# convs are outside the fused conv's geometries): every count stays 0.
# ---------------------------------------------------------------------------

SSD_LITE = dict(num_classes=5, image_shape=(3, 64, 64), max_boxes=4)
SSD_BATCH = 128
SSD_LR = 2e-3  # tests/test_models.py's rate
SSD_PER_STEP = per_run()
# a score gap, an IoU's distance from the NMS threshold or a loss gap at
# the mining cut below this (absolute; the card's and the CPU's NMS inputs
# differ by ~1e-7, see ssd_eval's line) may decide differently on the two
SSD_NEAR_TIE = 1e-5
# SSD300 (Liu et al. 2016) on VOC: six maps, 8,732 priors, 21 classes
SSD300_MAPS = ((38, 30.0, 60.0, (2.0,)), (19, 60.0, 111.0, (2.0, 3.0)),
               (10, 111.0, 162.0, (2.0, 3.0)), (5, 162.0, 213.0, (2.0, 3.0)),
               (3, 213.0, 264.0, (2.0,)), (1, 264.0, 315.0, (2.0,)))
SSD300_STEPS = (8.0, 16.0, 32.0, 64.0, 100.0, 300.0)
# YOLOv3-416's anchors and heads (13/26/52, strides 32/16/8)
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((13, [6, 7, 8], 32), (26, [3, 4, 5], 16), (52, [0, 1, 2], 8))


def _det_boxes(rng, shape, lo, hi, min_size):
    """Boxes [*shape, 4], corners sorted, at least ``min_size`` wide and
    high, inside [lo, hi]."""
    a = rng.uniform(lo, hi - min_size, tuple(shape) + (2,))
    size = rng.uniform(min_size, (hi - lo) / 4, tuple(shape) + (2,))
    return np.concatenate([a, np.minimum(a + size, hi)], -1).astype("f4")


def _padded_gt(rng, n, g, lo, hi, min_size, real):
    """[n, g, 4] gt boxes, the first ``real`` of each row real, the rest
    zero rows (padding)."""
    gt = _det_boxes(rng, (n, g), lo, hi, min_size)
    gt[:, real:] = 0.0
    return gt


def _ssd300_priors(fluid, v):
    """SSD300's 8,732 priors and variances from its six maps' prior_box
    (min/max sizes, ratios with flips, steps as Liu et al. 2016)."""
    L = fluid.layers
    boxes, var = [], []
    for (s, mn, mx, ars), step in zip(SSD300_MAPS, SSD300_STEPS):
        b, vr = L.prior_box(v["f%d" % s], v["image300"], min_sizes=[mn],
                            max_sizes=[mx], aspect_ratios=list(ars),
                            flip=True, steps=(step, step))
        boxes.append(L.reshape(b, [-1, 4]))
        var.append(L.reshape(vr, [-1, 4]))
    return L.concat(boxes, axis=0), L.concat(var, axis=0)


def _det_inputs(rng):
    """Seeded inputs of every detection-op case, at the published models'
    sizes (SSD300 VOC batch 8; a Faster R-CNN RPN at 800 x 1333, stride
    16, batch 2; YOLOv3-416 batch 8; R-FCN's position-sensitive map)."""
    f = {}
    for s, _, _, _ in SSD300_MAPS:
        f["f%d" % s] = np.zeros((1, 1, s, s), "f4")
    f["image300"] = np.zeros((1, 3, 300, 300), "f4")
    f["f32map"] = np.zeros((1, 1, 32, 32), "f4")
    f["image1024"] = np.zeros((1, 3, 1024, 1024), "f4")
    logits = rng.randn(8, 8732, 21).astype("f4") * 2.0
    logits[..., 0] += 4.0  # most priors are background, as trained
    e = np.exp(logits - logits.max(-1, keepdims=True))
    f["ssd_scores"] = (e / e.sum(-1, keepdims=True)).astype("f4")
    f["ssd_loc"] = (0.5 * rng.randn(8, 8732, 4)).astype("f4")
    f["nms_boxes"] = _det_boxes(rng, (8, 8732), 0.0, 1.0, 0.02)
    f["nms_scores"] = rng.uniform(0, 1, (8, 21, 8732)).astype("f4")
    f["ssd_gt"] = _padded_gt(rng, 8, 50, 0.0, 1.0, 0.03, 20)
    f["ssd_gt_lbl"] = rng.randint(1, 21, (8, 50, 1)).astype("int32")
    f["ssd_gt_lbl"][:, 20:] = 0
    f["dist"] = rng.uniform(0, 1, (8, 20, 8732)).astype("f4")
    match = np.full((8, 8732), -1, "int32")
    pos = rng.uniform(0, 1, (8, 8732)) < 0.02
    match[pos] = rng.randint(0, 20, int(pos.sum()))
    f["match"] = match
    f["cls_loss"] = rng.uniform(0, 5, (8, 8732)).astype("f4")
    f["mined"] = np.where(match >= 0, match, np.where(
        rng.uniform(0, 1, (8, 8732)) < 0.06, -1, -2)).astype("int32")
    # Faster R-CNN RPN (C4, stride 16) at 800 x 1333: a 50 x 84 map
    f["c4_shape"] = np.zeros((1, 1, 50, 84), "f4")
    f["rpn_scores"] = rng.uniform(0, 1, (2, 15, 50, 84)).astype("f4")
    f["rpn_deltas"] = (0.2 * rng.randn(2, 60, 50, 84)).astype("f4")
    f["im_info"] = np.array([[800, 1333, 1.0]] * 2, "f4")
    f["rpn_gt"] = _padded_gt(rng, 2, 20, 0.0, 780.0, 16.0, 12)
    f["c4"] = rng.randn(2, 1024, 50, 84).astype("f4")
    f["rois"] = _det_boxes(rng, (1024,), 0.0, 780.0, 32.0)
    f["prop_rois"] = _det_boxes(rng, (2, 2000), 0.0, 780.0, 16.0)
    f["prop_rois"][:, :200] = np.repeat(f["rpn_gt"][:, :10], 20, 1) \
        + rng.uniform(-8, 8, (2, 200, 4)).astype("f4")
    f["prop_cls"] = rng.randint(1, 81, (2, 20)).astype("int32")
    f["prop_cls"][:, 12:] = 0
    # R-FCN: 21 classes x 7 x 7 bins on a 38 x 63 map (600 x 1000)
    f["ps_map"] = rng.randn(1, 21 * 49, 38, 63).astype("f4")
    f["ps_rois"] = _det_boxes(rng, (300,), 0.0, 590.0, 32.0)
    # Mask R-CNN: 128 foreground RoIs an image, 81 classes, 14 x 14
    segms = np.zeros((2, 20, 2, 16, 2), "f4")
    ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    for i in range(2):
        for g in range(20):
            cx, cy = rng.uniform(60, 700, 2)
            r = rng.uniform(10, 60, (2, 16))
            for p in range(2):
                segms[i, g, p, :, 0] = cx + (p + 1) * r[p] * np.cos(ang) / 2
                segms[i, g, p, :, 1] = cy + (p + 1) * r[p] * np.sin(ang) / 2
    f["segms"] = segms
    f["mask_cls"] = f["prop_cls"]
    f["crowd"] = (rng.uniform(0, 1, (2, 20)) < 0.1).astype("int32")
    f["mask_rois"] = _det_boxes(rng, (2, 128), 0.0, 780.0, 16.0)
    f["mask_labels"] = rng.randint(0, 81, (2, 128)).astype("int32")
    f["quad_map"] = rng.randn(1, 32, 64, 128).astype("f4")
    quads = _det_boxes(rng, (128,), 3.0, 57.0, 8.0)  # inside, jittered
    quads[:, 0::2] *= 2.0  # x across the map's 128 columns, y its 64 rows
    f["quads"] = quads[:, [0, 1, 2, 1, 2, 3, 0, 3]] + rng.uniform(
        -2, 2, (128, 8)).astype("f4")
    f["east"] = rng.randn(8, 8, 128, 128).astype("f4")
    f["clip_boxes"] = rng.uniform(-100, 1500, (2, 63000, 4)).astype("f4")
    for s, _, _ in YOLO_HEADS:
        f["yolo%d" % s] = (0.5 * rng.randn(8, 255, s, s)).astype("f4")
    yolo_gt = np.zeros((8, 50, 4), "f4")
    yolo_gt[:, :30, :2] = rng.uniform(0.05, 0.95, (8, 30, 2))
    yolo_gt[:, :30, 2:] = rng.uniform(0.02, 0.6, (8, 30, 2))
    f["yolo_gt"] = yolo_gt
    f["yolo_lbl"] = rng.randint(0, 80, (8, 50)).astype("int32")
    det = np.full((8, 200, 6), -1.0, "f4")
    gt = f["ssd_gt"][:, :20]
    det[:, :150, 0] = rng.randint(1, 21, (8, 150))
    det[:, :150, 1] = rng.uniform(0.01, 1, (8, 150))
    pick = rng.randint(0, 20, (8, 150))
    det[:, :150, 2:] = np.take_along_axis(gt, pick[..., None], 1) \
        + rng.uniform(-0.02, 0.02, (8, 150, 4))
    det[:, :100, 0] = np.take_along_axis(f["ssd_gt_lbl"][..., 0], pick,
                                         1)[:, :100]
    f["det"] = det
    f["map_gt_lbl"] = f["ssd_gt_lbl"][:, :20, 0]
    f["map_gt"] = np.ascontiguousarray(gt)
    return f


def _raw_op(fluid, op_type, inputs, outputs, attrs=None, shape=None):
    """One op with fresh outputs ({slot: dtype}, of ``shape`` if given);
    the outputs in order."""
    from paddle_tpu_torch.core.layer_helper import LayerHelper

    helper = LayerHelper(op_type)
    outs = {s: helper.create_variable_for_type_inference(dtype=d,
                                                         shape=shape)
            for s, d in outputs.items()}
    helper.append_op(op_type, inputs, outs, attrs or {})
    return list(outs.values())


def _yolo_heads(fluid, v):
    return [fluid.layers.yolov3_loss(
        v["yolo%d" % s], v["yolo_gt"], v["yolo_lbl"], YOLO_ANCHORS, mask, 80,
        ignore_thresh=0.7, downsample_ratio=down)
        for s, mask, down in YOLO_HEADS]


# name -> (the published model whose size it runs at, float inputs whose
# gradient of sum(out^2) is checked, other inputs, build(fluid, vars))
DETECTION_CASES = {
    "detection_output": (
        "SSD300 VOC, batch 8: 8,732 priors, 21 classes, nms_top_k 400, "
        "keep_top_k 200, NMS 0.45", [],
        ["@ssd300", "ssd_loc",
         "ssd_scores"],
        lambda fl, v: list(fl.layers.detection_output(
            v["ssd_loc"], v["ssd_scores"], *_ssd300_priors(fl, v),
            nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
            score_threshold=0.01))),
    "multiclass_nms": (
        "SSD300 VOC's NMS alone, batch 8", [], ["nms_boxes", "nms_scores"],
        lambda fl, v: list(fl.layers.multiclass_nms(
            v["nms_boxes"], v["nms_scores"], score_threshold=0.01,
            nms_top_k=400, keep_top_k=200, nms_threshold=0.45))),
    "ssd300_targets": (
        "SSD300 training targets, batch 8, 50 gt rows (20 real)", [],
        ["@ssd300", "ssd_gt",
         "ssd_gt_lbl"],
        lambda fl, v: _ssd_targets(fl, v)),
    "box_coder_encode": (
        "SSD300: 50 gt against 8,732 priors", [],
        ["@ssd300", "map_gt"],
        lambda fl, v: [fl.layers.box_coder(
            *_ssd300_priors(fl, v), fl.layers.reshape(v["map_gt"], [-1, 4]))]),
    "bipartite_match": (
        "SSD300: 20 gt x 8,732 priors, batch 8, per_prediction", [],
        ["dist"], lambda fl, v: list(fl.layers.bipartite_match(
            v["dist"], match_type="per_prediction", dist_threshold=0.5))),
    "target_assign": (
        "SSD300, batch 8", [], ["ssd_gt", "match"],
        lambda fl, v: list(fl.layers.target_assign(v["ssd_gt"], v["match"]))),
    "mine_hard_examples": (
        "SSD300, batch 8, ratio 3", [], ["cls_loss", "match"],
        lambda fl, v: [fl.layers.mine_hard_examples(v["cls_loss"],
                                                    v["match"])]),
    "ssd_mining_masks": (
        "SSD300, batch 8", [], ["mined"],
        lambda fl, v: _raw_op(fl, "ssd_mining_masks", {"Mined": v["mined"]},
                              {"Selected": "float32",
                               "Positive": "float32"})),
    "density_prior_box": (
        "FaceBoxes' 32 x 32 map of a 1024 x 1024 image: densities 4, 2, 1",
        [], ["f32map", "image1024"],
        lambda fl, v: list(fl.layers.density_prior_box(
            v["f32map"], v["image1024"], densities=[4, 2, 1],
            fixed_sizes=[32.0, 64.0, 128.0], fixed_ratios=[1.0],
            clip=True))),
    "anchor_generator": (
        "Faster R-CNN C4 at 800 x 1333: 50 x 84 x 15 anchors", [],
        ["c4_shape"], lambda fl, v: list(fl.layers.anchor_generator(
            v["c4_shape"], anchor_sizes=[32.0, 64.0, 128.0, 256.0, 512.0],
            aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0]))),
    "generate_proposals": (
        "Faster R-CNN RPN, batch 2: 63,000 anchors, pre 6000, post 1000, "
        "NMS 0.7", [], ["rpn_scores", "rpn_deltas", "im_info", "c4_shape"],
        lambda fl, v: _proposals(fl, v)),
    "rpn_target_assign": (
        "Faster R-CNN RPN, batch 2: 63,000 anchors, 20 gt rows (12 real)",
        [], ["c4_shape", "rpn_gt"], lambda fl, v: _rpn_targets(fl, v)),
    "box_clip": (
        "Faster R-CNN: 63,000 boxes an image, batch 2", [],
        ["clip_boxes", "im_info"],
        lambda fl, v: [fl.layers.box_clip(v["clip_boxes"], v["im_info"])]),
    "roi_align": (
        "Faster R-CNN C4: 1,024 RoIs (2 x 512, every RoI reads image 0), "
        "7 x 7, [2, 1024, 50, 84]", ["c4"], ["rois"],
        lambda fl, v: [fl.layers.roi_align(v["c4"], v["rois"], 7, 7,
                                           spatial_scale=1.0 / 16)]),
    "roi_pool": (
        "Fast R-CNN C4: 1,024 RoIs, 7 x 7, [2, 1024, 50, 84]", ["c4"],
        ["rois"], lambda fl, v: [fl.layers.roi_pool(
            v["c4"], v["rois"], 7, 7, spatial_scale=1.0 / 16)]),
    "psroi_pool": (
        "R-FCN: 300 RoIs, 21 classes x 7 x 7 bins, [1, 1029, 38, 63]",
        ["ps_map"], ["ps_rois"], lambda fl, v: [fl.layers.psroi_pool(
            v["ps_map"], v["ps_rois"], 21, 1.0 / 16, 7, 7)]),
    "generate_proposal_labels": (
        "Faster R-CNN, batch 2: 2,000 RoIs, 20 gt rows, 512 sampled", [],
        ["prop_rois", "prop_cls", "rpn_gt"],
        lambda fl, v: _raw_op(
            fl, "generate_proposal_labels",
            {"RpnRois": v["prop_rois"], "GtClasses": v["prop_cls"],
             "GtBoxes": v["rpn_gt"]},
            {"LabelsInt32": "int32", "BboxTargets": "float32",
             "BboxInsideWeights": "float32"}, {"batch_size_per_im": 512})),
    "generate_mask_labels": (
        "Mask R-CNN, batch 2: 128 RoIs, 20 gt of 2 polygons, 81 classes, "
        "14 x 14", [], ["im_info", "mask_cls", "crowd", "segms",
                        "mask_rois", "mask_labels"],
        lambda fl, v: _raw_op(
            fl, "generate_mask_labels",
            {"ImInfo": v["im_info"], "GtClasses": v["mask_cls"],
             "IsCrowd": v["crowd"], "GtSegms": v["segms"],
             "Rois": v["mask_rois"], "LabelsInt32": v["mask_labels"]},
            {"MaskRois": "float32", "RoiHasMaskInt32": "int32",
             "MaskInt32": "int32"}, {"num_classes": 81, "resolution": 14})),
    "roi_perspective_transform": (
        "text RoIs: 128 quads on [1, 32, 64, 128], 8 x 32", ["quad_map"],
        ["quads"], lambda fl, v: _raw_op(
            fl, "roi_perspective_transform",
            {"X": v["quad_map"], "ROIs": v["quads"]}, {"Out": "float32"},
            {"transformed_height": 8, "transformed_width": 32})),
    "polygon_box_transform": (
        "EAST: [8, 8, 128, 128]", [], ["east"],
        lambda fl, v: [fl.layers.polygon_box_transform(v["east"])]),
    "yolov3_loss": (
        "YOLOv3-416, batch 8: heads 13/26/52, 80 classes, 50 gt rows",
        ["yolo13", "yolo26", "yolo52"],
        ["yolo_gt", "yolo_lbl"], lambda fl, v: _yolo_heads(fl, v)),
    "detection_map": (
        "VOC: 8 images x 200 detections, 20 gt rows, 21 classes", [],
        ["det", "map_gt_lbl", "map_gt"],
        lambda fl, v: [fl.layers.detection_map(
            v["det"], v["map_gt_lbl"], v["map_gt"], 21),
            fl.layers.detection_map(v["det"], v["map_gt_lbl"], v["map_gt"],
                                    21, ap_version="11point")]),
}


def _ssd_targets(fluid, v):
    """ssd_loss's target ops at SSD300's size: IoU of every gt with every
    prior (batched and plain), the match, the encoded targets, the
    labels, the per-prior smooth-L1 against them."""
    L = fluid.layers
    prior, pvar = _ssd300_priors(fluid, v)
    iou = _raw_op(fluid, "batched_iou_similarity",
                  {"X": v["ssd_gt"], "Y": prior}, {"Out": "float32"},
                  shape=tuple(v["ssd_gt"].shape[:2]) + (-1,))[0]
    one = L.iou_similarity(L.reshape(L.slice(v["ssd_gt"], [0], [0], [1]),
                                     [-1, 4]), prior)
    match, _ = L.bipartite_match(iou, match_type="per_prediction")
    enc = _raw_op(fluid, "ssd_encode_matched",
                  {"GTBox": v["ssd_gt"], "MatchIndices": match,
                   "PriorBox": prior, "PriorBoxVar": pvar},
                  {"Out": "float32"})[0]
    lbl = _raw_op(fluid, "ssd_gather_labels",
                  {"GTLabel": v["ssd_gt_lbl"], "MatchIndices": match},
                  {"Out": "int32"})[0]
    l1 = _raw_op(fluid, "ssd_smooth_l1", {"X": enc, "Y": L.scale(enc, 0.5)},
                 {"Out": "float32"})[0]
    return [iou, one, match, enc, lbl, l1]


def _proposals(fluid, v):
    anchors, var = fluid.layers.anchor_generator(
        v["c4_shape"], anchor_sizes=[32.0, 64.0, 128.0, 256.0, 512.0],
        aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0])
    return list(fluid.layers.generate_proposals(
        v["rpn_scores"], v["rpn_deltas"], v["im_info"], anchors, var,
        pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.7,
        min_size=0.1))


def _rpn_targets(fluid, v):
    anchors, _ = fluid.layers.anchor_generator(
        v["c4_shape"], anchor_sizes=[32.0, 64.0, 128.0, 256.0, 512.0],
        aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0])
    return _raw_op(fluid, "rpn_target_assign",
                   {"Anchor": anchors, "GtBoxes": v["rpn_gt"]},
                   {"ScoreLabel": "int32", "LocTarget": "float32"})


def _det_program(fluid, build, inputs, floats):
    """A case's program: data vars of ``inputs``, ``build``'s outputs, and
    the gradient of the sum over its float outputs of out^2 w.r.t.
    ``floats``. Returns (main, outs, grads, the ops ``build`` added)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        v = {k: L.data(k, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False, stop_gradient=k not in floats)
             for k, a in inputs.items()}
        outs = build(fluid, v)
        n_ops = len(main.global_block().ops)
        grads = []
        if floats:
            terms = [L.reduce_sum(L.elementwise_mul(o, o)) for o in outs
                     if str(o.dtype) == "float32"]
            total = terms[0] if len(terms) == 1 else L.sums(terms)
            grads = fluid.gradients(total, [v[k] for k in floats])
    return main, outs, grads, main.global_block().ops[:n_ops]


def _case_keys(keys):
    """A case's input names, "@ssd300" standing for SSD300's six maps and
    its image."""
    out = []
    for k in keys:
        out += (["f%d" % m[0] for m in SSD300_MAPS] + ["image300"]
                if k == "@ssd300" else [k])
    return out


def _det_compare(got, want, n_out):
    """Card vs CPU fetches: floats by their largest error over max(1,
    max |CPU|) (outputs) or relative L2 (gradients); ints equal."""
    errs, rel, equal, grad_l2, per = [], [], True, [], []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        check(g.shape == w.shape, "shape %s != %s" % (g.shape, w.shape))
        per.append(int((g != w).sum()) if w.dtype.kind in "biu" else
                   float(np.abs(g.astype("f8") - w).max()) if w.size
                   else 0.0)
        if w.dtype.kind in "biu":
            equal = equal and bool(np.array_equal(g, w))
        elif i < n_out:
            e = float(np.abs(g.astype("f8") - w).max()) if w.size else 0.0
            errs.append(e)
            rel.append(e / max(1.0, float(np.abs(w).max()) if w.size
                               else 1.0))
        else:
            grad_l2.append(_rel_l2(g, w))
    return {"max_abs_err": max(errs, default=0.0),
            "max_err_over_magnitude": max(rel, default=0.0),
            "discrete_equal": equal,
            "grad_rel_l2": max(grad_l2, default=None),
            "per_fetch": per}


def _time_ops(torch, ops, env, runs=5):
    """Wall ms of ``ops`` run by the interpreter (``run_op``) over device
    tensors, each run closed by a synchronize: median of ``runs`` after
    one warm-up, and the peak memory above what ``env`` holds."""
    from paddle_tpu_torch.core.op_registry import run_op

    def once():
        local = dict(env)
        t0 = time.perf_counter()
        for op in ops:
            run_op(local, op)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.no_grad():
        once()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = [once() for _ in range(runs)]
        peak = torch.cuda.max_memory_allocated() - base
    return statistics.median(times) * 1e3, [t * 1e3 for t in times], peak


# op-by-op checks (detection, misc and nn ops, the attention layer)
OP_OUT_TOL = 1e-5  # largest error over max(1, max |CPU output|)
OP_GRAD_TOL = 1e-5  # gradient relative L2


def _op_cases_check(torch, smi_line, phase, cases):
    """Each case of ``cases`` ((name, size, feed, differentiated inputs,
    build, own)) as a program of its ops (``_det_program``) on the card
    against the port on the CPU, on the same feed, each run in a scope of
    its own: float outputs within OP_OUT_TOL of max(1, max |CPU|), the
    gradients of sum(out^2) within OP_GRAD_TOL relative L2, and every
    integer and boolean output equal (``_det_compare``). A case with an
    ``own`` check draws from each side's generator instead: ``own(fetches,
    feed)`` holds each side's output to its own draw. Per case: the
    interpreted wall ms of its ops over device tensors (``_time_ops``),
    the peak memory, the CPU's seconds. The counts are zeroed first and
    must stay 0 (no port kernel). Returns (the largest output error over
    the compared cases, the op types run, the counts)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import to_tensor
    from paddle_tpu_torch.core.op_registry import RNG_KEY

    dev = fluid.CUDAPlace(0).torch_device()
    seen, worst = set(), 0.0
    tol = "outputs %g of max(1, max|CPU|), gradients %g rel L2, discrete " \
          "equal" % (OP_OUT_TOL, OP_GRAD_TOL)
    reset_counts()
    for name, size, feed, floats, build, own in cases:
        t_case = time.perf_counter()
        main, outs, grads, fwd = _det_program(fluid, build, feed, floats)
        seen |= {op.type for op in fwd}
        fetch = outs + list(grads)
        card = fluid.Executor().run(main, feed=feed, fetch_list=fetch,
                                    scope=fluid.Scope())
        t0 = time.perf_counter()
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=fluid.Scope())
        cpu_s = time.perf_counter() - t0
        env = {k: to_tensor(a, dev, main.global_block().var(k))
               for k, a in feed.items()}
        env[RNG_KEY] = torch.Generator(device=dev).manual_seed(SEED)
        ms, all_ms, peak = _time_ops(torch, fwd, env)
        line = {"phase": phase, "case": name, "size": size,
                "op_types": sorted({op.type for op in fwd}),
                "interpreted_ms": ms, "interpreted_ms_runs": all_ms,
                "peak_bytes_above_inputs": peak, "cpu_s": cpu_s,
                "outputs": [list(np.shape(o)) for o in card],
                "device": smi_line}
        if own is None:
            cmp = _det_compare(card, cpu, len(outs))
            worst = max(worst, cmp["max_err_over_magnitude"])
            ok = (cmp["max_err_over_magnitude"] <= OP_OUT_TOL
                  and cmp["discrete_equal"]
                  and (cmp["grad_rel_l2"] is None
                       or cmp["grad_rel_l2"] <= OP_GRAD_TOL))
            line.update(cmp, tol=tol)
        else:
            (ok_card, card_draw), (ok_cpu, cpu_draw) = own(card, feed), \
                own(cpu, feed)
            ok = ok_card and ok_cpu
            line.update(card_draw=card_draw, cpu_draw=cpu_draw,
                        tol="each side's output equals its own draw")
        emit(dict(line, ok=ok, case_s=time.perf_counter() - t_case))
        check(ok, "%s %s: %s" % (phase, name, line))
        del card, cpu, env
    counts = read_counts()
    check(counts == per_run(), "%s: a port kernel launched: %s"
          % (phase, counts))
    return worst, seen, counts


def phase_detection_ops_check(torch, smi_line):
    """Each of the 26 detection op types on the card against the port on
    the CPU, on the same seeded inputs at the published model's size
    (``DETECTION_CASES``), under ``_op_cases_check``: the gradient of
    sum(out^2) of roi_align, roi_pool, psroi_pool, roi_perspective_transform
    and yolov3_loss is held, and every discrete output (matches, mined
    indices, labels, NMS keeps, counts) equal: the decode's exp is taken
    in f64 and rounded once (``detection_ops.exp_once``), so both sides
    feed their NMS the same boxes bitwise, and the remaining arithmetic
    before a decision is IEEE-exact on both. Returns the path's counts (no
    port kernel launches)."""
    from paddle_tpu_torch.core.op_registry import OP_IMPLS

    inputs = _det_inputs(np.random.RandomState(SEED + 21))
    _, seen, counts = _op_cases_check(torch, smi_line, "detection_ops_check", (
        (name, size, {k: inputs[k] for k in floats + _case_keys(others)},
         floats, build, None)
        for name, (size, floats, others, build) in DETECTION_CASES.items()))
    types = {n for n, f in OP_IMPLS.items() if f.__module__.endswith(
        ".detection_ops")} | {"detection_map", "psroi_pool"}
    check(len(types) == 26 and types <= seen,
          "detection ops not run: %s" % sorted(types - seen))
    return counts


def build_ssd(fluid):
    """``ssd_lite(**SSD_LITE)`` + Adam(SSD_LR), and its
    ``clone(for_test=True)`` with a ``detection_map`` over the clone's
    detections and the gt feeds: (main, startup, spec, mAP var, test
    program)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        spec = fluid.models.ssd.ssd_lite(**SSD_LITE)
        fluid.optimizer.Adam(learning_rate=SSD_LR).minimize(spec.loss)
    test = main.clone(for_test=True)
    with fluid.program_guard(test, fluid.Program()):
        gb = test.global_block()
        m_ap = fluid.layers.detection_map(
            gb.var(spec.fetches["detections"].name), fluid.layers.reshape(
                gb.var("gt_label"), [-1, SSD_LITE["max_boxes"]]),
            gb.var("gt_box"), class_num=SSD_LITE["num_classes"])
    return main, startup, spec, m_ap, test


def ssd_feed(spec, batch, seed=SEED):
    """A fixed batch: images from ``spec``'s recipe; gt boxes with sorted
    corners in [0.05, 0.95], 1-4 real an image and zero rows as padding
    (labels 1..4, 0 on padding), as ``tests/test_detection.py`` draws
    them (``FeedSpec`` draws each corner on its own)."""
    rng = np.random.RandomState(seed)
    feed = spec.sample_batch(batch, rng)
    g = SSD_LITE["max_boxes"]
    c = np.sort(rng.uniform(0.05, 0.95, (batch, g, 2, 2)), axis=2)
    real = np.arange(g)[None] < rng.randint(1, g + 1, batch)[:, None]
    feed["gt_box"] = (c.reshape(batch, g, 4) * real[..., None]).astype("f4")
    feed["gt_label"] = (rng.randint(1, SSD_LITE["num_classes"],
                                    (batch, g, 1)) * real[..., None]) \
        .astype("int64")
    return feed


def bipartite_margins(dist):
    """The greedy bipartite match's decisions on [B, M, N] (f64, the
    reference's order): per image, the smallest gap between the best and
    the second-best live entry over its steps, and over the columns left
    unmatched, the smallest distance of their best row from the
    per_prediction threshold (0.5)."""
    out = []
    for d in np.asarray(dist, "f8"):
        live, gap, m, n = d.copy(), np.inf, d.shape[0], d.shape[1]
        matched = np.zeros(n, bool)
        for _ in range(min(m, n)):
            flat = np.sort(live.ravel())[::-1]
            i, j = np.unravel_index(np.argmax(live), live.shape)
            if live[i, j] <= 0:
                break
            gap = min(gap, flat[0] - flat[1], flat[0])
            matched[j] = True
            live[i, :] = -1
            live[:, j] = -1
        thr = np.abs(d.max(0)[~matched] - 0.5)
        out.append(min(gap, thr.min() if thr.size else np.inf))
    return np.array(out)


def mining_margins(cls_loss, match, ratio=3.0):
    """The CPU's mining cut per image: the gap between the last kept and
    the first dropped negative's loss (inf where every negative is kept
    or none is)."""
    out = []
    for loss, mi in zip(np.asarray(cls_loss, "f8"), np.asarray(match)):
        n_neg = min(int(np.float32(int((mi >= 0).sum())) * np.float32(ratio)),
                    loss.size)
        neg = np.sort(loss[mi < 0])[::-1]
        out.append(neg[n_neg - 1] - neg[n_neg]
                   if 0 < n_neg < neg.size else np.inf)
    return np.array(out)


def phase_ssd_train_check(torch, smi_line, batch=4):
    """One ``ssd_lite`` Adam step at batch 4 on the card and with the port
    on the CPU from one initial state (f32, TF32 off): the loss, every
    gradient and every Adam update under ``_step_verdict``'s bounds; the
    bipartite match (its IoU from the same gt and priors) and the mined
    indices equal, or differing only in an image whose deciding margin on
    the CPU (``bipartite_margins``: an IoU gap or the IoU less the 0.5
    threshold; ``mining_margins``: the loss gap at the cut) is within
    SSD_NEAR_TIE. No port kernel launches."""
    import paddle_tpu_torch as fluid

    main, startup, spec, _, _ = build_ssd(fluid)
    feed = ssd_feed(spec, batch)
    ops = main.global_block().ops
    bm = next(op for op in ops if op.type == "bipartite_match")
    mine = next(op for op in ops if op.type == "mine_hard_examples")
    extra = [bm.input("DistMat"), bm.output("ColToRowMatchIndices"),
             mine.input("ClsLoss"), mine.output("UpdatedMatchIndices")]
    names, params, runs, secs = _card_cpu_step(
        fluid, main, startup, spec, feed, SSD_PER_STEP, "ssd_train_check",
        extra)
    v = _step_verdict(names, params, runs)
    n = len(names) + 1
    (gd, gm, gl, gx), (cd, cm, cl, cx) = runs["gpu"][0][n:], runs["cpu"][0][n:]
    match_diff = [bool((a != b).any()) for a, b in zip(gm, cm)]
    mined_diff = [bool((a != b).any()) for a, b in zip(gx, cx)]
    bmar, mmar = bipartite_margins(cd), mining_margins(cl, cm)
    tie = {"match_differs": int(sum(match_diff)),
           "mined_differs": int(sum(mined_diff)),
           "dist_max_abs_err": float(np.abs(gd - cd).max()),
           "cls_loss_max_abs_err": float(np.abs(gl.astype("f8") - cl).max()),
           "match_min_margin": float(bmar.min()),
           "mining_min_margin": float(mmar.min()),
           "positives": int((cm >= 0).sum()),
           "mined_negatives": int((cx == -1).sum()),
           "ok": all(not d or m <= SSD_NEAR_TIE for d, m in zip(
               match_diff, bmar)) and all(
               not d or m <= SSD_NEAR_TIE for d, m in zip(mined_diff, mmar))}
    emit(dict({"phase": "ssd_train_check", "batch": batch,
               "config": SSD_LITE, "optimizer": "Adam(%g)" % SSD_LR,
               "launches": SSD_PER_STEP, "cpu_step_s": secs["cpu"],
               "gpu_step_s": secs["gpu"], "matching": tie,
               "tol": STEP_TOL + "; match and mined equal but at a margin "
                      "within %g" % SSD_NEAR_TIE, "device": smi_line}, **v))
    check(v["ok"], "ssd_train_check step: %s" % v)
    check(tie["ok"], "ssd_train_check matching: %s" % tie)


def phase_ssd_train(torch, smi_line, warmup=3, steps=10, prof_steps=2):
    """``ssd_lite`` at its defaults (5 classes, 3 x 64 x 64, 4 boxes, 240
    priors) at batch 128, Adam(SSD_LR), captured from the key's second
    step on: 3 warm-up and 10 timed steps on one fixed batch
    (``ssd_feed``). Prints ms a step, images/s (``tokens_per_s``: images
    here), busy share, kernels a step by kind, peak memory above the
    state, ``capture_rule``'s verdict, and the epilogue fusion's four
    sites, each declined by the fused conv's gate (3x3 stride 2). Returns
    (launches, replayed launches, (main, spec, test, m_ap, scope))."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import fused_ops

    main, startup, spec, m_ap, test = build_ssd(fluid)
    feed = ssd_feed(spec, SSD_BATCH)
    trainable = int(sum(np.prod(p.shape) for p in main.all_parameters()
                        if p.trainable))
    launches, replayed, scope = _train_path(
        torch, fluid, smi_line, "ssd_train", main, startup, spec, feed,
        SSD_PER_STEP, SSD_BATCH, warmup, steps, prof_steps,
        {"model": "ssd_lite", "config": SSD_LITE, "tokens_are": "images",
         "trainable_parameters": trainable,
         "optimizer": "Adam(%g)" % SSD_LR})
    _, report = fused_ops(main, [spec.loss.name])
    choices = [site.fused.attr("_kernel_choice") for site in report.fused]
    emit({"phase": "ssd_train", "case": "fusion",
          "sites": len(report.fused), "refused": len(report.refused),
          "kernel_choices": choices, "device": smi_line})
    check(len(report.fused) == 4 and all(
        c and c["kernel"] == "unfused_replay" and "strides [2, 2]"
        in c["reason"] for c in choices),
          "ssd fusion: %s" % choices)
    return launches, replayed, (main, spec, test, m_ap, scope)


def nms_margins(torch, op, boxes, scores, cut):
    """The CPU side's decisions in ``op`` (a multiclass_nms, eta 1) on its
    inputs boxes [N, M, 4] and scores [N, C, M] (CPU tensors), replayed:
    per image the smallest of the gaps between the best and second-best
    live score, the best's distance from the score threshold and every
    live box's IoU distance from the NMS threshold, over each trip of each
    class but the background, counting only boxes scored at or above the
    image's ``cut`` (its lowest output score, less SSD_NEAR_TIE: a box
    below it reaches no output row and suppresses only boxes below it);
    and the gaps between neighbours among the keep_top_k + 1 best kept
    scores (the rows' order and the last row)."""
    from paddle_tpu_torch.core.opimpl import detection_ops as d

    n, c, m = scores.shape
    live = scores >= cut[:, None, None] - SSD_NEAR_TIE
    top = min(op.attr("nms_top_k") if op.attr("nms_top_k") > 0 else m, m)
    sthr, thr = op.attr("score_threshold"), op.attr("nms_threshold")
    fg = torch.arange(c) != op.attr("background_label")
    iou = d._nms_iou(boxes, op.attr("normalized"))
    alive = torch.ones((n, c, m), dtype=torch.bool)
    cols, rows = torch.arange(m), torch.arange(n)[:, None]
    margin = torch.full((n,), float("inf"), dtype=torch.float64)
    kept = []
    for _ in range(top):
        masked = torch.where(alive, scores, -float("inf"))
        v, j = masked.topk(2, dim=-1)
        ok = v[..., 0] > sthr
        r = iou[rows, j[..., 0]]
        near = torch.where(alive & live & ok[..., None]
                           & (cols != j[..., :1]), (r - thr).abs(),
                           float("inf")).amin(-1)
        gap = torch.where(ok & (v[..., 0] >= cut[:, None] - SSD_NEAR_TIE),
                          torch.minimum(v[..., 0] - v[..., 1], near),
                          float("inf"))
        gap = torch.minimum(gap, torch.where(
            v[..., 0] >= cut[:, None] - SSD_NEAR_TIE,
            (v[..., 0] - sthr).abs(), float("inf")))
        margin = torch.minimum(margin, torch.where(fg, gap, float(
            "inf")).amin(1).double())
        kept.append(torch.where(ok & fg, v[..., 0], -float("inf")))
        alive = alive & (r <= thr) & (cols != j[..., :1]) & ok[..., None]
    k = op.attr("keep_top_k")
    flat = torch.sort(torch.stack(kept, -1).reshape(n, -1), dim=1,
                      descending=True).values
    flat = flat[:, :min(k + 1 if k > 0 else flat.shape[1], flat.shape[1])]
    order = torch.where(flat[:, 1:].isfinite(), flat[:, :-1] - flat[:, 1:],
                        float("inf"))
    return torch.minimum(margin, order.amin(1).double()).numpy()


def detection_verdict(card, cpu, margins, tol=SSD_NEAR_TIE):
    """Card vs CPU detections (Out [N, K, 6], Count [N]): an image is
    equal when its count and labels are and its scores and boxes agree
    within 1e-5; an image that differs must meet a near tie on the CPU
    side (``nms_margins`` below ``tol``), and fewer than half the images
    may. Returns the counts (``ok``)."""
    (go, gc), (co, cc) = card, cpu
    same = np.array([gc[i] == cc[i] and np.array_equal(go[i, :, 0],
                                                      co[i, :, 0])
                     and np.abs(go[i] - co[i]).max() <= 1e-5
                     for i in range(len(gc))])
    near = margins < tol
    return {"images": int(len(gc)), "images_equal": int(same.sum()),
            "near_tie_images": int(near.sum()),
            "differing_without_near_tie": int((~same & ~near).sum()),
            "min_margin": float(margins.min()),
            "median_margin": float(np.median(margins)), "tol": tol,
            "detections_card": int(gc.sum()), "detections_cpu": int(cc.sum()),
            "ok": bool(not (~same & ~near).any()
                       and near.sum() < len(gc) / 2)}


def phase_ssd_eval(torch, smi_line, trained, passes=5):
    """The ``for_test`` clone on ``ssd_train``'s weights at batch 128:
    decode + NMS (``detection_output``: nms_top_k 40, keep_top_k 10) and
    ``detection_map`` over the gt feeds, captured if ``capture_rule``
    admits it: ms a batch (median of the passes after the capture). The
    card's detections against the port's on the CPU from the same weights
    under ``detection_verdict`` (margins from the CPU's NMS inputs); the
    card's mAP against the CPU's ``detection_map`` over the card's own
    detections (within 1e-6); then ``detection_map`` alone, its own
    program on the card's detections, timed apart (interpreted and
    captured). Returns the launches (none)."""
    import paddle_tpu_torch as fluid

    main, spec, test, m_ap, scope = trained
    feed = ssd_feed(spec, SSD_BATCH, seed=SEED + 1)
    nms = next(op for op in test.global_block().ops
               if op.type == "multiclass_nms")
    fetch = [spec.fetches["detections"].name, spec.fetches["det_count"].name,
             m_ap.name, nms.input("BBoxes").name, nms.input("Scores").name]
    exe = fluid.Executor()
    before = read_counts()
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
        times.append(time.perf_counter() - t0)
    report = exe.step_report(test)
    exe.close()
    check(read_counts() == before, "ssd_eval launched a port kernel")
    cpu_scope = fluid.Scope()
    fluid.bridge.load_program_params(cpu_scope, _mt_params(scope, main),
                                     main, "cpu")
    cpu = fluid.Executor(fluid.CPUPlace()).run(test, feed=feed,
                                               fetch_list=fetch,
                                               scope=cpu_scope)
    # the lowest score an image's output holds (the threshold where its
    # rows do not fill keep_top_k)
    k = nms.attr("keep_top_k")
    cut = np.where(cpu[1] >= k, cpu[0][:, -1, 1], nms.attr("score_threshold"))
    margins = nms_margins(torch, nms, torch.from_numpy(cpu[3]),
                          torch.from_numpy(cpu[4]), torch.from_numpy(cut))
    dv = detection_verdict(card[:2], cpu[:2], margins)
    # the mAP alone: its own program over the card's detections
    L = fluid.layers
    mp, ms = fluid.Program(), fluid.Program()
    with fluid.program_guard(mp, ms):
        dets = L.data("dets", shape=list(card[0].shape),
                      append_batch_size=False)
        lbl = L.data("lbl", shape=[SSD_BATCH, SSD_LITE["max_boxes"]],
                     dtype="int64", append_batch_size=False)
        box = L.data("box", shape=list(feed["gt_box"].shape),
                     append_batch_size=False)
        one = L.detection_map(dets, lbl, box,
                              class_num=SSD_LITE["num_classes"])
    mfeed = {"dets": card[0], "lbl": feed["gt_label"][..., 0],
             "box": feed["gt_box"]}
    map_cpu, = fluid.Executor(fluid.CPUPlace()).run(mp, feed=mfeed,
                                                    fetch_list=[one])
    mexe, map_times = fluid.Executor(), []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        map_card, = mexe.run(mp, feed=mfeed, fetch_list=[one])
        map_times.append(time.perf_counter() - t0)
    map_report = mexe.step_report(mp)
    mexe.close()
    emit({"phase": "ssd_eval", "batch": SSD_BATCH, "passes": passes,
          "ms": [t * 1e3 for t in times],
          "ms_median_after_capture": statistics.median(times[2:]) * 1e3,
          "captured": report["captured"], "reason": report["reason"],
          "map_card": float(card[2]), "map_cpu_on_card_dets": float(map_cpu),
          "map_cpu_run": float(cpu[2]),
          "map_ms": [t * 1e3 for t in map_times],
          "map_ms_median_after_capture": statistics.median(
              map_times[2:]) * 1e3,
          "map_captured": map_report["captured"],
          "nms_input_max_abs_err": {
              "boxes": float(np.abs(card[3] - cpu[3]).max()),
              "scores": float(np.abs(card[4] - cpu[4]).max())},
          "detections": dv, "device": smi_line})
    check(card[0].shape == (SSD_BATCH, 10, 6) and np.isfinite(card[0]).all()
          and ((card[1] >= 0) & (card[1] <= 10)).all(),
          "ssd_eval detections out of shape or range")
    check(abs(float(card[2]) - float(map_cpu)) <= 1e-6
          and abs(float(map_card) - float(card[2])) <= 1e-6,
          "ssd_eval mAP: card %s, CPU on the card's detections %s, alone %s"
          % (card[2], map_cpu, map_card))
    check(dv["ok"], "ssd_eval detections: %s" % dv)
    return per_run()


# DCGAN (Radford et al., ICLR 2016, arXiv:1511.06434) at its LSUN widths:
# G from z [100, 1, 1] through 4x4 transposed convs 1024 (s1, p0), 512,
# 256, 128 (s2, p1) to 3 x 64 x 64, BN + ReLU after each but the last,
# then tanh; D through 4x4 s2 p1 convs 128, 256, 512, 1024, LeakyReLU 0.2,
# BN after the last three, and a 4x4 s1 conv to one logit; the 4x4 kernels
# are those of PyTorch's examples/dcgan; weights N(0, 0.02), BN scales
# N(1, 0.02), no conv biases; Adam(2e-4, beta1 0.5) on each side
DCGAN = dict(z_dim=100, g_widths=(1024, 512, 256, 128),
             d_widths=(128, 256, 512, 1024), channels=3)
DCGAN_BATCH = 128
DCGAN_LR = 2e-4
DCGAN_BETA1 = 0.5
# no port kernel: the transposed convs are cuDNN's, and the epilogue
# fusion declines D's 4x4 stride-2 conv -> BN sites (``supported_geometry``)
DCGAN_PER_STEP = per_run()


def build_dcgan(fluid, z_dim, g_widths, d_widths, channels=3, lr=DCGAN_LR,
                beta1=DCGAN_BETA1):
    """DCGAN from public layers in three programs that share the
    parameters by name, and one startup program: ``g`` (z -> images),
    ``d`` (D on fed real and fake images, sigmoid cross-entropy against 1
    and 0, Adam over D's parameters) and ``dg`` (G through D against 1,
    Adam over G's). The image side is 4 x 2^len(g_widths). Returns a
    namespace of the programs, the fetch vars and the parameter lists.
    Works in either package (the CPU tests build it in both)."""
    import types

    L, init = fluid.layers, fluid.initializer

    def w(name):
        return fluid.ParamAttr(name=name, initializer=init.Normal(0.0, 0.02))

    def bn(x, name, act):
        return L.batch_norm(
            x, act=act, param_attr=fluid.ParamAttr(
                name=name + "_s", initializer=init.Normal(1.0, 0.02)),
            bias_attr=fluid.ParamAttr(name=name + "_b",
                                      initializer=init.Constant(0.0)),
            moving_mean_name=name + "_m", moving_variance_name=name + "_v")

    def generator(z):
        h = bn(L.conv2d_transpose(z, g_widths[0], filter_size=4, stride=1,
                                  padding=0, param_attr=w("g_w0"),
                                  bias_attr=False), "g_bn0", "relu")
        for i, c in enumerate(g_widths[1:], 1):
            h = bn(L.conv2d_transpose(h, c, filter_size=4, stride=2,
                                      padding=1, param_attr=w("g_w%d" % i),
                                      bias_attr=False), "g_bn%d" % i, "relu")
        return L.tanh(L.conv2d_transpose(
            h, channels, filter_size=4, stride=2, padding=1,
            param_attr=w("g_w%d" % len(g_widths)), bias_attr=False))

    def discriminator(x):
        h = x
        for i, c in enumerate(d_widths):
            h = L.conv2d(h, c, 4, stride=2, padding=1,
                         param_attr=w("d_w%d" % i), bias_attr=False)
            if i:
                h = bn(h, "d_bn%d" % i, None)
            h = L.leaky_relu(h, alpha=0.2)
        h = L.conv2d(h, 1, 4, stride=1, padding=0,
                     param_attr=w("d_w%d" % len(d_widths)), bias_attr=False)
        return L.reshape(h, [-1, 1])

    def bce(logit, value):
        label = L.fill_constant_batch_size_like(logit, [-1, 1], "float32",
                                                value)
        return L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))

    side = 4 * 2 ** len(g_widths)
    img = [channels, side, side]
    startup = fluid.Program()
    g, d, dg = fluid.Program(), fluid.Program(), fluid.Program()
    for prog in (startup, g, d, dg):
        prog.random_seed = SEED
    with fluid.program_guard(g, startup):
        fake = generator(L.data("z", shape=[z_dim, 1, 1]))
    with fluid.program_guard(d, startup):
        d_loss = L.elementwise_add(
            bce(discriminator(L.data("real", shape=img)), 1.0),
            bce(discriminator(L.data("fake", shape=img)), 0.0))
        d_params = [p.name for p in d.all_parameters() if p.trainable]
        fluid.optimizer.Adam(learning_rate=lr, beta1=beta1).minimize(
            d_loss, parameter_list=d_params)
    with fluid.program_guard(dg, startup):
        g_loss = bce(discriminator(generator(L.data("z", shape=[
            z_dim, 1, 1]))), 1.0)
        g_params = [p.name for p in dg.all_parameters()
                    if p.trainable and p.name.startswith("g_")]
        fluid.optimizer.Adam(learning_rate=lr, beta1=beta1).minimize(
            g_loss, parameter_list=g_params)
    return types.SimpleNamespace(
        g=g, d=d, dg=dg, startup=startup, fake=fake, d_loss=d_loss,
        g_loss=g_loss, d_params=d_params, g_params=g_params, image=img,
        z_dim=z_dim)


def dcgan_feed(net, batch, seed=SEED):
    """Seeded noise for z (N(0, 1)) and the real images (U(-1, 1)):
    LSUN is not in the repository, and image quality is not asked for."""
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, net.z_dim, 1, 1).astype("f4"),
            rng.uniform(-1, 1, [batch] + net.image).astype("f4"))


# ---------------- the rest of A4: misc_ops' and nn_ops' last ops ----------

def _f32(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _ints(rng, lo, hi, *shape):
    return rng.integers(lo, hi, shape).astype("int32")


def _one(fluid, op_type, inputs, slot="Out", attrs=None, dtype="float32"):
    return _raw_op(fluid, op_type, inputs, {slot: dtype}, attrs)[0]


def _pool_unpool(fluid, v):
    out, mask = fluid.layers.max_pool2d_with_index(v["x"], [2, 2])
    return [out, mask, fluid.layers.unpool(out, mask, 224, 224)]


def _ctc_ids(rng, b, t, classes):
    """Greedy-decoder-like ids: runs of repeats, a blank (0) in about a
    third of the steps."""
    ids = rng.integers(1, classes, (b, t))
    ids = np.where(rng.random((b, t)) < 0.3, 0, ids)
    rep = rng.random((b, t)) < 0.4
    for s in range(1, t):
        ids[:, s] = np.where(rep[:, s], ids[:, s - 1], ids[:, s])
    return ids.astype("int32")


def _crop_check(out, x, shape):
    """A crop of ``x``'s trailing axes at one offset per axis: the
    offsets where x holds out's first element, then the whole window."""
    lead = x.ndim - len(shape)
    head = x[(0,) * lead]
    room = tuple(slice(0, d - s + 1) for d, s in zip(head.shape, shape))
    for off in np.argwhere(head[room] == out[(0,) * out.ndim]):
        sl = tuple([slice(None)] * lead
                   + [slice(o, o + s) for o, s in zip(off, shape)])
        if np.array_equal(out, x[sl]):
            return True, [int(o) for o in off]
    return False, None


def _sample_check(out, logits, labels, num):
    """SampledLogits = the gather at Samples less log(num / C), column 0
    the label, every draw in range."""
    got, samples, slabels = out
    logq = np.float32(np.log(num / float(logits.shape[1])))
    want = np.take_along_axis(logits, samples.astype(np.int64), 1) - logq
    return bool(np.array_equal(samples[:, 0], labels[:, 0])
                and (samples >= 0).all() and (samples < logits.shape[1]).all()
                and not slabels.any()
                and np.abs(got - want).max() <= 1e-6 * max(
                    1.0, float(np.abs(want).max()))), {
        "draw_mean": float(samples[:, 1:].mean()),
        "draw_mean_expected": (logits.shape[1] - 1) / 2.0}


# name -> (published size, inputs(rng), differentiated inputs,
# build(fluid, v) -> outputs, None or a check of the card's draws)
MISC_NN_CASES = {
    # ---- nn_ops
    "group_norm": (
        "ResNet-50 stage 1 [32, 256, 56, 56], 32 groups (Wu & He 2018)",
        lambda r: {"x": _f32(r, 32, 256, 56, 56), "s": _f32(r, 256),
                   "b": _f32(r, 256)}, ["x", "s", "b"],
        lambda fl, v: _raw_op(fl, "group_norm", {"X": v["x"], "Scale": v["s"],
                                                 "Bias": v["b"]},
                              {"Y": "float32"}, {"groups": 32}), None),
    "lrn": ("AlexNet conv1 [128, 96, 55, 55], n 5",
            lambda r: {"x": _f32(r, 128, 96, 55, 55)}, ["x"],
            lambda fl, v: [fl.layers.lrn(v["x"], n=5, k=2.0, alpha=1e-4,
                                         beta=0.75)], None),
    "conv3d": ("C3D conv1a [8, 3, 16, 112, 112] -> 64, 3x3x3",
               lambda r: {"x": _f32(r, 8, 3, 16, 112, 112),
                          "w": _f32(r, 64, 3, 3, 3, 3) * 0.1}, [],
               lambda fl, v: [_one(fl, "conv3d", {"Input": v["x"],
                                                  "Filter": v["w"]},
                                   "Output", {"paddings": [1, 1, 1]})], None),
    "pool3d": ("C3D pool1 over [8, 64, 16, 112, 112], 1x2x2",
               lambda r: {"x": _f32(r, 8, 64, 16, 112, 112)}, [],
               lambda fl, v: [_one(fl, "pool3d", {"X": v["x"]}, "Out", {
                   "pooling_type": "max", "ksize": [1, 2, 2],
                   "strides": [1, 2, 2]})], None),
    "pool3d_avg": ("C3D pool2 over [8, 128, 16, 56, 56], 2x2x2 avg",
                   lambda r: {"x": _f32(r, 8, 128, 16, 56, 56)}, ["x"],
                   lambda fl, v: [_one(fl, "pool3d", {"X": v["x"]}, "Out", {
                       "pooling_type": "avg", "ksize": [2, 2, 2],
                       "strides": [2, 2, 2]})], None),
    "conv2d_transpose": (
        "DCGAN G layer 2 at batch 32: [32, 1024, 4, 4] -> 512, 4x4 s2",
        lambda r: {"x": _f32(r, 32, 1024, 4, 4),
                   "w": _f32(r, 1024, 512, 4, 4) * 0.02}, ["x", "w"],
        lambda fl, v: [_one(fl, "conv2d_transpose", {
            "Input": v["x"], "Filter": v["w"]}, "Output", {
            "strides": [2, 2], "paddings": [1, 1]})], None),
    "depthwise_conv2d": (
        "MobileNet-v1 block 4 [32, 256, 28, 28], 3x3",
        lambda r: {"x": _f32(r, 32, 256, 28, 28),
                   "w": _f32(r, 256, 1, 3, 3) * 0.3}, ["x", "w"],
        lambda fl, v: [_one(fl, "depthwise_conv2d", {
            "Input": v["x"], "Filter": v["w"]}, "Output",
            {"paddings": [1, 1]})], None),
    "depthwise_conv2d_transpose": (
        "[32, 256, 14, 14] -> 28 x 28, 4x4 s2 p1 a channel",
        lambda r: {"x": _f32(r, 32, 256, 14, 14),
                   "w": _f32(r, 256, 1, 4, 4) * 0.3}, ["x", "w"],
        lambda fl, v: [_one(fl, "depthwise_conv2d_transpose", {
            "Input": v["x"], "Filter": v["w"]}, "Output", {
            "strides": [2, 2], "paddings": [1, 1]})], None),
    "conv3d_transpose": (
        "V-Net up-conv [4, 64, 16, 32, 32] -> 32, 2x2x2 s2",
        lambda r: {"x": _f32(r, 4, 64, 16, 32, 32),
                   "w": _f32(r, 64, 32, 2, 2, 2) * 0.1}, ["x", "w"],
        lambda fl, v: [_one(fl, "conv3d_transpose", {
            "Input": v["x"], "Filter": v["w"]}, "Output",
            {"strides": [2, 2, 2]})], None),
    "bilinear_interp_up": (
        "DeepLab-v3+ decoder 4x of [16, 256, 64, 64], corners aligned",
        lambda r: {"x": _f32(r, 16, 256, 64, 64)}, [],
        lambda fl, v: [fl.layers.resize_bilinear(v["x"], [256, 256])], None),
    "bilinear_interp_down": (
        "a 2x shrink of [16, 256, 128, 128] (anti-aliased)",
        lambda r: {"x": _f32(r, 16, 256, 128, 128)}, ["x"],
        lambda fl, v: [fl.layers.resize_bilinear(
            v["x"], [64, 64], align_corners=False)], None),
    "nearest_interp": ("FPN top-down 2x of [16, 256, 50, 50]",
                       lambda r: {"x": _f32(r, 16, 256, 50, 50)}, ["x"],
                       lambda fl, v: [fl.layers.resize_nearest(
                           v["x"], [100, 100])], None),
    "im2sequence": ("OCR attention features [64, 128, 6, 48], 6x1",
                    lambda r: {"x": _f32(r, 64, 128, 6, 48)}, ["x"],
                    lambda fl, v: [fl.layers.im2sequence(v["x"], [6, 1])],
                    None),
    "grid_sampler": (
        "STN [32, 3, 224, 224] on a [32, 224, 224, 2] grid",
        lambda r: {"x": _f32(r, 32, 3, 224, 224),
                   "g": r.uniform(-1.1, 1.1, (32, 224, 224, 2)).astype(
                       "f4")}, ["x", "g"],
        lambda fl, v: [fl.layers.grid_sampler(v["x"], v["g"])], None),
    "pixel_shuffle": ("ESPCN x4 [16, 48, 128, 128]",
                      lambda r: {"x": _f32(r, 16, 48, 128, 128)}, ["x"],
                      lambda fl, v: [fl.layers.pixel_shuffle(v["x"], 4)],
                      None),
    "adaptive_pool2d": ("[32, 512, 14, 14] to 7 x 7",
                        lambda r: {"x": _f32(r, 32, 512, 14, 14)}, ["x"],
                        lambda fl, v: [fl.layers.adaptive_pool2d(
                            v["x"], 7, pool_type="avg")], None),
    # ---- misc_ops: losses and metrics
    "losses": (
        "RankNet / CTR pairs [4096, 1], [1024, 512] distances",
        lambda r: {"a": _f32(r, 4096, 1), "b": _f32(r, 4096, 1),
                   "y": _ints(r, 0, 2, 4096, 1).astype("f4"),
                   "t": r.uniform(-0.5, 1.5, (4096, 1)).astype("f4"),
                   "m": _f32(r, 1024, 512), "n": _f32(r, 1024, 512)},
        ["a", "b", "m", "n"],
        lambda fl, v: [
            fl.layers.rank_loss(v["y"], v["a"], v["b"]),
            fl.layers.modified_huber_loss(v["a"], v["y"]),
            fl.layers.teacher_student_sigmoid_loss(v["a"], v["t"]),
            fl.layers.squared_l2_distance(v["m"], v["n"]),
            _one(fl, "l1_norm", {"X": v["m"]})], None),
    "mean_iou": ("DeepLab VOC eval, 16 x 512 x 512 pixels, 21 classes",
                 lambda r: {"p": _ints(r, 0, 21, 16 * 512 * 512),
                            "l": _ints(r, 0, 21, 16 * 512 * 512)}, [],
                 lambda fl, v: list(fl.layers.mean_iou(v["p"], v["l"], 21)),
                 None),
    "edit_distance": (
        "CTC OCR hypotheses [256, 32] against labels [256, 24]",
        lambda r: {"h": _ints(r, 0, 8, 256, 32), "r": _ints(r, 0, 8, 256, 24),
                   "hl": _ints(r, 0, 33, 256), "rl": _ints(r, 1, 25, 256)},
        [], lambda fl, v: list(fl.layers.edit_distance(
            v["h"], v["r"], normalized=True, input_length=v["hl"],
            label_length=v["rl"])), None),
    "chunk_eval": ("CoNLL-style tags [128, 64], 9 types, IOB",
                   lambda r: {"i": _ints(r, 0, 19, 128, 64),
                              "l": _ints(r, 0, 19, 128, 64),
                              "n": _ints(r, 1, 65, 128)}, [],
                   lambda fl, v: list(fl.layers.chunk_eval(
                       v["i"], v["l"], "IOB", 9, v["n"])), None),
    "positive_negative_pair": (
        "LTR: 2048 documents in 64 queries",
        lambda r: {"s": np.round(_f32(r, 2048) * 4) / 4,
                   "l": _ints(r, 0, 5, 2048).astype("f4"),
                   "q": _ints(r, 0, 64, 2048)}, [],
        lambda fl, v: _raw_op(fl, "positive_negative_pair", {
            "Score": v["s"], "Label": v["l"], "QueryID": v["q"]},
            {"PositivePair": "float32", "NegativePair": "float32",
             "NeutralPair": "float32"}), None),
    # ---- image and tensor ops
    "affine_channel": ("Detectron frozen BN, [32, 256, 56, 56]",
                       lambda r: {"x": _f32(r, 32, 256, 56, 56),
                                  "s": _f32(r, 256), "b": _f32(r, 256)},
                       ["x", "s", "b"],
                       lambda fl, v: [fl.layers.affine_channel(
                           v["x"], v["s"], v["b"])], None),
    "affine_grid": ("STN theta [32, 2, 3] -> 224 x 224",
                    lambda r: {"t": _f32(r, 32, 2, 3)}, ["t"],
                    lambda fl, v: [fl.layers.affine_grid(
                        v["t"], [32, 3, 224, 224])], None),
    "space_to_depth": ("YOLOv2 passthrough [32, 64, 26, 26], block 2",
                       lambda r: {"x": _f32(r, 32, 64, 26, 26)}, ["x"],
                       lambda fl, v: [fl.layers.space_to_depth(v["x"], 2)],
                       None),
    "shuffle_channel": ("ShuffleNet stage 2 [32, 240, 28, 28], 3 groups",
                        lambda r: {"x": _f32(r, 32, 240, 28, 28)}, ["x"],
                        lambda fl, v: [fl.layers.shuffle_channel(v["x"], 3)],
                        None),
    "crop": ("[32, 3, 256, 256] to 224", lambda r: {
        "x": _f32(r, 32, 3, 256, 256)}, ["x"],
        lambda fl, v: [fl.layers.crop(v["x"], [32, 3, 224, 224],
                                      [0, 0, 16, 16])], None),
    "pad_constant_like": (
        "[32, 64, 56, 56] padded to 57 x 57",
        lambda r: {"x": _f32(r, 32, 64, 57, 57), "y": _f32(r, 32, 64, 56,
                                                           56)}, ["y"],
        lambda fl, v: [fl.layers.pad_constant_like(v["x"], v["y"], 0.5)],
        None),
    "pool_with_index_unpool": (
        "SegNet encoder and decoder [16, 64, 224, 224], 2x2",
        lambda r: {"x": _f32(r, 16, 64, 224, 224)}, [], _pool_unpool, None),
    "max_pool3d_with_index": (
        "[8, 64, 16, 56, 56], 2x2x2",
        lambda r: {"x": _f32(r, 8, 64, 16, 56, 56)}, [],
        lambda fl, v: _raw_op(fl, "max_pool3d_with_index", {"X": v["x"]},
                              {"Out": "float32", "Mask": "int32"},
                              {"ksize": [2, 2, 2], "strides": [2, 2, 2]}),
        None),
    "spp": ("SPP-net ZF-5 conv5 [32, 256, 13, 13], 3 levels",
            lambda r: {"x": _f32(r, 32, 256, 13, 13)}, ["x"],
            lambda fl, v: [fl.layers.spp(v["x"], 3)], None),
    "similarity_focus": ("[32, 64, 28, 28], 3 channels",
                         lambda r: {"x": _f32(r, 32, 64, 28, 28)}, [],
                         lambda fl, v: [fl.layers.similarity_focus(
                             v["x"], 1, [0, 5, 9])], None),
    "spectral_norm": (
        "SN-GAN D weight [512, 256, 4, 4]",
        lambda r: {"w": _f32(r, 512, 256, 4, 4) * 0.02, "u": _f32(r, 512),
                   "v": _f32(r, 4096)}, ["w"],
        lambda fl, v: [_one(fl, "spectral_norm", {
            "Weight": v["w"], "U": v["u"], "V": v["v"]},
            attrs={"power_iters": 1})], None),
    "random_crop": (
        "ImageNet crop [128, 3, 256, 256] to 224",
        lambda r: {"x": _f32(r, 128, 3, 256, 256)}, [],
        lambda fl, v: [fl.layers.random_crop(v["x"], [3, 224, 224])],
        lambda out, inp: _crop_check(out[0], inp["x"], [3, 224, 224])),
    "multiplex": ("4 candidates [1024, 512]", lambda r: {
        "a": _f32(r, 1024, 512), "b": _f32(r, 1024, 512),
        "c": _f32(r, 1024, 512), "d": _f32(r, 1024, 512),
        "i": _ints(r, 0, 4, 1024, 1)}, ["a", "b", "c", "d"],
        lambda fl, v: [fl.layers.multiplex(
            [v["a"], v["b"], v["c"], v["d"]], v["i"])], None),
    "tensor_misc": (
        "SNN selu [1024, 4096], minus, is_empty",
        lambda r: {"x": _f32(r, 1024, 4096), "y": _f32(r, 1024, 4096)},
        ["x", "y"],
        lambda fl, v: [fl.layers.selu(v["x"]),
                       _one(fl, "minus", {"X": v["x"], "Y": v["y"]}),
                       _one(fl, "is_empty", {"X": v["x"]}, dtype="bool")],
        None),
    "bilinear_tensor_product": (
        "[256, 128] x [64, 128, 128] x [256, 128]",
        lambda r: {"x": _f32(r, 256, 128), "y": _f32(r, 256, 128),
                   "w": _f32(r, 64, 128, 128) * 0.1, "b": _f32(r, 64)},
        ["x", "y", "w", "b"],
        lambda fl, v: [_one(fl, "bilinear_tensor_product", {
            "X": v["x"], "Y": v["y"], "Weight": v["w"], "Bias": v["b"]})],
        None),
    "add_position_encoding": (
        "Transformer-base [64, 256, 512]",
        lambda r: {"x": _f32(r, 64, 256, 512)}, ["x"],
        lambda fl, v: [fl.layers.add_position_encoding(v["x"], 0.5, 1.0)],
        None),
    "conv_shift": ("NTM shift [256, 128] by [256, 3]",
                   lambda r: {"x": _f32(r, 256, 128), "y": _f32(r, 256, 3)},
                   ["x", "y"],
                   lambda fl, v: [_one(fl, "conv_shift", {
                       "X": v["x"], "Y": v["y"]})], None),
    "hash": ("[4096, 1] ids, 4 hashes", lambda r: {
        "x": r.integers(0, 2 ** 31 - 1, (4096, 1)).astype("int32")}, [],
        lambda fl, v: [fl.layers.hash(v["x"], 1000003, num_hash=4)], None),
    "data_norm": (
        "CTR dense features [4096, 256]",
        lambda r: {"x": _f32(r, 4096, 256),
                   "n": np.full(256, 1e4, "f4"), "s": _f32(r, 256) * 100,
                   "q": np.abs(_f32(r, 256)) * 1e4 + 1e4}, ["x"],
        lambda fl, v: _raw_op(fl, "data_norm", {
            "X": v["x"], "BatchSize": v["n"], "BatchSum": v["s"],
            "BatchSquareSum": v["q"]},
            {"Y": "float32", "Means": "float32", "Scales": "float32",
             "BatchSizeOut": "float32", "BatchSumOut": "float32",
             "BatchSquareSumOut": "float32"}), None),
    # ---- sequences
    "sequence_ops": (
        "[256, 512] rows to 64 steps; [256, 64, 512] reshaped; "
        "[256, 1024] scattered at [256, 64] ids",
        lambda r: {"x": _f32(r, 256, 512), "n": _ints(r, 0, 65, 256),
                   "s": _f32(r, 256, 64, 512), "t": _f32(r, 256, 1024),
                   "i": _ints(r, 0, 1024, 256, 64), "u": _f32(r, 256, 64)},
        ["x", "s", "t", "u"],
        lambda fl, v: [fl.layers.sequence_expand_as(v["x"], v["n"], 64),
                       fl.layers.sequence_reshape(v["s"], 1024),
                       fl.layers.sequence_scatter(v["t"], v["i"], v["u"])],
        None),
    # ---- updates and sampling
    "proximal": (
        "[1024, 1024] parameters",
        lambda r: {"p": _f32(r, 1024, 1024), "g": _f32(r, 1024, 1024),
                   "m": np.abs(_f32(r, 1024, 1024)),
                   "lr": np.array([0.05], "f4")}, [],
        lambda fl, v: [
            _one(fl, "proximal_gd", {"Param": v["p"], "Grad": v["g"],
                                     "LearningRate": v["lr"]}, "ParamOut",
                 {"l1": 0.1, "l2": 0.01})] + _raw_op(
            fl, "proximal_adagrad", {"Param": v["p"], "Grad": v["g"],
                                     "Moment": v["m"],
                                     "LearningRate": v["lr"]},
            {"ParamOut": "float32", "MomentOut": "float32"},
            {"l1": 0.1, "l2": 0.01}), None),
    "sample_logits": (
        "BERT's vocabulary: [1024, 30522], 4096 samples",
        lambda r: {"x": _f32(r, 1024, 30522),
                   "y": _ints(r, 0, 30522, 1024, 1)}, [],
        lambda fl, v: _raw_op(fl, "sample_logits", {
            "Logits": v["x"], "Labels": v["y"]},
            {"SampledLogits": "float32", "Samples": "int32",
             "SampledLabels": "int32"}, {"num_samples": 4096}),
        lambda out, inp: _sample_check(out, inp["x"], inp["y"], 4096)),
    # ---- recurrent and CTC
    "lstm_unit": ("[256, 4 x 512]", lambda r: {
        "x": _f32(r, 256, 2048), "c": _f32(r, 256, 512)}, ["x", "c"],
        lambda fl, v: _raw_op(fl, "lstm_unit", {"X": v["x"],
                                                "C_prev": v["c"]},
                              {"C": "float32", "H": "float32"},
                              {"forget_bias": 1.0}), None),
    "ctc_align": ("CRNN greedy ids [256, 128], blank 0",
                  lambda r: {"x": _ctc_ids(r, 256, 128, 37),
                             "n": _ints(r, 1, 129, 256)}, [],
                  lambda fl, v: _raw_op(fl, "ctc_align", {
                      "Input": v["x"], "InputLength": v["n"]},
                      {"Output": "int32", "OutputLength": "int32"},
                      {"blank": 0}), None),
}


def phase_misc_nn_ops_check(torch, smi_line):
    """Each op type of ``misc_ops`` and ``nn_ops`` that the port gained
    last (``MISC_NN_CASES``: 52 types, each at the size of a public model
    that runs it) on the card against the port on the CPU on the same
    seeded inputs, under ``_op_cases_check``: every integer and boolean
    output (hash ids, pooling indices, ``ctc_align``, ``edit_distance``,
    ``chunk_eval``'s counts) equal. The random ops (``random_crop``,
    ``sample_logits``) draw from each side's own generator: each side's
    output is held to its own draw (the crop a window of x, the logits
    the gather at Samples less log q). Returns the path's counts (no port
    kernel launches)."""
    from paddle_tpu_torch.core.op_registry import OP_IMPLS

    _, seen, counts = _op_cases_check(torch, smi_line, "misc_nn_ops_check", (
        (name, size, make(np.random.default_rng(SEED + 22 + i)), floats,
         build, own)
        for i, (name, (size, make, floats, build, own)) in enumerate(
            MISC_NN_CASES.items())))
    types = {n for n, f in OP_IMPLS.items()
             if f.__module__.endswith(".misc_ops")} - {"psroi_pool",
                                                        "detection_map"}
    types |= {"depthwise_conv2d", "conv3d", "conv2d_transpose", "pool3d",
              "conv3d_transpose", "depthwise_conv2d_transpose",
              "group_norm", "lrn", "bilinear_interp", "nearest_interp",
              "im2sequence", "grid_sampler", "pixel_shuffle"}
    check(len(types) == 52 and types <= seen,
          "misc and nn ops not run: %s" % sorted(types - seen))
    return counts


# scaled_dot_product_attention at Transformer-base widths: batch 64, 256
# steps, 8 heads of 64; f32, forward and backward
SDPA = dict(batch=64, seq=256, heads=8, d_model=512)
SDPA_PER_STEP = per_run(flash_attention_fwd=1, flash_attention_bwd=1)


def phase_sdpa_check(torch, smi_line):
    """The ``scaled_dot_product_attention`` layer (one ``flash_attention``
    op) at SDPA's widths with the gradients of sum(out * c) w.r.t. q, k
    and v: on the card one step launches the flash forward and backward
    kernels once each (counted, and seen by kind in a profiled step), and
    its output and gradients are held against the port on the CPU (the
    kernels' plain version): output within OP_OUT_TOL of max(1, max
    |CPU|), gradients within OP_GRAD_TOL relative L2. Returns the
    launches."""
    import paddle_tpu_torch as fluid

    b, t, d = SDPA["batch"], SDPA["seq"], SDPA["d_model"]
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        q, k, v = (L.data(n, shape=[b, t, d], append_batch_size=False,
                          stop_gradient=False) for n in "qkv")
        c = L.data("c", shape=[b, t, d], append_batch_size=False)
        out = L.scaled_dot_product_attention(q, k, v,
                                             num_heads=SDPA["heads"])
        grads = fluid.gradients(L.reduce_sum(L.elementwise_mul(out, c)),
                                [q, k, v])
    rng = np.random.default_rng(SEED + 23)
    feed = {n: _f32(rng, b, t, d) for n in "qkvc"}
    fetch = [out] + grads
    exe, scope = fluid.Executor(), fluid.Scope()
    reset_counts()
    card = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    launches = read_counts()
    check(launches == SDPA_PER_STEP, "sdpa step launched %s" % launches)
    kinds = {}
    device_ms, n_kernels, wall, _ = _profile_steps(
        torch, lambda: exe.run(main, feed=feed, fetch_list=fetch,
                               scope=scope), 1, counts=kinds)
    exe.close()
    choice = next(op for op in main.global_block().ops
                  if op.type == "flash_attention").attr("_kernel_choice")
    cpu = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                               fetch_list=fetch,
                                               scope=fluid.Scope())
    cmp = _det_compare(card, cpu, 1)
    ok = (cmp["max_err_over_magnitude"] <= OP_OUT_TOL
          and cmp["grad_rel_l2"] <= OP_GRAD_TOL
          and kinds.get("flash_attention_fwd") == 1
          and kinds.get("flash_attention_bwd") == 1)
    emit(dict({"phase": "sdpa_check", "shape": SDPA, "launches": launches,
               "profiled_kernels_by_kind": kinds,
               "device_ms_by_kind": device_ms, "kernels": n_kernels,
               "profiled_wall_ms": wall, "kernel_choice": choice,
               "tol": "out %g of max(1, max|CPU|), q/k/v gradients %g rel "
                      "L2" % (OP_OUT_TOL, OP_GRAD_TOL),
               "ok": ok, "device": smi_line}, **cmp))
    check(ok, "sdpa_check: %s" % cmp)
    return launches


def _debug_program(fluid, with_print=True, with_py_func=True):
    """x [8, 16] (multiples of 1/8) -> x * w (w a [16] parameter, 1 at
    start) -> Print(both phases) -> py_func(a -> a^2, backward 2 a dout)
    -> mean, SGD(0.5): every printed value and the first step's loss and
    gradient are exact in f32 on both sides."""
    from paddle_tpu_torch.core.layer_helper import LayerHelper

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        x = L.data("x", shape=[16])
        w = LayerHelper("dbg").create_parameter(
            fluid.ParamAttr(name="dbg_w",
                            initializer=fluid.initializer.Constant(1.0)),
            shape=[16], dtype="float32")
        h = L.elementwise_mul(x, w, axis=1)
        if with_print:
            h = L.Print(h, message="dbg:", summarize=6)
        if with_py_func:
            sq = main.global_block().create_var(name="dbg_sq",
                                                shape=(-1, 16),
                                                dtype="float32")
            L.py_func(func=lambda a: a * a, x=h, out=sq,
                      backward_func=lambda a, o, do: 2.0 * a * do)
            h = sq
        loss = L.mean(h)
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss, x


def phase_debug_ops_check(torch, smi_line):
    """``Print`` and ``py_func`` in a small training program
    (``_debug_program``) on the card and with the port on the CPU, three
    SGD steps: the printed lines (each step's forward value and gradient,
    ``bwd-grad``: exact in f32 on both sides, the squares taken in numpy
    on the host), the first step's loss and w's gradient and the w it
    leaves are equal; the card
    interprets all three runs (``step_report``: not captured, the reason
    naming ``print``), and a program with only ``py_func`` likewise names
    ``py_func``."""
    import contextlib as cl
    import io

    import paddle_tpu_torch as fluid

    feed = {"x": (np.arange(128, dtype="f4").reshape(8, 16) - 64) / 8}
    sides = {}
    reset_counts()
    for side, place in (("gpu", None), ("cpu", fluid.CPUPlace())):
        main, startup, loss, x = _debug_program(fluid)
        gb = main.global_block()
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            out = exe.run(main, feed=feed, fetch_list=[
                loss, gb.var("dbg_w@GRAD")], scope=scope)
            w = scope.numpy("dbg_w")
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[
                    loss, gb.var("dbg_w@GRAD")], scope=scope)
        report = exe.step_report(main) if side == "gpu" else None
        exe.close()
        sides[side] = (buf.getvalue(), out, w, report)
    text, out, w, report = sides["gpu"]
    ctext, cout, cw, _ = sides["cpu"]
    main, startup, loss, _ = _debug_program(fluid, with_print=False)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    py_report = exe.step_report(main)
    exe.close()
    counts = read_counts()
    lines = text.strip().split("\n")
    ok = (text == ctext and len(lines) == 6
          and all(" fwd " in ln for ln in lines[::2])
          and all(" bwd-grad " in ln for ln in lines[1::2])
          and all(np.array_equal(a, b) for a, b in zip(out, cout))
          and np.array_equal(w, cw)
          and not report["captured"] and report["captures"] == 0
          and report["interpreted"] == 3
          and report["reason"].startswith("op 'print'")
          and not py_report["captured"] and py_report["captures"] == 0
          and py_report["reason"].startswith("op 'py_func'"))
    emit({"phase": "debug_ops_check", "printed": lines,
          "printed_equal": text == ctext, "loss": float(out[0]),
          "w_grad_equal": bool(np.array_equal(out[1], cout[1])),
          "w_after_equal": bool(np.array_equal(w, cw)),
          "step_report": report, "py_func_step_report": py_report,
          "launches": counts, "ok": ok, "device": smi_line})
    check(ok, "debug_ops_check: card %r cpu %r report %s / %s"
          % (text, ctext, report, py_report))
    check(counts == per_run(), "debug_ops launched %s" % counts)
    return counts


def _dcgan_built(fluid, **kw):
    fluid.unique_name.switch()
    return build_dcgan(fluid, **dict(DCGAN, **kw))


def _rounding_verdict(names, params, runs, pert):
    """One DCGAN step, card against CPU, each quantity held to the larger
    of its bound and 5x the CPU step's own rounding sensitivity (its
    distance from ``pert``, the same CPU step on the input scaled by
    1 + 2^-20), as ``resnet_train_check`` holds ResNet-50
    (``_over_sensitivity``): the loss (1e-4 relative), each gradient (1e-2
    relative L2), each Adam update (1e-2 relative L2) and each parameter
    without a gradient, BN's moving statistics (1e-4 of max(1, max
    |CPU|)). Adam's first step moves an element by lr g / (|g| + eps /
    sqrt(1 - beta2)), about lr sign(g), so an element whose CPU gradient
    lies within the largest gradient difference of 0 (card's or scaled
    input's from the CPU, whichever is larger) may take any update of
    either sign: the updates and their sensitivity are compared over the
    other elements, and a flipped update only there is allowed."""
    (gpu, gpu_after), (cpu, cpu_after) = runs["gpu"], runs["cpu"]
    pert_out, pert_after = pert

    def rel(a):
        return abs(float(a[0]) - float(cpu[0])) / abs(float(cpu[0]))

    loss = {"loss": (rel(gpu), rel(pert_out))}
    grads, updates, rows, unexplained = {}, {}, {}, {}
    for i, p in enumerate(names):
        gg, gc, gp = (np.asarray(o[1 + i]) for o in (gpu, cpu, pert_out))
        live = np.abs(gc) > max(float(np.abs(g.astype("f8") - gc).max())
                                for g in (gg, gp))
        du, dc, dp = (after[p] - params[p]
                      for after in (gpu_after, cpu_after, pert_after))
        flip = np.sign(du) != np.sign(dc)
        if np.count_nonzero(flip & live):
            unexplained[p] = int(np.count_nonzero(flip & live))
        grads[p] = (_rel_l2(gg, gc), _rel_l2(gp, gc))
        updates[p] = (_rel_l2(du[live], dc[live]), _rel_l2(dp[live], dc[live]))
        rows[p] = {"grad": grads[p][0], "grad_sensitivity": grads[p][1],
                   "update": updates[p][0],
                   "update_sensitivity": updates[p][1],
                   "elements": int(du.size),
                   "beyond_grad_noise": int(live.sum()),
                   "flips": int(flip.sum())}
    stats = {p: (_elem_err(gpu_after[p], cpu_after[p]),
                 _elem_err(pert_after[p], cpu_after[p]))
             for p in sorted(set(params) - set(names))}
    bad = (_over_sensitivity(loss, 1e-4) + _over_sensitivity(grads, 1e-2)
           + ["update " + p for p in _over_sensitivity(updates, 1e-2)]
           + _over_sensitivity(stats, 1e-4))
    worst = max(rows, key=lambda p: rows[p]["grad"])
    worst_u = max(rows, key=lambda p: rows[p]["update"])
    worst_s = max(stats, key=lambda p: stats[p][0])
    finite = np.isfinite(float(gpu[0])) and all(
        np.isfinite(np.asarray(g)).all() for g in gpu[1:len(names) + 1])
    return {"loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
            "loss_rel_err": loss["loss"][0],
            "loss_rel_sensitivity": loss["loss"][1],
            "grads_compared": len(names), "worst_grad_param": worst,
            "worst_grad": rows[worst], "worst_update_param": worst_u,
            "worst_update": rows[worst_u], "per_param": rows,
            "no_grad_compared": len(stats), "worst_no_grad_param": worst_s,
            "worst_no_grad": stats[worst_s],
            "update_flips_beyond_grad_noise": unexplained,
            "over_tolerance": bad, "finite": bool(finite),
            "ok": bool(finite and not bad and not unexplained)}


def phase_dcgan_train_check(torch, smi_line, batch=4):
    """One D step and one G step of full-width DCGAN (``build_dcgan`` at
    DCGAN's widths) at batch 4 on the card and with the port on the CPU
    from one initial state (f32, TF32 off), and each CPU step again on its
    input scaled by 1 + 2^-20: the fake images of the G program within
    OP_OUT_TOL of max(1, max |CPU|); each step on the card three times
    with cuDNN's default algorithms (those ``dcgan_train`` runs) and twice
    with ``torch.backends.cudnn.deterministic``, every run under
    ``_rounding_verdict`` against the one CPU step. The G step's gradients
    are sensitive to rounding (the scaled input moves them by about 1e-3
    relative L2 on the CPU), and the default algorithms are not
    reproducible (some accumulate with atomics), so the default runs
    differ from each other; the deterministic runs do not. The line gives
    each run's worst distances and the largest gradient distance between
    two card runs of each kind. No port kernel launches
    (DCGAN_PER_STEP)."""
    import paddle_tpu_torch as fluid
    import types

    net = _dcgan_built(fluid)
    z, real = dcgan_feed(net, batch)
    fake = {}
    reset_counts()
    for side, place in (("gpu", None), ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(net.startup, scope=scope)
        if side == "gpu":
            init = _mt_params(scope, net.dg)
        else:
            fluid.bridge.load_program_params(scope, init, net.dg, "cpu")
        fake[side], = exe.run(net.g, feed={"z": z}, fetch_list=[net.fake],
                              scope=scope)
        exe.close()
    g_err = float(np.abs(fake["gpu"] - fake["cpu"]).max())
    scale = np.float32(1.0 + 2.0 ** -20)
    verdicts = {}
    for step, prog, loss, feed in (
            ("d", net.d, net.d_loss, {"real": real, "fake": fake["gpu"]}),
            ("g", net.dg, net.g_loss, {"z": z})):
        names, params, runs, secs = _card_cpu_step(
            fluid, prog, net.startup, types.SimpleNamespace(loss=loss),
            feed, DCGAN_PER_STEP, "dcgan_train_check %s" % step)
        gb = prog.global_block()
        fetch = [loss] + [gb.var(n + "@GRAD") for n in names]
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(net.startup, scope=scope)
        fluid.bridge.load_program_params(scope, params, prog, "cpu")
        pert = (exe.run(prog, feed={k: (v * scale).astype("f4")
                                    for k, v in feed.items()},
                        fetch_list=fetch, scope=scope),
                _mt_params(scope, prog))
        exe.close()

        def card_run():
            sc = fluid.Scope()
            ex = fluid.Executor()
            ex.run(net.startup, scope=sc)
            check(all(np.array_equal(sc.numpy(n), params[n])
                      for n in params),
                  "dcgan_train_check: the card's initial state changed")
            out = ex.run(prog, feed=feed, fetch_list=fetch, scope=sc)
            after = _mt_params(sc, prog)
            ex.close()
            return out, after

        card = {"default": [runs["gpu"], card_run(), card_run()]}
        torch.backends.cudnn.deterministic = True
        try:
            card["cudnn_deterministic"] = [card_run(), card_run()]
        finally:
            torch.backends.cudnn.deterministic = False
        each = {mode: [_rounding_verdict(names, params, {
            "gpu": r, "cpu": runs["cpu"]}, pert) for r in rs]
            for mode, rs in card.items()}
        verdicts[step] = dict(
            each["default"][0], cpu_step_s=secs["cpu"],
            gpu_step_s=secs["gpu"],
            runs={mode: [{"ok": v["ok"], "loss_rel_err": v["loss_rel_err"],
                          "grad_param": v["worst_grad_param"],
                          "grad_rel_l2": v["worst_grad"]["grad"],
                          "update_param": v["worst_update_param"],
                          "update_rel_l2": v["worst_update"]["update"],
                          "over_tolerance": v["over_tolerance"]}
                         for v in vs] for mode, vs in each.items()},
            card_vs_card_grad_rel_l2={mode: max(
                _rel_l2(np.asarray(a[0][1 + i]), np.asarray(b[0][1 + i]))
                for a, b in itertools.combinations(rs, 2)
                for i in range(len(names))) for mode, rs in card.items()},
            ok=all(v["ok"] for vs in each.values() for v in vs))
    launches = read_counts()
    g_params = int(sum(np.prod(p.shape) for p in net.dg.all_parameters()
                       if p.name in net.g_params))
    d_params = int(sum(np.prod(p.shape) for p in net.d.all_parameters()
                       if p.name in net.d_params))
    ok = (g_err <= OP_OUT_TOL * max(1.0, float(np.abs(
        fake["cpu"]).max())) and all(v["ok"] for v in verdicts.values()))
    emit({"phase": "dcgan_train_check", "batch": batch, "config": DCGAN,
          "g_parameters": g_params, "d_parameters": d_params,
          "optimizer": "Adam(%g, beta1 %g)" % (DCGAN_LR, DCGAN_BETA1),
          "fake_max_abs_err": g_err, "d_step": verdicts["d"],
          "g_step": verdicts["g"], "launches": launches,
          "tol": "max(stated, 5 x sensitivity): loss 1e-4 rel, grads and "
                 "the updates beyond the gradient noise 1e-2 rel L2, moving "
                 "stats 1e-4 of max(1, max|cpu|); flipped updates only "
                 "within the gradient noise", "ok": ok,
          "device": smi_line})
    check(ok, "dcgan_train_check: fake err %g, %s" % (g_err, verdicts))
    check(launches == DCGAN_PER_STEP, "dcgan_train_check launched %s"
          % launches)


def phase_dcgan_train(torch, smi_line, warmup=3, steps=10, prof_steps=2):
    """Full-width DCGAN at batch 128, each iteration G's images (the g
    program), one D step on them and the seeded real images (d) and one
    G step through D (dg), all three captured from their key's second run
    on, over one scope: 3 warm-up and 10 timed iterations on one fixed
    batch. Prints images/s, ms an iteration and a program, busy share,
    kernels an iteration by kind, peak memory above the state, each
    program's ``step_report``, both losses (a GAN's losses need not fall:
    the two sides train against each other); every loss is finite and
    every trained parameter moved. Returns (launches, replayed launches):
    none, none."""
    import paddle_tpu_torch as fluid

    net = _dcgan_built(fluid)
    z, real = dcgan_feed(net, DCGAN_BATCH)
    dev = fluid.CUDAPlace(0).torch_device()
    z, real = torch.from_numpy(z).to(dev), torch.from_numpy(real).to(dev)
    t0 = time.perf_counter()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(net.startup, scope=scope)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = torch.cuda.memory_allocated()
    setup_s = time.perf_counter() - t0
    d_losses, g_losses = [], []
    ms = {"iteration": [], "g": [], "d": [], "dg": []}
    runs = {"launched": 0, "replayed": 0}

    def iteration(record=True):
        n = len(d_losses)
        t_it = time.perf_counter()
        (fake,), dt_g, rep = counted_step(
            exe, net.g, DCGAN_PER_STEP, False, "dcgan g %d" % n,
            feed={"z": z}, fetch_list=[net.fake], scope=scope,
            return_numpy=False)
        (dl,), dt_d, rep_d = counted_step(
            exe, net.d, DCGAN_PER_STEP, False, "dcgan d %d" % n,
            feed={"real": real, "fake": fake}, fetch_list=[net.d_loss],
            scope=scope)
        (gl,), dt_dg, rep_g = counted_step(
            exe, net.dg, DCGAN_PER_STEP, False, "dcgan dg %d" % n,
            feed={"z": z}, fetch_list=[net.g_loss], scope=scope)
        for r in (rep, rep_d, rep_g):
            runs["replayed" if r else "launched"] += 1
        d_losses.append(float(dl))
        g_losses.append(float(gl))
        if record:
            ms["iteration"].append((time.perf_counter() - t_it) * 1e3)
            for k, dt in (("g", dt_g), ("d", dt_d), ("dg", dt_dg)):
                ms[k].append(dt * 1e3)

    start = {n: scope.numpy(n) for n in net.g_params + net.d_params}
    reset_counts()
    call1 = {}
    _profile_steps(torch, lambda: iteration(False), 1, counts=call1)
    for i in range(warmup - 1 + steps):
        iteration(i >= warmup - 1)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels, prof_wall, top_other = _profile_steps(
        torch, lambda: iteration(False), prof_steps, counts=replay)
    reports = {k: exe.step_report(getattr(net, k)) for k in ("g", "d", "dg")}
    launches = read_counts()
    still = [n for n in start if np.array_equal(start[n], scope.numpy(n))]
    exe.close()
    med = {k: statistics.median(v) for k, v in ms.items()}
    busy = sum(device_ms.values())
    emit({"phase": "dcgan_train", "batch": DCGAN_BATCH, "config": DCGAN,
          "precision": "f32",
          "captured": all(r["captured"] for r in reports.values()),
          "step_reports": reports, "warmup_iterations": warmup,
          "iterations": steps, "iteration_ms_median": med["iteration"],
          "iteration_ms": ms["iteration"],
          "g_program_ms_median": med["g"], "d_step_ms_median": med["d"],
          "g_step_ms_median": med["dg"],
          "images_per_s": DCGAN_BATCH / med["iteration"] * 1e3,
          "device_ms_per_iteration": device_ms, "device_ms": busy,
          "device_busy_share": busy / med["iteration"],
          "kernels_per_iteration": kernels,
          "kernels_by_kind": {"call1": call1, "replay": replay},
          "profiled_wall_ms_per_iteration": prof_wall,
          "top_other_kernels": top_other, "d_losses": d_losses,
          "g_losses": g_losses, "state_bytes": state,
          "peak_memory_bytes": peak, "peak_above_state_bytes": peak - state,
          "launches": launches, "runs_by_kind": runs, "setup_s": setup_s,
          "device": smi_line})
    check(all(r["captured"] and r["replays"] >= steps
              for r in reports.values()), "dcgan not captured: %s" % reports)
    check(np.isfinite(d_losses + g_losses).all(),
          "dcgan: non-finite loss: %s %s" % (d_losses, g_losses))
    check(not still, "dcgan: parameters not trained: %s" % still)
    check(launches == per_run(), "dcgan launches %s" % launches)
    return launches, per_run()


# ---------------------------------------------------------------------------
# The streaming loop (ROADMAP A6): a tail-followed record stream, versioned
# checkpoints, the hot swap into a live engine and a two-worker fleet
# ---------------------------------------------------------------------------

# DeepFM at config 5's widths (DEEPFM) trained from the stream, Adam at
# 1e-3 so that the held-out loss moves inside 23 steps; the stream's rows
# are labelled by ``streaming.synthesize_stream_files``'s rule
STREAM_LR = 1e-3
STREAM_WARMUP = 3
STREAM_STEPS = 20
STREAM_PUBLISH_EVERY = 5
STREAM_ASYNC_STEPS = 5
STREAM_REQUEST_ROWS = 8
STREAM_CLIENTS = 8
STREAM_KILL_BATCH = 4096
STREAM_CHECK_TOL = ("loss 1e-5 rel each step; each published parameter's "
                    "update from the shared start within 1e-3 rel L2, every "
                    "other published array (Adam's moments and beta "
                    "powers) within 1e-5 rel L2: deepfm_train_check's rule")


def stream_rule(seed):
    """``synthesize_stream_files``' labelling rule at config 5's widths:
    (per-id weights, dense weights, threshold)."""
    rule = np.random.RandomState(seed)
    w_id = rule.normal(0.0, 1.0, DEEPFM["sparse_feature_dim"])
    w_dense = rule.normal(0.0, 1.0, DEEPFM["dense_dim"])
    return w_id, w_dense, 0.5 * float(w_dense.sum())


def stream_rows(rng, n, rule):
    """``n`` rows drawn in bulk under ``rule``: the trainer's feed arrays
    (feat_ids int64 [n, 26], dense_value f32 [n, 13], label int64 [n, 1])."""
    w_id, w_dense, thresh = rule
    ids = rng.randint(0, DEEPFM["sparse_feature_dim"],
                      (n, DEEPFM["num_fields"]))
    dense = rng.uniform(0.0, 1.0, (n, DEEPFM["dense_dim"])).astype("f4")
    logit = w_id[ids].sum(1) + dense.astype("f8") @ w_dense
    return {"feat_ids": ids.astype("int64"), "dense_value": dense,
            "label": (logit > thresh).astype("int64")[:, None]}


def write_stream_part(path, rng, n, rule, chunk=4096):
    """Append ``n`` rows as recordio chunks of ``chunk`` records, serialised
    with numpy in bulk: each record is ``DataFeedDesc.serialize``'s bytes
    (the slots' little-endian buffers in order), framed as
    ``streaming.encode_chunk`` frames it. Returns the rows' feed arrays."""
    import struct
    import zlib

    rows = stream_rows(rng, n, rule)
    dt = np.dtype([("len", "<u4"),
                   ("feat_ids", "<i8", (DEEPFM["num_fields"],)),
                   ("dense_value", "<f4", (DEEPFM["dense_dim"],)),
                   ("label", "<i8", (1,))])
    rec = np.empty(n, dt)
    rec["len"] = dt.itemsize - 4
    for name in ("feat_ids", "dense_value", "label"):
        rec[name] = rows[name]
    with open(path, "ab") as f:
        for k in range(0, n, chunk):
            payload = rec[k:k + chunk].tobytes()
            f.write(struct.pack("<IIII", 0x7061646C, len(rec[k:k + chunk]),
                                len(payload),
                                zlib.crc32(payload) & 0xFFFFFFFF) + payload)
            f.flush()
    return rows


def stream_trainer(fluid, ckpt_dir, batch, place, holdout=1,
                   publish_every=STREAM_PUBLISH_EVERY):
    from paddle_tpu_torch import streaming

    return streaming.StreamingTrainer(
        ckpt_dir, num_fields=DEEPFM["num_fields"],
        sparse_feature_dim=DEEPFM["sparse_feature_dim"],
        embedding_size=DEEPFM["embedding_size"],
        dense_dim=DEEPFM["dense_dim"],
        hidden_sizes=DEEPFM["hidden_sizes"], batch_size=batch,
        learning_rate=STREAM_LR, publish_every_steps=publish_every,
        max_versions=4, holdout_batches=holdout, seed=SEED, place=place)


def _persistables(program, scope):
    return [v.name for v in program.list_vars()
            if v.persistable and v.name in scope]


def _version_arrays(ckpt_dir, version):
    with np.load(os.path.join(ckpt_dir, "checkpoint_%d" % version,
                              "replicated.npz")) as z:
        return {n: z[n] for n in z.files if not n.startswith("@")}


def _published_verdict(start, params, card, cpu):
    """STREAM_CHECK_TOL over one published version of each side: the
    worst update's and the worst other array's relative L2."""
    upd, other = {}, {}
    for n, want in cpu.items():
        got, want = card[n].astype("f8"), want.astype("f8")
        if n in params:
            upd[n] = _rel_l2(got - start[n], want - start[n])
        else:
            other[n] = _rel_l2(got, want)
    wu, wo = max(upd, key=upd.get), max(other, key=other.get)
    return {"worst_update": wu, "update_rel_l2": upd[wu],
            "worst_other": wo, "other_rel_l2": other[wo],
            "arrays": len(upd) + len(other),
            "ok": bool(upd[wu] <= 1e-3 and other[wo] <= 1e-5)}


def _dropout_restore_check(torch, fluid, ckpt_dir):
    """A captured dropout step on the card: save (the generator's state),
    three replays, load, three replays: the same draws, bitwise, from
    the same generator object and the same graph."""
    from paddle_tpu_torch import checkpoint

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup):
        fluid.unique_name.switch()
        y = fluid.layers.dropout(fluid.layers.data("x", shape=[4096]),
                                 dropout_prob=0.5)
    scope, exe = fluid.Scope(), fluid.Executor()
    feed = {"x": np.ones((64, 4096), "f4")}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    checkpoint.save_checkpoint(exe, ckpt_dir, main_program=main, scope=scope,
                               async_write=False)
    gen = scope.get("@RNG@")
    want = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
            for _ in range(3)]
    checkpoint.load_checkpoint(exe, ckpt_dir, main_program=main, scope=scope)
    got = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
           for _ in range(3)]
    report = exe.step_report(main)
    exe.close()
    return {"bitwise": all(np.array_equal(a, b) for a, b in zip(got, want)),
            "draws_differ": not np.array_equal(want[0], want[1]),
            "same_generator": scope.get("@RNG@") is gen,
            "generator_device": str(gen.device),
            "captures": report["captures"], "replays": report["replays"]}


def phase_stream_check(torch, smi_line, batch=64):
    """The streaming trainer at config 5's widths (batch 64) on the card
    and on the CPU from one startup state (the card's, copied across):
    both read the same five stream batches (one held out, four trained)
    and publish twice (every 2 steps, the second at the last step). Each
    step's loss and each published version's arrays are held by
    STREAM_CHECK_TOL; the card's last version, loaded into a fresh CPU
    scope, must equal the card's scope bitwise; and a captured dropout
    step, its generator restored from a checkpoint, must draw what the
    uninterrupted run drew, bitwise. Returns (launches, replayed
    launches): one scatter_add a launching step of the card's trainer."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import bridge, checkpoint, streaming

    reset_counts()
    tmp = tempfile.mkdtemp(prefix="stream_check_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        write_stream_part(os.path.join(data, "part-00000.recordio"),
                          np.random.RandomState(SEED), 5 * batch,
                          stream_rule(SEED), chunk=batch)
        card = stream_trainer(fluid, os.path.join(tmp, "card"), batch,
                              fluid.CUDAPlace(0), publish_every=2)
        cpu = stream_trainer(fluid, os.path.join(tmp, "cpu"), batch,
                             fluid.CPUPlace(), publish_every=2)
        names = _persistables(card.main, card.scope)
        params = {p.name for p in card.main.all_parameters()}
        start = {n: card.scope.numpy(n) for n in names}
        bridge.load_numpy_params(cpu.scope, start, "cpu", cpu.main)
        losses = {"card": [], "cpu": []}
        for side, tr in (("card", card), ("cpu", cpu)):
            stream = streaming.RecordStream(data, poll_interval_s=0.0)
            stream.close()
            tr.run(stream, on_step=lambda t, k=side: losses[k].append(
                t.last_train_loss))
            tr.close()
        counts = read_counts()
        report = card.exe.step_report(card.main)
        launching = report["interpreted"] + report["captures"]
        loss_err = [abs(a - b) / abs(b)
                    for a, b in zip(losses["card"], losses["cpu"])]
        versions = checkpoint.candidate_versions(card.ckpt_dir)
        cpu_versions = checkpoint.candidate_versions(cpu.ckpt_dir)
        start64 = {n: a.astype("f8") for n, a in start.items()}
        verdicts = {v: _published_verdict(
            start64, params, _version_arrays(card.ckpt_dir, v),
            _version_arrays(cpu.ckpt_dir, v)) for v in versions}
        fresh, cexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        checkpoint.load_checkpoint(cexe, card.ckpt_dir,
                                   main_program=card.main, scope=fresh,
                                   version=versions[0])
        bitwise = [n for n in names
                   if not np.array_equal(fresh.numpy(n),
                                         card.scope.numpy(n))]
        dropout = _dropout_restore_check(torch, fluid,
                                         os.path.join(tmp, "dropout"))
        card.exe.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "stream_check", "model": "deepfm", "config": DEEPFM,
          "batch": batch, "lr": STREAM_LR, "steps": len(losses["card"]),
          "losses_card": losses["card"], "losses_cpu": losses["cpu"],
          "loss_rel_err_max": max(loss_err), "versions": versions,
          "published": verdicts, "card_version_on_cpu_differs": bitwise,
          "dropout_restore": dropout, "step_report": report,
          "launches": counts, "tol": STREAM_CHECK_TOL, "device": smi_line})
    check(len(losses["card"]) == len(losses["cpu"]) == 4,
          "stream_check: steps %s" % losses)
    check(max(loss_err) <= 1e-5, "stream_check: losses %s" % losses)
    check(versions == cpu_versions == [1, 0],
          "stream_check: versions %s / %s" % (versions, cpu_versions))
    check(all(v["ok"] for v in verdicts.values()),
          "stream_check: published arrays %s" % verdicts)
    check(not bitwise, "stream_check: the card's version loaded on the CPU "
          "differs from the card's scope in %s" % bitwise)
    check(dropout["bitwise"] and dropout["draws_differ"]
          and dropout["same_generator"] and dropout["captures"] == 1
          and dropout["replays"] == 7,
          "stream_check: dropout after a generator restore %s" % dropout)
    check(report["captured"] and counts == per_run(scatter_add=launching),
          "stream_check: launches %s, report %s" % (counts, report))
    return counts, per_run(scatter_add=report["replays"])


class _SwapTimer:
    """The publisher's target: an engine whose reload windows are kept
    as (start, end, version) on the host clock."""

    def __init__(self, engine):
        self.engine = engine
        self.windows = []

    def reload(self, ckpt_dir, version=None):
        t0 = time.perf_counter()
        got = self.engine.reload(ckpt_dir, version=version)
        self.windows.append((t0, time.perf_counter(), got))
        return got


def _closed_loop(engine, rng, rule, stop, out, timeout_s=120.0):
    """One client of the closed loop: STREAM_REQUEST_ROWS-row DeepFM
    requests back to back until ``stop``; (submit, done, ok) each."""
    feed = stream_rows(rng, STREAM_REQUEST_ROWS, rule)
    feed = {k: feed[k] for k in ("feat_ids", "dense_value")}
    while not stop.is_set():
        t0 = time.perf_counter()
        try:
            got, = engine.predict(feed, timeout_s=timeout_s)
            ok = got.shape == (STREAM_REQUEST_ROWS, 1) \
                and bool(np.isfinite(got).all())
        except Exception:  # noqa: BLE001 — counted as a dropped request
            ok = False
        out.append((t0, time.perf_counter(), ok))


def _latency_split(reqs, windows):
    """requests/s and p99 ms of the requests that overlap a swap window
    and of the rest."""
    def p99(xs):
        xs = sorted(xs)
        return xs[int(0.99 * (len(xs) - 1))] * 1e3 if xs else None

    inside, outside = [], []
    for t0, t1, _ok in reqs:
        hit = any(t0 < b and t1 > a for a, b, _v in windows)
        (inside if hit else outside).append(t1 - t0)
    span = max(t1 for _, t1, _ in reqs) - min(t0 for t0, _, _ in reqs)
    in_s = sum(b - a for a, b, _ in windows)
    return {"requests": len(reqs), "requests_per_s": len(reqs) / span,
            "inside_swaps": {"requests": len(inside), "p99_ms": p99(inside),
                             "seconds": in_s,
                             "requests_per_s": len(inside) / in_s
                             if in_s else None},
            "outside_swaps": {"requests": len(outside),
                              "p99_ms": p99(outside),
                              "seconds": span - in_s,
                              "requests_per_s": len(outside)
                              / (span - in_s)}}


def _overlap_ms(a, b, spans):
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in spans) * 1e3


def _step_split(step_t, run_t, device, publish_t, swaps, gcs, progress_t,
                written, polls):
    """Each step interval (one on_step to the next) split on the host
    clock: the publish it held, the executor's run (host and device ms),
    the progress ledger's write, the ingest left over and, of that, the
    wait for the producer to finish the step's part file (step k reads
    file k; file 0 is held out) and the stream's polls that returned
    records (their ms and records); and the interval's overlap with the
    engine's swap windows and the collector's pauses."""
    out = []
    for k in range(1, len(step_t)):
        a, b = step_t[k - 1], step_t[k]
        ms = (b - a) * 1e3
        pub = _overlap_ms(a, b, publish_t)
        run = (run_t[k][1] - run_t[k][0]) * 1e3
        prog = (progress_t[k][1] - progress_t[k][0]) * 1e3
        done = written.get(k + 1, a)
        out.append({"step": k + 1, "ms": ms, "publish_ms": pub,
                    "run_host_ms": run, "run_device_ms": device[k],
                    "progress_ms": prog,
                    "ingest_ms": ms - pub - run - prog,
                    "producer_wait_ms": max(0.0, min(b, done) - a) * 1e3,
                    "poll_ms": _overlap_ms(a, b, [(x, y) for x, y, _ in
                                                  polls]),
                    "polled_records": sum(n for x, y, n in polls
                                          if a <= x < b),
                    "swap_overlap_ms": _overlap_ms(
                        a, b, [(x, y) for x, y, _ in swaps]),
                    "gc_ms": _overlap_ms(a, b, [(x, y) for x, y, _ in gcs]),
                    "gc_generations": sorted({g for x, y, g in gcs
                                              if x < b and y > a})})
    return out


def phase_stream_train(torch, smi_line, ctx):
    """The streaming loop at config 5's full widths, batch 32768, on the
    card. A producer thread appends one 32768-row part file at a time
    (numpy-serialised, ``write_stream_part``) while the trainer
    tail-follows them. First ``AsyncExecutor.run`` over the five sealed
    files (the C++ prefetch queue, 4 reader threads, 5 steps; its own
    DeepFM, Adam(1e-4)); then ``StreamingTrainer`` (one held-out batch,
    3 + 20 steps, publishing every 5 with ``async_write`` and once more at
    the end) while ``ModelPublisher`` hot-swaps each version into a
    ``ServingEngine`` on the card over the trainer's ``serve_dir``, under
    a closed loop of STREAM_CLIENTS clients of 8-row requests. Prints the
    ingest rate, step ms and the device's busy share (each step over 3x
    the median split by ``_step_split``), the snapshot's ms
    on the training thread beside the writer thread's, publish-to-swap
    staleness, requests/s and p99 inside and outside the swap windows,
    dropped requests (0), scatter_add's launches (one a launching step)
    and replays, and the first and last held-out loss (the last lower).
    Leaves the trainer and its directories in ``ctx`` for
    ``stream_fleet``. Returns (launches, replayed launches)."""
    import threading

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving, streaming
    from paddle_tpu_torch.streaming.trainer import feed_desc

    reset_counts()
    tmp = ctx["tmp"] = tempfile.mkdtemp(prefix="stream_train_")
    data = ctx["data"] = os.path.join(tmp, "data")
    os.makedirs(data)
    rule = ctx["rule"] = stream_rule(SEED)
    batch = DEEPFM_BATCH
    part = os.path.join(data, "part-%05d.recordio")
    t0 = time.perf_counter()
    for i in range(STREAM_ASYNC_STEPS):  # the sealed files
        write_stream_part(part % i, np.random.RandomState(1000 + i), batch,
                          rule)
    write_s = time.perf_counter() - t0

    # AsyncExecutor over the sealed files, through the native queue
    main, startup, spec = build_deepfm(fluid)
    ascope = fluid.Scope()
    aexe = fluid.AsyncExecutor(fluid.CUDAPlace(0))
    aexe._exe.run(startup, scope=ascope)
    desc = feed_desc(DEEPFM["num_fields"], DEEPFM["dense_dim"], batch)
    files = [part % i for i in range(STREAM_ASYNC_STEPS)]
    check(fluid.native.native_available(), "the native data plane did not "
          "build")
    t0 = time.perf_counter()
    aloss, = aexe.run(main, desc, files, thread_num=4, fetch=[spec.loss],
                      scope=ascope)
    async_s = time.perf_counter() - t0
    async_report = aexe._exe.step_report(main)
    async_run = dict(aexe.last_run)
    aexe._exe.close()
    del ascope

    # the trainer, the engine on its serve dir, the publisher, the loop
    trainer = ctx["trainer"] = stream_trainer(
        fluid, os.path.join(tmp, "ckpt"), batch, fluid.CUDAPlace(0))
    total_steps = STREAM_WARMUP + STREAM_STEPS
    n_files = 1 + total_steps  # one held-out batch, then a batch a step
    stop_producer = threading.Event()

    written = {}  # part file -> when the producer finished it

    def producer():
        for i in range(STREAM_ASYNC_STEPS, n_files):
            if stop_producer.is_set():
                return
            write_stream_part(part % i, np.random.RandomState(1000 + i),
                              batch, rule)
            written[i] = time.perf_counter()

    engine = ctx["engine"] = serving.ServingEngine(
        trainer.serve_dir, max_batch_size=STREAM_REQUEST_ROWS)
    engine.warmup()
    target = _SwapTimer(engine)
    pub = ctx["publisher"] = streaming.ModelPublisher(
        trainer.ckpt_dir, target, poll_interval_s=0.05)
    stop = ctx["stop_clients"] = threading.Event()
    reqs = []
    clients = ctx["clients"] = [
        threading.Thread(target=_closed_loop,
                         args=(engine, np.random.RandomState(50 + k), rule,
                               stop, reqs), daemon=True)
        for k in range(STREAM_CLIENTS)]
    for c in clients:
        c.start()
    pub.start()
    prod = threading.Thread(target=producer, daemon=True)
    ctx["producer"] = (prod, stop_producer)
    stream = streaming.RecordStream(data, poll_interval_s=0.005)
    step_t, evals, writers, dev_ms = [], [], [], []
    orig_run = trainer.exe.run

    def timed_run(program=None, **kw):
        # events around each training step: the device's time for it
        if program is not trainer.main:
            return orig_run(program, **kw)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = orig_run(program, **kw)
        b.record()
        run_t.append((t0, time.perf_counter()))
        dev_ms.append((a, b))
        return out

    trainer.exe.run = timed_run
    run_t, publish_t, gc_t, gc_open, progress_t = [], [], [], {}, []
    orig_progress = trainer._write_progress

    def timed_progress():
        t0 = time.perf_counter()
        orig_progress()
        progress_t.append((t0, time.perf_counter()))

    trainer._write_progress = timed_progress
    orig_poll = stream._poll_once

    def timed_poll():
        t0 = time.perf_counter()
        got = orig_poll()
        if got:
            poll_t.append((t0, time.perf_counter(), len(got)))
        return got

    poll_t = []
    stream._poll_once = timed_poll

    def on_gc(phase, info):
        # the collector's pauses on the host clock, to name slow steps
        if phase == "start":
            gc_open["t"] = time.perf_counter()
        elif "t" in gc_open:
            gc_t.append((gc_open.pop("t"), time.perf_counter(),
                         info["generation"]))

    def on_publish(tr):
        publish_t.append((step_t[-1], time.perf_counter()))
        evals.append(tr.last_eval_loss)
        writers.append(tr._writer)

    gc.callbacks.append(on_gc)
    t_start = time.perf_counter()
    prod.start()
    try:
        trainer.run(stream, max_steps=total_steps,
                    on_step=lambda tr: step_t.append(time.perf_counter()),
                    on_publish=on_publish)
    finally:
        gc.callbacks.remove(on_gc)
    train_s = time.perf_counter() - t_start
    rows = stream.rows_total
    if trainer.publish() is not None:  # the last step's version
        on_publish(trainer)
    prod.join(60.0)
    for w in writers:
        w.wait()
    trainer.exe.run = orig_run
    del trainer._write_progress, stream._poll_once
    newest = max(int(os.path.basename(w.path).split("_")[1])
                 for w in writers)
    deadline = time.perf_counter() + 60.0
    while pub.served_version != newest and time.perf_counter() < deadline:
        time.sleep(0.05)
    time.sleep(0.5)  # requests on the newest weights
    stop.set()
    for c in clients:
        c.join(150.0)
    pub.stop()
    torch.cuda.synchronize()
    step_ms = [(b - a) * 1e3 for a, b in zip(step_t, step_t[1:])]
    timed_ms = step_ms[STREAM_WARMUP - 1:]
    device = [a.elapsed_time(b) for a, b in dev_ms]
    timed_dev = device[STREAM_WARMUP:]
    report = trainer.exe.step_report(trainer.main)
    counts = read_counts()
    launching = (report["interpreted"] + report["captures"]
                 + async_report["interpreted"] + async_report["captures"])
    replays = report["replays"] + async_report["replays"]
    dropped = sum(1 for _, _, ok in reqs if not ok)
    split = _latency_split(reqs, target.windows)
    snapshot_ms = [w.snapshot_s * 1e3 for w in writers]
    split_steps = _step_split(step_t, run_t, device, publish_t,
                              target.windows, gc_t, progress_t,
                              written, poll_t)[STREAM_WARMUP - 1:]
    slow = [r for r in split_steps
            if r["ms"] > 3.0 * statistics.median(timed_ms)]
    write_ms = [w.write_s * 1e3 for w in writers]
    emit({"phase": "stream_train", "model": "deepfm", "config": DEEPFM,
          "table": [DEEPFM["sparse_feature_dim"], DEEPFM_WIDTH],
          "batch": batch, "lr": STREAM_LR, "producer": "one 32768-row "
          "part file at a time, numpy-serialised, appended while the "
          "trainer tail-follows", "sealed_files_write_s": write_s,
          "async_executor": {"steps": async_run["steps"],
                             "records": async_run["records"],
                             "queue": async_run["queue"], "threads": 4,
                             "seconds": async_s,
                             "rows_per_s": async_run["records"] / async_s,
                             "loss": float(np.asarray(aloss)),
                             "step_report": async_report},
          "steps": trainer.step, "rows_ingested": rows,
          "ingest_rows_per_s": rows / train_s,
          "ingest_gauge_rows_per_s": stream.rows_per_sec(),
          "step_ms_median": statistics.median(timed_ms),
          "step_ms_min": min(timed_ms), "step_ms_max": max(timed_ms),
          "step_ms": timed_ms, "slow_steps": slow,
          "step_split_median_ms": {
              k: statistics.median(r[k] for r in split_steps)
              for k in ("ingest_ms", "producer_wait_ms", "poll_ms",
                        "polled_records", "run_host_ms",
                        "run_device_ms", "progress_ms", "publish_ms",
                        "swap_overlap_ms", "gc_ms")},
          "device_ms_median":
              statistics.median(timed_dev),
          "device_busy_share": sum(timed_dev) / sum(timed_ms),
          "snapshot_ms_training_thread": snapshot_ms,
          "write_ms_writer_thread": write_ms,
          "publishes": trainer.publishes,
          "publish_failures": trainer.publish_failures,
          "swaps": pub.swap_count, "served_version": pub.served_version,
          "newest_version": newest,
          "staleness_s": pub.staleness_samples,
          "swap_ms": [(b - a) * 1e3 for a, b, _ in target.windows],
          "serving": split, "dropped_requests": dropped,
          "holdout_loss_first": evals[0], "holdout_loss_last": evals[-1],
          "holdout_losses": evals, "step_report": report,
          "launches": counts, "launching_steps": launching,
          "replayed_steps": replays, "device": smi_line})
    check(async_run["queue"] == "native" and async_run["steps"]
          == STREAM_ASYNC_STEPS and async_run["records"]
          == STREAM_ASYNC_STEPS * batch,
          "stream_train: AsyncExecutor.run %s" % async_run)
    check(trainer.step == total_steps and trainer.publish_failures == 0,
          "stream_train: %d steps, %d failed publishes"
          % (trainer.step, trainer.publish_failures))
    check(report["captured"] and async_report["captured"],
          "stream_train: not captured: %s / %s" % (report, async_report))
    check(counts == per_run(scatter_add=launching),
          "stream_train: launches %s, launching steps %d"
          % (counts, launching))
    check(dropped == 0 and split["requests"] > 0,
          "stream_train: %d of %d requests dropped" % (dropped, len(reqs)))
    check(pub.served_version == newest and pub.swap_count >= 2,
          "stream_train: served %s of %s after %d swaps"
          % (pub.served_version, newest, pub.swap_count))
    check(np.isfinite(evals).all() and evals[-1] < evals[0],
          "stream_train: held-out losses %s" % evals)
    ctx["engine"] = None
    engine.shutdown()
    return counts, per_run(scatter_add=replays)


def _worker_stats(router):
    """Each worker's ``stats`` verb: its gauges (``serve_version``)."""
    from paddle_tpu_torch.serving import rpc

    out = []
    for w in router._workers:
        sock = rpc.connect(w.address, timeout=60.0)
        try:
            rpc.send_msg(sock, {"type": "stats"})
            header, _ = rpc.recv_msg(sock)
        finally:
            sock.close()
        out.append(header["stats"])
    return out


def _predictor_at(fluid, trainer, version):
    """An in-process predictor on the card of the trainer's serve dir with
    ``version``'s weights applied."""
    from paddle_tpu_torch import checkpoint

    pred = fluid.inference.Predictor(trainer.serve_dir)
    _, updates, _ = checkpoint.load_staged(trainer.ckpt_dir, trainer.main,
                                           version=version)
    checkpoint.apply_updates(
        pred._scope, [(n, a) for n, a in updates if n in pred._scope])
    return pred


def phase_stream_fleet(torch, smi_line, ctx, kill_steps=4):
    """Two DeepFM workers on the card behind ``Router`` (``--warmup
    --ladder 8``) over ``stream_train``'s serve dir, driven by
    ``FleetPublisher`` through ``RouterTarget``: two clean two-phase
    rounds (each after two more training steps of ``stream_train``'s
    trainer, replays, and a publish), then a version corrupted with
    ``checkpoint._flip_byte`` that both workers refuse at prepare, the
    fleet staying on the intact one. After each round both workers report
    one ``serve_version``, and an 8-row request's answer equals an
    in-process predictor loaded from that version, bitwise. Then the kill
    drill: the trainer CLI on the card (config 5's widths, batch
    STREAM_KILL_BATCH) under ``PADDLE_TPU_FAULTS=checkpoint.write:hang``
    is SIGKILLed inside its third publish; its torn version is invisible
    to ``candidate_versions``, and a restarted trainer resumes from the
    newest intact version, counts ``replayed_rows`` as the ledger's rows
    less the cursor's, and publishes past the wreck. Returns (launches,
    replayed launches) of this process."""
    import signal
    import warnings

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import checkpoint, streaming
    from paddle_tpu_torch.serving import Router, RouterClient
    from paddle_tpu_torch.streaming.trainer import TRAINER_READY_PREFIX

    reset_counts()
    trainer = ctx["trainer"]
    d = trainer.ckpt_dir
    router = ctx["router"] = Router(
        trainer.serve_dir, num_workers=ROUTER_WORKERS,
        worker_args=["--warmup", "--ladder", str(STREAM_REQUEST_ROWS),
                     "--device", ROUTER_DEVICE])
    t0 = time.perf_counter()
    router.start()
    spawn_s = time.perf_counter() - t0
    client = ctx["client"] = RouterClient(router.address)
    fp = streaming.FleetPublisher(d, {"router": streaming.RouterTarget(
        client)})
    rng = np.random.RandomState(77)
    request = stream_rows(rng, STREAM_REQUEST_ROWS, ctx["rule"])
    request = {k: request[k] for k in ("feat_ids", "dense_value")}
    before = trainer.exe.step_report(trainer.main)["replays"]

    def train_and_publish(steps, seed):
        for k in range(steps):
            trainer.exe.run(trainer.main, feed=stream_rows(
                np.random.RandomState(seed + k), DEEPFM_BATCH, ctx["rule"]),
                fetch_list=[trainer.loss], scope=trainer.scope)
        w = trainer.publish()
        w.wait()
        return int(os.path.basename(w.path).split("_")[1])

    rounds = []
    for r in range(2):
        v = train_and_publish(2, 9000 + 10 * r)
        t0 = time.perf_counter()
        got = fp.poll_once()
        swap_s = time.perf_counter() - t0
        served = [s.get("serve_version") for s in _worker_stats(router)]
        answer = client.predict(request, timeout_s=ROUTER_TIMEOUT_S)[0]
        want = _predictor_at(fluid, trainer, v).run(request)[0]
        rounds.append({"version": v, "committed": got, "served": served,
                       "two_phase_s": swap_s,
                       "bitwise": bool(np.array_equal(answer, want)),
                       "max_abs_diff": float(np.abs(answer - want).max())})
    good = rounds[-1]["version"]
    bad = train_and_publish(2, 9100)
    checkpoint._flip_byte(os.path.join(d, "checkpoint_%d" % bad,
                                       "replicated.npz"))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        refused = fp.poll_once()
    served_after = [s.get("serve_version") for s in _worker_stats(router)]
    answer = client.predict(request, timeout_s=ROUTER_TIMEOUT_S)[0]
    want = _predictor_at(fluid, trainer, good).run(request)[0]
    corrupt = {"version": bad, "committed": refused,
               "prepare_failures": fp.prepare_failures,
               "fleet_version": fp.fleet_version, "served": served_after,
               "bitwise_on_intact": bool(np.array_equal(answer, want))}
    fleet_replays = trainer.exe.step_report(trainer.main)["replays"] - before
    client.close()
    router.shutdown()
    ctx["router"] = None
    fp.release()

    # the kill drill: the trainer CLI on the card, killed mid-publish
    kill_ck = os.path.join(ctx["tmp"], "kill_ckpt")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.streaming.trainer",
           "--data-dir", ctx["data"], "--ckpt-dir", kill_ck,
           "--device", ROUTER_DEVICE, "--publish-every", "2",
           "--batch-size", str(STREAM_KILL_BATCH),
           "--sparse-dim", str(DEEPFM["sparse_feature_dim"]),
           "--num-fields", str(DEEPFM["num_fields"]),
           "--embedding-size", str(DEEPFM["embedding_size"]),
           "--dense-dim", str(DEEPFM["dense_dim"]),
           "--hidden", ",".join(map(str, DEEPFM["hidden_sizes"])),
           "--holdout-batches", "1", "--poll-interval", "0.02",
           "--seed", str(SEED)]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = ctx["kill_proc"] = subprocess.Popen(
        cmd + ["--steps", "999"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env=dict(env, PADDLE_TPU_FAULTS="checkpoint.write:hang(600)@3"))
    torn = os.path.join(kill_ck, "checkpoint_2")
    deadline = time.perf_counter() + 300.0
    # killed while version 2's write hangs, once versions 0 and 1 have
    # landed: the trainer makes a version's directory when it publishes,
    # and the writer thread may still be writing the two before it
    while not (os.path.isdir(torn)
               and 1 in checkpoint.candidate_versions(kill_ck)):
        check(proc.poll() is None and time.perf_counter() < deadline,
              "stream_fleet: the killed trainer exited or never published "
              "(rc %s)" % proc.poll())
        time.sleep(0.02)
    proc.send_signal(signal.SIGKILL)
    proc.wait(60)
    kill_s = time.perf_counter() - t0
    dirs = sorted(n for n in os.listdir(kill_ck)
                  if n.startswith("checkpoint_"))
    visible = checkpoint.candidate_versions(kill_ck)
    _, extra = checkpoint.load_extra(kill_ck)
    with open(os.path.join(kill_ck, "progress.json")) as f:
        ledger = json.load(f)
    t0 = time.perf_counter()
    proc = ctx["kill_proc"] = subprocess.Popen(
        cmd + ["--steps", str(int(extra["step"]) + kill_steps)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out, err = proc.communicate(timeout=300)
    restart_s = time.perf_counter() - t0
    check(proc.returncode == 0, "stream_fleet: the restarted trainer "
          "exited %d: %s" % (proc.returncode, err[-2000:]))
    lines = out.strip().splitlines()
    ready = json.loads(next(l for l in lines if l.startswith(
        TRAINER_READY_PREFIX))[len(TRAINER_READY_PREFIX):])
    result = json.loads(lines[-1])
    after = checkpoint.candidate_versions(kill_ck)
    counts = read_counts()
    drill = {"dirs_at_kill": dirs, "visible_at_kill": visible,
             "ledger_rows": ledger["rows"],
             "cursor_rows": extra["cursor"]["rows"],
             "resumed_version": ready["resumed_version"],
             "replayed_rows": ready["replayed_rows"],
             "restart_steps": result["steps"],
             "restart_publish_failures": result["publish_failures"],
             "versions_after": after, "kill_s": kill_s,
             "restart_s": restart_s}
    emit({"phase": "stream_fleet", "model": "deepfm", "config": DEEPFM,
          "workers": ROUTER_WORKERS, "ladder": [STREAM_REQUEST_ROWS],
          "spawn_s": spawn_s, "rounds": rounds, "corrupt_round": corrupt,
          "kill_drill": drill, "training_replays": fleet_replays,
          "launches": counts, "device": smi_line})
    for r in rounds:
        check(r["committed"] == r["version"]
              and r["served"] == [r["version"]] * ROUTER_WORKERS
              and r["bitwise"], "stream_fleet: round %s" % r)
    check(refused is None and corrupt["prepare_failures"] == 1
          and corrupt["fleet_version"] == good
          and served_after == [good] * ROUTER_WORKERS
          and corrupt["bitwise_on_intact"],
          "stream_fleet: corrupt round %s" % corrupt)
    torn_dirs = {int(n.split("_")[1]) for n in dirs} - set(visible)
    check(2 in torn_dirs and visible and max(visible) < 2,
          "stream_fleet: torn versions %s visible %s" % (dirs, visible))
    check(ready["resumed_version"] == visible[0]
          and ready["replayed_rows"] == ledger["rows"]
          - extra["cursor"]["rows"] and result["publish_failures"] == 0
          and after[0] > max(torn_dirs),
          "stream_fleet: kill drill %s" % drill)
    check(counts == per_run(), "stream_fleet: launches %s" % counts)
    return counts, per_run(scatter_add=fleet_replays)


def close_stream(ctx):
    """Reap what the streaming phases started, whether or not they
    passed: the kill drill's trainer, the router's workers, the engine,
    the clients, the producer; then the directories."""
    proc = ctx.get("kill_proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(30)
    if ctx.get("router") is not None:
        ctx["router"].shutdown()
    if ctx.get("stop_clients") is not None:
        ctx["stop_clients"].set()
    if ctx.get("publisher") is not None:
        ctx["publisher"].stop()
    if ctx.get("engine") is not None:
        ctx["engine"].shutdown()
    if ctx.get("producer") is not None:
        ctx["producer"][1].set()
        ctx["producer"][0].join(60.0)
    if ctx.get("trainer") is not None:
        ctx["trainer"].close()
        ctx["trainer"].exe.close()
    if ctx.get("tmp"):
        shutil.rmtree(ctx["tmp"], ignore_errors=True)


# -- dygraph (A8): BERT-base through the imperative modules -----------------

# one step of models.bert_dygraph at BERT-base: a flash forward and backward
# a layer (self-attention, called directly as the reference calls its
# kernel), the MLM head's fused CE; the dygraph LayerNorm is plain torch,
# as the reference's is jnp
DY_PER_STEP = per_run(flash_attention_fwd=BERT["layers"],
                      flash_attention_bwd=BERT["layers"], fused_ce_fwd=1)
DY_LR = 1e-4
DY_CAPTURE_STEPS = 4


def dygraph_feed(batch, seed=SEED):
    """``bert_dygraph.sample_batch`` at BERT's widths, with key lengths
    from half the sequence to all of it (the first row full), so the
    flash kernels read a per-key bias."""
    from paddle_tpu_torch.models import bert_dygraph

    rng = np.random.RandomState(seed)
    ids, seg, _, lbl, wts, nsp = bert_dygraph.sample_batch(
        batch, BERT["seq"], BERT["vocab"], rng)
    seq = BERT["seq"]
    lens = rng.randint(seq // 2, seq + 1, batch).astype(np.int32)
    lens[0] = seq
    return ids, seg, lens, lbl, wts, nsp


def build_dygraph_bert(fluid, place, dropout_rate, amp):
    """BERT-base pretraining from the dygraph modules (BASELINE config 4,
    ``bench.py:1233-1284``) with its parameters on ``place``, drawn on the
    host from seed SEED: a model built on the card and one on the CPU
    hold the same weights. The three lazy FC heads are built in the order
    their forward builds them."""
    from paddle_tpu_torch.dygraph import layers as dlayers
    from paddle_tpu_torch.models import bert_dygraph

    dlayers.seed(SEED)
    with fluid.unique_name.guard(), fluid.dygraph.guard(place):
        model = bert_dygraph.bert_base_dygraph(
            vocab_size=BERT["vocab"], seq_len=BERT["seq"],
            d_model=BERT["d_model"], d_ff=BERT["d_ff"],
            n_head=BERT["heads"], n_layer=BERT["layers"],
            dropout_rate=dropout_rate, amp=amp)[0]
        for fc in (model.mlm_transform, model.pooler, model.nsp_out):
            fc._build_once(BERT["d_model"])
    return model


def _dygraph_eager(fluid, model, place, feed, label, want):
    """One eager step of the tape (``loss.backward()``): its loss and
    every parameter's gradient (numpy), the launches held to ``want``."""
    before = read_counts(), read_bf16_counts(), read_wgmma_counts()
    with fluid.dygraph.guard(place):
        loss = model(*feed)
        loss.backward()
    out = [loss.numpy()] + [p.gradient() for p in model.parameters()]
    for p in model.parameters():
        p.clear_gradient()
    after = read_counts(), read_bf16_counts(), read_wgmma_counts()
    got = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    check(got[0] == want[0] and got[1] == want[1] and got[2] == want[2],
          "%s launches %s (bf16 %s, wgmma %s) != %s" % (label, *got,
                                                        want[0]))
    return out


def _dygraph_capture_case(torch, fluid, amp, batch, dropout_rate):
    """The captured step against the eager one (capture_check's rule):
    DY_CAPTURE_STEPS steps of ``make_train_step`` called eagerly,
    INTERPRETED_RUNS_ATOMIC times (the flash backward sums dq by atomics),
    and the same steps through ``dygraph.CapturedTrainStep`` (call 1 eager
    under the sync check, call 2 the capture, then replays), all from one
    copied state and one generator state. The captured run's losses and
    final parameters and moments, as one relative L2, lie within twice
    the largest distance of two eager runs plus F32_ROUNDING; the capture
    launches what call 1 launched, a replay nothing from Python."""
    from paddle_tpu_torch.models import bert_dygraph

    dev = torch.device("cuda", 0)
    model = build_dygraph_bert(fluid, fluid.CUDAPlace(0), dropout_rate, amp)
    step, params, opt = bert_dygraph.make_train_step(model, DY_LR)
    names = sorted(params)
    start = [{n: t.clone() for n, t in params.items()},
             {k: {n: t.clone() for n, t in opt[k].items()}
              for k in ("m", "v")}, opt["t"].clone()]
    gen = torch.Generator(dev).manual_seed(SEED)
    gen_state = gen.get_state()
    feed = [torch.as_tensor(f).to(dev) for f in dygraph_feed(batch)]

    def reset():
        for n in names:
            params[n].copy_(start[0][n])
            opt["m"][n].copy_(start[1]["m"][n])
            opt["v"][n].copy_(start[1]["v"][n])
        opt["t"].copy_(start[2])
        gen.set_state(gen_state)

    def state():
        return ([params[n].double() for n in names]
                + [opt[k][n].double() for k in ("m", "v") for n in names])

    def run(captured):
        reset()
        cs = fluid.dygraph.CapturedTrainStep(step, params, opt, gen) \
            if captured else None
        losses, launches = [], []
        for i in range(DY_CAPTURE_STEPS):
            before = read_counts()
            if cs is not None and i == 0:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    loss = cs(*feed)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            elif cs is not None:
                loss = cs(*feed)
            else:
                loss = step(params, opt, gen, *feed)[0]
            losses.append(loss.double().reshape(1))
            after = read_counts()
            launches.append({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
        out = [torch.cat(losses)] + state()
        report = cs.report() if cs is not None else None
        if cs is not None:
            cs.close()
        return out, launches, report

    def dist(a, b):
        num = sum(float(torch.square(x - y).sum()) for x, y in zip(a, b))
        den = sum(float(torch.square(y).sum()) for y in b)
        return float(np.sqrt(num / max(den, 1e-300)))

    eager = [run(False) for _ in range(INTERPRETED_RUNS_ATOMIC)]
    cap, cap_launches, report = run(True)
    ii = [dist(x[0], y[0]) for x, y in itertools.combinations(eager, 2)]
    d_ci = dist(cap, eager[0][0])
    label = "dygraph capture (%s)" % ("amp" if amp else "f32")
    emit({"phase": "dygraph_check", "case": "captured_vs_eager",
          "amp": amp, "dropout": dropout_rate, "batch": batch,
          "steps": DY_CAPTURE_STEPS, "step_report": report,
          "eager_runs": len(eager), "eager_pairs": ii,
          "captured_vs_eager": d_ci,
          "losses_captured": [float(x) for x in cap[0]],
          "losses_eager": [float(x) for x in eager[0][0][0]],
          "launches_call1": cap_launches[0],
          "launches_capture": cap_launches[1],
          "replay_launches": cap_launches[2:],
          "tol": "captured vs eager <= 2 x the largest eager vs eager + "
                 "%g (rel L2 over the losses, parameters and moments)"
                 % F32_ROUNDING, "sync_debug_call1": "error"})
    check(report["captured"] and (report["interpreted"], report["captures"],
                                  report["replays"])
          == (1, 1, DY_CAPTURE_STEPS - 2), "%s: %s" % (label, report))
    want = {k: v for k, v in DY_PER_STEP.items() if v}
    check(cap_launches[0] == cap_launches[1] == want
          and not any(cap_launches[2:]),
          "%s launches %s" % (label, cap_launches))
    check(d_ci <= 2 * max(ii) + F32_ROUNDING,
          "%s: captured vs eager %g, eager vs eager %s" % (label, d_ci, ii))
    del model
    steps = INTERPRETED_RUNS_ATOMIC * DY_CAPTURE_STEPS + 2
    return ({k: n * steps for k, n in DY_PER_STEP.items()},
            {k: n * (DY_CAPTURE_STEPS - 2) for k, n in DY_PER_STEP.items()})


def phase_dygraph_check(torch, smi_line, batch=2):
    """One full-width BERT-base step through the dygraph tape at batch 2,
    dropout 0, on the card and with the port on the CPU from the same
    weights (drawn on the host from one seed) and feed. f32 by
    ``train_check``'s rule: the loss and the global gradient norm within
    1e-4 relative, every parameter's gradient within 1e-2 relative L2.
    AMP (``amp=True``: bf16 products, the bf16 forms of the flash and CE
    kernels, the flash forward and backward and the CE on their wgmma
    forms) by ``_amp_verdict``'s, against the CPU's AMP, f32 and
    perturbed (parameters x (1 + 2^-20)) AMP steps; the card's f32 step
    must fail it. Each card step launches DY_PER_STEP, under AMP all in
    bf16. Then the captured step against the eager one under AMP with
    dropout 0.1 (``_dygraph_capture_case``). Returns (launches,
    replayed)."""
    import paddle_tpu_torch as fluid

    card, cpu = fluid.CUDAPlace(0), fluid.CPUPlace()
    feed = dygraph_feed(batch)
    reset_counts()
    runs, cpu_s = {}, {}
    for amp in (False, True):
        want = (DY_PER_STEP, bf16_part(DY_PER_STEP, amp),
                wgmma_part(DY_PER_STEP, amp))
        m = build_dygraph_bert(fluid, card, 0.0, amp)
        runs[("gpu", amp)] = _dygraph_eager(fluid, m, card, feed,
                                            "dygraph_check card", want)
        names = [p.name for p in m.parameters()]
        del m
        none = (per_run(), bf16_part(per_run(), amp),
                wgmma_part(per_run(), amp))
        m = build_dygraph_bert(fluid, cpu, 0.0, amp)
        scales = (1.0, 1.0 + 2.0 ** -20) if amp else (1.0,)
        base = {p.name: p.value().clone() for p in m.parameters()}
        for scale in scales:
            m.load_pytree({n: v * scale for n, v in base.items()})
            t0 = time.perf_counter()
            runs[("cpu", amp, scale)] = _dygraph_eager(
                fluid, m, cpu, feed, "dygraph_check CPU", none)
            cpu_s["%s_%s" % ("amp" if amp else "f32", scale)] = \
                time.perf_counter() - t0
        del m, base
    launched = {k: 2 * n for k, n in DY_PER_STEP.items()}

    gpu, ref = runs[("gpu", False)], runs[("cpu", False, 1.0)]
    n_p = len(names)
    gnorm = [float(np.sqrt(sum(float(np.square(g.astype("f8")).sum())
                               for g in r[1:]))) for r in (gpu, ref)]
    errs = {"loss": abs(float(gpu[0]) - float(ref[0])) / abs(float(ref[0])),
            "grad_norm": abs(gnorm[0] - gnorm[1]) / gnorm[1]}
    l2 = {n: _rel_l2(g, c) for n, g, c in zip(names, gpu[1:], ref[1:])}
    worst = max(l2, key=l2.get)
    emit({"phase": "dygraph_check", "case": "f32", "batch": batch,
          "config": BERT, "dropout": 0.0, "loss_gpu": float(gpu[0]),
          "loss_cpu": float(ref[0]), "grad_norm_gpu": gnorm[0],
          "grad_norm_cpu": gnorm[1], "rel_errors": errs, "tol_rel": 1e-4,
          "grads_compared": n_p, "grad_rel_l2_max": l2[worst],
          "grad_rel_l2_param": worst, "tol_rel_l2": 1e-2,
          "launches_per_step": DY_PER_STEP, "cpu_step_s": cpu_s,
          "device": smi_line})
    check(np.isfinite([float(gpu[0]), gnorm[0]]).all(),
          "dygraph_check: non-finite loss or grads on the card")
    check(max(errs.values()) <= 1e-4, "dygraph_check errors %s" % errs)
    check(l2[worst] <= 1e-2, "dygraph_check: %s gradient off by %g (rel "
          "L2)" % (worst, l2[worst]))

    keys = ["loss"] + names
    amp_runs = [runs[("cpu", True, 1.0)], runs[("cpu", False, 1.0)],
                runs[("cpu", True, 1.0 + 2.0 ** -20)]]
    v = _amp_verdict(keys, runs[("gpu", True)], *amp_runs)
    control = _amp_verdict(keys, runs[("gpu", False)], *amp_runs)
    emit(dict({"phase": "dygraph_check", "case": "amp", "batch": batch,
               "precision": "bf16 (amp=True)",
               "loss_gpu": float(runs[("gpu", True)][0]),
               "loss_cpu_amp": float(amp_runs[0][0]),
               "loss_cpu_f32": float(amp_runs[1][0]),
               "grad_dtypes": sorted({str(g.dtype) for g in
                                      runs[("gpu", True)][1:]}),
               "device": smi_line}, **_amp_report(v, control)))
    check(np.isfinite(float(runs[("gpu", True)][0])),
          "dygraph_check: non-finite AMP loss on the card")
    _amp_checks("dygraph_check", v, control)
    del runs, amp_runs
    gc.collect()
    cap_launched, replayed = _dygraph_capture_case(torch, fluid, True, batch,
                                                   0.1)
    launched = {k: launched[k] + cap_launched[k] for k in launched}
    counts = read_counts()
    check(counts == launched, "dygraph_check launches %s != %s"
          % (counts, launched))
    return launched, replayed


def phase_dygraph_train(torch, smi_line, static=None, warmup=3, steps=10,
                        eager_steps=3, prof_steps=2):
    """The main path: BERT-base pretraining through the dygraph modules at
    BASELINE config 4's settings (``bench.py:1241-1258``: batch 128 x 128,
    ``amp=True``, Adam(1e-4), dropout 0.1, MLM on 15% and NSP), its
    ``make_train_step`` captured by ``dygraph.CapturedTrainStep`` (call 1
    eager, call 2 the capture, then replays, parameters and Adam state written
    in place) for ``warmup`` + ``steps`` steps, after ``eager_steps``
    timed eager calls of the same step function. Every eager or captured
    step launches DY_PER_STEP (12 + 12 flash, 1 CE), all bf16 and on the
    wgmma forms, a replay none from Python and, profiled, the first
    step's device kernels kind by kind. Prints tokens/s, ms a step, busy
    share, peak memory and kernels a step, beside the static
    ``bert_pretrain`` Adam arm's ``static`` (a reading, not a gate).
    Returns (launches, replayed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert_dygraph

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    model = build_dygraph_bert(fluid, fluid.CUDAPlace(0), 0.1, True)
    step, params, opt = bert_dygraph.make_train_step(model, DY_LR)
    gen = torch.Generator(dev).manual_seed(SEED)
    feed = dygraph_feed(BERT_PRETRAIN_BATCH)
    n_params = sum(int(t.numel()) for t in params.values())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = torch.cuda.memory_allocated()
    setup_s = time.perf_counter() - t0
    cs = fluid.dygraph.CapturedTrainStep(step, params, opt, gen)
    losses, runs = [], {"launched": 0, "replayed": 0}

    def counted(fn, label):
        before = read_counts(), read_bf16_counts(), read_wgmma_counts()
        replays = cs.runs["replays"]
        t = time.perf_counter()
        loss = fn()
        losses.append(float(loss))  # to the host: ends synchronised
        dt = time.perf_counter() - t
        after = read_counts(), read_bf16_counts(), read_wgmma_counts()
        rep = cs.runs["replays"] > replays
        want = per_run() if rep else DY_PER_STEP
        got = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        check(got == [want, bf16_part(want, True), wgmma_part(want, True)],
              "%s launches %s != %s" % (label, got, want))
        runs["replayed" if rep else "launched"] += 1
        return dt

    def eager_step():
        return counted(lambda: step(params, opt, gen, *feed)[0],
                       "dygraph eager step %d" % len(losses))

    def run_step():
        return counted(lambda: cs(*feed), "dygraph step %d" % len(losses))

    reset_counts()
    eager_s = [eager_step() for _ in range(eager_steps + 1)][1:]
    e_dev, e_kernels, _, _ = _profile_steps(torch, eager_step, 1)
    call1 = {}
    _profile_steps(torch, run_step, 1, counts=call1)
    step_s = []
    for i in range(warmup - 1 + steps):
        dt = run_step()
        if i >= warmup - 1:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels, prof_wall, top_other = _profile_steps(
        torch, run_step, prof_steps, counts=replay)
    report = cs.report()
    launches, bf16 = read_counts(), read_bf16_counts()
    wgmma = read_wgmma_counts()
    med, e_med = statistics.median(step_s), statistics.median(eager_s)
    busy, e_busy = sum(device_ms.values()), sum(e_dev.values())
    tokens = BERT_PRETRAIN_BATCH * BERT["seq"]
    out = {"phase": "dygraph_train",
           "model": "bert_dygraph (BertPretrain, dygraph modules)",
           "precision": "bf16 (amp=True)", "optimizer": "Adam(1e-4)",
           "config": dict(BERT, dropout_rate=0.1), "params": n_params,
           "batch": BERT_PRETRAIN_BATCH, "captured": report["captured"],
           "reason": report["reason"], "step_report": report,
           "warmup_steps": warmup, "steps": len(step_s),
           "step_ms_median": med * 1e3, "step_ms": [x * 1e3 for x in step_s],
           "tokens_per_s": tokens / med, "device_ms_per_step": device_ms,
           "device_ms": busy, "device_busy_share": busy / (med * 1e3),
           "kernels_per_step": kernels,
           "kernels_by_kind": {"call1": call1, "replay": replay},
           "profiled_wall_ms_per_step": prof_wall,
           "top_other_kernels": top_other,
           "eager": {"steps": len(eager_s), "step_ms_median": e_med * 1e3,
                     "step_ms": [x * 1e3 for x in eager_s],
                     "tokens_per_s": tokens / e_med, "device_ms": e_busy,
                     "device_busy_share": e_busy / (e_med * 1e3),
                     "kernels_per_step": e_kernels},
           "losses": losses, "state_bytes": state, "peak_memory_bytes": peak,
           "peak_above_state_bytes": peak - state,
           "graph_pool_bytes": report["pool_bytes"], "launches": launches,
           "bf16_launches": bf16, "wgmma_launches": wgmma,
           "launches_per_step": DY_PER_STEP, "steps_by_kind": runs,
           "setup_s": setup_s, "device": smi_line}
    if static is not None:  # the static Program's step on the same card
        out["static_bert_pretrain_adam"] = {
            k: static[k] for k in ("step_ms_median", "tokens_per_s",
                                   "device_busy_share", "peak_memory_bytes",
                                   "kernels_per_step")}
        out["dygraph_over_static_step_ms"] = \
            med * 1e3 / static["step_ms_median"]
    emit(out)
    cs.close()
    check(report["captured"] and report["replays"] >= steps,
          "dygraph_train not captured: %s" % report)
    check_replay_kernels("dygraph_train", call1, replay)
    check(np.isfinite(losses).all(), "non-finite loss: %s" % losses)
    check(losses[-1] < losses[0], "dygraph_train: loss did not fall: %s"
          % losses)
    check(launches == {k: n * runs["launched"]
                       for k, n in DY_PER_STEP.items()},
          "dygraph_train launches %s" % launches)
    return launches, {k: n * runs["replayed"] for k, n in DY_PER_STEP.items()}


# -- QAT (A9): ResNet-50 under the quantization transpiler -----------------

def build_qat_resnet(fluid):
    """ResNet-50 at config 2 (``RESNET``) under
    ``QuantizeTranspiler.training_transpile`` (8-bit channel-wise weights,
    moving-average activations) before ``Adam(1e-4).minimize``, the
    reference's order (``quantize_transpiler.py:11-13``). Returns (main,
    startup, spec, transpiler)."""
    from paddle_tpu_torch.contrib.quantize import QuantizeTranspiler

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = fluid.models.resnet.resnet_imagenet(**RESNET)
        qt = QuantizeTranspiler()
        qt.training_transpile(main, startup)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(spec.loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, spec, qt


def _qat_fusion(main, fetch_names):
    """The epilogue fusion's decisions on the QAT program: 53 sites, every
    fused conv reading its weight's fake-quant output, none refused (the
    reference's, held in ``tests/test_torch_quantize.py``)."""
    from paddle_tpu_torch.core.executor import fused_ops

    ops, report = fused_ops(main, fetch_names)
    sites = [o for o in ops if o.type == "fused_conv2d"]
    out = {"sites": len(report.fused), "refused": [str(r) for r in
                                                   report.refused],
           "quantized_filters": sum(o.input("Filter").name.endswith(
               ".quantized") for o in sites),
           "fake_quant_ops": sum(o.type.startswith("fake_") for o in ops)}
    check(len(sites) == out["quantized_filters"] == 53
          and not report.refused, "QAT fusion: %s" % out)
    return out, sites


def phase_qat_check(torch, smi_line, batch=2):
    """One QAT ResNet-50 step (``build_qat_resnet``) at batch 2 on the card
    and with the port on the CPU from the same weights and feed, plus the
    CPU step on the input scaled by 1 + 2^-20, by
    ``resnet_train_check``'s rule (each quantity within the larger of its
    tolerance and 5x that rounding sensitivity): the loss 1e-4 relative,
    every gradient 1e-2 relative L2, the 50 activation quant states (each
    a batch abs-max) 1e-4 relative L2 as one vector. That rule is printed
    and held, but it cannot fail a wrong gradient (a fake-quant's rounding
    flips make the step chaotic: see QAT_FORCED_TOL); the check that can
    is op by op: every forward op of the step and its VJP on the CPU
    chain's inputs, the card within QAT_FORCED_TOL of the CPU, and two
    planted faults on the card (an identity fake-quant, a zeroed
    straight-through gradient) caught at the fake-quant ops. The card
    step launches RESNET_PER_STEP (the fused convs at the 49 admitted
    sites, their Filter the fake-quant output); the fusion's decisions as
    ``_qat_fusion``. Returns (launches, replayed)."""
    import paddle_tpu_torch as fluid

    main, startup, spec, _ = build_qat_resnet(fluid)
    trainable = [p.name for p in main.all_parameters() if p.trainable]
    names = [p.name for p in main.all_parameters()]
    gb = main.global_block()
    fetch = [spec.loss] + [gb.var(n + "@GRAD") for n in trainable]
    feed = spec.sample_batch(batch, np.random.RandomState(SEED))
    gpu_scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    states = sorted(n for n in gpu_scope.var_names()
                    if n.endswith(".quant_state"))
    start_states = {n: gpu_scope.get(n).cpu().numpy() for n in states}
    reset_counts()
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = read_counts()
    check(counts == RESNET_PER_STEP, "qat_check launches %s != %s"
          % (counts, RESNET_PER_STEP))
    gpu_states = [gpu_scope.get(n).cpu().numpy() for n in states]
    fusion, _ = _qat_fusion(main, [spec.loss.name]
                            + [v.name for v in fetch[1:]])
    exe.close()
    cpu_runs, cpu_s = [], []
    for scale in (1.0, 1.0 + 2.0 ** -20):
        cpu_scope = fluid.Scope()
        cexe = fluid.Executor(fluid.CPUPlace())
        cexe.run(startup, scope=cpu_scope)
        fluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
        f = dict(feed, img=(feed["img"] * np.float32(scale)).astype("f4"))
        t0 = time.perf_counter()
        out = cexe.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
        cpu_s.append(time.perf_counter() - t0)
        cpu_runs.append((out, [cpu_scope.get(n).numpy() for n in states]))
    check(read_counts() == counts, "the CPU QAT steps launched a kernel")
    # op by op (see QAT_FORCED_TOL): the card, then the planted faults on
    # the card, against the CPU on the CPU chain's inputs
    t0 = time.perf_counter()
    ops, inputs = _forced_chain(torch, main, [spec.loss.name],
                                dict(params, **start_states), feed,
                                amp=False)
    dev, cpu_dev = fluid.CUDAPlace(0).torch_device(), torch.device("cpu")
    cts = {}
    want = _forced_run(torch, ops, inputs, cpu_dev, False, cts)
    got = _forced_run(torch, ops, inputs, dev, False, cts)
    flips = _forced_flips(got, want)
    if flips:  # the VJPs again, through the same ReLU masks
        want = _forced_run(torch, ops, inputs, cpu_dev, False, cts,
                           flips=flips)
        got = _forced_run(torch, ops, inputs, dev, False, cts, flips=flips)
    forced = {"card": _forced_f32_verdict(got, want, QAT_FORCED_TOL)}
    for name, fault in _qat_faults(torch).items():
        forced[name] = _forced_f32_verdict(
            _forced_run(torch, ops, inputs, dev, False, cts, fault, flips),
            want, QAT_FORCED_TOL)
    relu_flips = {"%d:%s" % k: int(f.sum()) for k, f in flips.items()}
    forced_s = time.perf_counter() - t0
    del want, got, inputs
    (cpu, cpu_states), (pert, pert_states) = cpu_runs
    n_t = len(trainable)
    loss = (abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0])),
            abs(float(pert[0]) - float(cpu[0])) / abs(float(cpu[0])))
    grads = {n: (_rel_l2(g, c), _rel_l2(p, c)) for n, g, c, p in zip(
        trainable, gpu[1:1 + n_t], cpu[1:1 + n_t], pert[1:1 + n_t])}
    # each state is one batch abs-max of a chaotic forward (a rounding
    # flip moves a value by a grid step): held as one vector
    cat = [np.array([float(np.asarray(x).reshape(-1)[0]) for x in xs])
           for xs in (gpu_states, cpu_states, pert_states)]
    qstates = {"quant_states": (_rel_l2(cat[0], cat[1]),
                                _rel_l2(cat[2], cat[1]))}
    bad = (_over_sensitivity({"loss": loss}, 1e-4)
           + _over_sensitivity(grads, 1e-2)
           + _over_sensitivity(qstates, 1e-4))
    worst = max(grads, key=lambda n: grads[n][0])
    emit({"phase": "qat_check", "batch": batch, "config": RESNET,
          "quantization": "8-bit channel-wise weights, moving-average "
                          "activations", "loss_gpu": float(gpu[0]),
          "loss_cpu": float(cpu[0]), "loss_rel_err": loss[0],
          "loss_rel_sensitivity": loss[1], "grads_compared": n_t,
          "grad_rel_l2_max": grads[worst][0], "grad_rel_l2_param": worst,
          "grad_rel_l2_median": float(np.median([e for e, _ in
                                                 grads.values()])),
          "grad_sensitivity_median": float(np.median([s for _, s in
                                                      grads.values()])),
          "quant_states": len(states),
          "quant_states_rel_l2": qstates["quant_states"][0],
          "quant_states_sensitivity": qstates["quant_states"][1],
          "quant_state_elem_err_max": max(
              _elem_err(g, c) for g, c in zip(gpu_states, cpu_states)),
          "fusion": fusion,
          "tol": "max(stated, 5 x sensitivity): loss 1e-4 rel, grads 1e-2 "
                 "rel L2, the quant states 1e-4 rel L2 as one vector",
          "over_tolerance": bad, "forced_ops": len(ops),
          "forced_s": forced_s, "forced_card": forced["card"],
          "forced_relu_flips": relu_flips,
          "forced_planted_faults": {k: dict(v, outside=len(v["outside"]))
                                    for k, v in forced.items()
                                    if k != "card"},
          "forced_tol": "every op's outputs and input gradients within %g "
                        "rel L2 of the CPU's; each planted fault must fail"
                        % QAT_FORCED_TOL,
          "launches": counts, "cpu_step_s": cpu_s, "device": smi_line})
    check(np.isfinite(float(gpu[0])), "qat_check: non-finite loss")
    check(not bad, "qat_check: over tolerance: %s" % bad)
    check(not forced["card"]["outside"], "qat_check: forced ops past %g: %s"
          % (QAT_FORCED_TOL, forced["card"]["outside"][:20]))
    for name, kind in (("identity_fake_quant", ":out:"),
                       ("zero_ste", ":grad:")):
        check(any(":fake_" in o and kind in o
                  for o in forced[name]["outside"]),
              "qat_check: the forced check passed the planted fault %s"
              % name)
    return counts, per_run()


def phase_qat_train(torch, smi_line, warmup=3, steps=10, prof_steps=2,
                    passes=3, small=8):
    """The main path: QAT ResNet-50 (``build_qat_resnet``) trained at batch
    128 (224 x 224 x 3, 1000 classes), captured from its second step on,
    ``warmup`` + ``steps`` steps on one fixed batch: each interpreted or
    captured step launches conv_moments and bn_apply 49 times (the fused
    convs, their Filter the weights' fake-quant outputs), a replay none
    from Python and, profiled, the first step's kernels by kind. Then the
    deployment: ``freeze_program`` on a pruned for_test clone (weights baked
    onto the int8 grid, the weight quant ops dropped, the activation ones
    frozen), ``passes`` eval passes of it at batch 128 (conv_apply 49 a
    pass, captured); the frozen model against the unfrozen clone (its
    activation quant ops frozen alike, the weights quantized in the step)
    on ``small`` images: the baked weights bitwise the clone's fake-quant
    outputs, the logits within twice the distance of two runs of the
    clone plus F32_ROUNDING (relative L2);
    ``export_int8`` / ``load_int8_params`` into a fresh scope: the weights
    bitwise the frozen ones, the logits bitwise the frozen model's.
    Returns (launches, replayed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib.quantize import load_int8_params

    t0 = time.perf_counter()
    main, startup, spec, qt = build_qat_resnet(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor()  # CUDAPlace(0)
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(RESNET_BATCH, np.random.RandomState(SEED))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, step_s, runs = [], [], {"launched": 0, "replayed": 0}

    def run_step():
        (loss,), dt, replayed = counted_step(
            exe, main, RESNET_PER_STEP, False, "qat step %d" % len(losses),
            feed=feed, fetch_list=[spec.loss], scope=scope)
        runs["replayed" if replayed else "launched"] += 1
        losses.append(float(loss))
        return dt

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    call1 = {}
    _profile_steps(torch, run_step, 1, counts=call1)
    for i in range(warmup - 1 + steps):
        dt = run_step()
        if i >= warmup - 1:
            step_s.append(dt)
    peak = torch.cuda.max_memory_allocated()
    replay = {}
    device_ms, kernels, prof_wall, top_other = _profile_steps(
        torch, run_step, prof_steps, counts=replay)
    report = exe.step_report(main)
    train_launches = read_counts()
    fusion, sites = _qat_fusion(main, [spec.loss.name])
    declined = [(tuple(o.input("Filter").shape), list(o.attr("strides")))
                for o in sites if not o.attrs["_kernel_choice"]["admitted"]]
    check(report["captured"] and report["replays"] >= steps,
          "qat_train not captured: %s" % report)
    check_replay_kernels("qat_train", call1, replay)
    check(declined == RESNET_DECLINED, "qat declined sites %s" % declined)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "qat_train: loss did not fall: %s" % losses)
    check(train_launches == {k: n * runs["launched"]
                             for k, n in RESNET_PER_STEP.items()},
          "qat_train launches %s" % train_launches)

    # deployment: the frozen clone, its int8 export, against the unfrozen
    logits_name = [op.input("X").name for op in main.global_block().ops
                   if op.type == "softmax"][0]
    unfrozen = main.clone(for_test=True)
    unfrozen = unfrozen.prune([unfrozen.global_block().var(logits_name)])
    for op in unfrozen.global_block().ops:
        if op.type == "fake_quantize_moving_average_abs_max":
            op.attrs["is_test"] = True
    small_feed = {"img": feed["img"][:small]}
    quantized = sorted(n + ".quantized" for n in qt._weight_quants)
    unfrozen_runs = [exe.run(unfrozen, feed=small_feed,
                             fetch_list=[logits_name] + quantized,
                             scope=scope) for _ in range(2)]
    want = unfrozen_runs[0][0]
    d_uu = _rel_l2(unfrozen_runs[1][0], want)
    frozen = main.clone(for_test=True)
    frozen = frozen.prune([frozen.global_block().var(logits_name)])
    qt.freeze_program(frozen, scope=scope)
    pass_s, eval_runs = [], {"launched": 0, "replayed": 0}
    eval_feed = {"img": feed["img"]}
    before = read_counts()

    def run_pass():
        _, dt, replayed = counted_step(
            exe, frozen, RESNET_PER_EVAL, False, "qat eval pass",
            feed=eval_feed, fetch_list=[logits_name], scope=scope)
        eval_runs["replayed" if replayed else "launched"] += 1
        pass_s.append(dt)

    for _ in range(passes + 2):
        run_pass()
    eval_launches = {k: v - before[k] for k, v in read_counts().items()}
    got = exe.run(frozen, feed=small_feed, fetch_list=[logits_name],
                  scope=scope)[0]
    # freeze is exact: the baked weights are the fake-quant outputs
    baked_bitwise = all(np.array_equal(
        scope.get(n[:-len(".quantized")]).cpu().numpy(), q)
        for n, q in zip(quantized, unfrozen_runs[0][1:]))
    d_fu = _rel_l2(got, want)
    tmp = tempfile.mkdtemp(prefix="qat_int8_")
    try:
        qt.export_int8(tmp, scope=scope)
        i8_scope = fluid.Scope()
        for p in frozen.all_parameters():
            if p.name in scope:
                i8_scope.set(p.name, scope.get(p.name).clone())
        for n in scope.var_names():
            if n.endswith(".quant_state"):
                i8_scope.set(n, scope.get(n).clone())
        for n in qt._weight_quants:
            i8_scope.set(n, torch.zeros_like(scope.get(n)))
        loaded = load_int8_params(tmp, i8_scope, require=True)
        int8_bytes = os.path.getsize(os.path.join(tmp, "params.int8.npz"))
    finally:
        shutil.rmtree(tmp)
    weights_equal = all(torch.equal(i8_scope.get(n), scope.get(n))
                        for n in loaded)
    via_int8 = exe.run(frozen, feed=small_feed, fetch_list=[logits_name],
                       scope=i8_scope)[0]
    int8_err = _elem_err(via_int8, got)
    eval_report = exe.step_report(frozen)
    exe.close()
    err = _elem_err(got, want)
    med = statistics.median(step_s)
    busy = sum(device_ms.values())
    emit({"phase": "qat_train", "model": "resnet50 (QAT)",
          "config": RESNET, "batch": RESNET_BATCH, "dtype": "float32",
          "quantization": "8-bit channel-wise weights, moving-average "
                          "activations (QuantizeTranspiler)",
          "optimizer": "Adam(1e-4)", "captured": report["captured"],
          "reason": report["reason"], "step_report": report,
          "warmup_steps": warmup, "steps": steps,
          "step_ms_median": med * 1e3, "step_ms": [x * 1e3 for x in step_s],
          "images_per_s": RESNET_BATCH / med, "losses": losses,
          "peak_memory_bytes": peak, "device_ms_per_step": device_ms,
          "device_ms": busy, "device_busy_share": busy / (med * 1e3),
          "kernels_per_step": kernels,
          "kernels_by_kind": {"call1": call1, "replay": replay},
          "profiled_wall_ms_per_step": prof_wall,
          "top_other_kernels": top_other, "fusion": dict(
              fusion, kernel_sites=len(sites) - len(declined),
              declined=declined), "launches": train_launches,
          "launches_per_step": RESNET_PER_STEP, "steps_by_kind": runs,
          "frozen_eval": {
              "passes_by_kind": eval_runs, "step_report": eval_report,
              "pass_ms_median": statistics.median(pass_s[2:]) * 1e3,
              "images_per_s": RESNET_BATCH / statistics.median(pass_s[2:]),
              "launches": eval_launches, "small_batch": small,
              "frozen_vs_unfrozen_max_err": err,
              "frozen_vs_unfrozen_rel_l2": d_fu,
              "unfrozen_vs_unfrozen_rel_l2": d_uu,
              "baked_weights_bitwise": baked_bitwise,
              "argmax_agree": float(np.mean(np.argmax(got, -1)
                                            == np.argmax(want, -1))),
              "int8_weights_loaded": len(loaded),
              "int8_weights_bitwise": weights_equal,
              "int8_logits_max_err": int8_err,
              "int8_file_bytes": int8_bytes},
          "setup_s": setup_s, "device": smi_line})
    check(eval_report["captured"], "frozen eval not captured: %s"
          % eval_report)
    check(eval_launches == {k: n * eval_runs["launched"]
                            for k, n in RESNET_PER_EVAL.items()},
          "qat eval launches %s" % eval_launches)
    check(baked_bitwise, "the frozen weights differ from the fake-quant "
          "outputs of the unfrozen clone")
    check(d_fu <= 2 * d_uu + F32_ROUNDING,
          "frozen vs unfrozen logits %g (rel L2), unfrozen vs unfrozen %g"
          % (d_fu, d_uu))
    # the weights bitwise; the logits within f32 noise (the four declined
    # sites run cuDNN, whose default algorithms are not reproducible)
    check(len(loaded) == len(qt._weight_quants) and weights_equal
          and int8_err <= 1e-5,
          "the int8 export did not round-trip the frozen model (%g)"
          % int8_err)
    launched = {k: train_launches[k] + eval_launches[k] for k in KERNELS}
    replayed = {k: RESNET_PER_STEP[k] * runs["replayed"]
                + RESNET_PER_EVAL[k] * eval_runs["replayed"]
                for k in KERNELS}
    return launched, replayed


def main():
    import faulthandler

    # a crash in native code prints the Python stack of every thread
    faulthandler.enable()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    seconds = {}
    time_phases(globals(), seconds)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "precision",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    dev = torch.device("cuda", 0)

    smi_line = phase_device(torch)
    phase_build()
    # each kernel's error against its plain version at the path's shape,
    # f32 and (rows 1-9) bf16
    rows = TRAIN_BATCH * TRANSFORMER["seq_len"]
    ce_case = "train_%dx%dx%d" % (rows, TRANSFORMER["d_model"],
                                  TRANSFORMER["trg_vocab"])
    checked = {"flash_attention_fwd": phase_flash_check(torch, dev),
               "layer_norm_fwd": phase_ln_check(torch, dev),
               "flash_attention_bwd": phase_flash_bwd_check(torch, dev),
               "layer_norm_bwd": phase_ln_bwd_check(torch, dev),
               "fused_ce_fwd": phase_ce_check(torch, dev)}
    errs, bf16_errs = {}, {}
    for name, f32_case, bf16_case in (
            ("flash_attention_fwd", "bert_f32", "train_bf16_dropout_0.1"),
            ("layer_norm_fwd", "1024x768_float32", "%dx512_bfloat16" % rows),
            ("flash_attention_bwd", "enc_self_bias_grad",
             "enc_self_bf16_dropout_0.1"),
            ("layer_norm_bwd", "train_%dx512" % rows,
             "train_%dx512_bf16" % rows),
            ("fused_ce_fwd", ce_case, ce_case + "_bf16")):
        errs[name] = checked[name][f32_case]
        bf16_errs[name] = checked[name][bf16_case]
    conv_errs, conv_bf16_errs = phase_fused_conv_check(torch, dev)
    errs.update(conv_errs)
    bf16_errs.update(conv_bf16_errs)
    errs["scatter_add"] = phase_scatter_check(
        torch, dev)["deepfm_densify_uniform"]
    times = phase_timing(torch, dev)
    # each path's launches from Python (interpreted and captured steps),
    # and the launches its graph replays repeated, by kernel
    paths, replayed = {}, {}
    phase_capture_check(torch)
    paths["serve"], replayed["serve"], bert = phase_serve(torch, smi_line)
    phase_train_check(torch, smi_line)
    paths["train"], replayed["train"] = phase_train(torch, smi_line, {
        "flash_attention_fwd": times["flash_attention_fwd"][
            "trained_shape"]["ms"],
        "flash_attention_bwd": times["flash_attention_bwd"]["ms"]})
    phase_amp_train_check(torch, smi_line)
    paths["amp_train"], replayed["amp_train"] = phase_train(
        torch, smi_line, {name: times[name]["bf16"]["ms"]
                          for name in ("flash_attention_fwd",
                                       "flash_attention_bwd")},
        amp=True, interp_steps=5)
    # read at once: the path's wgmma launches (no launch comes between);
    # conv_moments' come from resnet_amp_train, conv_apply's from
    # resnet_amp_eval
    amp_wgmma = read_wgmma_counts()
    phase_resnet_train_check(torch, smi_line)
    (paths["resnet_train"], replayed["resnet_train"]), trained, f32_step = \
        phase_resnet_train(torch, smi_line,
                           times["conv_moments"]["site_weighted_ms"])
    paths["resnet_eval"], _, n = phase_resnet_eval(torch, smi_line, trained)
    replayed["resnet_eval"] = {k: v * n for k, v in RESNET_PER_EVAL.items()}
    del trained
    phase_resnet_amp_train_check(torch, smi_line)
    (paths["resnet_amp_train"], replayed["resnet_amp_train"]), trained, _ = \
        phase_resnet_train(
            torch, smi_line,
            times["conv_moments"]["bf16"]["site_weighted_ms"], amp=True,
            f32_step=f32_step, interp_steps=5)
    amp_wgmma["conv_moments"] = read_wgmma_counts()["conv_moments"]
    paths["resnet_amp_eval"], eval_wgmma, n = phase_resnet_eval(
        torch, smi_line, trained, amp=True)
    replayed["resnet_amp_eval"] = {k: v * n
                                   for k, v in RESNET_PER_EVAL.items()}
    amp_wgmma["conv_apply"] = eval_wgmma["conv_apply"]
    del trained
    phase_deepfm_train_check(torch, smi_line)
    paths["deepfm_train"], replayed["deepfm_train"] = phase_deepfm_train(
        torch, smi_line, interp_steps=5)
    phase_deepfm_amp_train_check(torch, smi_line)
    paths["deepfm_amp_train"], replayed["deepfm_amp_train"] = \
        phase_deepfm_train(torch, smi_line, amp=True)
    phase_bert_pretrain_check(torch, smi_line)
    paths["bert_pretrain"], replayed["bert_pretrain"], bert_adam = \
        phase_bert_pretrain(torch, smi_line)
    bert_times = phase_bert_kernel_timing(torch, dev)
    opt_scatter = phase_optimizer_check(torch, smi_line)
    fam = phase_decode_check(torch, smi_line)
    paths["decode"], replayed["decode"], step_dir = phase_decode(
        torch, smi_line, fam, keep_dir=True)
    del fam
    # the front door: a router over two worker processes on the card, on
    # the directories serve and decode saved
    fleet = {"trace_dir": tempfile.mkdtemp(prefix="router_trace_"),
             "flight_dir": tempfile.mkdtemp(prefix="router_flight_")}
    try:
        paths["router_serve"], replayed["router_serve"] = \
            phase_router_serve(torch, smi_line, bert, fleet)
        paths["router_chaos"], replayed["router_chaos"] = \
            phase_router_chaos(torch, smi_line, fleet)
        paths["router_decode"], replayed["router_decode"] = \
            phase_router_decode(torch, smi_line, step_dir)
    finally:  # no worker process outlives the script
        if "router" in fleet:
            fleet["router"].shutdown()
    for d in (bert["model_dir"], step_dir, fleet["trace_dir"],
              fleet["flight_dir"]):
        shutil.rmtree(d)
    phase_mt_train_check(torch, smi_line)
    paths["mt_train"], replayed["mt_train"], mt, mt_scope = phase_mt_train(
        torch, smi_line)
    paths["mt_decode"], replayed["mt_decode"] = phase_mt_decode(
        torch, smi_line, mt, mt_scope)
    paths["mt_serve"], replayed["mt_serve"] = phase_mt_serve(
        torch, smi_line, mt, mt_scope)
    del mt, mt_scope
    mt_times = mt_flash_timing(torch, dev)
    phase_lstm_train_check(torch, smi_line)
    paths["lstm_train"], replayed["lstm_train"] = phase_lstm_train(
        torch, smi_line)
    phase_srl_check(torch, smi_line)
    paths["srl_train"], replayed["srl_train"] = phase_srl_train(
        torch, smi_line)
    paths["rnn_zoo"], replayed["rnn_zoo"] = \
        phase_rnn_zoo_check(torch, smi_line), per_run()
    srl_scatter, _ = phase_narrow_scatter_check(torch, dev)
    # detection: no port kernel on these paths (their counts stay 0)
    paths["detection_ops"], replayed["detection_ops"] = \
        phase_detection_ops_check(torch, smi_line), per_run()
    phase_ssd_train_check(torch, smi_line)
    paths["ssd_train"], replayed["ssd_train"], ssd = phase_ssd_train(
        torch, smi_line)
    paths["ssd_eval"], replayed["ssd_eval"] = \
        phase_ssd_eval(torch, smi_line, ssd), per_run()
    del ssd
    # the rest of A4: misc_ops' and nn_ops' last ops (no port kernel), the
    # scaled_dot_product_attention layer (the flash kernels, once each),
    # Print and py_func (interpreted), DCGAN trained (no port kernel)
    paths["misc_nn_ops"], replayed["misc_nn_ops"] = \
        phase_misc_nn_ops_check(torch, smi_line), per_run()
    paths["sdpa"], replayed["sdpa"] = phase_sdpa_check(torch, smi_line), \
        per_run()
    paths["debug_ops"], replayed["debug_ops"] = \
        phase_debug_ops_check(torch, smi_line), per_run()
    phase_dcgan_train_check(torch, smi_line)
    paths["dcgan_train"], replayed["dcgan_train"] = phase_dcgan_train(
        torch, smi_line)
    # the streaming loop (A6): a tail-followed stream, versioned
    # checkpoints, the hot swap into an engine and a two-worker fleet
    paths["stream_check"], replayed["stream_check"] = phase_stream_check(
        torch, smi_line)
    stream = {}
    try:
        paths["stream_train"], replayed["stream_train"] = \
            phase_stream_train(torch, smi_line, stream)
        paths["stream_fleet"], replayed["stream_fleet"] = \
            phase_stream_fleet(torch, smi_line, stream)
    finally:  # no process, thread or directory outlives the phases
        close_stream(stream)
    # dygraph (A8): BERT-base through the imperative modules, its captured
    # step; QAT (A9): ResNet-50 under the quantization transpiler
    paths["dygraph_check"], replayed["dygraph_check"] = phase_dygraph_check(
        torch, smi_line)
    paths["dygraph_train"], replayed["dygraph_train"] = phase_dygraph_train(
        torch, smi_line, bert_adam)
    paths["qat_check"], replayed["qat_check"] = phase_qat_check(
        torch, smi_line)
    paths["qat_train"], replayed["qat_train"] = phase_qat_train(
        torch, smi_line)

    src = {"flash_attention_fwd": ("flash_attention_fwd.cu",
                                   "paddle_tpu/ops/flash_attention.py:1001"),
           "flash_attention_bwd": ("flash_attention_bwd.cu",
                                   "paddle_tpu/ops/flash_attention.py:1058"),
           "layer_norm_fwd": ("layer_norm_fwd.cu",
                              "paddle_tpu/ops/fused_layer_norm.py:42"),
           "layer_norm_bwd": ("layer_norm_bwd.cu",
                              "paddle_tpu/ops/fused_layer_norm.py:57"),
           "fused_ce_fwd": ("fused_ce_fwd.cu",
                            "paddle_tpu/ops/fused_ce.py:57"),
           "conv_moments": ("fused_conv.cu",
                            "paddle_tpu/ops/fused_conv.py:159"),
           "bn_apply": ("fused_conv.cu", "paddle_tpu/ops/fused_conv.py:187"),
           "conv_apply": ("fused_conv.cu",
                          "paddle_tpu/ops/fused_conv.py:198"),
           "scatter_add": ("scatter_add.cu",
                           "paddle_tpu/ops/scatter.py:163")}
    kernels = []
    for name in KERNELS:
        source, replaces = src[name]
        r = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        replay_by_path = {path: counts.get(name, 0)
                          for path, counts in replayed.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/csrc/" + source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "graph_replayed_launches": sum(
                            replay_by_path.values()),
                        "graph_replayed_launches_by_path": replay_by_path,
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library": r.get("library")})
        for key in ("bound_ms_f32_fma", "trained_shape", "plan", "zipf_ms",
                    "zipf_bound_ms"):
            if key in r:
                kernels[-1][key] = r[key]
        if name in bert_times:  # the bf16 form at BERT pretraining's shape
            kernels[-1]["bert_pretrain_shape"] = bert_times[name]
        if name in mt_times:  # f32, one head of 512: the NMT model's
            kernels[-1]["mt_shape"] = mt_times[name]
        if name == "scatter_add":  # the densify of the new optimizers
            kernels[-1]["optimizer_check_shape"] = opt_scatter
            # the narrow dense lookups' backward at SRL's three tables
            kernels[-1]["srl_shapes"] = srl_scatter
        if "bf16" in r:  # rows 1-12: the bf16 form (AMP), training shape
            bf16_by_path = {path: paths[path][name] for path in AMP_PATHS}
            kernels[-1]["bf16"] = dict(r["bf16"],
                                       max_abs_err=bf16_errs[name],
                                       launches=sum(bf16_by_path.values()),
                                       launches_by_path=bf16_by_path)
            if name in WGMMA_FORMS:  # the warpgroup-product form
                kernels[-1]["bf16"].update(
                    form="wgmma", wgmma_launches=amp_wgmma[name],
                    header="paddle_tpu_torch/csrc/wgmma_bf16.cuh")
                if name in ("conv_moments", "conv_apply"):
                    kernels[-1]["bf16"]["wgmma_source"] = \
                        "paddle_tpu_torch/csrc/fused_conv_wgmma.cu"
    emit({"phase": "phase_seconds",
          "total": time.perf_counter() - t_start,
          "seconds_calls": seconds})
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
