"""Rematerialization in the port (``append_backward(checkpoints=...)``,
``memory_optimize``): the forward runs in checkpointed segments and the
backward recomputes their activations.

Against ``paddle_tpu`` (whose ``remat`` wraps the whole forward replay in
``jax.checkpoint``; on the CPU its gates take the kernels' XLA
references): a tiny BERT
pretraining step under ``memory_optimize``, dropout 0, gives the same
loss and gradients within the Transformer parity test's atol 2e-5 / rtol
1e-4. Within the port, at dropout 0.1 (the dropout ops' masks and the
flash kernel's hash seed drawn from the scope's generator), the step with
remat gives bitwise the loss and gradients of the step without, from one
seed, for the automatic segments, for named checkpoints and under AMP:
the recompute replays the forward's draws (``op_registry.RngTape``); a
recompute that drew again would fail this. The backward recomputes each
segment whole: the LayerNorm op runs once more for every one inside a
segment."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import op_registry as t_registry
from test_torch_optimizers import (fresh_port_programs,  # noqa: F401
                                   load_port_startup)
from test_torch_training import TOL

TINY = dict(vocab_size=97, seq_len=16, d_model=32, d_ff=64, n_head=2,
            n_layer=2)


def _batch(spec):
    batch = spec.sample_batch(3, np.random.RandomState(5))
    batch["input_len"] = np.array([16, 11, 4], "int64")
    return batch


def test_remat_grads_match_reference():
    tspec = tfluid.models.bert.bert_base(dropout_rate=0.0, **TINY)
    tpg = tfluid.backward.append_backward(tspec.loss)
    main = tfluid.memory_optimize()
    jspec = jmodels.bert.bert_base(dropout_rate=0.0, **TINY)
    jpg = fluid.backward.append_backward(jspec.loss)
    fluid.memory_optimize(fluid.default_main_program())
    texe = tfluid.Executor(tfluid.CPUPlace())
    load_port_startup(texe)

    exe = fluid.Executor(fluid.CPUPlace())
    names = [p.name for p, _ in jpg]
    want = exe.run(feed=_batch(jspec),
                   fetch_list=[jspec.loss] + [g for _, g in jpg])

    got = texe.run(feed=_batch(tspec),
                   fetch_list=[tspec.loss] + [g for _, g in tpg])
    assert len(texe._last[id(main)].remat) > 1
    for name, w, o in zip(["loss"] + names, want, got):
        np.testing.assert_allclose(o, w, err_msg=name, **TOL)


def _port_step(remat, amp=False):
    """One Adam step of tiny BERT at dropout 0.1 in fresh programs, seed
    3: (loss and grads, LayerNorm runs, segments)."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        spec = tfluid.models.bert.bert_base(dropout_rate=0.1, **TINY)
        ckpts = None
        if remat == "checkpoints":
            lns = [op.output("Y") for op in main.global_block().ops
                   if op.type == "layer_norm"]
            ckpts = lns[1::2]
        pg = tfluid.backward.append_backward(spec.loss, checkpoints=ckpts)
        tfluid.optimizer.Adam(1e-3).apply_gradients(pg)
    if remat == "auto":
        tfluid.memory_optimize(main)
    if amp:
        tfluid.amp.enable_bf16(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    runs = []
    impl = t_registry.OP_IMPLS["layer_norm"]

    def counted(env, op):
        runs.append(op)
        return impl(env, op)

    t_registry.OP_IMPLS["layer_norm"] = counted
    try:
        out = exe.run(main, feed=_batch(spec), scope=scope,
                      fetch_list=[spec.loss] + [g for _, g in pg])
    finally:
        t_registry.OP_IMPLS["layer_norm"] = impl
    entry = exe._last[id(main)]
    ops = entry.ops_plan()[0]
    in_segments = sum(ops[i].type == "layer_norm"
                      for start, (end, _) in entry.remat.items()
                      for i in range(start, end))
    return out, len(runs), entry.remat, in_segments


@pytest.mark.parametrize("remat,amp", [("auto", False),
                                       ("checkpoints", False),
                                       ("auto", True)],
                         ids=["memory_optimize", "checkpoints", "amp"])
def test_remat_grads_equal_plain_with_dropout(remat, amp):
    plain, plain_runs, none, _ = _port_step(None, amp)
    got, runs, segments, recomputed = _port_step(remat, amp)
    assert none == {} and len(segments) > 1
    # each segment's ops run again, whole, in the backward
    assert plain_runs == 2 * TINY["n_layer"] + 2
    assert runs == plain_runs + recomputed and recomputed > 0
    for i, (g, w) in enumerate(zip(got, plain)):
        np.testing.assert_array_equal(g, w, err_msg="fetch %d" % i)


def test_segments_end_at_checkpoints():
    """Each named checkpoint ends a segment; the fused CE runs outside any;
    a segment keeps only what a later op reads."""
    spec = tfluid.models.bert.bert_base(dropout_rate=0.1, **TINY)
    ops = tfluid.default_main_program().global_block().ops
    lns = [i for i, op in enumerate(ops) if op.type == "layer_norm"]
    ckpt = ops[lns[2]].output("Y")
    tfluid.backward.append_backward(spec.loss, checkpoints=[ckpt])
    ops = tfluid.default_main_program().global_block().ops
    ce = [i for i, op in enumerate(ops)
          if op.type == "fused_linear_smooth_ce"][0]
    segs = t_executor.remat_segments(ops, [spec.loss.name])
    # the fused CE runs outside: its recompute would save nothing
    assert sorted((s, e) for s, (e, _) in segs.items()) == [
        (0, lns[2] + 1), (lns[2] + 1, ce), (ce + 1, len(ops) - 1)]
    assert ckpt.name in segs[0][1]
    assert segs[ce + 1][1] == [spec.loss.name]
