"""BERT-base pretraining (``models.bert.bert_base``: the masked-LM head
over the fused projection + CE, weighted by ``mlm_weights``, and the
next-sentence head on [CLS]) in the port against ``paddle_tpu``, at 2
layers, width 32, 2 heads, vocabulary 97, sequence 16, dropout 0.

Both packages build the same program, var for var and name for name, with
the same FLOP and token counts. From the same initial state (the port's
startup run, loaded into both scopes; the reference's flash, LayerNorm
and fused-CE Pallas kernels in interpret mode) the
loss, every gradient and the parameters after one Adam step agree within
the Transformer parity test's bounds (``test_torch_training.py``: atol
2e-5 / rtol 1e-4 for the loss and grads, 1e-4 / 1e-4 for the
parameters). The port's flash, LayerNorm and CE ops record their path in
``_kernel_choice`` (the plain versions, on the CPU)."""

import numpy as np

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from test_torch_optimizers import (fresh_port_programs,  # noqa: F401
                                   load_port_startup)
from test_torch_training import (TOL, _grad_vars, _signature, jax_params,
                                 pallas_interpret)  # noqa: F401

TINY = dict(vocab_size=97, seq_len=16, d_model=32, d_ff=64, n_head=2,
            n_layer=2, dropout_rate=0.0)


def _batch(spec):
    batch = spec.sample_batch(3, np.random.RandomState(5))
    batch["input_len"] = np.array([16, 11, 4], "int64")  # padded keys
    batch["mlm_weights"] = (batch["mlm_weights"] > 0.6).astype("float32")
    return batch


def test_bert_pretrain_programs_identical():
    jspec = jmodels.bert.bert_base(**TINY)
    fluid.optimizer.Adam(1e-3).minimize(jspec.loss)
    tspec = tfluid.models.bert.bert_base(**TINY)
    tfluid.optimizer.Adam(1e-3).minimize(tspec.loss)
    assert tspec.loss.name == jspec.loss.name
    for get in ("default_main_program", "default_startup_program"):
        assert _signature(getattr(tfluid, get)()) == \
            _signature(getattr(fluid, get)())
    assert tspec.flops_per_example == jspec.flops_per_example
    assert tspec.tokens_per_example == jspec.tokens_per_example
    assert tspec.sequence_feeds == jspec.sequence_feeds
    ops = [op.type for op in tfluid.default_main_program().global_block().ops]
    assert ops.count("flash_attention") == TINY["n_layer"]
    assert ops.count("layer_norm") == 2 * TINY["n_layer"] + 2
    assert ops.count("fused_linear_smooth_ce") == 1


def test_bert_pretrain_grads_and_adam_step_match_jax(pallas_interpret):
    tspec = tfluid.models.bert.bert_base(**TINY)
    tfluid.optimizer.Adam(3e-3).minimize(tspec.loss)
    main = tfluid.default_main_program()
    jspec = jmodels.bert.bert_base(**TINY)
    fluid.optimizer.Adam(3e-3).minimize(jspec.loss)
    texe = tfluid.Executor(tfluid.CPUPlace())
    load_port_startup(texe)

    exe = fluid.Executor(fluid.CPUPlace())
    jprog = fluid.default_main_program()
    names = sorted(jax_params(jprog))
    batch = _batch(jspec)
    want = exe.run(feed=batch,
                   fetch_list=[jspec.loss] + _grad_vars(fluid, names))
    want_params = jax_params(jprog)

    got = texe.run(feed=batch,
                   fetch_list=[tspec.loss] + _grad_vars(tfluid, names))
    assert np.isfinite(got[0]) and float(got[0]) > 0
    for name, w, o in zip(["loss"] + names, want, got):
        assert np.abs(w).max() > 0 or name.startswith("pos_emb"), name
        np.testing.assert_allclose(o, w, err_msg=name, **TOL)
    scope = tfluid.global_scope()
    for n in names:
        np.testing.assert_allclose(scope.numpy(n), want_params[n],
                                   err_msg=n, atol=1e-4, rtol=1e-4)
    choices = {}
    for op in main.global_block().ops:
        if op.type in ("flash_attention", "layer_norm",
                       "fused_linear_smooth_ce"):
            choices.setdefault(op.type, []).append(
                op.attr("_kernel_choice")["kernel"])
    assert choices == {"flash_attention": ["plain"] * TINY["n_layer"],
                       "layer_norm": ["plain"] * (2 * TINY["n_layer"] + 2),
                       "fused_linear_smooth_ce": ["plain"]}


def test_amp_run_reduces_bf16_products_in_f32(monkeypatch):
    """An AMP run turns off cuBLAS's bf16 split-K reduction while its
    products run (PyTorch's default lets it sum partials in bf16, rounding
    a product twice; the reference's dots round once) and gives the
    process its setting back afterwards: every product of a tiny AMP BERT
    step sees the flag off, the f32 startup run and the code after the
    step see it on."""
    import torch
    from paddle_tpu_torch.core import op_registry

    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    seen = []
    for kind in ("mul", "matmul"):
        impl = op_registry.OP_IMPLS[kind]

        def spy(env, op, impl=impl):
            seen.append((op_registry.amp_enabled(),
                         matmul.allow_bf16_reduced_precision_reduction))
            impl(env, op)

        monkeypatch.setitem(op_registry.OP_IMPLS, kind, spy)
    spec = tfluid.models.bert.bert_base(**TINY)
    tfluid.amp.decorate(tfluid.optimizer.Adam(1e-3)).minimize(spec.loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    assert matmul.allow_bf16_reduced_precision_reduction
    exe.run(feed=_batch(spec), fetch_list=[spec.loss])
    assert seen and set(seen) == {(True, False)}
    assert matmul.allow_bf16_reduced_precision_reduction
