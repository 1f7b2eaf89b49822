"""The port's serving slice against ``paddle_tpu`` on the CPU: a tiny BERT
classifier (2 layers, d_model 32, 4 heads, seq 16, vocab 100) is built in
both packages, initialised by the JAX package, carried across as numpy
(``bridge.load_reference_params``), and served by both."""

import os

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models.bert import bert_encoder as jax_bert_encoder
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name

SEQ, VOCAB, D_MODEL, D_FF, HEADS, LAYERS = 16, 100, 32, 64, 4, 2
FEEDS = ["input_ids", "segment_ids", "input_len"]


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name generator for the port
    (the conftest fixture resets only paddle_tpu's)."""
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


def build_classifier(pkg, encoder):
    """BERT encoder + [CLS] classifier head, as user code builds it."""
    L = pkg.layers
    input_ids = L.data("input_ids", shape=[SEQ], dtype="int64")
    segment_ids = L.data("segment_ids", shape=[SEQ], dtype="int64")
    input_len = L.data("input_len", shape=[], dtype="int64")
    x = encoder(input_ids, segment_ids, input_len, SEQ, VOCAB, D_MODEL, D_FF,
                HEADS, LAYERS, dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    pooled = L.fc(cls, size=D_MODEL, act="tanh", name="pooler")
    return L.softmax(L.fc(pooled, size=2, name="cls_out"))


def make_feed(rng, n):
    return {"input_ids": rng.randint(0, VOCAB, (n, SEQ)).astype("int64"),
            "segment_ids": rng.randint(0, 2, (n, SEQ)).astype("int64"),
            "input_len": rng.randint(1, SEQ + 1, (n,)).astype("int64")}


def _program_signature(prog):
    gb = prog.global_block()
    ops = [(op.type, sorted((s, tuple(v.name for v in vs))
                            for s, vs in op.inputs.items()),
            sorted((s, tuple(v.name for v in vs))
                   for s, vs in op.outputs.items()))
           for op in gb.ops]
    var_table = sorted((v.name, v.shape, str(v.dtype), v.persistable)
                       for v in gb.vars.values())
    params = sorted(p.name for p in prog.all_parameters())
    return ops, var_table, params


def test_tiny_bert_programs_identical():
    jax_prob = build_classifier(fluid, jax_bert_encoder)
    t_prob = build_classifier(tfluid, tfluid.models.bert.bert_encoder)
    assert jax_prob.name == t_prob.name
    for get in (fluid.default_main_program, fluid.default_startup_program):
        jsig = _program_signature(get())
        tsig = _program_signature(getattr(tfluid, get.__name__)())
        assert jsig == tsig
    ops = {op.type for op in tfluid.default_main_program().global_block().ops}
    assert {"flash_attention", "layer_norm"} <= ops


def _export_both(tmp_path):
    """JAX initialises and saves; the port loads the JAX params.npz into
    its own identical program and saves its own model dir from them."""
    jax_prob = build_classifier(fluid, jax_bert_encoder)
    fluid.default_startup_program().random_seed = 11
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    jax_dir = str(tmp_path / "jax_model")
    fluid.io.save_inference_model(jax_dir, FEEDS, [jax_prob], exe)

    t_prob = build_classifier(tfluid, tfluid.models.bert.bert_encoder)
    scope = tfluid.Scope()
    names = tfluid.bridge.load_reference_params(
        jax_dir, scope, "cpu", program=tfluid.default_main_program())
    assert {p.name for p in tfluid.default_main_program().all_parameters()
            } == set(names)
    t_dir = str(tmp_path / "port_model")
    texe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(t_dir, FEEDS, [t_prob], texe)
    return jax_dir, t_dir


def _cpu_predictor(model_dir):
    config = tfluid.inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    return tfluid.inference.Predictor(config)


def test_port_predictor_matches_jax_predictor(tmp_path, rng):
    jax_dir, t_dir = _export_both(tmp_path)
    jax_pred = fluid.inference.Predictor(jax_dir)
    t_pred = _cpu_predictor(t_dir)
    assert t_pred.feed_names == jax_pred.feed_names == FEEDS
    feed = make_feed(rng, 5)
    feed["input_len"][:2] = [1, SEQ]  # shortest and full-length rows
    want, = jax_pred.run(feed)
    got, = t_pred.run(feed)
    assert got.shape == want.shape == (5, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    # both saved the same parameter layout
    with np.load(os.path.join(jax_dir, "params.npz")) as a, \
            np.load(os.path.join(t_dir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for n in a.files:
            np.testing.assert_array_equal(a[n], b[n])


def test_serving_engine_cpu_answers_concurrent_requests_as_solo_runs(
        tmp_path, rng):
    """Each request served inside a padded batch of 2, 4 or 8 rows equals
    the same request run alone within f32 rounding (rtol 1e-6, atol 1e-7):
    CPU BLAS blocks a product differently at different row counts, so
    bitwise equality depends on the machine; ``paddle_tpu``'s own serving
    test compares within a tolerance too."""
    _, t_dir = _export_both(tmp_path)
    solo = _cpu_predictor(t_dir)
    feeds = [make_feed(rng, int(rng.randint(1, 4))) for _ in range(16)]
    engine = tfluid.serving.ServingEngine(t_dir, max_batch_size=8,
                                          max_wait_ms=20.0, device="cpu")
    try:
        assert engine.warmup() == 4  # rungs 1, 2, 4, 8
        futures = [engine.submit(f) for f in feeds]
        got = [f.result(timeout=60)[0] for f in futures]
        snap = engine.metrics()
    finally:
        engine.shutdown()
    for feed, out in zip(feeds, got):
        np.testing.assert_allclose(out, solo.run(feed)[0], rtol=1e-6,
                                   atol=1e-7)
    assert snap["requests_completed"] == 16
    assert snap["requests_failed"] == 0
    assert snap["batches"] < 16  # requests were coalesced


def test_id_ops_accept_int32_and_int64(rng):
    """Feeds arrive as int32 (the 32-bit convention); ids made in-process
    may be int64: lookup_table and sequence_mask take both alike."""
    import torch

    from paddle_tpu_torch.core.op_registry import DEVICE_KEY, run_op

    ids = tfluid.layers.data("ids", shape=[SEQ], dtype="int64")
    lens = tfluid.layers.data("lens", shape=[], dtype="int64")
    emb = tfluid.layers.embedding(ids, size=[VOCAB, 8])
    mask = tfluid.layers.sequence_mask(lens, maxlen=SEQ, dtype="float32")
    table = torch.from_numpy(rng.normal(size=(VOCAB, 8)).astype("f4"))
    ids_np = rng.randint(0, VOCAB, (3, SEQ))
    lens_np = rng.randint(1, SEQ + 1, (3,))
    outs = []
    for dtype in (torch.int32, torch.int64):
        env = {emb.op.input("W").name: table,
               "ids": torch.from_numpy(ids_np).to(dtype),
               "lens": torch.from_numpy(lens_np).to(dtype),
               DEVICE_KEY: torch.device("cpu")}
        for op in tfluid.default_main_program().global_block().ops:
            run_op(env, op)
        outs.append((env[emb.name], env[mask.name]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][0], table[torch.from_numpy(ids_np)])
    np.testing.assert_array_equal(
        outs[0][1].numpy(), np.arange(SEQ)[None] < lens_np[:, None])


def test_clone_for_test_matches_reference_semantics():
    """``clone(for_test=True)`` turns ``dropout`` to inference but leaves
    ``flash_attention``'s dropout_rate alone, in both packages (a
    reference-side fault the port reproduces rather than fixes)."""
    def attrs(pkg, encoder):
        L = pkg.layers
        x = encoder(L.data("input_ids", shape=[SEQ], dtype="int64"),
                    L.data("segment_ids", shape=[SEQ], dtype="int64"),
                    L.data("input_len", shape=[], dtype="int64"), SEQ,
                    VOCAB, D_MODEL, D_FF, HEADS, LAYERS, dropout_rate=0.1)
        test_prog = pkg.default_main_program().clone(for_test=True)
        pruned = test_prog.prune([test_prog.global_block().var(x.name)])
        return [(op.type, op.attr("is_test"), op.attr("dropout_rate"))
                for op in pruned.global_block().ops
                if op.type in ("dropout", "flash_attention")]

    want = attrs(fluid, jax_bert_encoder)
    got = attrs(tfluid, tfluid.models.bert.bert_encoder)
    assert got == want
    assert ("flash_attention", None, 0.1) in got
    assert all(t for op, t, _ in got if op == "dropout")


def test_startup_draws_xavier_and_constant_inits():
    """Torch and JAX draw different numbers from one seed, so the port's
    startup program is held to the initializers' distributions."""
    build_classifier(tfluid, tfluid.models.bert.bert_encoder)
    tfluid.default_startup_program().random_seed = 3
    tfluid.Executor(tfluid.CPUPlace()).run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    for p in tfluid.default_main_program().all_parameters():
        a = scope.get(p.name).numpy()
        assert a.shape == p.shape and a.dtype == np.float32
        if p.name.startswith("layer_norm") and ".w_" in p.name:
            np.testing.assert_array_equal(a, 1.0)
        elif ".b_" in p.name:
            np.testing.assert_array_equal(a, 0.0)
        else:  # Xavier uniform on [-limit, limit]
            fan_in, fan_out = p.shape[0], p.shape[1]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(a).max() <= limit
            if a.size >= 1000:
                assert abs(a.mean()) < 0.05 * limit
                assert abs(a.std() - limit / np.sqrt(3)) < 0.05 * limit
