"""The Executor's program cache and compiled-step model on the CPU.

On the card the Executor captures each (program, feed signature, fetch
set, ...) key as one CUDA graph over static buffers (``CapturedStep``); a
CPU step has no graph. These tests check what decides and feeds a capture
without one:

* the cache key hits and misses as the reference's does, and ``close()``
  empties it;
* the capture rule admits the models' training, eval and serving programs
  and declines decode, ``merge_sparse``, lazy sparse updates,
  ``use_program_cache=False``, state-writing ``donate_state=False`` and
  CPU places, each with its reason;
* the step body over static buffers (the scope's own tensors, written in
  place) equals interpreted steps bitwise (dropout on, one generator
  state), and, dropout off, three Adam steps of ``paddle_tpu``'s jitted
  executor within atol 1e-4 / rtol 1e-4 on the parameters and atol 2e-5 /
  rtol 1e-4 on the losses (the bounds of ``test_torch_training.py``: the
  two sides sum in other orders, and Adam moves an element whose gradient
  is within rounding of zero by a share of the learning rate);
* the executor's call sequence (interpret, capture, replay, re-bind) with a
  CPU stand-in for the graph (:class:`EagerGraph`): a replaced state
  tensor is read by the next step, a ``return_numpy=False`` fetch survives
  the next step, and predictor clones leave their shared weights as they
  were."""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.ops.flash_attention as jfa
import paddle_tpu.ops.fused_ce as jfce
import paddle_tpu.ops.fused_layer_norm as jfln
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch import backward as t_backward
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name

TINY_T = dict(src_vocab=64, trg_vocab=64, seq_len=16, d_model=32, d_ff=64,
              n_head=2, n_layer=2, dropout_rate=0.0)
TINY_FM = dict(sparse_feature_dim=1000, num_fields=6, embedding_size=8,
               dense_dim=5, hidden_sizes=(16, 16))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_port_programs():
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


class EagerGraph:
    """CPU stand-in for a captured graph: a replay runs the step body
    eagerly and writes the fetches into the same tensors every time, as a
    replay overwrites the graph's own buffers."""

    def __init__(self, step):
        self.step = step
        self.outs = None

    def replay(self):
        outs = self.step.body()
        if self.outs is None:
            self.outs = [o.clone() for o in outs]
        else:
            for held, new in zip(self.outs, outs):
                held.copy_(new)
        self.step.fetches = self.outs


@pytest.fixture
def cpu_capture(monkeypatch):
    """The executor's capture path on the CPU: the rule judges a CPU place
    as it would a card, and the capture binds an :class:`EagerGraph`."""
    rule = t_executor.capture_rule

    def as_card(ops, writes=(), **kw):
        kw["cuda"] = True
        return rule(ops, writes, **kw)

    def capture(step, stream):
        step.graph = EagerGraph(step)
        step.entry.pool_bytes = 0

    monkeypatch.setattr(t_executor, "capture_rule", as_card)
    monkeypatch.setattr(t_executor.CapturedStep, "capture", capture)
    monkeypatch.setattr(t_executor.Executor, "_side_stream",
                        lambda self: None)
    monkeypatch.setattr(t_executor.Executor, "_warm_up",
                        lambda self: contextlib.nullcontext())


def _mlp(pkg, opt=None):
    x = pkg.layers.data("x", shape=[12])
    y = pkg.layers.data("y", shape=[3])
    h = pkg.layers.fc(x, size=16, act="relu")
    o = pkg.layers.fc(h, size=3)
    d = pkg.layers.elementwise_sub(o, y)
    loss = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
    (opt or pkg.optimizer.Adam(1e-2)).minimize(loss)
    return loss, h


def _mlp_feed(batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, 12).astype("float32"),
            "y": rng.randn(batch, 3).astype("float32")}


def _persist(program):
    return {v.name for v in program.list_vars() if v.persistable}


# -- the cache key -----------------------------------------------------------

def _variant(kind, main, loss, h, scope, monkeypatch):
    """(feed, fetch_list, scope) of the second run of a key test."""
    feed, fetch = _mlp_feed(), [loss]
    if kind == "version":
        with t_framework.program_guard(main):
            tfluid.layers.scale(h, scale=2.0)
    elif kind == "feed_shape":
        feed = _mlp_feed(batch=4)
    elif kind == "feed_dtype":  # an undeclared feed keeps its own dtype
        feed = dict(feed, extra=np.zeros(3, "int32"))
    elif kind == "fetch_set":
        fetch = [loss, h]
    elif kind == "scope":
        scope = t_executor.Scope()
        t_executor.Executor(tfluid.CPUPlace()).run(
            tfluid.default_startup_program(), scope=scope)
    elif kind == "fused_opt":
        monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", "1")
    elif kind == "amp":
        tfluid.amp.enable_bf16(main)
    return feed, fetch, scope


@pytest.mark.parametrize("kind", ["hit", "version", "feed_shape",
                                  "feed_dtype", "fetch_set", "scope",
                                  "fused_opt", "amp"])
def test_cache_key_hits_and_misses(kind, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_OPT", raising=False)
    loss, h = _mlp(tfluid)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.global_scope()
    exe.run(tfluid.default_startup_program())
    feed = dict(_mlp_feed(), extra=np.zeros(3, "float32")) \
        if kind == "feed_dtype" else _mlp_feed()
    exe.run(main, feed=feed, fetch_list=[loss])
    n = len(exe._cache)
    feed, fetch, scope = _variant(kind, main, loss, h, scope, monkeypatch)
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert len(exe._cache) == n + (kind != "hit")
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert len(exe._cache) == n + (kind != "hit")
    report = exe.step_report(main)
    assert report["captured"] is False
    assert report["reason"].startswith("CPU place")
    exe.close()
    assert exe._cache == {}
    with pytest.raises(KeyError):
        exe.step_report(main)


def test_use_program_cache_false_keeps_nothing():
    loss, _ = _mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    n = len(exe._cache)  # the startup program's entry
    exe.run(feed=_mlp_feed(), fetch_list=[loss], use_program_cache=False)
    assert len(exe._cache) == n
    report = exe.step_report()
    assert not report["captured"] and report["interpreted"] == 1


# -- the capture rule --------------------------------------------------------

def _bert_serving():
    L = tfluid.layers
    s = 16
    ids = L.data("input_ids", shape=[s], dtype="int64")
    seg = L.data("segment_ids", shape=[s], dtype="int64")
    ln = L.data("input_len", shape=[], dtype="int64")
    x = tfluid.models.bert.bert_encoder(ids, seg, ln, s, 100, 32, 64, 2, 2,
                                        dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    return [L.softmax(L.fc(cls, size=2))]


def _resnet(for_test):
    spec = tfluid.models.resnet.resnet_imagenet(class_num=10,
                                                image_shape=(3, 32, 32))
    tfluid.optimizer.Adam(1e-3).minimize(spec.loss)
    main = tfluid.default_main_program()
    if for_test:
        return main.clone(for_test=True), [spec.loss, spec.fetches["acc"]]
    return main, [spec.loss, spec.fetches["acc"]]


def _program(name):
    """(program, fetch list) of one rule case, built in the default
    programs."""
    main = tfluid.default_main_program()
    if name in ("transformer", "transformer_amp"):
        spec = tfluid.models.transformer.transformer_base(
            **dict(TINY_T, dropout_rate=0.1))
        opt = tfluid.optimizer.Adam(1e-3)
        if name == "transformer_amp":
            opt = tfluid.amp.decorate(opt)
        opt.minimize(spec.loss)
        return main, [spec.loss]
    if name == "resnet_train":
        return _resnet(False)
    if name == "resnet_eval":
        return _resnet(True)
    if name in ("deepfm", "deepfm_merge_sparse", "deepfm_lazy"):
        spec = tfluid.models.deepfm.deepfm(**TINY_FM)
        tfluid.optimizer.Adam(1e-3, lazy_mode=name == "deepfm_lazy") \
            .minimize(spec.loss)
        if name == "deepfm_merge_sparse":
            t_backward.require_merged_sparse(main)
        return main, [spec.loss]
    if name == "bert_serving":
        return main, _bert_serving()
    if name == "decode":
        fetch, _ = tfluid.models.transformer.transformer_lm_step(
            vocab=50, d_model=16, d_ff=32, n_head=2, n_layer=1, ctx_cap=8)
        return main, fetch
    if name == "train_no_donate":
        loss, _ = _mlp(tfluid)
        return main, [loss]
    raise AssertionError(name)


ADMITTED = ["transformer", "transformer_amp", "resnet_train", "resnet_eval",
            "deepfm", "bert_serving"]
DECLINED = {
    "decode": "op 'kv_cache_write': fed cache copied per dispatch",
    "deepfm_merge_sparse": "op 'autodiff' merges sparse rows",
    "deepfm_lazy": "op 'adam' updates the touched rows of a sparse grad",
    "train_no_donate": "writes state (",
}


def _judge(program, fetch, **kw):
    fetch_names = [v.name for v in fetch]
    ops, _ = t_executor.fused_ops(program, fetch_names)
    writes = t_executor.state_writes(ops, _persist(program))
    return t_executor.capture_rule(ops, writes, **kw), writes


@pytest.mark.parametrize("name", ADMITTED)
def test_rule_admits_the_models(name):
    program, fetch = _program(name)
    (captured, reason), writes = _judge(program, fetch)
    assert (captured, reason) == (True, "admitted")
    # serving and eval write no state, so the Predictor's
    # donate_state=False captures them too
    no_donate, _ = _judge(program, fetch, donate_state=False)
    assert no_donate[0] == (name in ("bert_serving", "resnet_eval"))
    assert bool(writes) == (name not in ("bert_serving", "resnet_eval"))


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_rule_declines_with_reason(name):
    program, fetch = _program(name)
    donate = name != "train_no_donate"
    (captured, reason), _ = _judge(program, fetch, donate_state=donate)
    assert not captured
    assert reason.startswith(DECLINED[name]), reason


@pytest.mark.parametrize("kw,reason", [
    (dict(use_program_cache=False), "use_program_cache=False"),
    (dict(cuda=False), "CPU place"),
])
def test_rule_declines_by_setting(kw, reason):
    program, fetch = _program("transformer")
    (captured, why), _ = _judge(program, fetch, **kw)
    assert not captured and why.startswith(reason), why


# -- the static-buffer step --------------------------------------------------

def _out_of_inference(scope, names):
    """The state as call 1 leaves it: tensors a training step can save."""
    for n in names:
        if n in scope and scope.get(n).is_inference():
            scope.set(n, scope.get(n).clone())


def _static_steps(program, scope, feed, fetch, steps):
    exe = tfluid.Executor(tfluid.CPUPlace())
    persist = _persist(program)
    fetch_names = [v.name for v in fetch]
    entry = exe._entry(program, scope, fetch_names, persist, False, True,
                       True)
    _out_of_inference(scope, persist)
    state_in = sorted(n for n in persist if n in scope)
    step = t_executor.CapturedStep(entry, scope, state_in, feed, fetch_names,
                                   CPU, program.global_block())
    out = []
    for _ in range(steps):
        step.load_feed(feed)
        out.append([f.numpy().copy() for f in step.body()])
    return out, step


def _copy_scope(src, names):
    dst = t_executor.Scope()
    for n in names:
        if n in src:
            dst.set(n, src.get(n).clone())
    gen = torch.Generator()
    gen.set_state(src.get(t_executor.RNG_KEY).get_state())
    dst.set(t_executor.RNG_KEY, gen)
    return dst


def test_static_body_equals_interpreted_bitwise():
    spec = tfluid.models.transformer.transformer_base(
        **dict(TINY_T, dropout_rate=0.1))
    tfluid.optimizer.Adam(3e-3).minimize(spec.loss)
    main = tfluid.default_main_program()
    tfluid.default_startup_program().random_seed = 5
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.global_scope()
    exe.run(tfluid.default_startup_program())
    feed = spec.sample_batch(4, np.random.RandomState(7))
    persist = _persist(main)
    other = _copy_scope(scope, persist)
    want = [exe.run(main, feed=feed, fetch_list=[spec.loss])
            for _ in range(3)]
    got, step = _static_steps(main, other, feed, [spec.loss], 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0], w[0])
    assert len({float(w[0]) for w in want}) == 3  # the steps moved
    for n in sorted(persist):
        assert other.get(n) is step.state[n], n  # written in place
        np.testing.assert_array_equal(other.get(n).numpy(),
                                      scope.get(n).numpy(), err_msg=n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod in (jfa, jfce, jfln):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def test_static_body_matches_jitted_reference(pallas_interpret):
    jspec = jmodels.transformer.transformer_base(**TINY_T)
    fluid.optimizer.Adam(3e-3).minimize(jspec.loss)
    jprog = fluid.default_main_program()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(fluid.default_startup_program())
    jscope = fluid.global_scope()
    params = {p.name: np.asarray(jscope.get(p.name))
              for p in jprog.all_parameters()}
    batch = jspec.sample_batch(4, np.random.RandomState(7))
    batch["src_len"] = np.array([16, 9, 1, 12], "int64")
    want = [jexe.run(feed=batch, fetch_list=[jspec.loss])[0]
            for _ in range(3)]
    want_params = {n: np.asarray(jscope.get(n)) for n in params}

    tspec = tfluid.models.transformer.transformer_base(**TINY_T)
    tfluid.optimizer.Adam(3e-3).minimize(tspec.loss)
    main = tfluid.default_main_program()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    tfluid.bridge.load_program_params(scope, params, main, "cpu")
    got, _ = _static_steps(main, scope, batch, [tspec.loss], 3)
    for i in range(3):
        np.testing.assert_allclose(got[i][0], want[i], atol=2e-5, rtol=1e-4,
                                   err_msg="loss of step %d" % i)
    for n in sorted(params):
        np.testing.assert_allclose(scope.get(n).numpy(), want_params[n],
                                   atol=1e-4, rtol=1e-4, err_msg=n)


# -- the call sequence, with the CPU stand-in ---------------------------------

def test_call_sequence_interpret_capture_replay(cpu_capture):
    loss, _ = _mlp(tfluid)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    feed = _mlp_feed()
    other = _copy_scope(scope, _persist(main))
    ref = tfluid.Executor(tfluid.CPUPlace())
    for i in range(5):
        got = exe.run(main, feed=feed, fetch_list=[loss])[0]
        want = ref.run(main, feed=feed, fetch_list=[loss], scope=other,
                       use_program_cache=False)[0]
        np.testing.assert_array_equal(got, want, err_msg="step %d" % i)
    report = exe.step_report(main)
    assert report["captured"] and report["graph"]
    assert (report["interpreted"], report["captures"],
            report["replays"]) == (1, 1, 3)
    exe.close()
    assert exe._cache == {}


def test_replaced_state_is_read_by_next_step(cpu_capture):
    loss, _ = _mlp(tfluid)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    feed = _mlp_feed()
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    assert exe.step_report(main)["replays"] == 1
    w = main.all_parameters()[0].name
    scope.set(w, torch.zeros_like(scope.get(w)))
    other = _copy_scope(scope, _persist(main))
    ref = tfluid.Executor(tfluid.CPUPlace())
    for i in range(3):  # interpreted again, captured again, replayed
        got = exe.run(main, feed=feed, fetch_list=[loss])[0]
        want = ref.run(main, feed=feed, fetch_list=[loss], scope=other)[0]
        np.testing.assert_array_equal(got, want, err_msg="step %d" % i)
    report = exe.step_report(main)
    assert (report["interpreted"], report["captures"],
            report["replays"]) == (2, 2, 2)


def test_tensor_fetch_survives_next_step(cpu_capture):
    loss, h = _mlp(tfluid)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = _mlp_feed()
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss, h])
    got = exe.run(main, feed=feed, fetch_list=[loss, h], return_numpy=False)
    kept = [t.clone() for t in got]
    exe.run(main, feed=_mlp_feed(seed=1), fetch_list=[loss, h])
    for t, k in zip(got, kept):
        assert torch.equal(t, k)
    assert exe.step_report(main)["replays"] == 2


def test_predictor_clones_leave_weights_untouched(cpu_capture, tmp_path):
    prob, = _bert_serving()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    tfluid.io.save_inference_model(
        str(tmp_path), ["input_ids", "segment_ids", "input_len"], [prob], exe)
    config = tfluid.inference.AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    pred = tfluid.inference.Predictor(config)
    clone = pred.clone()
    weights = dict(pred._scope._vars)
    values = {n: t.clone() for n, t in weights.items()
              if isinstance(t, torch.Tensor)}
    rng = np.random.RandomState(3)
    feeds = [{"input_ids": rng.randint(0, 100, (2, 16)),
              "segment_ids": rng.randint(0, 2, (2, 16)),
              "input_len": rng.randint(1, 17, (2,))} for _ in range(4)]
    want = [pred.run(f)[0] for f in feeds]  # call 1, capture, 2 replays
    for p in (clone, pred):
        got = [p.run(f)[0] for f in feeds]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    for p in (pred, clone):
        report = p._exe.step_report(p._program)
        assert report["captured"] and report["graph"], report
    # the first run adds the scope's generator, and nothing else
    assert pred._scope._vars.keys() - weights.keys() == {
        t_executor.RNG_KEY}
    for n, t in values.items():
        assert pred._scope.get(n) is weights[n], n
        assert torch.equal(pred._scope.get(n), t), n


def _dropout_mlp():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[12])
        h = tfluid.layers.dropout(tfluid.layers.fc(x, size=16, act="relu"),
                                  dropout_prob=0.5)
        loss = tfluid.layers.mean(tfluid.layers.fc(h, size=1))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_scope_keeps_a_generator_per_device(cpu_capture):
    """A scope whose ``@RNG@`` another device made (a stand-in for a card's
    generator) gives a CPU executor a generator of its own under
    ``@RNG@cpu``: its interpreted, captured and replayed steps draw the
    dropout masks a fresh scope draws, and the other device's generator
    stays as it was."""
    main, startup, loss = _dropout_mlp()
    feed = _mlp_feed()
    other = type("CardGenerator", (), {"device": torch.device("cuda", 0)})()
    losses = {}
    for shared in (False, True):
        scope = t_executor.Scope()
        if shared:
            scope.set(t_executor.RNG_KEY, other)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        losses[shared] = [exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0] for _ in range(4)]
        report = exe.step_report(main)
        assert (report["interpreted"], report["captures"],
                report["replays"]) == (1, 1, 2)
        step = next(e.step for e in exe._cache.values() if e.step)
        name = "@RNG@cpu" if shared else t_executor.RNG_KEY
        assert step.rng == name and step.gen is scope.get(name)
        assert isinstance(step.gen, torch.Generator)
        exe.close()
    assert scope.get(t_executor.RNG_KEY) is other
    assert len({float(v) for v in losses[False]}) > 1
    for got, want in zip(losses[True], losses[False]):
        np.testing.assert_array_equal(got, want)
