"""The port's imperative BERT (``models/bert_dygraph.py``) against
``paddle_tpu``'s on the CPU, at the reference tests' tiny configuration
(vocab 100, seq 16, d_model 32, d_ff 64, 4 heads, 2 layers).

Twins of ``tests/test_dygraph_bert.py``: the dygraph model loaded with the
static twin's parameters gives the static loss, held against the port's
own static BERT and against the JAX dygraph model, eager and through the
functional export; and the functional step trains. Beyond them, with
dropout 0: the eager loss and every parameter's gradient against the
reference's tape (its flash and CE Pallas kernels in interpret mode, as
its kernel tests run them; the port's plain versions), then two Adam
steps and one Lamb step of ``make_train_step`` against the reference's
jitted step, within ``test_torch_training.py``'s tolerances: loss and
gradients atol 2e-5 / rtol 1e-4, parameters atol 1e-4 / rtol 1e-4. Under
AMP (bf16 products) the port's loss and gradients follow the reference's
AMP tape where bf16 rounds (bounds stated in the test, far below the
distance of the port's f32 gradients). ``CapturedTrainStep`` over an
eager stand-in for the graph replays the step over its fixed feed buffers and
gives the direct step's losses and parameters bitwise."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.ops.flash_attention as jfa
import paddle_tpu.ops.fused_ce as jfce
import paddle_tpu_torch as tfluid
from paddle_tpu.models import bert_dygraph as jbd
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.dygraph import CapturedTrainStep
from paddle_tpu_torch.models import bert_dygraph as tbd

CFG = dict(vocab_size=100, seq_len=16, d_model=32, d_ff=64, n_head=4,
           n_layer=2, dropout_rate=0.0)
TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = tfluid.CPUPlace()
FEED_NAMES = ("input_ids", "segment_ids", "input_len", "mlm_labels",
              "mlm_weights", "nsp_label")


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


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod in (jfa, jfce):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _feeds(batch=4, ragged=False):
    feeds = list(jbd.sample_batch(batch, CFG["seq_len"], CFG["vocab_size"],
                                  np.random.RandomState(0)))
    if ragged:  # padded keys: the per-key bias the flash kernels read
        feeds[2] = np.array([16, 9, 3, 12][:batch], np.int32)
    return tuple(feeds)


def _models(amp=False, **kw):
    """The reference's dygraph BERT (lazy FCs built) and the port's, its
    weights the reference's."""
    cfg = dict(CFG, amp=amp, **kw)
    feeds = _feeds()
    jm = jbd.bert_base_dygraph(**cfg)[0]
    with fluid.dygraph.guard():
        jm(*feeds)
    with tfluid.dygraph.guard(CPU):
        tm = tbd.bert_base_dygraph(**cfg)[0]
        tm(*feeds)
    assert [p.name for p in jm.parameters()] == \
        [p.name for p in tm.parameters()]
    tfluid.bridge.load_dygraph_state(
        tm, {n: np.asarray(v) for n, v in jm.state_pytree().items()}, "cpu")
    return jm, tm


# -- twins of tests/test_dygraph_bert.py --------------------------------------

def _static_loss_and_params(pkg, feeds, params=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        spec = pkg.models.bert.bert_base(**CFG)
    place = pkg.CPUPlace()
    exe = pkg.Executor(place)
    scope = pkg.Scope()
    feed = dict(zip(FEED_NAMES, feeds))
    with pkg.scope_guard(scope):
        exe.run(startup)
        if params is not None:
            pkg.bridge.load_program_params(scope, params, main, "cpu")
        loss, = exe.run(main, feed=feed, fetch_list=[spec.loss])
        out = {p.name: np.array(scope.numpy(p.name))
               for p in main.all_parameters()}
    return float(loss), out


def _load_static_params(model, sp, setv):
    """Explicit static-name -> dygraph-module mapping (the reference
    test's)."""
    setv(model.word_emb._w, sp["word_emb"])
    setv(model.pos_emb._w, sp["pos_emb"])
    setv(model.seg_emb._w, sp["seg_emb"])
    ln = [k for k in sp if k.startswith("layer_norm_")]
    ln_w = sorted((k for k in ln if ".w_" in k),
                  key=lambda k: int(k.split("_")[2].split(".")[0]))
    ln_b = sorted((k for k in ln if ".b_" in k),
                  key=lambda k: int(k.split("_")[2].split(".")[0]))
    norms = [model.emb_norm]
    for attn, ffn in zip(model.attn, model.ffn):
        norms += [attn.norm, ffn.norm]
    norms.append(model.mlm_norm)
    assert len(norms) == len(ln_w) == len(ln_b)
    for mod, kw, kb in zip(norms, ln_w, ln_b):
        setv(mod._scale, sp[kw])
        setv(mod._bias, sp[kb])
    for i, (attn, ffn) in enumerate(zip(model.attn, model.ffn)):
        mha = attn.inner
        setv(mha._wq, sp["layer%d_attn.q" % i])
        setv(mha._wk, sp["layer%d_attn.k" % i])
        setv(mha._wv, sp["layer%d_attn.v" % i])
        setv(mha._wo, sp["layer%d_attn.out" % i])
        f = ffn.inner
        setv(f._w1, sp["layer%d_ffn1.w" % i])
        setv(f._b1, sp["layer%d_ffn1.b_0_0" % i])
        setv(f._w2, sp["layer%d_ffn2.w" % i])
        setv(f._b2, sp["layer%d_ffn2.b_0_0" % i])
    setv(model.mlm_transform._w, sp["mlm_transform.w_0_0"])
    setv(model.mlm_transform._b, sp["mlm_transform.b_0_0"])
    setv(model._mlm_w, sp["mlm_out.w"])
    setv(model._mlm_b, sp["mlm_out.b_0_0"])
    setv(model.pooler._w, sp["pooler.w_0_0"])
    setv(model.pooler._b, sp["pooler.b_0_0"])
    setv(model.nsp_out._w, sp["nsp_out.w_0_0"])
    setv(model.nsp_out._b, sp["nsp_out.b_0_0"])


def test_dygraph_matches_static_twin():
    import jax
    import jax.numpy as jnp

    feeds = _feeds()
    j_static, sp = _static_loss_and_params(fluid, feeds)
    t_static, _ = _static_loss_and_params(tfluid, feeds, params=sp)
    np.testing.assert_allclose(t_static, j_static, **TOL)

    def jset(p, arr):
        assert tuple(p.shape) == tuple(arr.shape), (p.shape, arr.shape)
        p._value = jnp.asarray(arr)

    def tset(p, arr):
        assert tuple(p.shape) == tuple(arr.shape), (p.shape, arr.shape)
        p._value = torch.from_numpy(np.array(arr))

    jm, tm = _models()
    _load_static_params(jm, sp, jset)
    _load_static_params(tm, sp, tset)
    jm.eval()
    tm.eval()
    with fluid.dygraph.guard():
        j_eager = float(jm(*feeds).numpy())
    with tfluid.dygraph.guard(CPU):
        t_eager = float(tm(*feeds).numpy())
    japply, jparams = jm.functional(rng=True)
    j_fn = float(jax.jit(japply)(jparams, jax.random.PRNGKey(0), *feeds))
    tapply, tparams = tm.functional(rng=True)
    t_fn = float(tapply(tparams, torch.Generator().manual_seed(0), *feeds))
    # the port's dygraph against its own static BERT ...
    np.testing.assert_allclose(t_eager, t_static, **TOL)
    np.testing.assert_allclose(t_fn, t_static, **TOL)
    # ... and against the JAX dygraph model
    np.testing.assert_allclose(t_eager, j_eager, **TOL)
    np.testing.assert_allclose(t_fn, j_fn, **TOL)
    np.testing.assert_allclose(j_eager, j_static, rtol=2e-4, atol=2e-4)


def test_dygraph_bert_trains_under_jit():
    """The functional step at dropout 0.1 trains (15 Adam steps, the loss
    below 0.7x its first); the reference's bar, on the port's step."""
    with tfluid.dygraph.guard(CPU):
        model = tbd.bert_base_dygraph(**dict(CFG, dropout_rate=0.1))[0]
        feeds = _feeds(batch=8)
        model(*feeds)
    step, params, opt_state = tbd.make_train_step(model, learning_rate=3e-3)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(params, opt_state, gen, *feeds)[0])
              for _ in range(15)]
    assert losses[-1] < 0.7 * losses[0], losses


# -- eager tape and functional steps against the reference -------------------

def test_tiny_bert_eager_loss_and_grads_match(pallas_interpret):
    jm, tm = _models()
    feeds = _feeds(ragged=True)
    with fluid.dygraph.guard():
        jl = jm(*feeds)
        jl.backward()
    with tfluid.dygraph.guard(CPU):
        tl = tm(*feeds)
        tl.backward()
    np.testing.assert_allclose(float(tl.numpy()), float(jl.numpy()), **TOL)
    for jp, tp in zip(jm.parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.gradient(), jp.gradient(),
                                   err_msg=tp.name, **TOL)


def _steps(jm, tm, feeds, opt, n, lr):
    import jax

    jstep, jparams, jopt = jbd.make_train_step(jm, learning_rate=lr,
                                               optimizer=opt)
    jstep = jax.jit(jstep)
    tstep, tparams, topt = tbd.make_train_step(tm, learning_rate=lr,
                                               optimizer=opt)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for i in range(n):
        key, sub = jax.random.split(key)
        jl, jparams, jopt = jstep(jparams, jopt, sub, *feeds)
        tl, _, _ = tstep(tparams, topt, gen, *feeds)
        np.testing.assert_allclose(float(tl), float(jl),
                                   err_msg="step %d" % i, **TOL)
    assert int(topt["t"]) == n
    for name, v in jparams.items():
        np.testing.assert_allclose(tparams[name].numpy(), np.asarray(v),
                                   err_msg=name, **PARAM_TOL)
        np.testing.assert_allclose(topt["m"][name].numpy(),
                                   np.asarray(jopt["m"][name]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("opt,n", [("adam", 2), ("lamb", 1)])
def test_train_step_matches_reference(opt, n):
    jm, tm = _models()
    _steps(jm, tm, _feeds(ragged=True), opt, n, 3e-3)


def _rl2(a, b):
    """Relative L2 distance of the arrays ``a`` from ``b``, all as one."""
    a = np.concatenate([np.ravel(x).astype("f8") for x in a])
    b = np.concatenate([np.ravel(x).astype("f8") for x in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


AMP_GRAD_RL2 = 1e-3   # matrices' gradients, relative L2 over them all
AMP_VEC_RL2 = 5e-3    # vectors' (biases, LayerNorm): f32 sums in bf16


def test_amp_loss_and_grads_match_the_reference_amp(pallas_interpret):
    """Under AMP the port's loss and gradients follow the reference's (its
    kernels in interpret mode) where bf16 rounds: the tanh gelu's and
    tanh's bf16 arithmetic and the order the attention input's gradients
    add in are the reference's. The loss within 1e-6 relative, the
    matrices' gradients within AMP_GRAD_RL2, the vectors' within
    AMP_VEC_RL2 (measured 0, 6.6e-5 and 8.1e-4), where the port's own f32
    gradients lie 1e-2 from the reference's AMP ones."""
    feeds = _feeds(ragged=True)
    jm, tm = _models(amp=True)
    state = {n: np.asarray(v) for n, v in jm.state_pytree().items()}
    with fluid.dygraph.guard():
        jl = jm(*feeds)
        jl.backward()
    with tfluid.dygraph.guard(CPU):
        tl = tm(*feeds)
        tl.backward()
        t_unique_name.switch()
        f32 = tbd.bert_base_dygraph(**CFG)[0]
        f32(*feeds)
        tfluid.bridge.load_dygraph_state(f32, state, "cpu")
        fl = f32(*feeds)
        fl.backward()
    assert jm.parameters()[0].gradient().dtype == np.float32
    np.testing.assert_allclose(float(tl.numpy()), float(jl.numpy()),
                               rtol=1e-6)
    want = {p.name: p.gradient() for p in jm.parameters()}
    got = {p.name: p.gradient() for p in tm.parameters()}
    f32g = {p.name: p.gradient() for p in f32.parameters()}
    mats = [n for n in want if want[n].ndim > 1]
    vecs = [n for n in want if want[n].ndim == 1]
    assert _rl2([got[n] for n in mats], [want[n] for n in mats]) \
        < AMP_GRAD_RL2 < _rl2([f32g[n] for n in mats],
                              [want[n] for n in mats])
    assert _rl2([got[n] for n in vecs], [want[n] for n in vecs]) \
        < AMP_VEC_RL2


class _EagerGraph:
    """CPU stand-in for the card's graph: a capture runs nothing, a replay
    runs the captured function and writes its result into the tensor the
    capture handed out."""

    def __init__(self, fn):
        self.fn = fn
        self.out = torch.empty(0)

    def replay(self):
        out = self.fn()
        self.out.resize_(out.shape).copy_(out)


def test_captured_step_replays_the_step(monkeypatch):
    def capture_graph(fn, generator, device, **graph_kw):
        graph = _EagerGraph(fn)
        return graph, graph.out, 0

    monkeypatch.setattr(t_executor, "capture_graph", capture_graph)
    batches = [_feeds(), _feeds(ragged=True)]
    out = []
    for captured in (False, True):
        t_unique_name.switch()
        tfluid.dygraph.layers.seed(5)
        with tfluid.dygraph.guard(CPU):
            model = tbd.bert_base_dygraph(**dict(CFG, dropout_rate=0.1))[0]
            model(*batches[0])
        step, params, opt = tbd.make_train_step(model, learning_rate=1e-3)
        gen = torch.Generator().manual_seed(3)
        run = CapturedTrainStep(step, params, opt, gen) if captured else \
            (lambda *f: step(params, opt, gen, *f)[0])
        losses = [float(run(*batches[i % 2])) for i in range(5)]
        out.append((losses, {n: p.clone() for n, p in params.items()}))
        if captured:
            # the step's first call ran eagerly, the second was the capture
            # (whose replay ran that step), the later ones replays
            assert run.report()["replays"] == 3
            assert run.report()["captures"] == 1
    assert out[0][0] == out[1][0]
    for n, p in out[0][1].items():
        assert torch.equal(p, out[1][1][n]), n
