"""bf16 mixed precision (``fluid.amp``) in the port against ``paddle_tpu``
on the CPU.

The API (``enable_bf16`` / ``disable_bf16`` / ``decorate`` and the version
bump; ``clone`` drops the mark in both packages), the Executor's scoping of
the flag, and the dtype of every op output of a tiny AMP Transformer, which
must equal the reference's op by op. Then two ``Adam`` steps of a tiny
Transformer (its flash, LayerNorm and fused-CE Pallas kernels in interpret
mode) and of a tiny DeepFM (its scatter in interpret mode) under
``decorate``, the port against the reference from the same weights and
feeds, next to the reference's own AMP-vs-f32 distance on the same inputs.

Tolerances. bf16 keeps 8 bits, and a rounding flip anywhere moves whole
gradient elements, so the comparison is by relative L2 over a step's
gradients, not element by element. Each step starts both packages from
one state. The matrices' (products') gradients must lie within a stated
bound of the reference's, and the reference's own AMP-vs-f32 distance
outside it: Transformer 1.5e-2 (measured: port 3.3e-3 and 7.5e-4 at the
two steps, f32 4.9e-2 and 3.6e-2), DeepFM 2.5e-3 (port 1.2e-3 and 0, f32
0.146 and 5.1e-3; its two layers round little). The vectors' gradients
(biases, LayerNorm scales) within ``VEC_RL2``: the gradient of a bias
added in bf16 is a bf16 sum over the batch, which XLA:CPU takes row by row
in bf16 and torch in f32 (measured 3e-3 to 7e-3, the size of the
AMP-vs-f32 distance of DeepFM's). The parameter updates at most half as
far from the reference's as the f32 run's (measured 0.2 at the first
Adam step, which moves each element by about lr * sign(g), and below 0.05
after). The loss within ``LOSS_REL`` relative, a quarter of bf16's 2^-8:
the scalar's own AMP-vs-f32 difference can be any size, and XLA fuses the
reference's jitted bf16 arithmetic, which moves its loss by some 2e-4.
The ported contract of
``tests/test_amp.py``: a bf16 MLP trains, within 5% of f32 at the first
step and 25% at the eighth, and its parameters stay f32.

ResNet-50 under ``decorate``: the dtype of every op output of a 32 x 32
step equals the reference's (its fused sites in interpret mode). A whole
AMP step of randomly initialised ResNet-50 is chaotic in bf16 (see
``test_resnet_amp_ops_match_jax_op_by_op``), so its step is held to the
reference op by op, each op on the reference's own AMP inputs, and its
Adam updates on the reference's AMP gradients (read: 1.9e-10 and 5.7e-8
relative L2 at the two steps, the f32 step's 1.25 and 1.36)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.ops.flash_attention as jfa
import paddle_tpu.ops.fused_ce as jfce
import paddle_tpu.ops.fused_conv as jfc
import paddle_tpu.ops.fused_layer_norm as jfln
from paddle_tpu import models as jmodels
from paddle_tpu.core import executor as j_executor
from paddle_tpu.core import op_registry as j_registry
from paddle_tpu.ops import scatter as jscatter
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.core import unique_name as t_unique_name

TINY = dict(src_vocab=64, trg_vocab=64, seq_len=16, d_model=32, d_ff=64,
            n_head=2, n_layer=2, dropout_rate=0.0)
DEEPFM = dict(sparse_feature_dim=1000, num_fields=6, embedding_size=8,
              dense_dim=5, hidden_sizes=(16, 16))
VEC_RL2 = 1.5e-2
FWD_RL2 = 5e-4
GRAD_RL2 = 1e-2
LOSS_REL = 1e-3
SPARSE_TABLES = ("fm_table",)  # a (rows, values) gradient: not fetched


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
    for mod in (jfa, jfce, jfln, jscatter):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _fresh_jax():
    from paddle_tpu.core import framework, unique_name

    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    unique_name.switch()
    j_executor._scope_stack[-1] = j_executor.Scope()


def _rl2(got, want):
    got = np.concatenate([np.ravel(g) for g in got])
    want = np.concatenate([np.ravel(w) for w in want])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mlp(pkg):
    x = pkg.layers.data("x", shape=[12])
    y = pkg.layers.data("y", shape=[1], dtype="int64")
    h = pkg.layers.fc(x, size=32, act="relu")
    logits = pkg.layers.fc(h, size=4)
    return pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, y))


def _mlp_batch(rng, n=16):
    x = rng.normal(size=(n, 12)).astype("f4")
    return {"x": x, "y": (x[:, :4].argmax(1)[:, None]).astype("int64")}


def test_amp_api_marks_the_program():
    prog = tfluid.Program()
    v0 = prog._version
    assert tfluid.amp.enable_bf16(prog) is prog
    assert prog._amp_bf16 and prog._version == v0 + 1
    tfluid.amp.disable_bf16(prog)
    assert not prog._amp_bf16 and prog._version == v0 + 2

    opt = tfluid.optimizer.Adam(1e-3)
    dec = tfluid.amp.decorate(opt, init_loss_scaling=8.0,
                              use_dynamic_loss_scaling=True, incr_ratio=3.0)
    assert dec._opt is opt and dec._learning_rate == opt._learning_rate
    assert (dec._scaler.loss_scaling, dec._scaler.use_dynamic,
            dec._scaler.incr_ratio, dec._scaler.decr_ratio) == \
        (8.0, True, 3.0, 0.5)
    loss = _mlp(tfluid)
    main = tfluid.default_main_program()
    assert not getattr(main, "_amp_bf16", False)
    ops, pg = dec.minimize(loss)
    assert main._amp_bf16 and [o.type for o in ops] == ["adam"] * len(pg)
    # a clone does not carry the mark, in the reference as in the port
    assert not getattr(main.clone(), "_amp_bf16", False)
    assert not getattr(main.clone(for_test=True), "_amp_bf16", False)
    jloss = _mlp(fluid)
    fluid.amp.decorate(fluid.optimizer.Adam(1e-3)).minimize(jloss)
    assert fluid.default_main_program()._amp_bf16
    assert not getattr(fluid.default_main_program().clone(), "_amp_bf16",
                       False)


def test_executor_scopes_the_flag(rng):
    """A marked program runs with AMP on (bf16 products), an unmarked one
    with it off, and the flag is restored after each run, also after one
    that raised."""
    loss = _mlp(tfluid)
    main = tfluid.default_main_program()
    h = main.global_block().ops[0].output("Out")  # the first fc's product
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    batch = _mlp_batch(rng)

    def product_dtype():
        out = exe.run(main, feed=batch, fetch_list=[h, loss],
                      return_numpy=False)
        assert out[1].dtype == torch.float32
        return out[0].dtype

    assert product_dtype() == torch.float32
    tfluid.amp.enable_bf16(main)
    assert product_dtype() == torch.bfloat16
    assert not t_registry.AMP.enabled
    with pytest.raises(KeyError, match="x"):
        exe.run(main, feed={"y": batch["y"]}, fetch_list=[loss])
    assert not t_registry.AMP.enabled
    tfluid.amp.disable_bf16(main)
    assert product_dtype() == torch.float32


@pytest.mark.parametrize("op,want", [("elementwise_add", "bfloat16"),
                                     ("elementwise_min", "bfloat16"),
                                     ("elementwise_pow", "bfloat16"),
                                     ("elementwise_mod", "float32")])
def test_binop_promotion_under_amp_matches_jax(rng, op, want):
    """A bf16 product against an f32 tensor: an arithmetic binop demotes
    the f32 side (``amp_harmonize``) and stays bf16; mod (like floordiv,
    which has no layer) keeps jnp's promotion to f32, since a demoted
    operand could flip its discrete result. Both packages agree."""
    batch = {"x": rng.normal(size=(4, 8)).astype("f4"),
             "y": rng.uniform(1, 2, size=(4, 6)).astype("f4")}
    got = []
    for pkg in (fluid, tfluid):
        x = pkg.layers.data("x", shape=[8])
        y = pkg.layers.data("y", shape=[6])
        h = pkg.layers.fc(x, size=6, bias_attr=False)
        out = getattr(pkg.layers, op)(h, y)
        pkg.amp.enable_bf16(pkg.default_main_program())
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(pkg.default_startup_program())
        res, = exe.run(feed=batch, fetch_list=[out], return_numpy=False)
        got.append(str(res.dtype).replace("torch.", ""))
    assert got == [want, want]


def _record_dtypes(monkeypatch, executor_module):
    """Wrap the module's ``run_op`` for the test: returns {var: (op type,
    dtype)}, the dtype of the first value each output name took."""
    seen = {}
    orig = executor_module.run_op

    def run_op(env, op):
        orig(env, op)
        for n in op.output_arg_names:
            v = env.get(n)
            if n not in seen and hasattr(v, "dtype"):
                seen[n] = (op.type, str(v.dtype).replace("torch.", ""))

    monkeypatch.setattr(executor_module, "run_op", run_op)
    return seen


@pytest.mark.parametrize("f32_acts", [False, True])
def test_transformer_dtype_of_every_op_matches_jax(pallas_interpret,
                                                   monkeypatch, f32_acts):
    """The dtype of every op output of a tiny AMP Transformer step equals
    the reference's, by default and under ``PADDLE_TPU_AMP_F32_ACTS=1``
    (f32-stored products, no demotion of a binop's f32 side)."""
    if f32_acts:
        monkeypatch.setenv("PADDLE_TPU_AMP_F32_ACTS", "1")
    jspec = jmodels.transformer.transformer_base(**TINY)
    fluid.amp.decorate(fluid.optimizer.Adam(3e-3)).minimize(jspec.loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    batch = jspec.sample_batch(4, np.random.RandomState(7))
    want = _record_dtypes(monkeypatch, j_executor)
    exe.run(feed=batch, fetch_list=[jspec.loss])

    tspec = tfluid.models.transformer.transformer_base(**TINY)
    tfluid.amp.decorate(tfluid.optimizer.Adam(3e-3)).minimize(tspec.loss)
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tfluid.default_startup_program())
    got = _record_dtypes(monkeypatch, t_executor)
    texe.run(feed=batch, fetch_list=[tspec.loss])

    assert got == want
    kinds = {v for v in want.values()}
    assert ("autodiff", "bfloat16") not in kinds
    assert ("adam", "bfloat16") not in kinds
    if f32_acts:
        # the products still take bf16 operands, but store f32
        for kind in [("mul", "float32"), ("matmul", "float32"),
                     ("flash_attention", "float32")]:
            assert kind in kinds, kind
        assert ("mul", "bfloat16") not in kinds
        return
    # the activation stream is bf16, statistics, loss and state are f32
    for kind in [("mul", "bfloat16"), ("matmul", "bfloat16"),
                 ("flash_attention", "bfloat16"), ("lookup_table",
                                                   "bfloat16"),
                 ("layer_norm", "bfloat16"), ("layer_norm", "float32"),
                 ("fused_linear_smooth_ce", "float32"),
                 ("autodiff", "float32"), ("adam", "float32")]:
        assert kind in kinds, kind


def _fresh_port():
    t_framework.switch_main_program(t_framework.Program())
    t_framework.switch_startup_program(t_framework.Program())
    t_unique_name.switch()
    t_executor._scope_stack[-1] = t_executor.Scope()


def _one_step(pkg, build, amp, state, feed, cache=None):
    """Build ``build`` in fresh programs of ``pkg``, initialise, replace
    the persistable state by ``state`` (None: keep the init) and run one
    step: (state before, [loss] + trainable parameter gradients, state
    after), the states as ``{name: np.ndarray}``. With a ``cache`` dict the
    programs, executor and scope of (pkg, amp) are built once and kept
    there, and a build that is given a state skips its startup run."""
    key = (pkg.__name__, amp)
    if cache is None or key not in cache:
        if pkg is tfluid:
            _fresh_port()
            models = tfluid.models
        else:
            _fresh_jax()
            models = jmodels
        spec, opt = build(pkg, models)
        (pkg.amp.decorate(opt) if amp else opt).minimize(spec.loss)
        prog = pkg.default_main_program()
        pkg.default_startup_program().random_seed = 13
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.global_scope()
        if cache is None or state is None:
            exe.run(pkg.default_startup_program())
        built = (spec, prog, exe, scope)
        if cache is not None:
            cache[key] = built
    spec, prog, exe, scope = built if cache is None else cache[key]
    get = (lambda t: t.numpy()) if pkg is tfluid else np.asarray
    if state is not None:
        if pkg is tfluid:
            tfluid.bridge.load_numpy_params(scope, state, "cpu", prog)
        else:
            for n, v in state.items():
                scope.set(n, v)
    persist = sorted(v.name for v in prog.list_vars()
                     if v.persistable and v.name in scope)
    before = {n: get(scope.get(n)).copy() for n in persist}
    dense = sorted(p.name for p in prog.all_parameters()
                   if p.trainable and p.name not in SPARSE_TABLES)
    gb = prog.global_block()
    outs = exe.run(prog, feed=feed, fetch_list=[spec.loss] + [
        gb.var(n + "@GRAD") for n in dense], scope=scope)
    return before, dict(zip(["loss"] + dense, outs)), {
        n: get(scope.get(n)).copy() for n in persist}


def _check_two_steps(build, feeds, grad_rl2, cache=None):
    """Each step once from the same state in three runs: the reference
    under AMP, the reference in f32 and the port under AMP. The second
    step starts from the state the reference's AMP step left (parameters
    and Adam moments): two free-running trajectories part after Adam's
    first update, which moves an element whose gradient is within rounding
    of zero by a share of the learning rate either way. ``cache``: see
    :func:`_one_step`."""
    state = None
    for step, feed in enumerate(feeds):
        before, want, after_want = _one_step(fluid, build, True, state, feed,
                                             cache)
        _, f32, after_f32 = _one_step(fluid, build, False, before, feed,
                                      cache)
        _, got, after_got = _one_step(tfluid, build, True, before, feed,
                                      cache)
        mats = [n for n in want if want[n].ndim > 1]
        vecs = [n for n in want if want[n].ndim == 1]
        port = _rl2([got[n] for n in mats], [want[n] for n in mats])
        ref = _rl2([f32[n] for n in mats], [want[n] for n in mats])
        assert port < grad_rl2 < ref, ("grads", step, port, ref)
        port = _rl2([got[n] for n in vecs], [want[n] for n in vecs])
        assert port < VEC_RL2, ("vector grads", step, port)
        loss_port = abs(float(got["loss"]) / float(want["loss"]) - 1.0)
        assert loss_port < LOSS_REL, ("loss", step, loss_port)
        moved = [n for n in sorted(after_want)
                 if not np.array_equal(after_want[n], before[n])]
        port = _rl2([after_got[n] - before[n] for n in moved],
                    [after_want[n] - before[n] for n in moved])
        ref = _rl2([after_f32[n] - before[n] for n in moved],
                   [after_want[n] - before[n] for n in moved])
        assert port < 0.5 * ref, ("update", step, port, ref)
        for n, v in after_got.items():  # parameters and Adam moments
            if v.dtype.kind == "f":
                assert v.dtype == np.float32, n
        state = after_want
    return after_got


def _transformer(pkg, models):
    return (models.transformer.transformer_base(**TINY),
            pkg.optimizer.Adam(3e-3))


def test_transformer_two_adam_steps_match_jax(pallas_interpret):
    batch = jmodels.transformer.transformer_base(**TINY).sample_batch(
        4, np.random.RandomState(7))
    batch["src_len"] = np.array([16, 9, 1, 12], "int64")  # padded keys
    batch["trg_len"] = np.array([16, 16, 5, 11], "int64")  # masked loss
    _check_two_steps(_transformer, [batch, batch], grad_rl2=1.5e-2)


def _deepfm(pkg, models):
    return models.deepfm.deepfm(**DEEPFM), pkg.optimizer.Adam(1e-3)


def test_deepfm_two_adam_steps_match_jax(pallas_interpret):
    """The MLP's products go bf16 through ``mul``, the gathered rows bf16
    through ``lookup_table``; the table's (rows, values) gradient and its
    scatter-add stay f32."""
    rng = np.random.RandomState(11)
    spec = jmodels.deepfm.deepfm(**DEEPFM)
    after = _check_two_steps(_deepfm, [spec.sample_batch(16, rng)
                                       for _ in range(2)], grad_rl2=2.5e-3)
    assert after["fm_table"].dtype == np.float32
    assert not after["fm_table"][:, DEEPFM["embedding_size"] + 1:].any()
    adam_op = [o for o in tfluid.default_main_program().global_block().ops
               if o.type == "adam" and o.input("Param").name == "fm_table"][0]
    assert adam_op.attrs["_kernel_choice"] == {"kernel": "plain_scatter_add"}


def _mlp_losses(amp, steps=8):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    scope = tfluid.Scope()
    with tfluid.program_guard(main, startup), tfluid.scope_guard(scope):
        loss = _mlp(tfluid)
        opt = tfluid.optimizer.SGD(learning_rate=0.1)
        (tfluid.amp.decorate(opt) if amp else opt).minimize(loss)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        batch = _mlp_batch(np.random.RandomState(3))
        out = [float(exe.run(main, feed=batch, fetch_list=[loss])[0])
               for _ in range(steps)]
        for p in main.all_parameters():
            assert scope.get(p.name).dtype == torch.float32, p.name
    return out


def test_bf16_training_converges_close_to_f32():
    """``tests/test_amp.py``'s contract, in the port."""
    ref = _mlp_losses(amp=False)
    amp = _mlp_losses(amp=True)
    assert amp[-1] < amp[0]
    assert abs(amp[0] - ref[0]) / ref[0] < 0.05
    assert abs(amp[-1] - ref[-1]) / max(ref[-1], 1e-3) < 0.25


RESNET = dict(depth=50, class_num=10)


def test_resnet_dtype_of_every_op_matches_jax(monkeypatch):
    """The dtype of every op output of a small AMP ResNet-50 step (32 x 32,
    batch 2) equals the reference's, op by op, the reference's fused
    sites in its Pallas kernels (interpret mode): bf16 fused sites (the
    49 kernel sites and the 4 replayed ones), pools, the fc and its bias
    add, the softmax; f32 BN statistics, the CE loss and its mean,
    gradients and Adam."""
    monkeypatch.setattr(jfc, "_INTERPRET", True)
    shape = dict(RESNET, image_shape=(3, 32, 32))
    jspec = jmodels.resnet.resnet_imagenet(**shape)
    fluid.amp.decorate(fluid.optimizer.Adam(1e-3)).minimize(jspec.loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    batch = jspec.sample_batch(2, np.random.RandomState(7))
    want = _record_dtypes(monkeypatch, j_executor)
    exe.run(feed=batch, fetch_list=[jspec.loss])

    tspec = tfluid.models.resnet.resnet_imagenet(**shape)
    tfluid.amp.decorate(tfluid.optimizer.Adam(1e-3)).minimize(tspec.loss)
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(tfluid.default_startup_program())
    got = _record_dtypes(monkeypatch, t_executor)
    texe.run(feed=batch, fetch_list=[tspec.loss])

    assert got == want
    kinds = set(want.values())
    for kind in [("fused_conv2d", "bfloat16"), ("fused_conv2d", "float32"),
                 ("pool2d", "bfloat16"), ("mul", "bfloat16"),
                 ("elementwise_add", "bfloat16"), ("softmax", "bfloat16"),
                 ("softmax_with_cross_entropy", "float32"),
                 ("mean", "float32"), ("autodiff", "float32"),
                 ("adam", "float32")]:
        assert kind in kinds, kind
    assert ("adam", "bfloat16") not in kinds
    assert ("autodiff", "bfloat16") not in kinds
    choices = {op.attrs["_kernel_choice"]["kernel"]
               for op in t_executor.fused_ops(
                   tfluid.default_main_program(), [tspec.loss.name])[0]
               if op.type == "fused_conv2d"}
    assert choices == {"plain_fused_conv", "unfused_replay"}


def _resnet(pkg, models):
    return (models.resnet.resnet_imagenet(**RESNET,
                                          image_shape=(3, 64, 64)),
            pkg.optimizer.Adam(1e-4))


def _jax_float(a):
    return hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)


def _np32(a):
    """A JAX array as numpy f32 (bf16 widened), or as it is."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _to_torch(a):
    t = torch.from_numpy(_np32(a).copy())
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _forced_rows(jops, tops, env, n_fwd, seed=3):
    """Each of the first ``n_fwd`` ops once from the reference's own AMP
    values (its inputs as the reference's AMP chain computed them): the
    reference under AMP and in f32 (the floating inputs widened), the port
    under AMP, each with the VJP of a seeded random cotangent (in the AMP
    outputs' dtypes). Rows of (kind, name, |port - ref AMP|, |ref f32 -
    ref AMP|, |ref AMP|), L2 norms, for every floating output ("out") and
    every floating input's gradient ("grad")."""
    rng = np.random.RandomState(seed)
    rows = []
    for jop, top in zip(jops[:n_fwd], tops[:n_fwd]):
        assert (jop.type, jop.output_arg_names) == (top.type,
                                                     top.output_arg_names)
        ins = [n for n in jop.input_arg_names if n in env]
        fl = [n for n in ins if _jax_float(env[n])]
        outs = jop.output_arg_names
        runs = {}
        for amp in (True, False):
            base = {n: env[n] if amp or not _jax_float(env[n])
                    else env[n].astype(jnp.float32) for n in ins}

            def f(*xs, base=base):
                e = dict(base, **dict(zip(fl, xs)))
                e[j_registry.RNG_KEY] = env[j_registry.RNG_KEY]
                j_registry.run_op(e, jop)
                return [e[n] for n in outs]

            prev, j_registry.AMP.enabled = j_registry.AMP.enabled, amp
            try:
                runs[amp] = jax.vjp(f, *[base[n] for n in fl])
            finally:
                j_registry.AMP.enabled = prev
        (o_amp, vjp_amp), (o_f32, vjp_f32) = runs[True], runs[False]
        cts = [jnp.asarray(np.asarray(rng.randn(*np.shape(a)), "f4")).astype(
            a.dtype) if _jax_float(a) else np.zeros(np.shape(a),
                                                     jax.dtypes.float0)
            for a in o_amp]
        g_amp = vjp_amp(cts)
        g_f32 = vjp_f32([c.astype(b.dtype) if _jax_float(b) else c
                         for c, b in zip(cts, o_f32)])

        tenv = {t_registry.DEVICE_KEY: torch.device("cpu"),
                t_registry.RNG_KEY: torch.Generator().manual_seed(0)}
        leaves = []
        for n in ins:
            tenv[n] = _to_torch(env[n])
            if n in fl:
                leaves.append(tenv[n].requires_grad_(True))
        with t_registry.amp_scope(True):
            t_registry.run_op(tenv, top)
        pairs = [(tenv[n], _to_torch(c)) for n, c in zip(outs, cts)
                 if isinstance(tenv[n], torch.Tensor)
                 and tenv[n].requires_grad]
        t_grads = torch.autograd.grad(
            [p[0] for p in pairs], leaves, [p[1] for p in pairs],
            allow_unused=True) if pairs else [None] * len(leaves)
        for kind, names, got, want, f32 in (
                ("out", outs, [tenv[n] for n in outs], o_amp, o_f32),
                ("grad", fl, t_grads, g_amp, g_f32)):
            for n, g, w, r in zip(names, got, want, f32):
                if not _jax_float(w):
                    continue
                w = _np32(w).astype("f8")
                g = np.zeros_like(w) if g is None else \
                    g.detach().float().numpy()
                rows.append((kind, jop.type + ":" + n,
                             float(np.linalg.norm(g - w)),
                             float(np.linalg.norm(_np32(r) - w)),
                             float(np.linalg.norm(w))))
        prev, j_registry.AMP.enabled = j_registry.AMP.enabled, True
        try:
            j_registry.run_op(env, jop)  # the reference's chain goes on
        finally:
            j_registry.AMP.enabled = prev
    return rows


def test_resnet_amp_ops_match_jax_op_by_op():
    """Every forward op of an AMP ResNet-50 step (64 x 64, batch 2: the 53
    fused sites, pools, the fc, softmax and CE), each run once by the port
    on the reference's own AMP inputs, against the reference's outputs and
    the VJPs of one seeded cotangent. A whole AMP step of randomly
    initialised ResNet-50 is chaotic in bf16: scaling the parameters by
    1 + 2^-20 moves the reference's own gradients by 1.07-1.24 relative L2
    (64 x 64, batch 2 and 8) and the loss by up to 10%, as far as AMP moves
    them from f32 (1.25-1.41); every rounding flip is amplified through 53
    batch-statistic BNs. So the step is compared op by op, where no flip
    propagates: the port within FWD_RL2 / GRAD_RL2 of the reference over
    all outputs / input gradients (read 5.3e-5 and 4.2e-3), the
    reference's own AMP-vs-f32 distance outside (read 2.6e-3 and 3.2e-2)."""
    from paddle_tpu.core.epilogue_fusion import fuse_ops as j_fuse_ops

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spec, opt = _resnet(fluid, jmodels)
        fluid.amp.decorate(opt).minimize(spec.loss)
        fluid.default_startup_program().random_seed = 13
        fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
        scope = fluid.global_scope()
        jmain = fluid.default_main_program()
        env = {v.name: jnp.asarray(scope.get(v.name))
               for v in jmain.list_vars()
               if v.persistable and v.name in scope}
        feed = spec.sample_batch(2, np.random.RandomState(7))
        env.update({n: jnp.asarray(v) for n, v in feed.items()})
        env[j_registry.RNG_KEY] = jax.random.PRNGKey(0)
        jops, _ = j_fuse_ops(list(jmain.global_block().ops),
                             protected={spec.loss.name})

        tspec, topt = _resnet(tfluid, tfluid.models)
        tfluid.amp.decorate(topt).minimize(tspec.loss)
        tops, _ = t_executor.fused_ops(tfluid.default_main_program(),
                                       [tspec.loss.name])
        n_fwd = [o.type for o in jops].index("autodiff")
        assert [o.type for o in tops].index("autodiff") == n_fwd
        rows = _forced_rows(jops, tops, env, n_fwd)
    finally:
        torch.set_num_threads(threads)
    assert sum(op.type == "fused_conv2d" for op in tops[:n_fwd]) == 53
    for kind, bound in (("out", FWD_RL2), ("grad", GRAD_RL2)):
        r = [x for x in rows if x[0] == kind]
        den = np.sqrt(sum(x[4] ** 2 for x in r))
        port = np.sqrt(sum(x[2] ** 2 for x in r)) / den
        ref = np.sqrt(sum(x[3] ** 2 for x in r)) / den
        assert port < bound < ref, (kind, port, ref)


def _port_updates(tprog, state, grads):
    """The port's update ops run once on the reference's state and its
    AMP step's gradients: {name: new value} of what they write."""
    ops = [o for o in tprog.global_block().ops if o.attr("is_optimizer_op")]
    env = {t_registry.DEVICE_KEY: torch.device("cpu"),
           t_registry.RNG_KEY: torch.Generator().manual_seed(0)}
    env.update({n: torch.from_numpy(np.array(v)) for n, v in state.items()})
    env.update({n + "@GRAD": torch.from_numpy(np.array(g))
                for n, g in grads.items() if n != "loss"})
    with torch.no_grad():
        for op in ops:
            t_registry.run_op(env, op)
    return {n: env[n].numpy() for op in ops for n in op.output_arg_names}


def test_resnet_two_adam_steps_match_jax():
    """Two Adam steps of ResNet-50 at 64 x 64 (the size of
    ``test_torch_resnet.py``) under ``decorate``, the reference's default
    CPU path (its fused sites replay the unfused ops). Each step the
    reference takes its AMP step and, from the same state, its f32 step;
    the port's update ops take the reference's AMP gradients from the
    same state. The update (new parameters and Adam moments minus the
    old) within 1e-5 relative L2 of the reference's (f32 arithmetic on
    equal inputs), the f32 step's update outside a tenth (the whole-step
    gradients are chaotic, see the test above). The port's own two AMP
    steps from the same states: a finite loss, f32 parameters and moments.
    The second step starts from the reference's state after its AMP step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spec = jmodels.resnet.resnet_imagenet(**RESNET,
                                              image_shape=(3, 64, 64))
        rng = np.random.RandomState(7)
        cache, state = {}, None
        for step in range(2):
            feed = spec.sample_batch(2, rng)
            before, want, after_want = _one_step(fluid, _resnet, True, state,
                                                 feed, cache)
            _, _, after_f32 = _one_step(fluid, _resnet, False, before, feed,
                                        cache)
            _, got, after_run = _one_step(tfluid, _resnet, True, before,
                                          feed, cache)
            tprog = cache[(tfluid.__name__, True)][1]
            after_got = _port_updates(tprog, before, want)
            moved = [n for n in sorted(after_got)
                     if not np.array_equal(after_want[n], before[n])]
            assert len(moved) > 3 * 161, len(moved)  # params, m, v
            port = _rl2([after_got[n] - before[n] for n in moved],
                        [after_want[n] - before[n] for n in moved])
            ref = _rl2([after_f32[n] - before[n] for n in moved],
                       [after_want[n] - before[n] for n in moved])
            assert port < 1e-5 and ref > 0.1, ("update", step, port, ref)
            assert np.isfinite(float(got["loss"]))
            for n, v in after_run.items():
                if v.dtype.kind == "f":
                    assert v.dtype == np.float32, n
            state = after_want
    finally:
        torch.set_num_threads(threads)
