"""Attention seq2seq NMT (``models.machine_translation``) in the port
against ``paddle_tpu`` on the CPU, at the size of the reference's serving
test (vocabulary 23, sequence 6, embeddings and GRUs 8 wide, beam 2,
4 decode steps).

Each package builds the three programs in one scope: the train program
(``seq2seq_attention`` + Adam), the beam program
(``seq2seq_attention_infer``) and the greedy program
(``seq2seq_attention_greedy_infer``), which share the ``mt_*``
parameters by name. The reference initialises; ``bridge.load_numpy_params``
copies its parameters into the port. The reference's flash attention runs
its Pallas kernels in interpret mode.

* Train: the loss and every gradient within atol 2e-5 / rtol 1e-4, the
  parameters after one Adam step within 1e-4 / 1e-4 (the bounds of
  ``test_torch_training.py``: f32 sums in different orders; Adam moves a
  parameter by a share of its rate where a gradient is within rounding of
  zero).
* Beam and greedy decode, under the near-tie rule of
  ``chip_smoke.near_tie_verdict`` (the card's decode check): on the
  reference side a hook on ``beam_search_step`` records each step's
  margin, the gap between a row's K-th and (K+1)-th best extensions;
  where it is below MARGIN_TOL + 1e-5 x |score| the two sides may keep
  different candidates. Per row, the beams each step kept (as a set of token
  prefixes) agree at every step before the row's first near tie; a row
  with no near tie also decodes the same sentences, its scores within
  the same bound. Fewer than half the rows may meet a near tie.
* ``ServingEngine`` over a ``ProgramPredictor`` of the beam program: a
  request served alone and the same request batched with three others,
  both at rung 4, give bitwise equal ids and scores.
* ``capture_rule`` declines the beam program for its ``while_block``
  (the loop condition is read on the host) and admits the train program.
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu.core.op_registry as jreg
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from test_torch_optimizers import fresh_port_programs  # noqa: F401
from test_torch_training import TOL, pallas_interpret  # noqa: F401

KW = dict(src_vocab=23, trg_vocab=23, seq_len=6, emb_dim=8, hid_dim=8)
BEAM, MAX_OUT = 2, 4
LENS = np.array([6, 4, 5, 3], "int64")
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
# candidates closer than this may swap between two f32 implementations,
# and the scores of whole sentences agree within it
MARGIN_TOL = 1e-4


def _build(pkg):
    """(train main, train startup, train spec, beam (ids, scores), greedy
    (ids, scores), beam program, greedy program), built in fresh programs
    with fresh names each."""
    mt = pkg.models.machine_translation
    tm, ts = pkg.Program(), pkg.Program()
    tm.random_seed = ts.random_seed = 13
    with pkg.program_guard(tm, ts):
        pkg.unique_name.switch()
        spec = mt.seq2seq_attention(**KW)
        pkg.optimizer.Adam(1e-2).minimize(spec.loss)
    im = pkg.Program()
    with pkg.program_guard(im, pkg.Program()):
        pkg.unique_name.switch()
        beam = mt.seq2seq_attention_infer(beam_size=BEAM,
                                          max_out_len=MAX_OUT, **KW)
    gm = pkg.Program()
    with pkg.program_guard(gm, pkg.Program()):
        pkg.unique_name.switch()
        greedy = mt.seq2seq_attention_greedy_infer(max_out_len=MAX_OUT, **KW)
    return tm, ts, spec, beam, greedy, im, gm


def _decode_fetches(program, outs):
    """The outputs and the recorded arrays of ``beam_search_decode``: its
    IdsArray, ParentsArray and FinalScores."""
    op = next(o for o in program.global_block().ops
              if o.type == "beam_search_decode")
    return list(outs) + [op.input(s).name for s in ("IdsArray",
                                                    "ParentsArray")]


def _feed():
    rng = np.random.RandomState(1)
    return {"src_ids": rng.randint(2, 23, (4, 6)).astype("int64"),
            "src_len": LENS}


@pytest.fixture
def margins(monkeypatch):
    """The reference's beam_search_step, recording each step's [B]
    margins (the gap between a row's K-th and (K+1)-th best extensions,
    |the K-th's score|) through a host callback, in step order."""
    import jax
    import jax.numpy as jnp

    steps = []
    impl = jreg.OP_IMPLS["beam_search_step"]

    def hooked(env, op):
        impl(env, op)
        pre_ids = env[op.input("PreIds").name]
        pre_scores = env[op.input("PreScores").name]
        scores = env[op.input("Scores").name]
        b, k, v = scores.shape
        end_id = op.attr("end_id")
        end_row = jnp.where(jnp.arange(v) == end_id, 0.0, -1e9)
        cont = jnp.where((pre_ids == end_id)[..., None], end_row, scores)
        flat = (pre_scores[..., None] + cont).reshape(b, k * v)
        top, _ = jax.lax.top_k(flat, k + 1)
        jax.debug.callback(
            lambda gap, kth: steps.append((np.asarray(gap), np.asarray(kth))),
            top[:, k - 1] - top[:, k], jnp.abs(top[:, k - 1]), ordered=True)

    monkeypatch.setitem(jreg.OP_IMPLS, "beam_search_step", hooked)
    return steps


def _reference(margins):
    """The reference's initial parameters, its beam and greedy decodes
    (with their margins) and its train step (loss + grads, parameters
    after it)."""
    tm, ts, spec, beam, greedy, im, gm = _build(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    names = sorted(p.name for p in tm.all_parameters())
    feed = _feed()
    with fluid.scope_guard(scope):
        exe.run(ts)
        params = {n: np.asarray(scope.get(n)) for n in names}
        out = {"params": params}
        for key, prog, outs in (("beam", im, beam), ("greedy", gm, greedy)):
            del margins[:]
            out[key] = exe.run(prog, feed=feed,
                               fetch_list=_decode_fetches(prog, outs))
            out[key + "_margins"] = list(margins)
        batch = _train_batch(spec)
        gb = tm.global_block()
        out["step"] = exe.run(tm, feed=batch, fetch_list=[spec.loss] + [
            gb.var(n + "@GRAD") for n in names])
        out["after"] = {n: np.asarray(scope.get(n)) for n in names}
    return out


def _train_batch(spec):
    batch = spec.sample_batch(4, np.random.RandomState(5))
    batch["src_len"] = LENS
    batch["trg_len"] = np.array([5, 6, 2, 4], "int64")
    return batch


_CACHE = {}


@pytest.fixture
def reference(pallas_interpret, margins):
    """:func:`_reference`, computed once per module (each xdist worker
    takes a whole file)."""
    if "ref" not in _CACHE:
        _CACHE["ref"] = _reference(margins)
    return _CACHE["ref"]


def _port(params):
    """The port's programs in one CPU scope holding the reference's
    parameters (its startup run fills the Adam state)."""
    tm, ts, spec, beam, greedy, im, gm = _build(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    tfluid.bridge.load_numpy_params(scope, params, device="cpu", program=tm)
    return dict(tm=tm, spec=spec, beam=beam, greedy=greedy, im=im, gm=gm,
                scope=scope, exe=exe)


def test_train_step_matches_reference(reference):
    port = _port(reference["params"])
    names = sorted(reference["params"])
    gb = port["tm"].global_block()
    got = port["exe"].run(port["tm"], feed=_train_batch(port["spec"]),
                          fetch_list=[port["spec"].loss] + [
                              gb.var(n + "@GRAD") for n in names],
                          scope=port["scope"])
    for name, g, w in zip(["loss"] + names, got, reference["step"]):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    for n in names:
        np.testing.assert_allclose(port["scope"].numpy(n),
                                   reference["after"][n], err_msg=n,
                                   **PARAM_TOL)
    choice = next(op for op in gb.ops if op.type == "flash_attention")
    assert choice.attr("_kernel_choice")["kernel"] == "plain"


def test_beam_and_greedy_decode_match_reference(reference):
    port = _port(reference["params"])
    feed = _feed()
    tied = 0
    for key, prog, outs in (("beam", port["im"], port["beam"]),
                            ("greedy", port["gm"], port["greedy"])):
        got = port["exe"].run(prog, feed=feed,
                              fetch_list=_decode_fetches(prog, outs),
                              scope=port["scope"])
        k = BEAM if key == "beam" else 1
        shape = (4, k, MAX_OUT) if key == "beam" else (4, MAX_OUT)
        assert got[0].shape == shape and got[1].shape == shape[:-1]
        assert got[2].shape == (MAX_OUT, 4, k) == got[3].shape
        want = reference[key]
        if key == "greedy":  # rows of one beam: the rule's [B, K] layout
            got = [got[0][:, None], got[1][:, None]] + got[2:]
            want = [want[0][:, None], want[1][:, None]] + want[2:]
        verdict = chip_smoke.near_tie_verdict(
            got, want, reference[key + "_margins"], MARGIN_TOL)
        assert verdict["ok"], (key, verdict)
        tied += verdict["near_tie_rows"]
    assert tied < 4, "%d of 8 decoded rows met a near tie" % tied


def test_beam_serving_solo_equals_batched(reference):
    port = _port(reference["params"])
    pred = tfluid.inference.ProgramPredictor(
        port["im"], ["src_ids", "src_len"], list(port["beam"]),
        scope=port["scope"], place=tfluid.CPUPlace())
    feed = _feed()
    eng = tfluid.serving.ServingEngine(pred, num_replicas=1, ladder=(4,),
                                       max_wait_ms=50, max_queue_depth=64)
    try:
        solo = eng.submit({k: v[:1] for k, v in feed.items()}).result(60.0)
        futs = [eng.submit({k: v[i:i + 1] for k, v in feed.items()})
                for i in range(4)]
        got = [f.result(60.0) for f in futs]
    finally:
        eng.shutdown()
    assert solo[0].shape == (1, BEAM, MAX_OUT)
    np.testing.assert_array_equal(solo[0], got[0][0])
    np.testing.assert_array_equal(solo[1], got[0][1])


def test_capture_rule_declines_while_and_admits_train():
    tm, _, _, _, _, im, _ = _build(tfluid)
    persist = {v.name for v in tm.list_vars() if v.persistable}
    train_ops = t_executor.step_plan(tm, (), False)[0]
    assert t_executor.capture_rule(
        train_ops, t_executor.state_writes(train_ops, persist)) == \
        (True, "admitted")
    assert "while_block" not in [op.type for op in train_ops]
    captured, reason = t_executor.capture_rule(
        t_executor.step_plan(im, (), False)[0], donate_state=False)
    assert not captured
    assert reason.startswith("op 'while_block': reads its loop condition "
                             "on the host"), reason
