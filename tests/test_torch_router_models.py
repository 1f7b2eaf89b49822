"""The port's front door is model-agnostic: the worker builtins
``mt_greedy`` (the NMT greedy While-loop decoder) and ``lm_decode`` (a
KV-cache decode step served by continuous batching) answer through the
router exactly as the same model answers in process; and a ``--smoke``
run of each port chaos tool on the CPU ends ``ok``.

These tests check the transport, not parity with the reference: each
builtin's weights come from a seed inside the worker, so no JAX answer on
the same inputs exists here. The builtin models' parity with
``paddle_tpu`` rests on the earlier tests of the same models:
``tests/test_torch_nmt.py::test_beam_and_greedy_decode_match_reference``
(the NMT greedy decoder) and ``tests/test_torch_decode.py`` (the
KV-cached ``transformer_lm`` step and chunk programs and their greedy
ids); BERT through the router against the JAX ``Predictor`` is in
``tests/test_torch_router.py``."""

import json

import numpy as np

from paddle_tpu_torch.serving import Router, RouterClient, ServingEngine
from paddle_tpu_torch.serving.worker import build_model
from paddle_tpu_torch.tools import chaos_decode, chaos_router

CPU = ["--device", "cpu"]


def _in_process(spec, feeds, **kw):
    """The builtin ``spec`` served by an in-process engine on the CPU."""
    model = build_model(spec, "cpu")
    decode = getattr(model, "_decode_spec", None)
    if decode is not None:
        kw.update(decode=decode, decode_prefill=model._decode_prefill)
    eng = ServingEngine(model, ladder=(1, 2, 4, 8), max_wait_ms=2.0, **kw)
    try:
        return [eng.predict(f, timeout_s=120.0) for f in feeds]
    finally:
        eng.shutdown()


def test_mt_greedy_builtin_through_the_router():
    rng = np.random.RandomState(0)
    feeds = [{"src_ids": rng.randint(2, 32, (n, 6)).astype("int64"),
              "src_len": rng.randint(1, 7, (n,)).astype("int64")}
             for n in (1, 2, 3)]
    want = _in_process("builtin:mt_greedy", feeds)
    router = Router("builtin:mt_greedy", num_workers=1, worker_args=CPU,
                    heartbeat_interval_s=0.5)
    try:
        router.start()
        client = RouterClient(router.address)
        for f, w in zip(feeds, want):
            ids, scores = client.predict(f, timeout_s=120.0,
                                         key="mt-session")
            assert ids.shape[0] == f["src_ids"].shape[0] and \
                scores.shape == (f["src_ids"].shape[0],)
            np.testing.assert_array_equal(ids, w[0])
            np.testing.assert_array_equal(scores, w[1])
        client.close()
    finally:
        router.shutdown()


def test_lm_decode_builtin_through_the_router():
    prompts = [[5, 7, 11, 13, 2], [3, 1], [5, 7, 11, 13, 2, 9, 4]]
    want = [list(ids) for ids in _in_process(
        "builtin:lm_decode", [{"prompt_ids": p} for p in prompts],
        default_max_new_tokens=5)]
    router = Router("builtin:lm_decode", num_workers=1, worker_args=CPU,
                    heartbeat_interval_s=0.5,
                    worker_env={"PADDLE_TPU_DECODE_MAX_NEW": "5"})
    try:
        router.start()
        client = RouterClient(router.address, pool_size=4)
        futs = [client.submit({"prompt_ids": np.asarray(p, "int64")},
                              timeout_s=120.0) for p in prompts]
        got = [list(f.result(150.0)[0]) for f in futs]
        assert got == want and all(len(g) == 5 for g in got)
        # max_new_tokens rides the header per request
        out, = client.predict({"prompt_ids": np.asarray(prompts[0],
                                                        "int64")},
                              timeout_s=120.0, max_new_tokens=2)
        assert list(out) == want[0][:2]
        client.close()
    finally:
        router.shutdown()
    exit_report = router._workers[0].exits[-1]
    assert exit_report["device"] == "cpu"
    assert exit_report["decode_steps"] > 0 and exit_report["served"] == 4


def test_chaos_router_smoke(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT", str(tmp_path))
    rc = chaos_router.main(["--smoke", "--device", "cpu", "--flight-dir",
                            str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["verdict"] == "ok", summary
    assert summary["completed"] == 8 and summary["silent_losses"] == 0
    assert summary["flight"]["outcome_events"] == 8


def test_chaos_decode_smoke(capsys):
    rc = chaos_decode.main(["--smoke", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["verdict"] == "ok", summary
    assert summary["respawns"] >= 1 and summary["prefix_hits"] > 0
    assert summary["burst_mismatches"] == 0 and summary["silent_losses"] == 0
