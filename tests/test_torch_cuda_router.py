"""The port's front door on the GPU: a two-worker router whose workers
serve on ``cuda:0`` answers a tiny BERT classifier as the CPU does, and a
replica the breaker evicts three times gives its captured graphs' memory
back. These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.
They import no JAX: ``python -m pytest --noconftest
tests/test_torch_cuda_router.py -q``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.reliability import faults
from paddle_tpu_torch.serving import Router, RouterClient, ServingEngine

pytestmark = pytest.mark.cuda

SEQ, VOCAB, D_MODEL, D_FF, HEADS, LAYERS = 16, 100, 32, 64, 4, 2
FEEDS = ["input_ids", "segment_ids", "input_len"]


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        L = tfluid.layers
        ids = L.data("input_ids", shape=[SEQ], dtype="int64")
        seg = L.data("segment_ids", shape=[SEQ], dtype="int64")
        n = L.data("input_len", shape=[], dtype="int64")
        x = tfluid.models.bert.bert_encoder(
            ids, seg, n, SEQ, VOCAB, D_MODEL, D_FF, HEADS, LAYERS,
            dropout_rate=0.0)
        cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
        prob = L.softmax(L.fc(L.fc(cls, size=D_MODEL, act="tanh"), size=2))
    startup.random_seed = 11
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path_factory.mktemp("bert"))
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, FEEDS, [prob], exe,
                                       main_program=main)
    return d


def _feed(rng, n):
    return {"input_ids": rng.randint(0, VOCAB, (n, SEQ)).astype("int64"),
            "segment_ids": rng.randint(0, 2, (n, SEQ)).astype("int64"),
            "input_len": rng.randint(1, SEQ + 1, (n,)).astype("int64")}


def _cpu(model_dir, feed):
    config = tfluid.inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    return tfluid.inference.Predictor(config).run(feed)[0]


def test_two_card_workers_answer_as_the_cpu(bert_dir):
    feed = _feed(np.random.RandomState(0), 3)
    router = Router(bert_dir, num_workers=2,
                    worker_args=["--warmup", "--ladder", "1,2,4"])
    try:
        router.start()
        client = RouterClient(router.address)
        got, = client.predict(feed, timeout_s=120.0)
        client.close()
    finally:
        router.shutdown()
    np.testing.assert_allclose(got, _cpu(bert_dir, feed), atol=1e-4,
                               rtol=0)
    for w in router._workers:
        assert w.ready[0]["device"] == "cuda:0"
        assert w.exits[-1]["device"] == "cuda:0"
        # the warmup interpreted and captured each rung: 2 LayerNorm
        # forward launches a layer and 1 for the embeddings, per run
        report = w.exits[-1]
        launching = report["runs"]["interpreted"] + report["runs"]["captures"]
        assert report["launches"]["layer_norm_fwd"] == \
            (2 * LAYERS + 1) * launching
        assert report["launches"]["flash_attention_fwd"] == \
            LAYERS * launching


def test_evicted_replicas_give_their_graphs_back(bert_dir):
    """Rounds of three breaker evictions (``predictor.run`` fails 9 times
    a round): each evicted predictor is closed and its rebuilt successor
    takes over its side stream, so once the rebuilt replica has captured
    its rungs again the card holds what it held before: one replica's
    graphs, give or take one, and at most one cuBLAS workspace (32 MiB on
    Hopper) more after the first round, none more after the second."""
    feed = _feed(np.random.RandomState(1), 2)
    eng = ServingEngine(bert_dir, ladder=(1, 2), max_wait_ms=0,
                        max_replica_failures=3)

    def settled():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    try:
        eng.warmup()
        want, = eng.predict(feed, timeout_s=60.0)
        pred = eng._workers[0].predictor
        pool = sum(e.pool_bytes or 0 for e in pred._exe._cache.values())
        assert pool > 0
        reserved = [settled()]
        for round_no in (1, 2):
            with faults.fault_scope(faults.FaultPlan.from_spec(
                    "predictor.run:error@1-9")):
                for _ in range(8):
                    try:
                        eng.predict(feed, timeout_s=60.0)
                    except faults.InjectedFault:
                        pass
            assert eng.metrics()["replicas_evicted"] == 3 * round_no
            eng.warmup()
            got, = eng.predict(feed, timeout_s=60.0)
            np.testing.assert_array_equal(got, want)
            reserved.append(settled())
    finally:
        eng.shutdown()
    before, first, second = reserved
    assert first <= before + pool + (32 << 20), (reserved, pool)
    assert second <= first + pool, (reserved, pool)
