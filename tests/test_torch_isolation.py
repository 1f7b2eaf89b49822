"""The port stands alone: it imports neither ``jax`` nor ``paddle_tpu``,
its entry points default to the GPU and raise without one, and every
source compiles."""

import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_importing_every_module_pulls_in_neither_jax_nor_paddle_tpu():
    code = (
        "import pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_source_imports_jax_or_paddle_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "paddle_tpu"), \
                "%s imports %s" % (path, n)


# the data, checkpoint and streaming plane: each module exists, imports in
# a fresh interpreter, and pulls in neither jax nor paddle_tpu
PLANE_MODULES = ["checkpoint", "native", "async_executor", "data",
                 "data.common", "data.data_feed", "data.datasets",
                 "data.feeder", "data.py_reader", "data.reader", "streaming",
                 "streaming.stream", "streaming.trainer",
                 "streaming.publisher", "streaming.coordinator"]


@pytest.mark.parametrize("module", PLANE_MODULES)
def test_plane_module_is_covered(module):
    mod = importlib.import_module("paddle_tpu_torch." + module)
    assert mod.__file__ in set(_sources())
    test_no_source_imports_jax_or_paddle_tpu(mod.__file__)


def test_plane_modules_alone_pull_in_neither_jax_nor_paddle_tpu():
    code = (
        "import importlib, sys\n"
        "for m in %r:\n"
        "    importlib.import_module('paddle_tpu_torch.' + m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (PLANE_MODULES,))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_eight_top_level_names_resolve():
    import paddle_tpu as ref

    for name in ("AsyncExecutor", "DataFeedDesc", "DataFeeder",
                 "async_executor", "checkpoint", "data", "native",
                 "streaming"):
        assert hasattr(ref, name) and hasattr(tfluid, name), name
    assert tfluid.async_executor.AsyncExecutor is tfluid.AsyncExecutor
    assert tfluid.data.DataFeeder is tfluid.DataFeeder


# the imperative mode, its BERT and the quantization / slim toolkit (A8,
# A9): each module exists, imports alone, and pulls in neither
DYGRAPH_MODULES = ["dygraph", "dygraph.base", "dygraph.layers", "dygraph.nn",
                   "dygraph.optimizer", "dygraph.capture",
                   "models.bert_dygraph", "core.opimpl.quant_ops",
                   "contrib", "contrib.quantize",
                   "contrib.quantize.quantize_transpiler", "contrib.slim",
                   "contrib.slim.prune", "contrib.slim.distill"]


@pytest.mark.parametrize("module", DYGRAPH_MODULES)
def test_dygraph_module_is_covered(module):
    mod = importlib.import_module("paddle_tpu_torch." + module)
    assert mod.__file__ in set(_sources())
    test_no_source_imports_jax_or_paddle_tpu(mod.__file__)


def test_dygraph_modules_alone_pull_in_neither_jax_nor_paddle_tpu():
    code = (
        "import importlib, sys\n"
        "for m in %r:\n"
        "    importlib.import_module('paddle_tpu_torch.' + m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (DYGRAPH_MODULES,))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_dygraph_and_contrib_resolve_with_the_reference_names():
    """``fluid.dygraph`` and ``fluid.contrib`` (and their modules) carry
    every public name of the reference's; 11 top-level names remain
    missing (A7's and the TPU-only ones)."""
    import paddle_tpu as ref

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    no_jax = {"jax", "jnp", "np"}  # the modules each imports
    for name in ("dygraph", "dygraph.base", "dygraph.layers",
                 "dygraph.nn", "dygraph.optimizer", "contrib",
                 "contrib.quantize", "contrib.slim",
                 "contrib.quantize.quantize_transpiler"):
        want = importlib.import_module("paddle_tpu." + name)
        got = importlib.import_module("paddle_tpu_torch." + name)
        missing = public(want) - public(got) - no_jax
        assert not missing, (name, missing)
    assert set(ref.dygraph.nn.__all__) == set(tfluid.dygraph.nn.__all__)
    assert tfluid.dygraph.nn.Linear is tfluid.dygraph.nn.FC
    assert public(ref) - public(tfluid) == {
        "BuildStrategy", "CompiledProgram", "ExecutionStrategy", "TPUPlace",
        "XLAPlace", "debugger", "distributed", "dlpack", "parallel",
        "profiler", "version"}


def test_dygraph_entry_points_default_to_cuda(monkeypatch):
    """Outside a ``guard(place)`` new parameters and variables go to
    ``CUDAPlace(0)``, which raises without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.dygraph.to_variable(np.ones(2, "f4"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.dygraph.nn.LayerNorm(normalized_shape=4)
    with tfluid.dygraph.guard(tfluid.CPUPlace()):
        v = tfluid.dygraph.to_variable(np.ones(2, "f4"))
    assert v.value().device.type == "cpu"


def test_package_compiles():
    r = subprocess.run([sys.executable, "-m", "compileall", "-q", PKG],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev_main = t_framework.switch_main_program(t_framework.Program())
    prev_startup = t_framework.switch_startup_program(t_framework.Program())
    old_gen = t_unique_name.switch()
    t_executor._scope_stack.append(t_executor.Scope())
    yield
    t_executor._scope_stack.pop()
    t_unique_name.switch(old_gen)
    t_framework.switch_main_program(prev_main)
    t_framework.switch_startup_program(prev_startup)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                           tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor(tfluid.CUDAPlace(0))

    # a model saved on the CPU ...
    x = tfluid.layers.data("x", shape=[4])
    y = tfluid.layers.fc(x, size=3, act="relu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    model_dir = str(tmp_path / "mlp")
    tfluid.io.save_inference_model(model_dir, ["x"], [y], exe)

    # ... is served on the GPU unless the CPU is asked for
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.inference.Predictor(model_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.serving.ServingEngine(model_dir)
    engine = tfluid.serving.ServingEngine(model_dir, device="cpu")
    try:
        out, = engine.predict({"x": np.ones((2, 4), "f4")}, timeout_s=30)
    finally:
        engine.shutdown()
    assert out.shape == (2, 3)
