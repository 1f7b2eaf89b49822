"""The port stands alone: it imports neither ``jax`` nor ``paddle_tpu``,
its entry points default to the GPU and raise without one, and every
source compiles."""

import ast
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
