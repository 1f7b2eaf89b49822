"""The port's CUDA kernels against their plain versions, on the GPU.

These tests need an NVIDIA GPU (Hopper: the kernels are built for sm_90a)
and ``nvcc``; elsewhere they skip. They import no JAX, so on a machine
without it run them past the suite's conftest:
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_layer_norm as tfln

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(gen, b, t, tk, h, d, dev, dtype):
    def mk(n):
        return torch.randn(b, n, h * d, generator=gen).to(dev, dtype)
    return mk(t), mk(tk), mk(tk)


FLASH_CASES = [
    # (B, Tq, Tk, H, D, causal, bias form)
    (2, 128, 128, 4, 64, False, "key4"),
    (3, 96, 96, 2, 64, False, "key1"),  # one bias row broadcast over B
    (2, 100, 100, 3, 64, False, "key2"),
    (2, 128, 128, 2, 128, True, None),
    (2, 64, 128, 2, 32, True, "key4"),
    (2, 128, 64, 2, 64, True, None),
    (1, 200, 77, 2, 32, False, None),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,tk,h,d,causal,bias_form", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, tol, b, t, tk, h, d, causal,
                                    bias_form):
    gen = torch.Generator().manual_seed(7)
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, dtype)
    bias = None
    if bias_form is not None:
        lengths = torch.randint(1, tk + 1, (b,), generator=gen)
        bias = torch.where(torch.arange(tk)[None] < lengths[:, None], 0.0,
                           -1e9).to(dev)
        if bias_form == "key4":
            bias = bias[:, None, None, :]
        elif bias_form == "key1":
            bias = bias[:1, None, None, :]
    before = tfa.flash_attention_fwd.launches
    out = tfa.flash_attention(q, k, v, h, bias=bias, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    want, _ = tfa.attention_plain(q.float(), k.float(), v.float(), h,
                                  bias=bias, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - want).abs().max().item()
    assert err <= tol, err


def test_flash_kernel_lse_and_strided_inputs(dev):
    """q/k/v as column slices of one packed [B, T, 3*H*D] tensor (row
    stride 3*H*D) need no copy; lse matches logsumexp of the logits."""
    gen = torch.Generator().manual_seed(3)
    b, t, h, d = 2, 96, 4, 64
    qkv = torch.randn(b, t, 3 * h * d, generator=gen).to(dev)
    q, k, v = qkv.split(h * d, dim=-1)
    assert q.stride(1) == 3 * h * d
    out, lse = tfa.flash_attention_fwd(q, k, v, h, causal=True)
    want, want_lse = tfa.attention_plain(q, k, v, h, causal=True)
    assert (out - want).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("rows", [1024, 1000, 3])
@pytest.mark.parametrize("affine", [(True, True), (False, True),
                                    (True, False), (False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(dev, rows, affine, dtype):
    """f32: y within 1e-5. bf16: y is rounded once to bf16, so within one
    bf16 ulp (2^-8 relative, at least 2^-8 absolute)."""
    gen = torch.Generator().manual_seed(5)
    d = 768
    x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev, dtype)
    g = torch.randn(d, generator=gen).to(dev) if affine[0] else None
    bb = torch.randn(d, generator=gen).to(dev) if affine[1] else None
    y, mean, var = tfln.fused_layer_norm(x, g, bb, 1e-5)
    wy, wm, wv = tfln.layer_norm_plain(x.float(), g, bb, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * wy.abs().clamp_min(
        1.0)
    assert bool(((y.float() - wy).abs() <= tol).all())
    assert (mean - wm).abs().max().item() <= 1e-5
    assert (var - wv).abs().max().item() <= 1e-4


@pytest.fixture
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


def test_tiny_bert_on_gpu_matches_cpu_and_launches_kernels(
        dev, fresh_port_programs, tmp_path):
    seq, vocab = 16, 100
    L = tfluid.layers
    ids = L.data("input_ids", shape=[seq], dtype="int64")
    seg = L.data("segment_ids", shape=[seq], dtype="int64")
    lens = L.data("input_len", shape=[], dtype="int64")
    x = tfluid.models.bert.bert_encoder(ids, seg, lens, seq, vocab, 128, 256,
                                        2, 2, dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    prob = L.softmax(L.fc(L.fc(cls, size=128, act="tanh"), size=2))
    tfluid.default_startup_program().random_seed = 11
    exe = tfluid.Executor()  # the default place: CUDAPlace(0)
    exe.run(tfluid.default_startup_program())
    model_dir = str(tmp_path / "m")
    tfluid.io.save_inference_model(
        model_dir, ["input_ids", "segment_ids", "input_len"], [prob], exe)
    gpu = tfluid.inference.Predictor(model_dir)
    config = tfluid.inference.AnalysisConfig(model_dir)
    config.disable_gpu()
    cpu = tfluid.inference.Predictor(config)
    rng = np.random.RandomState(0)
    feed = {"input_ids": rng.randint(0, vocab, (3, seq)),
            "segment_ids": rng.randint(0, 2, (3, seq)),
            "input_len": rng.randint(1, seq + 1, (3,))}
    n_flash = tfa.flash_attention_fwd.launches
    n_ln = tfln.layer_norm_fwd.launches
    got, = gpu.run(feed)
    assert tfa.flash_attention_fwd.launches - n_flash == 2  # 2 layers
    assert tfln.layer_norm_fwd.launches - n_ln == 5  # 2 per layer + embed
    want, = cpu.run(feed)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
