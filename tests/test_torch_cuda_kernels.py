"""The port's CUDA kernels against their plain versions, on the GPU.

These tests need an NVIDIA GPU (Hopper: the kernels are built for sm_90a)
and ``nvcc``; elsewhere they skip. They import no JAX, so on a machine
without it run them past the suite's conftest:
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import framework as t_framework
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_ce as tfce
from paddle_tpu_torch.ops import fused_conv as tfc
from paddle_tpu_torch.ops import fused_layer_norm as tfln
from paddle_tpu_torch.ops import scatter as tscatter

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


# the rich biases the kernels read by strides: one offset per (b, h, t, j),
# per (t, j) broadcast over b and h, per (h, j)
RICH_BIAS = {"full": lambda b, h, t, tk: (b, h, t, tk),
             "rows": lambda b, h, t, tk: (1, 1, t, tk),
             "head": lambda b, h, t, tk: (1, h, 1, tk)}


def _bias(gen, form, b, h, t, tk, dev):
    """None, a rich bias (``RICH_BIAS``) or a key padding mask: ``key``
    [B, Tk], ``key4`` [B, 1, 1, Tk], ``key1`` [1, Tk] (``+grad`` suffixes
    are the caller's)."""
    if form is None:
        return None
    form = form.split("+")[0]
    if form in RICH_BIAS:
        shape = RICH_BIAS[form](b, h, t, tk)
        return torch.randn(*shape, generator=gen).to(dev)
    lengths = torch.randint(1, tk + 1, (b,), generator=gen)
    bias = torch.where(torch.arange(tk)[None] < lengths[:, None], 0.0,
                       -1e9).to(dev)
    if form == "key4":
        return bias[:, None, None, :]
    return bias[:1] if form == "key1" else bias


FLASH_CASES = [
    # (B, Tq, Tk, H, D, causal, bias form)
    (2, 128, 128, 4, 64, False, "key4"),
    (3, 96, 96, 2, 64, False, "key1"),  # one bias row broadcast over B
    (2, 100, 100, 3, 64, False, "key2"),
    (2, 128, 128, 2, 128, True, None),
    (2, 64, 128, 2, 32, True, "key4"),
    (2, 128, 64, 2, 64, True, None),
    (1, 200, 77, 2, 32, False, None),
    # every head dim a multiple of 8 up to 512 (8, 16, 40 and 256 run on
    # widths 16, 16, 64 and 256 with zero-filled columns); T = 65 and 129
    # cross a 64-row tile by one
    (2, 65, 65, 2, 8, False, "key4"),
    (2, 129, 129, 2, 16, True, None),
    (2, 64, 129, 2, 16, True, "key2"),   # causal, Tq < Tk
    (2, 129, 64, 2, 16, True, None),     # causal, Tq > Tk
    (2, 65, 100, 3, 40, False, "key4"),
    (1, 70, 70, 2, 256, True, "key2"),
    (1, 129, 65, 2, 512, False, "key4"),
    (2, 96, 96, 1, 512, True, None),
    # enough rows for the 64-row blocks (two or more an SM)
    (16, 200, 200, 8, 64, False, "key4"),
    (16, 129, 129, 16, 16, True, None),
    (32, 65, 65, 12, 32, False, "key2"),
    # rich biases and head dims that are not multiples of 8 (padded by the
    # wrapper), which the reference's gate sends to mha_reference
    (2, 65, 100, 3, 12, False, "full"),
    (2, 129, 129, 2, 64, True, "rows"),
    (1, 70, 70, 2, 256, False, "head"),
    (2, 96, 96, 2, 20, True, None),
    (1, 64, 64, 2, 3, False, "full"),
    (16, 200, 200, 8, 64, True, "full"),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,tk,h,d,causal,bias_form", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, tol, b, t, tk, h, d, causal,
                                    bias_form):
    gen = torch.Generator().manual_seed(7)
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, dtype)
    bias = _bias(gen, bias_form, b, h, t, tk, dev)
    if bias_form == "key1":
        bias = bias[:, None, None, :]
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_fwd.bf16_launches)
    out = tfa.flash_attention(q, k, v, h, bias=bias, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_fwd.bf16_launches) == (
        before[0] + 1, before[1] + (dtype == torch.bfloat16))
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


@pytest.mark.parametrize("d", [1, 3, 37, 512, 768, 1000, 4096, 5000])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_layer_norm_kernel_widths(dev, d, affine, dtype, aligned):
    """Every instantiation family of the forward (``ln_fwd_plan``):
    16-byte register-resident, single-element, looped, and an x one
    element past a 16-byte boundary; the tolerances of the test above."""
    gen = torch.Generator().manual_seed(8)
    rows = 1000
    x = (torch.randn(rows * d + 1, generator=gen) * 2 + 0.5).to(dev, dtype)
    x = (x[:-1] if aligned else x[1:]).view(rows, d)
    g = torch.randn(d, generator=gen).to(dev) if affine else None
    bb = torch.randn(d, generator=gen).to(dev) if affine else None
    y, mean, var = tfln.fused_layer_norm(x, g, bb, 1e-5)
    wy, wm, wv = tfln.layer_norm_plain(x.float(), g, bb, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * wy.abs().clamp_min(
        1.0)
    assert bool(((y.float() - wy).abs() <= tol).all())
    assert (mean - wm).abs().max().item() <= 1e-5
    assert (var - wv).abs().max().item() <= 1e-4


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_at_the_trained_shape(dev, monkeypatch, affine,
                                                dtype):
    """Transformer-base's [32768, 512], which a training step normalises
    32 times: the launch runs under ``ln_fwd_plan``'s plan for that shape
    (the one ``chip_smoke.py`` times), and y, mean and var keep the
    tolerances above."""
    gen = torch.Generator().manual_seed(9)
    rows, d = 32768, 512
    x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev, dtype)
    g = torch.randn(d, generator=gen).to(dev) if affine else None
    bb = torch.randn(d, generator=gen).to(dev) if affine else None
    planned = []
    plan_fn = tfln.ln_fwd_plan
    monkeypatch.setattr(tfln, "ln_fwd_plan",
                        lambda *a: planned.append(plan_fn(*a)) or planned[-1])
    y, mean, var = tfln.layer_norm_fwd(x, g, bb, 1e-5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert planned == [plan_fn(rows, d, dtype, sms)]
    assert planned[0].vpl > 0 and planned[0].vec == 16 // x.element_size()
    wy, wm, wv = tfln.layer_norm_plain(x.float(), g, bb, 1e-5)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * wy.abs().clamp_min(
        1.0)
    assert bool(((y.float() - wy).abs() <= tol).all())
    assert (mean - wm).abs().max().item() <= 1e-5
    assert (var - wv).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [3, 768, 5000])
def test_layer_norm_kernel_tracks_f64_on_a_large_mean(dev, d):
    """f32 rows whose mean is large against their spread (100 + 0.01 x
    noise): the kernel's statistics of the row shifted by its first
    element keep y within 2e-6 x max(1, |x_hat * gamma| + |beta|) of an
    f64 LayerNorm of the same inputs in every form (single-element at 3,
    register-resident at 768, looped at 5000), where unshifted f32
    statistics lose the mean's rounding times rstd (about 100)."""
    gen = torch.Generator().manual_seed(10)
    x = (100.0 + 0.01 * torch.randn(512, d, generator=gen)).to(dev)
    g = torch.randn(d, generator=gen).to(dev)
    bb = torch.randn(d, generator=gen).to(dev)
    y, mean, var = tfln.layer_norm_fwd(x, g, bb, 1e-5)
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    vd = ((xd - mu) ** 2).mean(-1, keepdim=True)
    scaled = (xd - mu) * torch.rsqrt(vd + 1e-5) * g.double()
    want = scaled + bb.double()
    torch.cuda.synchronize()
    tol = 2e-6 * (scaled.abs() + bb.double().abs()).clamp_min(1.0)
    assert bool(((y.double() - want).abs() <= tol).all())
    assert (mean.double() - mu.squeeze(-1)).abs().max().item() <= 1e-4
    assert (var.double() - vd.squeeze(-1)).abs().max().item() <= 1e-7


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


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


GRAD_CASES = [
    # (B, Tq, Tk, H, D, causal, bias form, dropout rate)
    (2, 128, 128, 4, 64, False, "key+grad", 0.0),
    (2, 128, 128, 4, 64, True, None, 0.1),
    (2, 64, 128, 2, 32, True, "key", 0.0),
    (2, 128, 64, 2, 64, True, None, 0.0),   # rows with no allowed key
    (1, 100, 77, 2, 128, False, "key1+grad", 0.2),
    (2, 65, 65, 2, 8, False, "key+grad", 0.0),
    (2, 129, 129, 2, 16, True, None, 0.0),
    (2, 64, 129, 2, 16, True, "key", 0.0),   # causal, Tq < Tk
    (2, 129, 64, 2, 16, True, None, 0.0),    # causal, Tq > Tk
    (2, 100, 100, 3, 40, False, "key+grad", 0.1),  # dropout at D = 40
    (1, 70, 70, 2, 256, True, "key", 0.1),
    (1, 129, 65, 2, 512, False, "key1+grad", 0.0),
    (2, 96, 96, 1, 512, True, None, 0.2),
    (8, 256, 256, 8, 64, False, "key+grad", 0.1),  # 64-row blocks
    # rich biases (their gradient is the kernel's dS) and head dims that
    # are not multiples of 8
    (2, 65, 100, 3, 12, False, "full+grad", 0.1),
    (2, 129, 129, 2, 64, True, "rows+grad", 0.0),
    (1, 70, 70, 2, 256, False, "head+grad", 0.0),
    (2, 96, 96, 2, 20, True, None, 0.0),
    (8, 256, 256, 8, 64, True, "full+grad", 0.0),
    (2, 64, 64, 2, 64, False, "full", 0.1),
]


@pytest.mark.parametrize("b,t,tk,h,d,causal,bias_form,rate", GRAD_CASES)
def test_flash_kernels_match_plain_gradients(dev, b, t, tk, h, d, causal,
                                             bias_form, rate):
    """Forward (with dropout) and backward kernels through the autograd
    Function against autograd of the plain version, same seed: within
    2e-4 of max(1, max|plain|) (dq is summed with atomics)."""
    gen = torch.Generator().manual_seed(11)
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, torch.float32)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev)
    kb = _bias(gen, bias_form, b, h, t, tk, dev)
    grad_b = bias_form is not None and bias_form.endswith("+grad")
    seed = torch.tensor([5], dtype=torch.int64, device=dev) if rate else None
    runs = []
    for kernel in (True, False):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        bb = kb.clone().requires_grad_(grad_b) if kb is not None else None
        n0 = tfa.flash_attention_bwd.launches
        if kernel:
            out = tfa._FlashAttention.apply(*ins, bb, seed, h, causal, rate)
        else:
            out, _ = tfa.attention_plain(*ins, h, bb, causal, rate, seed)
        grads = torch.autograd.grad(out, ins + ([bb] if grad_b else []),
                                    dout)
        assert tfa.flash_attention_bwd.launches == n0 + int(kernel)
        runs.append((out,) + grads)
    torch.cuda.synchronize()
    for got, want in zip(*runs):
        assert _rel_err(got, want) <= 2e-4


@pytest.mark.parametrize("b,tq", [(4, 50), (8, 1)])
def test_flash_kernels_at_the_nmt_shapes(dev, b, tq):
    """The f32 flash kernels at the attention seq2seq model's shapes: one
    head of 512 over 50 keys with a per-key padding bias [B, 1, 1, 50];
    the train step (Tq = 50: forward and backward through the autograd
    Function) and a decode step (Tq = 1 against 50 keys, B = batch x
    beam: forward, its lse too) against the plain version, within 2e-4
    of max(1, max|plain|)."""
    gen = torch.Generator().manual_seed(19)
    tk, d = 50, 512
    q, k, v = _qkv(gen, b, tq, tk, 1, d, dev, torch.float32)
    kb = _bias(gen, "key4", b, 1, tq, tk, dev)
    assert tfa.kernel_choice(q, 1, k, kb)["kernel"] == "cuda_flash"
    out, lse = tfa.flash_attention_fwd(q, k, v, 1, kb)
    want, want_lse = tfa.attention_plain(q, k, v, 1, kb)
    assert _rel_err(out, want) <= 2e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4
    if tq == 1:
        return
    dout = torch.randn(b, tq, d, generator=gen).to(dev)
    runs = []
    for kernel in (True, False):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        n0 = tfa.flash_attention_bwd.launches
        if kernel:
            o = tfa._FlashAttention.apply(*ins, kb, None, 1, False, 0.0)
        else:
            o, _ = tfa.attention_plain(*ins, 1, kb)
        runs.append((o,) + torch.autograd.grad(o, ins, dout))
        assert tfa.flash_attention_bwd.launches == n0 + int(kernel)
    torch.cuda.synchronize()
    for got, want in zip(*runs):
        assert _rel_err(got, want) <= 2e-4


BF16_GRAD_CASES = [
    # (B, Tq, Tk, H, D, causal, bias form, dropout rate): the training
    # shape and one case of every width family
    (8, 256, 256, 8, 64, False, "key+grad", 0.1),
    (2, 128, 128, 4, 64, True, None, 0.1),
    (2, 129, 64, 2, 16, True, None, 0.0),
    (2, 100, 100, 3, 40, False, "key+grad", 0.1),
    (1, 100, 77, 2, 128, False, "key1+grad", 0.2),
    (1, 70, 70, 2, 256, True, "key", 0.1),
    (1, 129, 65, 2, 512, False, "key1+grad", 0.0),
    (2, 65, 100, 3, 12, False, "full+grad", 0.1),
    (2, 129, 129, 2, 64, True, "rows+grad", 0.0),
]


@pytest.mark.parametrize("b,t,tk,h,d,causal,bias_form,rate",
                         BF16_GRAD_CASES)
def test_flash_kernels_bf16_match_plain(dev, b, t, tk, h, d, causal,
                                        bias_form, rate):
    """bf16 (AMP): the forward kernel against the plain version, and the
    backward kernel against the plain backward from the same out and lse,
    same seed. Both round P (after dropout) and dS to bf16 for their
    products, which sum in f32: out, dq, dk and dv within 2^-7 of max(1,
    max|plain|) (one bf16 step either side: a sum in another order may
    round the other way), dbias (f32) within 1e-4."""
    gen = torch.Generator().manual_seed(12)
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, torch.bfloat16)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
    kb = _bias(gen, bias_form, b, h, t, tk, dev)
    grad_b = bias_form is not None and bias_form.endswith("+grad")
    seed = torch.tensor([6], dtype=torch.int64, device=dev) if rate else None
    out, lse = tfa.flash_attention_fwd(q, k, v, h, kb, causal, rate, seed)
    want, want_lse = tfa.attention_plain(q, k, v, h, kb, causal, rate, seed)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, kb, causal,
                                  rate, seed, want_dbias=grad_b)
    ref = tfa.attention_bwd_plain(q, k, v, out, lse, dout, h, kb, causal,
                                  rate, seed, want_dbias=grad_b)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and _rel_err(out, want) <= 2 ** -7
    live = want_lse > -1e30
    assert (lse - want_lse)[live].abs().max().item() <= 1e-3
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype == (torch.float32 if name == "dbias"
                                      else torch.bfloat16), name
        assert _rel_err(g, r) <= (1e-4 if name == "dbias" else 2 ** -7), name


def test_flash_kernels_bf16_track_f64_like_plain_bf16(dev):
    """At the training shape (B=128, T=256, H=8, D=64, key padding bias) on
    bf16 inputs: the kernels' out, dq, dk and dv against the plain version
    in f64 on the same (bf16) inputs, by max abs and relative L2 error, at
    most 1.5 times the plain bf16 version's own error."""
    gen = torch.Generator().manual_seed(13)
    b, t, h, d = 128, 256, 8, 64
    q, k, v = _qkv(gen, b, t, t, h, d, dev, torch.bfloat16)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
    lengths = torch.randint(1, t + 1, (b,), generator=gen)
    kb = torch.where(torch.arange(t)[None] < lengths[:, None], 0.0,
                     -1e9).to(dev)

    ins64 = [x.double().requires_grad_(True) for x in (q, k, v)]
    out64 = tfa.attention_plain(*ins64, h, kb.double())[0]
    exact = [out64.detach()] + list(torch.autograd.grad(out64, ins64,
                                                        dout.double()))
    outs = []
    for fwd, bwd in ((tfa.attention_plain, tfa.attention_bwd_plain),
                     (tfa.flash_attention_fwd, tfa.flash_attention_bwd)):
        out, lse = fwd(q, k, v, h, kb)
        outs.append([out] + list(bwd(q, k, v, out, lse, dout, h, kb)[:3]))
    torch.cuda.synchronize()

    def errs(x, want):
        dd = x.double() - want
        return dd.abs().max().item(), (dd.norm() / want.norm()).item()

    for name, want, r, g in zip(("out", "dq", "dk", "dv"), exact, *outs):
        ke, pe = errs(g, want), errs(r, want)
        assert ke[0] <= 1.5 * pe[0] and ke[1] <= 1.5 * pe[1], (name, ke, pe)


def test_flash_kernels_track_f64_like_plain_f32(dev):
    """At Transformer-base's training shape (B=128, T=256, H=8, D=64, key
    padding bias) the kernels' out, dq, dk and dv against the plain version
    in f64 on the same f32 inputs, by max abs and relative L2 error: at most
    twice the plain version's own f32 error (cuBLAS, TF32 off). A single
    TF32 pass would be about 1000 times off."""
    gen = torch.Generator().manual_seed(13)
    b, t, h, d = 128, 256, 8, 64
    q, k, v = _qkv(gen, b, t, t, h, d, dev, torch.float32)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev)
    lengths = torch.randint(1, t + 1, (b,), generator=gen)
    kb = torch.where(torch.arange(t)[None] < lengths[:, None], 0.0,
                     -1e9).to(dev)

    def run(fn, dtype):
        ins = [x.detach().to(dtype).clone().requires_grad_(True)
               for x in (q, k, v)]
        out = fn(ins, kb.to(dtype))
        grads = torch.autograd.grad(out, ins, dout.to(dtype))
        return [out.detach()] + list(grads)

    def plain(ins, bias):
        return tfa.attention_plain(*ins, h, bias)[0]

    exact = run(plain, torch.float64)
    ref = run(plain, torch.float32)
    got = run(lambda ins, bias: tfa._FlashAttention.apply(
        *ins, bias, None, h, False, 0.0), torch.float32)
    torch.cuda.synchronize()

    def errs(x, want):
        dd = x.double() - want
        return dd.abs().max().item(), (dd.norm() / want.norm()).item()

    for name, want, r, g in zip(("out", "dq", "dk", "dv"), exact, ref, got):
        ke, pe = errs(g, want), errs(r, want)
        assert ke[0] <= 2 * pe[0] and ke[1] <= 2 * pe[1], (name, ke, pe)


def test_flash_gate_on_the_card(dev):
    """On the card the gate admits a rich bias and a head dim that is not
    a multiple of 8, and both launch the kernels (recorded in the choice,
    matching the plain version); a head dim above 512 raises."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = _qkv(gen, 2, 32, 32, 2, 12, dev, torch.float32)
    rich = torch.randn(2, 2, 32, 32, generator=gen).to(dev)
    assert tfa.kernel_choice(q, 2) == {"kernel": "cuda_flash", "reasons": []}
    n0 = tfa.flash_attention_fwd.launches
    out = tfa.flash_attention(q, k, v, 2, bias=rich, causal=True)
    assert tfa.flash_attention_fwd.launches == n0 + 1
    want, _ = tfa.attention_plain(q, k, v, 2, bias=rich, causal=True)
    assert out.shape == q.shape
    assert (out - want).abs().max().item() <= 1e-4
    q520 = torch.zeros(1, 4, 520, device=dev)
    with pytest.raises(NotImplementedError, match="512"):
        tfa.flash_attention(q520, q520, q520, 1)
    assert tfa.flash_attention_fwd.launches == n0 + 1


@pytest.mark.parametrize("rows,d,affine", [(4096, 512, (True, True)),
                                           (1000, 768, (True, False)),
                                           (3, 64, (False, False))])
def test_layer_norm_backward_matches_plain(dev, rows, d, affine):
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev)
    dy = torch.randn(rows, d, generator=gen).to(dev)
    g = torch.randn(d, generator=gen).to(dev) if affine[0] else None
    bb = torch.randn(d, generator=gen).to(dev) if affine[1] else None
    runs = []
    for kernel in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (x, g, bb)
               if t is not None]
        xs = ins[0]
        gs = ins[1] if g is not None else None
        bs = ins[-1] if bb is not None else None
        if kernel:
            y, _, _ = tfln.fused_layer_norm(xs, gs, bs, 1e-5)
        else:
            y, _, _ = tfln.layer_norm_plain(xs, gs, bs, 1e-5)
        runs.append(torch.autograd.grad(y, ins, dy))
    torch.cuda.synchronize()
    for got, want in zip(*runs):
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("rows,d,affine", [(32768, 512, (True, True)),
                                           (1000, 768, (True, False)),
                                           (1000, 77, (True, True)),
                                           (3, 64, (False, False))])
def test_layer_norm_backward_bf16_matches_plain(dev, rows, d, affine):
    """bf16 x and dy (AMP; D = 77 takes the single-element form): dx (bf16,
    rounded once from f32 on both sides) within 2^-8 of max(1,
    max|plain|); dgamma and dbeta (f32 sums of all rows, in another order)
    within 1e-4."""
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev,
                                                           torch.bfloat16)
    dy = torch.randn(rows, d, generator=gen).to(dev, torch.bfloat16)
    g = torch.randn(d, generator=gen).to(dev) if affine[0] else None
    bb = torch.randn(d, generator=gen).to(dev) if affine[1] else None
    runs = []
    for kernel in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (x, g, bb)
               if t is not None]
        gs = ins[1] if g is not None else None
        bs = ins[-1] if bb is not None else None
        fn = tfln.fused_layer_norm if kernel else tfln.layer_norm_plain
        y = fn(ins[0], gs, bs, 1e-5)[0]
        assert y.dtype == torch.bfloat16
        runs.append(torch.autograd.grad(y, ins, dy))
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(*runs)):
        assert got.dtype == want.dtype
        assert _rel_err(got, want) <= (2 ** -8 if i == 0 else 1e-4)


# T never a multiple of the 128-row tile past the first case; V % 4 != 0
# (4-byte W copies), D % 4 != 0 (4-byte x copies), D % 32 != 0 (a ragged
# k chunk)
CE_CASES = [(2048, 512, 30000, False, 0.1), (333, 72, 1000, True, 0.0),
            (1000, 512, 30001, True, 0.1), (333, 72, 999, False, 0.1),
            (200, 75, 1000, False, 0.1), (129, 37, 257, True, 0.1),
            (777, 72, 300, True, 0.0)]


def _ce_inputs(gen, t, d, v, with_bias, dev):
    """Labels 0 and V - 1 in rows 0 and 1; row 2 of x zero (equal logits
    without a bias)."""
    x = torch.randn(t, d, generator=gen)
    x[2] = 0.0
    w = torch.randn(d, v, generator=gen) / d ** 0.5
    b = torch.randn(v, generator=gen).to(dev) if with_bias else None
    y = torch.randint(0, v, (t,), generator=gen)
    y[0], y[1] = 0, v - 1
    return x.to(dev), w.to(dev), b, y.to(dev)


@pytest.mark.parametrize("t,d,v,with_bias,eps", CE_CASES)
def test_fused_ce_kernel_matches_plain(dev, t, d, v, with_bias, eps):
    """Loss and lse within 2e-5 of max(1, max|plain|), bitwise equal over
    two runs (no atomics); the Function's gradients (chunked backward)
    within 1e-4."""
    gen = torch.Generator().manual_seed(9)
    x, w, b, y = _ce_inputs(gen, t, d, v, with_bias, dev)
    loss, lse = tfce.fused_ce_fwd(x, w, b, y, eps)
    again = tfce.fused_ce_fwd(x, w, b, y, eps)
    want, want_lse = tfce.linear_smooth_ce_plain(x, w, b, y, eps)
    assert _rel_err(loss, want) <= 2e-5 and _rel_err(lse, want_lse) <= 2e-5
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    g = torch.randn(t, generator=gen).to(dev)
    runs = []
    for kernel in (True, False):
        ins = [a.clone().requires_grad_(True) for a in (x, w, b)
               if a is not None]
        bias = ins[2] if b is not None else None
        if kernel:
            out = tfce.linear_smooth_ce(ins[0], ins[1], bias, y, eps)
        else:
            out = tfce.linear_smooth_ce_plain(ins[0], ins[1], bias, y, eps)[0]
        runs.append(torch.autograd.grad(out, ins, g))
    torch.cuda.synchronize()
    for got, want in zip(*runs):
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("t,d,v,with_bias,eps", [(4096, 512, 30000, False,
                                                   0.1),
                                                  (4097, 37, 257, True, 0.1)])
def test_fused_ce_kernel_tracks_f64_like_plain_f32(dev, t, d, v, with_bias,
                                                   eps):
    """Against the projection and CE in f64: the kernel's loss and lse
    within 2x the plain f32 version's max abs and relative L2 errors (a
    single TF32 product is 54-530x off on the CPU emulation)."""
    gen = torch.Generator().manual_seed(10)
    x, w, b, y = _ce_inputs(gen, t, d, v, with_bias, dev)
    z = torch.matmul(x.double(), w.double())
    if b is not None:
        z = z + b.double()
    lse = torch.logsumexp(z, dim=-1)
    exact = (lse - (1 - eps) * z.gather(1, y.long()[:, None])[:, 0]
             - eps * z.mean(dim=-1), lse)
    got = tfce.fused_ce_fwd(x, w, b, y, eps)
    ref = tfce.linear_smooth_ce_plain(x, w, b, y, eps)
    for g, r, e in zip(got, ref, exact):
        dg, dr = g.double() - e, r.double() - e
        assert dg.abs().max() <= 2 * dr.abs().max()
        assert dg.norm() <= 2 * dr.norm()


@pytest.mark.parametrize("t,d,v,with_bias,eps", CE_CASES)
def test_fused_ce_kernel_bf16_matches_plain(dev, t, d, v, with_bias, eps):
    """bf16 x, W and b (AMP; D % 8 != 0 and V % 8 != 0 take the
    element-wise copies): loss and lse (f32) within 2e-5 of max(1,
    max|plain|) of the plain version's, which forms f32 logits from the
    same bf16 operands, bitwise equal over two runs; the Function's
    gradients come back in bf16."""
    gen = torch.Generator().manual_seed(9)
    x, w, b, y = (a.to(torch.bfloat16) if a is not None and
                  a.is_floating_point() else a
                  for a in _ce_inputs(gen, t, d, v, with_bias, dev))
    loss, lse = tfce.fused_ce_fwd(x, w, b, y, eps)
    again = tfce.fused_ce_fwd(x, w, b, y, eps)
    want, want_lse = tfce.linear_smooth_ce_plain(x, w, b, y, eps)
    torch.cuda.synchronize()
    assert loss.dtype == lse.dtype == torch.float32
    assert _rel_err(loss, want) <= 2e-5 and _rel_err(lse, want_lse) <= 2e-5
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    ins = [a.clone().requires_grad_(True) for a in (x, w, b) if a is not None]
    out = tfce.linear_smooth_ce(ins[0], ins[1], ins[2] if b is not None
                                else None, y, eps)
    grads = torch.autograd.grad(out.sum(), ins)
    assert all(g_.dtype == torch.bfloat16 for g_ in grads)


def test_fused_ce_kernel_bf16_tracks_f64_like_plain(dev):
    """At the training shape's rows (4096 of 32768, D = 512, V = 30000) on
    bf16 inputs: the kernel's loss and lse against the f64 projection and
    CE of the same inputs, within 1.5 times the plain version's max abs and
    relative L2 errors."""
    gen = torch.Generator().manual_seed(10)
    x, w, _, y = _ce_inputs(gen, 4096, 512, 30000, False, dev)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    z = torch.matmul(x.double(), w.double())
    lse = torch.logsumexp(z, dim=-1)
    exact = (lse - 0.9 * z.gather(1, y.long()[:, None])[:, 0]
             - 0.1 * z.mean(dim=-1), lse)
    got = tfce.fused_ce_fwd(x, w, None, y, 0.1)
    ref = tfce.linear_smooth_ce_plain(x, w, None, y, 0.1)
    for g, r, e in zip(got, ref, exact):
        dg, dr = g.double() - e, r.double() - e
        assert dg.abs().max() <= 1.5 * dr.abs().max()
        assert dg.norm() <= 1.5 * dr.norm()


# the bf16 forms' route boundaries: (T, D, V, bias, eps, form). T is never a
# multiple of the 128-row tile except at the training width's 4096
CE_FORM_CASES = [
    (4096, 512, 30000, False, 0.1, "wgmma"),
    (1000, 512, 1000, True, 0.1, "wgmma"),
    (777, 72, 304, True, 0.0, "wgmma"),     # D not a multiple of 64
    (129, 40, 256, False, 0.1, "wgmma"),
    (300, 512, 8, True, 0.1, "wgmma"),      # one slab of one tile
    (1000, 512, 30001, True, 0.1, "wgmma"),  # V % 8 != 0: W copied
    (200, 75, 1000, False, 0.1, "mma_sync"),    # D % 8 != 0
    (257, 520, 1000, True, 0.1, "wgmma"),    # D above the old resident 512
    (16384, 768, 30522, True, 0.0, "wgmma"),  # BERT's MLM head
    (4097, 768, 30522, True, 0.1, "wgmma"),   # ragged rows, D 768
]


@pytest.mark.parametrize("t,d,v,with_bias,eps,form", CE_FORM_CASES)
def test_fused_ce_bf16_forms_match_plain(dev, t, d, v, with_bias, eps, form):
    """Each bf16 form where the route sends it (counted by
    ``wgmma_launches``): loss and lse within 2e-5 of max(1, max|plain|),
    bitwise equal over two runs."""
    gen = torch.Generator().manual_seed(21)
    x, w, b, y = (a.to(torch.bfloat16) if a is not None and
                  a.is_floating_point() else a
                  for a in _ce_inputs(gen, t, d, v, with_bias, dev))
    assert tfce.ce_form(x, w) == form
    n0 = tfce.fused_ce_fwd.wgmma_launches
    loss, lse = tfce.fused_ce_fwd(x, w, b, y, eps)
    again = tfce.fused_ce_fwd(x, w, b, y, eps)
    want, want_lse = tfce.linear_smooth_ce_plain(x, w, b, y, eps)
    torch.cuda.synchronize()
    assert tfce.fused_ce_fwd.wgmma_launches - n0 == 2 * (form != "mma_sync")
    assert _rel_err(loss, want) <= 2e-5 and _rel_err(lse, want_lse) <= 2e-5
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])


# (B, Tq, Tk, H, D, causal, bias form, dropout, form): Tk on both sides of
# 256, causal Tq < Tk and Tq > Tk, head dims 16 to 128 and past them
FLASH_FORM_CASES = [
    (2, 100, 16, 2, 64, False, "key", 0.0, "wgmma"),
    (2, 100, 255, 2, 64, False, "key", 0.1, "wgmma"),
    (4, 256, 256, 8, 64, False, "key", 0.1, "wgmma"),
    (2, 100, 257, 2, 64, False, "key", 0.1, "mma_sync"),
    (2, 64, 256, 4, 64, True, None, 0.0, "wgmma"),    # causal, Tq < Tk
    (2, 129, 64, 2, 16, True, None, 0.1, "wgmma"),    # causal, Tq > Tk
    (2, 100, 200, 2, 16, False, "key4", 0.0, "wgmma"),
    (2, 96, 96, 2, 128, True, "key", 0.1, "wgmma"),
    (2, 70, 256, 3, 48, False, None, 0.0, "wgmma"),
    (2, 70, 100, 2, 12, False, "key", 0.0, "wgmma"),  # padded to 16
    (2, 70, 100, 2, 40, False, "key", 0.0, "mma_sync"),
    (1, 70, 129, 2, 256, False, "key", 0.0, "mma_sync"),
    (2, 65, 100, 3, 64, False, "full", 0.1, "mma_sync"),  # per-query bias
]


@pytest.mark.parametrize("b,t,tk,h,d,causal,bias_form,rate,form",
                         FLASH_FORM_CASES)
def test_flash_bf16_forward_forms_match_plain(dev, b, t, tk, h, d, causal,
                                              bias_form, rate, form):
    """Each bf16 forward form where the route sends it (counted by
    ``wgmma_launches``): out within 2^-7 of max(1, max|plain|), lse within
    1e-4, the same rows fully masked, the same dropout mask as the plain
    version from one seed."""
    gen = torch.Generator().manual_seed(22)
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, torch.bfloat16)
    kb = _bias(gen, bias_form, b, h, t, tk, dev)
    seed = torch.tensor([31], dtype=torch.int64, device=dev) if rate else None
    n0 = tfa.flash_attention_fwd.wgmma_launches
    out, lse = tfa.flash_attention_fwd(q, k, v, h, kb, causal, rate, seed)
    want, want_lse = tfa.attention_plain(q, k, v, h, kb, causal, rate, seed)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.wgmma_launches - n0 == (form == "wgmma")
    assert out.dtype == torch.bfloat16 and _rel_err(out, want) <= 2 ** -7
    live = want_lse > -1e30
    assert torch.equal(lse <= -1e30, ~live)
    assert (lse - want_lse)[live].abs().max().item() <= 1e-4


@pytest.mark.parametrize("t,tk,d", [(256, 256, 64), (100, 255, 128)])
def test_flash_bf16_wgmma_forward_tracks_f64(dev, t, tk, d):
    """The single-pass form's out against an f64 attention on the same bf16
    inputs (padding mask): max abs and relative L2 error at most 1.5x the
    plain bf16 version's."""
    gen = torch.Generator().manual_seed(23)
    b, h = 8, 4
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, torch.bfloat16)
    kb = _bias(gen, "key", b, h, t, tk, dev)
    exact = tfa.attention_plain(q.double(), k.double(), v.double(), h,
                                kb.double())[0]
    n0 = tfa.flash_attention_fwd.wgmma_launches
    got = tfa.flash_attention_fwd(q, k, v, h, kb)[0]
    ref = tfa.attention_plain(q, k, v, h, kb)[0]
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.wgmma_launches == n0 + 1
    dg, dr = got.double() - exact, ref.double() - exact
    assert dg.abs().max() <= 1.5 * dr.abs().max()
    assert dg.norm() <= 1.5 * dr.norm()


def test_tiny_transformer_step_on_gpu_matches_cpu(dev, fresh_port_programs):
    """One Adam step of a tiny Transformer (dropout 0) on the card and on
    the CPU from the same weights: loss and grads within 1e-4, and the
    step launches every training kernel the expected number of times, in
    its f32 form."""
    spec = tfluid.models.transformer.transformer_base(
        src_vocab=300, trg_vocab=300, seq_len=32, d_model=64, d_ff=128,
        n_head=2, n_layer=2, dropout_rate=0.0)
    tfluid.optimizer.Adam(1e-3).minimize(spec.loss)
    main = tfluid.default_main_program()
    tfluid.default_startup_program().random_seed = 3
    names = [p.name for p in main.all_parameters()]
    fetch = [spec.loss] + [main.global_block().var(n + "@GRAD")
                           for n in names]
    feed = spec.sample_batch(4, np.random.RandomState(0))
    feed["src_len"] = np.array([32, 20, 7, 1])
    gpu_scope, cpu_scope = tfluid.Scope(), tfluid.Scope()
    exe = tfluid.Executor()
    exe.run(tfluid.default_startup_program(), scope=gpu_scope)
    params = {n: gpu_scope.get(n).cpu().numpy() for n in names}
    fns = (tfa.flash_attention_fwd, tfa.flash_attention_bwd,
           tfln.layer_norm_fwd, tfln.layer_norm_bwd, tfce.fused_ce_fwd)
    before = [(f.launches, f.bf16_launches) for f in fns]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    assert [f.launches - n for f, (n, _) in zip(fns, before)] == [
        6, 6, 12, 12, 1]
    assert [f.bf16_launches for f in fns] == [n for _, n in before]
    cexe = tfluid.Executor(tfluid.CPUPlace())
    cexe.run(tfluid.default_startup_program(), scope=cpu_scope)
    tfluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    want = cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    for name, g, w in zip(["loss"] + names, got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=name)


CONV_CASES = [
    # (N, C_in, C_out, k, stride, H = W, residual, relu)
    (4, 16, 8, 1, 1, 8, False, True),
    (3, 8, 8, 3, 1, 8, False, True),
    (2, 8, 16, 1, 1, 7, True, True),
    (2, 16, 24, 1, 2, 9, False, False),  # odd H: Ho = 5
    (5, 32, 70, 3, 1, 7, True, True),    # H*W = 49, ragged channel tile
    (1, 3, 5, 3, 1, 5, False, False),    # fewer pixels than one tile
    (3, 40, 200, 3, 1, 9, True, True),   # C % 32 != 0 (taps split a
                                         # chunk), O = 200: 128 + 72
    (3, 20, 48, 1, 1, 8, False, True),   # O < 64, 16-byte pixel copies
    (4, 16, 96, 3, 1, 7, False, True),   # a 128-pixel tile over three
                                         # 49-pixel images, no 16-byte path
    (3, 37, 130, 1, 2, 11, True, False),  # stride 2, odd H, K % 4 != 0
    (2, 10, 72, 1, 1, 8, True, True),    # 16-byte pixels, 4-byte W rows
    (2, 64, 64, 3, 1, 56, False, True),  # ResNet-50's body, two images
    (8, 512, 512, 3, 1, 7, False, True),  # K = 4608: 144 chunks
]


def _conv_inputs(gen, n, cin, cout, k, stride, hw, residual, dev):
    ho = (hw - 1) // stride + 1
    x = torch.randn(n, cin, hw, hw, generator=gen).to(dev)
    w = (torch.randn(cout, cin, k, k, generator=gen)
         * (2.0 / (cin * k * k)) ** 0.5).to(dev)
    scale = (torch.rand(cout, generator=gen) + 0.5).to(dev)
    shift = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    res = torch.randn(n, cout, ho, ho, generator=gen).to(dev) \
        if residual else None
    return x, w, scale, shift, res


@pytest.mark.parametrize("n,cin,cout,k,stride,hw,residual,relu", CONV_CASES)
def test_fused_conv_kernels_match_plain(dev, n, cin, cout, k, stride, hw,
                                        residual, relu):
    """conv_moments, bn_apply and conv_apply against their plain versions
    (cuDNN conv + torch sums and elementwise ops), within 1e-4 of the
    largest plain value."""
    gen = torch.Generator().manual_seed(5)
    x, w, scale, shift, res = _conv_inputs(gen, n, cin, cout, k, stride, hw,
                                           residual, dev)
    co, s1, s2 = tfc.conv_moments(x, w, stride)
    wco, ws1, ws2 = tfc.conv_moments_plain(x, w, stride)
    y = tfc.bn_apply(wco, scale, shift, res, relu)
    wy = tfc.bn_apply_plain(wco, scale, shift, res, relu)
    ya = tfc.conv_apply(x, w, scale, shift, res, relu, stride)
    wya = tfc.conv_apply_plain(x, w, scale, shift, res, relu, stride)
    torch.cuda.synchronize()
    for got, want in ((co, wco), (s1, ws1), (s2, ws2), (y, wy), (ya, wya)):
        assert got.shape == want.shape
        assert _rel_err(got, want) <= 1e-4


def test_fused_conv_moments_are_deterministic(dev):
    """Partial sums per tile, reduced in a fixed order: two runs on the
    same input agree bit for bit."""
    gen = torch.Generator().manual_seed(8)
    x, w, _, _, _ = _conv_inputs(gen, 8, 64, 64, 3, 1, 28, False, dev)
    first = tfc.conv_moments(x, w, 1)
    second = tfc.conv_moments(x, w, 1)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cin,cout,k,hw", [(64, 64, 3, 56),
                                           (512, 512, 3, 7),
                                           (512, 2048, 1, 7)])
def test_fused_conv_tracks_f64_like_cudnn_f32(dev, cin, cout, k, hw):
    """3xTF32 with f32 accumulation against an f64 conv: max abs and
    relative L2 error at most twice cuDNN's f32 conv (TF32 off). A single
    TF32 product would be about 1000 times off."""
    gen = torch.Generator().manual_seed(9)
    x, w, _, _, _ = _conv_inputs(gen, 4, cin, cout, k, 1, hw, False, dev)
    pad = (k - 1) // 2
    exact = torch.nn.functional.conv2d(x.double(), w.double(), padding=pad)

    def errs(t):
        d = t.double() - exact
        return d.abs().max().item(), (d.norm() / exact.norm()).item()

    got = errs(tfc.conv_moments(x, w, 1)[0])
    lib = errs(torch.nn.functional.conv2d(x, w, padding=pad))
    assert got[0] <= 2 * lib[0] and got[1] <= 2 * lib[1], (got, lib)


def test_fused_conv_train_function_matches_plain_autograd(dev):
    """_FusedTrain (rows 10 + 11 forward, recomputed epilogue + cuDNN conv
    gradients backward) against autograd through the plain composition."""
    gen = torch.Generator().manual_seed(6)
    x, w, _, _, res = _conv_inputs(gen, 4, 16, 32, 3, 1, 7, True, dev)
    g = (torch.rand(32, generator=gen) + 0.5).to(dev)
    b = (torch.randn(32, generator=gen) * 0.1).to(dev)
    dy = torch.randn(4, 32, 7, 7, generator=gen).to(dev)
    runs = []
    for kernel in (True, False):
        ins = [a.clone().requires_grad_(True) for a in (x, w, g, b, res)]
        if kernel:
            before = tfc.conv_moments.launches, tfc.bn_apply.launches
            out = tfc._FusedTrain.apply(*ins, 1, 1e-5, True)[0]
            assert (tfc.conv_moments.launches - before[0],
                    tfc.bn_apply.launches - before[1]) == (1, 1)
        else:
            co = torch.nn.functional.conv2d(ins[0], ins[1], padding=1)
            out = tfc.epilogue_reference(co, ins[2], ins[3], ins[4], None,
                                         None, 1e-5, True)
        runs.append([out] + list(torch.autograd.grad(out, ins, dy)))
    torch.cuda.synchronize()
    for got, want in zip(*runs):
        assert _rel_err(got, want) <= 1e-4


def _bf16_ulp_ok(got, want):
    """Within one bf16 ulp: |got - want| <= 2^-7 max(1, |want|) for every
    element."""
    got, want = got.double(), want.double()
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs().clamp_min(1.0))
                .all())


def _moments_ok(co, s1, s2):
    """The kernel's sums against an f64 sum over its own stored co, within
    1e-5 of sum |co| (s1) and of sum co^2 (s2)."""
    c = co.double()
    e1 = (s1.double() - c.sum((0, 2, 3))).abs() / c.abs().sum((0, 2, 3))
    e2 = (s2.double() - (c * c).sum((0, 2, 3))).abs() / (c * c).sum(
        (0, 2, 3))
    return bool((e1.nan_to_num(0.0) <= 1e-5).all()
                and (e2.nan_to_num(0.0) <= 1e-5).all())


@pytest.mark.parametrize("n,cin,cout,k,stride,hw,residual,relu", CONV_CASES)
def test_fused_conv_kernels_bf16_match_plain(dev, n, cin, cout, k, stride, hw,
                                             residual, relu):
    """The bf16 forms (AMP) against the plain versions (the f32 conv rounded
    once; the affine, then the residual add, each rounded to bf16): co and
    y within one bf16 ulp, 2^-7 of max(1, |plain|), the moments within 1e-5
    of an f64 sum over the kernel's own co, and each wrapper counting its
    bf16 launch."""
    gen = torch.Generator().manual_seed(5)
    x, w, scale, shift, res = _conv_inputs(gen, n, cin, cout, k, stride, hw,
                                           residual, dev)
    bf = torch.bfloat16
    x, w = x.to(bf), w.to(bf)
    res = res.to(bf) if res is not None else None
    before = [f.bf16_launches for f in (tfc.conv_moments, tfc.bn_apply,
                                         tfc.conv_apply)]
    co, s1, s2 = tfc.conv_moments(x, w, stride)
    wco, _, _ = tfc.conv_moments_plain(x, w, stride)
    y = tfc.bn_apply(wco, scale, shift, res, relu)
    wy = tfc.bn_apply_plain(wco, scale, shift, res, relu)
    ya = tfc.conv_apply(x, w, scale, shift, res, relu, stride)
    wya = tfc.conv_apply_plain(x, w, scale, shift, res, relu, stride)
    torch.cuda.synchronize()
    assert [f.bf16_launches - b for f, b in zip(
        (tfc.conv_moments, tfc.bn_apply, tfc.conv_apply), before)] == [1] * 3
    for got, want in ((co, wco), (y, wy), (ya, wya)):
        assert got.dtype == bf and got.shape == want.shape
    # co, and bn_apply's y on the same co, element by element; conv_apply's
    # y against the largest plain value: a co that rounds the other way
    # moves y by scale x one ulp of co, more than an ulp of a small y
    assert _bf16_ulp_ok(co, wco) and _bf16_ulp_ok(y, wy)
    err = (ya.double() - wya.double()).abs().max().item()
    assert err <= 2.0 ** -7 * max(1.0, wya.double().abs().max().item())
    assert s1.dtype == s2.dtype == torch.float32
    assert _moments_ok(co, s1, s2)


def test_fused_conv_bf16_moments_are_deterministic(dev):
    gen = torch.Generator().manual_seed(8)
    x, w, _, _, _ = _conv_inputs(gen, 8, 64, 64, 3, 1, 28, False, dev)
    x, w = x.bfloat16(), w.bfloat16()
    first = tfc.conv_moments(x, w, 1)
    second = tfc.conv_moments(x, w, 1)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cin,cout,k,hw", [(64, 64, 3, 56),
                                           (512, 512, 3, 7),
                                           (512, 2048, 1, 7)])
def test_fused_conv_bf16_tracks_f64_like_plain_bf16(dev, cin, cout, k, hw):
    """co of the bf16 kernel against an f64 conv of the same bf16 inputs:
    max abs and relative L2 error at most 1.5x the plain bf16 version's
    (the f32 conv rounded once)."""
    gen = torch.Generator().manual_seed(9)
    x, w, _, _, _ = _conv_inputs(gen, 4, cin, cout, k, 1, hw, False, dev)
    x, w = x.bfloat16(), w.bfloat16()
    pad = (k - 1) // 2
    exact = torch.nn.functional.conv2d(x.double(), w.double(), padding=pad)

    def errs(t):
        d = t.double() - exact
        return d.abs().max().item(), (d.norm() / exact.norm()).item()

    got = errs(tfc.conv_moments(x, w, 1)[0])
    plain = errs(tfc.conv_moments_plain(x, w, 1)[0])
    assert got[0] <= 1.5 * plain[0] and got[1] <= 1.5 * plain[1], (got,
                                                                    plain)


def test_fused_conv_bf16_train_function_matches_plain_autograd(dev):
    """_FusedTrain in bf16 (rows 10 + 11 bf16 forward; the epilogue
    recomputed from the bf16 co and cuDNN's bf16 conv gradients backward)
    against autograd through the plain bf16 composition: y within one bf16
    ulp, the gradients within 1e-2 relative L2 (bf16 gradients)."""
    gen = torch.Generator().manual_seed(6)
    x, w, _, _, res = _conv_inputs(gen, 4, 16, 32, 3, 1, 7, True, dev)
    x, w, res = x.bfloat16(), w.bfloat16(), res.bfloat16()
    g = (torch.rand(32, generator=gen) + 0.5).to(dev)
    b = (torch.randn(32, generator=gen) * 0.1).to(dev)
    dy = torch.randn(4, 32, 7, 7, generator=gen).to(dev).bfloat16()
    runs = []
    for kernel in (True, False):
        ins = [a.clone().requires_grad_(True) for a in (x, w, g, b, res)]
        if kernel:
            out = tfc._FusedTrain.apply(*ins, 1, 1e-5, True)[0]
        else:
            co = tfc.conv_rounded(ins[0], ins[1], 1)
            out = tfc.epilogue_reference(co, ins[2], ins[3], ins[4], None,
                                         None, 1e-5, True)
        runs.append([out] + list(torch.autograd.grad(out, ins, dy)))
    torch.cuda.synchronize()
    assert _bf16_ulp_ok(runs[0][0], runs[1][0])
    for got, want in zip(runs[0][1:], runs[1][1:]):
        assert got.dtype == want.dtype
        assert (got.double() - want.double()).norm() <= 1e-2 * \
            want.double().norm()


SCATTER_CASES = [
    # (V, K, N, row kind): the shape grid of tests/test_scatter.py, then
    # drop/wrap, one hot row, and a DeepFM-like [B * F] id stream
    (100, 16, 333, "uniform"), (50, 8, 64, "uniform"), (33, 32, 7, "uniform"),
    (257, 4, 1025, "uniform"), (120, 128, 40, "uniform"),
    (40, 16, 200, "wrap_drop"), (64, 16, 500, "one_row"),
    (1000, 32, 64 * 26, "uniform"), (1000, 33, 999, "uniform"),
    # Zipf(1.2) ids folded into [0, V), a hot row straddling every chunk
    # boundary of the kernel's plan, and a table wider than a warp's lanes
    (5000, 32, 20000, "zipf"), (5000, 4, 20000, "zipf"),
    (1000, 32, 5000, "straddle"), (300, 256, 3000, "zipf"),
]


def _scatter_ids(gen, kind, v, n, k):
    if kind == "wrap_drop":
        return torch.randint(-2 * v, 2 * v, (n,), generator=gen)
    if kind == "one_row":
        return torch.full((n,), 7)
    if kind == "zipf":
        rng = np.random.RandomState(int(torch.randint(1 << 30, (1,),
                                                      generator=gen)))
        return torch.from_numpy((rng.zipf(1.2, n) - 1) % v)
    rows = torch.randint(0, v, (n,), generator=gen)
    if kind == "straddle":
        chunk = tscatter.scatter_plan(n, k, True, torch.cuda.
                                      get_device_properties(0).
                                      multi_processor_count).chunk
        for c in range(chunk, n, chunk):
            rows[c - 3:c + 3] = 5
    return rows


def _scatter_tol(v, k, rows, vals):
    mass = tscatter.scatter_add_plain(torch.zeros(v, k), rows, vals.abs())
    return 1e-5 * mass.clamp_min(1.0)


@pytest.mark.parametrize("v,k,n,kind", SCATTER_CASES)
@pytest.mark.parametrize("sort", [False, True])
def test_scatter_kernel_matches_plain(dev, v, k, n, kind, sort):
    """The kernel's f32 atomics add duplicates in no fixed order: within
    1e-5 * max(1, sum over a row's slots of |vals|) of the plain version,
    which bounds a few ulp per duplicate."""
    gen = torch.Generator().manual_seed(5)
    base = torch.randn(v, k, generator=gen)
    rows = _scatter_ids(gen, kind, v, n, k)
    vals = torch.randn(n, k, generator=gen)
    want = tscatter.scatter_add_plain(base, rows, vals)
    before = tscatter.scatter_add.launches
    got = tscatter.scatter_add_rows(base.to(dev), rows.to(dev),
                                    vals.to(dev), sort=sort)
    torch.cuda.synchronize()
    assert tscatter.scatter_add.launches == before + 1
    err = (got.cpu() - want).abs()
    assert bool((err <= _scatter_tol(v, k, rows, vals)).all()), err.max()


@pytest.mark.parametrize("k", [4, 32, 33])
@pytest.mark.parametrize("kind", ["uniform", "zipf", "wrap_drop"])
def test_scatter_kernel_unaligned_table(dev, k, kind):
    """A table one float past a 16-byte boundary (a row-offset view of a
    flat buffer) takes the kernel's single-float instantiation, in place;
    same tolerance as above."""
    gen = torch.Generator().manual_seed(6)
    v, n = 2000, 9000
    base = torch.randn(v, k, generator=gen)
    rows = _scatter_ids(gen, kind, v, n, k)
    vals = torch.randn(n, k, generator=gen)
    out = torch.empty(v * k + 1, device=dev)[1:].view(v, k)
    assert out.data_ptr() % 16 and out.is_contiguous()
    out.copy_(base)
    tscatter.scatter_add_rows(out, rows.to(dev), vals.to(dev), inplace=True)
    torch.cuda.synchronize()
    err = (out.cpu() - tscatter.scatter_add_plain(base, rows, vals)).abs()
    assert bool((err <= _scatter_tol(v, k, rows, vals)).all()), err.max()


@pytest.mark.parametrize("chunk", [1, 37, 538, 1024])
@pytest.mark.parametrize("kind", ["uniform", "zipf", "one_row"])
def test_scatter_kernel_under_explicit_plans(dev, monkeypatch, chunk, kind):
    """The kernel at chunk sizes the default plan does not pick; a plan
    that does not fit the call is refused."""
    gen = torch.Generator().manual_seed(7)
    v, k, n = 3000, 32, 7000
    base = torch.randn(v, k, generator=gen)
    rows = _scatter_ids(gen, kind, v, n, k)
    vals = torch.randn(n, k, generator=gen)
    plan = tscatter.ScatterPlan(4, chunk, 8, -(-n // chunk), 6)
    out = base.to(dev)
    monkeypatch.setattr(tscatter, "scatter_plan", lambda *_a: plan)
    tscatter.scatter_add(out, rows.to(dev, torch.int32), vals.to(dev))
    torch.cuda.synchronize()
    err = (out.cpu() - tscatter.scatter_add_plain(base, rows, vals)).abs()
    assert bool((err <= _scatter_tol(v, k, rows, vals)).all()), err.max()
    for bad in (plan._replace(blocks=plan.blocks + 1),
                plan._replace(group=16), plan._replace(chunk=2048),
                plan._replace(per_sm=8)):
        monkeypatch.setattr(tscatter, "scatter_plan", lambda *_a, _p=bad: _p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tscatter.scatter_add(out, rows.to(dev, torch.int32),
                                 vals.to(dev))


def test_scatter_kernel_inplace_and_refusals(dev):
    out = torch.zeros(10, 4, device=dev)
    rows = torch.tensor([1, 1, -1, 10], dtype=torch.int32, device=dev)
    got = tscatter.scatter_add_rows(out, rows, torch.ones(4, 4, device=dev),
                                    inplace=True)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert out[1].tolist() == [2.0] * 4 and out[9].tolist() == [1.0] * 4
    assert float(out.sum()) == 12.0
    for dtype in (torch.bfloat16, torch.int32):
        with pytest.raises(NotImplementedError, match="AMP"):
            tscatter.scatter_add_rows(torch.zeros(10, 4, device=dev,
                                                  dtype=dtype),
                                      rows, torch.ones(4, 4, device=dev))


# SRL's three narrow dense tables (word, predicate, mark) at batch 128 x 16
SRL_TABLES = [(500, 32), (50, 32), (2, 32)]


@pytest.mark.parametrize("v,k", SRL_TABLES)
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_narrow_lookup_backward_on_the_kernel(dev, v, k, g_dtype):
    """``rowops.packed_take``'s backward (the lookup of a dense table with
    K dividing 128) launches the scatter-add kernel once and records
    ``cuda_scatter_add``; its table gradient agrees with the plain
    version's on the CPU within ``_scatter_tol`` (the [2, 32] table takes
    about a thousand duplicates a row). Under AMP the rows go on in bf16
    and their gradient comes back through the cast, into the f32 table."""
    from paddle_tpu_torch.ops import rowops

    assert rowops.pack_factor(k) > 1
    gen = torch.Generator().manual_seed(8)
    w = torch.randn(v, k, generator=gen)
    ids = torch.randint(0, v, (128 * 16,), generator=gen)
    g = torch.randn(128 * 16, k, generator=gen).to(g_dtype)
    op = type("Op", (), {"attrs": {}})()
    wd = w.to(dev).requires_grad_(True)
    before = tscatter.scatter_add.launches
    out = rowops.packed_take(wd, ids.to(dev), op)
    assert torch.equal(out.detach().cpu(), w[ids])
    out.to(g_dtype).backward(g.to(dev))
    torch.cuda.synchronize()
    assert tscatter.scatter_add.launches == before + 1
    assert op.attrs["_kernel_choice"] == {"kernel": "cuda_scatter_add"}
    want = tscatter.scatter_add_plain(torch.zeros(v, k), ids, g.float())
    err = (wd.grad.cpu() - want).abs()
    assert bool((err <= _scatter_tol(v, k, ids, g.float())).all()), \
        err.max()


def test_tiny_deepfm_step_on_gpu_matches_cpu(dev, fresh_port_programs):
    """One Adam step of a tiny DeepFM on the card and on the CPU from the
    same weights: loss, prob, the sparse grad of fm_table, every Adam
    first moment and the table after the step agree, and the step
    launches the scatter kernel once (the densify of fm_table's sparse
    grad)."""
    spec = tfluid.models.deepfm.deepfm(
        sparse_feature_dim=1000, num_fields=6, embedding_size=8,
        dense_dim=5, hidden_sizes=(16, 16))
    tfluid.optimizer.Adam(1e-3).minimize(spec.loss)
    main = tfluid.default_main_program()
    gb = main.global_block()
    tfluid.default_startup_program().random_seed = 3
    feed = spec.sample_batch(16, np.random.RandomState(0))
    fetch = [spec.loss, spec.fetches["prob"], gb.var("fm_table@GRAD@ROWS"),
             gb.var("fm_table@GRAD")]
    moments = [o.input("Moment1").name for o in gb.ops if o.type == "adam"]
    gpu_scope, cpu_scope = tfluid.Scope(), tfluid.Scope()
    exe = tfluid.Executor()
    exe.run(tfluid.default_startup_program(), scope=gpu_scope)
    params = {p.name: gpu_scope.get(p.name).cpu().numpy()
              for p in main.all_parameters()}
    before = tscatter.scatter_add.launches
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    assert tscatter.scatter_add.launches == before + 1
    cexe = tfluid.Executor(tfluid.CPUPlace())
    cexe.run(tfluid.default_startup_program(), scope=cpu_scope)
    tfluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    want = cexe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    # the gradient itself, in relative L2: the (rows, values) grad, and
    # after the step each first moment, (1 - beta1) * g, whose fm_table
    # entry is the kernel's densify
    assert np.linalg.norm(got[3] - want[3]) <= \
        1e-5 * np.linalg.norm(want[3])
    for n in moments:
        m_gpu = gpu_scope.get(n).cpu().numpy()
        m_cpu = cpu_scope.get(n).numpy()
        assert np.linalg.norm(m_gpu - m_cpu) <= \
            1e-5 * np.linalg.norm(m_cpu), n
    # Adam's first step moves an element by about lr * sign(g): an element
    # whose grad is within rounding of zero may part by up to lr, so the
    # update is held in relative L2 and each element within lr
    start = params["fm_table"]
    upd_gpu = gpu_scope.get("fm_table").cpu().numpy() - start
    upd_cpu = cpu_scope.get("fm_table").numpy() - start
    assert np.linalg.norm(upd_gpu - upd_cpu) <= \
        1e-4 * np.linalg.norm(upd_cpu)
    assert np.abs(upd_gpu - upd_cpu).max() <= 1e-3



# -- the decode tier --------------------------------------------------------

def test_decode_step_and_chunk_on_gpu_match_cpu(dev):
    """A tiny KV-cached family on the card and on the CPU from the same
    weights: three step dispatches, then one chunk dispatch with a padded
    lane (pos = C), logits and caches within 1e-5; every dispatch launches
    the LayerNorm forward 2 * layers + 1 times and nothing else."""
    from test_torch_decode_serving import TINY, build_family

    gpu_fam = build_family(tfluid, tfluid.Scope(), place=tfluid.CUDAPlace(0))
    cpu_scope = tfluid.Scope()
    for p in gpu_fam["full_main"].all_parameters():
        cpu_scope.set(p.name, gpu_fam["step"]._scope.get(p.name).cpu())
    cpu_fam = build_family(tfluid, cpu_scope, init=False)
    rng = np.random.RandomState(0)
    b, c, d = 3, 32, TINY["d_model"]
    ids = rng.randint(0, TINY["vocab"], (b, 8)).astype("int64")
    cpos = np.tile(np.arange(3, 8, dtype="int32"), (b, 1))
    cpos[1, 3:] = c   # a partial lane: its writes drop
    results = {}
    for key, fam, where in (("gpu", gpu_fam, dev),
                            ("cpu", cpu_fam, torch.device("cpu"))):
        caches = {cf["feed"]: torch.zeros(b, c, d, device=where)
                  for cf in fam["dspec"]["cache_feeds"]}
        logits = []
        for t in range(3):
            before = tfln.layer_norm_fwd.launches
            outs = fam["step"].run(dict(caches, tok_ids=ids[:, t],
                                        pos=np.full((b,), t, "int32")),
                                   return_numpy=False)
            if key == "gpu":
                assert tfln.layer_norm_fwd.launches - before == \
                    2 * TINY["n_layer"] + 1
            logits.append(outs[0].cpu())
            caches = {cf["feed"]: o for cf, o in
                      zip(fam["dspec"]["cache_feeds"], outs[1:])}
        outs = fam["chunk"].run(dict(caches, tok_chunk=ids[:, 3:],
                                     chunk_pos=cpos), return_numpy=False)
        results[key] = (torch.stack(logits, 1), outs[0].cpu(),
                        [o.cpu() for o in outs[1:]])
    (gs, gc, gk), (cs, cc, ck) = results["gpu"], results["cpu"]
    for got, want in [(gs, cs), (gc[0], cc[0]), (gc[1, :3], cc[1, :3])] \
            + list(zip(gk, ck)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(
                                       want.abs().max())))
    for k in gk:   # the padded lanes wrote nothing
        assert not bool(k[1, 6:].any())


def test_decode_cache_positions_out_of_range_on_gpu(dev):
    """kv_cache_write at -1 (wraps), C and C + 3 (drop) and a lookup
    marked ``out_of_range="fill"`` past the table (a NaN row, as jnp.take
    fills, the decode chunk's position lookup): bitwise as on the CPU,
    with no device assert."""
    from paddle_tpu_torch.core.opimpl.attention_ops import cache_write

    gen = torch.Generator().manual_seed(0)
    c = 16
    cache = torch.randn(4, c, 8, generator=gen)
    rows = torch.randn(4, 2, 8, generator=gen)
    pos = torch.tensor([[-1, 0], [c, c + 3], [3, c], [-c, -c - 1]],
                       dtype=torch.int32)
    got = cache_write(cache.to(dev), rows.to(dev), pos.to(dev))
    torch.cuda.synchronize()
    want = cache_write(cache, rows, pos)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want[0, c - 1], rows[0, 0])
    assert torch.equal(want[1], cache[1])
    L = tfluid.layers
    main, start = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, start):
        out = L.embedding(L.data("ids", shape=[], dtype="int64"),
                          size=[5, 3])
    out.op.attrs["out_of_range"] = "fill"
    ids = np.array([0, 4, -1, 5, 7], "int64")
    res = []
    for place in (tfluid.CUDAPlace(0), tfluid.CPUPlace()):
        scope = tfluid.Scope()
        exe = tfluid.Executor(place)
        exe.run(start, scope=scope)
        if res:
            scope.set(main.all_parameters()[0].name, w_cpu)
        else:
            w_cpu = scope.get(main.all_parameters()[0].name).cpu()
        res.append(exe.run(main, feed={"ids": ids}, fetch_list=[out],
                           scope=scope)[0])
    np.testing.assert_array_equal(res[0], res[1])
    assert np.isnan(res[0][3:]).all() and np.isfinite(res[0][:3]).all()


def test_wgmma_mn_major_product_matches_matmul(dev):
    """The product form the wgmma flash backward's dQ takes (both operands
    M/N-contiguous in the 128-byte swizzle, written by ordinary stores):
    a^T . b on 64 x 64 bf16 matrices against torch.matmul in f32."""
    import ctypes

    from paddle_tpu_torch.ops import _build

    fn = _build.load("flash_attention_bwd").wgmma_mn_major_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(40)
    a, b = (torch.randn(64, 64, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    d = torch.empty(64, 64, device=dev)
    assert fn(a.data_ptr(), b.data_ptr(), d.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    want = a.float().t() @ b.float()
    assert (d - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# (B, Tq, Tk, H, D, causal, bias form, dropout, the backward's form): Tk on
# both sides of 256 and past it, causal Tq < Tk and Tq > Tk (rows that see
# no key), head dims 16 to 128 and past them, padding and rich biases
FLASH_BWD_FORM_CASES = [
    (2, 100, 16, 2, 64, False, "key+grad", 0.0, "wgmma"),
    (2, 100, 255, 2, 64, False, "key", 0.1, "wgmma"),
    (4, 256, 256, 8, 64, False, "key+grad", 0.1, "wgmma"),
    (2, 100, 257, 2, 64, False, "key4+grad", 0.1, "wgmma"),
    (2, 70, 512, 2, 64, True, "key", 0.0, "wgmma"),     # causal, Tq < Tk
    (2, 300, 100, 2, 64, True, None, 0.1, "wgmma"),     # causal, Tq > Tk
    (2, 129, 64, 2, 16, True, None, 0.0, "wgmma"),
    (2, 96, 96, 2, 128, True, "key+grad", 0.1, "wgmma"),
    (1, 70, 300, 3, 48, False, None, 0.0, "wgmma"),
    (2, 70, 100, 2, 12, False, "key", 0.0, "wgmma"),    # padded to 16
    (2, 100, 130, 2, 112, False, "head+grad", 0.1, "wgmma"),
    (2, 70, 100, 2, 40, False, "key+grad", 0.0, "mma_sync"),
    (1, 70, 129, 2, 136, False, "key", 0.0, "mma_sync"),
    (2, 65, 100, 3, 64, False, "full+grad", 0.1, "mma_sync"),  # per query
]


@pytest.mark.parametrize("b,t,tk,h,d,causal,bias_form,rate,form",
                         FLASH_BWD_FORM_CASES)
def test_flash_bf16_backward_forms_match_plain(dev, monkeypatch, b, t, tk, h,
                                               d, causal, bias_form, rate,
                                               form):
    """The bf16 backward in the form its route names (counted by
    ``wgmma_launches``) and, where that is the wgmma form, in the mma.sync
    form too, against the plain backward from the same out and lse, same
    seed: dq, dk, dv within 2^-7 of max(1, max|plain|), dbias within
    1e-4."""
    gen = torch.Generator().manual_seed(41)
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, torch.bfloat16)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
    kb = _bias(gen, bias_form, b, h, t, tk, dev)
    grad_b = bias_form is not None and bias_form.endswith("+grad")
    seed = torch.tensor([42], dtype=torch.int64, device=dev) if rate else None
    out, lse = tfa.flash_attention_fwd(q, k, v, h, kb, causal, rate, seed)
    ref = tfa.attention_bwd_plain(q, k, v, out, lse, dout, h, kb, causal,
                                  rate, seed, want_dbias=grad_b)
    forms = (form, "mma_sync") if form == "wgmma" else (form,)
    for run in forms:
        if run != form:
            monkeypatch.setattr(tfa, "bwd_form",
                                lambda *a, **k: ("mma_sync", "forced"))
        n0 = tfa.flash_attention_bwd.wgmma_launches
        got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, kb, causal,
                                      rate, seed, want_dbias=grad_b)
        torch.cuda.synchronize()
        assert tfa.flash_attention_bwd.wgmma_launches - n0 == (
            run == "wgmma")
        for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            if r is None:
                assert g is None
                continue
            tol = 1e-4 if name == "dbias" else 2 ** -7
            assert _rel_err(g, r) <= tol, (run, name, _rel_err(g, r))


def _dq_abs_terms(q, k, v, out, lse, dout, h, kb, rate, seed):
    """Each dq element's sum of |terms|, scale * sum_j |dS_ij| |K_j|, with
    dS rounded to bf16 as the kernels multiply it (the plain backward's
    dS: the same softmax, dropout mask and delta), packed [B, T, H*D]."""
    b, t, hd = q.shape
    d = hd // h
    split = [tfa._split(x, h) for x in (q, k, v, out)]
    ds = tfa.mha_bwd_plain(*split, lse, tfa._split(dout, h),
                           tfa._plain_bias(kb), False, dropout_rate=rate,
                           seed=seed)[3]
    terms = torch.matmul(ds.to(torch.bfloat16).float().abs(),
                         split[1].float().abs()) / math.sqrt(d)
    return terms.transpose(1, 2).reshape(b, t, hd)


def _worst(name, got, want, excess, terms=None):
    """The message naming the output, its worst element by ``excess``, both
    values and (dq) the element's sum of |terms|."""
    i = int(torch.argmax(excess))
    idx = tuple(int(x) for x in np.unravel_index(i, tuple(got.shape)))
    msg = "%s differs at %s: %r vs %r" % (name, idx, float(got.flatten()[i]),
                                         float(want.flatten()[i]))
    if terms is not None:
        msg += ", sum of |terms| %r" % float(terms.flatten()[i])
    return msg


def test_flash_bf16_wgmma_backward_is_reproducible(dev):
    """At the training shape with dropout and the padding mask's dbias, 50
    runs of the wgmma backward against the first: dk, dv and dbias bitwise
    equal (each is summed by one block in a fixed order); dq, whose f32 sum
    over the Tk / 64 key blocks is taken by atomics in no fixed order and
    rounded to bf16 once, within one bf16 ulp of the larger value plus the
    reordering bound 2 (n - 1) 2^-24 of the element's sum of |terms| for
    n blocks. A failure names the output, the element, both values and the
    sum of |terms|."""
    gen = torch.Generator().manual_seed(43)
    b, t, h, d = 8, 256, 8, 64
    q, k, v = _qkv(gen, b, t, t, h, d, dev, torch.bfloat16)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
    kb = _bias(gen, "key", b, h, t, t, dev)
    seed = torch.tensor([44], dtype=torch.int64, device=dev)
    out, lse = tfa.flash_attention_fwd(q, k, v, h, kb, False, 0.1, seed)
    terms = _dq_abs_terms(q, k, v, out, lse, dout, h, kb, 0.1, seed)
    blocks = -(-t // 64)
    n0 = tfa.flash_attention_bwd.wgmma_launches
    first = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, kb, False,
                                    0.1, seed, want_dbias=True)
    dq0 = first[0].float()
    for run in range(1, 50):
        got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, kb, False,
                                      0.1, seed, want_dbias=True)
        torch.cuda.synchronize()
        for name, g, f in zip(("dk", "dv", "dbias"), got[1:], first[1:]):
            diff = (g.float() - f.float()).abs()
            assert torch.equal(g, f), "run %d: %s" % (
                run, _worst(name, g.float(), f.float(), diff))
        dq = got[0].float()
        bound = (2 ** -7 * torch.maximum(dq.abs(), dq0.abs())
                 + 2 * (blocks - 1) * 2 ** -24 * terms)
        excess = (dq - dq0).abs() - bound
        assert bool((excess <= 0).all()), "run %d: %s" % (
            run, _worst("dq", dq, dq0, excess, terms))
    assert tfa.flash_attention_bwd.wgmma_launches == n0 + 50


@pytest.mark.parametrize("t,tk,d,causal", [(100, 300, 128, True),
                                           (64, 129, 16, True),
                                           (200, 200, 48, False)])
def test_flash_bf16_wgmma_backward_tracks_f64(dev, t, tk, d, causal):
    """The wgmma backward's dq, dk and dv against an f64 attention's
    gradients on the same bf16 inputs and the same forward out and lse
    (padding mask): max abs and relative L2 error at most 1.5x the plain
    bf16 backward's."""
    gen = torch.Generator().manual_seed(45)
    b, h = 4, 4
    q, k, v = _qkv(gen, b, t, tk, h, d, dev, torch.bfloat16)
    dout = torch.randn(b, t, h * d, generator=gen).to(dev, torch.bfloat16)
    kb = _bias(gen, "key", b, h, t, tk, dev)
    ins = [x.double().requires_grad_(True) for x in (q, k, v)]
    o64 = tfa.attention_plain(*ins, h, kb.double(), causal)[0]
    exact = torch.autograd.grad(o64, ins, dout.double())
    out, lse = tfa.flash_attention_fwd(q, k, v, h, kb, causal)
    n0 = tfa.flash_attention_bwd.wgmma_launches
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, kb, causal)
    ref = tfa.attention_bwd_plain(q, k, v, out, lse, dout, h, kb, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.wgmma_launches == n0 + 1
    for name, want, g, r in zip(("dq", "dk", "dv"), exact, got, ref):
        dg, dr = g.double() - want, r.double() - want
        assert dg.abs().max() <= 1.5 * dr.abs().max(), name
        assert dg.norm() <= 1.5 * dr.norm(), name


# ResNet-50's 19 fused geometries (C, O, k, stride, H): every one takes the
# bf16 conv_apply's wgmma form
RESNET_GEOMS = [
    (64, 256, 1, 1, 56), (64, 64, 1, 1, 56), (64, 64, 3, 1, 56),
    (256, 64, 1, 1, 56), (256, 512, 1, 2, 56), (256, 128, 1, 1, 56),
    (128, 512, 1, 1, 28), (512, 128, 1, 1, 28), (128, 128, 3, 1, 28),
    (512, 1024, 1, 2, 28), (512, 256, 1, 1, 28), (256, 1024, 1, 1, 14),
    (1024, 256, 1, 1, 14), (256, 256, 3, 1, 14), (1024, 2048, 1, 2, 14),
    (1024, 512, 1, 1, 14), (512, 2048, 1, 1, 7), (2048, 512, 1, 1, 7),
    (512, 512, 3, 1, 7),
]


@pytest.mark.parametrize("cin,cout,k,stride,hw", RESNET_GEOMS)
def test_conv_apply_bf16_wgmma_at_resnet_geometries(dev, cin, cout, k, stride,
                                                    hw):
    """The bf16 conv_apply at each fused geometry of ResNet-50 (three
    images, a residual and relu), routed to its wgmma form: y within 2^-7
    of max(1, max|plain|) of the plain version (the f32 conv rounded once,
    the affine, then the residual add, each rounded to bf16)."""
    gen = torch.Generator().manual_seed(46)
    x, w, scale, shift, res = _conv_inputs(gen, 3, cin, cout, k, stride, hw,
                                           True, dev)
    bf = torch.bfloat16
    x, w, res = x.to(bf), w.to(bf), res.to(bf)
    assert tfc.apply_form(x, w, stride, res) == ("wgmma", None)
    n0 = tfc.conv_apply.wgmma_launches
    y = tfc.conv_apply(x, w, scale, shift, res, True, stride)
    want = tfc.conv_apply_plain(x, w, scale, shift, res, True, stride)
    torch.cuda.synchronize()
    assert tfc.conv_apply.wgmma_launches == n0 + 1
    assert y.dtype == bf and y.shape == want.shape
    assert _rel_err(y, want) <= 2 ** -7


# (N, C, O, k, stride, H, residual, relu, form): the wgmma form's route
# boundaries: C and O multiples of 64 or not, one or two warpgroups (O =
# 64 or a multiple of 128), a tile of whole images (H*W <= 256) or of rows
# (odd and even Wo), stride 2 with an odd H, x read in NCHW (1x1 stride 1,
# H*W a multiple of 8) or from its channels-last copy
CONV_FORM_CASES = [
    (3, 64, 64, 3, 1, 9, True, True, "wgmma"),
    (2, 64, 192, 1, 1, 17, False, True, "wgmma"),    # 3 x 64 channels
    (2, 128, 128, 1, 2, 33, True, False, "wgmma"),   # odd H, Ho = 17
    (7, 64, 128, 3, 1, 5, False, True, "wgmma"),     # 7 images a tile
    (2, 192, 64, 3, 1, 20, True, True, "wgmma"),     # rows of 20
    (2, 128, 128, 1, 1, 16, False, True, "wgmma"),   # NCHW: one 256-pixel
                                                     # tile an image
    (3, 64, 128, 1, 1, 12, True, False, "wgmma"),    # NCHW: H*W = 144
    (2, 64, 96, 1, 1, 8, False, True, "mma_sync"),   # O % 64 != 0
    (2, 96, 64, 3, 1, 8, False, True, "mma_sync"),   # C % 64 != 0
]


@pytest.mark.parametrize("n,cin,cout,k,stride,hw,residual,relu,form",
                         CONV_FORM_CASES)
def test_conv_apply_bf16_forms_match_plain(dev, monkeypatch, n, cin, cout, k,
                                           stride, hw, residual, relu, form):
    """The bf16 conv_apply in the form its route names (counted by
    ``wgmma_launches``) and, where that is the wgmma form, in the mma.sync
    form too, against the plain version: y within 2^-7 of max(1,
    max|plain|)."""
    gen = torch.Generator().manual_seed(47)
    x, w, scale, shift, res = _conv_inputs(gen, n, cin, cout, k, stride, hw,
                                           residual, dev)
    bf = torch.bfloat16
    x, w = x.to(bf), w.to(bf)
    res = res.to(bf) if res is not None else None
    want = tfc.conv_apply_plain(x, w, scale, shift, res, relu, stride)
    assert tfc.apply_form(x, w, stride, res)[0] == form
    for run in ((form, "mma_sync") if form == "wgmma" else (form,)):
        if run != form:
            monkeypatch.setattr(tfc, "apply_form",
                                lambda *a, **k: ("mma_sync", "forced"))
        n0 = tfc.conv_apply.wgmma_launches
        y = tfc.conv_apply(x, w, scale, shift, res, relu, stride)
        torch.cuda.synchronize()
        assert tfc.conv_apply.wgmma_launches - n0 == (run == "wgmma")
        assert _rel_err(y, want) <= 2 ** -7, run


@pytest.mark.parametrize("cin,cout,k,stride,hw", [(64, 64, 3, 1, 56),
                                                  (256, 512, 1, 2, 56),
                                                  (512, 512, 3, 1, 7)])
def test_conv_apply_bf16_wgmma_tracks_f64(dev, cin, cout, k, stride, hw):
    """The wgmma conv_apply with scale 1 and shift 0 (y is its rounded
    conv) against an f64 conv of the same bf16 inputs: max abs and
    relative L2 error at most 1.5x the plain bf16 version's."""
    gen = torch.Generator().manual_seed(48)
    x, w, _, _, _ = _conv_inputs(gen, 4, cin, cout, k, stride, hw, False,
                                 dev)
    x, w = x.bfloat16(), w.bfloat16()
    pad = (k - 1) // 2
    exact = torch.nn.functional.conv2d(x.double(), w.double(), stride=stride,
                                       padding=pad)
    ones = torch.ones(cout, device=dev)
    n0 = tfc.conv_apply.wgmma_launches
    got = tfc.conv_apply(x, w, ones, ones * 0, None, False, stride)
    plain = tfc.conv_rounded(x, w, stride)
    torch.cuda.synchronize()
    assert tfc.conv_apply.wgmma_launches == n0 + 1
    dg, dr = got.double() - exact, plain.double() - exact
    assert dg.abs().max() <= 1.5 * dr.abs().max()
    assert dg.norm() <= 1.5 * dr.norm()


# (N, C, O, k, stride, H, form): the bf16 conv_moments' route, and the
# tiles whose slots the wgmma form's moments must skip (they hold values
# that are not zero): rows past Ho in the last row tile (30x30), images
# past N in the last image tile (7x7, N = 7), slots past the box (14x14,
# the copy path), pixels past H*W in the last 256-pixel tile of the NCHW
# path (28x28), a 1x1 stride-2 conv with an odd H
MOMENTS_FORM_CASES = [
    (4, 64, 64, 3, 1, 30, "wgmma"),
    (7, 512, 512, 3, 1, 7, "wgmma"),
    (3, 1024, 256, 1, 1, 14, "wgmma"),
    (3, 512, 128, 1, 1, 28, "wgmma"),
    (3, 256, 512, 1, 2, 56, "wgmma"),
    (2, 128, 128, 1, 2, 33, "wgmma"),
    (2, 64, 64, 3, 1, 56, "wgmma"),
    (7, 64, 128, 3, 1, 5, "wgmma"),     # 7 images a tile, one tile
    (2, 192, 64, 3, 1, 20, "wgmma"),    # rows of 20, one warpgroup
    (2, 64, 96, 1, 1, 8, "mma_sync"),   # O % 64 != 0
    (2, 96, 64, 3, 1, 8, "mma_sync"),   # C % 64 != 0
]


@pytest.mark.parametrize("n,cin,cout,k,stride,hw,form", MOMENTS_FORM_CASES)
def test_conv_moments_bf16_forms_match_plain(dev, monkeypatch, n, cin, cout,
                                             k, stride, hw, form):
    """The bf16 conv_moments in the form its route names (counted by
    ``wgmma_launches``) and, where that is the wgmma form, in the mma.sync
    form too, against the plain version: co within one bf16 ulp, the
    moments within 1e-5 of an f64 sum over the kernel's own co, and co
    and the moments bitwise equal across two runs."""
    gen = torch.Generator().manual_seed(49)
    x, w, _, _, _ = _conv_inputs(gen, n, cin, cout, k, stride, hw, False,
                                 dev)
    x, w = x.bfloat16(), w.bfloat16()
    want = tfc.conv_moments_plain(x, w, stride)[0]
    assert tfc.moments_form(x, w, stride)[0] == form
    for run in ((form, "mma_sync") if form == "wgmma" else (form,)):
        if run != form:
            monkeypatch.setattr(tfc, "moments_form",
                                lambda *a, **k: ("mma_sync", "forced"))
        n0 = tfc.conv_moments.wgmma_launches
        first = tfc.conv_moments(x, w, stride)
        second = tfc.conv_moments(x, w, stride)
        torch.cuda.synchronize()
        assert tfc.conv_moments.wgmma_launches - n0 == 2 * (run == "wgmma")
        co, s1, s2 = first
        assert co.dtype == torch.bfloat16 and co.shape == want.shape
        assert _bf16_ulp_ok(co, want), run
        assert _moments_ok(co, s1, s2), run
        for a, b in zip(first, second):
            assert torch.equal(a, b), run


@pytest.mark.parametrize("cin,cout,k,stride,hw", RESNET_GEOMS)
def test_conv_moments_bf16_wgmma_at_resnet_geometries(dev, cin, cout, k,
                                                      stride, hw):
    """The bf16 conv_moments at each fused geometry of ResNet-50 (three
    images), routed to its wgmma form: co within one bf16 ulp of the plain
    version, the moments within 1e-5 of an f64 sum over its own co."""
    gen = torch.Generator().manual_seed(50)
    x, w, _, _, _ = _conv_inputs(gen, 3, cin, cout, k, stride, hw, False,
                                 dev)
    x, w = x.bfloat16(), w.bfloat16()
    assert tfc.moments_form(x, w, stride) == ("wgmma", None)
    n0 = tfc.conv_moments.wgmma_launches
    co, s1, s2 = tfc.conv_moments(x, w, stride)
    want = tfc.conv_moments_plain(x, w, stride)[0]
    torch.cuda.synchronize()
    assert tfc.conv_moments.wgmma_launches == n0 + 1
    assert _bf16_ulp_ok(co, want)
    assert _moments_ok(co, s1, s2)


@pytest.mark.parametrize("cin,cout,k,stride,hw", [(64, 64, 3, 1, 56),
                                                  (256, 512, 1, 2, 56),
                                                  (512, 512, 3, 1, 7)])
def test_conv_moments_bf16_wgmma_tracks_f64(dev, cin, cout, k, stride, hw):
    """The wgmma conv_moments' co against an f64 conv of the same bf16
    inputs: max abs and relative L2 error at most 1.5x the plain bf16
    version's (the f32 conv rounded once)."""
    gen = torch.Generator().manual_seed(51)
    x, w, _, _, _ = _conv_inputs(gen, 4, cin, cout, k, stride, hw, False,
                                 dev)
    x, w = x.bfloat16(), w.bfloat16()
    exact = torch.nn.functional.conv2d(x.double(), w.double(), stride=stride,
                                       padding=(k - 1) // 2)
    n0 = tfc.conv_moments.wgmma_launches
    got = tfc.conv_moments(x, w, stride)[0]
    plain = tfc.conv_rounded(x, w, stride)
    torch.cuda.synchronize()
    assert tfc.conv_moments.wgmma_launches == n0 + 1
    dg, dr = got.double() - exact, plain.double() - exact
    assert dg.abs().max() <= 1.5 * dr.abs().max()
    assert dg.norm() <= 1.5 * dr.norm()


# (rows, D, affine, (vec, vpl)): one case per form of ln_bwd_plan in bf16:
# the row in registers at 1-4 vectors a lane (D = 1000: 125 of 128
# vectors), the looped form on 16-byte vectors (D = 2048) and on single
# elements (D = 77)
LN_BWD_FORM_CASES = [
    (32768, 512, (True, True), (8, 2)),
    (1000, 768, (True, False), (8, 3)),
    (1000, 1000, (True, True), (8, 4)),
    (77, 256, (False, False), (8, 1)),
    (1000, 2048, (True, True), (8, 0)),
    (1000, 77, (True, True), (1, 0)),
]


def _ln_bwd_bf16_inputs(dev, rows, d, affine, seed):
    """bf16 x and dy, f32 gamma and beta (or None)."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, d, generator=gen) * 2 + 0.5).to(dev,
                                                           torch.bfloat16)
    dy = torch.randn(rows, d, generator=gen).to(dev, torch.bfloat16)
    g = torch.randn(d, generator=gen).to(dev) if affine[0] else None
    bb = torch.randn(d, generator=gen).to(dev) if affine[1] else None
    return x, dy, g, bb


@pytest.mark.parametrize("rows,d,affine,form", LN_BWD_FORM_CASES)
def test_layer_norm_backward_bf16_plan_forms(dev, rows, d, affine, form):
    """The bf16 LayerNorm backward in each form of its plan against the
    plain version: dx (bf16, rounded once from f32 on both sides) within
    2^-8 of max(1, max|plain|), dgamma and dbeta within 1e-4; two kernel
    runs bitwise equal."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tuple(tfln.ln_bwd_plan(rows, d, torch.bfloat16, sms)[:2]) == form
    x, dy, g, bb = _ln_bwd_bf16_inputs(dev, rows, d, affine, 7)
    runs = []
    for kernel in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (x, g, bb)
               if t is not None]
        gs = ins[1] if g is not None else None
        bs = ins[-1] if bb is not None else None
        fn = tfln.fused_layer_norm if kernel else tfln.layer_norm_plain
        y = fn(ins[0], gs, bs, 1e-5)[0]
        runs.append(torch.autograd.grad(y, ins, dy))
    _, mean, var = tfln.layer_norm_fwd(x, g, bb, 1e-5)
    again = [tfln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)
             for _ in range(2)]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(*runs)):
        assert got.dtype == want.dtype
        assert _rel_err(got, want) <= (2 ** -8 if i == 0 else 1e-4)
    for a, b in zip(*again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("rows,d", [(32768, 512), (1000, 2048), (1000, 77)])
def test_layer_norm_backward_writes_every_output(dev, monkeypatch, rows, d):
    """dx, dgamma and dbeta are allocated uninitialised: with every new
    buffer filled with NaN first, the outputs are the same as with the
    allocator's own memory (the kernels write every element)."""
    x, dy, g, bb = _ln_bwd_bf16_inputs(dev, rows, d, (True, True), 8)
    _, mean, var = tfln.layer_norm_fwd(x, g, bb, 1e-5)
    want = tfln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)
    empty, empty_like = torch.empty, torch.empty_like

    def nan_empty(*a, **k):
        t = empty(*a, **k)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    def nan_empty_like(*a, **k):
        t = empty_like(*a, **k)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)
    monkeypatch.setattr(torch, "empty_like", nan_empty_like)
    got = tfln.layer_norm_bwd(x, g, mean, var, dy, 1e-5)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# -- the captured step ------------------------------------------------------

def _state_names(program, scope):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and v.name in scope)


def _steps_from(main, scope, feed, fetch, start, gen_state, use_cache,
                steps=4):
    """``steps`` runs of ``main`` from the state ``start`` and the
    generator state ``gen_state`` with a fresh executor: the fetches of
    each step, the state after the last, and the step's report."""
    for n, t in start.items():
        scope.set(n, t.clone())
    scope.get(t_executor.RNG_KEY).set_state(gen_state)
    exe = tfluid.Executor()
    outs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    use_program_cache=use_cache) for _ in range(steps)]
    state = {n: scope.get(n).float().cpu().numpy() for n in start}
    report = exe.step_report(main)
    exe.close()
    return outs, state, report


def _captured_vs_interpreted(main, startup, feed, fetch):
    """Four captured steps against four interpreted ones from one state
    and one generator state. The distance between two interpreted runs of
    the same steps (the flash backward's dQ sums by f32 atomics) sets the
    bound: captured-vs-interpreted at most twice it plus 1e-6, in relative
    L2 over every fetch of every step and every state tensor at once."""
    scope = tfluid.Scope()
    tfluid.Executor().run(startup, scope=scope)
    start = {n: scope.get(n).clone() for n in _state_names(main, scope)}
    gen_state = scope.get(t_executor.RNG_KEY).get_state()
    runs = [_steps_from(main, scope, feed, fetch, start, gen_state, cache)
            for cache in (False, False, True)]
    i1, i2, cap = runs
    assert not i1[2]["captured"] and cap[2]["captured"], cap[2]
    assert (cap[2]["interpreted"], cap[2]["captures"],
            cap[2]["replays"]) == (1, 1, 2)

    def dist(a, b):
        pairs = [(np.asarray(x, np.float64), np.asarray(y, np.float64))
                 for sa, sb in zip(a[0], b[0]) for x, y in zip(sa, sb)]
        pairs += [(a[1][n], b[1][n]) for n in sorted(start)]
        num = sum(float(np.square(x - y).sum()) for x, y in pairs)
        den = sum(float(np.square(y).sum()) for _, y in pairs)
        return float(np.sqrt(num / max(den, 1e-300)))

    d_ii, d_ci = dist(i2, i1), dist(cap, i1)
    assert d_ci <= 2 * d_ii + 1e-6, (d_ci, d_ii)
    return cap[2]


def test_captured_transformer_amp_matches_interpreted(dev,
                                                      fresh_port_programs):
    spec = tfluid.models.transformer.transformer_base(
        src_vocab=64, trg_vocab=64, seq_len=32, d_model=64, d_ff=128,
        n_head=2, n_layer=2, dropout_rate=0.1)
    tfluid.amp.decorate(tfluid.optimizer.Adam(1e-3)).minimize(spec.loss)
    main = tfluid.default_main_program()
    main.random_seed = tfluid.default_startup_program().random_seed = 5
    feed = spec.sample_batch(4, np.random.RandomState(0))
    report = _captured_vs_interpreted(main, tfluid.default_startup_program(),
                                      feed, [spec.loss])
    assert report["pool_bytes"] >= 0


def test_captured_resnet_block_matches_interpreted(dev, fresh_port_programs):
    # Momentum, not Adam: at this size cuDNN's backward sums in no fixed
    # order, and Adam moves an element whose gradient is within rounding
    # of zero by up to twice the learning rate, so a few such elements set
    # the distance between any two runs; Momentum keeps it at rounding
    spec = tfluid.models.resnet.resnet_cifar10(depth=8, class_num=10)
    tfluid.optimizer.Momentum(1e-3, momentum=0.9).minimize(spec.loss)
    main = tfluid.default_main_program()
    tfluid.default_startup_program().random_seed = 5
    feed = spec.sample_batch(4, np.random.RandomState(0))
    before = tfc.conv_moments.launches
    _captured_vs_interpreted(main, tfluid.default_startup_program(), feed,
                             [spec.loss, spec.fetches["acc"]])
    assert tfc.conv_moments.launches > before


def test_captured_fetch_is_a_copy_and_rebinds(dev, fresh_port_programs):
    spec = tfluid.models.transformer.transformer_base(
        src_vocab=64, trg_vocab=64, seq_len=16, d_model=32, d_ff=64,
        n_head=2, n_layer=1, dropout_rate=0.0)
    tfluid.optimizer.Adam(1e-3).minimize(spec.loss)
    main = tfluid.default_main_program()
    exe = tfluid.Executor()
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    feed = spec.sample_batch(4, np.random.RandomState(0))
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[spec.loss], scope=scope)
    got, = exe.run(main, feed=feed, fetch_list=[spec.loss], scope=scope,
                   return_numpy=False)
    kept = got.clone()
    exe.run(main, feed=feed, fetch_list=[spec.loss], scope=scope)
    assert torch.equal(got, kept)
    assert exe.step_report(main)["replays"] == 2
    w = main.all_parameters()[0].name
    scope.set(w, scope.get(w).clone())  # another writer replaced it
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[spec.loss], scope=scope)
    report = exe.step_report(main)
    assert (report["interpreted"], report["captures"]) == (2, 2)
    exe.close()


def test_two_threads_serve_predictor_clones(dev, fresh_port_programs,
                                            tmp_path):
    import threading

    seq, vocab = 16, 100
    L = tfluid.layers
    ids = L.data("input_ids", shape=[seq], dtype="int64")
    seg = L.data("segment_ids", shape=[seq], dtype="int64")
    lens = L.data("input_len", shape=[], dtype="int64")
    x = tfluid.models.bert.bert_encoder(ids, seg, lens, seq, vocab, 64, 128,
                                        2, 2, dropout_rate=0.0)
    cls = L.squeeze(L.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    prob = L.softmax(L.fc(cls, size=2))
    exe = tfluid.Executor()
    exe.run(tfluid.default_startup_program())
    tfluid.io.save_inference_model(
        str(tmp_path), ["input_ids", "segment_ids", "input_len"], [prob], exe)
    pred = tfluid.inference.Predictor(str(tmp_path))
    rng = np.random.RandomState(0)
    feeds = [{"input_ids": rng.randint(0, vocab, (4, seq)),
              "segment_ids": rng.randint(0, 2, (4, seq)),
              "input_len": rng.randint(1, seq + 1, (4,))} for _ in range(12)]
    want = [pred.clone().run(f)[0] for f in feeds]  # interpreted, each
    clones = [pred.clone(), pred.clone()]
    got = [[None] * len(feeds) for _ in clones]
    errors = []

    def serve(k):
        try:
            for i, f in enumerate(feeds):
                got[k][i] = clones[k].run(f)[0]
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for k, c in enumerate(clones):
        report = c._exe.step_report(c._program)
        assert report["captured"] and report["replays"] == len(feeds) - 2
        for w, g in zip(want, got[k]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- the optimizers' sparse routes and rematerialization ---------------------

DENSIFYING = {
    "lars_momentum": lambda o: o.LarsMomentum(1e-2, 0.9),
    "adamax": lambda o: o.Adamax(1e-3),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(1e-2),
    "adadelta": lambda o: o.Adadelta(1.0),
    "rmsprop": lambda o: o.RMSProp(1e-3, momentum=0.5, centered=True),
    "ftrl": lambda o: o.Ftrl(1e-2),
    "lamb": lambda o: o.Lamb(1e-3),
}


@pytest.mark.parametrize("name", list(DENSIFYING))
def test_densifying_optimizer_scatters_through_the_kernel(
        dev, fresh_port_programs, name):
    """One step of a tiny DeepFM under each optimizer that densifies its
    sparse grad: the step launches the scatter-add kernel once, records
    ``cuda_scatter_add``, and its loss and the table's update agree with
    the CPU's (the plain scatter) within 1e-5 relative and 1e-4 relative
    L2: the optimizers' first steps move an element by about lr * sign(g)
    or lr * g / |g|, so an element whose grad is within rounding of zero
    may part."""
    spec = tfluid.models.deepfm.deepfm(
        sparse_feature_dim=1000, num_fields=6, embedding_size=8,
        dense_dim=5, hidden_sizes=(16, 16))
    DENSIFYING[name](tfluid.optimizer).minimize(spec.loss)
    main = tfluid.default_main_program()
    startup = tfluid.default_startup_program()
    startup.random_seed = 3
    upd = [o for o in main.global_block().ops if o.type == name
           and o.input("Param").name == "fm_table"][0]
    feed = spec.sample_batch(16, np.random.RandomState(0))
    gpu_scope, cpu_scope = tfluid.Scope(), tfluid.Scope()
    exe = tfluid.Executor()
    exe.run(startup, scope=gpu_scope)
    params = {p.name: gpu_scope.get(p.name).cpu().numpy()
              for p in main.all_parameters()}
    before = tscatter.scatter_add.launches
    got, = exe.run(main, feed=feed, fetch_list=[spec.loss], scope=gpu_scope)
    assert tscatter.scatter_add.launches == before + 1
    assert upd.attr("_kernel_choice") == {"kernel": "cuda_scatter_add"}
    cexe = tfluid.Executor(tfluid.CPUPlace())
    cexe.run(startup, scope=cpu_scope)
    tfluid.bridge.load_program_params(cpu_scope, params, main, "cpu")
    want, = cexe.run(main, feed=feed, fetch_list=[spec.loss],
                     scope=cpu_scope)
    assert upd.attr("_kernel_choice") == {"kernel": "plain_scatter_add"}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    start = params["fm_table"]
    upd_gpu = gpu_scope.get("fm_table").cpu().numpy() - start
    upd_cpu = cpu_scope.get("fm_table").numpy() - start
    assert np.abs(upd_cpu).max() > 0
    assert np.linalg.norm(upd_gpu - upd_cpu) <= \
        1e-4 * np.linalg.norm(upd_cpu)


def _tiny_bert(remat):
    """Tiny BERT pretraining (2 layers, width 32, dropout 0.1) under Adam
    in fresh programs with fresh names, with ``memory_optimize`` when
    ``remat``: (main, startup, loss and grads)."""
    old = t_unique_name.switch()
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup):
        spec = tfluid.models.bert.bert_base(
            vocab_size=97, seq_len=16, d_model=32, d_ff=64, n_head=2,
            n_layer=2, dropout_rate=0.1)
        pg = tfluid.optimizer.Adam(1e-3).minimize(spec.loss)[1]
    if remat:
        tfluid.memory_optimize(main)
    t_unique_name.switch(old)
    return main, startup, spec, [spec.loss] + [g for _, g in pg]


def test_captured_remat_step_matches_plain_step(dev):
    """Two steps of tiny BERT under ``memory_optimize`` with dropout 0.1:
    the first interpreted, the second captured (its backward recomputes
    every segment inside the graph, replaying the forward's dropout masks
    and flash seeds); a program without remat, interpreted, from the same
    weights and generator seed gives each step's loss and gradients within
    1e-6 relative L2: the recompute reproduces the forward, and dropout
    draws no new mask."""
    main, startup, spec, fetch = _tiny_bert(True)
    pmain, pstartup, pspec, pfetch = _tiny_bert(False)
    assert [v.name for v in fetch] == [v.name for v in pfetch]
    feed = spec.sample_batch(4, np.random.RandomState(1))
    feed["input_len"] = np.array([16, 9, 12, 3], "int64")
    scope, pscope = tfluid.Scope(), tfluid.Scope()
    exe, pexe = tfluid.Executor(), tfluid.Executor()
    exe.run(startup, scope=scope)
    pexe.run(pstartup, scope=pscope)
    tfluid.bridge.load_program_params(
        pscope, {p.name: scope.numpy(p.name) for p in main.all_parameters()},
        pmain)
    for step in range(2):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        want = pexe.run(pmain, feed=feed, fetch_list=pfetch, scope=pscope,
                        use_program_cache=False)
        for v, g, w in zip(fetch, got, want):
            assert np.linalg.norm(g - w) <= 1e-6 * max(
                np.linalg.norm(w), 1e-30), (step, v.name)
    report = exe.step_report(main)
    assert report["captured"] and report["captures"] == 1, report
    assert len(exe._last[id(main)].remat) > 1
    exe.close()


def test_amp_products_round_once(dev, fresh_port_programs):
    """A bf16 product under AMP at few rows and a long reduction (the CE
    backward's dx at BERT's vocabulary, 256 rows) rounds once, as the
    reference's f32-accumulated dots do: within the error of the f64
    product rounded to bf16 (cuBLAS's bf16 split-K reduction, PyTorch's
    default, adds a second rounding: 2.28e-3 against 1.67e-3 relative L2
    on an H100)."""
    x, w = (tfluid.layers.data(n, shape=s, dtype="float32",
                               append_batch_size=False)
            for n, s in (("x", [256, 30522]), ("w", [30522, 768])))
    main = tfluid.default_main_program()
    y = main.global_block().create_var(name="y", shape=(256, 768),
                                       dtype="float32")
    main.global_block().append_op("mul", {"X": x, "Y": w}, {"Out": y},
                                  {"x_num_col_dims": 1, "y_num_col_dims": 1})
    tfluid.amp.enable_bf16(main)
    gen = torch.Generator().manual_seed(0)
    xv = torch.randn(256, 30522, generator=gen) * 1e-4
    xv[:, 0] = -1.0
    wv = torch.randn(30522, 768, generator=gen) / 768 ** 0.5
    got, = tfluid.Executor().run(main, feed={"x": xv.numpy(),
                                             "w": wv.numpy()},
                                 fetch_list=[y], return_numpy=False)
    assert got.dtype == torch.bfloat16
    ref = (xv.bfloat16().double() @ wv.bfloat16().double()).to(dev)
    once = ref.bfloat16().double()
    err = float((got.double() - ref).norm() / ref.norm())
    assert err <= 1.001 * float((once - ref).norm() / ref.norm())


def test_cpu_run_then_captured_card_steps_share_a_scope(dev):
    """A CPU run first makes the scope's ``@RNG@`` on the CPU; card steps
    in that scope then draw from a CUDA generator of their own
    (``@RNG@cuda:0``), which their graph registers, and train as they do
    in a fresh scope: the same losses, captured and replayed."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        t_unique_name.switch()
        x = tfluid.layers.data("x", shape=[12])
        h = tfluid.layers.dropout(tfluid.layers.fc(x, size=16, act="relu"),
                                  dropout_prob=0.5)
        loss = tfluid.layers.mean(tfluid.layers.fc(h, size=1))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    masked = tfluid.Program()
    with tfluid.program_guard(masked, tfluid.Program()):
        y = tfluid.layers.dropout(tfluid.layers.data("x", shape=[12]),
                                  dropout_prob=0.5)
    feed = {"x": np.random.RandomState(0).randn(8, 12).astype("f4")}
    losses = {}
    for shared in (False, True):
        scope = t_executor.Scope()
        if shared:
            tfluid.Executor(tfluid.CPUPlace()).run(
                masked, feed=feed, fetch_list=[y], scope=scope)
        exe = tfluid.Executor(tfluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        losses[shared] = [exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0] for _ in range(5)]
        report = exe.step_report(main)
        assert report["captured"] and report["captures"] == 1, report
        assert report["replays"] == 3, report
        gen = scope.get("@RNG@cuda:0" if shared else t_executor.RNG_KEY)
        assert gen.device == dev
        exe.close()
    assert scope.get(t_executor.RNG_KEY).device.type == "cpu"
    for got, want in zip(losses[True], losses[False]):
        np.testing.assert_array_equal(got, want)


# -- the checkpoint and data plane on the card ---------------------------------

def _tiny_deepfm():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup):
        t_unique_name.switch()
        spec = tfluid.models.deepfm.deepfm(
            sparse_feature_dim=1000, num_fields=6, embedding_size=8,
            dense_dim=5, hidden_sizes=(16, 16))
        tfluid.optimizer.Adam(1e-2).minimize(spec.loss)
    return main, startup, spec


def test_async_save_after_a_captured_deepfm_step_holds_step_k(dev,
                                                              tmp_path):
    """The snapshot owns its bytes: a save after a captured step, one more
    replayed step (written into the same tensors), then ``wait()``: the
    file holds the values of the save's step."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.reliability import faults

    main, startup, spec = _tiny_deepfm()
    scope = t_executor.Scope()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = spec.sample_batch(16, np.random.RandomState(0))
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[spec.loss], scope=scope)
    assert exe.step_report(main)["captures"] == 1
    names = [v.name for v in main.list_vars()
             if v.persistable and v.name in scope]
    want = {n: scope.numpy(n) for n in names}
    held = {n: scope.get(n) for n in names}
    with faults.fault_scope(faults.FaultPlan.from_spec(
            "checkpoint.write:hang(0.5)@1")):
        w = checkpoint.save_checkpoint(exe, str(tmp_path), main_program=main,
                                       scope=scope)
        exe.run(main, feed=spec.sample_batch(16, np.random.RandomState(1)),
                fetch_list=[spec.loss], scope=scope)
        torch.cuda.synchronize()
        assert not w.done()
        w.wait()
    assert exe.step_report(main)["replays"] == 2
    assert all(scope.get(n) is held[n] for n in names)
    assert not np.array_equal(scope.numpy("fm_table"), want["fm_table"])
    with np.load(tmp_path / "checkpoint_0" / "replicated.npz") as z:
        for n in names:
            np.testing.assert_array_equal(z[n], want[n], err_msg=n)
    exe.close()


def test_restored_generator_under_a_captured_dropout_step(dev, tmp_path):
    """A generator state restored with ``set_state`` into the scope's CUDA
    generator keeps the captured step bound: its replays draw what the
    uninterrupted run drew, bitwise."""
    from paddle_tpu_torch import checkpoint

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        t_unique_name.switch()
        x = tfluid.layers.data("x", shape=[256])
        y = tfluid.layers.dropout(x, dropout_prob=0.5)
    scope = t_executor.Scope()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    feed = {"x": np.ones((8, 256), "f4")}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    checkpoint.save_checkpoint(exe, str(tmp_path), main_program=main,
                               scope=scope, async_write=False)
    gen = scope.get(t_executor.RNG_KEY)
    assert gen.device == dev
    want = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
            for _ in range(3)]
    checkpoint.load_checkpoint(exe, str(tmp_path), main_program=main,
                               scope=scope)
    assert scope.get(t_executor.RNG_KEY) is gen
    got = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
           for _ in range(3)]
    report = exe.step_report(main)
    assert report["captures"] == 1 and report["replays"] == 7, report
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(want[0], want[1])
    exe.close()


def test_py_reader_staged_batches_equal_their_host_arrays(dev):
    rd = tfluid.data.py_reader(capacity=2, shapes=[[-1, 64], [-1, 3]],
                               dtypes=["float32", "int64"], name="pr")
    rng = np.random.RandomState(0)
    host = [{"pr_slot_0": rng.randn(32, 64).astype("f4"),
             "pr_slot_1": rng.randint(0, 1000, (32, 3)).astype("int64")}
            for _ in range(6)]
    rd.decorate_batch_generator(lambda: iter(host))
    got = []
    for feed in rd:
        # a big kernel on the consumer's stream first: the copies must
        # be waited for, not raced
        torch.cuda._sleep(1_000_000)
        assert feed["pr_slot_0"].device == dev
        got.append({k: v.cpu().numpy() for k, v in feed.items()})
    assert rd.staged == len(host) == len(got)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g["pr_slot_0"], h["pr_slot_0"])
        assert g["pr_slot_1"].dtype == np.int32
        np.testing.assert_array_equal(g["pr_slot_1"], h["pr_slot_1"])


# -- the dygraph routes (models/bert_dygraph.py) -----------------------------

def _dygraph_bert(place, amp, dropout_rate=0.0, seed=7):
    """A small BERT from the dygraph modules with BERT-base's head width
    (64) and a per-key padding bias: the forms the full model takes."""
    from paddle_tpu_torch.dygraph import layers as dlayers
    from paddle_tpu_torch.models import bert_dygraph

    dlayers.seed(seed)
    with t_unique_name.guard(), tfluid.dygraph.guard(place):
        model = bert_dygraph.bert_base_dygraph(
            vocab_size=1000, seq_len=128, d_model=256, d_ff=512, n_head=4,
            n_layer=2, dropout_rate=dropout_rate, amp=amp)[0]
        for fc in (model.mlm_transform, model.pooler, model.nsp_out):
            fc._build_once(256)
    return model


def _dygraph_feed(batch=3):
    from paddle_tpu_torch.models import bert_dygraph

    feed = list(bert_dygraph.sample_batch(batch, 128, 1000,
                                          np.random.RandomState(5)))
    feed[2] = np.array([128, 77, 100][:batch], np.int32)
    return feed


def _dygraph_route_calls(monkeypatch, amp):
    """The small dygraph BERT's eager step on the card, recording the
    inputs of each call it makes of the flash and fused CE entries (its
    routes to the kernels: 2 attention calls, 1 CE) and the launches."""
    calls = {"flash": [], "ce": []}
    flash, ce = tfa.flash_attention, tfce.linear_smooth_ce

    def spy_flash(q, k, v, num_heads, **kw):
        calls["flash"].append((q.detach(), k.detach(), v.detach(),
                               num_heads, kw))
        return flash(q, k, v, num_heads, **kw)

    def spy_ce(x, w, b, y, eps):
        calls["ce"].append((x.detach(), w.detach(), b.detach(), y, eps))
        return ce(x, w, b, y, eps)

    monkeypatch.setattr(tfa, "flash_attention", spy_flash)
    monkeypatch.setattr(tfce, "linear_smooth_ce", spy_ce)
    fns = (tfa.flash_attention_fwd, tfa.flash_attention_bwd,
           tfce.fused_ce_fwd)
    before = [(f.launches, f.wgmma_launches) for f in fns]
    model = _dygraph_bert(tfluid.CUDAPlace(0), amp)
    with tfluid.dygraph.guard(tfluid.CUDAPlace(0)):
        model(*_dygraph_feed()).backward()
    launches = [(f.launches - a, f.wgmma_launches - b)
                for f, (a, b) in zip(fns, before)]
    return calls, launches


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_dygraph_flash_and_ce_routes_match_plain(dev, monkeypatch, amp):
    """The dygraph BERT's direct calls of the flash kernels (2 + 2 a step,
    a per-key padding bias, heads of 64) and the fused CE kernel (1, an f32
    bias beside bf16 x and W under AMP), on the wgmma forms under bf16,
    each held on the inputs the model gave it against the plain versions:
    the attention output and its gradients within 2e-4 (f32) or 2^-7
    (bf16: one bf16 step) of max(1, max|plain|), the loss and lse within
    2e-5."""
    calls, launches = _dygraph_route_calls(monkeypatch, amp)
    assert launches == [(2, 2 * amp), (2, 2 * amp), (1, 1 * amp)]
    assert len(calls["flash"]) == 2 and len(calls["ce"]) == 1
    tol = 2 ** -7 if amp else 2e-4
    gen = torch.Generator().manual_seed(3)
    for q, k, v, h, kw in calls["flash"]:
        assert q.dtype == (torch.bfloat16 if amp else torch.float32)
        bias = kw.get("bias")
        dout = torch.randn(q.shape, generator=gen).to(dev, q.dtype)
        out, lse = tfa.flash_attention_fwd(q, k, v, h, bias)
        want, want_lse = tfa.attention_plain(q, k, v, h, bias)
        got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, h, bias)
        ref = tfa.attention_bwd_plain(q, k, v, out, lse, dout, h, bias)
        assert _rel_err(out, want) <= tol
        for g, r in zip(got[:3], ref[:3]):
            assert _rel_err(g, r) <= tol
    x, w, b, y, eps = calls["ce"][0]
    assert b.dtype == torch.float32
    x, y = x.reshape(-1, x.shape[-1]), y.reshape(-1)
    loss, lse = tfce.fused_ce_fwd(x, w, b, y, eps)
    want, want_lse = tfce.linear_smooth_ce_plain(x, w, b, y, eps)
    assert _rel_err(loss, want) <= 2e-5 and _rel_err(lse, want_lse) <= 2e-5


def test_captured_dygraph_step_matches_eager(dev):
    """``make_train_step`` captured by ``dygraph.CapturedTrainStep`` (call 1
    eager, call 2 the capture, then replays) against the same step called
    eagerly, twice, from one state and one generator state, under AMP with
    dropout 0.1: the captured run's losses and parameters (one relative
    L2) within twice the two eager runs' distance plus 1e-6 (the flash
    backward sums dq by atomics, in no fixed order); the capture launches
    what call 1 launched, a replay nothing from Python."""
    from paddle_tpu_torch.models import bert_dygraph

    feed = [torch.as_tensor(f).to(dev) for f in _dygraph_feed()]
    out = []
    for captured in (False, False, True):
        model = _dygraph_bert(tfluid.CUDAPlace(0), True, dropout_rate=0.1)
        step, params, opt = bert_dygraph.make_train_step(model, 1e-3)
        gen = torch.Generator(dev).manual_seed(11)
        run = tfluid.dygraph.CapturedTrainStep(step, params, opt, gen) \
            if captured else (lambda *f: step(params, opt, gen, *f)[0])
        losses, launches = [], []
        for _ in range(4):
            before = tfa.flash_attention_fwd.launches
            losses.append(run(*feed).double().reshape(1))
            launches.append(tfa.flash_attention_fwd.launches - before)
        out.append(torch.cat(losses + [p.reshape(-1).double()
                                       for p in params.values()]))
        if captured:
            rep = run.report()
            assert rep["captured"] and (rep["interpreted"], rep["captures"],
                                        rep["replays"]) == (1, 1, 2)
            assert launches == [2, 2, 0, 0]
    e0, e1, cap = out

    def dist(a, b):
        return float((a - b).norm() / b.norm())

    assert dist(cap, e0) <= 2 * dist(e1, e0) + 1e-6, (dist(cap, e0),
                                                      dist(e1, e0))
