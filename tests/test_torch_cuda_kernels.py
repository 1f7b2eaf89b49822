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


def test_tiny_transformer_step_on_gpu_matches_cpu(dev, fresh_port_programs):
    """One Adam step of a tiny Transformer (dropout 0) on the card and on
    the CPU from the same weights: loss and grads within 1e-4, and the
    step launches every training kernel the expected number of times."""
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
    before = [f.launches for f in fns]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    assert [f.launches - n for f, n in zip(fns, before)] == [6, 6, 12, 12, 1]
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

