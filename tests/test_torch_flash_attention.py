"""The port's plain flash-attention version against ``paddle_tpu``'s
``mha_reference`` and its Pallas kernels (interpret mode), on the CPU,
forward and gradients (dq, dk, dv, dbias against ``jax.grad``), the
dropout hash the CUDA kernels share with it, the gate that chooses
between the kernels and the plain version, and how the kernel wrappers
pad head dims and read a bias. B=2, 4 heads of 8 (d_model 32; also head
dims 12, 16, 40 and 512), seq 16; f32, atol/rtol 1e-5 (gradients 2e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu.ops.flash_attention as fa
from paddle_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 4, 8
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(fa, "_INTERPRET", True)


def _inputs(rng, t, tk, bias_kind, d=D):
    q = rng.normal(0, 1, (B, t, H * d)).astype("f4")
    k = rng.normal(0, 1, (B, tk, H * d)).astype("f4")
    v = rng.normal(0, 1, (B, tk, H * d)).astype("f4")
    bias = None
    if bias_kind == "full":  # a rich bias: one offset per (b, h, t, j)
        return q, k, v, rng.normal(0, 1, (B, H, t, tk)).astype("f4")
    if bias_kind == "rows":  # [1, 1, Tq, Tk]: broadcast over b and h
        return q, k, v, rng.normal(0, 1, (1, 1, t, tk)).astype("f4")
    if bias_kind is not None:
        lengths = rng.randint(1, tk + 1, B)
        bias = np.where(np.arange(tk)[None] < lengths[:, None], 0.0, -1e9)
        bias = bias.astype("f4")
        if bias_kind == "key4":
            bias = bias[:, None, None, :]
    return q, k, v, bias


def _jax_reference(q, k, v, bias, causal):
    d = q.shape[-1] // H

    def split(x):
        return jnp.asarray(x).reshape(B, -1, H, d).transpose(0, 2, 1, 3)

    rb = None
    if bias is not None:
        rb = jnp.asarray(bias if bias.ndim == 4 else bias[:, None, None, :])
    out = fa.mha_reference(split(q), split(k), split(v), rb, causal)
    return np.asarray(out.transpose(0, 2, 1, 3).reshape(B, q.shape[1], -1))


def _port(q, k, v, bias, causal):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tb = torch.from_numpy(bias) if bias is not None else None
    out, lse = tfa.attention_plain(*t, H, bias=tb, causal=causal)
    via_entry = tfa.flash_attention(*t, H, bias=tb, causal=causal)
    assert torch.equal(out, via_entry)
    return out.numpy(), lse.numpy()


def _case_id(case, n):
    """pytest's id of the case's first n fields, plus the head dim where it
    is not the module's D."""
    head = "-".join(str(x) for x in case[:n])
    return head if case[n] == D else "%s-d%d" % (head, case[n])


CASES = [
    # (t_q, t_k, causal, bias kind, the Pallas kernels take it, head dim)
    (16, 16, False, "key4", True, D),
    (16, 16, False, "key2", True, D),
    (16, 16, True, None, True, D),
    (16, 16, True, "key4", True, D),
    (8, 16, True, None, True, D),
    (8, 16, False, "key2", True, D),
    (16, 8, True, None, False, D),  # t_q > t_k: rows with no allowed key
    (16, 8, True, "key4", False, D),
    # the head dims the CUDA kernels round up or reach the end of
    (16, 16, True, "key4", True, 16),
    (8, 16, False, "key2", True, 40),
    (16, 16, False, "key4", True, 512),
    # rich biases (the reference's gate sends them to mha_reference) and a
    # head dim that is not a multiple of 8 (the wrappers pad it)
    (16, 16, True, "full", True, D),
    (8, 16, False, "rows", True, 12),
]


@pytest.mark.parametrize("t,tk,causal,bias_kind,pallas,d", CASES,
                         ids=[_case_id(c, 5) for c in CASES])
def test_plain_matches_reference_and_pallas(rng, t, tk, causal, bias_kind,
                                            pallas, d):
    q, k, v, bias = _inputs(rng, t, tk, bias_kind, d)
    got, lse = _port(q, k, v, bias, causal)
    want = _jax_reference(q, k, v, bias, causal)
    np.testing.assert_allclose(got, want, **TOL)
    if pallas:
        kern = fa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), H,
                                  bias=None if bias is None
                                  else jnp.asarray(bias), causal=causal)
        np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    assert lse.shape == (B, H, t)


def test_fully_masked_rows_average_v_uniformly(rng):
    """Causal t_q > t_k: the first t_q - t_k queries see no key; the
    reference's finfo.min mask gives them the plain mean of V over all
    t_k keys, and lse = finfo.min (log t_k is below its resolution)."""
    t, tk = 16, 8
    q, k, v, _ = _inputs(rng, t, tk, None)
    got, lse = _port(q, k, v, None, causal=True)
    mean_v = v.mean(axis=1)
    for row in range(t - tk):
        np.testing.assert_allclose(got[:, row], mean_v, **TOL)
    assert np.all(lse[:, :, :t - tk] == np.finfo(np.float32).min)


def test_lse_is_logsumexp_of_scaled_biased_logits(rng):
    q, k, v, bias = _inputs(rng, 16, 16, "key2")
    _, lse = _port(q, k, v, bias, causal=False)
    qh = q.reshape(B, 16, H, D).transpose(0, 2, 1, 3).astype("f8")
    kh = k.reshape(B, 16, H, D).transpose(0, 2, 1, 3).astype("f8")
    logits = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(D) + bias[:, None, None]
    m = logits.max(-1)
    want = m + np.log(np.exp(logits - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse, want, **TOL)


GRAD_CASES = [
    # (t_q, t_k, causal, bias kind, head dim)
    (16, 16, True, None, D),     # causal square
    (8, 16, True, "key4", D),    # t_q < t_k, key bias
    (16, 8, True, None, D),      # t_q > t_k: rows with no allowed key
    (16, 16, False, "key2", D),  # key bias, [B, Tk] form
    (12, 16, False, None, D),    # no bias
    (16, 16, True, None, 16),
    (8, 16, False, "key4", 40),
    (12, 16, True, "key2", 512),
    (16, 16, False, "full", D),
    (16, 8, True, "rows", 12),
]


@pytest.mark.parametrize("t,tk,causal,bias_kind,d", GRAD_CASES,
                         ids=[_case_id(c, 4) for c in GRAD_CASES])
def test_plain_gradients_match_jax(rng, t, tk, causal, bias_kind, d):
    """Autograd of the port's plain version against ``jax.grad`` of
    ``paddle_tpu``'s ``flash_attention`` (its Pallas kernels in interpret
    mode where it takes them, ``mha_reference`` otherwise), including the
    gradient of the key bias."""
    q, k, v, bias = _inputs(rng, t, tk, bias_kind, d)
    w = rng.normal(0, 1, (B, t, H * d)).astype("f4")  # output cotangent

    def jloss(q, k, v, bias):
        out = fa.flash_attention(q, k, v, H, bias=bias, causal=causal)
        return jnp.sum(out * jnp.asarray(w))

    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    jb = None if bias is None else jnp.asarray(bias)
    want = jax.grad(jloss, argnums=argnums)(
        *(jnp.asarray(x) for x in (q, k, v)), jb)

    tq, tk_, tv = (torch.from_numpy(x).requires_grad_(True)
                   for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    out = tfa.flash_attention(tq, tk_, tv, H, bias=tb, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    got = [tq.grad, tk_.grad, tv.grad] + ([tb.grad] if tb is not None
                                          else [])
    for name, g, wg in zip("q k v bias".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


def test_dropout_hash_keeps_a_binomial_share():
    """1 - rate of the weights are kept, within 5 standard deviations of
    the binomial, per head; masks of two heads, or of two seeds, differ."""
    rate, b, h, t = 0.1, 2, 4, 64
    keep = tfa.dropout_keep(torch.tensor([12345]), b, h, t, t, rate)
    assert keep.shape == (b, h, t, t) and keep.dtype == torch.bool
    n = t * t
    sd = np.sqrt(n * rate * (1 - rate))
    for share in keep.float().sum((2, 3)).flatten().tolist():
        assert abs(share - n * (1 - rate)) <= 5 * sd
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert not torch.equal(keep[0, 0], keep[1, 0])
    # another seed draws another mask; the same seed the same one
    other = tfa.dropout_keep(torch.tensor([12346]), b, h, t, t, rate)
    assert (keep != other).float().mean() > 0.1
    assert torch.equal(keep, tfa.dropout_keep(torch.tensor([12345]), b, h,
                                              t, t, rate))
    # the threshold is the keep probability in 2^-24 steps
    assert tfa.keep_threshold(rate) == round(0.9 * 2 ** 24)


def test_dropout_hash_matches_its_scalar_definition():
    """The torch integer arithmetic equals the kernels' uint32 hash
    (``csrc/flash_dropout.cuh``) written out in Python integers."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    seed, b, h, tq, tk, rate = 2 ** 31 - 5, 2, 3, 5, 7, 0.3
    keep = tfa.dropout_keep(torch.tensor([seed]), b, h, tq, tk, rate)
    thresh = tfa.keep_threshold(rate)
    for bi in range(b):
        for hi in range(h):
            key = mix(seed ^ mix((bi * h + hi + 0x9E3779B9) & 0xFFFFFFFF))
            for t in range(tq):
                for j in range(tk):
                    r = mix((mix((t * tk + j) ^ key) + key) & 0xFFFFFFFF)
                    assert bool(keep[bi, hi, t, j]) == ((r >> 8) < thresh)


def test_dropout_mask_is_the_same_in_forward_and_backward(rng):
    """One seed drives the forward and the backward: the gradient through
    the dropped weights equals the gradient of the same arithmetic with
    the mask applied by hand."""
    q, k, v, _ = _inputs(rng, 16, 16, None)
    seed = torch.tensor([77])
    rate = 0.25
    keep = tfa.dropout_keep(seed, B, H, 16, 16, rate)

    def run(drop):
        tq, tk_, tv = (torch.from_numpy(x).requires_grad_(True)
                       for x in (q, k, v))
        if drop:
            out, _ = tfa.attention_plain(tq, tk_, tv, H, causal=True,
                                         dropout_rate=rate, seed=seed)
        else:
            qh, kh, vh = (tfa._split(x, H) for x in (tq, tk_, tv))
            logits = qh @ kh.transpose(-1, -2) / np.sqrt(D)
            mask = torch.ones(16, 16, dtype=torch.bool).tril()
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, -1) * keep / (1 - rate)
            out = (probs @ vh).transpose(1, 2).reshape(B, 16, H * D)
        out.square().sum().backward()
        return out.detach(), [x.grad for x in (tq, tk_, tv)]

    out_a, grads_a = run(True)
    out_b, grads_b = run(False)
    np.testing.assert_allclose(out_a.numpy(), out_b.numpy(), **TOL)
    for a, b in zip(grads_a, grads_b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-5)


def test_dropout_draws_from_the_generator(rng):
    q, k, v, _ = _inputs(rng, 16, 16, None)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    plain = tfa.flash_attention(*t, H)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tfa.flash_attention(*t, H, dropout_rate=0.5,
                                   seed=tfa.draw_seed(g, t[0].device))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), plain)


@pytest.mark.parametrize("kwargs,match", [
    ({"bias": torch.zeros(1, 1, 16, 16, device="meta")}, "bias"),
    ({"bias": torch.zeros(B, H, 16, 16, device="meta")}, "bias"),
])
def test_device_path_raises_for_what_the_kernel_lacks(kwargs, match):
    """Off the CPU the entry launches the kernels or raises, and never
    takes the plain version: the gate admits a rich bias, which the
    kernels read by its strides, one row of keys per query, and raises for
    a head dim above the kernels' 512 before any launch (checked on the
    meta device, no GPU here)."""
    q = torch.empty(B, 16, H * D, device="meta")
    assert tfa.kernel_choice(q, H) == {"kernel": "cuda_flash", "reasons": []}
    bias, strides = tfa._bias_args(kwargs[match], B, H, 16, 16, "check")
    assert bias.shape == (B, H, 16, 16) and strides[2] == 16
    wide = torch.empty(B, 16, H * 520, device="meta")
    with pytest.raises(NotImplementedError, match="512"):
        tfa.flash_attention(wide, wide, wide, H, **kwargs)


def test_kernel_wrapper_rejects_unsupported_head_dim():
    """The kernel wrappers take every head dim up to 512 and raise for
    wider ones before any launch."""
    for d in (513, 520):
        q = torch.empty(B, 16, 2 * d, device="meta")
        with pytest.raises(NotImplementedError, match="head dim %d" % d):
            tfa.flash_attention_fwd(q, q, q, 2)
        with pytest.raises(NotImplementedError, match="head dim %d" % d):
            tfa.flash_attention_bwd(q, q, q, q, None, q, 2)


def test_gate_admits_rich_bias_and_odd_head_dims():
    """The gate decides by device and shape: on a device every head dim up
    to 512 runs the kernels, whatever the bias (a rich bias and d = 12
    included); CPU tensors always take the plain version (reason
    ``device``)."""
    for d in (3, 12, 64, 512):
        q = torch.empty(B, 16, H * d, device="meta")
        assert tfa.kernel_choice(q, H) == {"kernel": "cuda_flash",
                                           "reasons": []}
    cpu = tfa.kernel_choice(torch.zeros(B, 16, H * D), H)
    assert cpu["kernel"] == "plain"
    assert [r["check"] for r in cpu["reasons"]] == ["device"]


# the forward's form by shape: Tk, head dim, bias ("key": [B, Tk] padding
# mask, "key4": [B, 1, 1, Tk], "head": [1, H, 1, Tk], "full": one offset
# per logit), dtype -> form. The padded head dim is the next multiple of 8.
FORM_TABLE = [
    (256, 64, "key", torch.bfloat16, "wgmma"),     # the training shape
    (255, 64, None, torch.bfloat16, "wgmma"),
    (257, 64, "key", torch.bfloat16, "mma_sync"),  # past the key slots
    (16, 64, "key4", torch.bfloat16, "wgmma"),
    (1, 64, None, torch.bfloat16, "wgmma"),
    (256, 128, None, torch.bfloat16, "wgmma"),
    (256, 112, "head", torch.bfloat16, "wgmma"),
    (256, 136, None, torch.bfloat16, "mma_sync"),  # head dim above 128
    (256, 120, None, torch.bfloat16, "mma_sync"),  # 7.5 k16 steps
    (100, 12, None, torch.bfloat16, "wgmma"),      # padded to 16
    (100, 8, None, torch.bfloat16, "mma_sync"),    # half a k16 step
    (100, 40, None, torch.bfloat16, "mma_sync"),
    (100, 48, None, torch.bfloat16, "wgmma"),
    (100, 512, None, torch.bfloat16, "mma_sync"),
    (256, 64, "full", torch.bfloat16, "mma_sync"),  # a bias per query
    (256, 64, "key", torch.float32, "mma_sync"),    # f32: 3xTF32 only
    (300, 64, None, torch.float32, "mma_sync"),
]


@pytest.mark.parametrize("tk,d,bias_kind,dtype,form", FORM_TABLE)
def test_forward_form_routes_by_shape(tk, d, bias_kind, dtype, form):
    """On a device the gate names the forward's form by shape alone,
    before any launch (meta tensors, no GPU here): the bf16 single pass on
    warpgroup products up to 256 keys and a padded head dim that is a
    multiple of 16 up to 128, with no bias or one row of keys per (b, h);
    the mma.sync form for every other bf16 call and for f32. A bf16
    call off the wgmma form says why."""
    q = torch.empty(B, 16, H * d, device="meta", dtype=dtype)
    k = torch.empty(B, tk, H * d, device="meta", dtype=dtype)
    bias = {None: None,
            "key": torch.empty(B, tk, device="meta"),
            "key4": torch.empty(B, 1, 1, tk, device="meta"),
            "head": torch.empty(1, H, 1, tk, device="meta"),
            "full": torch.empty(B, H, 16, tk, device="meta")}[bias_kind]
    choice = tfa.kernel_choice(q, H, k, bias)
    assert choice["kernel"] == "cuda_flash" and choice["reasons"] == []
    assert choice["form"] == form
    assert tfa.fwd_form(q, k, H, bias)[0] == form
    assert ("form_reason" in choice) == (form == "mma_sync"
                                         and dtype == torch.bfloat16)
    # on the CPU the plain version runs, with no form
    cpu = tfa.kernel_choice(torch.zeros(B, 16, H * d, dtype=dtype), H,
                            torch.zeros(B, tk, H * d, dtype=dtype))
    assert cpu["kernel"] == "plain" and "form" not in cpu


# the backward's form by shape: Tq, Tk, head dim, bias (as FORM_TABLE),
# dtype -> form. No key limit: the wgmma backward walks the query tiles of
# 64 keys a block at any Tq and Tk.
BWD_FORM_TABLE = [
    (256, 256, 64, "key", torch.bfloat16, "wgmma"),    # the training shape
    (256, 256, 64, None, torch.bfloat16, "wgmma"),     # causal self
    (100, 257, 64, "key", torch.bfloat16, "wgmma"),    # past the fwd's 256
    (64, 4096, 64, "key4", torch.bfloat16, "wgmma"),
    (1, 1, 16, None, torch.bfloat16, "wgmma"),
    (300, 16, 128, "head", torch.bfloat16, "wgmma"),
    (100, 255, 12, None, torch.bfloat16, "wgmma"),     # padded to 16
    (100, 100, 48, "key", torch.bfloat16, "wgmma"),
    (100, 100, 8, None, torch.bfloat16, "mma_sync"),   # half a k16 step
    (100, 100, 40, None, torch.bfloat16, "mma_sync"),
    (256, 256, 120, None, torch.bfloat16, "mma_sync"),
    (256, 256, 136, None, torch.bfloat16, "mma_sync"),  # head dim above 128
    (256, 256, 512, "key", torch.bfloat16, "mma_sync"),
    (256, 256, 64, "full", torch.bfloat16, "mma_sync"),  # a bias per query
    (256, 256, 64, "key", torch.float32, "mma_sync"),    # f32: 3xTF32 only
]


@pytest.mark.parametrize("tq,tk,d,bias_kind,dtype,form", BWD_FORM_TABLE)
def test_backward_form_routes_by_shape(tq, tk, d, bias_kind, dtype, form):
    """On a device the gate names the backward's form by shape alone,
    before any launch (meta tensors, no GPU here): warpgroup products for
    bf16 with a padded head dim that is a multiple of 16 up to 128 and no
    bias or one row of keys per (b, h), at any Tq and Tk; the mma.sync
    form for every other bf16 call and for f32. A bf16 call off the wgmma
    form says why; the forward's form is decided on its own."""
    q = torch.empty(B, tq, H * d, device="meta", dtype=dtype)
    k = torch.empty(B, tk, H * d, device="meta", dtype=dtype)
    bias = {None: None,
            "key": torch.empty(B, tk, device="meta"),
            "key4": torch.empty(B, 1, 1, tk, device="meta"),
            "head": torch.empty(1, H, 1, tk, device="meta"),
            "full": torch.empty(B, H, tq, tk, device="meta")}[bias_kind]
    choice = tfa.kernel_choice(q, H, k, bias)
    assert choice["kernel"] == "cuda_flash" and choice["reasons"] == []
    assert choice["bwd_form"] == form
    assert tfa.bwd_form(q, k, H, bias)[0] == form
    assert choice["form"] == tfa.fwd_form(q, k, H, bias)[0]
    assert ("bwd_form_reason" in choice) == (form == "mma_sync"
                                             and dtype == torch.bfloat16)
    cpu = tfa.kernel_choice(torch.zeros(B, tq, H * d, dtype=dtype), H,
                            torch.zeros(B, tk, H * d, dtype=dtype))
    assert cpu["kernel"] == "plain" and "bwd_form" not in cpu


def test_bf16_wrapper_refuses_before_building():
    """What neither form takes raises before any build or launch, in bf16
    too: a head dim above 512, mixed dtypes, disagreeing shapes, a dropout
    rate outside [0, 1)."""
    bf = torch.bfloat16
    wide = torch.empty(B, 16, 2 * 520, device="meta", dtype=bf)
    with pytest.raises(NotImplementedError, match="head dim 520"):
        tfa.flash_attention_fwd(wide, wide, wide, 2)
    q = torch.empty(B, 16, H * 64, device="meta", dtype=bf)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_fwd(q, q.float(), q, H)
    with pytest.raises(ValueError, match="disagree"):
        tfa.flash_attention_fwd(q, q[:, :, :-8], q, H)
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="dropout_rate"):
        tfa.flash_attention_fwd(q, q, q, H, None, False, 1.0, seed)


@pytest.mark.parametrize("d", [64, 40])  # the wgmma and the mma.sync form
def test_bf16_backward_refuses_before_building(d):
    """What neither backward form takes raises before any build or launch
    (meta tensors): mixed dtypes, dout or out in another dtype or shape,
    a head dim above 512, a dropout rate outside [0, 1)."""
    bf = torch.bfloat16
    q = torch.empty(B, 16, H * d, device="meta", dtype=bf)
    lse = torch.empty(B, H, 16, device="meta")
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_bwd(q, q.float(), q, q, lse, q, H)
    with pytest.raises(TypeError, match="dout"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q.float(), H)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q[:, :8], H)
    wide = torch.empty(B, 16, 2 * 520, device="meta", dtype=bf)
    with pytest.raises(NotImplementedError, match="head dim 520"):
        tfa.flash_attention_bwd(wide, wide, wide, wide, lse, wide, 2)
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="dropout_rate"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q, H, None, False, 1.5,
                                seed)


@pytest.mark.parametrize("d", [3, 8, 12, 16, 40, 512])
def test_kernel_wrapper_takes_head_dims_up_to_512(d):
    """d = 3 to 512 pass the wrappers' shape checks (meta tensors, nothing
    launched) and the gate admits them."""
    q = torch.empty(B, 16, H * d, device="meta")
    for dtypes in (tfa._DTYPE_CODES, (torch.float32,)):
        assert tfa._check_qkv(q, q, q, H, "check", dtypes)[-1] == d
    assert tfa.kernel_choice(q, H)["kernel"] == "cuda_flash"


@pytest.mark.parametrize("d", [3, 12, 20])
def test_padded_head_dim_changes_no_attention(rng, d):
    """The wrappers run a head dim that is not a multiple of 8 as the next
    multiple of 8, each head followed by zero columns, at the scale of the
    true d: the zero columns change no logit, and the output's extra
    columns are zero and cut off."""
    q, k, v, _ = _inputs(rng, 16, 12, None, d)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    dp = -(-d // 8) * 8
    pq, pk, pv = (tfa._pad_heads(x, H, d, dp) for x in (q, k, v))
    assert pq.shape == (B, 16, H * dp)
    assert torch.equal(tfa._cut_heads(pq, H, d, dp), q)
    split = tfa._split
    want, want_lse = tfa.mha_plain(split(q, H), split(k, H), split(v, H),
                                   causal=True)
    got, got_lse = tfa.mha_plain(split(pq, H), split(pk, H), split(pv, H),
                                 causal=True, scale=1.0 / np.sqrt(d))
    assert torch.all(got[..., d:] == 0)
    torch.testing.assert_close(got[..., :d], want, **TOL)
    torch.testing.assert_close(got_lse, want_lse, **TOL)


BIAS_SHAPES = [(B, 16), (1, 16), (B, 1, 1, 16), (1, H, 1, 16), (B, H, 8, 16),
               (1, 1, 8, 16), (16,), (B, H, 8, 1)]


@pytest.mark.parametrize("shape", BIAS_SHAPES,
                         ids=["x".join(map(str, s)) for s in BIAS_SHAPES])
def test_kernel_bias_reads_and_grads_every_form(rng, shape):
    """The bias the kernels read, rebuilt from the pointer and strides the
    wrappers pass ([B, H, Tq, Tk], key dim contiguous), equals the bias
    broadcast as the plain version adds it; and the kernel's dS ([B, H, Tq,
    Tk], or its per-head sum over the queries where a padding mask gives
    the query stride 0) summed to the bias's shape equals autograd's
    gradient of the bias through the plain version."""
    t, tk = 8, 16
    bias = torch.from_numpy(rng.normal(0, 1, shape).astype("f4"))
    full, (sb, sh, st) = tfa._bias_args(bias, B, H, t, tk, "check")
    seen = torch.as_strided(full, (B, H, t, tk), (sb, sh, st, 1))
    want = tfa._lift_bias(bias).expand(B, H, t, tk)
    assert torch.equal(seen, want)
    ds = torch.from_numpy(rng.normal(0, 1, (B, H, t, tk)).astype("f4"))
    leaf = bias.clone().requires_grad_(True)
    (tfa._lift_bias(leaf) * ds).sum().backward()
    kernel_ds = ds.sum(2, keepdim=True) if st == 0 else ds
    torch.testing.assert_close(tfa._sum_to_bias(kernel_ds, bias), leaf.grad,
                               **TOL)


def test_flash_op_records_kernel_choice(rng):
    """The flash_attention op of a tiny Transformer records the gate's
    decision in ``_kernel_choice`` after a CPU run, as the reference's op
    records its plan."""
    import paddle_tpu_torch as tfluid

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        spec = tfluid.models.transformer.transformer_base(
            src_vocab=32, trg_vocab=32, seq_len=8, d_model=16, d_ff=32,
            n_head=2, n_layer=1, dropout_rate=0.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=spec.sample_batch(2, rng), fetch_list=[spec.loss],
            scope=scope)
    ops = [op for op in main.global_block().ops
           if op.type == "flash_attention"]
    assert len(ops) == 3  # encoder self, decoder self, decoder cross
    for op in ops:
        assert op.attrs["_kernel_choice"] == {
            "kernel": "plain", "reasons": [
                {"check": "device",
                 "detail": "CPU tensors take the plain version"}]}


BF16_CASES = [
    # (t_q, t_k, causal, bias kind, head dim): the cases the reference
    # gives its Pallas kernels (a rich bias goes to its mha_reference,
    # whose bf16 logits no kernel rounds)
    (16, 16, False, "key4", D),
    (16, 16, True, None, D),
    (8, 16, True, "key2", 16),
    (8, 16, False, "key4", 40),
]


@pytest.mark.parametrize("t,tk,causal,bias_kind,d", BF16_CASES,
                         ids=[_case_id(c, 4) for c in BF16_CASES])
def test_bf16_plain_matches_pallas(rng, t, tk, causal, bias_kind, d):
    """bf16 q/k/v (AMP): the port's plain forward and backward (the
    ``_FlashAttention`` Function on CPU tensors) against ``jax.grad`` of
    ``paddle_tpu``'s ``flash_attention`` on the same bf16 inputs, its
    Pallas kernels in interpret mode. Both take f32 logits from the bf16
    operands, round the normalised weights and dS to bf16 for their
    products and store out, dq, dk, dv in bf16: out, dq, dk and dv within
    2^-7 * max(1, max|reference|) (two bf16 steps; the products sum in
    other orders in f32 and may round the other way), the f32 dbias within
    1e-4."""
    q, k, v, bias = _inputs(rng, t, tk, bias_kind, d)
    w = rng.normal(0, 1, (B, t, H * d)).astype("f4")
    bf = jnp.bfloat16

    def jloss(q, k, v, bias):
        out = fa.flash_attention(q, k, v, H, bias=bias, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w)), out

    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    jb = None if bias is None else jnp.asarray(bias)
    jin = [jnp.asarray(x).astype(bf) for x in (q, k, v)]
    want_grads, want_out = jax.grad(jloss, argnums=argnums, has_aux=True)(
        *jin, jb)
    assert want_out.dtype == bf

    tin = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
           for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    out = tfa.flash_attention(*tin, H, bias=tb, causal=causal)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    got = [x.grad for x in tin] + ([tb.grad] if tb is not None else [])
    pairs = [("out", out, want_out)] + list(zip(
        ("dq", "dk", "dv", "dbias"), got, want_grads))
    for name, g, wg in pairs:
        wg = np.asarray(jnp.asarray(wg).astype(jnp.float32))
        assert g.dtype == (torch.float32 if name == "dbias"
                           else torch.bfloat16), name
        tol = 1e-4 if name == "dbias" else 2.0 ** -7
        np.testing.assert_allclose(g.detach().float().numpy(), wg, rtol=0,
                                   atol=tol * max(1.0, np.abs(wg).max()),
                                   err_msg=name)
