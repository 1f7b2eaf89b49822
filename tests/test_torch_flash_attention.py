"""The port's plain flash-attention version against ``paddle_tpu``'s
``mha_reference`` and its Pallas kernels (interpret mode), on the CPU,
forward and gradients (dq, dk, dv, dbias against ``jax.grad``), and the
dropout hash the CUDA kernels share with it. B=2, 4 heads of 8 (d_model
32), seq 16; f32, atol/rtol 1e-5 (gradients 2e-5)."""

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


def _inputs(rng, t, tk, bias_kind):
    q = rng.normal(0, 1, (B, t, H * D)).astype("f4")
    k = rng.normal(0, 1, (B, tk, H * D)).astype("f4")
    v = rng.normal(0, 1, (B, tk, H * D)).astype("f4")
    bias = None
    if bias_kind is not None:
        lengths = rng.randint(1, tk + 1, B)
        bias = np.where(np.arange(tk)[None] < lengths[:, None], 0.0, -1e9)
        bias = bias.astype("f4")
        if bias_kind == "key4":
            bias = bias[:, None, None, :]
    return q, k, v, bias


def _jax_reference(q, k, v, bias, causal):
    def split(x):
        return jnp.asarray(x).reshape(B, -1, H, D).transpose(0, 2, 1, 3)

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


CASES = [
    # (t_q, t_k, causal, bias kind, the Pallas kernels take it)
    (16, 16, False, "key4", True),
    (16, 16, False, "key2", True),
    (16, 16, True, None, True),
    (16, 16, True, "key4", True),
    (8, 16, True, None, True),
    (8, 16, False, "key2", True),
    (16, 8, True, None, False),  # t_q > t_k: rows with no allowed key
    (16, 8, True, "key4", False),
]


@pytest.mark.parametrize("t,tk,causal,bias_kind,pallas", CASES)
def test_plain_matches_reference_and_pallas(rng, t, tk, causal, bias_kind,
                                            pallas):
    q, k, v, bias = _inputs(rng, t, tk, bias_kind)
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
    # (t_q, t_k, causal, bias kind)
    (16, 16, True, None),     # causal square
    (8, 16, True, "key4"),    # t_q < t_k, key bias
    (16, 8, True, None),      # t_q > t_k: rows with no allowed key
    (16, 16, False, "key2"),  # key bias, [B, Tk] form
    (12, 16, False, None),    # no bias
]


@pytest.mark.parametrize("t,tk,causal,bias_kind", GRAD_CASES)
def test_plain_gradients_match_jax(rng, t, tk, causal, bias_kind):
    """Autograd of the port's plain version against ``jax.grad`` of
    ``paddle_tpu``'s ``flash_attention`` (its Pallas kernels in interpret
    mode where it takes them, ``mha_reference`` otherwise), including the
    gradient of the key bias."""
    q, k, v, bias = _inputs(rng, t, tk, bias_kind)
    w = rng.normal(0, 1, (B, t, H * D)).astype("f4")  # output cotangent

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
        return tfa.flash_attention(*t, H, dropout_rate=0.5, generator=g)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), plain)


@pytest.mark.parametrize("kwargs,match", [
    ({"bias": torch.zeros(1, 1, 16, 16, device="meta")}, "bias"),
    ({"bias": torch.zeros(B, H, 16, 16, device="meta")}, "bias"),
])
def test_device_path_raises_for_what_the_kernel_lacks(kwargs, match):
    """Off the CPU the entry launches the kernel or raises; it never falls
    back to the plain version (checked on the meta device, no GPU here)."""
    q = torch.empty(B, 16, H * D, device="meta")
    with pytest.raises(NotImplementedError, match=match):
        tfa.flash_attention(q, q, q, H, **kwargs)


def test_kernel_wrapper_rejects_unsupported_head_dim():
    q = torch.empty(B, 16, 2 * 48, device="meta")
    with pytest.raises(NotImplementedError, match="head dim 48"):
        tfa.flash_attention_fwd(q, q, q, 2)
