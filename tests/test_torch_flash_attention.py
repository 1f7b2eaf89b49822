"""The port's plain flash-attention version against ``paddle_tpu``'s
``mha_reference`` and its Pallas kernels (interpret mode), on the CPU.
B=2, 4 heads of 8 (d_model 32), seq 16; f32, atol/rtol 1e-5."""

import numpy as np
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
    ({"dropout_rate": 0.1}, "dropout"),
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
