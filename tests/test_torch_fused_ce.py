"""The port's fused projection + label-smoothed CE on the CPU: its plain
version against ``paddle_tpu``'s Pallas kernel (interpret mode) and that
kernel's chunked-recompute vjp, for loss, dx, dW and db (eps 0 and 0.1,
with and without b, V not a multiple of the block); and the port's chunked
backward (what the CUDA path runs after its kernel) against autograd of
the plain version. f32: loss atol 1e-5, gradients atol 2e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu.ops.fused_ce as jfce
from paddle_tpu_torch.ops import fused_ce as tfce

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfce, "_INTERPRET", True)


def _data(rng, t, d, v, with_bias):
    x = rng.normal(0, 1, (t, d)).astype("f4")
    w = (rng.normal(0, 1, (d, v)) / np.sqrt(d)).astype("f4")
    b = rng.normal(0, 0.5, (v,)).astype("f4") if with_bias else None
    y = rng.randint(0, v, (t,)).astype("int32")
    g = rng.normal(0, 1, (t,)).astype("f4")  # loss cotangent
    return x, w, b, y, g


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t,d,v", [(24, 16, 200), (16, 8, 128)])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_plain_matches_pallas_kernel_and_vjp(rng, eps, with_bias, t, d, v):
    x, w, b, y, g = _data(rng, t, d, v, with_bias)
    jb = None if b is None else jnp.asarray(b)
    loss, vjp = jax.vjp(lambda x, w, b: jfce._fused(x, w, b, jnp.asarray(y),
                                                    eps),
                        jnp.asarray(x), jnp.asarray(w), jb)
    want_grads = vjp(jnp.asarray(g))

    tx, tw, tb = (None if a is None else a.requires_grad_(True)
                  for a in _torch(x, w, b))
    got = tfce.linear_smooth_ce(tx, tw, tb, torch.from_numpy(y), eps)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(loss),
                               atol=1e-5, rtol=1e-6)
    (got * torch.from_numpy(g)).sum().backward()
    for name, tt, wg in zip(("dx", "dw", "db"), (tx, tw, tb), want_grads):
        if tt is None:
            assert wg is None
            continue
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(wg),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_chunked_backward_equals_autograd_of_plain(rng, monkeypatch, eps,
                                                   with_bias):
    """The chunked recompute, forced into several ragged chunks, against
    autograd of the plain projection + closed-form CE."""
    t, d, v = 50, 12, 70
    x, w, b, y, g = _data(rng, t, d, v, with_bias)
    tx, tw, tb = (None if a is None else a.requires_grad_(True)
                  for a in _torch(x, w, b))
    ty = torch.from_numpy(y)
    loss, lse = tfce.linear_smooth_ce_plain(tx, tw, tb, ty, eps)
    (loss * torch.from_numpy(g)).sum().backward()

    monkeypatch.setattr(tfce, "_CHUNK_BYTES", 16 * 4 * v)  # 16-row chunks
    assert tfce._chunk_rows(t, v) == 16
    dx, dw, db = tfce.linear_smooth_ce_bwd(
        tx.detach(), tw.detach(), None if tb is None else tb.detach(), ty,
        lse.detach(), torch.from_numpy(g), eps)
    for name, got, tt in (("dx", dx, tx), ("dw", dw, tw), ("db", db, tb)):
        if tt is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), tt.grad.numpy(),
                                   err_msg=name, **TOL)


def test_chunk_stays_under_half_a_gigabyte():
    rows = tfce._chunk_rows(32768, 30000)
    assert rows == 4096 and rows * 30000 * 4 <= 512 * 2 ** 20


def test_entry_takes_leading_dims(rng):
    """On [B, S, D] activations with [B, S] labels the entry gives the
    per-position loss [B, S], row for row the flat call's."""
    x, w, _, y, _ = _data(rng, 12, 8, 40, False)
    tx, tw = _torch(x, w)
    flat = tfce.linear_smooth_ce(tx, tw, None, torch.from_numpy(y), 0.1)
    lead = tfce.linear_smooth_ce(tx.reshape(3, 4, 8), tw, None,
                                 torch.from_numpy(y).reshape(3, 4), 0.1)
    assert lead.shape == (3, 4)
    assert torch.equal(lead.reshape(-1), flat)


def test_kernel_wrapper_validates_before_building():
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 30, device="meta")
    y = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="f32"):
        tfce.fused_ce_fwd(x.bfloat16(), w.bfloat16(), None, y, 0.1)
    with pytest.raises(ValueError, match="labels"):
        tfce.fused_ce_fwd(x, w, None, y[:2], 0.1)
    with pytest.raises(ValueError, match="w"):
        tfce.fused_ce_fwd(x, w.t(), None, y, 0.1)
