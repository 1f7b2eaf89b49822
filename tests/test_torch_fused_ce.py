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


# ---------------------------------------------------------------------------
# the CUDA kernel's split plan and its arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,v,sms", [(32768, 30000, 132), (4096, 30000, 132),
                                     (777, 300, 132), (1000, 30001, 132),
                                     (1, 1, 132), (129, 999, 7),
                                     (5000, 129, 1), (300, 257, 132)])
def test_split_plan_covers_every_column_once(t, v, sms):
    """Every vocabulary column lies in exactly one split, every split is
    non-empty and made of whole 128-column tiles (the last may be ragged),
    and rows go 128 a block, as the C entry requires."""
    nsplit, per, rows = tfce.split_plan(t, v, sms)
    assert rows == 128 and per > 0 and per % 128 == 0
    owner = np.zeros(v, dtype=int)
    for k in range(nsplit):
        lo, hi = k * per, min(v, (k + 1) * per)
        assert lo < hi, "split %d is empty" % k
        owner[lo:hi] += 1
    assert (owner == 1).all()


def test_split_plan_splits_only_to_fill_the_card():
    """One row tile on 132 SMs splits the vocabulary as far as its tiles go;
    row tiles filling whole waves on their own keep one split."""
    assert tfce.split_plan(128, 30000, 132)[0] == 118   # 235 tiles, 2 each
    assert tfce.split_plan(132 * 128, 30000, 132)[0] == 1
    assert tfce.split_plan(4096, 30000, 132)[:2] == (4, 59 * 128)


def _f64_ce(x, w, b, y, eps):
    z = torch.matmul(x.double(), w.double())
    if b is not None:
        z = z + b.double()
    lse = torch.logsumexp(z, dim=-1)
    zy = z.gather(1, y.long()[:, None])[:, 0]
    return lse - (1 - eps) * zy - eps * z.mean(dim=-1), lse


def test_3xtf32_emulation_tracks_f64_and_single_tf32_does_not(rng):
    """At the training width (D 512) and a ragged vocabulary (V 3000 =
    23 tiles + 56 columns, 24 splits on 132 SMs), the kernel's arithmetic
    (3xTF32 products, its order of online statistics and merges) lands as
    close to an f64 projection + closed-form CE as the plain f32 version
    does: loss and lse within 2x its max abs and relative L2 errors (both
    are f32 roundings of values near 10: 0.9-1.13x over three seeds), and
    relative L2 at most 2^-22. A single TF32 product is 54-530x the plain
    error, so the f64 check on the card (at most 2x) tells them apart; the
    bound here is 16x."""
    t, d, v = 256, 512, 3000
    x = torch.from_numpy(rng.randn(t, d).astype("f4"))
    w = torch.from_numpy((rng.randn(d, v) / np.sqrt(d)).astype("f4"))
    b = torch.from_numpy((rng.randn(v) * 0.5).astype("f4"))
    y = torch.from_numpy(rng.randint(0, v, t))
    exact = _f64_ce(x, w, b, y, 0.1)
    plan = tfce.split_plan(t, v, 132)
    assert plan[0] == 24

    def errs(got):
        out = []
        for g, e in zip(got, exact):
            dd = g.double() - e
            out.append((dd.abs().max().item(), (dd.norm() / e.norm()).item()))
        return out

    plain = errs(tfce.linear_smooth_ce_plain(x, w, b, y, 0.1))
    three = errs(tfce.linear_smooth_ce_3xtf32_emulated(x, w, b, y, 0.1, plan))
    one = errs(tfce.linear_smooth_ce_3xtf32_emulated(x, w, b, y, 0.1, plan,
                                                     passes=1))
    for name, p, th, on in zip(("loss", "lse"), plain, three, one):
        assert th[0] <= 2 * p[0] and th[1] <= 2 * p[1], (name, th, p)
        assert th[1] <= 2.0 ** -22, (name, th)
        assert on[1] >= 16 * p[1] and on[1] > 2 * p[1], (name, on, p)


@pytest.mark.parametrize("plan", ["one_split", "split_per_tile"])
@pytest.mark.parametrize("t,d,v,with_bias,eps", [
    (24, 16, 200, True, 0.1), (16, 8, 128, False, 0.0),
    (130, 72, 300, True, 0.1), (7, 37, 257, False, 0.1)])
def test_3xtf32_emulation_matches_pallas_kernel(rng, plan, t, d, v,
                                                with_bias, eps):
    """The emulated kernel against the JAX package's Pallas kernel in
    interpret mode, with labels at 0, at V - 1 and out of range (both add
    z[y] = 0) and a row of equal logits (x = 0), over one split and over a
    split per tile: loss and lse within 1e-5 (f32 sums in other orders)."""
    x, w, b, y, _ = _data(rng, t, d, v, with_bias)
    x[0] = 0.0
    y[:3] = [0, v - 1, v + 5]
    want_loss, want_lse = jfce._fwd_impl(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        jnp.asarray(y), eps)
    p = (1, -(-v // 128) * 128, 128) if plan == "one_split" else \
        (-(-v // 128), 128, 128)
    tx, tw, tb, ty = _torch(x, w, b, y)
    loss, lse = tfce.linear_smooth_ce_3xtf32_emulated(tx, tw, tb, ty, eps, p)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=1e-6)


def test_emulation_rejects_a_plan_the_kernel_refuses():
    x, w = torch.zeros(4, 8), torch.zeros(8, 300)
    y = torch.zeros(4, dtype=torch.int64)
    for plan in [(2, 100, 128), (1, 256, 128), (3, 128, 64)]:
        with pytest.raises(ValueError, match="plan"):
            tfce.linear_smooth_ce_3xtf32_emulated(x, w, None, y, 0.1, plan)
