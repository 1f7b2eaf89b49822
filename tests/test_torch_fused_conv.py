"""The port's fused conv + BN (+ residual)(+ relu) against ``paddle_tpu``'s
on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``paddle_tpu.ops.fused_conv._INTERPRET``, as ``tests/test_fused_conv.py``
does); the port runs the plain versions of its CUDA kernels, inside the
same ``torch.autograd.Function``s the card uses. The geometries are the
four bottleneck shapes of ``tests/test_fused_conv.py`` plus a 3x3 body at
7x7 (H*W = 49, the size of ResNet-50's stage 4). Tolerances are the JAX
package's own for these kernels: 3e-5 forward, 2e-4 backward (f32; the
two sides sum in different orders)."""

import numpy as np
import pytest
import torch

import paddle_tpu.ops.fused_conv as jfc
from paddle_tpu_torch.ops import fused_conv as tfc

FWD_TOL = dict(rtol=3e-5, atol=3e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)

# (C_in, C_out, k, stride, act, with_residual, H = W)
GEOMS = [
    (16, 8, 1, 1, "relu", False, 8),   # reduce 1x1
    (8, 8, 3, 1, "relu", False, 8),    # body 3x3
    (8, 16, 1, 1, "relu", True, 8),    # expand 1x1 + residual + relu
    (16, 8, 1, 2, None, False, 8),     # stride-2 1x1 shortcut
    (16, 8, 3, 1, "relu", True, 7),    # 3x3 at H*W = 49
]
OUTS = ("y", "mean_out", "var_out", "saved_mean", "saved_var")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfc, "_INTERPRET", True)


def _mk(rng, cin, cout, k, stride, with_res, hw, n=2):
    ho = (hw - 1) // stride + 1
    arrays = [rng.randn(n, cin, hw, hw).astype("f4"),
              (rng.randn(cout, cin, k, k) * 0.2).astype("f4"),
              (rng.rand(cout) + 0.5).astype("f4"),
              (rng.randn(cout) * 0.1).astype("f4"),
              (rng.randn(cout) * 0.1).astype("f4"),
              (rng.rand(cout) + 0.5).astype("f4")]
    res = rng.randn(n, cout, ho, ho).astype("f4") if with_res else None
    return arrays, res


def _kw(k, stride, act, **extra):
    return dict(strides=(stride, stride), paddings=((k - 1) // 2,) * 2,
                eps=1e-5, momentum=0.9, act=act, **extra)


def _jax(arrays, res, kw):
    import jax.numpy as jnp

    return jfc.fused_conv_bn_act(
        *[jnp.asarray(a) for a in arrays],
        residual=None if res is None else jnp.asarray(res), **kw)


def _port(arrays, res, kw, grad=False):
    ts = [torch.from_numpy(a.copy()).requires_grad_(grad and i < 4)
          for i, a in enumerate(arrays)]
    r = torch.from_numpy(res.copy()).requires_grad_(grad) \
        if res is not None else None
    return tfc.fused_conv_bn_act(*ts, residual=r, **kw), ts, r


@pytest.mark.parametrize("cin,cout,k,stride,act,with_res,hw", GEOMS)
def test_forward_matches_jax(rng, cin, cout, k, stride, act, with_res, hw):
    arrays, res = _mk(rng, cin, cout, k, stride, with_res, hw)
    kw = _kw(k, stride, act)
    want = _jax(arrays, res, kw)
    got, _, _ = _port(arrays, res, kw)
    for name, g, w in zip(OUTS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **FWD_TOL)


@pytest.mark.parametrize("cin,cout,k,stride,act,with_res,hw", GEOMS)
def test_backward_through_fused_train_matches_jax(rng, cin, cout, k, stride,
                                                  act, with_res, hw):
    import jax
    import jax.numpy as jnp

    arrays, res = _mk(rng, cin, cout, k, stride, with_res, hw)
    kw = _kw(k, stride, act)
    mean, var = (jnp.asarray(a) for a in arrays[4:])

    def loss(x, w, g, b, *r):
        y = jfc.fused_conv_bn_act(x, w, g, b, mean, var,
                                  residual=r[0] if r else None, **kw)[0]
        return jnp.sum(y * jnp.cos(y))

    args = [jnp.asarray(a) for a in arrays[:4]] + (
        [jnp.asarray(res)] if with_res else [])
    want = jax.grad(loss, argnums=tuple(range(len(args))))(*args)

    (y, *_), ts, r = _port(arrays, res, kw, grad=True)
    assert type(y.grad_fn).__name__ == "_FusedTrainBackward"
    wrt = ts[:4] + ([r] if with_res else [])
    got = torch.autograd.grad((y * torch.cos(y)).sum(), wrt)
    for name, g, w in zip(("dx", "dw", "dgamma", "dbeta", "dres"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("with_res", [False, True])
def test_inference_path_matches_jax(rng, with_res):
    arrays, res = _mk(rng, 8, 16, 3, 1, with_res, 7)
    kw = _kw(3, 1, "relu", is_test=True)
    want = _jax(arrays, res, kw)
    got, ts, _ = _port(arrays, res, kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **FWD_TOL)
    assert got[3] is None and got[4] is None
    assert got[1] is ts[4] and got[2] is ts[5]  # moving stats pass through


def test_global_stats_backward_through_fused_infer_matches_jax(rng):
    import jax
    import jax.numpy as jnp

    arrays, res = _mk(rng, 8, 16, 1, 1, True, 8)
    kw = _kw(1, 1, "relu", use_global_stats=True)
    mean, var = (jnp.asarray(a) for a in arrays[4:])

    def loss(x, w, g, b, r):
        y = jfc.fused_conv_bn_act(x, w, g, b, mean, var, residual=r, **kw)[0]
        return jnp.sum(y * jnp.cos(y))

    args = [jnp.asarray(a) for a in arrays[:4]] + [jnp.asarray(res)]
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    (y, *_), ts, r = _port(arrays, res, kw, grad=True)
    assert type(y.grad_fn).__name__ == "_FusedInferBackward"
    got = torch.autograd.grad((y * torch.cos(y)).sum(), ts[:4] + [r])
    for name, g, w in zip(("dx", "dw", "dgamma", "dbeta", "dres"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


GATE_CASES = [  # tests/test_fused_conv.py:185-199, with the verdict
    (((2, 64, 56, 56), (64, 64, 1, 1), (1, 1), (0, 0), (1, 1), 1), True),
    (((2, 64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1), True),
    (((2, 256, 56, 56), (512, 256, 1, 1), (2, 2), (0, 0), (1, 1), 1), True),
    (((2, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1), False),
    (((2, 64, 56, 56), (64, 64, 3, 3), (2, 2), (1, 1), (1, 1), 1), False),
    (((2, 64, 56, 56), (64, 32, 3, 3), (1, 1), (1, 1), (1, 1), 2), False),
    (((2, 64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1), (2, 2), 1), False),
    (((-1, 64, 56, 56), (64, 64, 1, 1), (1, 1), (0, 0), (1, 1), 1), False),
]


@pytest.mark.parametrize("case,admitted", GATE_CASES)
def test_gate_admits_and_declines_as_the_reference(case, admitted):
    assert jfc.supported_geometry(*case) is admitted
    assert tfc.supported_geometry(*case) is admitted
    d = tfc.gate(*case)
    assert d["admitted"] is admitted
    assert d["kernel"] == ("cuda_fused_conv" if admitted
                           else "unfused_replay")
    assert (d["reason"] is None) is admitted
    if not admitted:
        assert d["reason"].startswith("unsupported conv geometry")


def test_gate_hopper_checks():
    """Only the geometry declines: an admitted site on the CPU takes the
    plain versions whatever its layout, and one on the card launches the
    kernels, whose wrappers raise for what they cannot take. f16 raises
    in the gate (the reference's AMP is bf16 only)."""
    geo = ((2, 8, 4, 4), (8, 8, 3, 3), (1, 1), (1, 1), (1, 1), 1)
    x = torch.zeros(2, 8, 4, 4)
    for t in (x, x.transpose(2, 3), x.double(), x.to(torch.bfloat16)):
        assert tfc.gate(*geo, x=t) == {"admitted": True,
                                       "kernel": "plain_fused_conv",
                                       "reason": None}
    assert tfc.gate(*geo, x=torch.zeros(2, 8, 4, 4, device="meta"))[
        "kernel"] == "cuda_fused_conv"
    with pytest.raises(NotImplementedError, match="bf16"):
        tfc.gate(*geo, x=x.to(torch.float16))
    # a declined geometry never reaches the dtype check
    assert not tfc.gate((2, 8, 4, 4), (8, 8, 3, 3), (2, 2), (1, 1), (1, 1),
                        1, x=x.to(torch.float16))["admitted"]
    # the wrappers never run the plain versions in the kernels' place
    w = torch.zeros(8, 8, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.conv_moments(x, w, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.fused_conv_bn_act(
            x.to("meta"), w.to("meta"), *(torch.ones(8, device="meta"),) * 4,
            strides=(1, 1), paddings=(1, 1), eps=1e-5, momentum=0.9)


def test_plain_versions_compose_to_the_unfused_chain(rng):
    """conv_moments_plain + bn_apply_plain equal conv -> batch-stat BN ->
    add -> relu written out with torch ops, and conv_apply_plain the
    moving-stat form."""
    arrays, res = _mk(rng, 8, 16, 3, 1, True, 7)
    x, w, g, b, mean, var = (torch.from_numpy(a) for a in arrays)
    r = torch.from_numpy(res)
    co, s1, s2 = tfc.conv_moments_plain(x, w, 1)
    want_co = torch.nn.functional.conv2d(x, w, padding=1)
    np.testing.assert_allclose(co.numpy(), want_co.numpy(), **FWD_TOL)
    np.testing.assert_allclose(s1.numpy(), want_co.sum((0, 2, 3)).numpy(),
                               **FWD_TOL)
    n = co.shape[0] * co.shape[2] * co.shape[3]
    bm = s1 / n
    bv = s2 / n - bm * bm
    scale = g * torch.rsqrt(bv + 1e-5)
    y = tfc.bn_apply_plain(co, scale, b - bm * scale, r, True)
    want = tfc.epilogue_reference(co, g, b, r, None, None, 1e-5, True)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **FWD_TOL)
    scale = g * torch.rsqrt(var + 1e-5)
    y = tfc.conv_apply_plain(x, w, scale, b - mean * scale, r, True, 1)
    want = tfc.epilogue_reference(want_co, g, b, r, mean, var, 1e-5, True)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **FWD_TOL)


TF32_CASES = [  # (f32 value, its TF32 rounding: nearest, ties away from 0)
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # tie: away, not to even
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),  # tie below zero: away
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # just below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),     # tie from an odd ulp
    (-3.0 * 2.0 ** -30, -3.0 * 2.0 ** -30),      # already TF32
]


@pytest.mark.parametrize("value,want", TF32_CASES)
def test_tf32_round_is_nearest_ties_away(value, want):
    """``cvt.rna.tf32.f32``'s rounding, which the kernels' split uses."""
    got = tfc.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


def test_tf32_split_keeps_22_bits(rng):
    """big + small, both TF32, is the f32 value within 2^-22 of its
    magnitude: the part of a product that 3xTF32 keeps."""
    a = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.randint(-6, 7, 4096))
                         .astype("f4"))
    big = tfc.tf32_round(a)
    small = tfc.tf32_round(a - big)
    for part in (big, small):
        assert torch.equal(tfc.tf32_round(part), part)
    err = (big.double() + small.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -22 * a.double().abs()).all())


def test_3xtf32_tracks_f64_and_single_tf32_does_not(rng):
    """At K = 4608 (ResNet-50's 3x3 512 -> 512 at 7x7) the kernels' three
    TF32 products stay within f32-level error of an f64 conv (relative L2
    at most 2^-21, and at most twice the CPU's own f32 conv), while a
    single TF32 product is off by more than 2^-14: the f64 check on the
    card tells the two designs apart."""
    x = torch.from_numpy(rng.randn(1, 512, 7, 7).astype("f4"))
    w = torch.from_numpy((rng.randn(512, 512, 3, 3) * (2.0 / 4608) ** 0.5)
                         .astype("f4"))
    exact = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)

    def rel_l2(t):
        return ((t.double() - exact).norm() / exact.norm()).item()

    three = rel_l2(tfc.conv_3xtf32_emulated(x, w, 1))
    one = rel_l2(tfc.conv_3xtf32_emulated(x, w, 1, passes=1))
    f32 = rel_l2(torch.nn.functional.conv2d(x, w, padding=1))
    assert three <= 2.0 ** -21 and three <= 2 * f32, (three, f32)
    assert one >= 2.0 ** -14 and one >= 100 * three, (one, three)


# ---------------------------------------------------------------------------
# bf16 (ResNet-50 under fluid.amp): x, w and the residual in bf16, gamma,
# beta and the moving statistics f32, as the reference's AMP feeds its
# kernels (its nn_ops.py:282, :311-313). Both sides round co to bf16 once
# from an f32 accumulation, take the moments of the rounded co, and round y
# before the residual add; they sum the f32 accumulator in different
# orders, which can flip a rounding of co now and then.
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _bf16_close(got, want, name):
    """Within one bf16 ulp: 2^-7 of max(1, |want|), element-wise."""
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    lim = 2.0 ** -7 * np.maximum(1.0, np.abs(want))
    bad = np.abs(got - want) > lim
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


def _jax_bf16(arrays, res):
    import jax.numpy as jnp

    bf = jnp.bfloat16
    ja = [jnp.asarray(a).astype(bf) if i < 2 else jnp.asarray(a)
          for i, a in enumerate(arrays)]
    return ja, None if res is None else jnp.asarray(res).astype(bf)


def _port_bf16(arrays, res, grad=False):
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    ts = [(t.to(torch.bfloat16) if i < 2 else t).requires_grad_(
        grad and i < 4) for i, t in enumerate(ts)]
    r = None if res is None else torch.from_numpy(res.copy()).to(
        torch.bfloat16).requires_grad_(grad)
    return ts, r


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, "f4")


@pytest.mark.parametrize("cin,cout,k,stride,act,with_res,hw", GEOMS)
def test_bf16_forward_matches_jax(rng, cin, cout, k, stride, act, with_res,
                                  hw):
    arrays, res = _mk(rng, cin, cout, k, stride, with_res, hw)
    kw = _kw(k, stride, act)
    ja, jr = _jax_bf16(arrays, res)
    want = jfc.fused_conv_bn_act(*ja, residual=jr, **kw)
    ts, r = _port_bf16(arrays, res)
    got = tfc.fused_conv_bn_act(*ts, residual=r, **kw)
    assert got[0].dtype == torch.bfloat16 and str(want[0].dtype) == "bfloat16"
    _bf16_close(_np(got[0]), _np(want[0]), "y")
    for name, g, w in zip(OUTS[1:], got[1:], want[1:]):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("cin,cout,k,stride,act,with_res,hw", GEOMS)
def test_bf16_backward_through_fused_train_matches_jax(rng, cin, cout, k,
                                                       stride, act, with_res,
                                                       hw):
    import jax
    import jax.numpy as jnp

    arrays, res = _mk(rng, cin, cout, k, stride, with_res, hw)
    kw = _kw(k, stride, act)
    ja, jr = _jax_bf16(arrays, res)

    def loss(x, w, g, b, *r):
        y = jfc.fused_conv_bn_act(x, w, g, b, ja[4], ja[5],
                                  residual=r[0] if r else None, **kw)[0]
        y = y.astype(jnp.float32)
        return jnp.sum(y * jnp.cos(y))

    args = ja[:4] + ([jr] if with_res else [])
    want = jax.grad(loss, argnums=tuple(range(len(args))))(*args)

    ts, r = _port_bf16(arrays, res, grad=True)
    y = tfc.fused_conv_bn_act(*ts, residual=r, **kw)[0]
    assert type(y.grad_fn).__name__ == "_FusedTrainBackward"
    yf = y.float()
    wrt = ts[:4] + ([r] if with_res else [])
    got = torch.autograd.grad((yf * torch.cos(yf)).sum(), wrt)
    for name, g, w, tol in zip(("dx", "dw", "dgamma", "dbeta", "dres"), got,
                               want, (1e-2, 1e-2, 1e-3, 1e-3, 1e-2)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), name
        assert _rel_l2(_np(g), _np(w)) < tol, (name, _rel_l2(_np(g), _np(w)))


@pytest.mark.parametrize("cin,cout,k,stride,act,with_res,hw", GEOMS)
def test_bf16_inference_path_matches_jax(rng, cin, cout, k, stride, act,
                                         with_res, hw):
    arrays, res = _mk(rng, cin, cout, k, stride, with_res, hw)
    kw = _kw(k, stride, act, is_test=True)
    ja, jr = _jax_bf16(arrays, res)
    want = jfc.fused_conv_bn_act(*ja, residual=jr, **kw)
    ts, r = _port_bf16(arrays, res)
    got = tfc.fused_conv_bn_act(*ts, residual=r, **kw)
    assert got[0].dtype == torch.bfloat16
    _bf16_close(_np(got[0]), _np(want[0]), "y")
    assert got[3] is None and got[1] is ts[4]


def test_bf16_global_stats_backward_through_fused_infer_matches_jax(rng):
    import jax
    import jax.numpy as jnp

    arrays, res = _mk(rng, 8, 16, 1, 1, True, 8)
    kw = _kw(1, 1, "relu", use_global_stats=True)
    ja, jr = _jax_bf16(arrays, res)

    def loss(x, w, g, b, r):
        y = jfc.fused_conv_bn_act(x, w, g, b, ja[4], ja[5], residual=r,
                                  **kw)[0].astype(jnp.float32)
        return jnp.sum(y * jnp.cos(y))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*ja[:4], jr)
    ts, r = _port_bf16(arrays, res, grad=True)
    y = tfc.fused_conv_bn_act(*ts, residual=r, **kw)[0]
    assert type(y.grad_fn).__name__ == "_FusedInferBackward"
    yf = y.float()
    got = torch.autograd.grad((yf * torch.cos(yf)).sum(), ts[:4] + [r])
    for name, g, w, tol in zip(("dx", "dw", "dgamma", "dbeta", "dres"), got,
                               want, (1e-2, 1e-2, 1e-3, 1e-3, 1e-2)):
        assert _rel_l2(_np(g), _np(w)) < tol, (name, _rel_l2(_np(g), _np(w)))


def test_bf16_plain_versions_round_where_the_reference_rounds(rng):
    """co is the f32 conv rounded once, its moments those of the rounded
    values; bn_apply rounds the affine before the residual add; conv_apply
    rounds the conv before the affine."""
    arrays, res = _mk(rng, 8, 16, 3, 1, True, 7)
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:2])
    r = torch.from_numpy(res).to(torch.bfloat16)
    f32 = torch.nn.functional.conv2d(x.float(), w.float(), padding=1)
    co, s1, s2 = tfc.conv_moments_plain(x, w, 1)
    assert co.dtype == torch.bfloat16 and torch.equal(co, f32.bfloat16())
    assert torch.equal(s1, co.float().sum((0, 2, 3)))
    assert torch.equal(s2, (co.float() ** 2).sum((0, 2, 3)))
    scale = torch.from_numpy(arrays[2])
    shift = torch.from_numpy(arrays[3])
    c = (1, -1, 1, 1)
    want = torch.relu((co.float() * scale.reshape(c) + shift.reshape(c))
                      .bfloat16() + r)
    assert torch.equal(tfc.bn_apply_plain(co, scale, shift, r, True), want)
    assert torch.equal(tfc.conv_apply_plain(x, w, scale, shift, r, True, 1),
                       want)


# the bf16 conv_apply's form by shape: (x [N, C, H, W], O, k, stride,
# residual, dtype, aligned) -> form. Every fused site of ResNet-50 has C
# and O multiples of 64 (64-2048) and Wo <= 56.
APPLY_FORM_TABLE = [
    ((2, 64, 56, 56), 64, 3, 1, False, torch.bfloat16, True, "wgmma"),
    ((2, 64, 56, 56), 256, 1, 1, True, torch.bfloat16, True, "wgmma"),
    ((2, 256, 56, 56), 512, 1, 2, False, torch.bfloat16, True, "wgmma"),
    ((2, 512, 7, 7), 512, 3, 1, False, torch.bfloat16, True, "wgmma"),
    ((2, 1024, 14, 14), 2048, 1, 2, False, torch.bfloat16, True, "wgmma"),
    ((2, 2048, 7, 7), 512, 1, 1, True, torch.bfloat16, True, "wgmma"),
    ((1, 64, 3, 512), 64, 1, 2, False, torch.bfloat16, True, "wgmma"),
    ((1, 64, 3, 257), 64, 1, 1, False, torch.bfloat16, True, "mma_sync"),
    ((2, 32, 8, 8), 64, 3, 1, False, torch.bfloat16, True, "mma_sync"),
    ((2, 64, 8, 8), 96, 1, 1, False, torch.bfloat16, True, "mma_sync"),
    ((2, 64, 8, 8), 64, 1, 1, True, torch.bfloat16, False, "mma_sync"),
    ((2, 64, 56, 56), 64, 3, 1, False, torch.float32, True, "mma_sync"),
]


@pytest.mark.parametrize("xs,o,k,stride,with_res,dtype,aligned,form",
                         APPLY_FORM_TABLE)
def test_apply_form_routes_by_shape(xs, o, k, stride, with_res, dtype,
                                    aligned, form):
    """The bf16 conv_apply's form is decided by shape and alignment alone,
    before any launch (meta tensors, and a CPU view one element off 16
    bytes for the misaligned case): warpgroup products where C and O are
    multiples of 64, Wo is at most 256 and x, w and the residual are
    16-byte aligned; the mma.sync form for every other bf16 call (with
    the check that failed) and for f32 (its only form)."""
    n, c, h, w_ = xs
    ho, wo = (h + 2 * ((k - 1) // 2) - k) // stride + 1, \
        (w_ + 2 * ((k - 1) // 2) - k) // stride + 1
    x = torch.empty(xs, device="meta", dtype=dtype)
    w = torch.empty(o, c, k, k, device="meta", dtype=dtype)
    res = torch.empty(n, o, ho, wo, device="meta", dtype=dtype) \
        if with_res else None
    if not aligned:
        res = torch.empty(n * o * ho * wo + 1, dtype=dtype)[1:].view(
            n, o, ho, wo)
    got, why = tfc.apply_form(x, w, stride, res)
    assert got == form
    assert (why is None) == (form == "wgmma" or dtype == torch.float32)


def test_bf16_conv_apply_refuses_before_building():
    """What the bf16 conv_apply cannot take raises before any build or
    launch, whichever form the route names: a tensor off CUDA, mixed
    dtypes, a scale of the wrong length."""
    bf = torch.bfloat16
    x = torch.empty(2, 64, 8, 8, device="meta", dtype=bf)
    w = torch.empty(64, 64, 3, 3, device="meta", dtype=bf)
    s = torch.empty(64, device="meta")
    assert tfc.apply_form(x, w, 1)[0] == "wgmma"
    with pytest.raises(ValueError, match="CUDA"):
        tfc.conv_apply(x, w, s, s, None, True, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.conv_apply(torch.zeros(2, 64, 8, 8, dtype=bf),
                       torch.zeros(64, 64, 3, 3, dtype=bf), torch.ones(64),
                       torch.zeros(64), None, True, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.conv_apply(x, w.float(), s, s, None, True, 1)


def _conv_by_taps(x, w, stride):
    """The conv as the wgmma conv_apply reads it, in f32: the channels-last
    copy of x (its stride-2 view for a 1x1 stride-2 conv), each tap
    (dy, dx) a shifted window of it with zeros outside the image, times
    the tap's C columns of ``_w_taps``, summed over the taps."""
    o, c, k, _ = w.shape
    pad = (k - 1) // 2
    xl = x.contiguous(memory_format=torch.channels_last)
    nhwc = xl.permute(0, 2, 3, 1)  # the copy's memory order, as a view
    assert nhwc.is_contiguous()
    if stride == 2:
        nhwc = nhwc[:, ::2, ::2, :]
    n, h, w_, _ = nhwc.shape
    ho, wo = h + 2 * pad - k + 1, w_ + 2 * pad - k + 1
    padded = torch.nn.functional.pad(nhwc.float(), (0, 0, pad, pad, pad, pad))
    taps = tfc._w_taps(w).float()
    out = torch.zeros(n, ho, wo, o)
    for t in range(k * k):
        dy, dx = divmod(t, k)
        window = padded[:, dy:dy + ho, dx:dx + wo, :]
        out += window @ taps[:, t * c:(t + 1) * c].t()
    return out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (64, 64, 3, 1, 7), (64, 128, 1, 1, 6), (128, 64, 1, 2, 8),
    (64, 64, 3, 1, 5), (64, 128, 1, 2, 7)])
def test_channels_last_taps_give_the_nchw_conv(rng, cin, cout, k, stride,
                                               hw):
    """The channels-last copy and the tap-major weights give the plain
    version the same conv as the NCHW input: summed tap by tap from the
    copy, the f32 conv of the bf16 inputs agrees with ``conv_rounded``'s
    f32 conv to f32 rounding, and rounds to the same bf16 values but for
    ties of that rounding."""
    x = torch.from_numpy(rng.randn(2, cin, hw, hw).astype("f4")).bfloat16()
    w = torch.from_numpy((rng.randn(cout, cin, k, k) * 0.1).astype(
        "f4")).bfloat16()
    got = _conv_by_taps(x, w, stride)
    want = tfc._conv_plain(x.float(), w.float(), stride)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    flips = (got.bfloat16() != tfc.conv_rounded(x, w, stride)).float()
    assert flips.mean().item() < 1e-3
