"""The port's conv -> BN (+ add)(+ relu) epilogue fusion against
``paddle_tpu``'s: the same program built in both packages and rewritten by
both ``fuse_ops`` gives the same sites (kinds, absorbed vars, ``orig_ops``,
the fused op's slots and attrs), the same refusals, and the same rewritten
``autodiff`` op. Programs: the bottleneck model of
``tests/test_fused_conv.py:208-228`` and ResNet-50 at 32x32. Also: the
executor keeps the rewritten op list per (program, version, fetch set)."""

import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu.core import epilogue_fusion as jef
from paddle_tpu_torch.core import epilogue_fusion as tef
from paddle_tpu_torch.core import executor as t_executor
from paddle_tpu_torch.core import unique_name as t_unique_name


@pytest.fixture(autouse=True)
def fresh_port_names():
    old_gen = t_unique_name.switch()
    yield
    t_unique_name.switch(old_gen)


def _bottleneck(pkg, fetch_mid=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", shape=[8, 8, 8], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int32")
        xx = pkg.layers.conv2d(img, 16, 1, bias_attr=False)
        xx = pkg.layers.batch_norm(xx, act="relu")
        short = xx
        y_conv = pkg.layers.conv2d(xx, 16, 3, padding=1, bias_attr=False)
        y = pkg.layers.batch_norm(y_conv)
        out = pkg.layers.elementwise_add(short, y, act="relu")
        out = pkg.layers.pool2d(out, pool_type="avg", global_pooling=True)
        logits = pkg.layers.fc(out, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, [loss.name] + ([y_conv.name] if fetch_mid else [])


def _resnet(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        models = jmodels if pkg is fluid else tfluid.models
        spec = models.resnet.resnet_imagenet(
            depth=50, class_num=10, image_shape=(3, 32, 32))
        pkg.optimizer.Adam(learning_rate=1e-4).minimize(spec.loss)
    return main, [spec.loss.name, spec.fetches["acc"].name]


def _names(slots):
    return sorted((s, tuple(v.name for v in vs)) for s, vs in slots.items())


def _sig(op):
    return op.type, _names(op.inputs), _names(op.outputs)


def _deep_sig(op):
    sig = _sig(op)
    if op.type == "fused_conv2d":
        attrs = {k: v for k, v in op.attrs.items() if k != "orig_ops"}
        return sig + (sorted(attrs.items()),
                      [_sig(o) for o in op.attr("orig_ops")])
    if op.type == "autodiff":
        return sig + ([_sig(o) for o in op.attr("fwd_ops")],
                      list(op.attr("wrt_names")))
    return sig


def _fuse_both(build, **kw):
    fluid.unique_name.switch()
    jmain, jfetch = build(fluid, **kw)
    t_unique_name.switch()
    tmain, tfetch = build(tfluid, **kw)
    assert tfetch == jfetch
    assert [_sig(o) for o in tmain.global_block().ops] == \
        [_sig(o) for o in jmain.global_block().ops]
    jops, jrep = jef.fuse_ops(jmain.global_block().ops, set(jfetch))
    tops, trep = tef.fuse_ops(tmain.global_block().ops, set(tfetch))
    return (jops, jrep), (tops, trep), tmain, tfetch


def _assert_same_rewrite(j, t):
    (jops, jrep), (tops, trep) = j, t
    assert [_deep_sig(o) for o in tops] == [_deep_sig(o) for o in jops]
    assert [(s.kinds, s.dropped_vars, [o.output_arg_names for o in s.ops])
            for s in trep.fused] == \
        [(s.kinds, s.dropped_vars, [o.output_arg_names for o in s.ops])
         for s in jrep.fused]
    assert [(r.op.type, r.var_name, r.reason) for r in trep.refused] == \
        [(r.op.type, r.var_name, r.reason) for r in jrep.refused]


def test_bottleneck_rewrite_matches_jax():
    j, t, _, _ = _fuse_both(_bottleneck)
    _assert_same_rewrite(j, t)
    kinds = [s.kinds for s in t[1].fused]
    assert kinds == [("conv2d", "batch_norm", "relu"),
                     ("conv2d", "batch_norm", "elementwise_add", "relu")]


def test_fetched_intermediate_refusal_matches_jax():
    """Fetching the second conv's output protects it: that chain is
    refused, with the same reason in both packages, and the first still
    fuses."""
    j, t, _, _ = _fuse_both(_bottleneck, fetch_mid=True)
    _assert_same_rewrite(j, t)
    assert [s.kinds for s in t[1].fused] == [("conv2d", "batch_norm",
                                              "relu")]
    assert len(t[1].refused) == 1
    assert "fetched/protected" in t[1].refused[0].reason


def test_resnet50_rewrite_matches_jax():
    j, t, _, _ = _fuse_both(_resnet)
    _assert_same_rewrite(j, t)
    rep = t[1]
    assert len(rep.fused) == 53 and not rep.refused  # 16 x 3 + 4 + stem
    kinds = [s.kinds for s in rep.fused]
    # the 16 bottleneck tails take the residual add; the 4 shortcut chains
    # fall back to conv -> bn alone (their residual is produced later)
    assert kinds.count(("conv2d", "batch_norm", "elementwise_add",
                        "relu")) == 16
    assert kinds.count(("conv2d", "batch_norm")) == 4
    assert kinds.count(("conv2d", "batch_norm", "relu")) == 33


def test_executor_keeps_the_rewrite_per_version_and_fetch_set():
    _, (_, _), tmain, fetch = _fuse_both(_bottleneck)
    ops, rep = t_executor.fused_ops(tmain, fetch)
    assert t_executor.fused_ops(tmain, fetch)[0] is ops  # cached
    assert len(rep.fused) == 2
    other, _ = t_executor.fused_ops(tmain, fetch[:1] + ["img"])
    assert other is not ops
    # alternating fetch sets of one version rebuild nothing
    assert t_executor.fused_ops(tmain, fetch)[0] is ops
    assert t_executor.fused_ops(tmain, fetch[:1] + ["img"])[0] is other
    tmain._version += 1  # a mutated program is rewritten again
    assert t_executor.fused_ops(tmain, fetch)[0] is not ops
    assert list(tmain._fusion_cache) == [(tmain._version, frozenset(fetch))]


def test_fuse_program_drops_absorbed_vars():
    fluid.unique_name.switch()
    t_unique_name.switch()
    tmain, fetch = _bottleneck(tfluid)
    fused, rep = tef.fuse_program(tmain, fetch)
    gb = fused.global_block()
    assert [o.type for o in gb.ops].count("fused_conv2d") == 2
    for site in rep.fused:
        for name in site.dropped_vars:
            assert name not in gb.vars
    assert fused._version == tmain._version + 1
