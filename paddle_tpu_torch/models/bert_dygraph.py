"""BERT-base pretraining built from DYGRAPH modules
(``paddle_tpu/models/bert_dygraph.py``; BASELINE config 4, "fluid dygraph
-> XLA").

The imperative model composes ``dygraph.nn`` modules (Embedding, FC,
LayerNorm, Dropout) with the port's flash-attention and fused-CE kernels
(``ops/flash_attention.py``, ``ops/fused_ce.py``), called directly as the
reference calls its Pallas ones: 12 flash forwards and backwards and one
fused CE forward a step at BERT-base. ``make_train_step`` is the
reference's step over ``Layer.functional(rng=True)``: the gradient by
``torch.autograd.grad`` and Adam or Lamb written into the parameter and
moment tensors in place, so ``dygraph.CapturedTrainStep`` captures it as
one CUDA graph. Under ``amp`` the bf16 products round once, as the
reference's f32-accumulated dots do (``op_registry.single_rounding``).
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..core.op_registry import single_rounding
from ..dygraph import nn as dnn
from ..dygraph.base import VarBase, draw_generator, record, to_variable
from ..dygraph.layers import Layer
from ..dygraph.nn import _gelu_tanh_parts, gelu_tanh_bf16_vjp

__all__ = ["BertPretrain", "bert_base_dygraph", "make_train_step",
           "sample_batch"]


def _cast(amp, *xs):
    if not amp:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(x.to(torch.bfloat16)
                if isinstance(x, torch.Tensor) and x.dtype == torch.float32
                else x for x in xs)
    return out if len(out) > 1 else out[0]


class _OneGradient(torch.autograd.Function):
    """Identity whose backward hands on the sum of its output's gradients
    as one: the three projections' input gradients sum among themselves
    (v's, k's, then q's, as the reference's VJP of the attention node
    adds them) before the residual's joins, so in bf16 the sums round as
    the reference's tape rounds them."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _MultiHeadAttention(Layer):
    """Bias-free QKV/out projections + the flash-attention kernels — the
    dygraph twin of ``layers.multi_head_attention``."""

    _SEED = 1234

    def __init__(self, d_model, n_head, dropout_rate, amp=False):
        super().__init__("mha")
        self._n_head = n_head
        self._rate = dropout_rate
        self._amp = amp
        self._wq = self.create_parameter([d_model, d_model])
        self._wk = self.create_parameter([d_model, d_model])
        self._wv = self.create_parameter([d_model, d_model])
        self._wo = self.create_parameter([d_model, d_model])

    def forward(self, x, key_bias):
        from ..ops.flash_attention import draw_seed, flash_attention

        n_head, amp = self._n_head, self._amp
        rate = self._rate if self.training else 0.0
        x = to_variable(x)
        seed = None
        if rate:
            dev = x.value().device
            seed = draw_seed(draw_generator(_MultiHeadAttention, dev,
                                            _MultiHeadAttention._SEED), dev)

        def fn(xv, bias, wq, wk, wv, wo):
            xv, wq, wk, wv, wo = _cast(amp, xv, wq, wk, wv, wo)
            if xv.requires_grad:
                xv = _OneGradient.apply(xv)
            q, k, v = xv @ wq, xv @ wk, xv @ wv
            ctx = flash_attention(q, k, v, n_head, bias=bias,
                                  dropout_rate=rate, seed=seed)
            return ctx @ wo

        return record(fn, x, to_variable(key_bias),
                      self._wq, self._wk, self._wv, self._wo)


class _Sublayer(Layer):
    """Post-norm residual wrapper: LN(x + dropout(f(x)))."""

    def __init__(self, inner, dropout_rate, d_model):
        super().__init__("sub")
        self.inner = inner
        self.drop = dnn.Dropout(p=dropout_rate)
        self.norm = dnn.LayerNorm(normalized_shape=d_model)

    def forward(self, x, *args):
        y = self.drop(self.inner(x, *args) if args else self.inner(x))
        return self.norm(record(lambda a, b: a + b, to_variable(x), y))


class _FFNBf16(torch.autograd.Function):
    """The reference's explicit bf16 FFN (``_ffn_bf16``, a custom_vjp):
    bf16 products, z saved, the tanh gelu and its gradient at the
    reference's rounding points (``dygraph/nn.py``); dW
    summed in f32 and kept f32 (``preferred_element_type=f32``), db summed
    in f32, dx rounded to bf16 and returned in x's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        xb = x.to(torch.bfloat16)
        w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
        z = xb @ w1b + b1.to(torch.bfloat16)
        o = _gelu_tanh_parts(z)[0] @ w2b + b2.to(torch.bfloat16)
        ctx.save_for_backward(xb, w1b, w2b, z)
        ctx.x_dtype = x.dtype
        return o

    @staticmethod
    def backward(ctx, do):
        from ..ops.fused_ce import _mm_f32

        xb, w1b, w2b, z = ctx.saved_tensors
        do = do.to(torch.bfloat16)
        lead = tuple(do.shape[:-1])
        do2 = do.reshape(-1, do.shape[-1])
        z2 = z.reshape(-1, z.shape[-1])
        x2 = xb.reshape(-1, xb.shape[-1])
        with single_rounding():
            h2 = _gelu_tanh_parts(z2)[0]
            dh = do2 @ w2b.t()                                # bf16
            dz = gelu_tanh_bf16_vjp(z2, dh)
            dw2 = _mm_f32(h2.t(), do2)
            db2 = do2.float().sum(dim=0)
            dw1 = _mm_f32(x2.t(), dz)
            db1 = dz.float().sum(dim=0)
            dx = (dz @ w1b.t()).reshape(lead + (xb.shape[-1],))
        return dx.to(ctx.x_dtype), dw1, db1, dw2, db2


class _FFN(Layer):
    def __init__(self, d_model, d_ff, amp=False):
        super().__init__("ffn")
        self._amp = amp
        self._w1 = self.create_parameter([d_model, d_ff])
        self._b1 = self.create_parameter([d_ff], is_bias=True)
        self._w2 = self.create_parameter([d_ff, d_model])
        self._b2 = self.create_parameter([d_model], is_bias=True)

    def forward(self, x):
        amp = self._amp

        def fn(xv, w1, b1, w2, b2):
            if amp:
                return _FFNBf16.apply(xv, w1, b1, w2, b2)
            h = F.gelu(xv @ w1 + b1, approximate="none")
            return h @ w2 + b2

        return record(fn, to_variable(x), self._w1, self._b1, self._w2,
                      self._b2)


class BertPretrain(Layer):
    def __init__(self, vocab_size=30522, seq_len=128, d_model=768,
                 d_ff=3072, n_head=12, n_layer=12, dropout_rate=0.1,
                 max_position=512, type_vocab=2, amp=False):
        super().__init__("bert_dy")
        self._seq_len = seq_len
        self._vocab = vocab_size
        self._amp = amp
        self.word_emb = dnn.Embedding(size=[vocab_size, d_model])
        self.pos_emb = dnn.Embedding(
            size=[max(max_position, seq_len), d_model])
        self.seg_emb = dnn.Embedding(size=[type_vocab, d_model])
        self.emb_norm = dnn.LayerNorm(normalized_shape=d_model)
        self.emb_drop = dnn.Dropout(p=dropout_rate)
        self.attn = []
        self.ffn = []
        for i in range(n_layer):
            attn = _Sublayer(
                _MultiHeadAttention(d_model, n_head, dropout_rate, amp),
                dropout_rate, d_model)
            ffn = _Sublayer(_FFN(d_model, d_ff, amp), dropout_rate, d_model)
            self.add_sublayer("attn%d" % i, attn)
            self.add_sublayer("ffn%d" % i, ffn)
            self.attn.append(attn)
            self.ffn.append(ffn)
        self.mlm_transform = dnn.FC(size=d_model, num_flatten_dims=2,
                                    act="gelu")
        self.mlm_norm = dnn.LayerNorm(normalized_shape=d_model)
        self._mlm_w = self.create_parameter([d_model, vocab_size],
                                            name="mlm_out.w_dy")
        self._mlm_b = self.create_parameter([vocab_size], is_bias=True,
                                            name="mlm_out.b_dy")
        self.pooler = dnn.FC(size=d_model, act="tanh")
        self.nsp_out = dnn.FC(size=2)

    def encode(self, input_ids, segment_ids, input_len):
        seq_len, amp = self._seq_len, self._amp
        input_ids = to_variable(input_ids)
        dev = input_ids.value().device
        pos = torch.arange(seq_len, dtype=torch.int32, device=dev)
        x = record(lambda a, b, c: a + b + c,
                   self.word_emb(input_ids), self.seg_emb(segment_ids),
                   self.pos_emb(VarBase(pos, stop_gradient=True)))
        x = self.emb_drop(self.emb_norm(x))
        if amp:  # bf16-resident stream from the embeddings on
            x = record(lambda v: _cast(True, v), x)

        lens = to_variable(input_len)
        key_bias = record(
            lambda lv: torch.where(
                torch.arange(seq_len, device=lv.device)[None, :]
                < lv.reshape(-1, 1), 0.0, -1e9).to(torch.float32),
            VarBase(lens.value(), stop_gradient=True))
        for attn, ffn in zip(self.attn, self.ffn):
            x = attn(x, key_bias)
            x = ffn(x)
        return x

    def forward(self, input_ids, segment_ids, input_len, mlm_labels,
                mlm_weights, nsp_label):
        with single_rounding() if self._amp else contextlib.nullcontext():
            return self._forward(input_ids, segment_ids, input_len,
                                 mlm_labels, mlm_weights, nsp_label)

    def _forward(self, input_ids, segment_ids, input_len, mlm_labels,
                 mlm_weights, nsp_label):
        from ..ops.fused_ce import linear_smooth_ce

        amp = self._amp
        x = self.encode(input_ids, segment_ids, input_len)

        h = self.mlm_norm(self.mlm_transform(x))
        mlm_labels = VarBase(to_variable(mlm_labels).value(),
                             stop_gradient=True)
        nsp_label = VarBase(to_variable(nsp_label).value(),
                            stop_gradient=True)

        def mlm_fn(hv, w, b, lbl, wts):
            hv, w = _cast(amp, hv, w)
            ce = linear_smooth_ce(hv, w, b, lbl, 0.0)
            wts = wts.reshape(ce.shape)
            return (ce * wts).sum() / (wts.sum() + 1e-6)

        mlm_loss = record(mlm_fn, h, self._mlm_w, self._mlm_b,
                          mlm_labels, to_variable(mlm_weights))

        cls = record(lambda xv: xv[:, 0, :], x)
        nsp_logits = self.nsp_out(self.pooler(cls))

        def nsp_fn(lg, lbl):
            lp = torch.log_softmax(lg.float(), dim=-1)
            ids = lbl.reshape(-1).to(torch.int64)
            return -lp.gather(-1, ids[:, None]).mean()

        nsp_loss = record(nsp_fn, nsp_logits, nsp_label)
        return record(lambda a, b: a + b, mlm_loss, nsp_loss)


def bert_base_dygraph(vocab_size=30522, seq_len=128, d_model=768,
                      d_ff=3072, n_head=12, n_layer=12, dropout_rate=0.1,
                      amp=False):
    """Build the imperative BERT (its parameters on the dygraph guard's
    device) and return (layer, feed_order, flops_per_example,
    tokens_per_example)."""
    model = BertPretrain(vocab_size, seq_len, d_model, d_ff, n_head,
                         n_layer, dropout_rate, amp=amp)
    per_layer_mac = (4 * d_model * d_model + 2 * d_model * d_ff
                     + 2 * seq_len * d_model)
    total_mac = n_layer * per_layer_mac + d_model * vocab_size
    feeds = ("input_ids", "segment_ids", "input_len", "mlm_labels",
             "mlm_weights", "nsp_label")
    return model, feeds, 2 * 3 * total_mac * seq_len, seq_len


def make_train_step(model, learning_rate=1e-4, b1=0.9, b2=0.999, eps=1e-8,
                    optimizer="adam", weight_decay=0.01):
    """The train step over the functional export:
    ``step(params, opt_state, generator, *feeds) -> (loss, params,
    opt_state)``, the parameters and the state updated in place (the
    reference's donated state), so ``dygraph.CapturedTrainStep`` captures
    it.
    ``optimizer``: "adam" or "lamb" (the BERT-pretraining recipe, the
    static ``lamb`` kernel's rule). Returns (step, params0, opt0): the
    model's own parameter tensors, and zero moments and step count on
    their device."""
    if optimizer not in ("adam", "lamb"):
        raise ValueError("unknown optimizer %r (adam|lamb)" % optimizer)
    apply_fn, params0 = model.functional(rng=True)
    names = list(params0)
    dev = params0[names[0]].device
    opt0 = {"m": {n: torch.zeros_like(p) for n, p in params0.items()},
            "v": {n: torch.zeros_like(p) for n, p in params0.items()},
            "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(params, opt_state, generator, *feeds):
        ps = [params[n] for n in names]
        leaves = {n: p.detach().requires_grad_() for n, p in zip(names, ps)}
        with torch.enable_grad(), single_rounding():
            loss = apply_fn(leaves, generator, *feeds)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        with torch.no_grad():
            ms = [opt_state["m"][n] for n in names]
            vs = [opt_state["v"][n] for n in names]
            t = opt_state["t"]
            t.add_(1)
            tf = t.to(torch.float32)
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
            if optimizer == "lamb":
                m_hat = torch._foreach_mul(ms, 1 / (1 - b1 ** tf))
                v_hat = torch._foreach_mul(vs, 1 / (1 - b2 ** tf))
                torch._foreach_sqrt_(v_hat)
                torch._foreach_add_(v_hat, eps)
                r = torch._foreach_div(m_hat, v_hat)
                torch._foreach_add_(r, torch._foreach_mul(ps, weight_decay))
                p_norm = torch._foreach_norm(ps)
                r_norm = torch._foreach_norm(r)
                for p, r_i, pn, rn in zip(ps, r, p_norm, r_norm):
                    trust = torch.where((pn > 0) & (rn > 0), pn / rn,
                                        torch.ones_like(pn))
                    p.sub_(learning_rate * trust * r_i)
            else:
                lr_t = learning_rate * torch.sqrt(1 - b2 ** tf) \
                    / (1 - b1 ** tf)
                denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(ms, denom)
                torch._foreach_mul_(upd, lr_t)
                torch._foreach_sub_(ps, upd)
        return loss.detach(), params, opt_state

    return step, params0, opt0


def sample_batch(batch, seq_len, vocab_size, rng):
    """Synthetic batch matching ``models/bert.py`` feed schema/order."""
    return (
        rng.randint(0, vocab_size, (batch, seq_len)).astype(np.int32),
        rng.randint(0, 2, (batch, seq_len)).astype(np.int32),
        np.full((batch,), seq_len, np.int32),
        rng.randint(0, vocab_size, (batch, seq_len)).astype(np.int32),
        (rng.rand(batch, seq_len) < 0.15).astype(np.float32),
        rng.randint(0, 2, (batch, 1)).astype(np.int32),
    )
