"""Knowledge-distillation losses (the port's
``paddle_tpu/contrib/slim/distill.py``; ref ``contrib/slim/distillation/
distillation_strategy.py`` + distiller losses).

Builds on the public layers API so the losses drop into any program.
"""

from ... import layers

__all__ = ["soft_label_loss", "fsp_loss"]


def soft_label_loss(student_logits, teacher_logits, temperature=2.0):
    """KL(student || teacher) at temperature T (ref soft_label_loss)."""
    t = float(temperature)
    s = layers.log_softmax(layers.scale(student_logits, scale=1.0 / t))
    p = layers.softmax(layers.scale(teacher_logits, scale=1.0 / t))
    # KL = sum p * (log p - log s); the p*log p term is constant w.r.t.
    # the student, so the trained quantity is -sum p * log s
    per = layers.reduce_sum(
        layers.elementwise_mul(p, layers.scale(s, scale=-1.0)), dim=-1)
    return layers.scale(layers.mean(per), scale=t * t)


def fsp_loss(a_first, a_second, b_first, b_second):
    """FSP-matrix distillation (flow between layers): mean squared error
    between student and teacher gram matrices (ref fsp_loss)."""
    def fsp(x, y):
        # [B, C1, H, W], [B, C2, H, W] -> [B, C1, C2]
        b, c1 = x.shape[0], x.shape[1]
        c2 = y.shape[1]
        hw = int(x.shape[2]) * int(x.shape[3])
        xf = layers.reshape(x, [b if b > 0 else -1, c1, -1])
        yf = layers.reshape(y, [b if b > 0 else -1, c2, -1])
        g = layers.matmul(xf, layers.transpose(yf, perm=[0, 2, 1]))
        return layers.scale(g, scale=1.0 / float(hw))

    diff = layers.elementwise_sub(fsp(a_first, a_second),
                                  fsp(b_first, b_second))
    return layers.mean(layers.elementwise_mul(diff, diff))
