"""Quantization-aware training transpiler (the port's
``paddle_tpu/contrib/quantize/quantize_transpiler.py``; ref
``python/paddle/fluid/contrib/quantize/quantize_transpiler.py``:
``QuantizeTranspiler.training_transpile:145``, ``freeze_program:255``,
``convert_to_int8:371``).

The same program rewrite: fake-quant ops (``core/opimpl/quant_ops.py``)
on the activation and weight inputs of every ``mul``, ``conv2d`` and
``depthwise_conv2d``, each with a straight-through gradient, so the QAT
backward needs no grad-op surgery. A conv2d keeps its chain to its
batch_norm, so the Executor's epilogue fusion still turns conv -> BN (+
add)(+ relu) into ``fused_conv2d``, its Filter now the weight's
fake-quant output.

Contract: call ``training_transpile`` BEFORE ``minimize`` — the
autodiff op records the forward op list at minimize time, so fake-quant
ops inserted afterwards would be invisible to the backward.
"""

import json
import os

import numpy as np

from ...checkpoint import apply_updates
from ...core import framework
from ...core.executor import resolve_device, to_numpy
from ...core.framework import Operator

__all__ = ["QuantizeTranspiler", "export_int8_params", "load_int8_params",
           "INT8_PARAMS_FILE", "INT8_MANIFEST_FILE"]

INT8_PARAMS_FILE = "params.int8.npz"
INT8_MANIFEST_FILE = "int8_manifest.json"

_QUANTIZABLE = {
    "mul": ("X", "Y"),
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
}


class QuantizeTranspiler:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="channel_wise_abs_max",
                 moving_rate=0.9):
        if activation_quantize_type not in ("abs_max",
                                            "moving_average_abs_max"):
            raise ValueError("unknown activation_quantize_type %r"
                             % activation_quantize_type)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.moving_rate = moving_rate
        self._weight_quants = {}  # weight var name -> quant axis

    # -- QAT ----------------------------------------------------------------
    def training_transpile(self, program=None, startup_program=None):
        """Insert fake-quant ops on the inputs + weights of every
        quantizable op, in place."""
        program = program or framework.default_main_program()
        startup = startup_program or framework.default_startup_program()
        block = program.global_block()
        if any(op.type == "autodiff" for op in block.ops):
            raise RuntimeError("training_transpile must run BEFORE "
                               "minimize()/append_backward")
        new_ops = []
        quanted = {}  # var name -> already-quantized replacement Variable
        for op in block.ops:
            if op.type in _QUANTIZABLE:
                act_slot, w_slot = _QUANTIZABLE[op.type]
                for slot in (act_slot, w_slot):
                    src = op.input(slot)
                    if src is None:
                        continue
                    if src.name in quanted:
                        op.inputs[slot] = [quanted[src.name]]
                        continue
                    is_weight = (slot == w_slot) and src.persistable
                    qv = self._insert_quant(block, startup, new_ops, src,
                                            is_weight, op)
                    quanted[src.name] = qv
                    op.inputs[slot] = [qv]
            new_ops.append(op)
        block.ops = new_ops
        program._version += 1
        return program

    def _insert_quant(self, block, startup, new_ops, src, is_weight, op):
        qv = block.create_var(
            name=src.name + ".quantized", shape=src.shape, dtype="float32")
        sv = block.create_var(
            name=src.name + ".quant_scale", shape=(), dtype="float32")
        if is_weight:
            # conv weights OIHW -> channel axis 0; mul weights [in, out]
            # -> output-channel axis 1
            axis = 0 if op.type != "mul" else 1
            self._weight_quants[src.name] = axis
            new_ops.append(Operator(
                block, "fake_channel_wise_quantize_abs_max",
                {"X": src}, {"Out": qv, "OutScale": sv},
                {"bit_length": self.weight_bits, "quant_axis": axis}))
        elif self.act_type == "abs_max":
            new_ops.append(Operator(
                block, "fake_quantize_abs_max", {"X": src},
                {"Out": qv, "OutScale": sv},
                {"bit_length": self.activation_bits}))
        else:
            state = block.create_var(name=src.name + ".quant_state",
                                     shape=(), dtype="float32",
                                     persistable=True)
            sb = startup.global_block()
            ssv = sb.create_var(name=state.name, shape=(),
                                dtype="float32", persistable=True)
            sb.append_op("fill_constant", outputs={"Out": ssv},
                         attrs={"shape": (), "dtype": "float32",
                                "value": 0.0})
            new_ops.append(Operator(
                block, "fake_quantize_moving_average_abs_max",
                {"X": src, "InScale": state},
                {"Out": qv, "OutScale": state},
                {"bit_length": self.activation_bits,
                 "moving_rate": self.moving_rate}))
        return qv

    # -- deployment ---------------------------------------------------------
    def freeze_program(self, program, place=None, scope=None):
        """Bake trained weights onto the quantization grid (in the scope)
        and drop the weight fake-quant ops; activation quant ops switch to
        their frozen (is_test) scales. Ref ``freeze_program:255``."""
        from ...core.executor import global_scope

        scope = scope or global_scope()
        block = program.global_block()
        kept = []
        for op in block.ops:
            if (op.type == "fake_channel_wise_quantize_abs_max"
                    and op.input("X").name in self._weight_quants):
                wname = op.input("X").name
                w = to_numpy(scope.get(wname))
                axis = self._weight_quants[wname]
                qw, _ = self._quant_np(w, axis)
                # the weight now ON the int grid, on its device
                apply_updates(scope, [(wname, qw)])
                # rewire consumers of the quantized var back to the
                # (now pre-quantized) weight
                qname = op.output("Out").name
                for other in block.ops:
                    for slot, vs in other.inputs.items():
                        other.inputs[slot] = [
                            op.input("X") if v.name == qname else v
                            for v in vs]
                continue
            if op.type in ("fake_quantize_abs_max",
                           "fake_quantize_moving_average_abs_max"):
                op.attrs["is_test"] = True
            kept.append(op)
        block.ops = kept
        program._version += 1
        return program

    def convert_to_int8(self, program, scope=None):
        """Return {weight name: (int8 array, per-channel float scales)} for
        deployment storage (ref ``convert_to_int8:371`` rewrites vars to
        INT8 tensors; serialization-ready dict here)."""
        from ...core.executor import global_scope

        scope = scope or global_scope()
        out = {}
        for wname, axis in self._weight_quants.items():
            w = to_numpy(scope.get(wname))
            _, scale = self._quant_np(w, axis)
            qmax = float(2 ** (self.weight_bits - 1) - 1)
            i8 = np.round(
                np.clip(w / np.maximum(scale, 1e-8), -1, 1) * qmax
            ).astype(np.int8)
            out[wname] = (i8, scale.reshape(-1))
        return out

    def _quant_np(self, w, axis):
        red = tuple(i for i in range(w.ndim) if i != axis)
        scale = np.max(np.abs(w), axis=red, keepdims=True)
        qmax = float(2 ** (self.weight_bits - 1) - 1)
        s = np.maximum(scale, 1e-8)
        qw = np.round(np.clip(w / s, -1, 1) * qmax) / qmax * s
        return qw.astype(w.dtype), scale

    def export_int8(self, dirname, scope=None):
        """Write the deployable int8 export next to a
        ``save_inference_model`` directory: ``params.int8.npz`` holding
        each quantized weight as int8 + its per-channel scales, and an
        ``int8_manifest.json`` with the quant axes/bits. Call AFTER
        ``freeze_program`` so the export round-trips losslessly onto the
        frozen quantization grid."""
        weights = self.convert_to_int8(None, scope=scope)
        return export_int8_params(
            dirname, weights,
            axes={n: a for n, a in self._weight_quants.items()},
            weight_bits=self.weight_bits)


def export_int8_params(dirname, weights, axes, weight_bits=8):
    """Serialize ``convert_to_int8``'s ``{name: (int8, scales)}`` dict.
    4x smaller on disk than the fp32 params; :func:`load_int8_params`
    dequantizes back onto the exact quantization grid the frozen program
    computed with."""
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for name, (i8, scale) in weights.items():
        arrays[name] = np.asarray(i8, dtype=np.int8)
        arrays[name + "@scale"] = np.asarray(scale,
                                             dtype=np.float32).reshape(-1)
    path = os.path.join(dirname, INT8_PARAMS_FILE)
    np.savez(path, **arrays)
    with open(os.path.join(dirname, INT8_MANIFEST_FILE), "w") as f:
        json.dump({"weight_bits": int(weight_bits),
                   "weights": {n: int(a) for n, a in axes.items()}},
                  f, indent=1)
    return path


def load_int8_params(dirname, scope, require=False, device=None):
    """Load the int8 export into ``scope``, dequantizing each weight as
    ``(int8 / qmax) * scale`` — the expression ``freeze_program`` baked, so
    the outputs match the frozen fp32 model up to float rounding. A weight
    the scope already holds keeps its device; a new one goes to
    ``device`` (None = ``CUDAPlace(0)``). Returns the weight names loaded
    ([] when the directory carries no export; raises when ``require``)."""
    path = os.path.join(dirname, INT8_PARAMS_FILE)
    man_path = os.path.join(dirname, INT8_MANIFEST_FILE)
    if not (os.path.exists(path) and os.path.exists(man_path)):
        if require:
            raise ValueError(
                "int8 serving requested but %r has no %s/%s export "
                "(QuantizeTranspiler.export_int8 writes it)"
                % (dirname, INT8_PARAMS_FILE, INT8_MANIFEST_FILE))
        return []
    with open(man_path) as f:
        man = json.load(f)
    qmax = float(2 ** (int(man.get("weight_bits", 8)) - 1) - 1)
    updates = []
    with np.load(path, allow_pickle=False) as data:
        for name, axis in man["weights"].items():
            i8 = data[name]
            scale = data[name + "@scale"]
            shape = [1] * i8.ndim
            shape[int(axis)] = -1
            updates.append(
                (name, (i8.astype(np.float32) / qmax) * scale.reshape(shape)))
    new = any(name not in scope for name, _ in updates)
    apply_updates(scope, updates,
                  device=resolve_device(device) if new else None)
    return [name for name, _ in updates]
