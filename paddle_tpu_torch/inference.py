"""Inference predictor stack (the one-device subset of
``paddle_tpu/inference.py``).

Reference: ``paddle/fluid/inference/api/analysis_predictor.cc:183``
(``AnalysisPredictor::Init``) + ``:734`` (``Run``) + ``Clone``, configured
by ``AnalysisConfig``. Here a predictor is a loaded program, an isolated
``Scope`` holding its weights on one device, and an ``Executor`` that
runs the program there (captured as one CUDA graph per input signature
on the card, see ``core/executor.py``). ``clone()`` shares the program and
the weights (ref ``AnalysisPredictor::Clone``) and keeps its own
``Executor``, so each serving thread owns its graphs and feed buffers.

Device: ``AnalysisConfig`` selects ``CUDAPlace(0)`` by default, as
``enable_use_gpu`` does in the reference; ``disable_gpu()`` selects the
CPU (another card goes through ``ServingEngine(device=...)``). Without a CUDA device, a predictor that was not asked for the CPU
raises. ``clone(device=...)`` pins a replica to one device: its scope is
a copy of the weights on that ``torch.device`` (the
``ServingEngine(placement="per_device")`` building block,
``paddle_tpu/inference.py:127-134``). ``enable_int8`` serves from the
``contrib.quantize`` int8 export beside the model, dequantized onto the
quantization grid at load (auto-detected unless set). ``shard`` (A7) and
the StableHLO predictor (A5b) are not ported.
"""

import os

import torch

from . import io as io_mod
from .core.executor import (CPUPlace, CUDAPlace, Executor, Scope, place_for,
                            scope_guard)

__all__ = ["AnalysisConfig", "Predictor", "ProgramPredictor",
           "create_paddle_predictor"]


class AnalysisConfig:
    """Model directory (or the combined-file form: ``prog_file`` and
    ``params_file`` paths inside one directory, ref
    ``SetModel(prog_file, params_file)``) plus the device to serve on."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.place = CUDAPlace(0)
        self._int8 = None  # None = auto-detect params.int8.npz in the dir

    def set_model(self, model_dir):
        self.model_dir = model_dir

    def disable_gpu(self):
        self.place = CPUPlace()

    def enable_int8(self, x=True):
        """Serve from the ``contrib.quantize`` int8 export
        (``params.int8.npz`` beside the model). ``True`` requires the
        export, ``False`` forces fp32, the default ``None`` auto-detects."""
        self._int8 = bool(x)


class ProgramPredictor:
    """Predictor over an already-built (program, scope) pair; ``Predictor``
    subclasses it with the model-directory front end."""

    def __init__(self, program, feed_names, fetch_vars, scope=None,
                 place=None):
        self.config = None
        self._scope = scope if scope is not None else Scope()
        self._exe = Executor(place)
        self._program = program
        self.feed_names = list(feed_names)
        self._fetch_vars = list(fetch_vars)
        self.fetch_names = [v.name if hasattr(v, "name") else str(v)
                            for v in fetch_vars]

    @property
    def device(self):
        """The ``torch.device`` the weights and the outputs live on."""
        return self._exe.device

    # the executor writes the caches the decode batcher lends in place
    # (``Executor.run``'s ``_lend``)
    _lends_feeds = True

    def run(self, inputs, return_numpy=True, _lend=()):
        """``inputs``: dict name->array, or a list/tuple in feed order.
        Returns outputs in fetch order. ``_lend`` (the decode batcher's):
        feeds whose tensors the caller lends (``Executor.run``)."""
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != len(self.feed_names):
                raise ValueError("expected %d inputs (%s), got %d"
                                 % (len(self.feed_names), self.feed_names,
                                    len(inputs)))
            feed = dict(zip(self.feed_names, inputs))
        else:
            feed = dict(inputs)
            missing = set(self.feed_names) - set(feed)
            if missing:
                raise ValueError("missing feeds: %s" % sorted(missing))
        # the scope is passed explicitly: clones serving from other
        # threads must not race on the process-global scope stack; no
        # donation (``paddle_tpu/inference.py:113-123``): a program that
        # writes the shared weights is never captured
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope,
                             return_numpy=return_numpy, donate_state=False,
                             _lend=_lend)

    def step_report(self):
        """The executor's capture report of this predictor's program
        (:meth:`Executor.step_report`), or None before its first run."""
        try:
            return self._exe.step_report(self._program)
        except KeyError:
            return None

    def close(self):
        """Release this predictor's cached steps and their CUDA graphs
        (:meth:`Executor.close`); it still runs afterwards."""
        self._exe.close()

    def clone(self, device=None):
        """A predictor sharing this one's program and weights (ref
        ``AnalysisPredictor::Clone``), with its own executor.

        ``device`` (a device string, ``torch.device`` or place): pin the
        clone to that device — its scope becomes a copy of every weight
        there (no longer shared with the parent) and its executor runs
        there. The ``placement="per_device"`` replica constructor."""
        other = object.__new__(type(self))
        other.config = self.config
        other._scope = self._scope
        other._exe = Executor(self._exe.place if device is None
                              else place_for(device))
        other._program = self._program
        other.feed_names = list(self.feed_names)
        other._fetch_vars = self._fetch_vars
        other.fetch_names = list(self.fetch_names)
        if hasattr(self, "int8"):  # a Predictor advertises its weights'
            other.int8 = self.int8
        if device is not None:
            dev = other._exe.device
            pinned = Scope()
            for name in self._scope.var_names():
                if name.startswith("@"):
                    continue  # the generator: each scope seeds its own
                value = self._scope.get(name)
                if isinstance(value, torch.Tensor):
                    value = value.to(dev)
                pinned.set(name, value)
            other._scope = pinned
        return other


class Predictor(ProgramPredictor):
    """Loads a saved inference model into an isolated scope on the
    config's device and serves ``run``/``predict``."""

    def __init__(self, config):
        if isinstance(config, str):
            config = AnalysisConfig(model_dir=config)
        model_dir = config.model_dir
        # combined-file form: the directory comes from the file paths,
        # which must agree (``paddle_tpu/inference.py:214-226``)
        for fp in (config.prog_file, config.params_file):
            if fp is None:
                continue
            d = os.path.dirname(os.path.abspath(fp))
            if model_dir is None:
                model_dir = d
            elif os.path.abspath(model_dir) != d:
                raise ValueError(
                    "AnalysisConfig: %r is not inside model_dir %r"
                    % (fp, model_dir))
        if model_dir is None:
            raise ValueError("AnalysisConfig needs model_dir (the "
                             "save_inference_model output directory) or "
                             "prog_file/params_file paths")
        scope = Scope()
        exe = Executor(config.place)
        with scope_guard(scope):
            prog, feed_names, fetch_vars = io_mod.load_inference_model(
                model_dir, exe,
                model_filename=(os.path.basename(config.prog_file)
                                if config.prog_file else None),
                params_filename=(os.path.basename(config.params_file)
                                 if config.params_file else None))
        ProgramPredictor.__init__(self, prog, feed_names, fetch_vars,
                                  scope=scope, place=config.place)
        self.config = config
        self._exe = exe
        self.int8 = False
        if config._int8 is not False:
            from .contrib.quantize.quantize_transpiler import \
                load_int8_params

            self.int8 = bool(load_int8_params(
                model_dir, scope, require=config._int8 is True,
                device=exe.device))


def create_paddle_predictor(config):
    """Factory-name parity with the reference C-API."""
    return Predictor(config)
