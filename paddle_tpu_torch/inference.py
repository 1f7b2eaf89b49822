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
raises. ``shard``, int8 serving, the StableHLO predictor and the
combined-file model form (``prog_file``/``params_file``) are not ported.
"""

from . import io as io_mod
from .core.executor import CPUPlace, CUDAPlace, Executor, Scope, scope_guard

__all__ = ["AnalysisConfig", "Predictor", "ProgramPredictor",
           "create_paddle_predictor"]


class AnalysisConfig:
    """Model directory plus the device to serve on."""

    def __init__(self, model_dir):
        self.model_dir = model_dir
        self.place = CUDAPlace(0)

    def disable_gpu(self):
        self.place = CPUPlace()


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

    def clone(self):
        """A predictor sharing this one's program and weights (ref
        ``AnalysisPredictor::Clone``)."""
        other = object.__new__(type(self))
        other.config = self.config
        other._scope = self._scope
        other._exe = Executor(self._exe.place)
        other._program = self._program
        other.feed_names = list(self.feed_names)
        other._fetch_vars = self._fetch_vars
        other.fetch_names = list(self.fetch_names)
        return other


class Predictor(ProgramPredictor):
    """Loads a saved inference model into an isolated scope on the
    config's device and serves ``run``/``predict``."""

    def __init__(self, config):
        if isinstance(config, str):
            config = AnalysisConfig(model_dir=config)
        scope = Scope()
        exe = Executor(config.place)
        with scope_guard(scope):
            prog, feed_names, fetch_vars = io_mod.load_inference_model(
                config.model_dir, exe)
        ProgramPredictor.__init__(self, prog, feed_names, fetch_vars,
                                  scope=scope, place=config.place)
        self.config = config
        self._exe = exe


def create_paddle_predictor(config):
    """Factory-name parity with the reference C-API."""
    return Predictor(config)
