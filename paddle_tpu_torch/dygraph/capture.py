"""A functional train step captured as one CUDA graph.

``paddle_tpu`` jits the step ``make_train_step`` returns with its state
donated (``bench.py:1258``). The port's counterpart:
:class:`CapturedTrainStep` runs the step eagerly on its first call
(kernel builds, cuBLAS handles, the allocator's pools), captures its
second call as one ``torch.cuda.CUDAGraph`` over fixed feed buffers
(``core/executor.py``'s ``capture_graph``, as the Executor's captured
step does), and replays the graph from then on. The step writes the
parameters and the optimizer state in place, so the graph reads and
writes the caller's own tensors. The generator the step draws from
(dropout, the attention dropout's seed) is registered with the graph, so
each replay advances it as an eager step would. The tensors must lie on
the card: on the CPU call the step itself.
"""

from ..core import executor

__all__ = ["CapturedTrainStep"]


class CapturedTrainStep:
    """``step(params, opt_state, generator, *feeds) -> (loss, params,
    opt_state)``, updating ``params`` and ``opt_state`` in place, bound to
    those tensors and ``generator``. Calling it with the feeds runs one
    step and returns the loss (a tensor of its own)."""

    def __init__(self, step, params, opt_state, generator):
        self.step = step
        self.params = params
        self.opt_state = opt_state
        self.generator = generator
        self.device = next(iter(params.values())).device
        self.graph = None
        self.feeds = None
        self.loss = None
        self.pool_bytes = 0
        self.runs = {"interpreted": 0, "captures": 0, "replays": 0}

    def body(self):
        """One step over the fixed feed buffers; returns the loss."""
        loss, _, _ = self.step(self.params, self.opt_state, self.generator,
                               *self.feeds)
        return loss

    def __call__(self, *feeds):
        feeds = [executor.to_tensor(f, self.device) for f in feeds]
        if self.runs["interpreted"] == 0:
            self.runs["interpreted"] += 1
            loss, _, _ = self.step(self.params, self.opt_state,
                                   self.generator, *feeds)
            return loss
        if self.graph is None:
            self.feeds = [f.clone() for f in feeds]
            self.graph, self.loss, self.pool_bytes = executor.capture_graph(
                self.body, self.generator, self.device)
            self.runs["captures"] += 1
        else:
            for buf, f in zip(self.feeds, feeds):
                buf.copy_(f)
            self.runs["replays"] += 1
        self.graph.replay()
        return self.loss.clone()

    def report(self):
        """Whether the step is captured, the graph pool's bytes and the
        runs by kind."""
        reason = "admitted" if self.graph is not None \
            else "call 1 runs eagerly; call 2 captures"
        return dict(self.runs, captured=self.graph is not None,
                    reason=reason, pool_bytes=self.pool_bytes)

    def close(self):
        """Free the graph and its pool."""
        self.graph = self.loss = self.feeds = None
