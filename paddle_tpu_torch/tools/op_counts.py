#!/usr/bin/env python3
"""The PyTorch ops an ``ssd_lite`` training step dispatches, by the
program's op type.

    python3 paddle_tpu_torch/tools/op_counts.py [--batch 8]

Builds ``chip_smoke.build_ssd``'s training program on the CPU, runs one
step (its first run also builds the constant prior grids), then counts
the ATen ops a second step dispatches under a ``TorchDispatchMode``, each
charged to the program op running it (views and aliases left out). Prints
one JSON line: the total and the count by op type. A step on the card
launches about one kernel for each of these.
"""

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_VIEWS = {"view", "_unsafe_view", "t", "detach", "expand", "alias", "slice",
          "select", "unsqueeze", "squeeze", "permute", "transpose",
          "as_strided", "_reshape_alias", "split", "unbind"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor, op_registry

    counts, current = collections.Counter(), [None]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if current[0] and func.overloadpacket.__name__ not in _VIEWS:
                counts[current[0]] += 1
            return func(*args, **(kwargs or {}))

    def run_op(env, op):
        outer, current[0] = current[0], op.type
        try:
            return op_registry.run_op(env, op)
        finally:
            current[0] = outer

    main_prog, startup, spec, _, _ = chip_smoke.build_ssd(fluid)
    feed = chip_smoke.ssd_feed(spec, args.batch)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main_prog, feed=feed, fetch_list=[spec.loss], scope=scope)
    executor.run_op = run_op
    with Count():
        exe.run(main_prog, feed=feed, fetch_list=[spec.loss], scope=scope)
    print(json.dumps({"model": "ssd_lite", "batch": args.batch,
                      "device": "cpu", "ops_dispatched": sum(counts.values()),
                      "by_op_type": dict(counts.most_common())}))


if __name__ == "__main__":
    main()
