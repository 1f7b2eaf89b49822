#!/usr/bin/env python3
"""Wall seconds of each phase of another checkout's ``chip_smoke.py``.

    python3 paddle_tpu_torch/tools/phase_times.py --root DIR

Runs ``DIR/chip_smoke.py``'s ``main()`` (it builds and imports that
checkout's ``paddle_tpu_torch``) with every ``phase_*`` function and the
helpers of ``chip_smoke.TIMED_HELPERS`` wrapped by this checkout's
``chip_smoke.time_phases``, then prints its ``phase_seconds`` line, as this
checkout's script prints its own: the total and [seconds, calls] by
function. For a checkout whose script predates the line. Exits with the
script's code.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    args = ap.parse_args()
    this = _module(os.path.join(THIS_ROOT, "chip_smoke.py"), "chip_smoke_timer")
    other = _module(os.path.join(os.path.abspath(args.root), "chip_smoke.py"),
                    "chip_smoke_timed")
    seconds = {}
    this.time_phases(vars(other), seconds)
    t0 = time.perf_counter()
    rc = other.main()
    print(json.dumps({"phase": "phase_seconds", "root": args.root,
                      "total": time.perf_counter() - t0,
                      "seconds_calls": seconds}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
