#!/usr/bin/env python3
"""A few main-path phases of one checkout's ``chip_smoke.py``, alone.

    python3 paddle_tpu_torch/tools/phase_ab.py --root DIR \\
        --phases capture_check,amp_train,resnet_amp_train,deepfm_amp_train,decode

Loads ``DIR/chip_smoke.py`` (it builds and imports that checkout's
``paddle_tpu_torch``), builds the kernels, runs the named phases in the
order given, each as the whole script runs it, and prints their lines,
then one ``phase_ab`` line: the phase seconds, each training phase's
median captured step ms, and decode's tokens/s, TPOT p50 and captured
dispatch wall ms per arm. Run it once for each of two checkouts in one
call to the card (parent, change, change, parent) to compare them: the
timing arguments the script passes the training phases from its
``timing`` phase are only printed beside their readings, so they are 0
here. Phases: ``capture_check``, ``amp_train``, ``resnet_amp_train``,
``deepfm_amp_train``, ``decode`` (with ``decode_check``, which builds its
programs), and ``bert_pretrain_check`` where the checkout has it.
"""

import argparse
import importlib.util
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

ZERO_FLASH = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}


def _module(path):
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text, phase):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{"phase": "%s"' % phase)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--phases", required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _module(os.path.join(root, "chip_smoke.py"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_device(torch)
    cs.phase_build()
    runs = {
        "capture_check": lambda: cs.phase_capture_check(torch),
        "amp_train": lambda: cs.phase_train(torch, smi, ZERO_FLASH,
                                            amp=True),
        "resnet_amp_train": lambda: cs.phase_resnet_train(
            torch, smi, 0.0, amp=True),
        "deepfm_amp_train": lambda: cs.phase_deepfm_train(torch, smi,
                                                          amp=True),
        "decode": lambda: cs.phase_decode(
            torch, smi, cs.phase_decode_check(torch, smi)),
        "bert_pretrain_check": lambda: cs.phase_bert_pretrain_check(
            torch, smi),
    }
    out = {"phase": "phase_ab", "root": args.root, "device": smi,
           "seconds": {}}
    for name in args.phases.split(","):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            runs[name]()
        out["seconds"][name] = time.perf_counter() - t0
        text = buf.getvalue()
        sys.stdout.write(text)
        if name == "decode":
            out["decode"] = {
                d["arm"]: {"tokens_per_s": d["tokens_per_s"],
                           "tpot_ms_p50": d["tpot_ms"]["p50"],
                           "wall_s": d["wall_s"],
                           "warmup_s": d["warmup_s"],
                           "dispatch_wall_ms": d["profile"][
                               "wall_ms_per_dispatch"],
                           "dispatch_busy": d["profile"][
                               "device_busy_share"]}
                for d in _lines(text, "decode") if "arm" in d}
        elif name.endswith("train"):
            d = _lines(text, name)[-1]
            out[name] = {k: d[k] for k in ("step_ms_median", "step_ms_min",
                                           "step_ms_max")}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
