#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``imagenet`` float32 recipe (ResNet-50 at
224², batch 32, SGD 0.02 / 0.9 from seed 0, 60 iterations over the
synthetic 256-record shard) several times in one process, with cuDNN's
default algorithms and with ``torch.backends.cudnn.deterministic``, and
report each run's loss trajectory head, last loss, train-set accuracy
and whether it meets the phase's criterion (last loss at most 0.9 × the
first, accuracy at least 0.5).  The default algorithms accumulate in a
run-dependent order, and the recipe amplifies the difference: one JSON
line a run; the card's name and power limit come first.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/imagenet_float32_probe.py [runs_each]``
"""
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    import mxnet_tpu_torch as mx
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    if not torch.cuda.is_available():
        print("imagenet_float32_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(cs.nvidia_smi(), flush=True)
    cfg = dict(cs.IMAGENET, dtype=None)
    tmp = tempfile.mkdtemp(prefix="mxnet-imagenet-probe-")
    try:
        prefix = os.path.join(tmp, "synth_imagenet")
        cs._synth_rec(prefix, cfg["records"], cfg["image"], cfg["classes"])
        for deterministic in [True] * runs + [False] * runs:
            torch.backends.cudnn.deterministic = deterministic
            t0 = time.perf_counter()
            run, _ = cs._imagenet_train(torch, mx, prefix + ".rec", cfg)
            losses = run["losses"]
            print(json.dumps(dict(
                cudnn_deterministic=deterministic,
                losses_head=losses[:8], last_loss=losses[-1],
                accuracy=run["accuracy"],
                meets_criterion=bool(losses[-1] <= 0.9 * losses[0]
                                     and run["accuracy"] >= 0.5),
                step_ms=run["step_ms"],
                seconds=time.perf_counter() - t0)), flush=True)
            cs._free(torch)
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
