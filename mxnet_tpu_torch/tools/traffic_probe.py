#!/usr/bin/env python3
"""Replay ``chip_smoke.py``'s ``traffic`` phase with another trace shape,
and measure what PyTorch's per-stream cuBLAS workspaces leave allocated.

``--workspace`` (first, before anything else runs on the card): the
allocator bytes an eager GEMM leaves on a new ``torch.cuda.Stream``, what
a CUDA-graph capture of the same GEMM on that stream adds, how many
distinct streams 40 ``torch.cuda.Stream()`` calls give and what eager
GEMMs on all of them leave.  That is the memory a scale-down cannot give
back: a graph captured on a stream uses the workspace its eager warm-up
left there.

``--rows-max N``: builds the kernels, runs ``serve`` and ``predict`` (the
SLOs come from them, as in the script), then ``traffic`` with the trace's
predict rows drawn from 1..N (``chip_smoke.TRAFFIC_TRACE["rows_max"]``,
12 by default).  Every ``traffic_run`` line of the frozen and scaled
runs is printed; a hard check of the phase that fails (at N = 5 the
scaled run adds no bert replica) is reported as a ``traffic_probe`` line
instead of raised.

One JSON line per result; the card's name and power limit last.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/traffic_probe.py [--workspace]
[--rows-max N]``
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.models import TransformerDecoderLM  # noqa: E402
from mxnet_tpu_torch.ops import build  # noqa: E402

MIB = 2 ** 20


def workspace(dev):
    """What cuBLAS's per-(handle, stream) workspace leaves allocated."""
    a = torch.randn(512, 512, device=dev)
    out_bytes = a.numel() * a.element_size()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    s1 = torch.cuda.Stream(dev)
    with torch.cuda.stream(s1):
        y = a @ a
    torch.cuda.synchronize()
    eager = torch.cuda.memory_allocated() - base - out_bytes
    g = torch.cuda.CUDAGraph()
    before = torch.cuda.memory_allocated()
    with torch.cuda.graph(g, stream=s1):
        z = a @ a
    torch.cuda.synchronize()
    captured = torch.cuda.memory_allocated() - before - out_bytes
    streams = [torch.cuda.Stream(dev) for _ in range(40)]
    before = torch.cuda.memory_allocated()
    for s in streams:
        with torch.cuda.stream(s):
            a @ a
    torch.cuda.synchronize()
    many = torch.cuda.memory_allocated() - before
    g.replay()
    torch.cuda.synchronize()
    return dict(eager_gemm_new_stream_mib=eager / MIB,
                capture_same_stream_extra_mib=captured / MIB,
                distinct_of_40_streams=len({s.cuda_stream for s in streams}),
                eager_gemms_on_40_streams_mib=many / MIB,
                replay_equals_eager=bool(torch.equal(z, y)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workspace", action="store_true")
    ap.add_argument("--rows-max", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("traffic_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    if args.workspace:
        print(json.dumps({"phase": "workspace", **workspace(dev)}),
              flush=True)
    if args.rows_max is not None:
        cs.TRAFFIC_TRACE = dict(cs.TRAFFIC_TRACE, rows_max=args.rows_max)
        build.build()
        lm = TransformerDecoderLM(**cs.GPT2_SMALL, device=dev,
                                  generator=torch.Generator().manual_seed(0))
        lm.eval()
        _launches, served = cs.phase_serve(torch, dev, lm)
        predict = cs.phase_predict(torch, dev, lm, served)
        try:
            cs.phase_traffic(torch, dev, lm, served, predict)
            failed = None
        except RuntimeError as e:       # a hard check: reported here
            failed = str(e)
        finally:
            predict["srv"].stop(timeout=120)
        print(json.dumps({"phase": "traffic_probe",
                          "rows_max": args.rows_max, "failed": failed}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
