#!/usr/bin/env python3
"""Trace ``chip_smoke.py``'s ``serve_trace`` traffic again and again, with
and without the idle padding of ``chip_smoke._profiled``, and report for
each trace whether the B4 kernel records equal ``num_layers`` per decode
replay, as ``serve_trace`` requires.

``torch.profiler`` keeps a device record only inside the host's window
from the trace's start to its stop; a record whose converted device time
lands past the stop is dropped without a word.  Each trace here gives the
records, what the replays hold, all device records, and how far the last
device record ends past the last host record (``dev_end_past_host_us``;
positive means device time stood after every host event).  The padding
under test is ``chip_smoke.TRACE_PAD_S``; ``pad_s = 0`` is the same trace
with no idle time at its ends.  One JSON line per trace; the card's name
and power limit come first.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/trace_window_probe.py [traces_per_pad]``
"""
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
from mxnet_tpu_torch.serving import DecodeEngine, PagedLMAdapter  # noqa: E402


def one_trace(lm):
    """``serve_trace``'s traffic on a new graphs engine, traced through
    ``chip_smoke._profiled``: (B4 records, 12 x decode replays, device
    records, last device end minus last host end in microseconds)."""
    cfg, warm, waves = cs._serve_traffic(lm)
    adapter = PagedLMAdapter(lm, device="cuda")
    eng = DecodeEngine(adapter, cfg, model_name="probe", autostart=True)
    try:
        eng.generate(warm, max_new_tokens=4, timeout=600)
        before = {k: p.replays for k, p in adapter._programs.items()}
        with cs._profiled(torch) as prof:
            for wave in waves:
                cs._run_wave(eng, wave)
        ran = {k: p.replays - before[k] for k, p in adapter._programs.items()}
    finally:
        eng.stop(timeout=120)
    b4, n_dev, dev_end, host_end = 0, 0, 0.0, 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            n_dev += 1
            dev_end = max(dev_end, e.time_range.end)
            b4 += cs.KERNEL_NAMES["ragged_paged_attention"] in e.name
        else:
            host_end = max(host_end, e.time_range.end)
    want = lm.num_layers * sum(n for k, n in ran.items() if k[0] == "decode")
    return b4, want, n_dev, dev_end - host_end


def main():
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    print(json.dumps({"device": cs.nvidia_smi()}), flush=True)
    build.build()
    lm = TransformerDecoderLM(**cs.GPT2_SMALL, device=torch.device("cuda:0"),
                              generator=torch.Generator().manual_seed(0))
    lm.eval()
    pad = cs.TRACE_PAD_S
    short = {0.0: 0, pad: 0}
    for i in range(n):
        for p in (0.0, pad):
            cs.TRACE_PAD_S = p
            b4, want, n_dev, past = one_trace(lm)
            short[p] += b4 != want
            print(json.dumps(dict(trace=i, pad_s=p, b4_records=b4,
                                  b4_in_replays=want, device_records=n_dev,
                                  dev_end_past_host_us=past)), flush=True)
    cs.TRACE_PAD_S = pad
    print(json.dumps({"traces_per_pad": n, "traces_short_of_replays":
                      {str(p): k for p, k in short.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
