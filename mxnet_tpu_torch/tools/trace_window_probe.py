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

``--bucket16 SECONDS`` instead traces 10 replays of a BERT-large
bucket-16 predict graph (``replicas_trace``'s program) again and again,
padded as ``chip_smoke`` pads, for that many seconds, and reports per
trace the B1 records against the 240 the replays hold, the device
records of each graph launch (grouped by correlation id), how far the
first device record starts after its launch and the last ends past the
last host record, and, for a trace short of records, which launch lost
which kernels.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/trace_window_probe.py [traces_per_pad]``
``python3 mxnet_tpu_torch/tools/trace_window_probe.py --bucket16 SECONDS``
"""
import collections
import json
import os
import sys
import time

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


def bucket16_trace(prog, padded, replays):
    """``replays`` calls of bucket program ``prog`` traced through
    ``chip_smoke._profiled``: the trace's B1 records, device records, the
    device records' names by correlation id of each graph launch, the
    least launch-to-first-kernel gap and the device end past the host's
    (microseconds)."""
    b1 = cs.FLASH_NAMES["flash_attention_fwd"]
    with cs._profiled(torch) as prof:
        for _ in range(replays):
            prog(*padded)
    launches, by_corr = {}, collections.defaultdict(list)
    n_b1 = n_dev = 0
    dev_end = host_end = 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            n_dev += 1
            n_b1 += b1 in e.name
            by_corr[e.id].append((e.time_range.start, e.time_range.end,
                                  e.name))
            dev_end = max(dev_end, e.time_range.end)
        else:
            host_end = max(host_end, e.time_range.end)
            if "GraphLaunch" in e.name:
                launches[e.id] = e.time_range.start
    gaps = [min(r[0] for r in by_corr[c]) - t
            for c, t in launches.items() if by_corr.get(c)]
    graph = {c: sorted(by_corr.get(c, [])) for c in launches}
    return n_b1, n_dev, graph, min(gaps) if gaps else None, dev_end - host_end


def lost_in(k, full, got):
    """Launch ``k``'s kernel names ``got`` against a complete launch's
    ``full``: the kernels missing and the first position that differs."""
    missing = collections.Counter(full) - collections.Counter(got)
    first = next((j for j, (a, b) in enumerate(zip(full, got)) if a != b),
                 len(got))
    return dict(launch=k, records=len(got), of=len(full),
                first_difference_at=first, missing=dict(missing))


def bucket16(seconds, replays=10):
    """``bucket16_trace`` again and again for ``seconds``: one JSON line a
    trace, and the names of the kernels a short launch lacks."""
    from mxnet_tpu_torch.serving import ModelRepository, pad_batch
    dev = torch.device("cuda:0")
    clients = cs._predict_traffic(cs.BERT_LARGE["vocab_size"])
    padded, _ = pad_batch([r for c in clients for r in c][:6],
                          cs.PREDICT_MAX_BATCH)
    clf = cs._bert_classifier(torch, dev, 0)
    entry = ModelRepository().add_block("bert", clf, *padded)
    prog = entry.make_program(cs.PREDICT_MAX_BATCH)
    for _ in range(3):
        prog(*padded)
    t0, i, short = time.perf_counter(), 0, 0
    while time.perf_counter() - t0 < seconds:
        n_b1, n_dev, graph, gap, past = bucket16_trace(prog, padded, replays)
        sizes = [len(v) for v in graph.values()]
        line = dict(trace=i, age_s=time.perf_counter() - t0, b1_records=n_b1,
                    b1_in_replays=24 * replays, device_records=n_dev,
                    graph_launches=len(graph), records_per_launch=sizes,
                    min_launch_to_kernel_us=gap, dev_end_past_host_us=past)
        if n_b1 != 24 * replays or len(set(sizes)) > 1:
            short += 1
            full = [r[2] for r in max(graph.values(), key=len)]
            line["lost"] = [lost_in(k, full, [r[2] for r in v])
                            for k, v in enumerate(graph.values())
                            if len(v) < len(full)]
        print(json.dumps(line), flush=True)
        i += 1
    print(json.dumps({"traces": i, "traces_short": short}), flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--bucket16"]:
        print(json.dumps({"device": cs.nvidia_smi()}), flush=True)
        build.build()
        return bucket16(float(sys.argv[2]))
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
