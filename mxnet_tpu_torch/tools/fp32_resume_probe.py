#!/usr/bin/env python3
"""Whether an fp32 supervised training run on the card resumes bit for
bit, as the JAX package's ``TrainingSupervisor`` does.

``chip_smoke.py``'s ``durability`` phase holds the bf16 step to that; this
probe runs the same fault plan (``chip_smoke.DURABILITY_SPEC``: a killed
step, a corrupt checkpoint restore, a step stalled past its deadline) on a
two-layer ``BERTForPretrain`` at BERT-large widths in fp32 (TF32 off),
through the captured step (``graphs=True``), against an uninterrupted run
and a second uninterrupted run from the same seed.  Before that, one
batch's gradients are taken twice from the same weights (eager, no
optimizer step) and every parameter whose gradient differs bitwise between
the two is named: that says which backward is not repeatable.  Last,
the cost of the embeddings' sorted-segment-sum weight gradient
(``models/torch_bert.py``) against ``F.embedding``'s own backward, on the
training batch's word and token-type indices at BERT-large width, fp32
and bf16: milliseconds of one forward + backward, CUDA events, median of
30 calls after 3.

One JSON line per reading; the card's name and power limit come first.

Usage, from the repository root on a machine with one card:
``python3 mxnet_tpu_torch/tools/fp32_resume_probe.py``
"""
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.models import torch_bert as models  # noqa: E402
from mxnet_tpu_torch.ops import build  # noqa: E402
from mxnet_tpu_torch.parallel import StepWatchdog  # noqa: E402

LAYERS = 2


def grad_repeat(dev, feats, labels):
    """Parameters whose gradient on one batch differs bitwise between
    two backward passes from the same weights."""
    head = models.BERTForPretrain(models.bert_24_1024_16(
        dropout=0.0, use_flash=True, device=dev, num_layers=LAYERS,
        generator=torch.Generator().manual_seed(0)))
    tf = [torch.from_numpy(a).to(dev) for a in feats]
    tl = [torch.from_numpy(a).to(dev) for a in labels]
    names = [n for n, _ in head.named_parameters()]
    params = [p for _, p in head.named_parameters()]
    grads = []
    for _ in range(2):
        loss = models.pretrain_loss(head(*tf), *tl)
        grads.append(torch.autograd.grad(loss, params))
    torch.cuda.synchronize()
    diff = {}
    for n, a, b in zip(names, *grads):
        if not bool((cs._bits(a) == cs._bits(b)).all()):
            diff[n] = float((a - b).abs().max())
    return diff, len(names)


def _median_ms(fn, n=30):
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def embedding_backward_ms(dev, feats):
    """ms of one embedding forward + backward: the sorted segment sum
    (``_embed``) against ``F.embedding``, per table and dtype."""
    from mxnet_tpu_torch.models.torch_bert import _embed
    out = {}
    units = cs.BERT_LARGE["units"]
    for name, rows, idx in (("word", cs.BERT_LARGE["vocab_size"], feats[0]),
                            ("token_type", 2, feats[1])):
        i = torch.from_numpy(idx).to(dev).long()
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.nn.Embedding(rows, units, device=dev, dtype=dtype)
            g = torch.randn(*i.shape, units, device=dev, dtype=dtype)

            def sorted_sum():
                table.weight.grad = None
                _embed(table, i).backward(g)

            def torch_own():
                table.weight.grad = None
                F.embedding(i, table.weight).backward(g)

            out[f"{name}/{str(dtype).split('.')[-1]}"] = dict(
                sorted_segment_ms=_median_ms(sorted_sum),
                torch_embedding_ms=_median_ms(torch_own))
    return out


def main():
    if not torch.cuda.is_available():
        print("fp32_resume_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(cs.nvidia_smi(), flush=True)
    build.build()
    dev = torch.device("cuda:0")
    model_kw = {"num_layers": LAYERS}
    feats, labels = cs._train_batch(cs.BERT_LARGE["vocab_size"])
    diff, n = grad_repeat(dev, feats, labels)
    cs.emit("fp32_grad_repeat", tensors=n, differ=sorted(diff),
            max_abs_diff=diff)
    warm = tuple(feats) + tuple(labels)
    root = tempfile.mkdtemp(prefix="mxnet-fp32-resume-")
    stalled = []
    try:
        runs, trainers = {}, {}
        for run in ("reference", "repeat", "faulted"):
            tr = cs._durability_trainer(torch, dev, feats, model_kw,
                                        dtype="float32")
            tr.step(*warm)
            trainers[run] = tr
        for run in ("reference", "repeat"):
            runs[run] = cs._supervised(torch, dev, trainers[run], root, run,
                                       model_kw)
            runs[run]["mngr"].close()
        stall_ms = (runs["reference"]["seconds"] + cs.STALL_MARGIN_S) * 1e3
        tr = trainers["faulted"]
        tr.watchdog = StepWatchdog(timeout_ms=cs.DEADLINE_MIN_MS,
                                   slow_factor=0)
        before = cs._watchdog_threads()
        got = cs._supervised(torch, dev, tr, root, "faulted", model_kw,
                             cs.DURABILITY_SPEC.format(stall_ms=stall_ms))
        got["mngr"].close()
        stalled = [t for t in cs._watchdog_threads() - before
                   if t.is_alive()]
        want = runs["reference"]["losses"]
        cs.emit("fp32_resume", layers=LAYERS, steps=cs.DURABILITY_STEPS,
                spec=cs.DURABILITY_SPEC.format(stall_ms=stall_ms),
                fired=got["fired"], restarts=got["sup"].restarts,
                timeouts=tr.watchdog.timeouts,
                losses_uninterrupted=want,
                losses_repeat=runs["repeat"]["losses"],
                losses_faulted=got["losses"],
                repeat_bitwise_equal=runs["repeat"]["losses"] == want,
                faulted_bitwise_equal=got["losses"] == want,
                faulted_max_rel_err=max(abs(a - b) / abs(b) for a, b in
                                        zip(got["losses"], want)))
    finally:
        for t in stalled:
            t.join(600)
        shutil.rmtree(root, ignore_errors=True)
    cs.emit("embedding_backward", indices=int(feats[0].size),
            ms=embedding_backward_ms(dev, feats))
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
