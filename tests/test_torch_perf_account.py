"""PyTorch port, training performance accounting: the card-name peak
table (no TPU entries) and its ``MXNET_PEAK_TFLOPS`` override, the 6NBL
MFU rule against the JAX package's, the step FLOPs counted from the
step (against an independent per-layer sum), and an
observed ``ShardedTrainer.step`` on the CPU leaving a ``train.step`` span
tree and the training metric series.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import perf_account as jax_pa
from mxnet_tpu_torch.models import torch_bert as tm
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import perf_account as pa
from mxnet_tpu_torch import runtime_metrics as rm
from mxnet_tpu_torch import tracing as tr


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H200", 989.0),
    ("NVIDIA A100-SXM4-80GB", 0.0)])
def test_detect_peak_from_device_name(monkeypatch, name, peak):
    monkeypatch.delenv("MXNET_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: name)
    assert pa.detect_peak_tflops() == peak


def test_detect_peak_without_a_card_is_unknown(monkeypatch):
    monkeypatch.delenv("MXNET_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pa.detect_peak_tflops() == 0.0


def test_peak_override(monkeypatch):
    monkeypatch.setenv("MXNET_PEAK_TFLOPS", "123.5")
    assert pa.detect_peak_tflops("NVIDIA H100 80GB HBM3") == 123.5


def test_mfu_matches_jax_rule():
    args = (335_000_000, 8, 512, 0.5, 989.0)
    assert pa.mfu(*args) == pytest.approx(jax_pa.mfu(*args), rel=1e-12)
    assert pa.mfu(1e9, 1, 1000, 1.0, 6.0) == pytest.approx(1.0)


KW = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
          num_heads=4, max_length=32, dropout=0.0)


def _trainer():
    head = tm.BERTForPretrain(tm.get_bert_model(
        "bert_12_768_12", use_flash=True, device="cpu", **KW), vocab_size=64)
    rs = np.random.RandomState(0)
    batch = (rs.randint(0, 64, (2, 16)).astype(np.int32),
             np.zeros((2, 16), np.int32), np.asarray([16, 9], np.float32),
             rs.randint(0, 9, (2, 3)).astype(np.int32),
             rs.randint(0, 64, (2, 3)).astype(np.int32),
             rs.randint(0, 2, (2,)).astype(np.int32))
    trainer = tpar.ShardedTrainer(head, tm.pretrain_loss,
                                  tpar.make_mesh(device="cpu"),
                                  example_inputs=batch[:4], n_labels=2)
    return trainer, batch


def test_step_flops_is_analytic():
    """The step's counted FLOPs equal an independent per-layer sum of its
    matrix products, three times each (forward, and the backward's two
    products): per layer the QKV, output and two FFN projections over
    the B * L tokens plus 4 B L^2 d of attention (flash, counted as the
    dense products); the pooler and NSP head over B rows; the MLM dense
    and decoder over the B * M masked positions only."""
    trainer, batch = _trainer()
    d, h, V, layers = 32, 64, 64, 2
    B, L = batch[0].shape
    M = batch[3].shape[1]
    T = B * L
    layer = (2 * T * d * 3 * d + 2 * T * d * d + 2 * 2 * T * d * h
             + 4 * B * L * L * d)
    heads = 2 * B * d * d + 2 * B * d * 2 + 2 * B * M * d * (d + V)
    want = 3.0 * (layers * layer + heads)
    assert pa.step_flops(trainer, batch) == want
    # counted once per signature, and a new shape counts anew
    assert list(trainer._flops.values()) == [want]
    short = tuple(a[:, :8] if a.ndim == 2 and a.shape[1] == L else a
                  for a in batch)
    assert pa.step_flops(trainer, short) < want
    assert len(trainer._flops) == 2


@pytest.fixture
def observed():
    tr.enable(sample=1.0)
    rm.enable()
    tr.reset()
    rm.reset()
    pa.reset()
    try:
        yield
    finally:
        tr.disable()
        rm.disable()
        tr.reset()
        rm.reset()
        pa.reset()


def test_observed_step_leaves_a_span_tree(observed):
    trainer, batch = _trainer()
    assert trainer.perf.active
    loss = trainer.step(*batch)
    assert torch.isfinite(loss)
    trace = tr.TRACER.last(root="train.step")
    assert trace is not None
    spans = {s["name"]: s for s in trace["spans"]}
    root = spans["train.step"]
    for child in ("train.h2d", "train.compute", "train.optimizer",
                  "train.collective"):
        assert spans[child]["parent_id"] == root["span_id"], child
    assert spans["train.h2d"]["t1"] <= spans["train.compute"]["t0"] + 1e-9
    assert spans["train.collective"]["t0"] == spans["train.collective"]["t1"]
    assert rm.TRAINER_STEP_SECONDS.count() == 1
    assert rm.TRAIN_STEP_BREAKDOWN_SECONDS.count(phase="compute") == 1
    assert rm.TRAIN_BOTTLENECK.value() == 0          # compute_bound
    assert trainer.perf.flops_per_step == pytest.approx(
        pa.step_flops(trainer, batch))
    summary = trainer.perf.summary()
    assert summary["steps"] == 1 and summary["verdict"] == "compute_bound"


def test_unobserved_step_is_inert():
    trainer, batch = _trainer()
    assert not trainer.perf.active
    assert trainer.perf.step_start() is pa._INERT
    before = trainer.params["mlm_dense.weight"].clone()
    trainer.step(*batch)
    assert not torch.equal(before, trainer.params["mlm_dense.weight"])
