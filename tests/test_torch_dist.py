"""PyTorch port, multi-process runtime: the launcher
(``mxnet_tpu_torch/tools/launch.py``), ``parallel.dist`` (bootstrap,
host collectives, the watchdog) and a two-rank trainer against a
one-process oracle, as gloo CPU jobs of real processes.

Twins of ``tests/test_dist.py``'s ``TestLauncher`` (not the kvstore
case: the kvstore is a later slice), ``TestWatchdog`` and
``TestMultiHostSPMD`` — the reference's two processes of four virtual
devices become two ranks of one device, a ``make_mesh(dp=2)`` trainer
whose two steps must match the one-process trainer (loss rtol 2e-4 /
2e-3, parameters rtol 2e-3, the reference's bounds) and the JAX
package's one-device trainer (losses atol 1e-4).  The BatchNorm twin
of ``tests/test_parallel.py`` runs on the same dp = 2 job: the running
mean after one step equals the JAX dp = 2 trainer's (the dp mean of
per-rank batch means is the global batch mean), it moves over five
steps, and a frozen weight is never decayed.

``run_job`` (used by the other ``test_torch_*`` multi-rank files)
writes a worker script into ``tmp_path``, hands it numpy inputs in an
``.npz`` and launches it; workers import ``torch`` and the port, never
``jax``, and each writes its results to ``out-<rank>.npz``.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jm
from mxnet_tpu import nd
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.tools import launch as launch_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = '''
import os
import numpy as np
import torch
torch.set_num_threads(1)
from mxnet_tpu_torch.parallel import dist
dist.initialize(device="cpu", timeout_s=120)
RANK, WORLD = dist.rank(), dist.size()
DIR = os.environ["MXT_JOB_DIR"]
IN = dict(np.load(os.path.join(DIR, "in.npz")))
OUT = {}
'''

EPILOGUE = '''
np.savez(os.path.join(DIR, f"out-{RANK}.npz"), **OUT)
dist.barrier()
dist.finalize()
print("WORKER_OK", RANK)
'''


def worker_env(tmp_path):
    return {"PYTHONPATH": REPO, "MXT_JOB_DIR": str(tmp_path),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def run_job(tmp_path, n, body, inputs=None, timeout=300):
    """Run ``body`` (after :data:`PRELUDE`) on ``n`` gloo CPU ranks;
    returns each rank's ``OUT`` dict."""
    np.savez(str(tmp_path / "in.npz"), **(inputs or {"_": np.zeros(1)}))
    script = tmp_path / "worker.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    rc = launch_mod.launch(n, [sys.executable, str(script)],
                           env_extra=worker_env(tmp_path), timeout=timeout)
    assert rc == 0, f"job exited {rc}"
    return [dict(np.load(str(tmp_path / f"out-{r}.npz"))) for r in range(n)]


def _write(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


# ------------------------------------------------------------- launcher
class TestLauncher:
    def test_two_process_allreduce(self, tmp_path):
        outs = run_job(tmp_path, 2, """
            assert WORLD == 2, WORLD
            total = dist.allreduce_host(np.array([RANK + 1.0], np.float32))
            assert total.tolist() == [3.0], total
            t = dist.allreduce_host(torch.tensor([RANK + 1.0]))
            assert isinstance(t, torch.Tensor) and t.tolist() == [3.0]
            b = dist.broadcast_host(np.array([float(RANK)], np.float32),
                                    root=1)
            assert b.tolist() == [1.0]
            dist.barrier()
            OUT["backend"] = np.array(dist.backend())
        """)
        assert [str(o["backend"]) for o in outs] == ["gloo", "gloo"]

    def test_failure_detection_aborts_job(self, tmp_path):
        """One dead worker must take the job down, not hang it."""
        script = _write(tmp_path, "w.py", """
            import sys, time
            from mxnet_tpu_torch.parallel import dist
            dist.initialize(device="cpu")
            if dist.rank() == 1:
                sys.exit(7)       # simulated worker crash
            time.sleep(600)       # would hang forever without detection
        """)
        t0 = time.monotonic()
        rc = launch_mod.launch(2, [sys.executable, script],
                               env_extra=worker_env(tmp_path), timeout=240)
        assert rc == 7
        assert time.monotonic() - t0 < 60

    def test_launcher_timeout(self, tmp_path):
        script = _write(tmp_path, "w.py", "import time; time.sleep(600)")
        t0 = time.monotonic()
        rc = launch_mod.launch(1, [sys.executable, script],
                               env_extra=worker_env(tmp_path), timeout=1)
        assert rc == 124
        assert time.monotonic() - t0 < 20

    def test_module_entry_point(self, tmp_path):
        """``python3 -m mxnet_tpu_torch.tools.launch -n 2 ...`` sets the
        env protocol, reference names included, and prefixes output."""
        script = _write(tmp_path, "w.py", """
            import os
            print("ENV", os.environ["MXNET_TPU_PROC_ID"],
                  os.environ["DMLC_WORKER_ID"],
                  os.environ["MXNET_TPU_NUM_PROCS"],
                  os.environ["DMLC_NUM_WORKER"], flush=True)
        """)
        proc = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
             "2", "--timeout", "60", sys.executable, script],
            env={**os.environ, **worker_env(tmp_path)}, timeout=120,
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        lines = sorted(ln for ln in proc.stdout.splitlines() if "ENV" in ln)
        assert lines == ["[worker-0] ENV 0 0 2 2", "[worker-1] ENV 1 1 2 2"]


# ------------------------------------------------------------- watchdog
class TestWatchdog:
    def test_watchdog_aborts_hung_step(self, tmp_path):
        script = _write(tmp_path, "w.py", """
            import time
            from mxnet_tpu_torch.parallel import dist
            wd = dist.Watchdog(timeout_s=2, name="step").start()
            wd.kick()
            time.sleep(600)   # hang: watchdog must abort with code 42
        """)
        proc = subprocess.run(
            [sys.executable, script],
            env={**os.environ, **worker_env(tmp_path)}, timeout=120,
            capture_output=True)
        assert proc.returncode == 42

    def test_watchdog_quiet_when_kicked(self):
        with dist.Watchdog(timeout_s=2, name="ok") as wd:
            for _ in range(3):
                time.sleep(0.5)
                wd.kick()
        # still alive — no abort

    def test_standalone_initialize_noop(self, monkeypatch):
        for var in ("MXNET_TPU_COORDINATOR", "MXNET_TPU_NUM_PROCS",
                    "MXNET_TPU_PROC_ID", "DMLC_PS_ROOT_URI",
                    "DMLC_NUM_WORKER", "DMLC_WORKER_ID"):
            monkeypatch.delenv(var, raising=False)
        dist.initialize()      # no env, no args: standalone no-op
        assert not dist.is_initialized()
        assert (dist.rank(), dist.size()) == (0, 1)

    def test_initialize_is_noop_while_finalizing(self, monkeypatch):
        """A concurrent initialize() during teardown must not create a
        process group while the shutdown is in flight."""
        def boom(*a, **k):      # pragma: no cover
            raise AssertionError("init_process_group called mid-teardown")

        monkeypatch.setattr(dist.tdist, "init_process_group", boom)
        monkeypatch.setitem(dist._state, "finalizing", True)
        dist.initialize(coordinator_address="127.0.0.1:1",
                        num_processes=1, process_id=0, device="cpu")
        assert not dist.is_initialized()
        dist.finalize()        # a concurrent finalize returns at once

    def test_env_protocol_and_backend_choice(self, monkeypatch):
        """The reference's DMLC names are read, a CPU rank gets gloo, an
        explicit backend wins, and an NCCL rank on the CPU is refused."""
        seen = []
        monkeypatch.setattr(dist.tdist, "init_process_group",
                            lambda backend, **kw: seen.append((backend, kw)))
        monkeypatch.setattr(dist, "_state", dict(dist._state))
        for var in ("MXNET_TPU_COORDINATOR", "MXNET_TPU_NUM_PROCS",
                    "MXNET_TPU_PROC_ID"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv("DMLC_PS_ROOT_URI", "10.0.0.7")
        monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9876")
        monkeypatch.setenv("DMLC_NUM_WORKER", "4")
        monkeypatch.setenv("DMLC_WORKER_ID", "3")
        assert dist._initialize_locked(None, None, None, 5, None, "cpu")
        backend, kw = seen[-1]
        assert backend == "gloo"
        assert kw["init_method"] == "tcp://10.0.0.7:9876"
        assert (kw["world_size"], kw["rank"]) == (4, 3)
        dist._state["initialized"] = False
        with pytest.raises(MXNetError, match="nccl backend needs a CUDA"):
            dist._initialize_locked(None, None, None, 5, "nccl", "cpu")
        monkeypatch.delenv("DMLC_WORKER_ID")
        with pytest.raises(MXNetError, match="must all be provided"):
            dist._initialize_locked(None, None, None, 5, None, "cpu")


# ------------------------------------------------------- multi-rank SPMD
BKW = dict(vocab_size=96, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=32, dropout=0.0)
B, L = 8, 16


def _cls_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 96, (B, L)).astype(np.int32),
            np.zeros((B, L), np.int32), np.full((B,), L, np.float32),
            rng.randint(0, 2, (B,)).astype(np.int32))


def _jax_cls_loss(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()


def jax_classifier(seed=0):
    """The JAX ``BERTClassifier`` of the reference's SPMD test and its
    parameters in the names the port's ``load_numpy_params`` takes."""
    mx.random.seed(seed)
    bert = jm.get_bert_model("bert_12_768_12", **BKW)
    bert.initialize()
    head = jm.BERTClassifier(bert, num_classes=2, dropout=0.0)
    head.initialize()
    pre = head.prefix
    params = {(k[len(pre):] if k.startswith(pre) else k):
              v.data().asnumpy() for k, v in head.collect_params().items()}
    return head, params


def jax_losses(head, mesh, batch, steps, lr=1e-3):
    arrs = [nd.array(a, dtype=str(a.dtype)) for a in batch]
    tr = jpar.ShardedTrainer(head, _jax_cls_loss, mesh, optimizer="adamw",
                             optimizer_params={"learning_rate": lr},
                             example_inputs=tuple(arrs[:3]), n_labels=1)
    return [float(jax.device_get(tr.step(*arrs))) for _ in range(steps)], tr


CLASSIFIER = '''
import re
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.models import torch_bert as tm

def classifier(use_flash=False):
    kw = dict(vocab_size=96, units=64, hidden_size=128, num_layers=2,
              num_heads=4, max_length=32, dropout=0.0)
    np_params = {k[3:]: v for k, v in IN.items() if k.startswith("np:")}
    head = tm.BERTClassifier(tm.get_bert_model(
        "bert_12_768_12", use_flash=use_flash, device="cpu", **kw),
        num_classes=2, dropout=0.0, device="cpu")
    return head.load_numpy_params(np_params)

def cls_loss(logits, labels):
    return -torch.log_softmax(logits.float(), -1).gather(
        -1, labels.long()[:, None]).mean()

def gluon_params(head, full):
    """{gluon name: numpy} of a trainer's gathered parameters."""
    port = {id(p): n for n, p in head.named_parameters()}
    return {"p:" + g: full[port[id(p)]].numpy()
            for g, p in head.gluon_names().items()}

BATCH = tuple(IN[k] for k in ("inp", "tt", "vl", "lab"))
'''


@pytest.fixture(scope="module")
def spmd_job(tmp_path_factory):
    """One two-rank job: the dp = 2 trainer and its one-process oracle,
    then the BatchNorm case."""
    tmp = tmp_path_factory.mktemp("spmd")
    jhead, np_params = jax_classifier()
    batch = _cls_batch()
    rs = np.random.RandomState(5)
    bn = dict(bn_x=(rs.rand(8, 4) + 3.0).astype(np.float32),
              bn_y=rs.rand(8, 2).astype(np.float32))
    inputs = {"np:" + k: v for k, v in np_params.items()}
    inputs.update(inp=batch[0], tt=batch[1], vl=batch[2], lab=batch[3],
                  **bn)
    outs = run_job(tmp, 2, CLASSIFIER + textwrap.dedent('''
        opt = dict(optimizer="adamw", optimizer_params={"learning_rate": 1e-3})
        one = tpar.ShardedTrainer(classifier(), cls_loss, tpar.Mesh("cpu"),
                                  example_inputs=BATCH[:3], n_labels=1, **opt)
        o = [float(one.step(*BATCH)) for _ in range(2)]
        mesh = tpar.make_mesh(dp=2, device="cpu")
        assert mesh.shape == {"dp": 2, "tp": 1, "sp": 1, "ep": 1}
        head = classifier()
        tr = tpar.ShardedTrainer(head, cls_loss, mesh,
                                 example_inputs=BATCH[:3], n_labels=1,
                                 **opt)
        d = [float(tr.step(*BATCH)) for _ in range(2)]
        full = tr.gathered_params()
        OUT["oracle"], OUT["dp2"] = np.array(o), np.array(d)
        OUT["ck_dp2"] = np.array([float(full[n].sum()) for n in sorted(full)])
        OUT["ck_one"] = np.array([float(one.params[n].detach().sum())
                                  for n in sorted(full)])
        # BatchNorm: running stats through the dp step, frozen weight
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                  torch.nn.BatchNorm1d(8),
                                  torch.nn.Linear(8, 2))
        mse = lambda o, t: ((o - t) ** 2).mean()
        tr = tpar.ShardedTrainer(
            net, mse, mesh, optimizer="adamw",
            optimizer_params={"learning_rate": 1e-3, "weight_decay": 0.1},
            example_inputs=(IN["bn_x"],), n_labels=1)
        before = tr.buffers["1.running_mean"].clone()
        for net_w, name in ((net[0].weight, "w0"), (net[0].bias, "b0")):
            OUT[name] = net_w.detach().numpy().copy()
        tr.step(IN["bn_x"], IN["bn_y"])
        OUT["bn_mean1"] = tr.buffers["1.running_mean"].numpy().copy()
        for _ in range(4):
            tr.step(IN["bn_x"], IN["bn_y"])
        OUT["bn_moved"] = np.array(float(
            (tr.buffers["1.running_mean"] - before).abs().max()))
        net2 = torch.nn.Linear(4, 4)
        net2.weight.requires_grad_(False)
        w0 = net2.weight.detach().clone()
        tr2 = tpar.ShardedTrainer(
            net2, mse, mesh, optimizer="adamw",
            optimizer_params={"learning_rate": 1e-2, "weight_decay": 0.5},
            example_inputs=(IN["bn_x"],), n_labels=1)
        for _ in range(5):
            tr2.step(IN["bn_x"], np.ones((8, 4), np.float32))
        OUT["frozen_moved"] = np.array(float(
            (tr2.params["weight"] - w0).abs().max()))
    '''), inputs)
    return outs, jhead, batch, bn


class TestMultiHostSPMD:
    def test_two_rank_trainer_matches_one_process_oracle(self, spmd_job):
        outs, jhead, batch, _ = spmd_job
        for o in outs:
            np.testing.assert_allclose(o["dp2"][0], o["oracle"][0],
                                       rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(o["dp2"][1], o["oracle"][1],
                                       rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(o["ck_dp2"], o["ck_one"], rtol=2e-3,
                                       atol=2e-3)
        np.testing.assert_array_equal(outs[0]["dp2"], outs[1]["dp2"])
        jl, _ = jax_losses(
            jhead, jpar.make_mesh(dp=1, tp=1, sp=1,
                                  devices=jax.devices()[:1]), batch, 2)
        np.testing.assert_allclose(outs[0]["dp2"], jl, atol=1e-4)

    def test_batchnorm_stats_update_and_frozen_preserved_on_dp2(
            self, spmd_job):
        outs, _, _, bn = spmd_job
        from mxnet_tpu.gluon import nn as jnn
        jnet = jnn.HybridSequential()
        jnet.add(jnn.Dense(8, in_units=4))
        jnet.add(jnn.BatchNorm(in_channels=8))
        jnet.add(jnn.Dense(2, in_units=8))
        jnet.initialize()
        jnet[0].weight.set_data(nd.array(outs[0]["w0"]))
        jnet[0].bias.set_data(nd.array(outs[0]["b0"]))
        jtr = jpar.ShardedTrainer(
            jnet, lambda o, t: ((o - t) ** 2).mean(),
            jpar.make_mesh(dp=2, tp=1, sp=1, devices=jax.devices()[:2]),
            optimizer="adamw",
            optimizer_params={"learning_rate": 1e-3, "weight_decay": 0.1},
            example_inputs=(nd.array(bn["bn_x"]),), n_labels=1)
        jtr.step(nd.array(bn["bn_x"]), nd.array(bn["bn_y"]))
        want = np.asarray(jax.device_get(
            jtr.params[jnet[1].running_mean.name]))
        for o in outs:
            # the dp mean of per-rank batch means is the global mean
            np.testing.assert_allclose(o["bn_mean1"], want, atol=1e-5)
            assert float(o["bn_moved"]) > 1e-4
            assert float(o["frozen_moved"]) == 0.0
