"""PyTorch port, the artifact path: ``deploy.export_stablehlo`` (a
``torch.export`` program with B1 as the registered operator
``mxnet_tpu_torch::flash_attention_fwd``), ``deploy.load_stablehlo``
and ``ModelRepository.load_artifact``.

Twins of the JAX package's artifact tests (tests/test_export_stablehlo.py,
tests/test_serving.py, tests/test_faults.py) on the reference's MLP
(Dense 16 + ReLU, BatchNorm, Dense 4) carried into ``nn.Linear`` /
``nn.BatchNorm1d``; the exported flash BERT's graph; the artifact loaded
and run in a fresh process that imports ``torch`` alone (the MLP) or
``torch`` and ``mxnet_tpu_torch.ops`` alone (the BERT); and, against
the JAX package: both packages' exports of one MLP agree on the manifest
and the outputs (1e-5), and a small flash ``BERTClassifier`` (2 layers,
64 units, 4 heads, L = 32) with the JAX weights, exported and served
through ``load_artifact`` -> ``ModelServer.predict``, matches the JAX
package's ``ModelServer`` on the same requests within atol 1e-5 (the
tolerance of tests/test_torch_serving_predict.py: the frameworks sum in
different orders, nothing else differs).

Everything runs on the CPU (``device="cpu"``), where B1's operator takes
the kernel's plain version; ``chip_smoke.py``'s ``artifact`` phase runs
the same path on the card.  Exports run once per module (fixtures).
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
from torch import nn

import mxnet_tpu as mx
from mxnet_tpu import deploy as jdeploy
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import deploy, faults
from mxnet_tpu_torch import runtime_metrics as rm
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                     ServingConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
FLASH_OP = "mxnet_tpu_torch.flash_attention_fwd"


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.clear()
    rm.reset()
    rm.enable()
    yield
    faults.clear()
    rm.disable()
    rm.reset()


def _cfg(**kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_latency_us", 20_000)
    return ServingConfig(**kw)


# ------------------------------------------------ the reference's MLP
def _jax_net(seed=7, batchnorm=True):
    """tests/test_export_stablehlo.py's net, with BatchNorm running
    statistics set away from 0 / 1 so that the carried twin's eval-mode
    normalisation is exercised."""
    mx.random.seed(seed)
    net = jnn.HybridSequential(prefix="shlo_net_")
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu", in_units=8))
        if batchnorm:
            net.add(jnn.BatchNorm(in_channels=16))
        net.add(jnn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier())
    if batchnorm:
        rs = np.random.RandomState(seed)
        params = net.collect_params()
        params["shlo_net_batchnorm0_running_mean"].set_data(
            nd.array(rs.randn(16).astype(np.float32) * 0.1))
        params["shlo_net_batchnorm0_running_var"].set_data(
            nd.array(rs.uniform(0.5, 1.5, 16).astype(np.float32)))
    net.hybridize()
    return net


def _carry(jnet):
    """The port's twin of a ``_jax_net``: ``nn.Linear`` and
    ``nn.BatchNorm1d`` (eval mode) holding the JAX net's weights, bias,
    gamma, beta and running statistics."""
    p = {k[len("shlo_net_"):]: v.data().asnumpy().copy()
         for k, v in jnet.collect_params().items()}
    layers = [nn.Linear(8, 16), nn.ReLU()]
    if "batchnorm0_gamma" in p:
        layers.append(nn.BatchNorm1d(16, eps=jnet[1]._eps))
    layers.append(nn.Linear(16, 4))
    net = nn.Sequential(*layers)
    lin0, lin1 = layers[0], layers[-1]
    with torch.no_grad():
        for lin, pre in ((lin0, "dense0_"), (lin1, "dense1_")):
            lin.weight.copy_(torch.from_numpy(p[pre + "weight"]))
            lin.bias.copy_(torch.from_numpy(p[pre + "bias"]))
        if len(layers) == 4:
            bn = layers[2]
            bn.weight.copy_(torch.from_numpy(p["batchnorm0_gamma"]))
            bn.bias.copy_(torch.from_numpy(p["batchnorm0_beta"]))
            bn.running_mean.copy_(
                torch.from_numpy(p["batchnorm0_running_mean"]))
            bn.running_var.copy_(
                torch.from_numpy(p["batchnorm0_running_var"]))
    return net.eval()


def _ref(net, *xs):
    with torch.no_grad():
        return net(*(torch.from_numpy(x) for x in xs)).numpy()


def _x(rows, seed=0, cols=8):
    return np.random.RandomState(seed).uniform(
        size=(rows, cols)).astype(np.float32)


def _export(net, tmp_path, name="m", dynamic_batch=True, batch=5,
            version=None):
    return deploy.export_stablehlo(net, _x(batch), path=str(tmp_path / name),
                                   dynamic_batch=dynamic_batch,
                                   version=version)


@pytest.fixture(scope="module")
def static_art(tmp_path_factory):
    """One static export shared module-wide: (net, x, path-prefix)."""
    net = _carry(_jax_net())
    x = _x(5, seed=1)
    path = str(tmp_path_factory.mktemp("art_static") / "model")
    deploy.export_stablehlo(net, x, path=path, emit_text=True)
    return net, x, path


@pytest.fixture(scope="module")
def dynamic_art(tmp_path_factory):
    """One dynamic-batch export shared module-wide: (net, path-prefix)."""
    net = _carry(_jax_net())
    path = str(tmp_path_factory.mktemp("art_dyn") / "dyn")
    deploy.export_stablehlo(net, _x(5), path=path, dynamic_batch=True,
                            version=3)
    return net, path


# -------------------------------------------------- deploy.py's twins
def test_load_stablehlo_roundtrip(static_art, tmp_path):
    net, x, path = static_art
    fn = deploy.load_stablehlo(path + ".shlo", device="cpu")
    np.testing.assert_allclose(fn.call(x).numpy(), _ref(net, x),
                               rtol=1e-5, atol=1e-5)
    assert fn.content_hash == __import__("hashlib").sha256(
        open(path + ".shlo", "rb").read()).hexdigest()
    with pytest.raises(MXNetError, match="no artifact"):
        deploy.load_stablehlo(str(tmp_path / "missing.shlo"), device="cpu")


def test_manifest_validation_roundtrip(static_art, tmp_path):
    """load_stablehlo validates calls against the .json manifest: a
    shape or dtype mistake raises a clear MXNetError naming the manifest;
    matching inputs still round-trip."""
    net, x, path = static_art
    fn = deploy.load_stablehlo(path + ".shlo", device="cpu")
    assert fn.manifest["inputs"] == [{"shape": [5, 8], "dtype": "float32"}]
    assert fn.manifest["outputs"][0]["shape"] == [5, 4]
    assert fn.manifest["format"] == "torch.export"
    assert not fn.dynamic_batch and fn.quantization is None
    # the good path round-trips (numpy or a tensor)
    np.testing.assert_allclose(fn.call(torch.from_numpy(x)).numpy(),
                               _ref(net, x), rtol=1e-5, atol=1e-5)
    with pytest.raises(MXNetError, match="dtype mismatch"):
        fn.call(x.astype(np.float64))
    with pytest.raises(MXNetError, match="rank mismatch"):
        fn.call(x[0])
    with pytest.raises(MXNetError, match="shape mismatch at axis 0"):
        fn.call(np.ones((3, 8), np.float32))
    with pytest.raises(MXNetError, match="expected 1 input"):
        fn.call(x, x)
    # the error names the manifest file, so it is actionable
    with pytest.raises(MXNetError, match="model.json"):
        fn.call(np.ones((5, 9), np.float32))
    # an artifact without a manifest stays loadable, unchecked
    bare = str(tmp_path / "bare.shlo")
    shutil.copyfile(path + ".shlo", bare)
    fn2 = deploy.load_stablehlo(bare, device="cpu")
    assert fn2.manifest is None
    np.testing.assert_allclose(fn2.call(x).numpy(), _ref(net, x),
                               rtol=1e-5, atol=1e-5)


def test_rejected_export_leaves_no_orphan_artifact(tmp_path):
    """A dynamic_batch export whose module collapses the batch axis must
    fail before anything is written."""
    class Collapse(nn.Module):
        def forward(self, x):
            return x.sum()

    path = str(tmp_path / "collapse")
    with pytest.raises(MXNetError, match="batch"):
        deploy.export_stablehlo(Collapse(), _x(3), path=path,
                                dynamic_batch=True)
    assert not os.listdir(tmp_path)


def test_dynamic_batch_export_serves_any_batch(dynamic_art):
    net, path = dynamic_art
    fn = deploy.load_stablehlo(path + ".shlo", device="cpu")
    assert fn.dynamic_batch
    assert fn.manifest["version"] == 3
    assert fn.manifest["inputs"] == [{"shape": [None, 8],
                                      "dtype": "float32"}]
    assert fn.manifest["outputs"][0]["shape"] == [None, 4]
    for n in (1, 3, 8):
        xs = _x(n, seed=n)
        np.testing.assert_allclose(fn.call(xs).numpy(), _ref(net, xs),
                                   rtol=1e-5, atol=1e-5)
    # the batch axis is free, every other dimension still validates
    with pytest.raises(MXNetError, match="axis 1"):
        fn.call(np.ones((4, 9), np.float32))


def test_bfloat16_artifact_validates_not_crashes(tmp_path):
    """bfloat16 flows through manifest validation: a mismatch raises
    MXNetError and the matching dtype (a bf16 tensor: numpy has no
    bfloat16) serves."""
    torch.manual_seed(11)
    net = nn.Linear(8, 4).to(torch.bfloat16)
    x = torch.rand(3, 8).to(torch.bfloat16)
    path = str(tmp_path / "bf16")
    deploy.export_stablehlo(net, x, path=path)
    fn = deploy.load_stablehlo(path + ".shlo", device="cpu")
    assert fn.manifest["inputs"][0]["dtype"] == "bfloat16"
    assert fn.manifest["outputs"][0]["dtype"] == "bfloat16"
    with pytest.raises(MXNetError, match="dtype mismatch"):
        fn.call(np.ones((3, 8), np.float32))
    with torch.no_grad():
        want = net(x).float()
    torch.testing.assert_close(fn.call(x).float(), want, rtol=0, atol=0)


def test_export_emits_program_text_and_restores_mode(static_art, tmp_path):
    net, x, path = static_art
    text = open(path + ".export.txt").read()
    assert "ExportedProgram" in text and "aten.linear" in text
    assert not os.path.exists(path + ".stablehlo.txt")
    assert json.load(open(path + ".json"))["block"] == "Sequential"
    live = _carry(_jax_net()).train()
    deploy.export_stablehlo(live, x, path=str(tmp_path / "t"))
    assert live.training            # the caller's mode is put back


@pytest.mark.parametrize("kw, item", [({"precompile": (1, 2)}, "item 2"),
                                      ({"quantize": "int4"},
                                       "'int8' or 'fp8'")])
def test_unported_export_options_refuse(tmp_path, kw, item):
    """``precompile=`` is not ported; ``quantize=`` takes int8 or fp8
    alone.  Both refuse before any file is written."""
    with pytest.raises(MXNetError, match=item):
        deploy.export_stablehlo(_carry(_jax_net()), _x(2),
                                path=str(tmp_path / "m"), **kw)
    assert not os.listdir(tmp_path)


def test_execute_fault_site_fires(static_art):
    _net, x, path = static_art
    fn = deploy.load_stablehlo(path + ".shlo", device="cpu")
    with faults.plan("deploy.execute=fail"):
        with pytest.raises(faults.InjectedFault):
            fn.call(x)
    assert fn.call(x).shape == (5, 4)


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("dynamic", [False, True])
def test_manifest_and_outputs_match_jax_export(tmp_path, dynamic):
    """The reference MLP exported by the JAX package and its carried twin
    exported by the port: the manifests agree on the signature, batch
    mode and versions; both loaded artifacts give the same outputs."""
    jnet = _jax_net()
    x = _x(5, seed=2)
    version = 3 if dynamic else None
    jpath = str(tmp_path / "jax")
    jdeploy.export_stablehlo(jnet, nd.array(x), path=jpath,
                             dynamic_batch=dynamic, version=version)
    tpath = str(tmp_path / "port")
    deploy.export_stablehlo(_carry(jnet), x, path=tpath,
                            dynamic_batch=dynamic, version=version)
    jm = json.load(open(jpath + ".json"))
    tm = json.load(open(tpath + ".json"))
    for key in ("inputs", "outputs", "dynamic_batch", "version",
                "manifest_version"):
        assert tm[key] == jm[key], key
    assert tm["format"] == "torch.export" != jm["format"]
    jfn = jdeploy.load_stablehlo(jpath + ".shlo")
    tfn = deploy.load_stablehlo(tpath + ".shlo", device="cpu")
    for n in ((1, 3, 8) if dynamic else (5,)):
        xs = _x(n, seed=10 + n)
        np.testing.assert_allclose(tfn.call(xs).numpy(),
                                   np.asarray(jfn.call(xs)),
                                   rtol=1e-5, atol=1e-5)


def test_jax_format_artifact_refused(tmp_path):
    """A JAX package artifact (format "jax.export/stablehlo") is refused
    by the port's loader and repository, not fed to torch.export."""
    jpath = str(tmp_path / "jax")
    jdeploy.export_stablehlo(_jax_net(), nd.array(_x(5)), path=jpath,
                             dynamic_batch=True)
    with pytest.raises(MXNetError, match="format"):
        deploy.load_stablehlo(jpath + ".shlo", device="cpu")
    with pytest.raises(MXNetError, match="format"):
        ModelRepository().load_artifact("net", jpath, device="cpu")


# -------------------------------------------- the repository's twins
class TestLoadArtifact:
    def test_load_artifact_auto_versions_default_exports(self, tmp_path):
        """Exports without a version (manifest version null) number
        themselves in the repository: two default exports do not
        collide."""
        net = _carry(_jax_net(32))
        a1 = _export(net, tmp_path, name="a1")
        a2 = _export(net, tmp_path, name="a2")
        repo = ModelRepository()
        repo.load_artifact("net", a1, device="cpu")
        repo.load_artifact("net", a2[:-len(".shlo")], device="cpu")
        assert repo.versions("net") == [1, 2]
        assert repo.current_version("net") == 2
        assert repo.get("net").kind == "stablehlo"

    def test_load_artifact_requires_manifest(self, tmp_path):
        art = _export(_carry(_jax_net(6)), tmp_path)
        (tmp_path / "m.json").unlink()
        with pytest.raises(MXNetError, match="no manifest"):
            ModelRepository().load_artifact("net", art, device="cpu")

    def test_static_artifact_pads_to_exported_batch(self, tmp_path):
        net = _carry(_jax_net(11))
        repo = ModelRepository()
        repo.load_artifact(
            "net", _export(net, tmp_path, dynamic_batch=False, batch=4),
            device="cpu")
        entry = repo.get("net")
        assert not entry.dynamic_batch and entry.fixed_batch == 4
        with ModelServer(repo, _cfg()) as srv:
            for n in (1, 2, 4):
                x = _x(n, seed=n)
                np.testing.assert_allclose(srv.predict("net", x, timeout=60),
                                           _ref(net, x), rtol=1e-5,
                                           atol=1e-5)
            with pytest.raises(MXNetError, match="outside"):
                srv.predict("net", np.ones((5, 8), np.float32))
        # one program: every dispatch pads to the exported batch of 4
        assert srv.stats()["programs"] == 1

    def test_disk_loaded_programs_counted_as_disk_hits(self, tmp_path):
        """A program marked ``_mx_from_disk_cache`` counts as a disk hit,
        not a miss: misses stay == built programs."""
        repo = ModelRepository()
        repo.load_artifact("m", _export(_carry(_jax_net(12)), tmp_path),
                           device="cpu")
        entry = repo.get("m")
        real = entry.make_program

        def disk_make_program(rows):
            prog = real(rows)
            prog._mx_from_disk_cache = True
            return prog
        entry.make_program = disk_make_program
        with ModelServer(repo, _cfg(max_batch_size=4)) as srv:
            out = srv.prewarm("m")
            assert out == {"model": "m", "version": 1,
                           "buckets": [1, 2, 4], "compiled": 0,
                           "disk_hits": 3}
            stats = srv.stats()
            assert stats["bucket_disk_hits"] == 3
            assert stats["bucket_misses"] == 0
            assert stats["programs"] == \
                stats["bucket_misses"] + stats["bucket_disk_hits"]
            assert rm.SERVING_BUCKET_CACHE.value(event="disk_hit") == 3
            assert rm.SERVING_BUCKET_CACHE.value(event="miss") == 0
            srv.predict("m", _x(1), timeout=60)
            assert rm.SERVING_BUCKET_CACHE.value(event="mem_hit") >= 1

    def test_corrupt_artifact_load_under_traffic(self, tmp_path):
        """A failing or corrupt artifact load is an error on the
        operator's path; live traffic on the current version keeps
        serving."""
        repo = ModelRepository()
        repo.add_function("m", lambda a: a + 1.0,
                          [{"shape": [None, 2], "dtype": "float32"}])
        with ModelServer(repo, _cfg(max_latency_us=1)) as srv:
            x = np.ones((2, 2), np.float32)
            np.testing.assert_array_equal(srv.predict("m", x, timeout=60),
                                          x + 1.0)
            with faults.plan("repository.load_artifact=fail"):
                with pytest.raises(faults.InjectedFault):
                    srv.repository.load_artifact(
                        "m2", str(tmp_path / "nope.shlo"), device="cpu")
            bad = tmp_path / "rotten.shlo"
            bad.write_bytes(b"\x00garbage\xff" * 16)
            (tmp_path / "rotten.json").write_text("{not json")
            with pytest.raises(Exception):
                srv.repository.load_artifact("m3", str(bad), device="cpu")
            (tmp_path / "rotten.json").unlink()
            with pytest.raises(Exception):
                srv.repository.load_artifact("m4", str(bad), device="cpu")
            np.testing.assert_array_equal(srv.predict("m", x, timeout=60),
                                          x + 1.0)
            assert srv.repository.models() == ["m"]

    def test_decode_metadata_lands_on_the_entry(self, tmp_path):
        meta = {"vocab_size": 64, "num_layers": 2, "num_heads": 4,
                "head_dim": 16, "max_context": 128, "eos_id": 3}
        path = deploy.export_stablehlo(_carry(_jax_net(13)), _x(2),
                                       path=str(tmp_path / "m"),
                                       dynamic_batch=True, decode=meta)
        entry = ModelRepository().load_artifact("m", path, device="cpu")
        assert entry.decode_meta == meta
        bad = dict(meta, vocab_size=0)
        with pytest.raises(MXNetError, match="vocab_size"):
            deploy.export_stablehlo(_carry(_jax_net(13)), _x(2),
                                    path=str(tmp_path / "bad"),
                                    dynamic_batch=True, decode=bad)
        assert not os.path.exists(str(tmp_path / "bad.shlo"))

    def test_quantized_manifest_refused(self, tmp_path, monkeypatch):
        """A v4 manifest's admission: with its scale digest it is served
        and its block lands on the entry; without the digest, or with a
        calibration error above ``MXNET_SERVING_QUANT_MAX_REL_ERR``, it
        is refused."""
        path = _export(_carry(_jax_net(14)), tmp_path)
        mpath = str(tmp_path / "m.json")
        manifest = json.load(open(mpath))
        qb = {"mode": "int8", "weights": [
            {"name": "0.weight", "scale": 0.01, "dtype": "int8",
             "elems": 128}],
            "calibration": {"examples": 5, "max_abs_err": 0.01,
                            "max_rel_err": 0.02}}
        qb["digest"] = deploy._quantization_digest(qb)
        manifest.update(manifest_version=4, quantization=qb)
        json.dump(manifest, open(mpath, "w"))
        assert deploy.load_stablehlo(path, device="cpu").quantization == qb
        repo = ModelRepository()
        assert repo.load_artifact("m", path, device="cpu").quantization == qb
        monkeypatch.setenv("MXNET_SERVING_QUANT_MAX_REL_ERR", "0.01")
        with pytest.raises(MXNetError, match="exceeds the admission bound"):
            repo.load_artifact("m", path, device="cpu")
        monkeypatch.delenv("MXNET_SERVING_QUANT_MAX_REL_ERR")
        del manifest["quantization"]["digest"]
        json.dump(manifest, open(mpath, "w"))
        with pytest.raises(MXNetError, match="no scale digest"):
            repo.load_artifact("m", path, device="cpu")
        assert repo.versions("m") == [1]

    def test_hot_swap_between_artifacts(self, tmp_path):
        """export -> load_artifact(activate=False) -> prewarm -> swap:
        the documented deploy loop, each version serving its own
        weights."""
        n1, n2 = _carry(_jax_net(21)), _carry(_jax_net(22))
        repo = ModelRepository()
        repo.load_artifact("net", _export(n1, tmp_path, name="v1"),
                           device="cpu")
        x = _x(3, seed=5)
        with ModelServer(repo, _cfg()) as srv:
            np.testing.assert_allclose(srv.predict("net", x, timeout=60),
                                       _ref(n1, x), rtol=1e-5, atol=1e-5)
            repo.load_artifact("net", _export(n2, tmp_path, name="v2"),
                               activate=False, device="cpu")
            warm = srv.prewarm("net", version=2)
            assert warm["compiled"] == len(serving.bucket_set(8))
            assert repo.swap("net", 2) == 1
            np.testing.assert_allclose(srv.predict("net", x, timeout=60),
                                       _ref(n2, x), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ flash BERT artifacts
BERT_KW = dict(vocab_size=64, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0)
L = 32


@pytest.fixture(scope="module")
def bert_art(tmp_path_factory):
    """The JAX flash ``BERTClassifier`` (2 layers, 64 units), its port
    twin with the same weights, and the twin exported with
    ``dynamic_batch=True`` from batch-1 examples: (jclf, tclf, path)."""
    from mxnet_tpu import models as jm
    from mxnet_tpu.models.bert import BERTClassifier as JaxClassifier
    from mxnet_tpu_torch.models import torch_bert as tm

    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=True, **BERT_KW)
    jbert.initialize()
    jclf = JaxClassifier(jbert, num_classes=2, dropout=0.0)
    jclf.initialize()
    pre = jclf.prefix
    np_params = {(k[len(pre):] if k.startswith(pre) else k):
                 v.data().asnumpy()
                 for k, v in jclf.collect_params().items()}
    tbert = tm.get_bert_model("bert_12_768_12", use_flash=True,
                              device="cpu", **BERT_KW)
    tclf = tm.BERTClassifier(tbert, dropout=0.0).load_numpy_params(
        np_params).eval()
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    path = deploy.export_stablehlo(
        tclf, *example, path=str(tmp_path_factory.mktemp("bert") / "bert"),
        dynamic_batch=True, emit_text=True)
    return jclf, tclf, path


def _requests(n=12, seed=0):
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        rows = int(rs.choice([1, 2, 3, 5]))
        reqs.append((rs.randint(0, 64, (rows, L)).astype(np.int32),
                     rs.randint(0, 2, (rows, L)).astype(np.int32),
                     rs.randint(1, L + 1, rows).astype(np.int32)))
    return reqs


def test_exported_bert_holds_one_flash_node_per_layer(bert_art):
    """B1 is one ``mxnet_tpu_torch::flash_attention_fwd`` node per layer
    of the exported graph (the loaded one too), and the plain version's
    dense products are not in it."""
    _j, tclf, path = bert_art
    fn = deploy.load_stablehlo(path, device="cpu")
    targets = [str(n.target) for n in fn.exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(FLASH_OP + ".default") == BERT_KW["num_layers"]
    assert not any("einsum" in t or "bmm" in t for t in targets)
    assert FLASH_OP in open(path[:-len(".shlo")] + ".export.txt").read()
    assert fn.manifest["block"] == "BERTClassifier"
    assert fn.manifest["inputs"] == [
        {"shape": [None, L], "dtype": "int32"},
        {"shape": [None, L], "dtype": "int32"},
        {"shape": [None], "dtype": "int32"}]
    assert fn.manifest["outputs"] == [{"shape": [None, 2],
                                       "dtype": "float32"}]


def test_batch1_example_dynamic_export_serves_any_batch(bert_art):
    """The artifact was traced from batch-1 examples (repeated to 2, as
    torch.export specialises a size-1 dimension) and serves batches 1, 3
    and 8 as the exporting module's eager forward does."""
    _j, tclf, path = bert_art
    fn = deploy.load_stablehlo(path, device="cpu")
    rs = np.random.RandomState(3)
    for n in (1, 3, 8):
        req = (rs.randint(0, 64, (n, L)).astype(np.int32),
               rs.randint(0, 2, (n, L)).astype(np.int32),
               rs.randint(0, L + 1, n).astype(np.int32))
        np.testing.assert_allclose(fn.call(*req).numpy(), _ref(tclf, *req),
                                   rtol=0, atol=ATOL)


def test_flash_operator_matches_wrapper_and_fake_shapes():
    """The registered operator is the B1 wrapper (on the CPU its plain
    version, bit for bit, with no launch counted); its fake gives O like
    q and LSE (BH, Lq, 1) fp32."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, 40, 16, generator=g) for _ in range(3))
    lens = torch.tensor([40, 0, 1, 17, 33, 40], dtype=torch.int32)
    before = fa.flash_attention_fwd.launches
    out, lse = torch.ops.mxnet_tpu_torch.flash_attention_fwd(
        q, k, v, lens, False, 0.25, -1)
    want = fa.flash_attention_fwd_reference(q, k, v, lens, False, 0.25, -1)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert fa.flash_attention_fwd.launches == before
    mode = FakeTensorMode()
    fq = mode.from_tensor(q.to(torch.bfloat16))
    flens = mode.from_tensor(lens)
    with mode:
        fo, fl = torch.ops.mxnet_tpu_torch.flash_attention_fwd(
            fq, fq, fq, flens, True, 0.25, 8)
    assert fo.shape == q.shape and fo.dtype == torch.bfloat16
    assert fl.shape == (6, 40, 1) and fl.dtype == torch.float32


_RUNNER = textwrap.dedent("""
    import sys
    allowed = sys.argv[1].split(",") if sys.argv[1] else []

    class _Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root == "mxnet_tpu" or (
                    root == "mxnet_tpu_torch"
                    and not any(name == a or name.startswith(a + ".")
                                for a in allowed)):
                raise ImportError("framework import attempted at "
                                  "serving time: " + name)
            return None

    sys.meta_path.insert(0, _Block())
    import numpy as np
    import torch
    if allowed:
        import mxnet_tpu_torch.ops  # registers B1's operator
    ep = torch.export.load(sys.argv[2])
    xs = [torch.from_numpy(np.load(p)) for p in sys.argv[4:]]
    with torch.no_grad():
        out = ep.module()(*xs)
    np.save(sys.argv[3], out.numpy())
    print("served", tuple(out.shape),
          sorted(m for m in sys.modules if m.startswith("mxnet_tpu")))
""")


@pytest.mark.parametrize("which", ["mlp", "bert"])
def test_artifact_runs_without_framework(static_art, bert_art, tmp_path,
                                         which):
    """A fresh process loads the artifact with ``torch.export.load`` and
    runs it, with a meta-importer that refuses the JAX package and every
    module of the port: all of them for the MLP, all but
    ``mxnet_tpu_torch.ops`` (and the package root and ``base`` it
    imports) for the flash BERT, whose B1 node needs the operator."""
    if which == "mlp":
        net, x, path = static_art
        artifact, inputs, allowed = path + ".shlo", (x,), ""
    else:
        _j, net, artifact = bert_art
        inputs = _requests(1, seed=4)[0]
        allowed = "mxnet_tpu_torch,mxnet_tpu_torch.base,mxnet_tpu_torch.ops"
    ref = _ref(net, *inputs)
    files = []
    for i, a in enumerate(inputs):
        files.append(str(tmp_path / f"x{i}.npy"))
        np.save(files[-1], a)
    out_path = str(tmp_path / "out.npy")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if allowed:
        env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, allowed, artifact, out_path,
         *files],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "serving" not in proc.stdout and "deploy" not in proc.stdout
    np.testing.assert_allclose(np.load(out_path), ref, rtol=1e-5,
                               atol=1e-5)


def test_artifact_needs_the_registered_operator(bert_art, tmp_path):
    """Without ``mxnet_tpu_torch.ops`` the BERT artifact does not load:
    its graph names B1's operator, which only that import registers."""
    _j, _t, artifact = bert_art
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.export.load(sys.argv[1])", artifact],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "flash_attention_fwd" in proc.stderr


def _serve(srv, model, reqs):
    out = [None] * len(reqs)

    def one(i):
        out[i] = srv.predict(model, *reqs[i], timeout=300)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in out)
    return out


def test_bert_artifact_predict_matches_jax_model_server(bert_art):
    """The slice as a whole: the flash ``BERTClassifier`` with the JAX
    weights, exported, loaded with ``load_artifact`` and served by the
    port's ``ModelServer.predict`` from threads, against the JAX
    package's ``ModelServer`` serving the JAX classifier on the same
    requests."""
    from mxnet_tpu import serving as jserving
    jclf, _t, path = bert_art
    reqs = _requests()
    cfg = dict(max_batch_size=8, max_latency_us=20_000, num_workers=2)
    repo = ModelRepository()
    entry = repo.load_artifact("bert", path, device="cpu")
    assert entry.kind == "stablehlo" and entry.dynamic_batch
    with ModelServer(repo, ServingConfig(**cfg)) as srv:
        warm = srv.prewarm("bert")
        got = _serve(srv, "bert", reqs)
        stats = srv.stats()
    assert warm["compiled"] == len(serving.bucket_set(8))
    jrepo = jserving.ModelRepository()
    example = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
               np.full((1,), L, np.int32))
    jrepo.add_block("bert", jclf, *(nd.array(a, dtype="int32")
                                    for a in example))
    with jserving.ModelServer(jrepo, jserving.ServingConfig(**cfg)) as jsrv:
        want = _serve(jsrv, "bert", reqs)
    for req, g, w in zip(reqs, got, want):
        assert g.shape == (req[0].shape[0], 2)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    assert stats["completed"] == len(reqs)
    assert stats["bucket_misses"] == len(serving.bucket_set(8))
