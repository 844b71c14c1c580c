"""PyTorch port, quantized artifacts: ``deploy.export_stablehlo(quantize=
'int8'|'fp8')`` (manifest v4), ``load_stablehlo`` and
``ModelRepository.load_artifact``'s admission of them.

Twins of the JAX package's v4 tests (tests/test_export_stablehlo.py,
"Quantized artifacts") on the reference's MLP (Dense 16 + ReLU,
BatchNorm, Dense 4) carried into ``nn.Linear`` / ``nn.BatchNorm1d``;
what the exported program holds (the int8 / fp8 payloads and their
scales under the weights' state-dict names, no float copy of a quantized
weight, each dequantization next to its consumer); and, against the JAX
package on the same weights: both packages' int8 exports of the MLP and
of a small flash ``BERTClassifier`` (2 layers, 64 units, 4 heads,
L = 32) agree on every scale and bit for bit on every payload, name by
name through the name map of ``gluon_names()``, and the BERT served by
the port's ``ModelServer.predict`` over ``load_artifact`` matches the
JAX package's quantized artifact served by its ``ModelServer`` within
atol 1e-5 (the tolerance of tests/test_torch_deploy_artifact.py: the
dequantized weights are bitwise equal, the frameworks sum in different
orders).

Everything runs on the CPU (``device="cpu"``), where B1's operator takes
the kernel's plain version; ``chip_smoke.py``'s ``artifact_quant`` phase
runs BERT-large on the card.
"""
import json
import os
import re
import shutil
import threading

import numpy as np
import pytest
import torch
from torch import nn

import mxnet_tpu as mx
from mxnet_tpu import deploy as jdeploy
from mxnet_tpu import nd
from mxnet_tpu import quantize as jqz
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import deploy, serving
from mxnet_tpu_torch import quantize as qz
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (ModelRepository, ModelServer,
                                     ServingConfig)

ATOL = 1e-5
# the MLP's port state-dict names -> the JAX net's parameter names
MLP_NAMES = {"0.weight": "shlo_net_dense0_weight",
             "3.weight": "shlo_net_dense1_weight"}


# ------------------------------------------------ the reference's MLP
def _jax_net(seed=7):
    """tests/test_export_stablehlo.py's net, BatchNorm's running
    statistics set away from 0 / 1."""
    mx.random.seed(seed)
    net = jnn.HybridSequential(prefix="shlo_net_")
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu", in_units=8))
        net.add(jnn.BatchNorm(in_channels=16))
        net.add(jnn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier())
    rs = np.random.RandomState(seed)
    params = net.collect_params()
    params["shlo_net_batchnorm0_running_mean"].set_data(
        nd.array(rs.randn(16).astype(np.float32) * 0.1))
    params["shlo_net_batchnorm0_running_var"].set_data(
        nd.array(rs.uniform(0.5, 1.5, 16).astype(np.float32)))
    net.hybridize()
    return net


def _carry(jnet):
    """The port's twin of ``_jax_net``: ``nn.Linear`` + ReLU,
    ``nn.BatchNorm1d`` (eval), ``nn.Linear`` with the JAX weights."""
    p = {k[len("shlo_net_"):]: v.data().asnumpy().copy()
         for k, v in jnet.collect_params().items()}
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                        nn.BatchNorm1d(16, eps=jnet[1]._eps),
                        nn.Linear(16, 4))
    with torch.no_grad():
        for lin, pre in ((net[0], "dense0_"), (net[3], "dense1_")):
            lin.weight.copy_(torch.from_numpy(p[pre + "weight"]))
            lin.bias.copy_(torch.from_numpy(p[pre + "bias"]))
        bn = net[2]
        bn.weight.copy_(torch.from_numpy(p["batchnorm0_gamma"]))
        bn.bias.copy_(torch.from_numpy(p["batchnorm0_beta"]))
        bn.running_mean.copy_(torch.from_numpy(p["batchnorm0_running_mean"]))
        bn.running_var.copy_(torch.from_numpy(p["batchnorm0_running_var"]))
    return net.eval()


def _ref(net, *xs):
    with torch.no_grad():
        return net(*(torch.from_numpy(x) for x in xs)).numpy()


def _x(rows, seed=0, cols=8):
    return np.random.RandomState(seed).uniform(
        size=(rows, cols)).astype(np.float32)


@pytest.fixture(scope="module")
def quant_art(tmp_path_factory):
    """One int8 dynamic-batch export: (net, x, path-prefix)."""
    net = _carry(_jax_net())
    x = _x(4, seed=1)
    path = str(tmp_path_factory.mktemp("quant") / "net_int8")
    deploy.export_stablehlo(net, x, path=path, dynamic_batch=True,
                            version=1, quantize="int8")
    return net, x, path


# -------------------------------------------- test_export_stablehlo's twins
def test_quantized_export_manifest_v4(quant_art):
    _net, _x4, path = quant_art
    manifest = json.load(open(path + ".json"))
    assert manifest["manifest_version"] == 4
    qb = manifest["quantization"]
    assert qb["mode"] == "int8"
    # only >=2d float tensors quantize (the Linear weights; BatchNorm
    # vectors, running statistics and biases stay f32)
    names = {w["name"] for w in qb["weights"]}
    assert names == set(MLP_NAMES)
    for w in qb["weights"]:
        assert w["dtype"] == "int8" and w["scale"] > 0 and w["elems"] > 0
    calib = qb["calibration"]
    assert calib["examples"] == 4
    assert 0 <= calib["max_rel_err"] < 0.1
    assert isinstance(qb["digest"], str) and len(qb["digest"]) == 64
    assert qb["digest"] == deploy._quantization_digest(qb)
    assert manifest["inputs"][0]["dtype"] == "float32"
    # both packages' validators accept the manifest
    deploy.validate_manifest(manifest)
    jdeploy.validate_manifest(manifest)


def test_quantized_artifact_roundtrip_within_calibration(quant_art):
    net, x, path = quant_art
    model = deploy.load_stablehlo(path + ".shlo", device="cpu")
    calib = model.quantization["calibration"]
    ref = _ref(net, x)
    got = model.call(x).numpy()
    assert np.abs(got - ref).max() <= calib["max_abs_err"] + 1e-6
    # and a batch size the calibration never saw
    x2 = _x(7, seed=2)
    got2 = model.call(x2).numpy()
    assert np.abs(got2 - _ref(net, x2)).max() \
        < 10 * calib["max_abs_err"] + 1e-3


def test_quantized_artifact_smaller_than_f32(tmp_path):
    # weights big enough that the archive's own bytes (program, code,
    # metadata: ~0.2 MB) do not drown the 4x shrink of the weights
    torch.manual_seed(9)
    net = nn.Sequential(nn.Linear(512, 2048), nn.ReLU(),
                        nn.Linear(2048, 64)).eval()
    x = np.random.RandomState(0).uniform(size=(2, 512)).astype(np.float32)
    f32 = deploy.export_stablehlo(net, x, path=str(tmp_path / "f32"))
    i8 = deploy.export_stablehlo(net, x, path=str(tmp_path / "i8"),
                                 quantize="int8")
    assert os.path.getsize(f32) > 3 * os.path.getsize(i8)


def test_tampered_scale_rejected_at_load(quant_art, tmp_path):
    _net, _x4, path = quant_art
    prefix = str(tmp_path / "tampered")
    shutil.copyfile(path + ".shlo", prefix + ".shlo")
    manifest = json.load(open(path + ".json"))
    manifest["quantization"]["weights"][0]["scale"] *= 2.0
    json.dump(manifest, open(prefix + ".json", "w"))
    with pytest.raises(MXNetError, match="digest mismatch"):
        deploy.load_stablehlo(prefix + ".shlo", device="cpu")
    with pytest.raises(MXNetError, match="digest mismatch"):
        ModelRepository().load_artifact("m", prefix, device="cpu")


def test_corrupt_scale_values_rejected(quant_art):
    _net, _x4, path = quant_art
    manifest = json.load(open(path + ".json"))
    for bad in (-1.0, 0.0, float("nan"), "x"):
        m = json.loads(json.dumps(manifest))
        m["quantization"]["weights"][0]["scale"] = bad
        with pytest.raises(MXNetError):
            deploy.validate_manifest(m)
    m = json.loads(json.dumps(manifest))
    m["manifest_version"] = 3
    with pytest.raises(MXNetError, match="manifest_version >= 4"):
        deploy.validate_manifest(m)
    # a present digest key verifies whatever its value is
    m = json.loads(json.dumps(manifest))
    m["quantization"]["digest"] = None
    with pytest.raises(MXNetError, match="digest mismatch"):
        deploy.validate_manifest(m)
    m = json.loads(json.dumps(manifest))
    m["quantization"]["weights"][0]["dtype"] = "float8_e4m3fn"
    with pytest.raises(MXNetError, match="disagrees with mode"):
        deploy.validate_manifest(m)


def test_quantized_serving_admission_knobs(quant_art, tmp_path,
                                           monkeypatch):
    _net, _x4, path = quant_art
    # stripped digest: structurally valid, refused at serving admission
    prefix = str(tmp_path / "nodigest")
    shutil.copyfile(path + ".shlo", prefix + ".shlo")
    manifest = json.load(open(path + ".json"))
    del manifest["quantization"]["digest"]
    json.dump(manifest, open(prefix + ".json", "w"))
    repo = ModelRepository()
    with pytest.raises(MXNetError, match="no scale digest"):
        repo.load_artifact("m", prefix + ".shlo", device="cpu")
    monkeypatch.setenv("MXNET_SERVING_QUANT_REQUIRE_DIGEST", "0")
    repo.load_artifact("m", prefix + ".shlo", device="cpu")
    # calibration-error admission bound
    monkeypatch.delenv("MXNET_SERVING_QUANT_REQUIRE_DIGEST")
    monkeypatch.setenv("MXNET_SERVING_QUANT_MAX_REL_ERR", "1e-9")
    with pytest.raises(MXNetError, match="exceeds the admission bound"):
        repo.load_artifact("m2", path + ".shlo", device="cpu")
    monkeypatch.setenv("MXNET_SERVING_QUANT_MAX_REL_ERR", "0.5")
    entry = repo.load_artifact("m2", path + ".shlo", device="cpu")
    assert entry.quantization["mode"] == "int8"
    assert repo.models() == ["m", "m2"]


def test_quantized_and_f32_versions_coexist_in_serving(quant_art,
                                                       tmp_path):
    """f32 and int8 artifacts of one model serve side by side through
    the same bucket machinery, each within the per-version program bound,
    swap switching between them."""
    net, x, path = quant_art
    f32 = str(tmp_path / "f32v")
    deploy.export_stablehlo(net, x, path=f32, dynamic_batch=True, version=1)
    repo = ModelRepository()
    repo.load_artifact("net", f32 + ".shlo", device="cpu")        # v1 f32
    repo.load_artifact("net", path + ".shlo", version=2, activate=False,
                       device="cpu")                               # v2 int8
    cfg = ServingConfig(max_batch_size=4, max_latency_us=0)
    with ModelServer(repo, cfg) as srv:
        ref = _ref(net, x)
        np.testing.assert_allclose(srv.predict("net", x, timeout=120), ref,
                                   rtol=1e-5, atol=1e-5)
        assert repo.get("net").quantization is None
        repo.swap("net", 2)
        q_out = srv.predict("net", x, timeout=120)
        calib = repo.get("net").quantization["calibration"]
        assert np.abs(q_out - ref).max() <= calib["max_abs_err"] + 1e-6
        batcher = srv.batcher
        assert batcher.programs(repo._resolve("net", 1)) >= 1
        assert 1 <= batcher.programs(repo._resolve("net", 2)) \
            <= len(serving.bucket_set(cfg.max_batch_size))


def test_fp8_export_roundtrip(tmp_path):
    net = _carry(_jax_net())
    x = _x(3, seed=3)
    path = str(tmp_path / "net_fp8")
    deploy.export_stablehlo(net, x, path=path, dynamic_batch=True,
                            quantize="fp8")
    model = deploy.load_stablehlo(path + ".shlo", device="cpu")
    qb = model.quantization
    assert qb["mode"] == "fp8"
    assert all(w["dtype"] == "float8_e4m3fn" for w in qb["weights"])
    assert model.exported.state_dict["0.weight"].dtype == torch.float8_e4m3fn
    got = model.call(x).numpy()
    assert np.abs(got - _ref(net, x)).max() \
        <= qb["calibration"]["max_abs_err"] + 1e-6


def test_quantize_arg_validated(tmp_path):
    """A mode other than int8 / fp8, or a module with no >=2d floating
    parameter, is refused before any file is written."""
    with pytest.raises(MXNetError, match="'int8' or 'fp8'"):
        deploy.export_stablehlo(_carry(_jax_net()), _x(3),
                                path=str(tmp_path / "bad"), quantize="int4")
    with pytest.raises(MXNetError, match="no >=2d float weight"):
        deploy.export_stablehlo(nn.BatchNorm1d(8).eval(), _x(3),
                                path=str(tmp_path / "bn"), quantize="int8")
    assert not os.listdir(tmp_path)


# ---------------------------------------------- what the program holds
def test_quantized_program_holds_payloads_not_float_weights(quant_art):
    """The archive's program keeps each quantized weight as its payload
    (under the weight's state-dict name) and a float32 scale beside it,
    and no float copy of it; each payload's one reader is the
    dequantizing multiply, whose one reader is the weight's consumer."""
    net, _x4, path = quant_art
    model = deploy.load_stablehlo(path + ".shlo", device="cpu")
    ep = model.exported
    sd = ep.state_dict
    scales = {w["name"]: w["scale"] for w in model.quantization["weights"]}
    for name, scale in scales.items():
        assert sd[name].dtype == torch.int8
        assert sd[name].shape == net.get_parameter(name).shape
        s = sd[name + deploy._SCALE_SUFFIX]
        assert s.dtype == torch.float32 and s.numel() == 1
        assert float(s) == np.float32(scale)
    floats = {k for k, v in sd.items() if v.is_floating_point()}
    assert not floats & set(scales)
    assert [k for k in floats if sd[k].dim() >= 2
            and not k.endswith(deploy._SCALE_SUFFIX)] == []
    # the net the caller passed still holds its float parameters
    assert net[0].weight.dtype == torch.float32
    assert isinstance(net[0].weight, nn.Parameter)
    inputs = ep.graph_signature.inputs_to_buffers
    for node in ep.graph.nodes:
        if node.op == "placeholder" and inputs.get(node.name) in scales:
            (mul,) = node.users
            assert mul.target == torch.ops.aten.mul.Tensor
            (consumer,) = mul.users
            assert consumer.target == torch.ops.aten.linear.default


def test_bf16_weights_dequantize_back_to_bf16(tmp_path):
    """A bf16 weight is stored int8 and read back as bf16: the float32
    widen-multiply, then one cast (``quantize.dequantize_tensor``)."""
    torch.manual_seed(11)
    net = nn.Linear(8, 4).to(torch.bfloat16).eval()
    x = torch.rand(3, 8).to(torch.bfloat16)
    path = deploy.export_stablehlo(net, x, path=str(tmp_path / "bf16"),
                                   quantize="int8")
    model = deploy.load_stablehlo(path, device="cpu")
    (w,) = model.quantization["weights"]
    q = model.exported.state_dict["weight"]
    deq = qz.dequantize_tensor(q, w["scale"], torch.bfloat16)
    assert deq.dtype == torch.bfloat16
    with torch.no_grad():
        want = torch.nn.functional.linear(x, deq, net.bias)
    torch.testing.assert_close(model.call(x), want, rtol=0, atol=0)


def test_cpu_payloads_equal_quantize_tensor(quant_art):
    """The payloads are ``quantize.quantize_tensor`` of the weights at
    ``tensor_scale``: bit for bit, and dequantized within half a step."""
    net, _x4, path = quant_art
    model = deploy.load_stablehlo(path + ".shlo", device="cpu")
    spec = qz.CompressionSpec("int8")
    for w in model.quantization["weights"]:
        p = net.get_parameter(w["name"]).detach()
        assert w["scale"] == qz.tensor_scale(p, spec)
        assert w["elems"] == p.numel()
        q = model.exported.state_dict[w["name"]]
        assert torch.equal(q, qz.quantize_tensor(p, w["scale"], spec))
        back = qz.dequantize_tensor(q, w["scale"], torch.float32)
        assert (back - p).abs().max() <= 0.51 * w["scale"]


# ------------------------------------------------ against the JAX package
def _jax_payloads(jparams, manifest, kind):
    """The JAX export's payloads, recomputed by the reference's own
    ``quantize_tensor`` from its parameters at the manifest's scales."""
    spec = jqz.CompressionSpec(kind)
    return {w["name"]: np.asarray(jqz.quantize_tensor(
        jparams[w["name"]], w["scale"], spec)).view(np.uint8)
        for w in manifest["quantization"]["weights"]}


def _compare_with_jax(tpath, jpath, jparams, names, kind):
    tm = json.load(open(tpath + ".json"))
    jm = json.load(open(jpath + ".json"))
    assert tm["manifest_version"] == jm["manifest_version"] == 4
    tq, jq = tm["quantization"], jm["quantization"]
    assert tq["mode"] == jq["mode"] == kind
    assert tq["calibration"]["examples"] == jq["calibration"]["examples"]
    tw = {w["name"]: w for w in tq["weights"]}
    jw = {w["name"]: w for w in jq["weights"]}
    assert len(tw) == len(jw) == len(names)
    assert {names[n] for n in tw} == set(jw)
    payloads = _jax_payloads(jparams, jm, kind)
    state = deploy.load_stablehlo(tpath + ".shlo",
                                  device="cpu").exported.state_dict
    for tname, jname in names.items():
        assert tw[tname]["scale"] == jw[jname]["scale"], tname
        assert (tw[tname]["dtype"], tw[tname]["elems"]) \
            == (jw[jname]["dtype"], jw[jname]["elems"]), tname
        got = state[tname].contiguous().view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, payloads[jname], err_msg=tname)
    # each package's validator accepts the other's manifest
    deploy.validate_manifest(jm)
    jdeploy.validate_manifest(tm)
    return tq, jq


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_mlp_scales_and_payloads_match_jax_export(tmp_path, kind):
    """The reference MLP exported quantized by the JAX package and its
    carried twin by the port: every scale equal, every payload bit for
    bit (name map ``MLP_NAMES``), and the loaded artifacts' outputs
    within 1e-5."""
    jnet = _jax_net()
    x = _x(5, seed=2)
    jpath = str(tmp_path / "jax")
    jdeploy.export_stablehlo(jnet, nd.array(x), path=jpath,
                             dynamic_batch=True, quantize=kind)
    tpath = str(tmp_path / "port")
    deploy.export_stablehlo(_carry(jnet), x, path=tpath,
                            dynamic_batch=True, quantize=kind)
    jparams = {k: v.data().asnumpy() for k, v in
               jnet.collect_params().items()}
    tq, jq = _compare_with_jax(tpath, jpath, jparams, MLP_NAMES, kind)
    np.testing.assert_allclose(tq["calibration"]["max_abs_err"],
                               jq["calibration"]["max_abs_err"],
                               rtol=0, atol=ATOL)
    jfn = jdeploy.load_stablehlo(jpath + ".shlo")
    tfn = deploy.load_stablehlo(tpath + ".shlo", device="cpu")
    for n in (1, 3, 8):
        xs = _x(n, seed=10 + n)
        np.testing.assert_allclose(tfn.call(xs).numpy(),
                                   np.asarray(jfn.call(xs)),
                                   rtol=0, atol=ATOL)


BERT_KW = dict(vocab_size=64, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0)
L = 32


def _jax_name_map(jclf):
    """The JAX classifier's parameters keyed as the port's
    ``gluon_names()`` keys them -> their real JAX names.  The classifier's
    own prefix is removed, and the BERT model's ``bertmodel<N>_`` (N
    counts the BERT models the process built before this one) reads
    ``bertmodel0_``, as ``load_numpy_params`` and the trainer tests
    normalise it; the values map back to the real names, under which the
    JAX artifact stores its tensors."""
    pre = jclf.prefix
    return {re.sub(r"^bertmodel\d+_", "bertmodel0_",
                   k[len(pre):] if k.startswith(pre) else k): k
            for k in jclf.collect_params()}


def _bert_twins():
    """The JAX flash ``BERTClassifier`` (seed 0), its port twin carried by
    ``load_numpy_params``, and the name map: a port parameter's
    state-dict name (each >= 2-d one, the quantized set) -> the real name
    of the JAX parameter whose values it holds."""
    from mxnet_tpu import models as jm
    from mxnet_tpu.models.bert import BERTClassifier as JaxClassifier
    from mxnet_tpu_torch.models import torch_bert as tm

    mx.random.seed(0)
    jbert = jm.get_bert_model("bert_12_768_12", use_flash=True, **BERT_KW)
    jbert.initialize()
    jclf = JaxClassifier(jbert, num_classes=2, dropout=0.0)
    jclf.initialize()
    jnames = _jax_name_map(jclf)
    np_params = {short: jclf.collect_params()[k].data().asnumpy()
                 for short, k in jnames.items()}
    tbert = tm.get_bert_model("bert_12_768_12", use_flash=True,
                              device="cpu", **BERT_KW)
    tclf = tm.BERTClassifier(tbert, dropout=0.0).load_numpy_params(
        np_params).eval()
    by_id = {id(t): jnames[g] for g, t in tclf.gluon_names().items()}
    names = {n: by_id[id(p)] for n, p in tclf.named_parameters()
             if p.dim() >= 2}
    return jclf, tclf, names


def test_bert_name_map_survives_an_earlier_jax_bert():
    """The name map does not depend on how many BERT models the process
    built before: with one extra JAX BERT model built first (its gluon
    counter moves, so the classifier's parameters are named
    ``bertmodel<N>_...`` with N >= 1) it still covers all 13 quantized
    tensors, each mapped to a real JAX parameter holding its values."""
    from mxnet_tpu import models as jm
    jm.get_bert_model("bert_12_768_12", use_flash=True, **BERT_KW)
    jclf, tclf, names = _bert_twins()
    assert len(names) == 3 + 4 * BERT_KW["num_layers"] + 2
    jparams = jclf.collect_params()
    assert any(not k.startswith("bertmodel0_") for k in jparams), \
        "the gluon counter did not move"
    tparams = dict(tclf.named_parameters())
    for tname, jname in names.items():
        got = tparams[tname].detach().numpy()
        want = jparams[jname].data().asnumpy()
        np.testing.assert_array_equal(got, want, err_msg=tname)


@pytest.fixture(scope="module")
def bert_quant(tmp_path_factory):
    """The JAX flash ``BERTClassifier`` (2 layers, 64 units) and its port
    twin with the same weights, both exported int8 on the same
    calibration batch (the port's with ``dynamic_batch=True``): (jclf,
    tclf, port path prefix, JAX path prefix, name map port -> JAX)."""
    jclf, tclf, names = _bert_twins()
    calib = _requests(1, seed=7, rows=8)[0]
    root = tmp_path_factory.mktemp("bert_quant")
    tpath, jpath = str(root / "port"), str(root / "jax")
    deploy.export_stablehlo(tclf, *calib, path=tpath, dynamic_batch=True,
                            quantize="int8")
    # the JAX package's flash kernel takes no symbolic batch (Pallas
    # blocks are static), so its artifact is static at the calibration
    # batch of 8 rows and its server pads every batch to 8
    jdeploy.export_stablehlo(jclf, *(nd.array(a, dtype="int32")
                                     for a in calib),
                             path=jpath, quantize="int8")
    return jclf, tclf, tpath, jpath, names


def _requests(n=12, seed=0, rows=None):
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        r = rows or int(rs.choice([1, 2, 3, 5]))
        reqs.append((rs.randint(0, 64, (r, L)).astype(np.int32),
                     rs.randint(0, 2, (r, L)).astype(np.int32),
                     rs.randint(1, L + 1, r).astype(np.int32)))
    return reqs


def test_bert_scales_and_payloads_match_jax_export(bert_quant):
    """All 13 quantized tensors of the 2-layer classifier (word, token
    type and position embeddings, 4 projections a layer, pooler,
    classifier): scales equal, payloads bit for bit."""
    jclf, _t, tpath, jpath, names = bert_quant
    assert len(names) == 3 + 4 * BERT_KW["num_layers"] + 2
    jparams = {k: v.data().asnumpy() for k, v in
               jclf.collect_params().items()}
    tq, jq = _compare_with_jax(tpath, jpath, jparams, names, "int8")
    assert tq["calibration"]["max_rel_err"] < 0.1
    np.testing.assert_allclose(tq["calibration"]["max_abs_err"],
                               jq["calibration"]["max_abs_err"],
                               rtol=0, atol=ATOL)


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


def test_bert_quantized_predict_matches_jax_model_server(bert_quant):
    """The slice as a whole: the int8 artifact of the flash classifier,
    loaded with ``load_artifact`` and served by the port's
    ``ModelServer.predict`` from threads, against the JAX package's int8
    artifact of the same weights served by its ``ModelServer``."""
    from mxnet_tpu import serving as jserving
    _j, tclf, tpath, jpath, _names = bert_quant
    reqs = _requests()
    cfg = dict(max_batch_size=8, max_latency_us=20_000, num_workers=2)
    repo = ModelRepository()
    entry = repo.load_artifact("bert", tpath, device="cpu")
    assert entry.kind == "stablehlo" and entry.quantization["mode"] == "int8"
    with ModelServer(repo, ServingConfig(**cfg)) as srv:
        warm = srv.prewarm("bert")
        got = _serve(srv, "bert", reqs)
        stats = srv.stats()
    assert warm["compiled"] == len(serving.bucket_set(8))
    jrepo = jserving.ModelRepository()
    jrepo.load_artifact("bert", jpath + ".shlo")
    with jserving.ModelServer(jrepo, jserving.ServingConfig(**cfg)) as jsrv:
        want = _serve(jsrv, "bert", reqs)
    calib = entry.quantization["calibration"]
    for req, g, w in zip(reqs, got, want):
        assert g.shape == (req[0].shape[0], 2)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        # and the quantized logits stay near the float module's
        assert np.abs(g - _ref(tclf, *req)).max() \
            < 10 * calib["max_abs_err"] + 1e-3
    assert stats["completed"] == len(reqs)
    assert stats["bucket_misses"] == len(serving.bucket_set(8))
