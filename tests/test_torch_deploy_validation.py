"""PyTorch port, serving signatures: twins of the JAX package's manifest
checks (tests/test_export_stablehlo.py) on ``mxnet_tpu_torch.deploy`` —
structural manifest validation, the dynamic-batch inference check, and
the signature guard of ``ModelRepository.add_function`` — plus the
request-time ``validate_inputs`` on numpy arrays and torch tensors, and
the two validators held to the JAX package's on the same manifests.
The artifact round trip waits for the port's exporter (ROADMAP item
3a′).
"""
import json

import numpy as np
import pytest
import torch

from mxnet_tpu import deploy as jdeploy
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu_torch import deploy
from mxnet_tpu_torch.base import MXNetError

GOOD = {"inputs": [{"shape": [None, 8], "dtype": "float32"}],
        "outputs": [{"shape": [None, 4], "dtype": "float32"}],
        "version": 3, "dynamic_batch": True}


def test_validate_manifest_structural_checks():
    assert deploy.validate_manifest(dict(GOOD)) == GOOD

    with pytest.raises(MXNetError, match="missing 'inputs'"):
        deploy.validate_manifest({"outputs": []})
    bad = dict(GOOD, inputs=[{"shape": [None, -2], "dtype": "float32"}])
    with pytest.raises(MXNetError, match="nonnegative ints or null"):
        deploy.validate_manifest(bad)
    bad = dict(GOOD, inputs=[{"shape": [None, 8], "dtype": "float99"}])
    with pytest.raises(MXNetError, match="unknown dtype"):
        deploy.validate_manifest(bad)
    bad = dict(GOOD, version="three")
    with pytest.raises(MXNetError, match="version must be an int"):
        deploy.validate_manifest(bad)
    bad = dict(GOOD, inputs=[{"shape": "nope", "dtype": "float32"}])
    with pytest.raises(MXNetError, match="signature entry"):
        deploy.validate_manifest(bad)
    # bfloat16 is a dtype name torch carries and numpy lacks
    deploy.validate_manifest(
        dict(GOOD, inputs=[{"shape": [None, 8], "dtype": "bfloat16"}]))


def test_validate_manifest_dynamic_batch_inference_checks():
    m = {"inputs": [{"shape": [4, 8], "dtype": "float32"}],
         "outputs": [{"shape": [None, 4], "dtype": "float32"}],
         "dynamic_batch": True}
    with pytest.raises(MXNetError, match="symbolic batch dim"):
        deploy.validate_manifest(m)
    m = {"inputs": [{"shape": [None, 8], "dtype": "float32"}],
         "outputs": [{"shape": [4], "dtype": "float32"}],
         "dynamic_batch": True}
    with pytest.raises(MXNetError, match="not .*batch-major|batch-major"):
        deploy.validate_manifest(m)
    m = {"inputs": [{"shape": [None, 8], "dtype": "float32"}],
         "outputs": [{"shape": [], "dtype": "float32"}],
         "dynamic_batch": True}
    with pytest.raises(MXNetError, match="batch"):
        deploy.validate_manifest(m)
    m = {"inputs": [{"shape": [4, 8], "dtype": "float32"}],
         "outputs": [{"shape": [4], "dtype": "float32"}]}
    deploy.validate_manifest(m)


def test_validate_signature_guards_add_function():
    from mxnet_tpu_torch.serving import ModelRepository

    deploy.validate_signature([{"shape": [None, 8], "dtype": "float32"}])
    with pytest.raises(MXNetError, match="list of .*entries"):
        deploy.validate_signature({"shape": [8]})
    with pytest.raises(MXNetError, match="unknown dtype"):
        deploy.validate_signature([{"shape": [8], "dtype": "floatx"}])

    repo = ModelRepository()
    with pytest.raises(MXNetError, match="add_function\\('bad'\\)"):
        repo.add_function("bad", lambda x: x,
                          [{"shape": [None, "eight"], "dtype": "float32"}])
    assert "bad" not in repo.models()
    with pytest.raises(MXNetError, match="concrete leading dimension"):
        repo.add_function("batchy", lambda x: x,
                          [{"shape": [4, 8], "dtype": "float32"}])
    repo.add_function("batchy", lambda x: x,
                      [{"shape": [4, 8], "dtype": "float32"}],
                      dynamic_batch=False)


def test_validate_inputs_numpy_and_torch():
    m = {"dynamic_batch": True,
         "inputs": [{"shape": [None, 3], "dtype": "int32"},
                    {"shape": [None], "dtype": "float32"}]}
    deploy.validate_inputs(m, (np.zeros((2, 3), np.int32),
                               np.zeros(2, np.float32)))
    deploy.validate_inputs(m, (torch.zeros(5, 3, dtype=torch.int32),
                               torch.zeros(5)))
    with pytest.raises(MXNetError, match="dtype mismatch"):
        deploy.validate_inputs(m, (torch.zeros(2, 3), torch.zeros(2)))
    with pytest.raises(MXNetError, match="disagree on the batch"):
        deploy.validate_inputs(m, (np.zeros((2, 3), np.int32),
                                   np.zeros(3, np.float32)))


_QUANT = {"mode": "int8", "weights": [{"name": "w", "scale": 0.5,
                                       "dtype": "int8", "elems": 4}]}
_CASES = [
    GOOD,
    {"outputs": []},
    dict(GOOD, inputs=[{"shape": [None, -2], "dtype": "float32"}]),
    dict(GOOD, version="three"),
    dict(GOOD, manifest_version=9),
    dict(GOOD, precompiled=[{"bucket": 1, "file": "../x", "key": "k"}]),
    dict(GOOD, precompiled=[{"bucket": 2, "file": "b2.bin", "key": "k"}]),
    dict(GOOD, manifest_version=4, quantization=_QUANT),
    dict(GOOD, manifest_version=3, quantization=_QUANT),
    dict(GOOD, manifest_version=4,
         quantization=dict(_QUANT, digest="0" * 64)),
    dict(GOOD, decode={"vocab_size": 8, "num_layers": 1, "num_heads": 1,
                       "head_dim": 4, "max_context": 16, "eos_id": 9}),
    dict(GOOD, decode={"vocab_size": 8, "num_layers": 1, "num_heads": 1,
                       "head_dim": 4, "max_context": 16, "spec_k": 3}),
    {"inputs": [{"shape": [4, 8], "dtype": "float32"}],
     "dynamic_batch": True},
]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_validate_manifest_agrees_with_jax_package(case):
    """Same manifest, same verdict (and the same message) as the JAX
    package's validator."""
    m = json.loads(json.dumps(_CASES[case]))
    try:
        jdeploy.validate_manifest(json.loads(json.dumps(m)))
        want = None
    except JaxMXNetError as e:
        want = str(e)
    try:
        deploy.validate_manifest(m)
        got = None
    except MXNetError as e:
        got = str(e)
    assert got == want
