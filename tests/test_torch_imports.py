"""PyTorch port, package boundary: no module of ``mxnet_tpu_torch`` and
not ``chip_smoke.py`` imports ``jax`` or the JAX package (an AST scan of
every import statement), the adapter's default device refuses to fall
back to the CPU, and the kernel build reports a missing ``nvcc`` as
:class:`MXNetError`.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) \
                and getattr(node.func, "id", None) == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10, files
    bad = [(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def test_adapter_default_device_refuses_without_a_card(monkeypatch):
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.models import TransformerDecoderLM
    from mxnet_tpu_torch.serving import PagedLMAdapter, as_decode_model
    lm = TransformerDecoderLM(11, units=8, hidden_size=16, num_layers=1,
                              num_heads=2, max_length=8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        PagedLMAdapter(lm)
    with pytest.raises(MXNetError, match="no CUDA device"):
        as_decode_model(lm)
    assert PagedLMAdapter(lm, device="cpu").device.type == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import build
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: False if p.endswith("bin/nvcc")
                        else real_exists(p))
    with pytest.raises(MXNetError, match="nvcc not found"):
        build.build()
    path = build.library_path("ragged_paged_attention")
    assert path.startswith(str(tmp_path)) and path.endswith(".so")
