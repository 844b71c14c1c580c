"""PyTorch port, package boundary: no module of ``mxnet_tpu_torch`` and
not ``chip_smoke.py`` imports ``jax`` or the JAX package (an AST scan of
every import statement), ``import mxnet_tpu_torch`` (which brings in
``nd`` with ``nd.sparse``, ``autograd``, ``gluon`` with
``gluon.data``, ``gluon.rnn``, ``gluon.contrib`` and
``gluon.model_zoo``, ``kvstore``, ``metric``, ``recordio``, ``sym``,
``executor``, ``module``, ``callback``, ``attribute`` and ``compat``)
loads neither and builds no kernel, the adapter's, the multi-rank entry
points' and ``Module``'s default device refuses to fall back to the
CPU, the kernel build reports a missing ``nvcc`` as
:class:`MXNetError`, the ``gluon.contrib`` names not ported yet
raise :class:`MXNetError` naming ROADMAP 6.4b, and every module the two
packages share has the JAX module's public names but an explicit list
of exceptions.
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
    scanned = {os.path.relpath(f, REPO) for f in files}
    for module in ("ops/flash_attention.py", "models/bert.py",
                   "parallel/trainer.py", "parallel/optim.py",
                   "parallel/mesh.py", "perf_account.py", "deploy.py",
                   "serving/server.py", "serving/repository.py",
                   "serving/batcher.py", "serving/resilience.py",
                   "parallel/checkpoint.py", "parallel/supervisor.py",
                   "io/io.py", "random.py", "quantize.py",
                   "serving/replica.py", "parallel/placement.py",
                   "serving/admission.py", "serving/autoscaler.py",
                   "serving/traffic.py", "parallel/dist.py",
                   "parallel/sharding.py", "parallel/ring_attention.py",
                   "parallel/pipeline.py", "tools/launch.py",
                   "context.py", "autograd.py", "ndarray/ndarray.py",
                   "ndarray/__init__.py", "ops/registry.py", "ops/tensor.py",
                   "ops/nn.py", "ops/optimizer_ops.py", "initializer.py",
                   "lr_scheduler.py", "optimizer/optimizer.py",
                   "gluon/parameter.py", "gluon/block.py", "gluon/loss.py",
                   "gluon/cached_op.py",
                   "gluon/utils.py", "gluon/trainer.py",
                   "gluon/nn/basic_layers.py", "gluon/nn/conv_layers.py",
                   "kvstore/base.py", "kvstore/kvstore.py",
                   "gluon/data/__init__.py", "gluon/data/dataset.py",
                   "gluon/data/sampler.py", "gluon/data/dataloader.py",
                   "gluon/data/vision/__init__.py",
                   "gluon/data/vision/datasets.py",
                   "gluon/data/vision/transforms.py", "metric.py",
                   "recordio.py", "attribute.py", "symbol/__init__.py",
                   "symbol/symbol.py", "symbol/infer.py", "executor.py",
                   "module/__init__.py", "module/base_module.py",
                   "module/module.py", "module/bucketing_module.py",
                   "callback.py", "compat.py", "ndarray/sparse.py",
                   "gluon/rnn/__init__.py", "gluon/rnn/rnn_layer.py",
                   "gluon/rnn/rnn_cell.py", "gluon/contrib/__init__.py",
                   "gluon/contrib/nn.py", "gluon/contrib/rnn.py",
                   "gluon/contrib/estimator.py",
                   "gluon/model_zoo/__init__.py",
                   "gluon/model_zoo/vision.py"):
        assert f"mxnet_tpu_torch/{module}" in scanned, module
    bad = [(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def test_chip_smoke_defines_each_top_level_name_once():
    """A phase's helper that reuses an earlier helper's name rebinds it
    for every phase of the script."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    assert sorted({n for n in names if names.count(n) > 1}) == []


def test_package_import_loads_no_jax_and_builds_no_kernel():
    import subprocess
    import sys
    code = ("import sys\n"
            "import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import nd, autograd, gluon, kvstore\n"
            "from mxnet_tpu_torch import metric, recordio\n"
            "from mxnet_tpu_torch import sym, executor, module, callback\n"
            "from mxnet_tpu_torch import attribute, compat\n"
            "from mxnet_tpu_torch.gluon import rnn, contrib, model_zoo\n"
            "from mxnet_tpu_torch.gluon.contrib import nn, estimator\n"
            "assert mx.nd.sparse.RowSparseNDArray\n"
            "assert mx.Symbol is sym.Symbol and mx.AttrScope\n"
            "from mxnet_tpu_torch.gluon.data import vision\n"
            "from mxnet_tpu_torch.ops import build\n"
            "assert not build._LIBS, build._LIBS\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "assert not bad, bad\n"
            "assert mx.current_context() == mx.gpu(0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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


def test_multi_rank_entry_points_default_to_the_card(monkeypatch):
    """``dist.initialize``, ``make_mesh`` and ``make_pipeline_mesh`` take
    ``device="cuda"`` unless told otherwise, and without a card they
    refuse instead of running on the CPU."""
    import torch

    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **k: pytest.fail("group created"))
    with pytest.raises(MXNetError, match="no CUDA device"):
        dist.initialize(coordinator_address="127.0.0.1:1",
                        num_processes=1, process_id=0)
    assert not dist.is_initialized()
    with pytest.raises(MXNetError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(MXNetError, match="no CUDA device"):
        parallel.make_pipeline_mesh(1)
    assert parallel.make_pipeline_mesh(1, device="cpu").device.type == "cpu"


def test_module_default_context_is_the_card():
    """A Module made without ``context`` binds on ``mx.gpu(0)``; without
    a card its bind refuses instead of running on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    s = mx.sym
    out = s.FullyConnected(s.var("data"), s.var("w"), s.var("b"),
                           num_hidden=2, name="fc")
    mod = mx.module.Module(out, label_names=None)
    assert mod._context == mx.gpu(0)
    if mx.num_gpus() == 0:
        with pytest.raises(MXNetError, match="no device"):
            mod.bind(data_shapes=[("data", (2, 3))])


@pytest.mark.parametrize("name", ["detection", "FusedTrainStep", "MoEFFN"])
def test_gluon_contrib_names_still_to_come_raise(name):
    """The last names of ROADMAP 6.4b are ported: each resolves, and an
    unknown name raises a plain AttributeError, as in the JAX package."""
    from mxnet_tpu_torch.gluon import contrib
    assert name in contrib.__all__ and getattr(contrib, name) is not None
    with pytest.raises(AttributeError):
        contrib.no_such_name
    assert {"nn", "rnn", "estimator", name} <= set(dir(contrib))


# Public names of the JAX package that the port has not, by module: the
# names a later ROADMAP item brings, and the JAX-only ones.
NAME_EXCEPTIONS = {
    "": {"library": "6.8b", "operator": "6.8b", "profiler": "6.8b",
         "runtime": "6.8b", "util": "6.8b", "tpu": "JAX-only",
         "num_tpus": "JAX-only"},
    "context": {"tpu": "JAX-only", "num_tpus": "JAX-only"},
    "compile_cache": {"aot_program": "waiting item 2",
                      "enable_jax_persistent_cache": "JAX-only"},
    "contrib": {"onnx": "6.8b", "text": "6.8b", "tensorboard": "6.8b"},
    "gluon.utils": {"download": "needs a network"},
    "ops": {"pallas_kernels": "JAX-only"},
    # registered ops whose port functions live in ops/nn.py
    "ops.contrib": {"gelu_erf": "ops.nn", "gelu_tanh": "ops.nn"},
    # the JAX registry's hot-path OpDef that skips its signature harvest
    "ops.registry": {"LightOpDef": "JAX-only"},
    "parallel.sharding": {"global_device_put": "JAX-only"},
    "random": {"next_key": "JAX-only", "trace_key_scope": "JAX-only"},
    "runtime_metrics": {"dump_tensorboard": "6.8b"},
}


def _shared_modules():
    """Every module of the port with a module of the same path in the
    JAX package ("" is the package root)."""
    out = []
    for root, _dirs, names in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, n),
                                  os.path.join(REPO, "mxnet_tpu_torch"))
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            jax_path = os.path.join(REPO, "mxnet_tpu", *parts)
            if os.path.exists(jax_path + ".py") or os.path.exists(
                    os.path.join(jax_path, "__init__.py")):
                out.append(".".join(parts))
    return sorted(out)


def _public(mod):
    """``__all__``, else the names without an underscore that the module
    (or a module under it) defines."""
    import types
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        owner = v.__name__ if isinstance(v, types.ModuleType) \
            else getattr(v, "__module__", None)
        if owner and (owner == mod.__name__
                      or owner.startswith(mod.__name__ + ".")):
            out.add(n)
    return out


def _missing_names():
    """{module: sorted public names of the JAX module the port's lacks}
    over the shared modules."""
    import importlib
    missing = {}
    for rel in _shared_modules():
        suffix = "." + rel if rel else ""
        jax_mod = importlib.import_module("mxnet_tpu" + suffix)
        port_mod = importlib.import_module("mxnet_tpu_torch" + suffix)
        lack = sorted(n for n in _public(jax_mod) if not hasattr(port_mod, n))
        if lack:
            missing[rel] = lack
    return missing


def test_public_names_match_the_jax_package():
    """In a fresh interpreter: a package's attributes include the
    submodules imported so far, which other tests of a worker change."""
    import json
    import subprocess
    import sys
    assert {"", "engine", "initializer", "ndarray", "random", "base",
            "models", "models.bert", "models.transformer",
            "models.decoding", "parallel", "ops"} <= set(_shared_modules())
    code = ("import json, sys\n"
            f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
            "import test_torch_imports as t\n"
            "print(json.dumps(t._missing_names()))\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    missing = json.loads(out.stdout.strip().splitlines()[-1])
    assert missing == {k: sorted(v) for k, v in NAME_EXCEPTIONS.items()}
