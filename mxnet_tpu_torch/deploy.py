"""Deployment artifacts and serving signatures (docs/frontends.md §2).

The PyTorch port of ``mxnet_tpu.deploy``:

- the artifact half: :func:`export_stablehlo` writes a module's
  inference forward as a ``torch.export`` program (``path.shlo``, the
  ``torch.export.save`` archive with the weights inside; the file name
  is the JAX package's, the content is not StableHLO) beside its
  signature manifest (``path.json``); :func:`load_stablehlo` loads it
  onto a device as a :class:`StableHLOModel`, which validates every
  call against the manifest.  The flash-attention forward (B1) is the
  registered operator ``mxnet_tpu_torch::flash_attention_fwd``, so an
  exported BERT holds one node per layer, and a process that imports
  ``mxnet_tpu_torch.ops`` (and nothing else of the port) can load and
  run it; on the card the node launches ``csrc/flash_attention_fwd.cu``.
  ``serving.ModelRepository.load_artifact`` serves such an artifact.
  ``export_stablehlo(quantize='int8'|'fp8')`` writes the quantized
  serving shape (manifest v4): int8 / float8_e4m3fn weights with
  per-tensor scales, dequantized inside the program where each is read.
- the framework-free validators: the manifest loader and its structural
  checks (``load_manifest``, ``validate_manifest``,
  ``validate_signature``) and the request-time guard
  ``validate_inputs``.  ``serving`` validates every ``predict()``
  against an entry's signature with it, and
  ``ModelRepository.add_function`` checks a hand-written signature with
  it at registration.

A signature is a list of ``{"shape": [int|null, ...], "dtype": name}``
entries; ``null`` marks a free dimension.  Dtype names are numpy's;
``bfloat16`` and the float8 names (which numpy lacks) are torch's.
"""
from __future__ import annotations

import copy
import hashlib
import inspect
import itertools
import json
import os

import numpy as np
import torch

from . import faults as _faults
from . import ops as _ops  # noqa: F401  (registers B1's operator)
from . import quantize as _qz
from . import tracing as _tr
from .base import MXNetError

__all__ = ["export_stablehlo", "load_stablehlo", "StableHLOModel",
           "load_manifest", "validate_manifest", "validate_signature",
           "validate_inputs", "QUANT_DTYPES", "ARTIFACT_FORMAT"]

# the manifest's "format" of this package's artifacts (the JAX package
# writes "jax.export/stablehlo", which this loader refuses)
ARTIFACT_FORMAT = "torch.export"

# weight dtypes a quantized (manifest v4) artifact may bake in
QUANT_DTYPES = frozenset({"int8", "float8_e4m3fn", "float8_e5m2"})
# dtype names numpy cannot resolve but torch tensors carry
_EXTENSION_DTYPES = frozenset({"bfloat16", "float8_e4m3fn", "float8_e5m2"})


def _manifest_path(path):
    """``model.shlo`` / ``model`` -> ``model.json``."""
    base = path[:-len(".shlo")] if path.endswith(".shlo") else path
    return base + ".json"


def _sig_entry(shape, dtype):
    return {"shape": [d if isinstance(d, int) else None for d in shape],
            "dtype": str(dtype)}


def _quantization_digest(qblock) -> str:
    """Content address of a manifest ``quantization`` block (minus the
    digest field itself): canonical-JSON sha256, so a hand-edited scale
    is rejected at ``validate_manifest``."""
    body = {k: v for k, v in qblock.items() if k != "digest"}
    payload = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def _dtype_name(dtype):
    """``torch.int32`` / ``np.dtype('int32')`` -> ``"int32"``."""
    return str(dtype).rsplit(".", 1)[-1]


def _module_device(module):
    """The device of a module's first parameter or buffer (the CPU for a
    module that has none)."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return torch.device("cpu")


def _as_tensor(x, device):
    t = x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


# manifest v4: the quantize= modes and the payload dtype each writes
_QUANT_WIRE = {"int8": "int8", "fp8": "float8_e4m3fn"}
# a quantized weight's scale is the buffer of this suffix beside it
_SCALE_SUFFIX = "_qscale"


def _dequantizing(cls, dtypes):
    """A subclass of module class ``cls`` whose attribute ``name`` (each
    of ``dtypes``) is the weight dequantized from the module's buffers
    ``name`` (the int8/fp8 payload) and ``name + _SCALE_SUFFIX`` (its
    float32 scale), cast back to ``dtypes[name]``: every read
    dequantizes where the forward reads the weight."""
    def prop(name, dtype):
        return property(lambda self: _qz.dequantize_tensor(
            self._buffers[name], self._buffers[name + _SCALE_SUFFIX],
            dtype))
    attrs = {name: prop(name, dtype) for name, dtype in dtypes.items()}
    return type(f"Quantized{cls.__name__}", (cls,), attrs)


def _quantized_copy(module, quantize):
    """Weight-only post-training quantization of ``module`` for export:
    every floating parameter of dim >= 2 becomes a ``quantize`` payload
    (per-tensor symmetric scale, ``quantize.tensor_scale``) held as a
    buffer under the parameter's own name, with its scale beside it, and
    the module reads it back dequantized at each use.  The copy shares
    the other parameters and buffers' values but not the originals of
    the quantized weights (no float copy of them is made or kept).

    Returns ``(copy, quant_block)``: the manifest v4 ``quantization``
    entry (mode and one ``{name, scale, dtype, elems}`` a weight, named
    by the state-dict name)."""
    if quantize not in _QUANT_WIRE:
        raise MXNetError(
            f"export_stablehlo: quantize must be 'int8' or 'fp8', "
            f"got {quantize!r}")
    spec = _qz.CompressionSpec(kind=quantize)
    packed, weights_meta = {}, []
    for name, p in module.named_parameters():
        if p.dim() < 2 or not p.is_floating_point():
            continue
        scale = _qz.tensor_scale(p, spec)
        with torch.no_grad():
            q = _qz.quantize_tensor(p.detach(), scale, spec)
        # the scale has the weight's rank, so the multiply broadcasts it
        # without a reshape
        packed[id(p)] = (q, torch.full((1,) * p.dim(), scale,
                                       dtype=torch.float32,
                                       device=p.device), p.dtype)
        weights_meta.append({"name": name, "scale": float(scale),
                             "dtype": _QUANT_WIRE[quantize],
                             "elems": int(p.numel())})
    if not weights_meta:
        raise MXNetError(
            f"export_stablehlo(quantize={quantize!r}): "
            f"{type(module).__name__} has no >=2d float weight tensors "
            f"to quantize")
    memo = {id(t): None for t in itertools.chain(
        (p for p in module.parameters() if id(p) in packed),
        (p.grad for p in module.parameters() if p.grad is not None))}
    qmod = copy.deepcopy(module, memo)
    for orig, sub in zip(module.modules(), qmod.modules()):
        dtypes = {}
        for name, p in orig._parameters.items():
            if p is None or id(p) not in packed:
                continue
            q, scale, dtype = packed[id(p)]
            del sub._parameters[name]
            sub.register_buffer(name, q)
            sub.register_buffer(name + _SCALE_SUFFIX, scale)
            dtypes[name] = dtype
        if dtypes:
            sub.__class__ = _dequantizing(type(sub), dtypes)
    return qmod, {"mode": quantize, "weights": weights_meta}


def _calibration(module, program, example_inputs):
    """The manifest's ``calibration`` entry: ``module`` (unquantized) and
    ``program`` (the exported quantized program, what ships) run on the
    example inputs; the largest absolute output error, and that error
    over the reference output's max |value|, as the JAX package records
    them."""
    def outs(fn):
        with torch.no_grad():
            out = fn(*example_inputs)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [o.detach().float().cpu().numpy() for o in out]

    max_abs = max_rel = 0.0
    for r, q in zip(outs(module), outs(program)):
        abs_err = float(np.max(np.abs(q - r))) if r.size else 0.0
        ref_mag = float(np.max(np.abs(r))) if r.size else 0.0
        max_abs = max(max_abs, abs_err)
        max_rel = max(max_rel, abs_err / (ref_mag + 1e-12))
    first = example_inputs[0] if example_inputs else None
    return {"examples": int(first.shape[0])
            if first is not None and first.dim() else 0,
            "max_abs_err": max_abs, "max_rel_err": max_rel}


def export_stablehlo(module, *example_inputs, path, emit_text=False,
                     dynamic_batch=False, version=None, decode=None,
                     precompile=(), quantize=None):
    """Export ``module``'s inference forward as a deployable artifact.

    The module is exported in eval mode under ``torch.no_grad()`` with
    ``torch.export.export`` on its own device (numpy example inputs go
    there); its mode is restored afterwards.  Writes ``path.shlo`` (the
    ``torch.export.save`` archive: the program with its weights — a
    ``torch.export`` program, not StableHLO; the name is the JAX
    package's, so paths and ``ModelRepository.load_artifact`` carry over)
    and ``path.json``, the manifest: v3 (v4 when quantized) with
    ``"format": "torch.export"``,
    the ``inputs`` / ``outputs`` signature (symbolic dimensions ``null``),
    ``dynamic_batch``, ``version`` (null unless given: the serving
    repository then numbers versions itself), ``block`` (the module's
    class name) and, with ``decode``, the decode metadata dict (checked
    as the JAX package checks it).  With ``emit_text=True`` also writes
    ``path.export.txt``, the program's text.  The manifest is validated
    before anything is written, so a rejected export leaves no file.

    ``dynamic_batch=True`` exports axis 0 of every input as ONE shared
    symbolic size (``torch.export.Dim("b")``), so one artifact serves
    every batch bucket.  ``torch.export`` specialises a dimension whose
    example size is 1, so an example batch of 1 is traced as its rows
    repeated to 2; the manifest records the axis as ``null`` all the
    same.

    Kernels: B1 is the operator ``mxnet_tpu_torch::flash_attention_fwd``
    in the exported graph; a process that loads the archive needs
    ``torch`` and ``import mxnet_tpu_torch.ops`` (which registers it),
    nothing else of the port.

    ``quantize='int8'|'fp8'`` exports the quantized serving shape
    (manifest v4): every floating parameter of dim >= 2 is stored as an
    int8 / float8_e4m3fn payload with one per-tensor symmetric scale
    (``quantize.tensor_scale``), both buffers of the program under the
    parameter's state-dict name (the scale as ``name + "_qscale"``); no
    float copy of a quantized weight is in the archive.  The program
    dequantizes each weight where the forward reads it (float32 multiply,
    one cast back to the weight's dtype), so a graph replaying it holds
    one dequantized weight at a time, not a float copy of the model.
    The example inputs are the calibration batch: the unquantized module
    and the exported quantized program both run on them and the manifest's
    ``quantization`` block records ``calibration = {examples,
    max_abs_err, max_rel_err}``, the per-tensor scales (``weights``:
    ``{name, scale, dtype, elems}``) and their ``digest``, which
    ``load_manifest`` verifies; ``ModelRepository.load_artifact`` admits
    the artifact against them (``MXNET_SERVING_QUANT_*``).

    ``precompile`` (executables shipped per bucket) has no counterpart
    yet and raises :class:`MXNetError` (ROADMAP Queue A item 2).
    """
    if precompile:
        raise MXNetError(
            "export_stablehlo(precompile=...): not ported — a bucket "
            "program of this package is a CUDA graph, which cannot "
            "outlive its process (ROADMAP Queue A item 2)")
    if not isinstance(module, torch.nn.Module):
        raise MXNetError(
            f"export_stablehlo: expected a torch.nn.Module, got "
            f"{type(module).__name__}")
    if not example_inputs:
        raise MXNetError("export_stablehlo: pass example inputs to fix "
                         "the signature")
    device = _module_device(module)
    xs = calib_inputs = tuple(_as_tensor(x, device)
                              for x in example_inputs)
    target, quant_block = module, None
    if quantize:
        target, quant_block = _quantized_copy(module, quantize)
    dynamic_shapes = None
    if dynamic_batch:
        if any(x.dim() < 1 for x in xs):
            raise MXNetError(
                "export_stablehlo(dynamic_batch=True): every input needs "
                "a leading batch dimension")
        xs = tuple(torch.cat([x, x]) if x.shape[0] == 1 else x
                   for x in xs)
        batch = torch.export.Dim("b")
        dynamic_shapes = tuple({0: batch} for _ in xs)
        if any(p.kind is p.VAR_POSITIONAL for p in
               inspect.signature(target.forward).parameters.values()):
            # ``forward(self, *inputs)`` (a Gluon block's GluonModule):
            # the inputs are one tuple argument
            dynamic_shapes = (dynamic_shapes,)
    was_training = module.training
    module.eval()
    target.eval()
    try:
        try:
            with torch.no_grad():
                exported = torch.export.export(
                    target, xs, dynamic_shapes=dynamic_shapes)
        except Exception as e:
            raise MXNetError(
                f"export_stablehlo: torch.export failed: {e}") from e
        if quant_block is not None:
            quant_block["calibration"] = _calibration(
                module, exported.module(), calib_inputs)
            quant_block["digest"] = _quantization_digest(quant_block)
    finally:
        module.train(was_training)
    user = set(exported.graph_signature.user_outputs)
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [n.meta["val"] for n in out_node.args[0]
            if getattr(n, "name", None) in user]
    manifest = {
        "format": ARTIFACT_FORMAT,
        "manifest_version": 3 if quant_block is None else 4,
        "version": version,
        "dynamic_batch": bool(dynamic_batch),
        "inputs": [_sig_entry([None, *x.shape[1:]] if dynamic_batch
                              else x.shape, _dtype_name(x.dtype))
                   for x in xs],
        "outputs": [_sig_entry(o.shape, _dtype_name(o.dtype)) for o in outs],
        "block": type(module).__name__,
    }
    if decode is not None:
        manifest["decode"] = dict(decode)
    if quant_block is not None:
        manifest["quantization"] = quant_block
    # validate BEFORE anything touches disk: an orphan .shlo without its
    # manifest would later load unchecked
    validate_manifest(manifest, where=f"export_stablehlo({path!r})")
    with open(path + ".shlo", "wb") as f:
        torch.export.save(exported, f)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    if emit_text:
        with open(path + ".export.txt", "w") as f:
            f.write(str(exported))
    return path + ".shlo"


def load_manifest(path):
    """Read the ``.json`` signature manifest next to an artifact (pass
    either the ``.shlo`` path or the bare prefix).  Returns None when
    the artifact ships without one."""
    mpath = _manifest_path(path)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    if not isinstance(manifest.get("inputs"), list):
        raise MXNetError(f"malformed artifact manifest {mpath}: "
                         f"missing 'inputs' signature")
    validate_manifest(manifest, where=mpath)
    return manifest


def _check_sig_entries(entries, kind, where):
    for i, spec in enumerate(entries):
        if not isinstance(spec, dict) \
                or not isinstance(spec.get("shape"), list) \
                or "dtype" not in spec:
            raise MXNetError(
                f"{where}: manifest {kind} {i} is not a "
                f"{{shape, dtype}} signature entry")
        for d in spec["shape"]:
            if d is not None and (not isinstance(d, int) or d < 0):
                raise MXNetError(
                    f"{where}: manifest {kind} {i} has dimension {d!r} — "
                    f"dims are nonnegative ints or null (symbolic)")
        if not _known_dtype(spec["dtype"]):
            raise MXNetError(
                f"{where}: manifest {kind} {i} declares unknown dtype "
                f"{spec['dtype']!r}")


def _known_dtype(d) -> bool:
    """Whether ``d`` names a resolvable dtype: a numpy dtype, or one of
    the extension names torch carries (``bfloat16``, float8)."""
    if str(d) in _EXTENSION_DTYPES:
        return True
    try:
        np.dtype(d)
        return True
    except Exception:
        return False


def validate_signature(entries, where="signature", dynamic_batch=False):
    """Structural check of a bare manifest-style signature list (what
    ``serving.ModelRepository.add_function`` accepts): each entry is
    ``{"shape": [int|null, ...], "dtype": name}``.  With
    ``dynamic_batch`` every entry's leading dim must be symbolic
    (``None``): the batcher splits rows along it."""
    if not isinstance(entries, (list, tuple)):
        raise MXNetError(
            f"{where}: signature must be a list of {{shape, dtype}} "
            f"entries, got {type(entries).__name__}")
    _check_sig_entries(list(entries), "input", where)
    if dynamic_batch:
        for i, spec in enumerate(entries):
            if not spec["shape"] or spec["shape"][0] is not None:
                raise MXNetError(
                    f"{where}: dynamic_batch signature input {i} has a "
                    f"concrete leading dimension "
                    f"({spec['shape'] or 'scalar'}) — every input must "
                    f"share the symbolic (null) batch dim, or register "
                    f"with dynamic_batch=False")
    return entries


def _check_quantization(qb, mver, where):
    if mver is None or mver < 4:
        raise MXNetError(
            f"{where}: 'quantization' needs manifest_version >= 4 "
            f"(got {mver!r}) — re-export with "
            f"deploy.export_stablehlo(quantize=...)")
    if not isinstance(qb, dict) \
            or qb.get("mode") not in ("int8", "fp8") \
            or not isinstance(qb.get("weights"), list) \
            or not qb["weights"]:
        raise MXNetError(
            f"{where}: manifest 'quantization' must be a dict with "
            f"mode in ('int8', 'fp8') and a non-empty 'weights' list")
    for i, w in enumerate(qb["weights"]):
        ok = isinstance(w, dict) \
            and isinstance(w.get("name"), str) \
            and isinstance(w.get("scale"), (int, float)) \
            and not isinstance(w.get("scale"), bool) \
            and isinstance(w.get("dtype"), str) \
            and isinstance(w.get("elems"), int) and w["elems"] >= 1
        if not ok:
            raise MXNetError(
                f"{where}: quantization weight entry {i} is not a "
                f"{{name, scale, dtype, elems>=1}} record")
        scale = float(w["scale"])
        if not (scale > 0.0) or not np.isfinite(scale):
            raise MXNetError(
                f"{where}: quantization scale for {w['name']!r} must be "
                f"a positive finite float, got {w['scale']!r} — the "
                f"manifest is corrupted or hand-edited; re-export the "
                f"artifact")
        if w["dtype"] not in QUANT_DTYPES:
            raise MXNetError(
                f"{where}: quantization dtype {w['dtype']!r} for "
                f"{w['name']!r} not in {sorted(QUANT_DTYPES)}")
        if (qb["mode"] == "int8") != (w["dtype"] == "int8"):
            raise MXNetError(
                f"{where}: quantization weight {w['name']!r} dtype "
                f"{w['dtype']!r} disagrees with mode {qb['mode']!r}")
    calib = qb.get("calibration")
    if calib is not None:
        if not isinstance(calib, dict):
            raise MXNetError(
                f"{where}: quantization 'calibration' must be a dict")
        for field in ("max_abs_err", "max_rel_err"):
            v = calib.get(field)
            if v is not None and (
                    not isinstance(v, (int, float)) or isinstance(v, bool)
                    or not np.isfinite(float(v)) or float(v) < 0):
                raise MXNetError(
                    f"{where}: calibration {field} must be a finite "
                    f"nonnegative number, got {v!r}")
    if "digest" in qb:
        # a PRESENT digest key must verify, a null one included
        digest = qb["digest"]
        if not isinstance(digest, str) \
                or digest != _quantization_digest(qb):
            raise MXNetError(
                f"{where}: quantization digest mismatch — the per-tensor "
                f"scales were modified after export (tampered or "
                f"corrupted manifest); the baked weights no longer match "
                f"their description, refusing to serve.  Re-export the "
                f"artifact.")


_DECODE_DIMS = ("vocab_size", "num_layers", "num_heads", "head_dim",
                "max_context")


def _check_decode(dec, where):
    if not isinstance(dec, dict):
        raise MXNetError(f"{where}: manifest 'decode' must be a dict of "
                         f"model dimensions")
    for field in _DECODE_DIMS:
        v = dec.get(field)
        if not isinstance(v, int) or v < 1:
            raise MXNetError(
                f"{where}: decode metadata field {field!r} must be a "
                f"positive int, got {v!r}")
    eos = dec.get("eos_id")
    if eos is not None and (not isinstance(eos, int) or eos < 0
                            or eos >= dec["vocab_size"]):
        raise MXNetError(
            f"{where}: decode metadata eos_id {eos!r} outside "
            f"[0, vocab_size={dec['vocab_size']})")
    draft = dec.get("draft")
    if draft is not None:
        if not isinstance(draft, dict):
            raise MXNetError(
                f"{where}: decode metadata 'draft' must be a dict of "
                f"draft-model dimensions")
        for field in _DECODE_DIMS:
            v = draft.get(field)
            if not isinstance(v, int) or v < 1:
                raise MXNetError(
                    f"{where}: decode draft metadata field {field!r} "
                    f"must be a positive int, got {v!r}")
        if draft["vocab_size"] != dec["vocab_size"]:
            raise MXNetError(
                f"{where}: decode draft vocab_size {draft['vocab_size']} "
                f"!= target vocab_size {dec['vocab_size']} — draft "
                f"proposals must be target token ids")
    spec_k = dec.get("spec_k")
    if spec_k is not None:
        if not isinstance(spec_k, int) or spec_k < 1:
            raise MXNetError(
                f"{where}: decode metadata spec_k must be a positive "
                f"int, got {spec_k!r}")
        if spec_k + 1 > dec["max_context"]:
            raise MXNetError(
                f"{where}: decode metadata spec_k {spec_k} + 1 exceeds "
                f"max_context {dec['max_context']}")


def validate_manifest(manifest, where="manifest"):
    """Soundness-check a (v2-v4) manifest against what the serving stack
    infers from it — the static half of :func:`validate_inputs`.

    Beyond per-entry structure, the load-bearing check: with
    ``dynamic_batch`` every input and output must be batch-major with a
    symbolic leading dimension, or serving would mis-split the batch at
    un-pad time.  Raises :class:`MXNetError`; returns the manifest."""
    if not isinstance(manifest.get("inputs"), list):
        raise MXNetError(f"{where}: manifest missing 'inputs' signature")
    outputs = manifest.get("outputs")
    _check_sig_entries(manifest["inputs"], "input", where)
    if isinstance(outputs, list):
        _check_sig_entries(outputs, "output", where)
    version = manifest.get("version")
    if version is not None and not isinstance(version, int):
        raise MXNetError(
            f"{where}: manifest version must be an int or null, got "
            f"{version!r}")
    mver = manifest.get("manifest_version")
    if mver is not None and (not isinstance(mver, int)
                             or not 2 <= mver <= 4):
        raise MXNetError(
            f"{where}: unsupported manifest_version {mver!r} "
            f"(this loader understands 2..4)")
    pre = manifest.get("precompiled")
    if pre is not None:
        if not isinstance(pre, list):
            raise MXNetError(
                f"{where}: manifest 'precompiled' must be a list")
        for i, e in enumerate(pre):
            if not isinstance(e, dict) \
                    or not isinstance(e.get("bucket"), int) \
                    or e["bucket"] < 1 \
                    or not isinstance(e.get("file"), str) \
                    or not isinstance(e.get("key"), str):
                raise MXNetError(
                    f"{where}: precompiled entry {i} is not a "
                    f"{{bucket>=1, file, key}} record")
            f = e["file"]
            if os.path.isabs(f) or ".." in f.split("/"):
                raise MXNetError(
                    f"{where}: precompiled entry {i} file {f!r} must be "
                    f"a relative path inside the artifact directory")
    if manifest.get("quantization") is not None:
        _check_quantization(manifest["quantization"], mver, where)
    if manifest.get("decode") is not None:
        _check_decode(manifest["decode"], where)
    if bool(manifest.get("dynamic_batch")):
        for i, spec in enumerate(manifest["inputs"]):
            if not spec["shape"] or spec["shape"][0] is not None:
                raise MXNetError(
                    f"{where}: dynamic_batch manifest input {i} has a "
                    f"concrete leading dimension "
                    f"({spec['shape'] or 'scalar'}) — every input must "
                    f"share the symbolic batch dim")
        for i, spec in enumerate(outputs or ()):
            if not spec["shape"] or spec["shape"][0] is not None:
                raise MXNetError(
                    f"{where}: dynamic_batch manifest output {i} is not "
                    f"batch-major ({spec['shape'] or 'scalar'}): the "
                    f"block collapses the batch axis, so serving could "
                    f"not un-pad per-request rows — export with "
                    f"dynamic_batch=False or keep axis 0 the batch")
    return manifest


def _canon_dtype(d):
    """Canonical dtype NAME for comparison: numpy's name, or the bare
    name of a torch dtype (``torch.bfloat16`` -> ``bfloat16``)."""
    name = str(d)
    if name.startswith("torch."):
        return name[len("torch."):]
    try:
        return np.dtype(d).name
    except TypeError:
        return name


def _resolve_dtype(name):
    """Signature dtype NAME -> numpy dtype (the host side of a request);
    an extension dtype numpy lacks raises :class:`MXNetError`."""
    try:
        return np.dtype(name)
    except TypeError:
        raise MXNetError(
            f"signature dtype {name!r} has no numpy counterpart: serve "
            f"requests of this input as a numpy dtype") from None


def _shape_dtype(x):
    """(shape, dtype name) of a numpy array or torch tensor without
    copying."""
    a = x if hasattr(x, "shape") and hasattr(x, "dtype") else np.asarray(x)
    return tuple(a.shape), _canon_dtype(a.dtype)


def validate_inputs(manifest, arrays, where="validate_inputs"):
    """Check caller arrays against a manifest's input signature.

    Raises a descriptive :class:`MXNetError` on arity, dtype, rank, or
    dimension mismatch.  ``null`` dimensions accept any size; with
    ``dynamic_batch`` all leading dimensions must also agree with each
    other (one shared batch)."""
    sig = manifest["inputs"]
    if len(arrays) != len(sig):
        raise MXNetError(
            f"{where}: expected {len(sig)} input(s) per the artifact "
            f"manifest, got {len(arrays)}")
    dynamic = bool(manifest.get("dynamic_batch"))
    lead = None
    for i, (spec, arr) in enumerate(zip(sig, arrays)):
        shape, dtype = _shape_dtype(arr)
        want_shape = list(spec["shape"])
        if dynamic and want_shape:
            want_shape[0] = None
        want_dtype = _canon_dtype(spec["dtype"])
        want_str = "x".join("?" if d is None else str(d)
                            for d in want_shape)
        got_str = "x".join(str(d) for d in shape)
        if dtype != want_dtype:
            raise MXNetError(
                f"{where}: input {i} dtype mismatch — manifest declares "
                f"{want_dtype}[{want_str}], got {dtype}[{got_str}]")
        if len(shape) != len(want_shape):
            raise MXNetError(
                f"{where}: input {i} rank mismatch — manifest declares "
                f"{want_dtype}[{want_str}] ({len(want_shape)}d), got "
                f"{got_str} ({len(shape)}d)")
        for ax, (got, want) in enumerate(zip(shape, want_shape)):
            if want is not None and got != want:
                raise MXNetError(
                    f"{where}: input {i} shape mismatch at axis {ax} — "
                    f"manifest declares {want_dtype}[{want_str}], got "
                    f"{got_str}")
        if dynamic and shape:
            if lead is None:
                lead = shape[0]
            elif shape[0] != lead:
                raise MXNetError(
                    f"{where}: dynamic-batch inputs disagree on the "
                    f"batch dimension ({lead} vs {shape[0]} at input "
                    f"{i}) — it was exported as one shared size")


class StableHLOModel:
    """A loaded artifact plus its serving signature.

    ``module`` is the program as a callable module on ``device`` (made
    once).  ``call(*arrays)`` validates the arrays against the manifest
    (when the artifact shipped one), moves numpy arrays and tensors to
    the device and runs the module under ``torch.no_grad()`` inside the
    ``stablehlo.execute`` span and the ``deploy.execute`` fault site;
    it returns what the module returns (tensors on the device).
    ``exported`` is the loaded ``ExportedProgram``."""

    def __init__(self, exported, manifest, path, content_hash=None,
                 device="cpu"):
        self.exported = exported
        self.manifest = manifest
        self.path = path
        # sha256 of the archive: the artifact's identity
        self.content_hash = content_hash
        self.device = torch.device(device)
        self.module = exported.module()

    @property
    def dynamic_batch(self):
        return bool(self.manifest and self.manifest.get("dynamic_batch"))

    @property
    def quantization(self):
        """The manifest v4 ``quantization`` block (mode, per-tensor
        scales, calibration, digest), or None for a float artifact."""
        return (self.manifest or {}).get("quantization")

    def validate(self, arrays):
        if self.manifest is not None:
            validate_inputs(self.manifest, arrays,
                            where=os.path.basename(
                                _manifest_path(self.path)))

    def call(self, *arrays):
        self.validate(arrays)
        xs = [_as_tensor(a, self.device) for a in arrays]
        with _tr.span("stablehlo.execute", path=self.path):
            _faults.inject("deploy.execute")
            with torch.no_grad():
                return self.module(*xs)

    __call__ = call


def _artifact_devices(exported):
    """Every device the program's weights, constants and traced values
    name (a device baked into an op, as ``aten.to`` of the lengths,
    shows in its value)."""
    devices = {t.device for t in exported.state_dict.values()}
    devices |= {t.device for t in exported.constants.values()
                if isinstance(t, torch.Tensor)}
    for node in exported.graph.nodes:
        val = node.meta.get("val")
        for v in val if isinstance(val, (tuple, list)) else (val,):
            if isinstance(v, torch.Tensor):
                devices.add(v.device)
    return devices


def load_stablehlo(path, device="cuda"):
    """Load an artifact of :func:`export_stablehlo` onto ``device``.

    Returns a :class:`StableHLOModel`: ``.call`` validates inputs against
    the ``.json`` manifest (a shape or dtype mistake raises a clear
    :class:`MXNetError` naming the manifest) and the manifest is the
    serving signature for ``serving.ModelRepository.load_artifact``.  A
    program exported on another device is moved with
    ``torch.export.passes.move_to_device_pass`` (weights, constants and
    devices baked into its ops).  A manifest of another format (the JAX
    package's StableHLO artifacts) is refused; an artifact without a
    manifest loads unchecked.  The process must have imported
    ``mxnet_tpu_torch.ops`` (this module does) for B1's operator."""
    if not os.path.exists(path):
        raise MXNetError(f"no artifact at {path}")
    manifest = load_manifest(path)
    if manifest is not None and manifest.get("format") != ARTIFACT_FORMAT:
        raise MXNetError(
            f"load_stablehlo({path!r}): the manifest's format is "
            f"{manifest.get('format')!r}, not {ARTIFACT_FORMAT!r} — this "
            f"package loads only its own artifacts; re-export the model "
            f"with mxnet_tpu_torch.deploy.export_stablehlo")
    from torch.export.passes import move_to_device_pass
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            digest.update(chunk)
        f.seek(0)
        exported = torch.export.load(f)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _artifact_devices(exported) - {device}:
        exported = move_to_device_pass(exported, device)
    return StableHLOModel(exported, manifest, path,
                          content_hash=digest.hexdigest(), device=device)
