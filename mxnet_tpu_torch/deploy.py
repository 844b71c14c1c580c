"""Serving signatures: the manifest validators of the deployment boundary
(docs/frontends.md §2).

The PyTorch port's copy of the framework-free half of
``mxnet_tpu.deploy``: the manifest loader and its structural checks
(``load_manifest``, ``validate_manifest``, ``validate_signature``) and
the request-time guard ``validate_inputs``.  ``serving`` validates every
``predict()`` against an entry's signature with it, and
``ModelRepository.add_function`` checks a hand-written signature with
it at registration.  The artifact half (``export_stablehlo``,
``load_stablehlo``, ``StableHLOModel``) is not ported yet (ROADMAP
item 3a′).

A signature is a list of ``{"shape": [int|null, ...], "dtype": name}``
entries; ``null`` marks a free dimension.  Dtype names are numpy's;
``bfloat16`` and the float8 names (which numpy lacks) are torch's.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .base import MXNetError

__all__ = ["load_manifest", "validate_manifest", "validate_signature",
           "validate_inputs", "QUANT_DTYPES"]

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
