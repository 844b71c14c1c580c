"""KVStore of the PyTorch port: gradient aggregation and weight sync
across contexts and processes (reference: python/mxnet/kvstore/).

The counterpart of ``mxnet_tpu.kvstore.kvstore``:

- ``'local'`` / ``'device'``: reduce the per-context copies in this
  process; the sum lands on the CPU (``local``) or on the first value's
  device (``device``).
- ``'xla'`` (the type string is kept so that code written for the JAX
  package runs unchanged; alias ``'nccl'``): one bucketed all-reduce of
  the per-context copies, keys below ``bigarray_bound``
  (``MXNET_KVSTORE_BIGARRAY_BOUND``) fused into one flat buffer per
  dtype; int8/fp8 compression quantizes each copy's bucket with error
  feedback and sums the dequantized copies in float32.  It cannot run the
  optimizer.  Copies on more than one card are refused with
  ``MXNetError``: that path would be NCCL's single-process collectives,
  and it cannot be shown on a machine with one card.
- ``'dist_sync'`` (aliases ``'dist'``, ``'dist_device_sync'``): over
  ``parallel.dist``; rank 0's ``init`` value wins (``broadcast_host``), a
  push reduces across this process's contexts and then across processes
  (``allreduce_host``).  A gloo group stages CUDA tensors through host
  memory, an NCCL group takes them as they are: ``parallel.dist`` decides
  that from the group's backend, never by retrying.

Compression: ``2bit`` keeps its error-feedback residual; ``int8`` /
``fp8`` use ``quantize.quantize_with_feedback`` / ``dequantize``.
``kvstore.wire.bytes`` counts the payload plus the scales, as the JAX
tiers count them; ``MXNET_KVSTORE_GRAD_COMPRESSION`` sets the default
compression of every store that :func:`create` makes.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..base import MXNetError, get_env
from ..context import cpu
from .. import faults as _faults
from .. import quantize as qz
from .. import runtime_metrics as _rm
from ..ndarray import NDArray
from .base import KVStoreBase

__all__ = ["KVStore", "create"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _nd_bytes(vals) -> int:
    """Logical bytes of a list of arrays (shape x itemsize)."""
    return sum(v._data.numel() * v._data.element_size() for v in vals)


def _normalize(key, value):
    """-> list of (str key, [NDArray per context]) pairs."""
    keys = _as_list(key)
    if len(keys) == 1 and not (isinstance(value, (list, tuple)) and value
                               and isinstance(value[0], (list, tuple))):
        vals = [_as_list(value)]
    else:
        vals = [_as_list(v) for v in value]
    if len(keys) != len(vals):
        raise MXNetError(
            f"kvstore: {len(keys)} keys but {len(vals)} value lists")
    return [(str(k), list(v)) for k, v in zip(keys, vals)]


def _sum_on(vals, device):
    """The sum of the copies' tensors, on ``device``, in order."""
    acc = vals[0]._data.detach().to(device, copy=True)
    for v in vals[1:]:
        acc = acc + v._data.detach().to(device)
    return acc


class _TwoBitCompressor:
    """2-bit sign compression with an error-feedback residual
    (reference: gradient_compression.cc)."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residual = {}

    def compress(self, key, idx, grad):
        thr = self.threshold
        res = self._residual.get((key, idx))
        g = grad if res is None else grad + res
        q = (torch.where(g >= thr, thr, 0.0)
             + torch.where(g <= -thr, -thr, 0.0)).to(grad.dtype)
        self._residual[(key, idx)] = g - q
        return q

    def wire_bytes(self, vals) -> int:
        return _nd_bytes(vals)


class _QuantCompressor:
    """int8 / fp8 blockwise compression of each copy: a quantize ->
    dequantize round trip with an error-feedback residual per (key,
    copy)."""

    def __init__(self, spec: qz.CompressionSpec):
        self.spec = spec
        self._residual = {}
        self._step = 0

    def _key(self, device, idx):
        if not self.spec.stochastic:
            return None
        self._step += 1
        return torch.Generator(device=device).manual_seed(
            self._step * 1009 + idx)

    def compress(self, key, idx, grad):
        res = self._residual.get((key, idx))
        if res is None or res.shape != grad.shape:
            res = torch.zeros(grad.shape, dtype=torch.float32,
                              device=grad.device)
        payload, scales, new_res = qz.quantize_with_feedback(
            grad, res, self.spec, key=self._key(grad.device, idx))
        self._residual[(key, idx)] = new_res
        return qz.dequantize(payload, scales, grad.shape, grad.dtype)

    def wire_bytes(self, vals) -> int:
        return sum(qz.wire_bytes(v.size, self.spec) for v in vals)


class KVStore(KVStoreBase):
    """The classic API: init / push / pull / pushpull.  Subclasses supply
    ``_reduce`` (aggregate the per-context copies)."""

    CAPABILITIES = (KVStoreBase.OPTIMIZER,)

    def __init__(self):
        self._store: "OrderedDict[str, NDArray]" = OrderedDict()
        self._updater = None
        self._optimizer = None
        self._compressor = None

    @property
    def type(self):
        return self._TYPE

    def init(self, key, value):
        for k, vals in _normalize(key, value):
            if k in self._store:
                raise MXNetError(f"kvstore: key {k!r} already initialized")
            self._store[k] = self._pin(vals[0])

    def _pin(self, value: NDArray) -> NDArray:
        """The master copy of a key: a fresh array on the host
        (``local``), never the caller's."""
        return value.copyto(cpu(0))

    def push(self, key, value, priority=0):
        _faults.inject("kvstore.push")
        for k, vals in _normalize(key, value):
            if _rm._ENABLED:
                _rm.KV_PUSH.inc()
                _rm.KV_PUSH_BYTES.inc(_nd_bytes(vals))
                self._count_wire(vals)
            self._push_one(k, vals)

    def _count_wire(self, vals):
        """Wire bytes of one push: the logical bytes, or the compressed
        form's under compression."""
        _rm.KV_WIRE_BYTES.inc(self._compressor.wire_bytes(vals)
                              if self._compressor is not None
                              else _nd_bytes(vals))

    def _push_one(self, k, vals):
        if k not in self._store:
            raise MXNetError(f"kvstore: push to uninitialized key {k!r}")
        merged = self._reduce(k, self._maybe_compress(k, vals))
        stored = self._store[k]
        merged = merged.as_in_context(stored.context)
        if self._updater is not None:
            self._updater(int(k) if k.isdigit() else k, merged, stored)
        else:
            stored._set_data(merged._data.to(stored._data.dtype))

    def _maybe_compress(self, k, vals):
        if self._compressor is None:
            return vals
        with torch.no_grad():
            return [NDArray._wrap(self._compressor.compress(
                k, i, v._data.detach()), v.context)
                for i, v in enumerate(vals)]

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        _faults.inject("kvstore.pull")
        if out is None:
            raise MXNetError("kvstore.pull requires out=")
        for k, outs in _normalize(key, out):
            if k not in self._store:
                raise MXNetError(f"kvstore: pull of uninitialized key {k!r}")
            if _rm._ENABLED:
                _rm.KV_PULL.inc()
                _rm.KV_PULL_BYTES.inc(_nd_bytes(outs))
            for o in outs:
                self._store[k].copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key's value into
        ``out`` (reference: ``KVStore.row_sparse_pull``).  The store
        keeps dense values, so ``out`` gets the gathered rows, dense, on
        its own device and in its dtype, as in the JAX package."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        for (k, outs), (_k, rids) in zip(_normalize(key, out),
                                         _normalize(key, row_ids)):
            if k not in self._store:
                raise MXNetError(f"kvstore: pull of uninitialized key {k!r}")
            stored = self._store[k]._data.detach()
            for o, r in zip(outs, rids):
                idx = r._data.to(device=stored.device, dtype=torch.int64)
                rows = stored.index_select(0, idx)
                o._set_data(rows.to(device=o._data.device,
                                    dtype=o._data.dtype))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def set_optimizer(self, optimizer):
        if not self.is_capable(KVStoreBase.OPTIMIZER):
            raise MXNetError(
                f"kvstore type {self.type!r} cannot run the optimizer "
                f"(update_on_kvstore unsupported)")
        from .. import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """Compress every later push: ``{'type': '2bit', 'threshold':
        t}``, or ``{'type': 'int8'|'fp8', 'block': ..., ...}`` (also a
        spec string such as ``'int8:block=64'`` or a
        ``CompressionSpec``); None turns compression off."""
        if compression_params is None:
            self._compressor = None
            return
        if isinstance(compression_params, qz.CompressionSpec):
            self._compressor = _QuantCompressor(compression_params)
            return
        if isinstance(compression_params, str):
            spec = qz.CompressionSpec.parse(compression_params)
            self._compressor = None if spec is None \
                else _QuantCompressor(spec)
            return
        params = dict(compression_params)
        ctype = params.pop("type", "2bit")
        if ctype == "2bit":
            self._compressor = _TwoBitCompressor(params.pop("threshold",
                                                            0.5))
            if params:
                raise MXNetError(f"unknown compression params {params}")
            return
        if ctype in ("int8", "fp8"):
            self._compressor = _QuantCompressor(
                qz.CompressionSpec.parse(dict(params, type=ctype)))
            return
        raise MXNetError(f"unsupported compression type {ctype!r}")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _reduce(self, k, vals) -> NDArray:
        raise NotImplementedError


@KVStoreBase.register
class Local(KVStore):
    """Reduce on the host."""

    _TYPE = "local"

    def _reduce(self, k, vals):
        return NDArray._wrap(_sum_on(vals, torch.device("cpu")), cpu(0))


@KVStoreBase.register
class Device(KVStore):
    """Reduce on the first value's device."""

    _TYPE = "device"

    def _pin(self, value):
        return value.copy()

    def _reduce(self, k, vals):
        return NDArray._wrap(_sum_on(vals, vals[0]._data.device),
                             vals[0].context)


@KVStoreBase.register
class XLA(KVStore):
    """One bucketed all-reduce of the per-context copies (see the module
    docstring)."""

    _TYPE = "xla"
    CAPABILITIES = ()

    def __init__(self):
        super().__init__()
        # error-feedback residuals of the quantized buckets, keyed by
        # (dtype, bucket keys, total): one float32 vector per copy
        self._ef_residuals = {}
        self.bigarray_bound = int(get_env("MXNET_KVSTORE_BIGARRAY_BOUND",
                                          1 << 19))

    def _pin(self, value):
        return value.copy()

    def _count_wire(self, vals):
        pass        # the bucketed all-reduce counts what it moves

    def _maybe_compress(self, k, vals):
        # int8/fp8 quantize inside the bucketed all-reduce
        if isinstance(self._compressor, _QuantCompressor):
            return vals
        return super()._maybe_compress(k, vals)

    def _reduce(self, k, vals):
        if len(vals) == 1:
            return vals[0]
        return self._fused_allreduce([(k, vals)])[k][0]

    def pushpull(self, key, value, out=None, priority=0):
        """All keys in as few bucketed reductions as possible, the
        results written straight into ``out``."""
        pairs = _normalize(key, value)
        for k, _ in pairs:
            if k not in self._store:
                raise MXNetError(f"kvstore: push to uninitialized key {k!r}")
        if any(len(v) == 1 for _, v in pairs) or self._updater is not None \
                or isinstance(self._compressor, _TwoBitCompressor):
            return super().pushpull(key, value, out, priority)
        _faults.inject("kvstore.pushpull")
        if _rm._ENABLED:
            for _k, vals in pairs:
                _rm.KV_PUSH.inc()
                _rm.KV_PUSH_BYTES.inc(_nd_bytes(vals))
        reduced = self._fused_allreduce(pairs)
        for k, _ in pairs:
            self._store[k]._set_data(reduced[k][0]._data.to(
                self._store[k]._data.dtype))
        if out is not None:
            for k, outs in _normalize(key, out):
                if _rm._ENABLED:
                    _rm.KV_PULL.inc()
                    _rm.KV_PULL_BYTES.inc(_nd_bytes(outs))
                for o, r in zip(outs, reduced[k]):
                    o._set_data(r._data.to(o._data.dtype))

    def _buckets(self, group):
        buckets, cur, cur_elems = [], [], 0
        for k, vals in group:
            n = vals[0].size
            if n >= self.bigarray_bound:
                buckets.append([(k, vals, n)])
                continue
            cur.append((k, vals, n))
            cur_elems += n
            if cur_elems >= self.bigarray_bound:
                buckets.append(cur)
                cur, cur_elems = [], 0
        if cur:
            buckets.append(cur)
        return buckets

    def _fused_allreduce(self, pairs):
        """[(key, [NDArray per copy])] -> {key: [NDArray per copy]}."""
        ndev = len(pairs[0][1])
        ctxs = [v.context for v in pairs[0][1]]
        if len(set(ctxs)) != ndev:
            raise MXNetError("kvstore('xla'): per-key copies must live on "
                             f"distinct contexts, got {ctxs}")
        cards = {v._data.device for v in pairs[0][1]
                 if v._data.device.type == "cuda"}
        if len(cards) > 1:
            raise MXNetError(
                "kvstore('xla'): copies on more than one card need NCCL's "
                "single-process collectives, which the port does not run "
                "yet (one card per process: use 'device' or 'dist_sync')")
        by_dtype = OrderedDict()
        for k, vals in pairs:
            if len(vals) != ndev:
                raise MXNetError(f"kvstore('xla'): key {k!r} has "
                                 f"{len(vals)} copies, expected {ndev}")
            by_dtype.setdefault(vals[0]._data.dtype, []).append((k, vals))
        results = {}
        with torch.no_grad():
            for dtype, group in by_dtype.items():
                quant = self._compressor.spec \
                    if isinstance(self._compressor, _QuantCompressor) \
                    and dtype.is_floating_point else None
                for bucket in self._buckets(group):
                    self._reduce_bucket(bucket, ndev, dtype, quant, ctxs,
                                        results)
        return results

    def _reduce_bucket(self, bucket, ndev, dtype, quant, ctxs, results):
        total = sum(n for _, _, n in bucket)
        flats = [torch.cat([vals[d]._data.detach().reshape(-1)
                            for _, vals, _ in bucket])
                 for d in range(ndev)]
        dev = flats[0].device
        if quant is not None:
            res_key = (dtype, tuple(k for k, _, _ in bucket), total)
            residuals = self._ef_residuals.get(res_key) or [
                torch.zeros(total, dtype=torch.float32, device=dev)
                for _ in range(ndev)]
            acc, new_res = None, []
            for d in range(ndev):
                key = self._compressor._key(dev, d)
                payload, scales, r = qz.quantize_with_feedback(
                    flats[d].to(dev), residuals[d], quant, key=key)
                new_res.append(r)
                part = payload.to(torch.float32) * scales[:, None]
                acc = part if acc is None else acc + part
            self._ef_residuals[res_key] = new_res
            summed = acc.reshape(-1)[:total].to(dtype)
            if _rm._ENABLED:
                _rm.KV_WIRE_BYTES.inc(ndev * qz.wire_bytes(total, quant))
        else:
            summed = flats[0].clone()
            for f in flats[1:]:
                summed = summed + f.to(dev)
            if _rm._ENABLED:
                _rm.KV_WIRE_BYTES.inc(ndev * total * summed.element_size())
        offset = 0
        for k, vals, n in bucket:
            seg = summed[offset:offset + n]
            results[k] = [NDArray._wrap(
                seg.to(vals[d]._data.device, copy=True)
                .reshape(vals[d].shape), ctxs[d]) for d in range(ndev)]
            offset += n


KVStoreBase.register_alias("nccl", XLA)


@KVStoreBase.register
class DistSync(KVStore):
    """Synchronous multi-process tier over ``parallel.dist`` (see the
    module docstring); ``rank`` / ``num_workers`` are the worker's
    identity."""

    _TYPE = "dist_sync"

    def __init__(self):
        super().__init__()
        from ..parallel import dist
        self._dist = dist
        dist.initialize()   # a no-op standalone or when already joined

    def _pin(self, value):
        return value.copy()

    def init(self, key, value):
        # rank 0's value is authoritative, else workers whose initial
        # weights differ would train apart
        super().init(key, value)
        if self._dist.is_initialized():
            for k, _vals in _normalize(key, value):
                stored = self._store[k]
                stored._set_data(self._dist.broadcast_host(
                    stored._data.detach(), root=0))

    @property
    def rank(self):
        return self._dist.rank() if self._dist.is_initialized() else 0

    @property
    def num_workers(self):
        return self._dist.size() if self._dist.is_initialized() else 1

    def _reduce(self, k, vals):
        # across this process's contexts, then across processes
        acc = _sum_on(vals, vals[0]._data.device)
        if self._dist.is_initialized():
            acc = self._dist.allreduce_host(acc)
        return NDArray._wrap(acc, vals[0].context)


KVStoreBase.register_alias("dist_sync", DistSync)
KVStoreBase.register_alias("dist", DistSync)
KVStoreBase.register_alias("dist_device_sync", DistSync)


def create(name="local") -> KVStore:
    """Make a kvstore by type name (reference: ``kvstore.create``).

    ``dist_async`` is unsupported by design: asynchronous
    parameter-server SGD assumes CPU-side per-key optimizers and
    tolerates stale gradients; the synchronous ``'dist_sync'`` tier
    covers the same scale without staleness."""
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    if name.lower() in ("dist_async", "dist_device_async"):
        raise MXNetError(
            f"kvstore type {name!r} is intentionally unsupported on this "
            f"framework: asynchronous parameter-server SGD assumes "
            f"CPU-side per-key optimizers and tolerates gradient "
            f"staleness; the synchronous 'dist_sync' tier covers the same "
            f"scale without staleness.  Use 'dist_sync' instead.  See "
            f"kvstore.create.__doc__.")
    klass = KVStoreBase.kv_registry.get(name.lower())
    if klass is None:
        raise MXNetError(f"unknown kvstore type {name!r}; registered: "
                         f"{sorted(KVStoreBase.kv_registry)}")
    store = klass()
    env_spec = qz.CompressionSpec.from_env()
    if env_spec is not None:
        store.set_gradient_compression(env_spec)
    return store
