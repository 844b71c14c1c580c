"""INT8 post-training quantization frontend.

The counterpart of ``mxnet_tpu.contrib.quantization`` (reference:
``python/mxnet/contrib/quantization.py``): ``quantize_net`` (Gluon),
``quantize_model`` / ``quantize_graph`` / ``quantize_params`` /
``calib_graph`` (the symbolic path), naive min/max and KL-divergence
("entropy") calibration, over the port's int8 ops
(``ops/quantization.py``: int8 x int8 products accumulated exactly in
float64, so the int32 results are the JAX package's bit for bit).

Calibration runs the float network eagerly (a hybridized network's
CachedOp is bypassed, as the JAX package's hooks see no tracer), and a
hook copies each quantizable layer's input to the host.  The entropy
search (:func:`_get_optimal_threshold`) gives the JAX package's
threshold and KL curve from prefix sums, all candidates in one batched
numpy pass (:func:`_kl_curve`) in place of a Python loop over each
candidate's 255 bins.  Only signed int8 is
supported, as in the JAX package.
"""
from __future__ import annotations

import fnmatch
import logging
from collections import OrderedDict

import numpy as np

from ..base import MXNetError

__all__ = ["quantize_net", "quantize_model", "quantize_graph",
           "CalibrationCollector", "calib_graph"]


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _kl_curve(hist, hist_edges, num_quantized_bins=255):
    """Every candidate threshold of the KL search and its divergence, in
    the JAX package's order (reference: quantization.py
    ``_get_optimal_threshold`` / ``_smooth_distribution``), in one
    batched pass over all candidates.

    ``hist`` is a symmetric histogram of counts around 0.  Candidate
    ``i`` keeps the window of ``2 i + 1`` bins around the zero bin and
    clips the outliers into its two boundary bins (P, over the total
    count T); Q cuts the window into ``num_quantized_bins`` segments
    (``n // num_quantized_bins`` bins each, the last one taking the
    rest) and gives each nonzero bin its segment's mean count, over Q's
    sum ``qs``.  A candidate whose Q sums to 0 is skipped.

    Segment sums and nonzero counts come from integer prefix sums, so
    they are exact (the JAX package's float sums of integer counts are
    too).  An interior nonzero bin k of segment j adds
    ``p_k log p_k - p_k log mean_j + p_k log qs``: the first terms come
    from an extended-precision prefix sum over the histogram, the
    second from the segments, the third from the window's interior
    count; the two boundary bins are computed as the JAX package does.
    The divergences agree with its loop to about 1e-12 relative."""
    h = np.asarray(hist).astype(np.int64)
    nq = num_quantized_bins
    zero_bin = len(h) // 2
    cand = np.arange(nq // 2 + 1, zero_bin + 1)
    if cand.size == 0:
        return [], []
    total = int(h.sum())
    t = float(max(total, 1e-12))
    csum = np.concatenate([[0], np.cumsum(h)])
    cnz = np.concatenate([[0], np.cumsum(h != 0)])
    hp = h / t
    f = np.where(h > 0, hp * np.log(np.where(h > 0, hp, 1.0)), 0.0)
    flog = np.concatenate([[0], np.cumsum(f.astype(np.longdouble))])
    lo, hi = zero_bin - cand, zero_bin + cand + 1        # [lo, hi)
    merged = (hi - lo) // nq
    starts = lo[:, None] + np.arange(nq)[None, :] * merged[:, None]
    ends = starts + merged[:, None]
    ends[:, -1] = hi
    seg_sum = csum[ends] - csum[starts]
    seg_nz = cnz[ends] - cnz[starts]
    mean = seg_sum / np.maximum(seg_nz, 1)               # 0 if empty
    qs = (seg_nz * mean).sum(axis=1)
    # the interior bins' share of each segment
    inner = seg_sum.astype(np.float64)
    inner[:, 0] -= h[lo]
    inner[:, -1] -= h[hi - 1]
    log_mean = np.log(np.where(mean > 0, mean, 1.0))
    safe_qs = np.where(qs > 0, qs, 1.0)
    kl = (flog[hi - 1] - flog[lo + 1]
          - ((inner / t).astype(np.longdouble) * log_mean).sum(axis=1)
          + ((csum[hi - 1] - csum[lo + 1]) / t) * np.log(safe_qs))
    for k, outlier, j in ((lo, csum[lo], 0),
                          (hi - 1, total - csum[hi], -1)):
        pk = (h[k] + outlier) / t
        qk = np.where(h[k] != 0, mean[:, j] / safe_qs, 0.0)
        qk = np.where(qk == 0, 1e-10, qk)
        kl = kl + np.where(pk != 0, pk * np.log(
            np.where(pk != 0, pk, 1.0) / qk), 0.0)
    keep = qs != 0
    edges = np.asarray(hist_edges)
    return ([float(e) for e in edges[hi[keep]]],
            [float(v) for v in kl[keep]])


def _kl_one(hist, i, num_quantized_bins=255):
    """Candidate ``i``'s divergence in the JAX package's own arithmetic
    (its loop's operations in its order, the 255 segments as numpy
    segment sums), for the candidates that decide the search."""
    hist = np.asarray(hist)
    zero_bin = len(hist) // 2
    p_start, p_stop = zero_bin - i, zero_bin + i + 1
    sliced = hist[p_start:p_stop].astype(np.float64)
    n = len(sliced)
    p = sliced.copy()
    p[0] += hist[:p_start].sum()
    p[-1] += hist[p_stop:].sum()
    is_nonzero = p != 0
    starts = np.arange(num_quantized_bins) * (n // num_quantized_bins)
    sums = np.add.reduceat(sliced, starts)
    nzs = np.add.reduceat((sliced != 0).astype(np.int64), starts)
    q = np.repeat(sums / np.maximum(nzs, 1),
                  np.diff(np.append(starts, n)))
    q[sliced == 0] = 0.0
    p /= max(p.sum(), 1e-12)
    q /= q.sum()
    q[q == 0] = 1e-10
    return float(np.sum(p[is_nonzero]
                        * np.log(p[is_nonzero] / q[is_nonzero])))


def _get_optimal_threshold(hist, hist_edges, num_quantized_bins=255):
    """The |threshold| minimizing KL(P || Q) over :func:`_kl_curve`'s
    candidates (the last edge when there is none).  The candidates
    within 1e-9 of the smallest divergence are computed again in the
    JAX package's arithmetic (:func:`_kl_one`) and the first smallest
    wins, so that exact ties (windows that quantize alike) resolve as
    its ``argmin`` does."""
    thresholds, divergences = _kl_curve(hist, hist_edges,
                                        num_quantized_bins)
    if not thresholds:
        return float(hist_edges[-1])
    kl = np.asarray(divergences)
    near = np.nonzero(kl <= kl.min() * (1 + 1e-9) + 1e-300)[0]
    if len(near) == 1:
        return thresholds[int(near[0])]
    edges = np.asarray(hist_edges)
    zero_bin = len(hist) // 2
    exact = []
    for k in near:
        # the candidate whose window ends at this threshold's edge
        i = int(np.searchsorted(edges, thresholds[k])) - zero_bin - 1
        exact.append(_kl_one(hist, i, num_quantized_bins))
    return thresholds[int(near[int(np.argmin(exact))])]


class CalibrationCollector:
    """Accumulates per-tensor calibration statistics across batches
    (reference: _LayerOutputMinMaxCollector / _LayerHistogramCollector)."""

    def __init__(self, mode="naive", num_bins=8001):
        if mode not in ("naive", "entropy"):
            raise MXNetError(f"calib_mode must be naive|entropy, got {mode}")
        self.mode = mode
        self.num_bins = num_bins
        self.min_max = OrderedDict()        # name -> (min, max)
        self.hists = OrderedDict()          # name -> (hist, edges)

    def collect(self, name, arr):
        a = np.asarray(arr, np.float32)
        mn, mx = float(a.min()), float(a.max())
        old = self.min_max.get(name)
        if old is not None:
            mn, mx = min(mn, old[0]), max(mx, old[1])
        self.min_max[name] = (mn, mx)
        if self.mode == "entropy":
            amax = max(abs(mn), abs(mx), 1e-8)
            prev = self.hists.get(name)
            if prev is not None and prev[1][-1] >= amax:
                hist, edges = np.histogram(a, bins=prev[1])
                self.hists[name] = (prev[0] + hist, prev[1])
            else:
                edges = np.linspace(-amax, amax, self.num_bins + 1)
                hist, _ = np.histogram(a, bins=edges)
                if prev is not None:
                    # re-bin the old histogram into the wider range
                    centers = (prev[1][:-1] + prev[1][1:]) / 2
                    rebin, _ = np.histogram(centers, bins=edges,
                                            weights=prev[0])
                    hist = hist + rebin.astype(hist.dtype)
                self.hists[name] = (hist, edges)

    def ranges(self):
        """Final calibration ranges per collected tensor."""
        out = OrderedDict()
        for name, (mn, mx) in self.min_max.items():
            if self.mode == "entropy":
                hist, edges = self.hists[name]
                t = _get_optimal_threshold(hist, edges)
                out[name] = (-t, t)
            else:
                out[name] = (mn, mx)
        return out


# ---------------------------------------------------------------------------
# Gluon path: quantize_net
# ---------------------------------------------------------------------------

def _quantize_param(p):
    """Quantize one fp32 parameter offline → (int8 NDArray, min, max)."""
    from .. import ndarray as nd
    data = p if isinstance(p, nd.NDArray) else p.data()
    q, mn, mx = nd.quantize_v2(data.astype("float32"))
    return q, mn, mx


def _make_quantized_blocks():
    """Defer gluon import to avoid a cycle at package import time."""
    from ..gluon.block import HybridBlock

    class QuantizedDense(HybridBlock):
        """int8 replacement for nn.Dense built by quantize_net
        (reference: the quantized_fully_connected subgraph)."""

        def __init__(self, dense, calib_range, **kwargs):
            super().__init__(**kwargs)
            from .. import ndarray as nd
            self._units = dense._units
            self._flatten = dense._flatten
            self._activation = dense._activation
            self._calib = calib_range      # None = dynamic per-batch range
            self._qweight, self._wmin, self._wmax = \
                _quantize_param(dense.weight)
            if dense.bias is not None:
                self._qbias, self._bmin, self._bmax = \
                    _quantize_param(dense.bias)
            else:
                self._qbias = None

        def hybrid_forward(self, F, x):
            from .. import ndarray as nd
            if self._calib is not None:
                qx, xmn, xmx = nd.quantize_v2(
                    x, min_calib_range=self._calib[0],
                    max_calib_range=self._calib[1])
            else:
                qx, xmn, xmx = nd.quantize_v2(x)
            if self._qbias is not None:
                out32, omn, omx = nd.quantized_fully_connected(
                    qx, self._qweight, self._qbias, xmn, xmx,
                    self._wmin, self._wmax, self._bmin, self._bmax,
                    num_hidden=self._units, flatten=self._flatten)
            else:
                out32, omn, omx = nd.quantized_fully_connected(
                    qx, self._qweight, None, xmn, xmx,
                    self._wmin, self._wmax, None, None,
                    num_hidden=self._units, flatten=self._flatten,
                    no_bias=True)
            out = nd.dequantize(out32, omn, omx)
            if self._activation is not None:
                out = nd.Activation(out, act_type=self._activation)
            return out

    class QuantizedConv(HybridBlock):
        """int8 replacement for nn.Conv2D/Conv1D/Conv3D
        (reference: the quantized_conv subgraph)."""

        def __init__(self, conv, calib_range, **kwargs):
            super().__init__(**kwargs)
            self._kernel = conv._kernel
            self._strides = conv._strides
            self._padding = conv._padding
            self._dilation = conv._dilation
            self._groups = conv._groups
            self._channels = conv._channels
            self._activation = conv._activation
            self._calib = calib_range
            self._qweight, self._wmin, self._wmax = \
                _quantize_param(conv.weight)
            if conv.bias is not None:
                self._qbias, self._bmin, self._bmax = \
                    _quantize_param(conv.bias)
            else:
                self._qbias = None

        def hybrid_forward(self, F, x):
            from .. import ndarray as nd
            if self._calib is not None:
                qx, xmn, xmx = nd.quantize_v2(
                    x, min_calib_range=self._calib[0],
                    max_calib_range=self._calib[1])
            else:
                qx, xmn, xmx = nd.quantize_v2(x)
            args = dict(kernel=self._kernel, stride=self._strides,
                        dilate=self._dilation, pad=self._padding,
                        num_filter=self._channels, num_group=self._groups)
            if self._qbias is not None:
                out32, omn, omx = nd.quantized_conv(
                    qx, self._qweight, self._qbias, xmn, xmx,
                    self._wmin, self._wmax, self._bmin, self._bmax, **args)
            else:
                out32, omn, omx = nd.quantized_conv(
                    qx, self._qweight, None, xmn, xmx,
                    self._wmin, self._wmax, None, None,
                    no_bias=True, **args)
            out = nd.dequantize(out32, omn, omx)
            if self._activation is not None:
                out = nd.Activation(out, act_type=self._activation)
            return out

    return QuantizedDense, QuantizedConv


def _walk_candidates(block, exclude_layers, exclude_layers_match, prefix=""):
    """Yield (parent, child_key, attr_name, layer, path) for every
    quantizable layer (Dense / forward Conv)."""
    from ..gluon import nn
    for key, child in list(block._children.items()):
        path = f"{prefix}{key}"
        is_dense = isinstance(child, nn.Dense)
        is_conv = isinstance(child, (nn.Conv1D, nn.Conv2D, nn.Conv3D))
        if is_dense or is_conv:
            name = child.name
            if exclude_layers and name in exclude_layers:
                continue
            if exclude_layers_match and any(
                    fnmatch.fnmatch(name, pat) or pat in name
                    for pat in exclude_layers_match):
                continue
            attr = None
            for k, v in block.__dict__.items():
                if v is child:
                    attr = k
                    break
            yield block, key, attr, child, path
        else:
            yield from _walk_candidates(child, exclude_layers,
                                        exclude_layers_match, path + ".")


def quantize_net(network, quantized_dtype="int8", quantize_mode="full",
                 exclude_layers=None, exclude_layers_match=None,
                 calib_data=None, data_shapes=None, calib_mode="none",
                 num_calib_batches=None, ctx=None, logger=None):
    """Quantize a Gluon network in place-of (reference: quantize_net).

    calib_mode:
      'none'    — dynamic: every batch computes its own input ranges.
      'naive'   — min/max over ``calib_data`` batches.
      'entropy' — KL-optimal thresholds over ``calib_data`` batches.
    Returns the same network object with Dense/Conv children swapped for
    int8 blocks; the original blocks' fp32 weights are quantized offline.
    """
    if quantized_dtype != "int8":
        raise MXNetError("only int8 is supported")
    logger = logger or logging.getLogger(__name__)
    QuantizedDense, QuantizedConv = _make_quantized_blocks()
    from ..gluon import nn

    cands = list(_walk_candidates(network, exclude_layers,
                                  exclude_layers_match))
    if not cands:
        raise MXNetError("quantize_net: no quantizable Dense/Conv layers "
                         "found (or all excluded)")

    calib_ranges = {}
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} needs calib_data")
        collector = CalibrationCollector(mode=calib_mode)
        handles = []
        for _, _, _, layer, path in cands:
            def mk(path):
                def pre_hook(blk, args):
                    collector.collect(path, args[0].asnumpy())
                return pre_hook
            layer._forward_pre_hooks.append(mk(path))
            handles.append(layer)
        # eager forwards: a hybridized network's CachedOp would run the
        # hooks inside its program, where a host read cannot be captured
        from ..gluon.cached_op import _TRACING
        tok = _TRACING.set(True)
        try:
            for i, batch in enumerate(calib_data):
                if num_calib_batches is not None and i >= num_calib_batches:
                    break
                data = batch[0] if isinstance(batch, (list, tuple)) \
                    else batch
                network(data)
        finally:
            _TRACING.reset(tok)
            for layer in handles:
                layer._forward_pre_hooks.pop()
        calib_ranges = collector.ranges()
        logger.info("calibrated %d tensors (%s)", len(calib_ranges),
                    calib_mode)
    elif calib_mode != "none":
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")

    n = 0
    for parent, key, attr, layer, path in cands:
        crange = calib_ranges.get(path)
        if isinstance(layer, nn.Dense):
            qblock = QuantizedDense(layer, crange)
        else:
            qblock = QuantizedConv(layer, crange)
        parent._children[key] = qblock
        if attr is not None:
            parent.__dict__[attr] = qblock
        n += 1
    logger.info("quantized %d layers", n)
    return network


# ---------------------------------------------------------------------------
# Symbolic path: quantize_model / quantize_graph
# ---------------------------------------------------------------------------

_QUANTIZABLE = {"FullyConnected": "_contrib_quantized_fully_connected",
                "Convolution": "_contrib_quantized_conv"}


def quantize_graph(sym, excluded_sym_names=(), calib_ranges=None):
    """Rewrite a Symbol graph: each FullyConnected/Convolution becomes a
    quantize→quantized-op→dequantize sandwich (reference: the C++
    QuantizeGraph pass driven from quantize_model).

    Returns (qsym, needed_param_transforms) where the latter maps
    ``weight_name -> base_name`` for every weight/bias variable that
    ``quantize_params`` must convert to int8 + range scalars.
    """
    from ..ops.registry import get_op
    from ..symbol.symbol import Symbol, _SymNode, var

    calib_ranges = calib_ranges or {}
    excluded = set(excluded_sym_names)
    mapping = {}                      # id(old node) -> new node
    param_transforms = {}

    def mapped(entry):
        node, idx = entry
        return (mapping[id(node)], idx)

    for node in sym._topo():
        if node.is_variable:
            mapping[id(node)] = node
            continue
        new_inputs = [mapped(e) for e in node.inputs]
        opname = node.op.name
        if opname in _QUANTIZABLE and node.name not in excluded:
            qop = get_op(_QUANTIZABLE[opname])
            data_e = new_inputs[0]
            weight_e = new_inputs[1]
            no_bias = bool(node.kwargs.get("no_bias", False))
            bias_e = None if no_bias or len(new_inputs) < 3 \
                else new_inputs[2]
            if not weight_e[0].is_variable or (
                    bias_e is not None and not bias_e[0].is_variable):
                # weight produced by another op — leave the node fp32
                mapping[id(node)] = _SymNode(node.op, new_inputs,
                                             dict(node.kwargs), node.name,
                                             node.num_outputs)
                continue
            # offline-quantized weight/bias variables
            wname = weight_e[0].name
            param_transforms[wname] = wname
            qw = var(wname + "_quantize")._outputs[0][0]
            wmn = var(wname + "_min")._outputs[0][0]
            wmx = var(wname + "_max")._outputs[0][0]
            if bias_e is not None:
                bname = bias_e[0].name
                param_transforms[bname] = bname
                qb = var(bname + "_quantize")._outputs[0][0]
                bmn = var(bname + "_min")._outputs[0][0]
                bmx = var(bname + "_max")._outputs[0][0]
            # runtime-quantized data input
            qkw = {}
            crange = calib_ranges.get(node.name)
            if crange is not None:
                qkw = {"min_calib_range": float(crange[0]),
                       "max_calib_range": float(crange[1])}
            qdata = _SymNode(get_op("_contrib_quantize_v2"), [data_e], qkw,
                             node.name + "_quantize", 3)
            qinputs = [(qdata, 0),
                       (qw, 0),
                       (qb, 0) if bias_e is not None else (qdata, 0),
                       (qdata, 1), (qdata, 2), (wmn, 0), (wmx, 0)]
            qkwargs = dict(node.kwargs)
            if bias_e is not None:
                qinputs += [(bmn, 0), (bmx, 0)]
            else:
                qinputs += [(qdata, 1), (qdata, 2)]
                qkwargs["no_bias"] = True
            qnode = _SymNode(qop, qinputs, qkwargs,
                             "quantized_" + node.name, 3)
            deq = _SymNode(get_op("_contrib_dequantize"),
                           [(qnode, 0), (qnode, 1), (qnode, 2)], {},
                           node.name, 1)
            mapping[id(node)] = deq
        else:
            mapping[id(node)] = _SymNode(node.op, new_inputs,
                                         dict(node.kwargs), node.name,
                                         node.num_outputs)
    qsym = Symbol([mapped(e) for e in sym._outputs])
    return qsym, param_transforms


def quantize_params(qsym, arg_params):
    """Produce the quantized arg dict for a rewritten graph (reference:
    quantize_params): every ``X_quantize`` variable gets int8 data plus
    ``X_min``/``X_max`` scalars; untouched fp32 params pass through."""
    needed = set(qsym.list_arguments())
    out = {}
    for name, value in arg_params.items():
        if name + "_quantize" in needed:
            q, mn, mx = _quantize_param(value)
            out[name + "_quantize"] = q
            out[name + "_min"] = mn
            out[name + "_max"] = mx
        elif name in needed:
            out[name] = value
    return out


def calib_graph(sym, arg_params, aux_params, calib_data, data_names=("data",),
                calib_mode="naive", num_calib_batches=None):
    """Collect per-quantizable-node input ranges by evaluating the fp32
    graph's internals over calibration batches (reference: the
    collect_layer_output step of quantize_model)."""
    collector = CalibrationCollector(mode=calib_mode)
    internals = sym.get_internals()
    out_names = internals.list_outputs()
    # which internal outputs feed quantizable nodes, keyed by consumer name
    wanted = {}                      # internal output index -> node name
    topo = sym._topo()
    index_of = {}
    k = 0
    for n in topo:
        for i in range(n.num_outputs):
            index_of[(id(n), i)] = k
            k += 1
    for node in topo:
        if not node.is_variable and node.op.name in _QUANTIZABLE:
            src, si = node.inputs[0]
            wanted[index_of[(id(src), si)]] = node.name
    for bi, batch in enumerate(calib_data):
        if num_calib_batches is not None and bi >= num_calib_batches:
            break
        if not isinstance(batch, (list, tuple)):
            batch = (batch,)
        feed = dict(arg_params)
        feed.update(aux_params or {})
        feed.update(dict(zip(data_names, batch)))
        outs = internals.eval(**feed)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for idx, consumer in wanted.items():
            collector.collect(consumer, outs[idx].asnumpy())
    return collector.ranges()


def quantize_model(sym, arg_params, aux_params=None, data_names=("data",),
                   ctx=None, excluded_sym_names=None, calib_mode="none",
                   calib_data=None, num_calib_examples=None,
                   num_calib_batches=None, quantized_dtype="int8",
                   logger=None):
    """Quantize a symbolic model (reference: contrib.quantization
    .quantize_model).  Returns (qsym, qarg_params, aux_params)."""
    if quantized_dtype != "int8":
        raise MXNetError("only int8 is supported")
    aux_params = aux_params or {}
    calib_ranges = None
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} needs calib_data")
        calib_ranges = calib_graph(sym, arg_params, aux_params, calib_data,
                                   data_names, calib_mode,
                                   num_calib_batches)
    elif calib_mode != "none":
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    qsym, _ = quantize_graph(sym, excluded_sym_names or (), calib_ranges)
    qargs = quantize_params(qsym, arg_params)
    # the new variables carry their shapes and dtypes, so that a Module
    # binds the quantized graph from the data shapes alone
    for node in qsym._topo():
        value = qargs.get(node.name)
        if node.is_variable and value is not None \
                and node.name not in arg_params:
            node.attrs["__shape__"] = str(tuple(value.shape))
            node.attrs["__dtype__"] = str(value.dtype)
    return qsym, qargs, aux_params
