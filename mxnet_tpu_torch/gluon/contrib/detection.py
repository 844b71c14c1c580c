"""Two-stage detection building blocks of the PyTorch port: FPN, RPN,
Faster R-CNN (the counterpart of ``mxnet_tpu.gluon.contrib.detection``;
reference surface: GluonCV ``model_zoo/fpn`` / ``model_zoo/faster_rcnn``,
built from upstream MXNet's ROIAlign and box ops).

Everything is static-shape, as in the JAX package: proposal selection is
a top-k and a fixed number of rounds of mask-based NMS (no data-dependent
box counts, so no host read and nothing a CUDA graph could not hold), and
second-stage training scores every kept proposal rather than a random
subset.  The JAX package's ``vmap`` over images becomes batched tensor
ops, and its ``lax.scan`` over NMS rounds a loop of ``topk`` rounds.

Ties: ``lax.top_k`` and ``jnp.argmax`` take the lowest index among equal
values.  ``torch.argmax`` does so too (documented); ``torch.topk`` does
not promise it, so the proposals' top-k is a stable descending sort.  In
NMS the suppressed slots score ``-inf``: once every slot is suppressed
the pick is slot 0 (the top box), and ``keep`` masks those duplicates.

The box helpers take tensors (numpy arrays and NDArrays are converted)
and return tensors; the losses and the pyramid ROIAlign are single
operators through the registry, so ``autograd.record()`` tapes them and
the second stage's gradient reaches the FPN and the backbone.
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock

__all__ = ["FPN", "AnchorGenerator", "RPNHead", "box_iou",
           "decode_deltas", "encode_deltas", "nms_static",
           "fpn_level_index", "RCNNBoxHead", "FasterRCNN"]


def _t(x, device=None):
    """A tensor of ``x`` (a tensor, NDArray or numpy array)."""
    from ...ndarray import NDArray
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x if device is None else x.to(device)


class FPN(HybridBlock):
    """Feature Pyramid Network neck (GluonCV ``FPNFeatureExpander``):
    lateral 1x1 on each backbone stage, top-down nearest upsample, 3x3
    smoothing; highest level optionally downsampled to P6."""

    def __init__(self, in_channels, channels=256, use_p6=True, **kwargs):
        super().__init__(**kwargs)
        self._n = len(in_channels)
        self._use_p6 = use_p6
        with self.name_scope():
            self.laterals = nn.HybridSequential()
            self.smooths = nn.HybridSequential()
            for c in in_channels:
                self.laterals.add(nn.Conv2D(channels, 1, in_channels=c))
                self.smooths.add(nn.Conv2D(channels, 3, padding=1,
                                           in_channels=channels))

    def hybrid_forward(self, F, *feats):
        if len(feats) != self._n:
            raise MXNetError(f"FPN expects {self._n} feature maps, "
                             f"got {len(feats)}")
        laterals = [lat(x) for lat, x in zip(self.laterals, feats)]
        outs = [laterals[-1]]
        for lvl in range(self._n - 2, -1, -1):
            up = F.UpSampling(outs[0], scale=2, sample_type="nearest",
                              num_args=1)
            # crop in case the lower level has odd spatial dims
            up = F.slice_like(up, laterals[lvl], axes=(2, 3))
            outs.insert(0, laterals[lvl] + up)
        outs = [sm(x) for sm, x in zip(self.smooths, outs)]
        if self._use_p6:
            outs.append(F.Pooling(outs[-1], kernel=(2, 2), stride=(2, 2),
                                  pool_type="max"))
        return tuple(outs)


class AnchorGenerator:
    """Dense grid anchors per pyramid level, corner (x1,y1,x2,y2) in
    pixels (GluonCV ``RPNAnchorGenerator``)."""

    def __init__(self, strides, sizes, ratios=(0.5, 1.0, 2.0)):
        if len(strides) != len(sizes):
            raise MXNetError("strides and sizes must align per level")
        self.strides = tuple(strides)
        self.sizes = tuple(sizes)
        self.ratios = tuple(ratios)
        self.num_anchors = len(ratios)

    def level(self, lvl, H, W):
        """(H*W*num_ratios, 4) numpy anchors for one level."""
        stride, size = self.strides[lvl], self.sizes[lvl]
        ws = np.array([size * np.sqrt(1.0 / r) for r in self.ratios])
        hs = np.array([size * np.sqrt(r) for r in self.ratios])
        cx = (np.arange(W) + 0.5) * stride
        cy = (np.arange(H) + 0.5) * stride
        cxg, cyg = np.meshgrid(cx, cy)                  # (H, W)
        ctrs = np.stack([cxg, cyg], axis=-1).reshape(-1, 1, 2)
        wh = np.stack([ws, hs], axis=-1).reshape(1, -1, 2)
        boxes = np.concatenate([ctrs - wh / 2, ctrs + wh / 2], axis=-1)
        return boxes.reshape(-1, 4).astype(np.float32)


class RPNHead(HybridBlock):
    """Shared conv3x3 + objectness/delta 1x1s applied to every level
    (GluonCV ``RPNHead``)."""

    def __init__(self, channels=256, num_anchors=3, **kwargs):
        super().__init__(**kwargs)
        self._na = num_anchors
        with self.name_scope():
            self.conv = nn.Conv2D(channels, 3, padding=1,
                                  in_channels=channels,
                                  activation="relu")
            self.obj = nn.Conv2D(num_anchors, 1, in_channels=channels)
            self.reg = nn.Conv2D(num_anchors * 4, 1, in_channels=channels)

    def hybrid_forward(self, F, x):
        t = self.conv(x)
        # (B, A, H, W) -> (B, H*W*A); (B, 4A, H, W) -> (B, H*W*A, 4)
        obj = F.transpose(self.obj(t), axes=(0, 2, 3, 1)) \
            .reshape((x.shape[0], -1))
        reg = F.transpose(self.reg(t), axes=(0, 2, 3, 1)) \
            .reshape((x.shape[0], -1, 4))
        return obj, reg


# ------------------------------------------------------------ box helpers
def box_iou(a, b):
    """IoU of corner boxes: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    a, b = _t(a), _t(b)
    a, b = a[..., :, None, :], b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def encode_deltas(anchors, gt):
    """Box regression targets (tx,ty,tw,th) — R-CNN parameterization.
    Degenerate (zero-area) anchors/rois are clamped so they encode to
    finite garbage rather than inf/nan — callers mask them out, and
    0 * inf would poison the loss otherwise."""
    anchors, gt = _t(anchors), _t(gt)
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-6)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-6)
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-6)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-6)
    gx = gt[..., 0] + gw / 2
    gy = gt[..., 1] + gh / 2
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


def decode_deltas(anchors, deltas):
    """Inverse of encode_deltas -> corner boxes."""
    anchors, deltas = _t(anchors), _t(deltas)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _take(x, idx):
    """``x[..., idx, :]`` per leading index: x (..., N, k), idx (..., R)."""
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


def nms_static(boxes, scores, topk, iou_thr=0.7):
    """Static-shape NMS over boxes (..., N, 4), scores (..., N): returns
    (boxes (..., topk, 4), scores (..., topk), keep (..., topk)).
    ``topk`` rounds of greedy suppression over masked scores (suppressed
    slots keep score -inf, module docstring on ties)."""
    boxes, scores = _t(boxes), _t(scores)
    iou = box_iou(boxes, boxes)
    n = scores.shape[-1]
    ar = torch.arange(n, device=scores.device)
    live = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    neg = torch.tensor(float("-inf"), dtype=scores.dtype,
                       device=scores.device)
    picks, keeps = [], []
    for _ in range(int(topk)):
        masked = torch.where(live, scores, neg)
        i = torch.argmax(masked, dim=-1, keepdim=True)          # (..., 1)
        keeps.append(torch.gather(masked, -1, i)[..., 0] > neg)
        picks.append(i[..., 0])
        row = torch.gather(iou, -2, i[..., None].expand(
            *i.shape, n))[..., 0, :]                            # (..., N)
        # suppress everything overlapping the pick (including itself)
        live = live & ~(row > iou_thr) & (ar != i)
    idx = torch.stack(picks, dim=-1)
    keep = torch.stack(keeps, dim=-1)
    out_scores = torch.where(keep, torch.gather(scores, -1, idx), neg)
    return _take(boxes, idx), out_scores, keep


def _match_gt(boxes, gt_boxes):
    """IoU-match fixed boxes (..., N, 4) against (possibly
    zero-area-padded) gt (..., G, 4): -> (best_iou (..., N), best_gt
    (..., N)).  Shared by the RPN and ROI-head target assignment so the
    matching rule cannot drift between them."""
    iou = box_iou(boxes, gt_boxes)
    valid_gt = (gt_boxes[..., 2] > gt_boxes[..., 0]) & \
        (gt_boxes[..., 3] > gt_boxes[..., 1])
    iou = torch.where(valid_gt[..., None, :], iou, torch.zeros_like(iou))
    return iou.max(dim=-1).values, torch.argmax(iou, dim=-1)


def _smooth_l1(diff):
    """Huber/smooth-L1 summed over the last axis."""
    return torch.where(torch.abs(diff) < 1.0, 0.5 * diff * diff,
                       torch.abs(diff) - 0.5).sum(dim=-1)


def fpn_level_index(w, h, n_levels, base_level=3):
    """Canonical FPN ROI-to-level routing (k0=4, 224-canonical):
    ``k = floor(4 + log2(sqrt(wh)/224))`` is the ABSOLUTE pyramid
    level; subtract ``base_level`` (P3 = stride 2^3 is list index 0)
    before indexing the level list."""
    w, h = _t(w), _t(h)
    k = torch.floor(4 + torch.log2(torch.sqrt(torch.clamp(w * h, min=1.0))
                                   / 224.0 + 1e-6))
    return torch.clamp(k - base_level, 0, n_levels - 1).to(torch.int32)


class RCNNBoxHead(HybridBlock):
    """ROI feature -> (class scores, per-class deltas) (GluonCV
    ``FasterRCNN`` top: two FCs + parallel cls/reg)."""

    def __init__(self, num_classes, channels=256, roi_size=7,
                 hidden=1024, **kwargs):
        super().__init__(**kwargs)
        self._nc = num_classes
        in_units = channels * roi_size * roi_size
        with self.name_scope():
            self.fc1 = nn.Dense(hidden, activation="relu",
                                in_units=in_units)
            self.fc2 = nn.Dense(hidden, activation="relu",
                                in_units=hidden)
            self.cls = nn.Dense(num_classes + 1, in_units=hidden)
            self.reg = nn.Dense(num_classes * 4, in_units=hidden)

    def hybrid_forward(self, F, roi_feats):
        x = self.fc2(self.fc1(F.Flatten(roi_feats)))
        return self.cls(x), self.reg(x).reshape((-1, self._nc, 4))


def _op(name, fn, n_in):
    from ...ops.registry import OpDef
    return OpDef(name, fn, n_in, 1, True)


class FasterRCNN(HybridBlock):
    """Minimal but complete two-stage detector over a caller-supplied
    multi-scale feature extractor.

    ``features(x) -> tuple of (B,C,H,W)`` stages (e.g. resnet C3-C5);
    this block adds FPN, RPN, static top-k proposal selection + NMS,
    level-assigned ROIAlign, and the box head.  ``rpn_targets`` /
    ``rpn_loss`` provide the first-stage training path (static-shape
    IoU matching — one program every step).
    """

    def __init__(self, features, in_channels, num_classes,
                 image_size=(256, 256), channels=64, roi_size=7,
                 rpn_pre_topk=256, rpn_post_topk=64, ratios=(0.5, 1, 2),
                 **kwargs):
        super().__init__(**kwargs)
        self._nc = num_classes
        self._roi = roi_size
        self._pre = rpn_pre_topk
        self._post = rpn_post_topk
        n_levels = len(in_channels) + 1                 # + P6
        strides = tuple(2 ** (i + 3) for i in range(n_levels))
        sizes = tuple(2 ** (i + 5) for i in range(n_levels))
        self.anchors = AnchorGenerator(strides, sizes, ratios)
        self._image_size = image_size
        # (device, level shapes) -> the anchors as a tensor
        self._anchor_tensors = {}
        with self.name_scope():
            self.features = features
            self.fpn = FPN(in_channels, channels)
            self.rpn = RPNHead(channels, self.anchors.num_anchors)
            self.box_head = RCNNBoxHead(num_classes, channels, roi_size)

    # -------------------------------------------------------------- plumbing
    def _levels(self, x):
        feats = self.features(x)
        return self.fpn(*feats)

    def _flat_anchors(self, levels):
        anchors = [self.anchors.level(i, f.shape[2], f.shape[3])
                   for i, f in enumerate(levels)]
        return np.concatenate(anchors, axis=0)          # (N, 4)

    def _anchor_tensor(self, anchors, device):
        """``anchors`` on ``device``, copied there once per shape."""
        key = (str(device), anchors.shape)
        t = self._anchor_tensors.get(key)
        if t is None:
            t = self._anchor_tensors[key] = torch.as_tensor(anchors).to(
                device)
        return t

    def rpn_forward(self, x):
        """-> (levels, anchors (N,4) np, obj (B,N), deltas (B,N,4))."""
        from ... import nd
        levels = self._levels(x)
        anchors = self._flat_anchors(levels)
        objs, regs = [], []
        for f in levels:
            o, r = self.rpn(f)
            objs.append(o)
            regs.append(r)
        obj = nd.concat(*objs, dim=1) if len(objs) > 1 else objs[0]
        reg = nd.concat(*regs, dim=1) if len(regs) > 1 else regs[0]
        return levels, anchors, obj, reg

    def proposals(self, anchors, obj, reg):
        """Static top-k + NMS per image -> (rois (B, post, 4),
        scores (B, post), keep (B, post)) tensors, off the tape.  Slots
        past the NMS survivors hold DUPLICATES of the top box with score
        -inf and keep=False — consumers must respect the mask."""
        o, r = _t(obj).detach(), _t(reg).detach()
        a = self._anchor_tensor(anchors, o.device)
        W, H = self._image_size[1], self._image_size[0]
        # a stable sort: the lowest index first among equal scores, as
        # lax.top_k
        score, idx = torch.sort(o, dim=-1, descending=True, stable=True)
        score, idx = score[:, :self._pre], idx[:, :self._pre]
        boxes = decode_deltas(a[idx], _take(r, idx))
        lo = torch.zeros(4, dtype=boxes.dtype, device=boxes.device)
        hi = torch.tensor([W, H, W, H], dtype=boxes.dtype,
                          device=boxes.device)
        boxes = torch.minimum(torch.maximum(boxes, lo), hi)
        return nms_static(boxes, score, self._post)

    def roi_align(self, levels, rois):
        """FPN level assignment by box scale + ROIAlign (GluonCV
        ``_pyramid_roi_feats``): all levels aligned, one gathered.
        ``rois``: (B, R, 4).  One op through the registry so the tape
        links the output to the FPN feature maps — the second-stage
        gradient must reach the FPN/backbone, not stop at the align."""
        from ...ndarray import NDArray
        from ...ops.registry import get_op, invoke

        roi_fn = get_op("ROIAlign").fn
        strides = self.anchors.strides
        r = self._roi
        n_levels = len(levels)

        def fn(rois_t, *feats):
            B, R = rois_t.shape[0], rois_t.shape[1]
            w = rois_t[..., 2] - rois_t[..., 0]
            h = rois_t[..., 3] - rois_t[..., 1]
            lvl = fpn_level_index(w, h, n_levels).reshape(-1)
            batch_ix = torch.arange(B, dtype=rois_t.dtype,
                                    device=rois_t.device)[:, None] \
                .expand(B, R)
            flat = torch.cat([batch_ix.reshape(-1, 1),
                              rois_t.reshape(-1, 4)], dim=1)
            per_level = [roi_fn(f, flat, pooled_size=(r, r),
                                spatial_scale=1.0 / strides[i])
                         for i, f in enumerate(feats)]
            stacked = torch.stack(per_level, dim=0)     # (L, BR, C, r, r)
            sel = lvl.to(torch.int64).reshape(1, -1, 1, 1, 1).expand(
                1, *stacked.shape[1:])
            return torch.gather(stacked, 0, sel)[0]

        rois = rois if isinstance(rois, NDArray) else NDArray._wrap(
            _t(rois, levels[0]._data.device), levels[0].context)
        return invoke(_op("pyramid_roi_align", fn, 1 + n_levels),
                      [rois, *levels], {})

    def hybrid_forward(self, F, x):
        """Inference: -> (class scores (B,R,nc+1), boxes (B,R,nc,4),
        roi scores (B,R))."""
        from ...ndarray import NDArray
        levels, anchors, obj, reg = self.rpn_forward(x)
        rois, rscores, _keep = self.proposals(anchors, obj, reg)
        roi_feats = self.roi_align(levels, rois)
        cls, deltas = self.box_head(roi_feats)
        B, R = rois.shape[0], rois.shape[1]
        boxes = decode_deltas(rois.reshape(B * R, 1, 4),
                              deltas._data.detach())
        ctx = x.context
        return (cls.reshape((B, R, -1)),
                NDArray._wrap(boxes.reshape(B, R, self._nc, 4), ctx),
                NDArray._wrap(rscores, ctx))

    # -------------------------------------------------------------- training
    def rpn_targets(self, anchors, gt_boxes, pos_iou=0.5, neg_iou=0.3):
        """RPN targets: (obj_target (..., N), obj_mask (..., N),
        delta_target (..., N, 4), pos_mask (..., N)) for gt_boxes
        (..., G, 4); G is static (pad with zero-area boxes)."""
        gt_boxes = _t(gt_boxes)
        anchors = _t(anchors, gt_boxes.device)
        best_iou, best_gt = _match_gt(anchors, gt_boxes)
        pos = best_iou >= pos_iou
        neg = best_iou < neg_iou
        obj_t = pos.to(torch.float32)
        obj_mask = (pos | neg).to(torch.float32)
        delta_t = encode_deltas(anchors, _take(gt_boxes, best_gt))
        return obj_t, obj_mask, delta_t, pos.to(torch.float32)

    def rpn_loss(self, anchors, obj, reg, gt_boxes):
        """Batched RPN loss (objectness BCE + smooth-L1 on positives), the
        mean over images.  One op through the registry, so the autograd
        tape records it."""
        from ...ops.registry import invoke

        def fn(o, r, g):
            obj_t, obj_m, delta_t, pos = self.rpn_targets(anchors, g)
            bce = torch.clamp(o, min=0) - o * obj_t + \
                torch.log1p(torch.exp(-torch.abs(o)))
            cls_l = (bce * obj_m).sum(-1) / torch.clamp(obj_m.sum(-1),
                                                        min=1.0)
            sl1 = _smooth_l1(r - delta_t)
            reg_l = (sl1 * pos).sum(-1) / torch.clamp(pos.sum(-1), min=1.0)
            return (cls_l + reg_l).mean()

        return invoke(_op("rpn_loss", fn, 3), [obj, reg, gt_boxes], {})

    def rcnn_targets(self, rois, gt_boxes, gt_classes, fg_iou=0.5):
        """Second-stage targets over FIXED rois (..., R, 4):
        (cls_target (..., R) int — 0=background, 1..nc=fg;
         delta_target (..., R, 4); fg_mask (..., R)).  gt_classes are
        1-based foreground ids; padded gt rows have zero area and never
        match."""
        rois, gt_boxes = _t(rois), _t(gt_boxes)
        gt_classes = _t(gt_classes, gt_boxes.device)
        best_iou, best_gt = _match_gt(rois, gt_boxes)
        fg = best_iou >= fg_iou
        cls_t = torch.where(fg, torch.gather(gt_classes, -1, best_gt),
                            torch.zeros_like(best_gt, dtype=gt_classes.dtype)
                            ).to(torch.int32)
        delta_t = encode_deltas(rois, _take(gt_boxes, best_gt))
        return cls_t, delta_t, fg.to(torch.float32)

    def rcnn_loss(self, levels, rois, gt_boxes, gt_classes, keep=None):
        """Second-stage loss over the proposals: softmax CE over
        nc+1 classes + smooth-L1 on the matched class's deltas for
        foreground rois.  ``rois`` (B,R,4) are fixed samples (no gradient
        flows into the proposal coordinates, the two-stage training
        convention); ``keep`` (B,R) is the NMS validity mask from
        ``proposals`` — suppressed slots hold duplicates of the top box
        and must not be counted as extra training samples.  The head's
        loss is one op through the registry, so the tape records it end
        to end (roi_align links back to the FPN features)."""
        from ...ndarray import NDArray
        from ...ops.registry import invoke

        dev = levels[0]._data.device
        rois = _t(rois, dev).detach()
        B, R = rois.shape[0], rois.shape[1]
        keep = torch.ones((B, R), dtype=torch.bool, device=dev) \
            if keep is None else _t(keep, dev)
        roi_feats = self.roi_align(levels, rois)        # (BR, C, r, r)
        cls, deltas = self.box_head(roi_feats)   # (BR, nc+1), (BR, nc, 4)
        nc = self._nc

        def fn(cls_flat, deltas_flat, rois_b, gt_b, gtc_b, keep_b):
            c = cls_flat.reshape(B, R, nc + 1)
            d = deltas_flat.reshape(B, R, nc, 4)
            valid = keep_b.to(torch.float32)
            cls_t, delta_t, fg = self.rcnn_targets(rois_b, gt_b, gtc_b)
            fg = fg * valid
            logp = torch.log_softmax(c.to(torch.float32), dim=-1)
            ce_all = -torch.gather(logp, -1,
                                   cls_t.to(torch.int64)[..., None])[..., 0]
            ce = (ce_all * valid).sum(-1) / torch.clamp(valid.sum(-1),
                                                        min=1.0)
            # pick the matched class's delta row (class 1 -> row 0)
            row = torch.clamp(cls_t.to(torch.int64) - 1, min=0)
            dsel = torch.gather(d, 2, row[..., None, None].expand(
                B, R, 1, 4))[:, :, 0]
            sl1 = _smooth_l1(dsel - delta_t)
            # where(), not multiply: a background roi's (unused) delta
            # target can be huge and 0 * inf = nan
            reg = torch.where(fg > 0, sl1, torch.zeros_like(sl1)).sum(-1) \
                / torch.clamp(fg.sum(-1), min=1.0)
            return (ce + reg).mean()

        ctx = levels[0].context
        return invoke(_op("rcnn_loss", fn, 6),
                      [cls, deltas, NDArray._wrap(rois, ctx), gt_boxes,
                       gt_classes, NDArray._wrap(keep, ctx)], {})
