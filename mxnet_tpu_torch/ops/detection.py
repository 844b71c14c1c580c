"""Object-detection operators of the PyTorch port: the SSD MultiBox
family (anchors, target matching and encoding, decoding with NMS).

The counterpart of ``mxnet_tpu.ops.detection``.  The JAX package maps a
per-sample body over the batch and runs the bipartite match and NMS as
``lax.fori_loop``s; here both loops run over the whole batch at once,
one step per ground truth (M) or per box (N), with no host read, so the
ops can sit inside a captured CUDA graph.  Sorts are stable, as
``jnp.argsort`` is: ties order the same, so hard-negative mining keeps
the same anchors.

Layouts (the reference's):
  anchors   : (1, N, 4) corner format [xmin, ymin, xmax, ymax], normalised
  labels    : (B, M, 5) rows [cls, xmin, ymin, xmax, ymax]; cls < 0 pads
  cls_pred  : (B, num_cls + 1, N); class 0 is background
  loc_pred  : (B, N * 4) centre-format offsets scaled by ``variances``
"""
from __future__ import annotations

import math

import torch

from .registry import register
from .tensor import const

__all__ = ["MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection"]


def _corner_to_center(boxes):
    """[xmin, ymin, xmax, ymax] -> (cx, cy, w, h), each (..., 1)."""
    xmin, ymin, xmax, ymax = torch.split(boxes, 1, dim=-1)
    w = xmax - xmin
    h = ymax - ymin
    return xmin + w / 2, ymin + h / 2, w, h


def _iou_matrix(a, b):
    """IoU of corner boxes a (..., N, 4) against b (..., M, 4) ->
    (..., N, M)."""
    ax0, ay0, ax1, ay1 = [a[..., :, i, None] for i in range(4)]
    bx0, by0, bx1, by1 = [b[..., None, :, i] for i in range(4)]
    ix = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0),
                     min=0.0)
    iy = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0),
                     min=0.0)
    inter = ix * iy
    area_a = torch.clamp(ax1 - ax0, min=0.0) * torch.clamp(ay1 - ay0,
                                                           min=0.0)
    area_b = torch.clamp(bx1 - bx0, min=0.0) * torch.clamp(by1 - by0,
                                                           min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _floats(v):
    return tuple(float(s) for s in (v if isinstance(v, (tuple, list))
                                    else (v,)))


@register("_contrib_MultiBoxPrior", aliases=["MultiBoxPrior"],
          differentiable=False)
def MultiBoxPrior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes of one (B, C, H, W) feature map: (1, H*W*K, 4),
    K = len(sizes) + len(ratios) - 1, per cell one box per size and one
    per extra ratio at sizes[0].  Widths carry the ``H/W`` factor, so a
    ratio-1 box is square in image space."""
    sizes, ratios = _floats(sizes), _floats(ratios)
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    step_y = 1.0 / H if steps[0] <= 0 else float(steps[0])
    step_x = 1.0 / W if steps[1] <= 0 else float(steps[1])
    cy = (torch.arange(H, dtype=torch.float32, device=dev)
          + float(offsets[0])) * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev)
          + float(offsets[1])) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    aspect = float(H) / float(W)
    half = [(s * aspect / 2.0, s / 2.0) for s in sizes]
    for r in ratios[1:]:
        rs = math.sqrt(r)
        half.append((sizes[0] * aspect * rs / 2.0, sizes[0] / rs / 2.0))
    hw = const([w for w, _ in half], torch.float32, dev)
    hh = const([h for _, h in half], torch.float32, dev)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    boxes = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    out = boxes.reshape(1, -1, 4)
    return torch.clamp(out, 0.0, 1.0) if clip else out


@register("_contrib_MultiBoxTarget", num_inputs=3, num_outputs=3,
          aliases=["MultiBoxTarget"], differentiable=False)
def MultiBoxTarget(anchor, label, cls_pred, *, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor-to-ground-truth matching and offset encoding: returns
    box_target (B, N*4), box_mask (B, N*4), cls_target (B, N).

    Each valid ground truth claims its best unclaimed anchor in turn
    (bipartite), then every anchor whose best IoU exceeds
    ``overlap_threshold`` joins its best ground truth.  With
    ``negative_mining_ratio > 0`` only the ``ratio * num_pos`` negatives
    of lowest background score (among those under
    ``negative_mining_thresh`` IoU) keep class 0; the others get
    ``ignore_label``."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    dev = anchors.device
    var = [float(v) for v in variances]
    acx, acy, aw, ah = _corner_to_center(anchors)          # (N, 1)
    valid = label[:, :, 0] >= 0                            # (B, M)
    gt = label[:, :, 1:5]
    iou = _iou_matrix(anchors, gt)                         # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    anchor_ids = torch.arange(N, device=dev)
    match = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    claimed = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for j in range(M):
        col = torch.where(claimed, torch.full_like(iou[:, :, j], -1.0),
                          iou[:, :, j])
        best = torch.argmax(col, dim=1, keepdim=True)      # (B, 1)
        ok = valid[:, j:j + 1] & (torch.gather(col, 1, best) > 1e-12)
        hit = ok & (anchor_ids[None, :] == best)
        match = torch.where(hit, torch.full_like(match, j), match)
        claimed = claimed | hit
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.gather(iou, 2, best_gt[:, :, None])[:, :, 0]
    match = torch.where((match < 0) & (best_iou > overlap_threshold),
                        best_gt, match)
    matched = match >= 0
    gt_cls = torch.where(valid, label[:, :, 0],
                         torch.zeros_like(label[:, :, 0]))
    safe = torch.clamp(match, 0, M - 1)
    cls_t = torch.where(matched, torch.gather(gt_cls, 1, safe) + 1.0,
                        torch.zeros_like(best_iou))
    if negative_mining_ratio > 0:
        num_pos = matched.sum(dim=1, keepdim=True)
        max_neg = torch.clamp(
            (negative_mining_ratio * num_pos.to(torch.float32))
            .to(torch.int64), min=int(minimum_negative_samples))
        is_neg = ~matched & (best_iou < negative_mining_thresh)
        bg = cls_pred[:, 0, :]
        order = torch.argsort(
            torch.where(is_neg, bg, torch.full_like(bg, math.inf)), dim=1,
            stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        keep_neg = is_neg & (rank < max_neg)
        cls_t = torch.where(
            matched, cls_t,
            torch.where(keep_neg, torch.zeros_like(cls_t),
                        torch.full_like(cls_t, float(ignore_label))))
    g = torch.gather(gt, 1, safe[:, :, None].expand(B, N, 4))
    gcx, gcy, gw, gh = _corner_to_center(g)                # (B, N, 1)
    eps = 1e-12
    aw_, ah_ = torch.clamp(aw, min=eps), torch.clamp(ah, min=eps)
    tx = (gcx - acx) / aw_ / var[0]
    ty = (gcy - acy) / ah_ / var[1]
    tw = torch.log(torch.clamp(gw / aw_, min=eps)) / var[2]
    th = torch.log(torch.clamp(gh / ah_, min=eps)) / var[3]
    t = torch.cat([tx, ty, tw, th], dim=-1)                # (B, N, 4)
    mask = matched[:, :, None].to(t.dtype)
    return ((t * mask).reshape(B, -1),
            mask.expand(B, N, 4).reshape(B, -1), cls_t)


@register("_contrib_MultiBoxDetection", num_inputs=3,
          aliases=["MultiBoxDetection"], differentiable=False)
def MultiBoxDetection(cls_prob, loc_pred, anchor, *, clip=True,
                      threshold=0.01, background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """Decode and per-class NMS: (B, N, 6) rows [cls_id, score, xmin,
    ymin, xmax, ymax] sorted by score; suppressed and below-threshold
    rows have cls_id -1."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B = cls_prob.shape[0]
    dev = anchors.device
    var = [float(v) for v in variances]
    acx, acy, aw, ah = _corner_to_center(anchors)
    loc = loc_pred.reshape(B, N, 4)
    cx = loc[..., 0:1] * var[0] * aw + acx
    cy = loc[..., 1:2] * var[1] * ah + acy
    w = torch.exp(torch.clamp(loc[..., 2:3] * var[2], -10, 10)) * aw / 2
    h = torch.exp(torch.clamp(loc[..., 3:4] * var[3], -10, 10)) * ah / 2
    boxes = torch.cat([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    best = torch.argmax(fg, dim=1, keepdim=True)           # (B, 1, N)
    score = torch.gather(fg, 1, best)[:, 0]                # (B, N)
    best = best[:, 0]
    # the foreground classes renumbered from 0 (background removed)
    fg_id = torch.where(best >= background_id, best + 1, best)
    cls_id = (fg_id - (fg_id > background_id).to(fg_id.dtype)).to(
        torch.float32)
    keep = score > threshold
    cls_id = torch.where(keep, cls_id, torch.full_like(cls_id, -1.0))
    score = torch.where(keep, score, torch.zeros_like(score))
    order = torch.argsort(-score, dim=1, stable=True)
    cls_id = torch.gather(cls_id, 1, order)
    score = torch.gather(score, 1, order)
    boxes = torch.gather(boxes, 1, order[:, :, None].expand(B, N, 4))
    ids = torch.arange(N, device=dev)
    if nms_topk > 0:
        cls_id = torch.where(ids[None, :] < nms_topk, cls_id,
                             torch.full_like(cls_id, -1.0))
    same = torch.ones((B, N, N), dtype=torch.bool, device=dev) \
        if force_suppress else cls_id[:, :, None] == cls_id[:, None, :]
    # cand[b, i, k]: box i suppresses box k if i is still alive
    cand = (_iou_matrix(boxes, boxes) > nms_threshold) & same \
        & (ids[None, :] > ids[:, None])[None] & (cls_id >= 0)[:, :, None]
    alive = torch.ones((B, N), dtype=torch.bool, device=dev)
    for i in range(N):
        alive = alive & ~(cand[:, i, :] & alive[:, i:i + 1])
    cls_id = torch.where(alive, cls_id, torch.full_like(cls_id, -1.0))
    return torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)
