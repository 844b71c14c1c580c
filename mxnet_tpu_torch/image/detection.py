"""Detection augmenters and ImageDetIter of the PyTorch port (the
counterpart of ``mxnet_tpu.image.detection``; reference:
``python/mxnet/image/detection.py`` — ``DetAugmenter`` subclasses,
``CreateDetAugmenter``, ``ImageDetIter``).

Host-side data path (numpy), like the rest of the image module.  Labels
are (N, 5+) float rows ``[cls, xmin, ymin, xmax, ymax, ...]`` with
coordinates normalized to [0, 1]; every geometric augmenter transforms
image and boxes together.  :class:`ImageDetIter` keeps its decoded
samples and runs its augmenters on the host (``mx.cpu(0)``) and copies
each batch to its context once a field: the context current when it is
built or reset.
"""
from __future__ import annotations

import random as pyrandom
from typing import List

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import ndarray as nd
from ..ndarray import NDArray
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter base: ``(src, label) -> (src, label)``
    (reference: image.detection.DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src: NDArray, label: np.ndarray):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter that leaves geometry unchanged
    (color/cast/normalize) into the detection pipeline."""

    def __init__(self, augmenter: Augmenter):
        if not isinstance(augmenter, Augmenter):
            raise MXNetError("DetBorrowAug wraps an image Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of ``aug_list`` (or skip) per sample."""

    def __init__(self, aug_list: List[DetAugmenter], skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and box x-coordinates with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = nd.array(src.asnumpy()[:, ::-1].copy(),
                           dtype=str(src.dtype))
            label = label.copy()
            valid = label[:, 0] >= 0
            x0 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x0
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping a minimum object overlap (SSD-style
    min-IoU sampling; reference: DetRandomCropAug).

    Boxes are clipped to the crop; objects whose center falls outside
    are dropped (cls set to -1)."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.3, 1.0), max_attempts=20):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        H, W = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(area * ratio))
            ch = min(1.0, np.sqrt(area / ratio))
            cx = pyrandom.uniform(0, 1.0 - cw)
            cy = pyrandom.uniform(0, 1.0 - ch)
            new_label = self._crop_boxes(label, cx, cy, cw, ch)
            if (new_label[:, 0] >= 0).any() or not \
                    (label[:, 0] >= 0).any():
                x0, y0 = int(cx * W), int(cy * H)
                x1, y1 = int((cx + cw) * W), int((cy + ch) * H)
                img = src.asnumpy()[y0:max(y1, y0 + 1),
                                    x0:max(x1, x0 + 1)]
                return nd.array(img, dtype=str(src.dtype)), new_label
        return src, label

    def _crop_boxes(self, label, cx, cy, cw, ch):
        out = label.copy()
        for i in range(label.shape[0]):
            if label[i, 0] < 0:
                continue
            bx0, by0, bx1, by1 = label[i, 1:5]
            ctr_x, ctr_y = (bx0 + bx1) / 2, (by0 + by1) / 2
            # coverage of the object by the crop
            ix = max(0.0, min(bx1, cx + cw) - max(bx0, cx))
            iy = max(0.0, min(by1, cy + ch) - max(by0, cy))
            barea = max(1e-12, (bx1 - bx0) * (by1 - by0))
            covered = ix * iy / barea
            inside = (cx <= ctr_x <= cx + cw) and (cy <= ctr_y <= cy + ch)
            if not inside or covered < self.min_object_covered:
                out[i, 0] = -1.0
                continue
            out[i, 1] = np.clip((bx0 - cx) / cw, 0, 1)
            out[i, 2] = np.clip((by0 - cy) / ch, 0, 1)
            out[i, 3] = np.clip((bx1 - cx) / cw, 0, 1)
            out[i, 4] = np.clip((by1 - cy) / ch, 0, 1)
        return out


class DetRandomPadAug(DetAugmenter):
    """Zoom-out: place the image on a larger filled canvas and shrink
    boxes accordingly (reference: DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=20,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = src.asnumpy()
        H, W = img.shape[0], img.shape[1]
        scale = pyrandom.uniform(*self.area_range)
        if scale <= 1.0:
            return src, label
        # canvas aspect sampled from aspect_ratio_range (reference
        # samples a ratio and sizes the canvas anisotropically)
        ratio = pyrandom.uniform(*self.aspect_ratio_range)
        new_h = int(H * np.sqrt(scale / ratio))
        new_w = int(W * np.sqrt(scale * ratio))
        new_h, new_w = max(new_h, H), max(new_w, W)
        off_y = pyrandom.randint(0, new_h - H)
        off_x = pyrandom.randint(0, new_w - W)
        canvas = np.empty((new_h, new_w) + img.shape[2:], img.dtype)
        canvas[...] = np.asarray(self.pad_val,
                                 img.dtype)[:img.shape[2] if img.ndim == 3
                                            else 1]
        canvas[off_y:off_y + H, off_x:off_x + W] = img
        out = label.copy()
        valid = out[:, 0] >= 0
        out[valid, 1] = (out[valid, 1] * W + off_x) / new_w
        out[valid, 3] = (out[valid, 3] * W + off_x) / new_w
        out[valid, 2] = (out[valid, 2] * H + off_y) / new_h
        out[valid, 4] = (out[valid, 4] * H + off_y) / new_h
        return nd.array(canvas, dtype=str(src.dtype)), out


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), pad_val=(127, 127, 127),
                       **kwargs):
    """Standard detection pipeline (reference: CreateDetAugmenter)."""
    auglist: List[DetAugmenter] = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])))
        auglist.append(DetRandomSelectAug([crop], 1.0 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad], 1.0 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # geometry is settled: force the output size
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]))))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(
            brightness, contrast, saturation)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        if mean is True:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True:
            std = np.array([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter:
    """Detection batches over RecordIO / image lists (reference:
    mx.image.ImageDetIter).  Yields data (B, C, H, W) and padded labels
    (B, max_objects, 5) with unused rows = -1."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 imglist=None, aug_list=None, shuffle=False,
                 max_objects=16, dtype="float32", **kwargs):
        from ..io.io import DataDesc
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.max_objects = max_objects
        self.dtype = dtype
        self._shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape)
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self.data_shape,
                                      dtype)]
        self.provide_label = [DataDesc("label",
                                       (batch_size, max_objects, 5),
                                       "float32")]
        # samples: list of (image NDArray | bytes, label np (N,5))
        self._samples = []
        if imglist is not None:
            for img, label in imglist:
                self._samples.append((img, np.asarray(label, np.float32)
                                      .reshape(-1, 5)))
        elif path_imgrec is not None:
            with cpu(0):
                self._load_rec(path_imgrec)
        else:
            raise MXNetError("ImageDetIter needs path_imgrec or imglist")
        self._order = list(range(len(self._samples)))
        self.reset()

    def _load_rec(self, path):
        from .. import recordio
        from .image import imdecode
        rec = recordio.MXRecordIO(path, "r")
        while True:
            s = rec.read()
            if s is None:
                break
            header, img_bytes = recordio.unpack(s)
            flat = np.asarray(header.label, np.float32)
            # reference det-record layout: flat[0] = header WIDTH (number
            # of leading header fields incl. itself), flat[1] = object
            # row width; object rows start at flat[header_width].
            # Accept a plain (N*5,) label too.  When both layouts parse
            # (ambiguous), prefer the one that yields object rows, then
            # the header layout (upstream canonical).
            header_ok = (
                flat.size >= 2 and float(flat[0]).is_integer()
                and 2 <= int(flat[0]) <= flat.size
                and float(flat[1]).is_integer() and int(flat[1]) >= 5
                and (flat.size - int(flat[0])) % int(flat[1]) == 0)
            plain_ok = flat.size > 0 and flat.size % 5 == 0
            header_rows = ((flat.size - int(flat[0])) // int(flat[1])
                           if header_ok else 0)
            if header_ok and (header_rows > 0 or not plain_ok):
                header_width = int(flat[0])
                obj_width = int(flat[1])
                objs = flat[header_width:].reshape(-1, obj_width)[:, :5]
            elif plain_ok:
                objs = flat.reshape(-1, 5)
            else:
                raise MXNetError(
                    f"ImageDetIter: cannot parse det-record label of "
                    f"size {flat.size} (head {flat[:4].tolist()}): "
                    f"expected [header_width, obj_width, ...header..., "
                    f"obj rows] with objects starting at "
                    f"flat[header_width], or a plain (N*5,) "
                    f"[cls, x0, y0, x1, y1] list.  (Records written "
                    f"against this package's pre-r3 nonstandard layout "
                    f"— objects hard-coded at flat[2:] — must be "
                    f"re-packed with the standard header, e.g. "
                    f"[2, 5, cls, x0, y0, x1, y1].)")
            self._samples.append((imdecode(img_bytes),
                                  objs.astype(np.float32)))
        rec.close()

    def reset(self):
        from ..io.io import _batch_context
        self._ctx = _batch_context()
        self._cursor = 0
        if self._shuffle:
            pyrandom.shuffle(self._order)

    def __iter__(self):
        return self

    def next(self):
        return self.__next__()

    def __next__(self):
        from ..io.io import DataBatch, _place, _staging
        from .image import imdecode
        if self._cursor >= len(self._samples):
            raise StopIteration
        C, H, W = self.data_shape
        data = np.zeros((self.batch_size, H, W, C), np.float32)
        labels = np.full((self.batch_size, self.max_objects, 5), -1.0,
                         np.float32)
        pad = 0
        with cpu(0):
            for i in range(self.batch_size):
                if self._cursor >= len(self._samples):
                    pad += 1
                    continue
                img, label = self._samples[self._order[self._cursor]]
                self._cursor += 1
                if isinstance(img, (bytes, bytearray)):
                    img = imdecode(img)
                label = label.copy()
                for aug in self.auglist:
                    img, label = aug(img, label) if isinstance(
                        aug, DetAugmenter) else (aug(img), label)
                arr = img.asnumpy().astype(np.float32)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                data[i, :arr.shape[0], :arr.shape[1], :arr.shape[2]] = \
                    arr[:H, :W, :C]
                n = min(label.shape[0], self.max_objects)
                labels[i, :n] = label[:n, :5]
        ctx = self._ctx
        data_t, host = _staging((self.batch_size, C, H, W), self.dtype, ctx)
        host[...] = data.transpose(0, 3, 1, 2)
        lab_t, lab_host = _staging(labels.shape, np.float32, ctx)
        lab_host[...] = labels
        return DataBatch(data=[_place(data_t, ctx)],
                         label=[_place(lab_t, ctx)], pad=pad)
