"""mx.image of the PyTorch port: decode, resize and augment on the host
(the counterpart of ``mxnet_tpu.image.image``; reference:
``python/mxnet/image/image.py``).

Decode and augmentation are host work, as in the reference, where this
module wraps OpenCV: numpy over a codec chain, ``cv2`` -> PIL -> a
built-in numpy PNG codec (``_BACKEND`` names the tier that runs; with the
built-in codec ``imresize`` is nearest-neighbour and ``imencode`` writes
PNG whatever the extension, as the JAX package's numpy backend does).
Randomness comes from the global ``random`` and ``np.random`` streams,
drawn in the JAX package's order, so seeded runs of both packages make
the same images.

The public functions and augmenters take and return NDArrays on the
current context.  :class:`ImageIter` decodes and augments on the host
(``mx.cpu(0)``, no copies between host and card) and copies each batch
to its context once a field: the context current when it is built or
reset, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import os
import random as pyrandom
import struct
import zlib
from typing import List

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["imread", "imdecode", "imencode", "imwrite", "imresize",
           "resize_short", "fixed_crop", "center_crop", "random_crop",
           "random_size_crop", "color_normalize",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "RandomSizedCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "RandomGrayAug", "CreateAugmenter", "ImageIter"]


# ---------------------------------------------------------------------------
# codec backends
# ---------------------------------------------------------------------------

def _backend():
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        pass
    try:
        import PIL.Image  # noqa: F401
        return "pil"
    except ImportError:
        return "numpy"


_BACKEND = _backend()


def _png_decode(data: bytes) -> np.ndarray:
    """Pure-numpy PNG decoder: 8-bit gray/RGB/RGBA, non-interlaced.
    Fallback so the framework decodes its own PNGs with zero deps."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise MXNetError("not a PNG file")
    pos, w = 8, None
    idat = b""
    while pos < len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if depth != 8 or interlace:
                raise MXNetError("numpy PNG codec: 8-bit non-interlaced only")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
            if channels is None:
                raise MXNetError(f"unsupported PNG color type {color}")
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
    stride = w * channels
    raw = raw.reshape(h, stride + 1)
    filters, lines = raw[:, 0], raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), dtype=np.int32)
    c = channels
    for y in range(h):
        line = lines[y].copy()
        f = filters[y]
        prev = out[y - 1] if y else np.zeros(stride, np.int32)
        if f == 0:
            out[y] = line
        elif f == 2:      # up
            out[y] = (line + prev) & 0xFF
        elif f in (1, 3, 4):
            for x in range(stride):
                a = out[y, x - c] if x >= c else 0
                b = prev[x]
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else cc)
                out[y, x] = (line[x] + pred) & 0xFF
        else:
            raise MXNetError(f"bad PNG filter {f}")
    img = out.astype(np.uint8).reshape(h, w, channels)
    return img


def _png_encode(img: np.ndarray) -> bytes:
    """Pure-numpy PNG encoder (filter 0 scanlines)."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    scan = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    idat = zlib.compress(scan.tobytes(), 6)

    def chunk(ctype, payload):
        body = ctype + payload
        return struct.pack(">I", len(payload)) + body + \
            struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _host(src) -> np.ndarray:
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _decode(data: bytes, flag=1, to_rgb=True) -> np.ndarray:
    """HWC uint8 numpy image of an encoded buffer on the ``_BACKEND``
    tier (RGB, or BGR from ``cv2`` when ``to_rgb`` is False)."""
    if _BACKEND == "cv2":
        import cv2
        img = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR if flag else
                           cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise MXNetError("imdecode: decode failed")
        if flag and to_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if not flag:
            img = img[:, :, None]
        return img
    if _BACKEND == "pil":
        import io as _io
        import PIL.Image
        try:
            pimg = PIL.Image.open(_io.BytesIO(data))
            pimg = pimg.convert("RGB" if flag else "L")
        except Exception as e:
            raise MXNetError(f"imdecode: decode failed: {e}") from e
        img = np.asarray(pimg)
        return img[:, :, None] if not flag else img
    if data[:2] == b"\xff\xd8":
        raise MXNetError(
            "imdecode: a JPEG needs cv2 or PIL, and this host has "
            "neither (the built-in codec reads PNG only)")
    img = _png_decode(data)
    if img.shape[2] == 2:           # gray+alpha: drop alpha
        img = img[:, :, :1]
    if flag and img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    elif flag and img.shape[2] == 4:
        img = img[:, :, :3]
    elif not flag and img.shape[2] != 1:
        img = img[:, :, :3].mean(axis=2, keepdims=True).astype(np.uint8)
    return img


def imdecode(buf, flag=1, to_rgb=True, **kwargs) -> NDArray:
    """Decode an encoded image buffer to an HWC uint8 NDArray
    (reference: mx.image.imdecode over cv2.imdecode).
    flag: 1=color, 0=grayscale."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    return nd.array(_decode(bytes(buf), flag, to_rgb), dtype="uint8")


def imread(filename, flag=1, to_rgb=True, **kwargs) -> NDArray:
    """Read an image file to an HWC uint8 NDArray (reference: imread)."""
    if not os.path.exists(filename):
        raise MXNetError(f"imread: no such file {filename!r}")
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imencode(img, ext=".png", quality=95) -> bytes:
    """Encode an HWC uint8 image (reference: cv2.imencode); the built-in
    codec writes PNG whatever ``ext`` says."""
    arr = _host(img)
    if _BACKEND == "cv2":
        import cv2
        enc = arr[:, :, ::-1] if arr.ndim == 3 and arr.shape[2] == 3 else arr
        params = [cv2.IMWRITE_JPEG_QUALITY, quality] \
            if ext in (".jpg", ".jpeg") else []
        ok, buf = cv2.imencode(ext, enc, params)
        if not ok:
            raise MXNetError("imencode failed")
        return buf.tobytes()
    if _BACKEND == "pil" and ext != ".png":
        import io as _io
        import PIL.Image
        bio = _io.BytesIO()
        PIL.Image.fromarray(arr.squeeze()).save(bio, format="JPEG",
                                                quality=quality)
        return bio.getvalue()
    return _png_encode(arr)


def imwrite(filename, img, quality=95):
    ext = os.path.splitext(filename)[1].lower() or ".png"
    with open(filename, "wb") as f:
        f.write(imencode(img, ext=ext, quality=quality))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _resize(arr, w, h, interp=1) -> np.ndarray:
    """``arr`` (HWC numpy) resized to (h, w) on the ``_BACKEND`` tier."""
    if _BACKEND == "cv2":
        import cv2
        interp_map = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
                      2: cv2.INTER_CUBIC, 3: cv2.INTER_AREA,
                      4: cv2.INTER_LANCZOS4}
        out = cv2.resize(arr, (w, h), interpolation=interp_map.get(
            interp, cv2.INTER_LINEAR))
    elif _BACKEND == "pil":
        import PIL.Image
        mode_map = {0: PIL.Image.NEAREST, 1: PIL.Image.BILINEAR,
                    2: PIL.Image.BICUBIC}
        out = np.asarray(PIL.Image.fromarray(arr.squeeze()).resize(
            (w, h), mode_map.get(interp, PIL.Image.BILINEAR)))
    else:
        ys = (np.arange(h) * arr.shape[0] / h).astype(np.int64)
        xs = (np.arange(w) * arr.shape[1] / w).astype(np.int64)
        out = arr[ys][:, xs]
    return out[:, :, None] if out.ndim == 2 else out


def imresize(src, w, h, interp=1) -> NDArray:
    """Resize HWC image to (h, w) (reference: mx.image.imresize)."""
    arr = _host(src)
    return nd.array(_resize(arr, w, h, interp), dtype=str(arr.dtype))


def resize_short(src, size, interp=2) -> NDArray:
    """Resize so the shorter edge becomes `size` (reference: resize_short)."""
    arr = _host(src)
    h, w = arr.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2) -> NDArray:
    arr = _host(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize(out, size[0], size[1], interp)
    return nd.array(out, dtype=str(arr.dtype))


def center_crop(src, size, interp=2):
    arr = _host(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    arr = _host(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random area+aspect crop (reference: random_size_crop)."""
    arr = _host(src)
    h, w = arr.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(arr, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std in float32 (reference: color_normalize)."""
    arr = _host(src).astype(np.float32)
    arr = arr - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return nd.array(arr)


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------

class Augmenter:
    """Image augmenter base (reference: image.Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src: NDArray) -> NDArray:
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts: List[Augmenter]):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts: List[Augmenter]):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return nd.array(src.asnumpy()[:, ::-1].copy(),
                            dtype=str(src.dtype))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return nd.array(src.asnumpy().astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        arr = src.asnumpy().astype(np.float32)
        gray = (arr * self._coef).sum(axis=2).mean()
        return nd.array(arr * alpha + gray * (1 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = ContrastJitterAug._coef

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        arr = src.asnumpy().astype(np.float32)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return nd.array(arr * alpha + gray * (1 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      np.float32)
        t = self.ityiq @ bt @ self.tyiq
        arr = src.asnumpy().astype(np.float32)
        return nd.array(arr @ t.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-noise lighting (reference: LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__()
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)) \
            .astype(np.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return nd.array(src.asnumpy().astype(np.float32) + rgb)


class RandomGrayAug(Augmenter):
    _coef = np.array([[[0.299], [0.587], [0.114]]], np.float32) \
        .reshape(1, 1, 3)

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            arr = src.asnumpy().astype(np.float32)
            gray = (arr * self._coef).sum(axis=2, keepdims=True)
            return nd.array(np.repeat(gray, 3, axis=2))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter pipeline (reference: CreateAugmenter)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and np.any(np.asarray(mean) != 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter
# ---------------------------------------------------------------------------

class ImageIter:
    """Python-side image iterator over RecordIO or an image list
    (reference: mx.image.ImageIter).  Yields NCHW float batches.

    Each image is decoded and augmented on the host (``mx.cpu(0)``), the
    batch is assembled in one host buffer (pinned when bound for the
    card) and copied to its context once a field: the context current
    when the iterator is built or reset.  The threaded counterpart is
    :class:`mxnet_tpu_torch.io.ImageRecordIter`.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, dtype="float32", last_batch_handle="pad",
                 **kwargs):
        from ..io.io import DataDesc, DataBatch
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self._batch_cls = DataBatch
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self.data_shape,
                                      dtype)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc("softmax_label", lshape, "float32")]

        self._rec = None
        self.imglist = []
        if path_imgrec is not None:
            from .. import recordio
            idx_path = path_imgrec[:-4] + ".idx" \
                if path_imgrec.endswith(".rec") else path_imgrec + ".idx"
            if os.path.exists(idx_path):
                self._rec = recordio.MXIndexedRecordIO(idx_path,
                                                      path_imgrec, "r")
                self._keys = list(self._rec.keys)
            else:
                self._rec = recordio.MXRecordIO(path_imgrec, "r")
                self._records = []
                while True:
                    s = self._rec.read()
                    if s is None:
                        break
                    self._records.append(s)
                self._keys = list(range(len(self._records)))
        elif path_imglist is not None or imglist is not None:
            if imglist is None:
                with open(path_imglist) as f:
                    imglist = []
                    for line in f:
                        parts = line.strip().split("\t")
                        imglist.append([float(x) for x in parts[1:-1]]
                                       + [parts[-1]])
            for entry in imglist:
                *labels, fname = entry
                if path_root is not None:
                    fname = os.path.join(path_root, fname)
                self.imglist.append((np.array(labels, np.float32), fname))
            self._keys = list(range(len(self.imglist)))
        else:
            raise MXNetError(
                "ImageIter needs path_imgrec, path_imglist or imglist")

        n = len(self._keys)
        s = n * part_index // num_parts
        e = n * (part_index + 1) // num_parts
        self._keys = self._keys[s:e]
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "hue", "pca_noise", "rand_gray",
                         "inter_method")})
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._order = list(range(len(self._keys)))
        self.reset()

    def reset(self):
        from ..io.io import _batch_context
        self._ctx = _batch_context()
        if self.shuffle:
            pyrandom.shuffle(self._order)
        self._cursor = 0

    def _read_one(self, idx):
        from .. import recordio as rio
        key = self._keys[idx]
        if self._rec is not None:
            if hasattr(self, "_records"):
                s = self._records[key]
            else:
                s = self._rec.read_idx(key)
            header, payload = rio.unpack(s)
            label = np.atleast_1d(np.asarray(header.label, np.float32))
            img = imdecode(payload)
        else:
            label, fname = self.imglist[key]
            img = imread(fname)
        for aug in self.auglist:
            img = aug(img)
        arr = img.asnumpy()
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[2] != self.data_shape[0] and \
                self.data_shape[0] == 3 and arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
        return arr.transpose(2, 0, 1).astype(self.dtype), label

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from ..io.io import _place, _staging
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        ctx = self._ctx
        data_t, data = _staging((self.batch_size,) + self.data_shape,
                                self.dtype, ctx)
        labels = np.zeros((self.batch_size, self.label_width), np.float32)
        data[...] = 0
        i = 0
        pad = 0
        with cpu(0):
            while i < self.batch_size:
                if self._cursor >= n:
                    if self.last_batch_handle == "discard":
                        raise StopIteration
                    pad = self.batch_size - i
                    for j in range(i, self.batch_size):   # wrap-pad
                        data[j], labels[j] = data[j % max(i, 1)], \
                            labels[j % max(i, 1)]
                    break
                arr, label = self._read_one(self._order[self._cursor])
                if arr.shape != self.data_shape:
                    raise MXNetError(
                        f"augmented image shape {arr.shape} != data_shape "
                        f"{self.data_shape}; add a Resize/Crop augmenter")
                data[i] = arr
                labels[i, :len(label)] = label[:self.label_width]
                self._cursor += 1
                i += 1
        lab = labels[:, 0] if self.label_width == 1 else labels
        lab_t, lab_host = _staging(lab.shape, np.float32, ctx)
        lab_host[...] = lab
        return self._batch_cls(data=[_place(data_t, ctx)],
                               label=[_place(lab_t, ctx)], pad=pad,
                               provide_data=self.provide_data,
                               provide_label=self.provide_label)
