"""Vision datasets (reference: python/mxnet/gluon/data/vision/datasets.py;
the counterpart of ``mxnet_tpu.gluon.data.vision.datasets``).

No download path exists: a dataset reads its idx or CIFAR binary files
under ``root``, and without them builds a seeded synthetic stand-in with
the same shapes, dtypes and classes (``.synthetic`` is True), capped at
8192 samples, byte for byte the JAX package's.  The images stay on the
host (``mx.cpu(0)``); ``DataLoader`` copies each batch to its context in
one transfer.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError
from ....context import cpu
from .... import ndarray as nd
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset"]

def _host_array(data):
    return nd.array(data, dtype="uint8", ctx=cpu(0))


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self.synthetic = False
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic_images(n, shape, num_classes, seed):
    """Class-correlated images from a seed: each class a fixed random
    template plus noise, so that a small model can fit them."""
    rng = np.random.RandomState(seed)
    templates = rng.uniform(0, 255, size=(num_classes,) + shape)
    labels = rng.randint(0, num_classes, size=(n,)).astype(np.int32)
    noise = rng.uniform(-32, 32, size=(n,) + shape)
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels


def _read_idx(img_path, lbl_path):
    """An idx image file and its label file (gzip): (N, rows, cols, 1)
    uint8 images and int32 labels."""
    with gzip.open(lbl_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    with gzip.open(img_path, "rb") as f:
        _, _, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8) \
            .reshape(len(label), rows, cols, 1)
    return data, label


class MNIST(_DownloadedDataset):
    """MNIST: items (28x28x1 uint8 image HWC, int32 label)."""

    _N_TRAIN, _N_TEST, _SHAPE, _CLASSES = 60000, 10000, (28, 28, 1), 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._base_seed = 0x5EED
        super().__init__(root, train, transform)

    def _get_data(self):
        if self._train:
            files = ("train-images-idx3-ubyte.gz",
                     "train-labels-idx1-ubyte.gz")
            n = self._N_TRAIN
        else:
            files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
            n = self._N_TEST
        img_path = os.path.join(self._root, files[0])
        lbl_path = os.path.join(self._root, files[1])
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            data, label = _read_idx(img_path, lbl_path)
        else:
            self.synthetic = True
            data, label = _synthetic_images(
                min(n, 8192), self._SHAPE, self._CLASSES,
                self._base_seed + (0 if self._train else 1))
        self._data = _host_array(data)
        self._label = label


class FashionMNIST(MNIST):
    """Fashion-MNIST: MNIST's format and shapes."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        self._base_seed = 0xFA51
        _DownloadedDataset.__init__(self, root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10: items (32x32x3 uint8 image HWC, int32 label)."""

    _SHAPE, _CLASSES = (32, 32, 3), 10
    _TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
    _TEST_FILES = ["test_batch.bin"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3072 + self._label_bytes())
        data = rec[:, self._label_bytes():].reshape(-1, 3, 32, 32) \
            .transpose(0, 2, 3, 1)
        label = rec[:, self._label_index()].astype(np.int32)
        return data, label

    def _label_bytes(self):
        return 1

    def _label_index(self):
        return 0

    def _get_data(self):
        files = self._TRAIN_FILES if self._train else self._TEST_FILES
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            parts = [self._read_batch(p) for p in paths]
            data = np.concatenate([p[0] for p in parts])
            label = np.concatenate([p[1] for p in parts])
        else:
            self.synthetic = True
            n = 8192 if self._train else 2048
            data, label = _synthetic_images(n, self._SHAPE, self._CLASSES,
                                            0xC1FA + (0 if self._train
                                                      else 1))
        self._data = _host_array(data)
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR-100: coarse labels, or fine ones with ``fine_label``."""

    _CLASSES = 100
    _TRAIN_FILES = ["train.bin"]
    _TEST_FILES = ["test.bin"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _label_bytes(self):
        return 2

    def _label_index(self):
        # a CIFAR-100 record: <coarse><fine><3072 px>
        return 1 if self._fine else 0


class ImageFolderDataset(Dataset):
    """``<root>/<class>/<item>`` folders (reference:
    ImageFolderDataset): ``.npy`` items and image files (decoded by
    ``image.imread`` with ``flag``) load as HWC uint8 arrays on the
    host."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        if not os.path.isdir(self._root):
            raise MXNetError(f"no such directory {self._root!r}")
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image as img_mod
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _host_array(np.load(path))
        else:
            with cpu(0):
                img = img_mod.imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
