"""Vision data of the PyTorch port (reference:
python/mxnet/gluon/data/vision/)."""
from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100, \
    ImageFolderDataset
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "transforms"]
