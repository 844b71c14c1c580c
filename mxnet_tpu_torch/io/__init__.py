"""Data iterators of the PyTorch port (the iterator tier of
``mxnet_tpu.io``)."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]
