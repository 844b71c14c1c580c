"""Data iterators of the PyTorch port (reference: python/mxnet/io/ +
src/io/; the counterpart of ``mxnet_tpu.io``)."""
from .io import (DataDesc, DataBatch, DataIter, ResizeIter,
                 PrefetchingIter, NDArrayIter, CSVIter, MNISTIter,
                 ImageRecordIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "ImageRecordIter"]
