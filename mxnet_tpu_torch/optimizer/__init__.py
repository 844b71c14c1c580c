"""Optimizers of the PyTorch port (reference: python/mxnet/optimizer/):
each one updates a parameter through the tensor ops of
``ops/optimizer_ops.py``."""
from .optimizer import (Optimizer, SGD, NAG, Adam, AdamW, LAMB, RMSProp,
                        AdaGrad, AdaDelta, Ftrl, Signum, SignSGD, LARS,
                        Updater, create, register, get_updater, Test)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "Signum", "SignSGD", "LARS",
           "Updater", "create", "register", "get_updater", "Test"]
