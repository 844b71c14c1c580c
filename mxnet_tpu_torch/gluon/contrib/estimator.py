"""A minimal Estimator of the PyTorch port: the fit / evaluate loop
(reference: ``python/mxnet/gluon/contrib/estimator/estimator.py``; the
counterpart of ``mxnet_tpu.gluon.contrib.estimator``)."""
from __future__ import annotations

from ... import autograd
from ...base import MXNetError

__all__ = ["Estimator"]


class Estimator:
    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = train_metrics or []
        self.trainer = trainer
        self.context = context

    def fit(self, train_data, val_data=None, epochs=1):
        """Train ``epochs`` passes over ``train_data`` (batches of
        ``(data, label, ...)``); returns each epoch's metrics."""
        if self.trainer is None:
            raise MXNetError("Estimator needs a Trainer")
        history = []
        for _epoch in range(epochs):
            for m in self.train_metrics:
                m.reset()
            for batch in train_data:
                data, label = batch[0], batch[1]
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                for m in self.train_metrics:
                    m.update(label, out)
            history.append({m.name: m.get()[1]
                            for m in self.train_metrics})
        return history

    def evaluate(self, val_data, metrics=None):
        metrics = metrics or self.train_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            data, label = batch[0], batch[1]
            out = self.net(data)
            for m in metrics:
                m.update(label, out)
        return {m.name: m.get()[1] for m in metrics}
