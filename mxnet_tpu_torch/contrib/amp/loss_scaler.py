"""Dynamic loss scaling (reference: ``contrib/amp/loss_scaler.py``).

The counterpart of ``mxnet_tpu.contrib.amp.loss_scaler``: the scale
doubles after ``scale_window`` steps without an overflow and halves
(not below 1) at one.  bfloat16 has float32's exponent range, so its
gradients rarely overflow; float16 needs the scaler.
"""
from __future__ import annotations

from ... import ndarray as nd

__all__ = ["LossScaler"]


class LossScaler:
    """Doubling / halving dynamic scaler (reference: LossScaler)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0
        self._total_steps = 0
        self._skipped = 0

    def has_overflow(self, params) -> bool:
        """One finite-check over every gradient (``all_finite`` on the
        gradients' device) and one host read of its flag (reference:
        multi_all_finite).  A deferred backward whose gradients these
        are runs first."""
        grads = []
        for p in params:
            if getattr(p, "grad_req", "write") == "null":
                continue
            grads.extend(p.list_grad())
        if not grads:
            return False
        ok = nd.all_finite(*grads)
        return bool(ok.asnumpy()[0] == 0.0)

    def update_scale(self, overflow: bool):
        self._total_steps += 1
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
            self._skipped += 1
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0

    @property
    def stats(self):
        return {"loss_scale": self.loss_scale,
                "steps": self._total_steps, "skipped": self._skipped}
