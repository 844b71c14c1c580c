"""``mx.sym`` of the PyTorch port: symbolic graph building.

The counterpart of ``mxnet_tpu.symbol``.  The op functions are made from
the same registry as ``mx.nd``'s (one registry for both paths, as in
NNVM): called with a Symbol first, a frontend builds a graph node.
"""
from __future__ import annotations

import sys
import types

from .. import ndarray as _nd  # noqa: F401  registers the ops
from ..ops import registry as _reg
from .symbol import (Group, Symbol, Variable, load, load_json, ones, var,
                     zeros)

op = types.ModuleType(__name__ + ".op")
op.__doc__ = "Operator functions, one per registered op."
for _name in _reg.list_ops():
    setattr(op, _name, _reg.make_frontend(_reg.get_op(_name)))
sys.modules[op.__name__] = op

_g = globals()
for _name in _reg.list_ops():
    if _name not in _g:
        _g[_name] = getattr(op, _name)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "op"]
