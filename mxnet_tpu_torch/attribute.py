"""Symbol attribute scoping (reference: ``python/mxnet/attribute.py``).

The counterpart of ``mxnet_tpu.attribute``: ``mx.AttrScope`` attaches
string attributes (``ctx_group`` for the reference's manual model
parallelism, ``__layout__`` hints) to every symbol made inside the
scope.  The attributes flow into the graph, serialise through Symbol
JSON and can be queried; ``bind(group2ctx=...)`` keeps the groups as
metadata (one card runs the whole graph).  The scope stack is
thread-local.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current_attrs"]


class _ScopeState(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _ScopeState()


class AttrScope:
    """``with mx.AttrScope(ctx_group='dev1'):`` — every symbol made in
    the scope carries the attributes."""

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def __enter__(self):
        merged = dict(_STATE.stack[-1]) if _STATE.stack else {}
        merged.update(self._attrs)
        _STATE.stack.append(merged)
        return self

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False

    @classmethod
    def get(cls, attrs: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """The current scope's attributes merged with ``attrs`` (which
        win)."""
        out = dict(_STATE.stack[-1]) if _STATE.stack else {}
        if attrs:
            out.update({k: str(v) for k, v in attrs.items()})
        return out


def current_attrs() -> Dict[str, str]:
    return dict(_STATE.stack[-1]) if _STATE.stack else {}
