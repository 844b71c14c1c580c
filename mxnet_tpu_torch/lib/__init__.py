"""Native (C++) runtime components of the port, bound via ctypes (see
nativelib.py)."""
from . import nativelib

__all__ = ["nativelib"]
