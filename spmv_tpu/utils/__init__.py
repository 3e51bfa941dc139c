"""Utilities: persistent compile cache, bandwidth model, profiling."""

from .cache import enable_compile_cache
from .perfmodel import bytes_moved, roofline_gflops
from .profiling import trace, Stopwatch

__all__ = ["enable_compile_cache", "bytes_moved", "roofline_gflops",
           "trace", "Stopwatch"]
