"""The CLI's host filters: the detectors (segmentation, context order,
record size) and the preprocessing transforms (block reversal, record
reordering), in numpy, as in the reference (filters/*.cpp)."""

from . import detectors, preprocessing

__all__ = ["detectors", "preprocessing"]
