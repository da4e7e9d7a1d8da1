"""The library's exception: an error code of the reference ABI, raised."""

from __future__ import annotations

from . import constants as C


class BscError(Exception):
    """An error code of the reference ABI, raised."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"libbsc-tpu error {code}")
        self.code = code


def corrupt(what: str) -> BscError:
    """The error a decoder raises for a payload field it cannot trust."""
    return BscError(C.DATA_CORRUPT, f"data corrupt: {what}")
