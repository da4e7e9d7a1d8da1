"""The no-native engine (``TBSC_ENGINE=numpy``): every host stage without
the native runtime.

LZP and the QLFC coders are Python ports of the native runtime (slow, but
bit-exact with the stream formats) and the inverse ST is numpy; the BWT
forward and inverse and the forward ST run through the torch ops on the
device the caller names (the API's device), at any block size.  Nothing
here picks a device of its own.
"""
