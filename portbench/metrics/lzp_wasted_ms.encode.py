"""The host stages' wasted work in the encode phase: the time of the LZP
attempts whose output was thrown away (lzp_compress spans with 0 bytes
out, libbsc_tpu_torch/api.py), in ms a block (the program's spans,
portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.lzp_wasted_ms()
