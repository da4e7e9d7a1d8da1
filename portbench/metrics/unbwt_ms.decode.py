"""The default format's inverse BWT in the decode phase (the bwt_decode
span of libbsc_tpu_torch/api.py: the native inverse from the aux
indexes, its chains on threads), in ms a block (the program's spans,
portbench/stage_spans.py)."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"bwt_decode"}, "decode")
