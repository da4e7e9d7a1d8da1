"""The host static QLFC coder in the encode phase (the coder_compress
span of libbsc_tpu_torch/api.py: the native coder's segments, each on a
thread of its own), in ms a block (the program's spans,
portbench/stage_spans.py)."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"coder_compress"}, "encode")
