"""The host static QLFC decoder in the decode phase (the coder_decompress
span of libbsc_tpu_torch/api.py: the native decoder's segments, each on
a thread of its own), in ms a block (the program's spans,
portbench/stage_spans.py)."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"coder_decompress"}, "decode")
