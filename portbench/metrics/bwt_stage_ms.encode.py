"""The default format's BWT stage in the encode phase (the bwt_encode
span of libbsc_tpu_torch/api.py: on a device worker the block's copy to
the card where the screen's copy is not reused, the suffix sort and
extraction on the card, U and the aux indexes back; on the farm's host
worker the native BWT), in ms a block (the program's spans,
portbench/stage_spans.py)."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"bwt_encode"}, "encode")
