"""The default format's device BWT copies in the encode phase: the
bwt.upload (the block to the card; absent where the LZP screen's copy is
reused) and bwt.download (U and the aux indexes back, which waits for
the sort) spans under bwt_encode (libbsc_tpu_torch/engine.py), in ms a
block (the program's spans, portbench/stage_spans.py)."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"bwt.upload", "bwt.download"},
                                    "encode")
