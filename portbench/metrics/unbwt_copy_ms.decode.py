"""The default format's inverse BWT copies in the decode phase: the
bwt.upload (the block to the card) and bwt.download (the restored bytes
back, after the kernels are waited for) spans under bwt_decode
(libbsc_tpu_torch/engine.py), in ms a block; None where the program
records neither, as the native inverse does (the program's spans,
portbench/stage_spans.py)."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"bwt.upload", "bwt.download"},
                                    "decode")
