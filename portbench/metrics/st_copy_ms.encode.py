"""The device ST's copies in the encode phase: the st.upload (the block
to the card) and st.download (the output back, which waits for the
sort) spans under the st<k>_encode spans (libbsc_tpu_torch/engine.py),
in ms a block (the program's spans, portbench/stage_spans.py).  None
where the program records no such span."""

from portbench import stage_spans


def read(run):
    return stage_spans.per_block_ms({"st.upload", "st.download"}, "encode")
