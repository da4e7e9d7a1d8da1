"""Host time of api.compress a block (libbsc_tpu_torch/api.py: the two
Adler-32s, the LZP attempt, pool allocations and copies, the payload's
assembly), in ms: the api.compress spans' time less their
compress_block_device child's, averaged over the encode phase's blocks
(the program's spans, portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.host_stage_ms("encode")
