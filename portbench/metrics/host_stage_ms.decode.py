"""Host time of api.decompress a block (libbsc_tpu_torch/api.py: the
payload's copy and Adler-32, pool allocations, the restored block's copy
and Adler-32), in ms: the api.decompress spans' time less their
decompress_block_device child's, averaged over the decode phase's blocks
(the program's spans, portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.host_stage_ms("decode")
