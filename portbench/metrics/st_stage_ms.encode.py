"""The Sort Transform stage in the encode phase (the st<k>_encode spans
of libbsc_tpu_torch/api.py: on a device worker the block's copy to the
card, the sort there and the output back; on the farm's host worker the
native ST), in ms a block (the program's spans,
portbench/stage_spans.py)."""

from portbench import stage_spans

NAMES = {f"st{k}_encode" for k in range(3, 9)}


def read(run):
    return stage_spans.per_block_ms(NAMES, "encode")
