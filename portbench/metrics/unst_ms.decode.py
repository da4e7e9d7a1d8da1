"""The inverse Sort Transform in the decode phase (the st<k>_decode
spans of libbsc_tpu_torch/api.py: the native inverse on the host), in
ms a block (the program's spans, portbench/stage_spans.py)."""

from portbench import stage_spans

NAMES = {f"st{k}_decode" for k in range(3, 9)}


def read(run):
    return stage_spans.per_block_ms(NAMES, "decode")
