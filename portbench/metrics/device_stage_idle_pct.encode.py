"""Share of the compress_block_device spans' time (the fused device
encode, libbsc_tpu_torch/engine.py, on the farm's threads) during which no
kernel, copy or set ran on the card, in %.  The spans are laid on the
device trace by the file-call spans, which are in both (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.device_stage_idle_pct("encode", run.trace)
