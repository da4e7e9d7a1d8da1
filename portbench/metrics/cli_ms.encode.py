"""The CLI's own time in an encode call (libbsc_tpu_torch/cli.py: api.init,
the reads and the archive's writes, the farm's threads, their pool slots
and the copy handed to the API), in ms: the mean, over the encode phase's
compress_file calls, of each call's time during which no api.compress span
of that call is open on any thread (the program's spans, portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.cli_ms("encode")
