"""The CLI's own time in a decode call (libbsc_tpu_torch/cli.py: api.init,
the archive's reads, the decode pool's threads, the restored file's
writes), in ms: the mean, over the decode phase's decompress_file calls, of
each call's time during which no api.decompress span of that call is open
on any thread (the program's spans, portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.cli_ms("decode")
