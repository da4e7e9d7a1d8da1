"""Input bytes of every file the encode phase compressed, in MB, over
the phase's wall time (its start to the last call's end)."""


def read(run):
    ph = run.encode
    return sum(c.in_bytes for c in ph.ok()) / 1e6 / ph.seconds
