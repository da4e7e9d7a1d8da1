"""Restored bytes of every file the decode phase wrote, in MB, over the
phase's wall time (its start to the last call's end)."""


def read(run):
    ph = run.decode
    return sum(c.out_bytes for c in ph.ok()) / 1e6 / ph.seconds
