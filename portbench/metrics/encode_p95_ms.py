"""95th percentile (linear between order statistics) of the wall time
of every compress_file call of the encode phase, in ms; a failed call
counts as the whole phase, longer than any call."""

import numpy as np


def read(run):
    ph = run.encode
    ms = [(ph.seconds if c.error else c.seconds) * 1e3 for c in ph.calls]
    return float(np.percentile(ms, 95))
