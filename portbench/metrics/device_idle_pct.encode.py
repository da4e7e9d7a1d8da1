"""Share of the encode phase (its span in the trace) in which no kernel,
copy or set ran on the card, in %."""


def read(run):
    span = run.trace.span("encode") if run.trace else None
    if not span or not run.trace.device:
        return None
    lo, hi = span
    return 100.0 * (1.0 - run.trace.busy(lo, hi) / (hi - lo))
