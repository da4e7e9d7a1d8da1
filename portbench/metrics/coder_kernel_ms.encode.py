"""Device time of the wide coder's encode kernels (ops/wide_schedule.py,
ops/wide_kernels.py: K9, K10 the bit schedule, K1 the model, K2 the
rANS chain and placement) in the encode phase, in ms per block."""

PATTERN = (r"\b(sched_events|sched_planes|wide_model|wide_rans_chain|"
           r"wide_rans_place)_kernel\b")


def read(run):
    if not run.trace or not run.encode.blocks:
        return None
    lo, hi = run.trace.span("encode")
    us, n = run.trace.kernel_us(lo, hi, PATTERN)
    return us / 1e3 / run.encode.blocks if n else None
