"""Device time of the forward BWT's hand kernels K11-K14 (ops/bwt.py,
csrc/bwt_sort.cu) in the encode phase, in ms per block encoded."""

PATTERN = (r"\bbwt_(boot_keys|round_keys|heads_pay|heads|extract_bin|"
           r"extract_place)_kernel\b")


def read(run):
    if not run.trace or not run.encode.blocks:
        return None
    lo, hi = run.trace.span("encode")
    us, n = run.trace.kernel_us(lo, hi, PATTERN)
    return us / 1e3 / run.encode.blocks if n else None
