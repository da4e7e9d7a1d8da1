"""Device time of the wide decoder and the wide-aux inverse BWT
(ops/wide_kernels.py K3's chain and expand kernels, ops/bwt.py K8's
table and chase) in the decode phase, in ms per block decoded."""

PATTERN = r"\b(wide_chain|wide_expand|unbwt_table|unbwt_chase)_kernel\b"


def read(run):
    if not run.trace or not run.decode.blocks:
        return None
    lo, hi = run.trace.span("decode")
    us, n = run.trace.kernel_us(lo, hi, PATTERN)
    return us / 1e3 / run.decode.blocks if n else None
