"""Device time of torch.sort's kernels (CUB's radix sort, torch's
segmented and in-place sorts: the BWT's rows, the lane table's sort) in
the encode phase, in ms per block encoded."""

PATTERN = r"RadixSort|radixSort|sortKeyValueInplace|SegmentedSort|MergeSort"


def read(run):
    if not run.trace or not run.encode.blocks:
        return None
    lo, hi = run.trace.span("encode")
    us, n = run.trace.kernel_us(lo, hi, PATTERN)
    return us / 1e3 / run.encode.blocks if n else None
