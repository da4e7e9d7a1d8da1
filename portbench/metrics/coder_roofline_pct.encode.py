"""K1 + K2's share of their roofline in the encode phase, in %: the
least time their bytes take at the card's peak (portbench/roofline.py,
from each archive's wide headers) over the kernels' measured time.

The bound is summed over the -m9 -e4 blocks of every archive the phase
made.  Where the farm's host worker coded some of them (fewer K1
launches than such blocks), the archive does not say which, and the sum
is scaled by launches over blocks."""

from portbench import roofline
from portbench.peaks import bound_s

K1 = r"\bwide_model_kernel\b"
K2 = r"\bwide_rans_(chain|place)_kernel\b"


def read(run):
    if not run.trace:
        return None
    lo, hi = run.trace.span("encode")
    k1_us, launches = run.trace.kernel_us(lo, hi, K1)
    k2_us, _ = run.trace.kernel_us(lo, hi, K2)
    bound, blocks = 0.0, 0
    for c in run.encode.ok():
        for _, L, max_bits, live, units in roofline.wide_blocks(
                c.out.read()):
            bound += bound_s(roofline.encode_bytes(L, max_bits, live, units))
            blocks += 1
    if not launches or not blocks:
        return None
    bound *= min(1.0, launches / blocks)
    return 100.0 * bound / ((k1_us + k2_us) / 1e6)
