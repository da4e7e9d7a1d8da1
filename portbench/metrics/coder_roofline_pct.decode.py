"""K3's share of its roofline in the decode phase, in %: the least time
its bytes take at the card's peak (portbench/roofline.py, from each
decoded archive's wide headers) over the kernel's measured time (its
chain and expand launches).  Scaled by launches over blocks where some
block took another route."""

from portbench import roofline
from portbench.peaks import bound_s

K3 = r"\bwide_(chain|expand)_kernel\b"


def read(run):
    if not run.trace:
        return None
    lo, hi = run.trace.span("decode")
    us, _ = run.trace.kernel_us(lo, hi, K3)
    _, launches = run.trace.kernel_us(lo, hi, r"\bwide_chain_kernel\b")
    per_archive: dict = {}
    bound, blocks = 0.0, 0
    for c in run.decode.ok():
        if id(c.origin) not in per_archive:
            per_archive[id(c.origin)] = [
                bound_s(roofline.decode_bytes(n, L, units))
                for n, L, _, _, units in roofline.wide_blocks(
                    c.origin.out.read())]
        bound += sum(per_archive[id(c.origin)])
        blocks += len(per_archive[id(c.origin)])
    if not launches or not blocks:
        return None
    bound *= min(1.0, launches / blocks)
    return 100.0 * bound / (us / 1e6)
