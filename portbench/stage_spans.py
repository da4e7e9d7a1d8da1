"""Per-block times of the program's stage spans (``api.py``'s stages and
the engine's spans under them), for the per-layer metrics of the default
format's layers: the device BWT and its copies, the host QLFC coder, the
host inverse BWT.  Read from the program's record (``spans.record``);
None where the program records no such span, as a program without it
does."""

from __future__ import annotations

from portbench import spans


def per_block_ms(names, phase: str):
    """Total time of the spans named in ``names`` that lie under the
    phase's API spans, over those API spans (one a block), in ms; None
    where there is none of them."""
    rec = spans.record() or []
    api = {s.id for s in spans.named(rec, spans.API[phase])}
    parent = {s.id: s.parent for s in rec}
    total = found = 0
    for s in rec:
        if s.name not in names:
            continue
        up = s.parent
        while up is not None and up not in api:
            up = parent.get(up)
        if up is not None:
            found += 1
            total += s.end - s.start
    if not found:
        return None
    return total / len(api) / 1e6
