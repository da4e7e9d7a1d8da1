"""The default format's inverse BWT in the decode phase: the share of the
bwt_decode spans (libbsc_tpu_torch/api.py, one a default-format block)
whose route tag starts with "device", i.e. the blocks inverted on the
card rather than by the native runtime, in %.  None where the program
records no bwt_decode span in the phase (the program's spans,
portbench/spans.py)."""

from portbench import spans


def read(run):
    rec = spans.record()
    if not rec:
        return None
    api = {s.id for s in spans.named(rec, spans.API["decode"])}
    parent = {s.id: s.parent for s in rec}

    def in_phase(s):
        up = s.parent
        while up is not None and up not in api:
            up = parent.get(up)
        return up is not None

    tags = [s.tag or "" for s in spans.named(rec, "bwt_decode")
            if in_phase(s)]
    if not tags:
        return None
    return 100.0 * sum(t.startswith("device") for t in tags) / len(tags)
