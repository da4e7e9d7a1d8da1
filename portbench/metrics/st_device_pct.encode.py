"""The Sort Transform's route in the encode phase: the share of the
st<k>_encode spans (libbsc_tpu_torch/api.py, one an ST block) whose
route tag is "device", i.e. the blocks sorted on the card rather than by
the native runtime, in %.  None where the program records no such span
in the phase, or tags none of them with a route (the program's spans,
portbench/spans.py)."""

from portbench import spans

NAMES = {f"st{k}_encode" for k in range(3, 9)}


def read(run):
    rec = spans.record()
    if not rec:
        return None
    api = {s.id for s in spans.named(rec, spans.API["encode"])}
    parent = {s.id: s.parent for s in rec}

    def in_phase(s):
        up = s.parent
        while up is not None and up not in api:
            up = parent.get(up)
        return up is not None

    tags = [s.tag or "" for s in rec if s.name in NAMES and in_phase(s)]
    if not any(tags):
        return None
    return 100.0 * sum(t == "device" for t in tags) / len(tags)
