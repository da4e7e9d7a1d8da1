"""The host stages' screened share in the encode phase: of the api.compress
spans (one a block), the share with an lzp_screen child whose out is 0,
i.e. the blocks whose host LZP attempt the device screen proved would be
rejected and so skipped (libbsc_tpu_torch/api.py), in %.  None where the
program records no lzp_screen span (the program's spans,
portbench/spans.py)."""

from portbench import spans


def read(run):
    rec = spans.record()
    screens = spans.named(rec, "lzp_screen") if rec else []
    api = spans.named(rec, spans.API["encode"]) if rec else []
    if not screens or not api:
        return None
    ids = {a.id for a in api}
    ruled_out = {s.parent for s in screens if s.out == 0 and s.parent in ids}
    return 100.0 * len(ruled_out) / len(api)
