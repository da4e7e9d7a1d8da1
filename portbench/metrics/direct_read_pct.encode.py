"""The CLI's direct reads in the encode phase: of the api.compress spans
(one a block), the share with no api.copy child, i.e. the blocks the API
took as the CLI read them, with no copy of the block into a slot of its
own (libbsc_tpu_torch/api.py, cli.py), in %.  None where the program
records no api.compress span (the program's spans, portbench/spans.py)."""

from portbench import spans


def read(run):
    rec = spans.record()
    api = spans.named(rec, spans.API["encode"]) if rec else []
    if not api:
        return None
    copied = {s.parent for s in spans.named(rec, "api.copy")}
    return 100.0 * sum(a.id not in copied for a in api) / len(api)
