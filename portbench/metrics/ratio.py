"""Input bytes over archive bytes, summed over every file of the encode
phase."""


def read(run):
    ok = run.encode.ok()
    return sum(c.in_bytes for c in ok) / sum(c.out_bytes for c in ok)
