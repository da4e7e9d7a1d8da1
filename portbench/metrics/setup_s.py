"""Seconds from the process's start to the window's: imports, the
program's cached builds, the data, the warm-up."""


def read(run):
    return run.setup_s
