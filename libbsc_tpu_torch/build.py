"""Where and how the port builds its binaries: the CUDA kernels
(:mod:`libbsc_tpu_torch.ops._cuda`) and the native host runtime
(:mod:`libbsc_tpu_torch.native`) are compiled at first use into
``libbsc_tpu_torch/_build/``, which git ignores."""

from __future__ import annotations

import fcntl
import os
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def stale(target: Path, deps) -> bool:
    """True when ``target`` is missing or older than any of ``deps``."""
    try:
        built = target.stat().st_mtime
    except OSError:
        return True
    return any(Path(d).stat().st_mtime > built for d in deps)


def build(deps: dict, make) -> list:
    """Bring every target of ``deps`` (target path -> its sources) up to
    date.  Under one file lock shared by every process, ``make(todo)``
    builds each stale target into the temporary path ``todo[target]``;
    each is then renamed into place, so no process loads a half-written
    binary.  Returns the targets built; ``make`` raises on failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        todo = {t: t.with_name(f".{t.stem}.{os.getpid()}{t.suffix}")
                for t, srcs in deps.items() if stale(t, srcs)}
        if todo:
            make(todo)
            for target, tmp in todo.items():
                os.replace(tmp, target)
    return list(todo)
