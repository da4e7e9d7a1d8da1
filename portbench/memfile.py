"""Anonymous memory files: the benchmark's inputs, archives and restored
files live in RAM and reach the program as ``/proc/self/fd/<n>``, so a
run writes nothing to disk."""

from __future__ import annotations

import os


class MemFile:
    """One ``memfd_create`` file; ``path`` is what the program opens."""

    def __init__(self, name: str, data=None):
        self.fd = os.memfd_create(name)
        self.path = f"/proc/self/fd/{self.fd}"
        if data is not None:
            view = memoryview(data).cast("B")
            done = 0
            while done < len(view):
                done += os.write(self.fd, view[done:])

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def read(self) -> bytes:
        size = self.size()
        out = bytearray(size)
        view, done = memoryview(out), 0
        while done < size:
            got = os.preadv(self.fd, [view[done:]], done)
            if got == 0:
                break
            done += got
        return bytes(out[:done])

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1
