"""The plain reference the benchmark judges the program's outputs by.

Plain numpy and torch, written from the formats' definitions: the ``bsc1``
container, the 28-byte block header, LZP, the wide-aux BWT, the lane
tables and the v3 wide coder; every choice a block's encoding makes is
made here from the input.  It imports nothing of the program and takes
nothing the program made, apart from the archives it judges.
"""
