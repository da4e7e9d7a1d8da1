from .header import (
    Mode,
    pack_mode,
    unpack_mode,
    BlockHeader,
    pack_block_header,
    parse_block_header,
    make_stored_block,
)
from .subblocks import num_sub_blocks, write_directory, read_directory

__all__ = [
    "Mode",
    "pack_mode",
    "unpack_mode",
    "BlockHeader",
    "pack_block_header",
    "parse_block_header",
    "make_stored_block",
    "num_sub_blocks",
    "write_directory",
    "read_directory",
]
