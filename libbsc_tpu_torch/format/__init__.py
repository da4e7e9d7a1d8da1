from .header import (
    Mode,
    pack_mode,
    unpack_mode,
    BlockHeader,
    pack_block_header,
    parse_block_header,
    make_stored_block,
)

__all__ = [
    "Mode",
    "pack_mode",
    "unpack_mode",
    "BlockHeader",
    "pack_block_header",
    "parse_block_header",
    "make_stored_block",
]
