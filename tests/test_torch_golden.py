"""Known-answer archives through the port's CLI: the exact bytes of
``tests/test_golden.py``, so the port's on-disk format cannot drift from
the JAX package's.

GOLDEN_41 is the reference binary's output (a stored block); GOLDEN_1K
pins the QLFC-static stream of the default config.
"""

from libbsc_tpu_torch import cli

SAMPLE_41 = b"the quick brown fox jumps over a lazy dog"[:41]
SAMPLE_1K = (b"the quick brown fox jumps over a lazy dog. " * 24)[:1024]

GOLDEN_41 = bytes.fromhex(
    "627363310100000000000000000000000101450000002900000000000000000000"
    "001a0f2e401a0f2e409d01820e74686520717569636b2062726f776e20666f7820"
    "6a756d7073206f7665722061206c617a7920646f67"
)

GOLDEN_1K = bytes.fromhex(
    "627363310100000000000000000000000101800000000004000021800f00010000"
    "001d6fcd933b305c503904f4240100000000c70066ee1dd805a3681ed013fec238"
    "d6ca74c6edc28d34cf15e92c2442f86bdfae6686efddf51a18fe137fbd0c6858bb"
    "d5e6f51da3a6157d3119413f27d5c06efc77a8242bb012bb4b3ccdcbb2c3cab912"
    "5e7abc40ddec37df319ba9000000"
)


def _cli_encode(tmp_path, data: bytes) -> bytes:
    inp = tmp_path / "in.bin"
    out = tmp_path / "out.bsc"
    inp.write_bytes(data)
    cli.compress_file(str(inp), str(out), cli.Params(), quiet=True)
    return out.read_bytes()


def test_golden_41_bytes(tmp_path):
    assert _cli_encode(tmp_path, SAMPLE_41) == GOLDEN_41


def test_golden_1k_bytes(tmp_path):
    assert _cli_encode(tmp_path, SAMPLE_1K) == GOLDEN_1K


def test_golden_archives_decode(tmp_path):
    for golden, data in [(GOLDEN_41, SAMPLE_41), (GOLDEN_1K, SAMPLE_1K)]:
        arch = tmp_path / "a.bsc"
        restored = tmp_path / "r.bin"
        arch.write_bytes(golden)
        cli.decompress_file(str(arch), str(restored), cli.Params(),
                            quiet=True)
        assert restored.read_bytes() == data


def test_golden_header_fields():
    # 'bsc1' magic, int32 nBlocks=1, block header at offset 8
    assert GOLDEN_41[:4] == b"bsc1"
    assert int.from_bytes(GOLDEN_41[4:8], "little") == 1
    # stored block: mode word 0 (bytes 8..12 of the 28-byte block header
    # after the 10-byte container entry header)
    assert int.from_bytes(GOLDEN_41[18 + 8:18 + 12], "little") == 0
    # compressible block: BWT + QLFC static with LZP(15, 128)
    mode1k = int.from_bytes(GOLDEN_1K[18 + 8:18 + 12], "little")
    assert mode1k & 0x1F == 1
    assert (mode1k >> 5) & 0x7 == 1
    assert (mode1k >> 8) & 0xFF == 128 and (mode1k >> 16) & 0xFF == 15
