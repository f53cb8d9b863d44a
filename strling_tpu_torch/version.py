"""Versioning for strling_tpu and the binary evidence ("bin") file format.

Mirrors reference src/strpkg/version.nim:1-8: the bin format carries a 3-byte
magic "STR", an int16 format version, and the 9-char software version string.
We keep the reference's format version 0 so bin files interoperate.
"""

__version__ = "0.1.0"

# Version string embedded in bin files. The reference embeds its own version
# ("0.6.0"); readers only warn on mismatch (unpack.nim:74-75), and assert on
# the *format* version (unpack.nim:66). We embed our own software version.
STRLING_VERSION = "0.6.0"

# bin file format version (must match reference thisFmtVersion for interop,
# version.nim:4)
BIN_FMT_VERSION = 0


def as_array9(s: str) -> bytes:
    """9-byte zero-padded version field (version.nim:6-8)."""
    b = s.encode()[:9]
    return b + b"\x00" * (9 - len(b))
