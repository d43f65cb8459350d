"""Typed file-corruption errors.

The reference error-checks every marker/magic on open and read
(reference: lib/two_reader.cpp:98-151, twk_reader.cpp:30-90); these
errors are the equivalent surface. All derive from ValueError so
existing callers that catch ValueError keep working, and each carries
the file path and byte offset for diagnostics.
"""


class CorruptFileError(ValueError):
    """A structural inconsistency in a tomahawk archive: bad magic, bad
    marker, truncated section, or an undecompressable block."""

    def __init__(self, path: str, detail: str, offset=None):
        self.path = path
        self.offset = offset
        self.detail = detail
        at = f" (at byte offset {offset})" if offset is not None else ""
        super().__init__(f"{path}: {detail}{at}")


def read_exact(fh, n: int, path: str, what: str) -> bytes:
    """Read exactly n bytes or raise a CorruptFileError naming the
    section and offset. Guards against corrupt length fields before
    allocating."""
    off = fh.tell()
    end = fh.seek(0, 2)
    fh.seek(off)
    if n > end - off:
        raise CorruptFileError(
            path, f"truncated {what}: wanted {n} bytes, "
            f"got {max(end - off, 0)}", off)
    b = fh.read(n)
    if len(b) != n:
        raise CorruptFileError(
            path, f"truncated {what}: wanted {n} bytes, got {len(b)}", off)
    return b


def parse_checked(fn, buf: bytes, path: str, what: str, offset=None):
    """Run a deserializer over an in-memory section, mapping parse
    failures (underruns, bad struct fields, undecodable strings) to
    CorruptFileError."""
    try:
        return fn(buf)
    except (EOFError, ValueError, KeyError, UnicodeDecodeError,
            MemoryError) as e:
        raise CorruptFileError(path, f"corrupt {what}: {e}",
                               offset) from None


def decompress_checked(dctx, payload: bytes, b_unc: int, path: str,
                       what: str, offset=None) -> bytes:
    """zstd-decompress one section, mapping codec failures and size
    mismatches to CorruptFileError."""
    import zstandard
    if not 0 <= b_unc <= (1 << 40):
        raise CorruptFileError(
            path, f"corrupt {what}: implausible uncompressed size "
            f"{b_unc}", offset)
    try:
        out = dctx.decompress(payload, max_output_size=max(b_unc, 1))
    except (zstandard.ZstdError, MemoryError) as e:
        raise CorruptFileError(path, f"corrupt {what}: {e}",
                               offset) from None
    if len(out) != b_unc:
        raise CorruptFileError(
            path, f"corrupt {what}: decompressed to {len(out)} bytes, "
            f"expected {b_unc}", offset)
    return out
