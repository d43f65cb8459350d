"""Little-endian byte-stream serialization.

Mirrors the wire format of the reference's twk_buffer_t SerializePrimitive /
SerializeString helpers (reference: include/buffer.h:149-156,
lib/buffer.cpp:410-421): primitives are raw little-endian, strings are a
uint32 length followed by raw bytes.
"""

import struct


class BufferWriter:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts = []

    def raw(self, b: bytes):
        self._parts.append(bytes(b))
        return self

    def u8(self, v):
        return self.raw(struct.pack("<B", v))

    def u16(self, v):
        return self.raw(struct.pack("<H", v))

    def u32(self, v):
        return self.raw(struct.pack("<I", v))

    def u64(self, v):
        return self.raw(struct.pack("<Q", v))

    def i32(self, v):
        return self.raw(struct.pack("<i", v))

    def i64(self, v):
        return self.raw(struct.pack("<q", v))

    def f32(self, v):
        return self.raw(struct.pack("<f", v))

    def f64(self, v):
        return self.raw(struct.pack("<d", v))

    def string(self, s):
        b = s.encode() if isinstance(s, str) else bytes(s)
        self.u32(len(b))
        return self.raw(b)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)

    def __len__(self):
        return sum(len(p) for p in self._parts)


class BufferReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def raw(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError(f"buffer underrun: wanted {n}, got {len(b)}")
        self.pos += n
        return b

    def _unpack(self, fmt: str, size: int):
        try:
            (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        except struct.error as e:
            raise EOFError(f"buffer underrun: {e}") from None
        self.pos += size
        return v

    def u8(self):
        return self._unpack("<B", 1)

    def u16(self):
        return self._unpack("<H", 2)

    def u32(self):
        return self._unpack("<I", 4)

    def u64(self):
        return self._unpack("<Q", 8)

    def i32(self):
        return self._unpack("<i", 4)

    def i64(self):
        return self._unpack("<q", 8)

    def f32(self):
        return self._unpack("<f", 4)

    def f64(self):
        return self._unpack("<d", 8)

    def string(self) -> str:
        n = self.u32()
        return self.raw(n).decode()

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def eof(self) -> bool:
        return self.pos >= len(self.buf)
