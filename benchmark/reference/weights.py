"""A reader of Flax `.msgpack` checkpoints for the plain reference: the
MessagePack subset that `flax.serialization.msgpack_serialize` writes
(maps, strings, arrays as extension type 1, scalars as type 3). Written
for the benchmark; it shares no code with the program's reader."""

from __future__ import annotations

import struct

import numpy as np
import torch


class _Cursor:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if b & 0xF0 == 0x90:
            return [self.read() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}      # str
        if b in sized:
            raw = self.take(self.num(sized[b]))
            return raw.decode() if b >= 0xD9 else raw
        if b in (0xC7, 0xC8, 0xC9):                       # ext
            n = self.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.num(">b")
            return _ext(code, self.take(n))
        if 0xD4 <= b <= 0xD8:                             # fixext
            code = self.num(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.num(scalars[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(
                self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            n = self.num(">H" if b == 0xDE else ">I")
            return {self.read(): self.read() for _ in range(n)}
        raise ValueError(f"msgpack type byte 0x{b:02x} not read here")


def _ext(code: int, payload: bytes):
    if code not in (1, 3):
        raise ValueError(f"msgpack extension {code} not read here")
    shape, dtype, buf = _Cursor(payload).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if code == 3 else arr


def read_tree(path: str) -> dict:
    """A `.msgpack` checkpoint -> nested dict with NumPy leaves."""
    with open(path, "rb") as f:
        cur = _Cursor(f.read())
    tree = cur.read()
    if cur.pos != len(cur.data):
        raise ValueError(f"{path}: trailing bytes")
    return tree


def to_torch(tree, device) -> dict:
    """The tree with float32 torch leaves on `device`."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.array(tree, np.float32), device=device)
