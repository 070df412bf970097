"""Weights: a reader for Flax `.msgpack` checkpoints and the map from a
Flax parameter tree to the port's state dicts (the port's counterpart of
deeppointmap_tpu/models/weights.py and pipeline/common.load_weights).

`read_flax_msgpack` decodes the subset of MessagePack that
`flax.serialization.msgpack_serialize` writes -- maps, arrays, strings,
binaries, numbers, nil, booleans, and extension type 1 (an ndarray packed
as (shape, dtype name, C-order bytes)) and 3 (a NumPy scalar, packed the
same way) -- so that neither `msgpack` nor `flax` is needed.

The port's submodules carry the Flax scope names, so the map is
mechanical: `a/b/kernel` -> `a.b.weight` transposed (Dense (in, out) ->
Linear (out, in)), `scale` -> `weight` (LayerNorm), `in_proj_kernel`
(C, 3C) -> `in_proj_weight` (3C, C).
"""

from __future__ import annotations

import struct
from typing import Dict, Mapping

import numpy as np
import torch


class _Reader:
    """A cursor over one MessagePack buffer."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                          0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self.unpack(">b"), self.take(n))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:                            # fixext 1..16
            code = self.unpack(">b")
            return self._ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    @staticmethod
    def _ext(code: int, payload: bytes):
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, buf = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == 3 else arr


def read_flax_msgpack(path: str) -> dict:
    """A Flax `.msgpack` checkpoint -> nested dict with NumPy leaves
    (the result of `flax.serialization.msgpack_restore`)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return out


def _flat(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One Flax parameter tree (optionally under a 'params' key) -> a state
    dict of the port module with the same scope names."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, arr in _flat(tree):
        *scope, leaf = path.split("/")
        if leaf in ("kernel", "in_proj_kernel"):
            arr = arr.T
            leaf = "weight" if leaf == "kernel" else "in_proj_weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(scope + [leaf])] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    return sd


def state_dicts_from_jax(enc_tree: Mapping, dec_tree: Mapping):
    """Flax encoder and decoder trees -> (encoder state dict, decoder
    state dict) for models.encoder.Encoder and models.decoder.Decoder."""
    return state_dict_from_flax(enc_tree), state_dict_from_flax(dec_tree)


def load_msgpack_weights(path: str):
    """A checkpoint written by the JAX package ({'encoder': ..., 'decoder':
    ...}) -> (encoder state dict, decoder state dict)."""
    blob = read_flax_msgpack(path)
    return state_dicts_from_jax(blob["encoder"], blob["decoder"])
