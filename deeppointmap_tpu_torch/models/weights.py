"""Weights: a reader and a writer of Flax `.msgpack` checkpoints and the
maps between a Flax parameter tree and the port's state dicts (the port's
counterpart of deeppointmap_tpu/models/weights.py and of
pipeline/common.load_weights / save_weights).

`read_flax_msgpack` decodes the subset of MessagePack that
`flax.serialization.msgpack_serialize` writes -- maps, arrays, strings,
binaries, numbers, nil, booleans, and extension type 1 (an ndarray packed
as (shape, dtype name, C-order bytes)) and 3 (a NumPy scalar, packed the
same way) -- so that neither `msgpack` nor `flax` is needed.
`write_flax_msgpack` is its inverse for the trees the trainer saves: maps
with sorted string keys and ndarray leaves under extension type 1, each
item in its smallest MessagePack form, as `msgpack_serialize` writes them.

The port's submodules carry the Flax scope names, so the map is
mechanical: `a/b/kernel` -> `a.b.weight` transposed (Dense (in, out) ->
Linear (out, in)), `scale` -> `weight` (LayerNorm), `in_proj_kernel`
(C, 3C) -> `in_proj_weight` (3C, C); `flax_tree_from_state_dict` maps
back.

`load_torch_weight` reads the reference's `.pth` schema ({'encoder':
state_dict, 'decoder': state_dict} of its torch modules, reference:
pipeline/infer.py:63-65): `convert_encoder` / `convert_decoder` (copies of
the JAX package's) lay the reference's names onto a Flax tree, and the map
above takes it from there, so both formats reach one set of names.
`save_torch_weight` writes that schema: `convert_encoder_back` /
`convert_decoder_back` (copies of the JAX package's) invert the two
converters, so a model the port trained runs in the reference.
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


class _Writer:
    """MessagePack encoding of nested maps with str keys and ndarray
    leaves, each item in its smallest form (msgpack-python's choice)."""

    def __init__(self):
        self.parts = []

    def head(self, n: int, fix: int, fix_max: int, wide) -> None:
        """A length header: the fix form below `fix_max`, else the first
        of the (limit, type byte, struct format) forms that holds `n`."""
        if n < fix_max:
            self.parts.append(bytes([fix | n]))
            return
        for limit, byte, fmt in wide:
            if n < limit:
                self.parts.append(bytes([byte]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack item too long: {n}")

    def value(self, v) -> None:
        if isinstance(v, Mapping):
            self.head(len(v), 0x80, 16, ((1 << 16, 0xDE, ">H"),
                                         (1 << 32, 0xDF, ">I")))
            for k in sorted(v):
                self.value(str(k))
                self.value(v[k])
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self.head(len(b), 0xA0, 32, ((1 << 8, 0xD9, ">B"),
                                         (1 << 16, 0xDA, ">H"),
                                         (1 << 32, 0xDB, ">I")))
            self.parts.append(b)
        elif isinstance(v, bytes):
            self.head(len(v), 0, 0, ((1 << 8, 0xC4, ">B"),
                                     (1 << 16, 0xC5, ">H"),
                                     (1 << 32, 0xC6, ">I")))
            self.parts.append(v)
        elif isinstance(v, (tuple, list)):
            self.head(len(v), 0x90, 16, ((1 << 16, 0xDC, ">H"),
                                         (1 << 32, 0xDD, ">I")))
            for x in v:
                self.value(x)
        elif isinstance(v, int) and 0 <= v < 1 << 32:
            self.head(v, 0, 128, ((1 << 8, 0xCC, ">B"),
                                  (1 << 16, 0xCD, ">H"),
                                  (1 << 32, 0xCE, ">I")))
        elif isinstance(v, np.ndarray):
            self.ext(1, v)
        else:
            raise TypeError(f"cannot write {type(v).__name__} as msgpack")

    def ext(self, code: int, arr: np.ndarray) -> None:
        """An ndarray as extension `code`: (shape, dtype name, C bytes)."""
        inner = _Writer()
        inner.value((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        payload = b"".join(inner.parts)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.parts.append(bytes([fixext[n]]))
        else:
            self.head(n, 0, 0, ((1 << 8, 0xC7, ">B"), (1 << 16, 0xC8, ">H"),
                                (1 << 32, 0xC9, ">I")))
        self.parts.append(struct.pack(">b", code) + payload)


def write_flax_msgpack(path: str, tree: Mapping) -> None:
    """A nested dict of ndarrays -> a `.msgpack` file that
    `flax.serialization.msgpack_restore` (and `read_flax_msgpack`) read
    back as the same tree."""
    w = _Writer()
    w.value(tree)
    with open(path, "wb") as f:
        f.write(b"".join(w.parts))


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


def flax_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of `state_dict_from_flax`: a port module's state dict
    -> its Flax parameter tree (no 'params' root). 2-D `weight` ->
    `kernel` transposed, `in_proj_weight` -> `in_proj_kernel` transposed,
    1-D `weight` (LayerNorm) -> `scale`."""
    tree: dict = {}
    for name, t in sd.items():
        *scope, leaf = name.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "in_proj_weight":
            arr, leaf = arr.T, "in_proj_kernel"
        elif leaf == "weight":
            arr, leaf = (arr.T, "kernel") if arr.ndim == 2 else (arr, "scale")
        _set(tree, "/".join(scope + [leaf]), np.ascontiguousarray(arr))
    return tree


def state_dicts_from_jax(enc_tree: Mapping, dec_tree: Mapping):
    """Flax encoder and decoder trees -> (encoder state dict, decoder
    state dict) for models.encoder.Encoder and models.decoder.Decoder."""
    return state_dict_from_flax(enc_tree), state_dict_from_flax(dec_tree)


def load_msgpack_weights(path: str):
    """A checkpoint written by the JAX package ({'encoder': ..., 'decoder':
    ...}) -> (encoder state dict, decoder state dict)."""
    blob = read_flax_msgpack(path)
    return state_dicts_from_jax(blob["encoder"], blob["decoder"])


# ------------------------------------------------ the reference's .pth
# Layout rules (reference torch modules -> Flax tree):
#   Conv1d (out, in, 1)    -> Dense kernel (in, out) = w[:, :, 0].T
#   Conv2d (out, in, 1, 1) -> Dense kernel (in, out) = w[:, :, 0, 0].T
#   Linear (out, in)       -> Dense kernel (in, out) = w.T
#   LayerNorm weight/bias  -> scale/bias
#   MHA in_proj_weight (3C, C) -> in_proj_kernel (C, 3C) = w.T

def _t(w):  # torch Linear / MHA in_proj
    return np.asarray(w).T


def _c1(w):  # Conv1d k=1
    return np.asarray(w)[:, :, 0].T


def _c2(w):  # Conv2d k=1x1
    return np.asarray(w)[:, :, 0, 0].T


def _set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value, dtype=np.float32)


def _np(sd: Mapping, key: str) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _mlp_block(tree, sd, torch_prefix, flax_prefix, n_layers, conv):
    """build_mlp stack: torch indices 0,1[,3,4,...] = conv,ln pairs with the
    relu (no params) between pairs (reference:
    network/encoder/utils.py:378-389)."""
    for i in range(n_layers):
        ti = i * 3  # conv at 0, norm at 1, act at 2, next conv at 3 ...
        _set(tree, f"{flax_prefix}/dense{i}/kernel",
             conv(_np(sd, f"{torch_prefix}.{ti}.weight")))
        if f"{torch_prefix}.{ti}.bias" in sd:
            _set(tree, f"{flax_prefix}/dense{i}/bias",
                 _np(sd, f"{torch_prefix}.{ti}.bias"))
        _set(tree, f"{flax_prefix}/norm{i}/scale",
             _np(sd, f"{torch_prefix}.{ti + 1}.ln.weight"))
        _set(tree, f"{flax_prefix}/norm{i}/bias",
             _np(sd, f"{torch_prefix}.{ti + 1}.ln.bias"))


def convert_encoder(sd: Mapping, npoint_count: int, irm_counts) -> dict:
    """Reference encoder state dict -> Flax encoder tree (no 'params'
    root). irm_counts[i] = len(radius_list[i]) - 1 InvResMLP blocks per
    stage (reference: network/encoder/pointnext.py:158-167)."""
    p: dict = {}
    _set(p, "point_mlp0/kernel", _c1(_np(sd, "point_mlp0.weight")))
    _set(p, "point_mlp0/bias", _np(sd, "point_mlp0.bias"))
    for i in range(npoint_count):
        base = f"downsampler.{i}"
        _mlp_block(p, sd, f"{base}.sa.mlp", f"down{i}/sa/mlp", 1, _c2)
        for j in range(irm_counts[i]):
            tb = f"{base}.irm.{j}"
            fb = f"down{i}/irm{j}"
            _mlp_block(p, sd, f"{tb}.la.mlp", f"{fb}/la/mlp", 1, _c2)
            _mlp_block(p, sd, f"{tb}.pw_conv", f"{fb}/pw_conv", 2, _c1)
    # upsamplers: 2-layer 1d mlps
    ups = sorted({k.split(".")[1] for k in sd if k.startswith("upsampler.")})
    for i in ups:
        _mlp_block(p, sd, f"upsampler.{i}.mlp", f"up{i}/mlp", 2, _c1)
    return p


def _attn(p, sd, tb, fb):
    _set(p, f"{fb}/in_proj_kernel", _t(_np(sd, f"{tb}.in_proj_weight")))
    _set(p, f"{fb}/in_proj_bias", _np(sd, f"{tb}.in_proj_bias"))
    _set(p, f"{fb}/out_proj/kernel", _t(_np(sd, f"{tb}.out_proj.weight")))
    _set(p, f"{fb}/out_proj/bias", _np(sd, f"{tb}.out_proj.bias"))


def _seq_head(p, sd, tb, fb, names=("dense0", "dense1")):
    """Conv1d-relu-Conv1d heads (similarity / coarse pairing / loop mlp)."""
    for ti, fn in zip((0, 2), names):
        _set(p, f"{fb}/{fn}/kernel", _c1(_np(sd, f"{tb}.{ti}.weight")))
        _set(p, f"{fb}/{fn}/bias", _np(sd, f"{tb}.{ti}.bias"))


def convert_decoder(sd: Mapping, attention_layers: int = 3) -> dict:
    """Reference decoder state dict -> Flax decoder tree (no 'params'
    root)."""
    p: dict = {}
    _set(p, "projection/kernel", _c1(_np(sd, "projection.weight")))
    _set(p, "projection/bias", _np(sd, "projection.bias"))
    for i in range(attention_layers):
        tb = f"descriptor_attention.{i}"
        fb = f"attn{i}"
        _attn(p, sd, f"{tb}.self_attn", f"{fb}/self_attn")
        _attn(p, sd, f"{tb}.cross_attn", f"{fb}/cross_attn")
        for ti, fn in ((0, "mlp0"), (2, "mlp1")):
            _set(p, f"{fb}/{fn}/kernel", _t(_np(sd, f"{tb}.mlp.{ti}.weight")))
            _set(p, f"{fb}/{fn}/bias", _np(sd, f"{tb}.mlp.{ti}.bias"))
        for norm in ("norm1", "norm2", "norm3"):
            _set(p, f"{fb}/{norm}/scale", _np(sd, f"{tb}.{norm}.weight"))
            _set(p, f"{fb}/{norm}/bias", _np(sd, f"{tb}.{norm}.bias"))
    _seq_head(p, sd, "similarity_head", "similarity_head")
    _seq_head(p, sd, "coarse_pairing_head", "coarse_pairing_head")
    # offset head: mlp convs at 0, 2, 4 + downsample + head
    for ti, fn in ((0, "mlp0"), (2, "mlp1"), (4, "mlp2")):
        _set(p, f"offset_head/{fn}/kernel",
             _c1(_np(sd, f"offset_head.mlp.{ti}.weight")))
        _set(p, f"offset_head/{fn}/bias",
             _np(sd, f"offset_head.mlp.{ti}.bias"))
    for name in ("downsample", "head"):
        _set(p, f"offset_head/{name}/kernel",
             _c1(_np(sd, f"offset_head.{name}.weight")))
        _set(p, f"offset_head/{name}/bias",
             _np(sd, f"offset_head.{name}.bias"))
    _seq_head(p, sd, "loop_head.mlp", "loop_head", names=("mlp0", "mlp1"))
    for ti, fn in ((0, "proj0"), (2, "proj1")):
        _set(p, f"loop_head/{fn}/kernel",
             _t(_np(sd, f"loop_head.projection.{ti}.weight")))
        _set(p, f"loop_head/{fn}/bias",
             _np(sd, f"loop_head.projection.{ti}.bias"))
    return p


def load_torch_weight(path: str, args):
    """A `.pth` weight file in the reference's schema -> (encoder state
    dict, decoder state dict), the same names and layouts as
    `load_msgpack_weights` gives. The file holds tensors only, so it is read
    with `weights_only=True` (no pickled code runs)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    e = args.encoder
    irm_counts = [len(r) - 1 for r in e.radius_list]
    enc = convert_encoder(blob["encoder"], len(e.npoint), irm_counts)
    dec = convert_decoder(blob["decoder"], int(args.decoder.attention_layers))
    return state_dicts_from_jax(enc, dec)


# ----------------------------------------- the reference's .pth, written
# The inverse of convert_encoder / convert_decoder (copies of the JAX
# package's convert_encoder_back / convert_decoder_back): a Flax tree ->
# the reference's state dicts, in the JAX writer's key order.

def _get(tree: Mapping, path: str) -> np.ndarray:
    node = tree
    for p in path.split("/"):
        node = node[p]
    return np.asarray(node)


def _inv_mlp_block(out, tree, torch_prefix, flax_prefix, n_layers, to_conv):
    for i in range(n_layers):
        ti = i * 3
        out[f"{torch_prefix}.{ti}.weight"] = to_conv(
            _get(tree, f"{flax_prefix}/dense{i}/kernel"))
        try:
            out[f"{torch_prefix}.{ti}.bias"] = _get(
                tree, f"{flax_prefix}/dense{i}/bias")
        except KeyError:
            pass
        out[f"{torch_prefix}.{ti + 1}.ln.weight"] = _get(
            tree, f"{flax_prefix}/norm{i}/scale")
        out[f"{torch_prefix}.{ti + 1}.ln.bias"] = _get(
            tree, f"{flax_prefix}/norm{i}/bias")


def _to_c1(k):  # Dense kernel (in, out) -> Conv1d weight (out, in, 1)
    return np.asarray(k).T[:, :, None]


def _to_c2(k):  # -> Conv2d weight (out, in, 1, 1)
    return np.asarray(k).T[:, :, None, None]


def convert_encoder_back(params: Mapping, npoint_count: int,
                         irm_counts) -> dict:
    """Flax encoder tree (no 'params' root) -> the reference's encoder
    state dict (NumPy values), the inverse of `convert_encoder`."""
    out: dict = {}
    out["point_mlp0.weight"] = _to_c1(_get(params, "point_mlp0/kernel"))
    out["point_mlp0.bias"] = _get(params, "point_mlp0/bias")
    for i in range(npoint_count):
        _inv_mlp_block(out, params, f"downsampler.{i}.sa.mlp",
                       f"down{i}/sa/mlp", 1, _to_c2)
        for j in range(irm_counts[i]):
            _inv_mlp_block(out, params, f"downsampler.{i}.irm.{j}.la.mlp",
                           f"down{i}/irm{j}/la/mlp", 1, _to_c2)
            _inv_mlp_block(out, params, f"downsampler.{i}.irm.{j}.pw_conv",
                           f"down{i}/irm{j}/pw_conv", 2, _to_c1)
    i = 0
    while f"up{i}" in params:
        _inv_mlp_block(out, params, f"upsampler.{i}.mlp", f"up{i}/mlp", 2,
                       _to_c1)
        i += 1
    return out


def convert_decoder_back(params: Mapping, attention_layers: int = 3) -> dict:
    """Flax decoder tree (no 'params' root) -> the reference's decoder
    state dict (NumPy values), the inverse of `convert_decoder`."""
    out: dict = {}
    out["projection.weight"] = _to_c1(_get(params, "projection/kernel"))
    out["projection.bias"] = _get(params, "projection/bias")
    for i in range(attention_layers):
        tb = f"descriptor_attention.{i}"
        fb = f"attn{i}"
        for attn in ("self_attn", "cross_attn"):
            out[f"{tb}.{attn}.in_proj_weight"] = _get(
                params, f"{fb}/{attn}/in_proj_kernel").T
            out[f"{tb}.{attn}.in_proj_bias"] = _get(
                params, f"{fb}/{attn}/in_proj_bias")
            out[f"{tb}.{attn}.out_proj.weight"] = _get(
                params, f"{fb}/{attn}/out_proj/kernel").T
            out[f"{tb}.{attn}.out_proj.bias"] = _get(
                params, f"{fb}/{attn}/out_proj/bias")
        for ti, fn in ((0, "mlp0"), (2, "mlp1")):
            out[f"{tb}.mlp.{ti}.weight"] = _get(params,
                                                f"{fb}/{fn}/kernel").T
            out[f"{tb}.mlp.{ti}.bias"] = _get(params, f"{fb}/{fn}/bias")
        for norm in ("norm1", "norm2", "norm3"):
            out[f"{tb}.{norm}.weight"] = _get(params, f"{fb}/{norm}/scale")
            out[f"{tb}.{norm}.bias"] = _get(params, f"{fb}/{norm}/bias")
    for tb, fb, names in (("similarity_head", "similarity_head",
                           ("dense0", "dense1")),
                          ("coarse_pairing_head", "coarse_pairing_head",
                           ("dense0", "dense1")),
                          ("loop_head.mlp", "loop_head", ("mlp0", "mlp1"))):
        for ti, fn in zip((0, 2), names):
            out[f"{tb}.{ti}.weight"] = _to_c1(_get(params,
                                                   f"{fb}/{fn}/kernel"))
            out[f"{tb}.{ti}.bias"] = _get(params, f"{fb}/{fn}/bias")
    for ti, fn in ((0, "mlp0"), (2, "mlp1"), (4, "mlp2")):
        out[f"offset_head.mlp.{ti}.weight"] = _to_c1(
            _get(params, f"offset_head/{fn}/kernel"))
        out[f"offset_head.mlp.{ti}.bias"] = _get(params,
                                                 f"offset_head/{fn}/bias")
    for name in ("downsample", "head"):
        out[f"offset_head.{name}.weight"] = _to_c1(
            _get(params, f"offset_head/{name}/kernel"))
        out[f"offset_head.{name}.bias"] = _get(params,
                                               f"offset_head/{name}/bias")
    for ti, fn in ((0, "proj0"), (2, "proj1")):
        out[f"loop_head.projection.{ti}.weight"] = _get(
            params, f"loop_head/{fn}/kernel").T
        out[f"loop_head.projection.{ti}.bias"] = _get(params,
                                                      f"loop_head/{fn}/bias")
    return out


def _as_flax_tree(model) -> Mapping:
    """A port module, its state dict, or a Flax tree (with or without the
    'params' root) -> the Flax tree."""
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    if model and all(isinstance(v, torch.Tensor) for v in model.values()):
        return flax_tree_from_state_dict(model)
    return model["params"] if set(model) == {"params"} else model


def save_torch_weight(path: str, enc, dec, args) -> None:
    """Write a model in the reference's `.pth` schema ({'encoder': sd,
    'decoder': sd} of CPU float32 tensors, reference:
    pipeline/infer.py:63-65). `enc` / `dec`: the port's Encoder / Decoder,
    their state dicts, or Flax trees. `load_torch_weight` reads it back."""
    e = args.encoder
    irm_counts = [len(r) - 1 for r in e.radius_list]
    sds = (convert_encoder_back(_as_flax_tree(enc), len(e.npoint),
                                irm_counts),
           convert_decoder_back(_as_flax_tree(dec),
                                int(args.decoder.attention_layers)))
    enc_sd, dec_sd = ({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()} for sd in sds)
    torch.save({"encoder": enc_sd, "decoder": dec_sd}, path)
