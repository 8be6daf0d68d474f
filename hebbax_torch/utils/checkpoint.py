"""Snapshot save/load in hebbax's ``HBAXCKP1`` container
(``hebbax/utils/checkpoint.py``).

File layout: the magic ``HBAXCKP1``, a ``<Q`` header length, the JSON
meta (threshold, hebb_params, excluded_layers), then the variable tree in
flax's msgpack layout: nested maps with string keys whose ndarray leaves
are ``ExtType(1, packb((shape, dtype_name, C-order bytes)))``.

The msgpack subset that layout needs is encoded and decoded here, so the
port depends on no msgpack package, and a snapshot crosses between hebbax
and the port in both directions.  The tree holds flax names and layouts
(``params``/``batch_stats``, kernels ``(*k, I, O)``);
:mod:`hebbax_torch.bridge` maps it to and from a ``state_dict``, told
which modules are transpose convs (``transposed``) where a kernel is 5-D.
"""

import json
import os
import struct

import numpy as np

MAGIC = b"HBAXCKP1"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_LEAF_BYTES = 2 ** 30   # flax chunks larger leaves; none is this big


# -- msgpack encoder --------------------------------------------------------

def _pack_len(out, n, small_tag, small_max, tags):
    """Append a length header: fix form below ``small_max``, else the
    8/16/32-bit form from ``tags`` (None where a width does not exist)."""
    if small_tag is not None and n < small_max:
        out.append(struct.pack("B", small_tag | n))
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            out.append(struct.pack("B", tag) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out, v):
    if 0 <= v < 128:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for tag, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out.append(struct.pack("B", tag) + struct.pack(fmt, v))
                return
        raise ValueError(f"int {v} too large for msgpack")
    else:
        for tag, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(struct.pack("B", tag) + struct.pack(fmt, v))
                return
        raise ValueError(f"int {v} too small for msgpack")


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    else:
        _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(struct.pack("b", code))
    out.append(data)


def _pack(out, obj):
    # numpy first: np.float64 is also a Python float
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"cannot serialize array {arr.dtype} "
                             f"{arr.shape}")
        inner = []
        _pack(inner, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        _pack_ext(out, code, b"".join(inner))
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, str(k))
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of a tree of dicts, lists, scalars and ndarrays."""
    out = []
    _pack(out, obj)
    return b"".join(out)


# -- msgpack decoder --------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data):
    shape, dtype_name, buf = unpackb(data)
    if isinstance(dtype_name, (bytes, bytearray)):
        dtype_name = dtype_name.decode()
    return np.frombuffer(bytes(buf), dtype=np.dtype(dtype_name)).reshape(
        tuple(shape), order="C").copy()


def _ext(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unpack(r):
    t = r.unpack("B")
    if t <= 0x7f:
        return t
    if t >= 0xe0:
        return t - 0x100
    if 0x80 <= t <= 0x8f:
        return _unpack_map(r, t & 0x0f)
    if 0x90 <= t <= 0x9f:
        return [_unpack(r) for _ in range(t & 0x0f)]
    if 0xa0 <= t <= 0xbf:
        return bytes(r.take(t & 0x1f)).decode("utf-8")
    simple = {0xc0: None, 0xc2: False, 0xc3: True}
    if t in simple:
        return simple[t]
    lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
            0xdb: ">I"}
    if t in lens:
        b = bytes(r.take(r.unpack(lens[t])))
        return b if t <= 0xc6 else b.decode("utf-8")
    nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    if t in nums:
        return r.unpack(nums[t])
    if t in (0xdc, 0xdd):
        n = r.unpack(">H" if t == 0xdc else ">I")
        return [_unpack(r) for _ in range(n)]
    if t in (0xde, 0xdf):
        return _unpack_map(r, r.unpack(">H" if t == 0xde else ">I"))
    fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
    if t in fixext:
        code = r.unpack("b")
        return _ext(code, r.take(fixext[t]))
    if t in (0xc7, 0xc8, 0xc9):
        n = r.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[t])
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _unpack_map(r, n):
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data):
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


# -- snapshots --------------------------------------------------------------

def _sorted_tree(tree):
    """Maps with sorted keys at every level: flax writes its trees so,
    which makes the port's snapshot bytes equal to hebbax's."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _write(out, meta, variables):
    header = json.dumps(meta, default=str).encode()
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(packb(_sorted_tree(variables)))
    os.replace(tmp, out)
    return out


def save_snapshot(state_dict, path, threshold=None, save_best=False,
                  hebb_params=None, layers_excluded=None, extra=None,
                  transposed=None):
    """Write ``best_JI.ckpt`` (save_best) or ``last.ckpt`` into ``path``
    from a model ``state_dict``; ``transposed``: the model's transpose
    conv paths (:func:`hebbax_torch.hebb.layers.transposed_paths`)."""
    from ..bridge import to_flax

    os.makedirs(path, exist_ok=True)
    name = "best_JI.ckpt" if save_best else "last.ckpt"
    meta = {
        "threshold": None if threshold is None else float(threshold),
        "hebb_params": hebb_params,
        "excluded_layers": layers_excluded,
    }
    if extra:
        meta.update(extra)
    params, batch_stats = to_flax(state_dict, transposed)
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return _write(os.path.join(path, name), meta, variables)


def load_snapshot(path):
    """Return (variables, meta): the flax-layout numpy tree and the JSON
    meta, as hebbax's ``load_snapshot`` does."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a hebbax checkpoint")
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen).decode())
        variables = unpackb(f.read())
    return variables, meta


def load_state_dict(path, transposed=None):
    """Return (state_dict, meta) from a snapshot file; the state_dict
    holds CPU tensors under the port's parameter names.  ``transposed``:
    the transpose conv paths of the model it is for (needed where a
    kernel is 5-D)."""
    from ..bridge import from_flax

    variables, meta = load_snapshot(path)
    return from_flax(variables["params"], variables.get("batch_stats"),
                     transposed), meta
