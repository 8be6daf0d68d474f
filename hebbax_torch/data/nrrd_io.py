"""Minimal NRRD reader/writer (pure Python + numpy): a copy of
``hebbax/data/nrrd_io.py``, header lines included, so a file written by
either package is byte-equal to the other's.

The format (teem.sourceforge.net/nrrd/format.html) is a text header
followed by a raw or gzip data blob.  Supports the
fields the Atrial/LA pipeline needs (sizes, type, endian, encoding, space
directions, space origin) and preserves the affine on round-trip.

Data layout note: NRRD stores the FIRST axis fastest (Fortran order wrt
the sizes list); arrays here are numpy with shape == sizes, C-indexed as
arr[x, y, z] like SimpleITK's GetArrayFromImage transposed — i.e. index i
of ``sizes`` is axis i of the returned array.
"""

import gzip
import os
from typing import Optional, Tuple

import numpy as np

_TYPE_MAP = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "int64": np.int64,
    "int64_t": np.int64,
    "float": np.float32, "double": np.float64,
}
_INV_TYPE = {np.dtype(np.uint8): "unsigned char",
             np.dtype(np.int16): "short",
             np.dtype(np.int32): "int",
             np.dtype(np.float32): "float",
             np.dtype(np.float64): "double"}


def _parse_vector(s):
    s = s.strip()
    if s == "none":
        return None
    return [float(x) for x in s.strip("()").split(",")]


def read_nrrd(path) -> Tuple[np.ndarray, dict]:
    """Return (array with shape == sizes, header dict incl. 'affine')."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path}: not an NRRD file")
        fields = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("ascii", "replace").strip()
            if text.startswith("#") or not text:
                continue
            if ":=" in text:
                k, v = text.split(":=", 1)
            else:
                k, v = text.split(":", 1)
            fields[k.strip().lower()] = v.strip()
        blob = f.read()

    sizes = [int(x) for x in fields["sizes"].split()]
    dtype = np.dtype(_TYPE_MAP[fields["type"]])
    if fields.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    enc = fields.get("encoding", "raw")
    if enc in ("gzip", "gz"):
        blob = gzip.decompress(blob)
    elif enc != "raw":
        raise NotImplementedError(f"NRRD encoding {enc!r}")
    arr = np.frombuffer(blob, dtype=dtype, count=int(np.prod(sizes)))
    # first axis fastest -> reshape reversed then transpose; copy to a
    # writable contiguous array (frombuffer views are read-only)
    arr = np.ascontiguousarray(
        arr.reshape(sizes[::-1]).transpose(range(len(sizes))[::-1]))

    header = dict(fields)
    dirs = None
    if "space directions" in fields:
        vecs = [
            _parse_vector(v) for v in fields["space directions"].split(") ")
        ]
        dirs = [v for v in vecs if v is not None]
    origin = (_parse_vector(fields["space origin"])
              if "space origin" in fields else None)
    affine = np.eye(4)
    if dirs is not None:
        d = np.asarray(dirs, float)
        affine[:3, :3] = d.T
    if origin is not None:
        affine[:3, 3] = origin
    header["affine"] = affine
    header["sizes"] = sizes
    return arr, header


def write_nrrd(path, arr: np.ndarray, affine: Optional[np.ndarray] = None,
               encoding: str = "gzip", space: str = "left-posterior-superior"):
    arr = np.asarray(arr)
    dtype = arr.dtype
    if dtype not in _INV_TYPE:
        arr = arr.astype(np.float32)
        dtype = arr.dtype
    lines = ["NRRD0004",
             "# hebbax nrrd writer",
             f"type: {_INV_TYPE[np.dtype(dtype)]}",
             f"dimension: {arr.ndim}",
             f"sizes: {' '.join(str(s) for s in arr.shape)}",
             f"encoding: {encoding}",
             "endian: little"]
    if arr.ndim == 3:
        lines.append(f"space: {space}")
        aff = np.eye(4) if affine is None else np.asarray(affine, float)
        d = aff[:3, :3].T
        dirs = " ".join("({},{},{})".format(*row) for row in d)
        lines.append(f"space directions: {dirs}")
        lines.append("space origin: ({},{},{})".format(*aff[:3, 3]))
        lines.append("kinds: domain domain domain")
    blob = np.ascontiguousarray(
        arr.transpose(range(arr.ndim)[::-1])).tobytes()
    if encoding == "gzip":
        blob = gzip.compress(blob)
    elif encoding != "raw":
        raise NotImplementedError(encoding)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(blob)
