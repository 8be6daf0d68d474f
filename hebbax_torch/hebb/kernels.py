"""SWTA-delta dispatcher and the wrapper of its CUDA kernel
(``hebbax/hebb/pallas_kernels.py`` ``swta_delta`` / ``swta_delta_pallas``).

:func:`swta_delta` routes by rank, stride and shape.  hebbax's
dispatcher sends only 2D stride-1 convs to its fused kernel
(``pallas_kernels.py:164-166``); the port's kernel takes those whose
output has the input's size, as every 2D forward conv of the networks
does:

* a 2D stride-1 conv whose output has its input's size (every forward
  conv of the 2D networks) goes to the hand-written kernel
  ``csrc/swta_delta.cu`` through :data:`SWTA_DELTA` for CUDA tensors, or
  raises — there is no fallback and no environment switch — and to its
  plain version :func:`rules.swta_conv_delta` for CPU tensors;
* every other site — a 5-D weight (a 3D conv), a strided conv (VNet's
  down convs, a swapped k = s = 2 transpose conv), a VALID stride-1 one —
  goes to the composed rule :func:`rules.swta_wgrad_delta` on any device:
  no kernel of the port takes it, and K1 assumes stride 1 and a same-size
  output, so it must never see one.

The wrapper checks device, dtype, contiguity and shape, allocates the
output and the workspace with ``torch.empty``, launches on the current
stream, raises on a launch error, and counts its launches.
"""

import ctypes
from typing import NamedTuple

import torch

from . import rules

_KP = 32            # pixels per stage: the K depth of a stage in the kernel
_MAX_O = 512        # every O channel of a stage is staged in shared memory
_MAX_SMEM = 232448  # dynamic shared memory a block may use (H100)
_SM_SMEM = 233472   # shared memory of one SM
_WAVES = 1          # pixel ranges are chosen to fill about this many waves
_WORKSPACE = 64 * 2 ** 20   # bytes of partials at most


class Plan(NamedTuple):
    """Tile and split of one launch: ``nwg`` the wgmma width (8..128),
    ``wm``/``wn`` the warpgroups along M/N, ``halo`` whether x is staged
    as rows with a margin (16-byte copies) rather than gathered per patch
    element, ``smem`` the block's dynamic shared memory in bytes, and the
    pixel ranges."""
    nwg: int
    wm: int
    wn: int
    halo: bool
    smem: int
    ranges: int
    range_len: int


class SwtaDeltaKernel:
    """ctypes wrapper of ``hebbax_swta_delta_f32`` with a launch count."""

    name = "swta_delta"
    source = "hebbax_torch/csrc/swta_delta.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            from .. import build
            fn = build.load("swta_delta").hebbax_swta_delta_f32
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_int,
                              ctypes.c_longlong] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    @staticmethod
    def check(w, x, y, padding):
        """Raise ValueError unless the kernel takes these operands."""
        for t, nm in ((w, "w"), (x, "x"), (y, "y")):
            if not t.is_cuda:
                raise ValueError(f"{nm} must be a CUDA tensor")
            if t.dtype != torch.float32:
                raise ValueError(f"{nm} must be float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{nm} must be contiguous")
            if t.dim() != 4:
                raise ValueError(f"{nm} must be 4-D, got {tuple(t.shape)}")
        if not (w.device == x.device == y.device):
            raise ValueError("w, x and y must lie on one device")
        o, i, kh, kw = w.shape
        n, c, h, wd = x.shape
        ph, pw = padding
        if c != i or tuple(y.shape) != (n, o, h, wd):
            raise ValueError(f"shapes do not match: w {tuple(w.shape)}, "
                             f"x {tuple(x.shape)}, y {tuple(y.shape)}")
        if h + 2 * ph - kh + 1 != h or wd + 2 * pw - kw + 1 != wd:
            raise ValueError(f"padding {padding} with kernel {kh}x{kw} is "
                             "not a same-size stride-1 conv")
        if o > _MAX_O:
            raise ValueError(f"O={o} exceeds the kernel's limit {_MAX_O}")
        if n * h * wd == 0:
            raise ValueError("empty input")
        if i * h * wd >= 2 ** 31 or n * h * wd >= 2 ** 30:
            raise ValueError("x is too large for the kernel's 32-bit "
                             "pixel and image indices")

    @staticmethod
    def tile(m, o):
        """(nwg, wm, wn): the block tile for M = m, O = o.  One
        warpgroup per 64 rows of M (two where 128-row tiles pad M no more
        than 64-row tiles do) by all O channels rounded up to a wgmma
        width; 128 < O <= 256 takes two warpgroups along N; O > 256 goes
        in chunks of 128."""
        n = -(-o // 8) * 8
        if n <= 128:
            nwg = next(w for w in (8, 16, 32, 64, 128) if w >= n)
            wm = 2 if m > 64 and (m % 128 == 0 or m % 128 > 64) else 1
            return nwg, wm, 1
        if n <= 256:
            return 128, 1, 2
        return 128, 1, 1

    @staticmethod
    def halo(h, wd, pw, aligned=True):
        """Whether the kernel can stage x as rows with a 4-column margin:
        W a multiple of 4, taps at most 4 columns off, a stage's 32 pixels
        the aligned segment of one row or whole rows of one image, and x
        and y 16-byte aligned."""
        return (aligned and wd % 4 == 0 and pw <= 4
                and (wd % _KP == 0 or (_KP % wd == 0 and h * wd % _KP == 0)))

    @staticmethod
    def x_slot(bm, i, wd, kh, kw, halo):
        """Floats of one stage of x in shared memory (the kernel's
        ``Shape::x_slot``): the rows of the channels that bm patch rows
        touch, with the margin, or bm gathered rows of 32 pixels."""
        if not halo:
            return bm * _KP
        wt = min(wd, _KP)
        n_ch = min(i, (bm - 1) // (kh * kw) + 2)
        return n_ch * (_KP // wt + kh - 1) * (wt + 8)

    @staticmethod
    def smem_bytes(o, nwg, wm, wn, x_slot):
        """Dynamic shared memory of one block (``Tile::smem_bytes`` in
        the kernel): the raw y and x ring of two stages, the hi/lo B
        operands with padded K-chunks, and the row table."""
        bm, nb, nw = 64 * wm, nwg * wn, 4 * wm * wn
        ys = _KP + 32 // nw     # padded channel row of y
        op_b = _KP // 4 * (nb * 4 + 4)
        return 4 * (2 * (o * ys + x_slot) + 2 * op_b + 4 * bm)

    @classmethod
    def plan(cls, n, i, h, wd, o, kh, kw, sm_count, aligned=True):
        """The :class:`Plan` of a launch: the tile, and pixel ranges, each
        a whole number of 32-pixel stages, for about _WAVES waves of
        blocks over the SMs, with at most _WORKSPACE bytes of partials."""
        p, m = n * h * wd, i * kh * kw
        nwg, wm, wn = cls.tile(m, o)
        halo = cls.halo(h, wd, (kw - 1) // 2, aligned)
        smem = cls.smem_bytes(o, nwg, wm, wn,
                              cls.x_slot(64 * wm, i, wd, kh, kw, halo))
        per_sm = max(1, min(_SM_SMEM // (smem + 1024),
                            2048 // (128 * wm * wn)))
        tiles = -(-m // (64 * wm)) * -(-o // (nwg * wn))
        n_stages = -(-p // _KP)
        ranges = -(-_WAVES * sm_count * per_sm // tiles)
        ranges = max(1, min(n_stages, ranges, _WORKSPACE // (4 * m * o)))
        range_len = -(-n_stages // ranges) * _KP
        return Plan(nwg, wm, wn, halo, smem, -(-p // range_len),
                    range_len)

    def __call__(self, w, x, y, k, padding):
        self.check(w, x, y, padding)
        o, i, kh, kw = w.shape
        n, _, h, wd = x.shape
        m = i * kh * kw
        dev = x.device
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
        pl = self.plan(n, i, h, wd, o, kh, kw, sm_count, aligned)
        delta = torch.empty_like(w)
        part = torch.empty((pl.ranges, o, m), dtype=torch.float32,
                           device=dev)
        rsum = torch.empty((pl.ranges, o), dtype=torch.float32, device=dev)
        fn = self._entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(),
                    delta.data_ptr(), part.data_ptr(), rsum.data_ptr(),
                    n, i, h, wd, o, kh, kw, padding[0], padding[1],
                    float(k), pl.ranges, pl.range_len, pl.nwg, pl.wm,
                    pl.wn, int(pl.halo), stream)
        if rc != 0:
            raise RuntimeError(f"swta_delta kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        return delta


SWTA_DELTA = SwtaDeltaKernel()


def swta_delta(w, x, y, k, padding, stride=1):
    """SWTA delta of a forward conv: K1 for a 2D stride-1 same-size conv
    on CUDA tensors, its plain version for one on CPU tensors, the
    composed rule for every other site on any device."""
    nd = w.dim() - 2
    stride, padding = rules._tuple(stride, nd), rules._tuple(padding, nd)
    if nd != 2 or stride != (1, 1) or x.shape[2:] != y.shape[2:]:
        return rules.swta_wgrad_delta(w, x, y, k, padding, stride)
    if x.is_cuda:
        return SWTA_DELTA(w.contiguous(), x.contiguous(), y.contiguous(),
                          k, padding)
    if w.device.type == x.device.type == y.device.type == "cpu":
        return rules.swta_conv_delta(w, x, y, k, padding)
    raise ValueError(f"no swta_delta for tensors on {x.device}")
