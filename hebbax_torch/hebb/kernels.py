"""SWTA-delta dispatcher and the wrapper of its CUDA kernel
(``hebbax/hebb/pallas_kernels.py`` ``swta_delta`` / ``swta_delta_pallas``).

:func:`swta_delta` routes by where the tensors lie:

* CUDA tensors go to the hand-written kernel ``csrc/swta_delta.cu``
  through :data:`SWTA_DELTA`, or raise — there is no fallback and no
  environment switch;
* CPU tensors go to the plain version :func:`rules.swta_conv_delta`.

The wrapper checks device, dtype, contiguity and shape, allocates the
output and the workspace with ``torch.empty``, launches on the current
stream, raises on a launch error, and counts its launches.
"""

import ctypes

import torch

from . import rules

_TP = 16            # pixels per shared-memory stage in the kernel
_MAX_O = 512        # the kernel stages all O channels of 16 pixels in smem
_BLOCKS_PER_SM = 8  # pixel ranges are chosen to give about this many blocks


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
                              ctypes.c_longlong, ctypes.c_void_p])
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

    @staticmethod
    def plan(p, m, o, sm_count):
        """(ranges, range_len): pixel ranges for about _BLOCKS_PER_SM
        blocks per SM, each a whole number of 16-pixel stages."""
        tiles = -(-m // 64) * -(-o // (16 if o <= 16 else 32 if o <= 32
                                       else 64))
        stages = -(-p // _TP)
        ranges = max(1, min(stages, -(-_BLOCKS_PER_SM * sm_count // tiles)))
        range_len = -(-stages // ranges) * _TP
        return -(-p // range_len), range_len

    def __call__(self, w, x, y, k, padding):
        self.check(w, x, y, padding)
        o, i, kh, kw = w.shape
        n, _, h, wd = x.shape
        m, p = i * kh * kw, n * h * wd
        dev = x.device
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        ranges, range_len = self.plan(p, m, o, sm_count)
        delta = torch.empty_like(w)
        part = torch.empty((ranges, o, m), dtype=torch.float32, device=dev)
        rsum = torch.empty((ranges, o), dtype=torch.float32, device=dev)
        fn = self._entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(),
                    delta.data_ptr(), part.data_ptr(), rsum.data_ptr(),
                    n, i, h, wd, o, kh, kw, padding[0], padding[1],
                    float(k), ranges, range_len, stream)
        if rc != 0:
            raise RuntimeError(f"swta_delta kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        return delta


SWTA_DELTA = SwtaDeltaKernel()


def swta_delta(w, x, y, k, padding):
    """SWTA delta of a stride-1 2D forward conv: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return SWTA_DELTA(w.contiguous(), x.contiguous(), y.contiguous(),
                          k, padding)
    if w.device.type == x.device.type == y.device.type == "cpu":
        return rules.swta_conv_delta(w, x, y, k, padding)
    raise ValueError(f"no swta_delta for tensors on {x.device}")
