"""The wrapper of the folded 3D max pool's backward kernel
``csrc/subpixel_max3.cu`` (:func:`hebbax_torch.ops.s2d3d.subpixel_max3`).

The kernel sends each pooled cotangent to the first maximum of its 2x2x2
window in (z, y, x) order and writes the whole folded gradient in one
pass; :func:`hebbax_torch.ops.s2d3d.first_max_grad` is its plain version,
which CPU tensors take.  A CUDA tensor launches the kernel or raises:
there is no fallback and no switch.

The wrapper checks dtype, shape, device and contiguity, makes the
cotangent contiguous, allocates the gradient with ``torch.empty``,
launches on the current stream without synchronising, raises on a launch
error, and counts its launches.
"""

import ctypes

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SubpixelMax3Kernel(build.Kernel):
    """ctypes wrapper of ``hebbax_subpixel_max3_bwd`` with a launch
    count."""

    name = library = "subpixel_max3"
    symbol = "hebbax_subpixel_max3_bwd"
    source = "hebbax_torch/csrc/subpixel_max3.cu"
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9

    @staticmethod
    def check(x, g, f):
        """Raise ValueError unless the kernel takes the folded x, the
        pooled cotangent g and the fold f."""
        if x.dtype not in _DTYPES:
            raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
        if g.dtype != x.dtype:
            raise ValueError(f"g must have x's dtype {x.dtype}, got "
                             f"{g.dtype}")
        f = tuple(f)
        if len(f) != 3 or any(a not in (1, 2) for a in f):
            raise ValueError(f"fold {f} must be three factors of 1 or 2")
        if x.dim() != 5 or g.dim() != 5:
            raise ValueError(f"x and g must be 5-D, got {tuple(x.shape)} "
                             f"and {tuple(g.shape)}")
        n, cf = x.shape[:2]
        pf = f[0] * f[1] * f[2]
        full = [s * a for s, a in zip(x.shape[2:], f)]
        if cf % pf or any(s % 2 for s in full):
            raise ValueError(f"x {tuple(x.shape)} folded by {f} does not "
                             "pool 2x2x2")
        want = (n, cf // pf) + tuple(s // 2 for s in full)
        if tuple(g.shape) != want:
            raise ValueError(f"g {tuple(g.shape)} is not the pool of x "
                             f"{tuple(x.shape)} folded by {f}: want {want}")
        if g.numel() == 0:
            raise ValueError("empty input")
        if g.numel() >= 2 ** 31:
            raise ValueError("g is too large for the kernel's 32-bit "
                             "thread index")
        if not (x.is_cuda and g.is_cuda):
            raise ValueError("x and g must be CUDA tensors")
        if x.device != g.device:
            raise ValueError("x and g must lie on one device")
        if not (x.is_contiguous() and g.is_contiguous()):
            raise ValueError("x and g must be contiguous")

    def __call__(self, x, g, f):
        """The folded gradient of x: g at each window's first maximum,
        zero elsewhere."""
        g = g.contiguous()
        self.check(x, g, f)
        fz, fy, fx = (int(a) for a in f)
        n, cf, p, q, r = x.shape
        gx = torch.empty_like(x, memory_format=torch.contiguous_format)
        self.launch(x.device, x.data_ptr(), g.data_ptr(), gx.data_ptr(),
                    _DTYPES[x.dtype], n, cf // (fz * fy * fx), fz, fy, fx,
                    p, q, r)
        return gx


SUBPIXEL_MAX3 = SubpixelMax3Kernel()
