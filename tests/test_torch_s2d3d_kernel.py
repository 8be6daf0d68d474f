"""The folded 3D max pool's backward kernel (``csrc/subpixel_max3.cu``)
and its route in :func:`hebbax_torch.ops.s2d3d.subpixel_max3`.

This file imports no JAX and nothing of hebbax, so it runs on a machine
with the card too:

    python -m pytest --noconftest tests/test_torch_s2d3d_kernel.py

On the card (tests marked ``cuda``) the kernel's gradient is held to the
bit against the plain version :func:`s2d3d.first_max_grad` on the same
CUDA tensors: every fold a network passes, float32 and bfloat16, windows
of zeros, of tied values, of -0 and +0, and with a NaN, widths that do
not fill the kernel's vectors, a misaligned x, a strided cotangent, and
the shape of unet3d_s2d's folded level at 96x96x80.  Here, without a
card, a CPU tensor takes the plain version, which neither builds nor
counts a kernel, and the wrapper refuses what the kernel does not take.
"""

import pytest
import torch

from hebbax_torch import build
from hebbax_torch.ops import s2d3d
from hebbax_torch.ops.s2d3d_kernels import SUBPIXEL_MAX3, SubpixelMax3Kernel

torch.set_num_threads(2)

FOLDS = [(2, 1, 1), (2, 2, 2), (2, 2, 1), (1, 1, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _windows(n=2, c=3, d=4, h=6, w=10, seed=0):
    """An unfolded float32 (N, C, D, H, W) post-ReLU tensor (zero windows
    and zero ties everywhere) with planted windows: one of tied non-zero
    values, one of two tied maxima at voxels 3 and 5, one whose maxima
    are -0 (voxel 2) and +0 (voxel 5), and one holding a NaN."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((n, c, d, h, w), generator=gen))
    x[0, 0, :2, :2, :2] = 0.0
    x[0, 1, :2, :2, :2] = 0.5
    win = x[1, 0, :2, :2, :2].reshape(8)
    win[:] = torch.tensor([0.1, 0.2, 0.3, 0.9, 0.4, 0.9, 0.0, 0.9])
    x[1, 0, :2, :2, :2] = win.reshape(2, 2, 2)
    win = -torch.ones(8)
    win[2], win[5] = -0.0, 0.0
    x[1, 1, :2, :2, :2] = win.reshape(2, 2, 2)
    x[0, 2, :2, :2, :2] = 0.25
    x[0, 2, 1, 0, 1] = float("nan")
    return x


def _cotangent(x, seed=1):
    n, c, d, h, w = x.shape
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, c, d // 2, h // 2, w // 2), generator=gen)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def test_cpu_backward_takes_the_plain_version_and_counts_nothing(
        monkeypatch):
    """A CPU tensor's backward is the plain version, the unfolded max
    pool's gradient, and neither builds nor counts a kernel."""

    def no_build(name):
        raise AssertionError(f"the CPU path loaded the {name} kernel")

    monkeypatch.setattr(build, "load", no_build)
    f = (2, 1, 1)
    xu = torch.relu(_windows()[..., :2, :, :].nan_to_num())
    g = _cotangent(xu)
    x = s2d3d.fold3(xu, f).requires_grad_(True)
    before = SUBPIXEL_MAX3.launches
    s2d3d.subpixel_max3(x, f).backward(g)
    assert SUBPIXEL_MAX3.launches == before
    assert torch.equal(x.grad, s2d3d.first_max_grad(x.detach(), g, f))
    ref = xu.clone().requires_grad_(True)
    torch.nn.functional.max_pool3d(ref, 2).backward(g)
    assert torch.equal(x.grad, s2d3d.fold3(ref.grad, f))


def _operands(f, dtype=torch.float32, device="cpu", shape=(1, 2, 4, 4, 4)):
    xu = torch.zeros(shape)
    x = s2d3d.fold3(xu, f).to(device=device, dtype=dtype)
    return x, _cotangent(xu).to(device=device, dtype=dtype)


REFUSED = [
    ("float16", lambda x, g: (x.half(), g.half()), "float32 or bfloat16"),
    ("float64", lambda x, g: (x.double(), g.double()), "float32 or bfloat16"),
    ("g_dtype", lambda x, g: (x, g.bfloat16()), "x's dtype"),
    ("odd_depth", lambda x, g: (x[:, :, :, :, :3], g), "does not pool"),
    ("channels", lambda x, g: (x[:, :3], g), "does not pool"),
    ("g_shape", lambda x, g: (x, g[:, :, :1]), "not the pool"),
    ("rank", lambda x, g: (x[0], g[0]), "5-D"),
]


@pytest.mark.parametrize("case,alter,match", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_check_refuses_what_the_kernel_does_not_take(case, alter, match):
    x, g = alter(*_operands((2, 2, 1)))
    with pytest.raises(ValueError, match=match):
        SubpixelMax3Kernel.check(x, g, (2, 2, 1))


@pytest.mark.parametrize("f", [(3, 1, 1), (2, 2)])
def test_check_refuses_other_folds(f):
    x, g = _operands((2, 2, 1))
    with pytest.raises(ValueError, match="fold"):
        SubpixelMax3Kernel.check(x, g, f)


def test_wrapper_refuses_cpu_tensors():
    x, g = _operands((2, 1, 1))
    before = SUBPIXEL_MAX3.launches
    with pytest.raises(ValueError, match="CUDA"):
        SUBPIXEL_MAX3(x, g, (2, 1, 1))
    assert SUBPIXEL_MAX3.launches == before


# ---------------------------------------------------------------- the card

def _check_on_card(xu, f, dtype, device, strided_g=False, offset=False):
    """Kernel against the plain version on the same CUDA tensors: the
    gradient's bits equal, one launch counted, and the autograd route
    launching the kernel too."""
    x = s2d3d.fold3(xu, f).to(device=device, dtype=dtype)
    if offset:           # a contiguous x that is not 16-byte aligned
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    g = _cotangent(xu).to(device=device, dtype=dtype)
    if strided_g:
        wide = torch.zeros(g.shape[:4] + (2 * g.shape[4],), dtype=dtype,
                           device=device)
        wide[..., ::2] = g
        g = wide[..., ::2]
        assert not g.is_contiguous()
    before = SUBPIXEL_MAX3.launches
    got = SUBPIXEL_MAX3(x, g, f)
    ref = s2d3d.first_max_grad(x, g, f)
    torch.cuda.synchronize()
    assert SUBPIXEL_MAX3.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(ref)), (f, dtype, tuple(x.shape))
    xr = x.detach().clone().requires_grad_(True)
    s2d3d.subpixel_max3(xr, f).backward(g)
    torch.cuda.synchronize()
    assert SUBPIXEL_MAX3.launches == before + 2
    assert torch.equal(_bits(xr.grad), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("f", FOLDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [32, 12, 10])
def test_cuda_kernel_matches_plain_to_the_bit(cuda_device, f, dtype, w):
    """Pooled widths 16, 6 and 5: every vector width fills at 16, 6 fills
    float32's x-pair vectors only, 5 none (the element-by-element
    path)."""
    _check_on_card(_windows(w=w), f, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("f", FOLDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_strided_cotangent_and_misaligned_x(cuda_device, f,
                                                         dtype):
    _check_on_card(_windows(w=16), f, dtype, cuda_device, strided_g=True)
    _check_on_card(_windows(w=16), f, dtype, cuda_device, offset=True)


@pytest.mark.cuda
def test_cuda_kernel_at_the_cells_shape(cuda_device):
    """unet3d_s2d's folded level at a 96x96x80 patch: x 1x128x48x96x80,
    f = (2, 1, 1), post-ReLU."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    xu = torch.relu(torch.randn((1, 64, 96, 96, 80), generator=gen,
                                device=cuda_device))
    _check_on_card(xu, (2, 1, 1), torch.float32, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case,alter,match", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_cuda_check_refuses(cuda_device, case, alter, match):
    x, g = alter(*_operands((2, 2, 1), device=cuda_device))
    before = SUBPIXEL_MAX3.launches
    with pytest.raises(ValueError, match=match):
        SUBPIXEL_MAX3(x, g, (2, 2, 1))
    assert SUBPIXEL_MAX3.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_cuda_em_step_launches_twice(cuda_device, dtype):
    """One EM step of unet3d_s2d runs two folded forwards, so two pool
    backwards: two launches."""
    from hebbax_torch.engine import semi
    from hebbax_torch.engine.state import TrainState
    from hebbax_torch.models import get_network
    from hebbax_torch.ops.losses import dice_loss

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    model = get_network("unet3d_s2d", 1, 2, device=cuda_device,
                        generator=torch.Generator().manual_seed(5),
                        dtype=dtype)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    state = TrainState(model=model, optimizer=opt, schedule=lambda c: 0.01)
    step = semi.make_semi_step(model, "unet3d_s2d", dice_loss,
                               semi.em_unsup(2))
    shape = (1, 1, 32, 32, 32)
    sup = {"image": torch.randn(shape, generator=gen, device=cuda_device),
           "mask": (torch.rand(shape[:1] + shape[2:], generator=gen,
                               device=cuda_device) > 0.5).long()}
    unsup = {"image": torch.randn(shape, generator=gen, device=cuda_device)}
    before = SUBPIXEL_MAX3.launches
    state, out = step(state, sup, unsup, 0.1)
    torch.cuda.synchronize()
    assert SUBPIXEL_MAX3.launches == before + 2
    assert torch.isfinite(out["loss"])


@pytest.mark.cuda
def test_cuda_urpc_forward_backward_launches_twice(cuda_device):
    """unet3d_urpc_s2d pools two folded levels at (2, 2, 2): two launches
    for each forward and backward."""
    from hebbax_torch.models import get_network

    model = get_network("unet3d_urpc_s2d", 1, 2, device=cuda_device,
                        generator=torch.Generator().manual_seed(6))
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for i in range(2):
        x = torch.randn((1, 1, 32, 32, 32), generator=gen,
                        device=cuda_device)
        before = SUBPIXEL_MAX3.launches
        sum(o.float().square().mean() for o in model(x)).backward()
        torch.cuda.synchronize()
        assert SUBPIXEL_MAX3.launches == before + 2, i
