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
``unet3d_s2d`` runs unfolded (``models/unet3d_s2d.py``), so its EM step
on the card launches P1 zero times and matches the same step on the CPU;
``unet3d_urpc_s2d`` keeps its folded pools, two launches a pass.
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


# the EM step on the card against the same step on the CPU: logits within
# OUT_TOL of max(1, max|logits|) of the CPU's float32 ones
# (test_torch_s2d_nets.py's bound for two layouts of one network); the
# step's parameter change (the gradient: SGD's first step at lr 1) held
# to the CPU's float64 step, its worst parameter's gap within GRAD_TOL of
# the largest change (float32 alone reads up to 1.78e-3 of it on the card
# and 1.53e-3 on the CPU over three input seeds, at 64 features and batch
# 1); bfloat16: logits within BF16_TRAIN_TOL (test_torch_bf16.py's
# training forward bound) and the change's relative L2 miss within
# BF16_TRAVEL_TOL (its step's parameter-travel bound)
OUT_TOL, GRAD_TOL = 1e-4, 5e-3
BF16_TRAIN_TOL, BF16_TRAVEL_TOL = 2e-1, 5e-1


def _em_step(device, dtype, sup, unsup, lr=1.0, double=False):
    """One EM step of unet3d_s2d on ``device`` from the seed-5 weights
    (``double``: the network and the images in float64): (logits, each
    parameter's change)."""
    from hebbax_torch.engine import semi
    from hebbax_torch.engine.state import TrainState
    from hebbax_torch.models import get_network
    from hebbax_torch.ops.losses import dice_loss

    model = get_network("unet3d_s2d", 1, 2, device=device,
                        generator=torch.Generator().manual_seed(5),
                        dtype=dtype)
    if double:
        model = model.double()
        sup = {k: v.double() if v.is_floating_point() else v
               for k, v in sup.items()}
        unsup = unsup.double()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    state = TrainState(model=model, optimizer=opt, schedule=lambda c: lr)
    step = semi.make_semi_step(model, "unet3d_s2d", dice_loss,
                               semi.em_unsup(2))
    move = {k: v.to(device) for k, v in sup.items()}
    state, out = step(state, move, {"image": unsup.to(device)}, 0.1)
    assert torch.isfinite(out["loss"])
    change = {n: (p.detach() - before[n]).float().cpu()
              for n, p in model.named_parameters()}
    return out["logits"].float().cpu(), change


def _worst(change, truth):
    """(the worst parameter's largest gap over the largest |change| of
    ``truth``, its name)."""
    scale = max(float(c.abs().max()) for c in truth.values())
    return max((float((change[n] - c).abs().max()) / scale, n)
               for n, c in truth.items())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_cuda_em_step_launches_twice(cuda_device, dtype, monkeypatch):
    """One EM step of unet3d_s2d runs two forwards.  hebbax folds their
    full-resolution level and pools it through the subpixel max, P1 on
    the card (two launches); the port runs the network unfolded
    (``models/unet3d_s2d.py``), so the step launches P1 zero times, and
    its logits and parameter change match the same step on the CPU."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(5)
    shape = (1, 1, 32, 32, 32)
    sup = {"image": torch.randn(shape, generator=gen),
           "mask": (torch.rand(shape[:1] + shape[2:], generator=gen)
                    > 0.5).long()}
    unsup = torch.randn(shape, generator=gen)
    before = SUBPIXEL_MAX3.launches
    logits, change = _em_step(cuda_device, dtype, sup, unsup)
    torch.cuda.synchronize()
    assert SUBPIXEL_MAX3.launches == before
    ref_logits, ref_change = _em_step("cpu", dtype, sup, unsup)
    tol = OUT_TOL if dtype is None else BF16_TRAIN_TOL
    scale = max(1.0, float(ref_logits.abs().max()))
    err = float((logits - ref_logits).abs().max()) / scale
    print(f"em step logits {dtype}: {err:.3e} of scale")
    assert err <= tol
    if dtype is None:
        _, truth = _em_step("cpu", None, sup, unsup, double=True)
        card, cpu = _worst(change, truth), _worst(ref_change, truth)
        print(f"em step change against float64: card {card[0]:.3e} at "
              f"{card[1]}, CPU float32 {cpu[0]:.3e} at {cpu[1]}")
        assert card[0] <= GRAD_TOL, (card, cpu)
    else:
        miss = sum(float((change[n] - c).square().sum())
                   for n, c in ref_change.items())
        ref = sum(float(c.square().sum()) for c in ref_change.values())
        print(f"em step change (bf16): relative L2 miss "
              f"{(miss / ref) ** 0.5:.3e}")
        assert (miss / ref) ** 0.5 <= BF16_TRAVEL_TOL


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
