"""The SWTA-delta dispatcher and the wrapper of its CUDA kernel.

This file imports no JAX and nothing of hebbax, so it runs on a machine
with the card too: ``python -m pytest tests/test_torch_kernels.py``.
There ``test_cuda_kernel_matches_plain`` holds the kernel against its
plain version; here, without a card, it skips (marked ``cuda``) and the
CPU tests check that the dispatcher takes the plain version, counts no
launch, and that the wrapper refuses what the kernel cannot take.

Tolerance of the card tests: rtol 1e-5 / atol 1e-6, float32 sums over a
few hundred products in another order than cuBLAS; the O >= 256 cases
add atol 1e-5 * max|delta|, because with K=50 the logits k*y span ~300
and their float32 rounding alone moves each softmax weight by up to ~2e-5
of itself.  The kernel multiplies on the tensor cores in 3xTF32; the CPU
tests below emulate that split and hold it within 1e-5 of max|delta| of
a float64 reference, where one TF32 product misses by ~3e-4.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hebbax_torch.hebb import kernels
from hebbax_torch.hebb import rules as trules

torch.set_num_threads(2)

# (n, h, w, i, o, k)
SHAPES = [(2, 4, 4, 3, 5, 3), (1, 8, 8, 4, 4, 1), (2, 4, 6, 2, 3, 3),
          (2, 8, 8, 3, 256, 3), (2, 8, 8, 3, 256, 1),
          (4, 16, 16, 32, 64, 3), (2, 8, 8, 256, 128, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, seed=0, device="cpu"):
    """NCHW x, y and (O, I, kh, kw) w from a numpy seed."""
    n, h, wd, i, o, k = shape
    rng = np.random.RandomState(seed)
    w = rng.randn(o, i, k, k).astype(np.float32) * 0.1
    x = rng.randn(n, i, h, wd).astype(np.float32)
    y = rng.randn(n, o, h, wd).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (w, x, y))


def _assert_close(got, ref, shape):
    atol = 1e-6 if shape[4] < 256 else 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    wt, xt, yt = _inputs((2, 8, 8, 4, 6, 3), seed=2)
    before = kernels.SWTA_DELTA.launches
    got = kernels.swta_delta(wt, xt, yt, 20.0, (1, 1))
    ref = trules.swta_conv_delta(wt, xt, yt, 20.0, (1, 1))
    assert kernels.SWTA_DELTA.launches == before == 0
    assert torch.equal(got, ref)


def test_kernel_wrapper_refuses_cpu_tensors():
    w = torch.zeros(4, 2, 3, 3)
    x = torch.zeros(1, 2, 8, 8)
    y = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.SWTA_DELTA(w, x, y, 50.0, (1, 1))
    assert kernels.SWTA_DELTA.launches == 0


# UNet2D's 22 Hebbian sites: (I, O, k, side at 128x128 input)
_UNET = [(3, 16, 3, 128), (16, 16, 3, 128), (16, 32, 3, 64), (32, 32, 3, 64),
         (32, 64, 3, 32), (64, 64, 3, 32), (64, 128, 3, 16),
         (128, 128, 3, 16), (128, 256, 3, 8), (256, 256, 3, 8),
         (256, 128, 1, 8), (256, 128, 3, 16), (128, 128, 3, 16),
         (128, 64, 1, 16), (128, 64, 3, 32), (64, 64, 3, 32),
         (64, 32, 1, 32), (64, 32, 3, 64), (32, 32, 3, 64), (32, 16, 1, 64),
         (32, 16, 3, 128), (16, 16, 3, 128)]


@pytest.mark.parametrize("i,o,k,side", _UNET)
def test_kernel_plan_covers_pixels(i, o, k, side):
    p, m = 32 * side * side, i * k * k
    pl = kernels.SwtaDeltaKernel.plan(32, i, side, side, o, k, k, 132)
    # every UNet2D site stages x as rows with a margin (16-byte copies)
    assert pl.halo
    assert pl.range_len % 32 == 0
    assert pl.ranges * pl.range_len >= p > (pl.ranges - 1) * pl.range_len
    # workspace of partials stays bounded (not one partial per stage)
    assert pl.ranges * m * o * 4 <= 64 * 2 ** 20
    # the block fits in shared memory, and a chunk of O above 128 channels
    # never has to recompute the softmax for a second chunk
    assert pl.smem <= kernels._MAX_SMEM
    assert pl.nwg in (8, 16, 32, 64, 128)
    assert pl.nwg * pl.wn >= min(o, 256)


@pytest.mark.parametrize("o", [1, 3, 5, 8, 17, 130, 256, 257, 384, 512])
def test_kernel_tile_fits_every_channel_count(o):
    nwg, wm, wn = kernels.SwtaDeltaKernel.tile(64 * 9, o)
    x_slot = max(kernels.SwtaDeltaKernel.x_slot(64 * wm, 64, wd, 3, 3, True)
                 for wd in (8, 16, 32))
    smem = kernels.SwtaDeltaKernel.smem_bytes(o, nwg, wm, wn, x_slot)
    assert smem <= kernels._MAX_SMEM
    chunks = -(-o // (nwg * wn))
    assert chunks * nwg * wn >= o
    assert chunks == 1 or o > 256


@pytest.mark.parametrize("h,wd,k,aligned,halo", [
    (128, 128, 3, True, True), (8, 8, 3, True, True), (16, 16, 1, True, True),
    (4, 4, 3, True, False), (4, 6, 3, True, False), (8, 12, 3, True, False),
    (8, 8, 3, False, False)])
def test_kernel_halo_staging_where_shapes_allow(h, wd, k, aligned, halo):
    """Halo staging needs W % 4 == 0 and a stage of 32 pixels that is one
    row's aligned segment or whole rows of one image; other shapes gather
    per element."""
    pl = kernels.SwtaDeltaKernel.plan(2, 8, h, wd, 16, k, k, 132, aligned)
    assert pl.halo == halo
    assert pl.smem <= kernels._MAX_SMEM


def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), nearest, ties away from
    zero: ``cvt.rna.tf32.f32``."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    hi = _tf32(a)
    lo = _tf32((a - hi).astype(np.float32))
    return hi.astype(np.float64), lo.astype(np.float64)


def _delta_products(w, x, y, k, terms):
    """delta with pos = r . xpatch from the float32 softmax, the products
    exact and summed in float64: terms "f64" (no rounding), "3xtf32"
    (hi*hi + hi*lo + lo*hi) or "tf32" (hi*hi only)."""
    o, i, kh, kw = w.shape
    r = torch.softmax(k * torch.from_numpy(y), dim=1).numpy()
    rf = r.transpose(1, 0, 2, 3).reshape(o, -1)
    xp = F.unfold(torch.from_numpy(x), (kh, kw), padding=(kh // 2, kw // 2))
    xp = xp.numpy().transpose(1, 0, 2).reshape(i * kh * kw, -1)
    if terms == "f64":
        pos = rf.astype(np.float64) @ xp.astype(np.float64).T
    else:
        rh, rl = _split(rf)
        xh, xl = _split(xp)
        pos = rh @ xh.T
        if terms == "3xtf32":
            pos += rh @ xl.T + rl @ xh.T
    rsum = rf.astype(np.float64).sum(1)
    return pos - rsum[:, None] * w.reshape(o, -1).astype(np.float64)


@pytest.mark.parametrize("i,o,k", sorted({(i, o, k) for i, o, k, _ in _UNET}))
def test_3xtf32_split_matches_float64(i, o, k):
    """The kernel's operand split, emulated, at UNet2D's (I, O, k) with
    batch 2 at 8x8: within 1e-5 of max|delta| of float64, while one TF32
    product alone is off by more than 1e-5."""
    w, x, y = (t.numpy() for t in _inputs((2, 8, 8, i, o, k), seed=5))
    ref = _delta_products(w, x, y, 50.0, "f64")
    scale = np.abs(ref).max()
    err3 = np.abs(_delta_products(w, x, y, 50.0, "3xtf32") - ref).max()
    err1 = np.abs(_delta_products(w, x, y, 50.0, "tf32") - ref).max()
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_split_meets_card_tolerance(shape):
    """The emulated 3xTF32 delta passes the card test's own tolerance
    against the plain version at every card-test shape."""
    wt, xt, yt = _inputs(shape, seed=3)
    p = shape[5] // 2
    ref = trules.swta_conv_delta(wt, xt, yt, 50.0, (p, p)).numpy()
    got = _delta_products(wt.numpy(), xt.numpy(), yt.numpy(), 50.0,
                          "3xtf32").reshape(ref.shape)
    _assert_close(got, ref, shape)


def _check_on_card(shape, device, seed):
    """Kernel vs plain at one shape, one launch counted per call, and two
    launches on the same tensors equal to the bit."""
    wt, xt, yt = _inputs(shape, seed=seed, device=device)
    p = shape[5] // 2
    before = kernels.SWTA_DELTA.launches
    got = kernels.swta_delta(wt, xt, yt, 50.0, (p, p))
    again = kernels.swta_delta(wt, xt, yt, 50.0, (p, p))
    torch.cuda.synchronize()
    assert kernels.SWTA_DELTA.launches == before + 2
    assert torch.equal(got, again), f"{shape}: repeat launch differs"
    ref = trules.swta_conv_delta(wt, xt, yt, 50.0, (p, p))
    _assert_close(got.cpu().numpy(), ref.cpu().numpy(), shape)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for shape in SHAPES:
        _check_on_card(shape, cuda_device, seed=3)


@pytest.mark.cuda
def test_cuda_kernel_unet_sites(cuda_device):
    """UNet2D's (I, O, k) combinations at batch 2, 8x8 (and O=384)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = [(2, 8, 8, i, o, k) for i, o, k in
              sorted({(i, o, k) for i, o, k, _ in _UNET})]
    for shape in shapes + [(2, 8, 8, 16, 384, 3)]:
        _check_on_card(shape, cuda_device, seed=4)


def test_cpu_dispatch_sends_strided_sites_to_the_composed_rule():
    """A strided 2D site (VNet-style k = s = 2, or a swapped transpose
    conv) and a VALID stride-1 one never take K1's path: on the CPU they
    go to the composed rule, not to the plain version."""
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(4, 3, 2, 2).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32))
    y = F.conv2d(x, w, stride=2)
    before = kernels.SWTA_DELTA.launches
    got = kernels.swta_delta(w, x, y, 50.0, (0, 0), (2, 2))
    assert kernels.SWTA_DELTA.launches == before
    assert torch.equal(got, trules.swta_wgrad_delta(w, x, y, 50.0, 0, 2))


@pytest.mark.cuda
def test_cuda_dispatch_keeps_strided_sites_off_the_kernel(cuda_device):
    """On the card a strided 2D site goes to the composed rule and leaves
    K1's launch count as it was; a stride-1 same-size site still launches
    K1 once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(6)
    for k, s, pad in ((2, 2, 0), (3, 2, 1), (3, 1, 0)):
        w = torch.from_numpy(rng.randn(8, 4, k, k).astype(np.float32)
                             ).to(cuda_device)
        x = torch.from_numpy(rng.randn(2, 4, 16, 16).astype(np.float32)
                             ).to(cuda_device)
        y = F.conv2d(x, w, stride=s, padding=pad)
        before = kernels.SWTA_DELTA.launches
        got = kernels.swta_delta(w, x, y, 50.0, (pad, pad), (s, s))
        torch.cuda.synchronize()
        assert kernels.SWTA_DELTA.launches == before, (k, s, pad)
        # the composed rule on the card against itself on the CPU (cuDNN's
        # weight gradient may sum in another order than oneDNN's)
        cpu = trules.swta_wgrad_delta(w.cpu(), x.cpu(), y.cpu(), 50.0, pad,
                                      s)
        scale = float(cpu.abs().max())
        assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale
    w, x, y = _inputs((2, 8, 8, 4, 6, 3), seed=7, device=cuda_device)
    before = kernels.SWTA_DELTA.launches
    kernels.swta_delta(w, x, y, 50.0, (1, 1), 1)
    torch.cuda.synchronize()
    assert kernels.SWTA_DELTA.launches == before + 1
