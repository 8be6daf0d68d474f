"""The SWTA-delta dispatcher and the wrapper of its CUDA kernel.

This file imports no JAX and nothing of hebbax, so it runs on a machine
with the card too: ``python -m pytest tests/test_torch_kernels.py``.
There ``test_cuda_kernel_matches_plain`` holds the kernel against its
plain version; here, without a card, it skips (marked ``cuda``) and the
CPU tests check that the dispatcher takes the plain version, counts no
launch, and that the wrapper refuses what the kernel cannot take.

Tolerance of the card test: rtol 1e-5 / atol 1e-6, float32 sums over a
few hundred products in another order than cuBLAS; the O=256 cases add
atol 1e-5 * max|delta|, because with K=50 the logits k*y span ~300 and
their float32 rounding alone moves each softmax weight by up to ~2e-5 of
itself.
"""

import numpy as np
import pytest
import torch

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


# UNet2D's 22 Hebbian sites at batch 32, 128x128: (P, M, O)
_SITES = [(32 * s * s, i * k * k, o) for (i, o, k, s) in [
    (3, 16, 3, 128), (16, 16, 3, 128), (16, 32, 3, 64), (32, 32, 3, 64),
    (32, 64, 3, 32), (64, 64, 3, 32), (64, 128, 3, 16), (128, 128, 3, 16),
    (128, 256, 3, 8), (256, 256, 3, 8), (256, 128, 1, 8),
    (256, 128, 3, 16), (128, 128, 3, 16), (128, 64, 1, 16),
    (128, 64, 3, 32), (64, 64, 3, 32), (64, 32, 1, 32), (64, 32, 3, 64),
    (32, 32, 3, 64), (32, 16, 1, 64), (32, 16, 3, 128), (16, 16, 3, 128)]]


@pytest.mark.parametrize("p,m,o", _SITES)
def test_kernel_plan_covers_pixels(p, m, o):
    ranges, range_len = kernels.SwtaDeltaKernel.plan(p, m, o, 132)
    assert range_len % 16 == 0
    assert ranges * range_len >= p > (ranges - 1) * range_len
    # workspace of partials stays bounded (not one partial per stage)
    assert ranges * m * o * 4 <= 64 * 2 ** 20


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for shape in SHAPES:
        wt, xt, yt = _inputs(shape, seed=3, device=cuda_device)
        p = shape[5] // 2
        before = kernels.SWTA_DELTA.launches
        got = kernels.swta_delta(wt, xt, yt, 50.0, (p, p))
        torch.cuda.synchronize()
        assert kernels.SWTA_DELTA.launches == before + 1
        ref = trules.swta_conv_delta(wt, xt, yt, 50.0, (p, p))
        _assert_close(got.cpu().numpy(), ref.cpu().numpy(), shape)
