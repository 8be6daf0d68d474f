"""Single-level discrete wavelet transforms (``hebbax/ops/wavelets.py``):
float64 numpy, pywt-compatible, the port's own copy.

The filter banks of the reference's wavelet dataset tools (``haar`` /
``db1``, ``db2``, ``db4``, ``coif1``, ``bior1.5``, ``bior2.4`` and
``dmey``, the 62-tap discrete-Meyer FIR table) are embedded with their
standard published coefficients, and the transform is pywt's
symmetric-extension single-level DWT: output length
floor((n + flen - 1) / 2), half-sample symmetric padding, correlation with
the decomposition filter, odd-phase downsampling.  The same float64
operations in the same order as hebbax's, so the outputs are equal to the
bit.
"""

import math

import numpy as np

_SQRT2 = math.sqrt(2.0)

_S3 = math.sqrt(3.0)
_DB2_LO = np.array([(1 - _S3), (3 - _S3), (3 + _S3), (1 + _S3)]) / (4 * _SQRT2)

_DB4_LO = np.array([
    -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
    -0.18703481171888114, -0.02798376941698385, 0.6308807679295904,
    0.7148465705525415, 0.23037781330885523])

_COIF1_LO = np.array([
    -0.01565572813546454, -0.0727326195128539, 0.38486484686420286,
    0.8525720202122554, 0.3378976624578092, -0.0727326195128539])

# bior1.5 / bior2.4 analysis filters (standard spline-biorthogonal tables)
_BIOR15_LO = np.array([
    0.01657281518405971, -0.01657281518405971, -0.12153397801643787,
    0.12153397801643787, 0.7071067811865476, 0.7071067811865476,
    0.12153397801643787, -0.12153397801643787, -0.01657281518405971,
    0.01657281518405971])
_BIOR15_HI = np.array([0, 0, 0, 0, -0.7071067811865476,
                       0.7071067811865476, 0, 0, 0, 0])

_BIOR24_LO = np.array([
    0.0, 0.03314563036811942, -0.06629126073623884, -0.17677669529663689,
    0.4198446513295126, 0.9943689110435825, 0.4198446513295126,
    -0.17677669529663689, -0.06629126073623884, 0.03314563036811942])
_BIOR24_HI = np.array([
    0.0, 0.0, 0.0, 0.3535533905932738, -0.7071067811865476,
    0.3535533905932738, 0.0, 0.0, 0.0, 0.0])


# discrete Meyer ('dmey'): the standard 62-tap FIR approximation of the
# Meyer scaling filter (the table MATLAB/pywt ship); symmetric, padded to
# even length with a trailing zero.  Listed as rec_lo; dec_lo = reversed.
_DMEY_REC_LO = np.array([
    -1.009999956941423e-12, 8.519459636796214e-09,
    -1.111944952595278e-08, -1.0798819539621958e-08,
    6.066975741351135e-08, -1.0866516536735883e-07,
    8.200680650386481e-08, 1.1783004497663934e-07,
    -5.506340565252278e-07, 1.1307947017916706e-06,
    -1.489549216497156e-06, 7.367572885903746e-07,
    3.20544191334478e-06, -1.6312699734552807e-05,
    6.554305930575149e-05, -0.0006011502343516092,
    -0.002704672124643725, 0.002202534100911002,
    0.006045814097323304, -0.006387718318497156,
    -0.011061496392513451, 0.015270015130934803,
    0.017423434103729693, -0.03213079399021176,
    -0.024348745906078023, 0.0637390243228016,
    0.030655091960824263, -0.13284520043622938,
    -0.035087555656258346, 0.44459300275757724,
    0.7445855923188063, 0.44459300275757724,
    -0.035087555656258346, -0.13284520043622938,
    0.030655091960824263, 0.0637390243228016,
    -0.024348745906078023, -0.03213079399021176,
    0.017423434103729693, 0.015270015130934803,
    -0.011061496392513451, -0.006387718318497156,
    0.006045814097323304, 0.002202534100911002,
    -0.002704672124643725, -0.0006011502343516092,
    6.554305930575149e-05, -1.6312699734552807e-05,
    3.20544191334478e-06, 7.367572885903746e-07,
    -1.489549216497156e-06, 1.1307947017916706e-06,
    -5.506340565252278e-07, 1.1783004497663934e-07,
    8.200680650386481e-08, -1.0866516536735883e-07,
    6.066975741351135e-08, -1.0798819539621958e-08,
    -1.111944952595278e-08, 8.519459636796214e-09,
    -1.009999956941423e-12, 0.0])


def _qmf(lo):
    """Orthogonal high-pass from low-pass: hi[n] = (-1)^n lo[N-1-n]."""
    n = len(lo)
    return np.array([(-1) ** k * lo[n - 1 - k] for k in range(n)])


def filters(name: str):
    """(dec_lo, dec_hi) for a wavelet family name (pywt naming)."""
    name = name.lower()
    if name == "haar" or name == "db1":
        lo = np.array([1.0, 1.0]) / _SQRT2
        return lo, _qmf(lo)
    if name == "db2":
        return _DB2_LO, _qmf(_DB2_LO)
    if name == "db4":
        return _DB4_LO, _qmf(_DB4_LO)
    if name == "coif1":
        return _COIF1_LO, _qmf(_COIF1_LO)
    if name == "bior1.5":
        return _BIOR15_LO, _BIOR15_HI
    if name == "bior2.4":
        return _BIOR24_LO, _BIOR24_HI
    if name == "dmey":
        lo = _DMEY_REC_LO[::-1].copy()  # dec_lo = reversed rec_lo
        return lo, _qmf(lo)
    raise ValueError(f"unknown wavelet {name!r}")


def _dwt1d(x, lo, hi, axis):
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    flen = len(lo)
    pad = flen - 1
    # half-sample symmetric extension (pywt mode='symmetric'), repeated
    # reflection so filters longer than the signal still work
    idx = np.arange(-pad, n + pad)
    idx = np.mod(idx, 2 * n)
    idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
    xp = x[..., idx]
    shape = xp.shape[:-1] + (xp.shape[-1] - flen + 1,)
    a = np.zeros(shape)
    d = np.zeros(shape)
    for k in range(flen):
        seg = xp[..., k: k + shape[-1]]
        a += lo[::-1][k] * seg
        d += hi[::-1][k] * seg
    a = a[..., 1::2]
    d = d[..., 1::2]
    return np.moveaxis(a, -1, axis), np.moveaxis(d, -1, axis)


def dwt2(image, wavelet="haar"):
    """Single-level 2D DWT: (LL, (LH, HL, HH)) with pywt's subband
    naming (LH = lowpass rows, highpass cols ordering as pywt.dwt2)."""
    lo, hi = filters(wavelet)
    a, d = _dwt1d(np.asarray(image, np.float64), lo, hi, axis=0)
    aa, ad = _dwt1d(a, lo, hi, axis=1)
    da, dd = _dwt1d(d, lo, hi, axis=1)
    return aa, (ad, da, dd)


def dwtn3(volume, wavelet="haar"):
    """Single-level 3D DWT: dict of subbands keyed 'aaa'..'ddd' like
    pywt.dwtn (axis order x,y,z; 'a'=lowpass)."""
    lo, hi = filters(wavelet)
    bands = {"": np.asarray(volume, np.float64)}
    for axis in range(3):
        new = {}
        for key, arr in bands.items():
            a, d = _dwt1d(arr, lo, hi, axis=axis)
            new[key + "a"] = a
            new[key + "d"] = d
        bands = new
    return bands
