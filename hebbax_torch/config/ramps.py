"""Consistency-weight ramps (``hebbax/config/ramps.py``), plain float
functions."""

import math


def sigmoid_rampup(current, rampup_length):
    """Exponential sigmoid ramp: exp(-5 (1 - t)^2), t clipped to [0, 1]."""
    if rampup_length == 0:
        return 1.0
    current = min(max(float(current), 0.0), float(rampup_length))
    phase = 1.0 - current / rampup_length
    return float(math.exp(-5.0 * phase * phase))


def linear_rampup(current, rampup_length):
    assert current >= 0 and rampup_length >= 0
    if current >= rampup_length:
        return 1.0
    return current / rampup_length


def cosine_rampdown(current, rampdown_length):
    assert 0 <= current <= rampdown_length
    return float(0.5 * (math.cos(math.pi * current / rampdown_length) + 1))
