"""Batched highshelf biquad with per-block coefficient interpolation
(PyTorch port of ops/biquad.py).

Replacement for Godot's ``AudioFilterSW::Processor`` as the reference
uses it (audio_spatializer_3d.cpp:504-528): the HIGHSHELF coefficient
formula with its pre-negated a1/a2 and gain/cutoff floors, a per-block
target with per-sample linear coefficient interpolation, and the bypass
rule (gain < 0.001 passes through; neither history nor coefficients
advance).

Only the frame-sequential ``"scan"`` method is ported; the mode-A main
path runs the recurrence inside the fused CUDA kernel
(ops/kernels/mix_mode_a.py) instead.
"""

from __future__ import annotations

import math

import torch


def highshelf_coeffs(sampling_rate, cutoff, gain, resonance: float = 1.0):
    """Vectorized HIGHSHELF coefficients → [..., 5] (b0,b1,b2,a1,a2).

    a1/a2 are pre-negated so the recurrence is
    y = b0·x + b1·x1 + b2·x2 + a1·y1 + a2·y2.  The gain enters squared
    at Nyquist (b0 carries tmpgain twice), as in the reference."""
    sr_limit = (sampling_rate / 2.0) + 512.0
    final_cutoff = torch.clamp(torch.clamp(cutoff, max=sr_limit), min=1.0)
    omega = (2.0 * math.pi) * final_cutoff / sampling_rate
    sin_v = torch.sin(omega)
    cos_v = torch.cos(omega)
    q = resonance if resonance > 0 else 0.0001
    tmpgain = torch.clamp(gain, min=0.001)
    tmpq = math.sqrt(q) if math.sqrt(q) > 0 else 0.001
    beta = torch.sqrt(tmpgain) / tmpq

    a0 = (tmpgain + 1.0) - (tmpgain - 1.0) * cos_v + beta * sin_v
    b0 = tmpgain * ((tmpgain + 1.0) + (tmpgain - 1.0) * cos_v + beta * sin_v)
    b1 = -2.0 * tmpgain * ((tmpgain - 1.0) + (tmpgain + 1.0) * cos_v)
    b2 = tmpgain * ((tmpgain + 1.0) + (tmpgain - 1.0) * cos_v - beta * sin_v)
    a1 = 2.0 * ((tmpgain - 1.0) - (tmpgain + 1.0) * cos_v)
    a2 = (tmpgain + 1.0) - (tmpgain - 1.0) * cos_v - beta * sin_v
    return torch.stack([b0 / a0, b1 / a0, b2 / a0, a1 / -a0, a2 / -a0], dim=-1)


def biquad_block_scan(x, coeffs0, incr, state):
    """Frame-sequential path.

    x: [..., F]; coeffs0/incr: [..., 5]; state: [..., 4] = (x1, x2, y1, y2).
    Returns (y [..., F], new_state, new_coeffs).

    Coefficients are evaluated affinely (c0 + k·incr), never accumulated:
    f32 accumulation drifts ~F ulps per block and detunes near-pole
    filters."""
    F = x.shape[-1]
    x1, x2, y1, y2 = state.unbind(-1)
    ys = []
    for f in range(F):
        kf = float(f + 1)
        c = coeffs0 + kf * incr
        xt = x[..., f]
        y = (
            c[..., 0] * xt
            + c[..., 1] * x1
            + c[..., 2] * x2
            + c[..., 3] * y1
            + c[..., 4] * y2
        )
        ys.append(y)
        x1, x2, y1, y2 = xt, x1, y, y1
    new_state = torch.stack([x1, x2, y1, y2], dim=-1)
    return torch.stack(ys, dim=-1), new_state, coeffs0 + F * incr


_NOT_PORTED = {
    "pallas": "ROADMAP Queue 2, row 6 (biquad_block_pallas)",
    "scan_df": "ROADMAP Queue 1, item 9 (effects: double-float filters)",
    "assoc": "ROADMAP Queue 1, item 9 (effects: associative-scan filters)",
}


def biquad_interp_block(x, coeffs, target, state, apply_mask, *, method="scan"):
    """One audio block through the interpolated-coefficient highshelf.

    x: [..., F]; coeffs/target: [..., 5]; state: [..., 4];
    apply_mask: [...] bool.  Returns (y, new_state, new_coeffs); bypass
    lanes pass x through and keep state and coefficients."""
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"biquad method {method!r} is not ported yet: {_NOT_PORTED[method]}"
        )
    if method != "scan":
        raise ValueError(f"unknown biquad method {method!r}")
    F = x.shape[-1]
    m = apply_mask[..., None]
    incr = torch.where(m, (target - coeffs) / F, torch.zeros_like(coeffs))
    y, new_state, new_coeffs = biquad_block_scan(x, coeffs, incr, state)
    return (
        torch.where(m, y, x),
        torch.where(m, new_state, state),
        torch.where(m, new_coeffs, coeffs),
    )
