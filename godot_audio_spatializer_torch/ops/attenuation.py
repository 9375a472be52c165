"""Batched distance attenuation (reference audio_spatializer_3d.cpp:123-151).

All four models are computed branch-free and selected per source by model
index.  Linear domain: db_to_linear(linear_to_db(x) + vol_db) clamped at
max_db is min(x·vol_lin, max_lin), with vol_lin/max_lin precomputed on
the host in float64.
"""

from __future__ import annotations

import torch

from ..constants import CMP_EPSILON, DB_TO_LINEAR_SCALE, AttenuationModel

# LOGARITHMIC model: att = -20·ln(x) dB → linear gain x^(-20·ln(10)/20)
_LOG_MODEL_EXP = -20.0 * DB_TO_LINEAR_SCALE


def attenuation_multiplier(distance, model, unit_size, volume_linear, max_linear):
    """Linear-domain attenuation multiplier (before max_distance rolloff)."""
    d = distance / unit_size
    inv = 1.0 / (d + CMP_EPSILON)
    inv_sq = 1.0 / (d * d + CMP_EPSILON)
    log_m = torch.pow(d + CMP_EPSILON, _LOG_MODEL_EXP)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    x = torch.where(
        model == AttenuationModel.INVERSE_DISTANCE,
        inv,
        torch.where(
            model == AttenuationModel.INVERSE_SQUARE_DISTANCE,
            inv_sq,
            torch.where(model == AttenuationModel.LOGARITHMIC, log_m, one),
        ),
    )
    return torch.minimum(x * volume_linear, max_linear)
