"""Batched reverb-send volume computation
(reference audio_spatializer_3d.cpp:154-198)."""

from __future__ import annotations

import torch

from ..constants import (
    MAX_CHANNELS_PER_BUS,
    REVERB_CENTER_VALUES,
    SPEAKER_MODE_CHANNEL_COUNT,
    SpeakerMode,
)
from ..utils.dsp import safe_normalize
from .attenuation import attenuation_multiplier
from .pan import calc_output_vol


def calc_reverb_vol(
    uniformity,  # [...]
    amount,  # [...]
    listener_area_pos,  # [..., 3]
    lap_len,  # [...]
    direct_path_vol,  # [..., 4, 2]
    att_model,  # [...] int32
    unit_size,
    volume_linear,
    max_linear,
    panning_strength,
    speaker_mode: SpeakerMode,
    global_panning_strength: float = 1.0,
):
    """Per-(source, listener) Area3D reverb volumes → [..., 4, 2].

    uniformity > 0: the uniform `center_val` fraction is lerped against the
    panned area-position sound, scaled by attenuation, then lerped against
    the direct path by uniformity (cpp:161-190).  uniformity ≤ 0: plain
    `direct * amount` (cpp:192-195)."""
    chan_count = SPEAKER_MODE_CHANNEL_COUNT[speaker_mode]
    attenuation = attenuation_multiplier(
        lap_len, att_model, unit_size, volume_linear, max_linear
    )
    center = REVERB_CENTER_VALUES[chan_count - 1]

    # panned uniform sound: flat (y=0) normalized area direction
    rev_pos = listener_area_pos.clone()
    rev_pos[..., 1] = 0.0
    rev_pos = safe_normalize(rev_pos)
    panned = calc_output_vol(
        rev_pos, panning_strength, speaker_mode, global_panning_strength
    )

    att_e = attenuation[..., None, None]
    uni_e = uniformity[..., None, None]
    amt_e = amount[..., None, None]

    blended = torch.where(
        att_e < 1.0, panned + (center - panned) * att_e, torch.full_like(panned, center)
    )
    ch_mask = (
        torch.arange(MAX_CHANNELS_PER_BUS, device=panned.device) < chan_count
    )[..., None]  # [4,1]
    wet = blended * att_e
    uni_vol = (direct_path_vol + (wet - direct_path_vol) * uni_e) * amt_e
    uni_vol = torch.where(ch_mask, uni_vol, torch.zeros_like(uni_vol))
    plain_vol = direct_path_vol * amt_e
    return torch.where(uni_e > 0.0, uni_vol, plain_vol)
