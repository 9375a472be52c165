"""Batched panners: equal-power stereo pan + SPCAP surround
(reference audio_spatializer_3d.cpp:57-121 and 903-938)."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    DEFAULT_SPEAKER_DIRECTIONS,
    MAX_CHANNELS_PER_BUS,
    SPEAKER_MODE_SPEAKER_COUNT,
    SpeakerMode,
)


def stereo_pan(source_dir, pan_strength):
    """Equal-power stereo pan (reference cpp:103-110) → [..., 2]."""
    x = source_dir[..., 0]
    z = source_dir[..., 2]
    flatrad = torch.sqrt(x * x + z * z)
    g = torch.clamp((1.0 - pan_strength) * (1.0 - pan_strength), 0.0, 1.0)
    f = (1.0 - g) / (1.0 + g)
    cosx = torch.clamp(x / torch.where(flatrad == 0.0, torch.ones_like(flatrad), flatrad), -1.0, 1.0)
    fcosx = cosx * f
    left = torch.sqrt((-fcosx + 1.0) / 2.0)
    right = torch.sqrt((fcosx + 1.0) / 2.0)
    return torch.stack([left, right], dim=-1)


def speaker_directions(speaker_count: int) -> np.ndarray:
    """Default speaker direction table slice (reference cpp:47-55)."""
    return np.asarray(DEFAULT_SPEAKER_DIRECTIONS[:speaker_count], np.float32)


def spcap_effective_count(directions: np.ndarray) -> np.ndarray:
    """effective_number_of_speakers (reference cpp:911-915)."""
    dots = directions @ directions.T
    return (0.5 * (1.0 + dots)).sum(axis=1)


def spcap_volumes(source_dir, tightness, speaker_count: int):
    """SPCAP per-speaker gains (reference cpp:926-938) → [..., S],
    normalised so the squared gains sum to 1."""
    dev = source_dir.device
    dirs = torch.as_tensor(speaker_directions(speaker_count), device=dev)
    eff = torch.as_tensor(
        spcap_effective_count(speaker_directions(speaker_count)), device=dev
    )
    d = torch.einsum("...i,si->...s", source_dir, dirs)
    initial_gain = 0.5 * torch.pow(1.0 + d, tightness[..., None]) / eff
    sq = initial_gain * initial_gain
    total = sq.sum(dim=-1, keepdim=True)
    return torch.sqrt(sq / total)


def calc_output_vol(source_dir, panning_strength, speaker_mode: SpeakerMode,
                    global_panning_strength: float = 1.0):
    """Pan dispatch → per-channel-pair volumes [..., 4, 2].

    Channel-pair order: 0=FL/FR, 1=C/LFE, 2=RL/RR, 3=SL/SR; LFE is always
    1.0 in surround modes (cpp:91)."""
    batch = source_dir.shape[:-1]
    out = torch.zeros(batch + (MAX_CHANNELS_PER_BUS, 2), dtype=source_dir.dtype,
                      device=source_dir.device)
    if speaker_mode == SpeakerMode.STEREO:
        out[..., 0, :] = stereo_pan(source_dir, global_panning_strength * panning_strength)
        return out
    tightness = global_panning_strength * 2.0 * panning_strength
    count = SPEAKER_MODE_SPEAKER_COUNT[speaker_mode]
    v = spcap_volumes(source_dir, torch.broadcast_to(tightness, batch), count)
    out[..., 0, 0] = v[..., 0]  # front-left
    out[..., 0, 1] = v[..., 1]  # front-right
    out[..., 1, 0] = v[..., 2]  # center
    out[..., 1, 1] = 1.0  # LFE — always full power
    if speaker_mode in (SpeakerMode.SURROUND_51, SpeakerMode.SURROUND_71):
        out[..., 2, 0] = v[..., 3]
        out[..., 2, 1] = v[..., 4]
    if speaker_mode == SpeakerMode.SURROUND_71:
        out[..., 3, 0] = v[..., 5]
        out[..., 3, 1] = v[..., 6]
    return out
