"""Benchmark scene construction (BASELINE.md north-star shape; PyTorch
port of utils/benchscene.py).

N moving sources orbiting one listener, looping noise clips made from
the seed with NumPy: the same draws in the same order as the JAX
package, so both packages build identical scenes from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.offline import default_slot_config
from ..engine.scene import ListenerDesc, build_scene_state, default_source_params
from ..ops.mix import SampleBank, make_mix_state
from ..ops.resample import build_bank
from ..utils.device import resolve_device


def build_bench_scene(
    n_sources: int,
    num_blocks: int,
    frame_count: int,
    mix_rate: float,
    *,
    num_clips: int = 8,
    clip_seconds: float = 1.0,
    doppler: bool = True,
    seed: int = 0,
    chain_effects=(),
    use_chain: bool = False,
    bank_dtype=np.float32,
    row_align: int = 128,
    int16_state: bool = False,
    device=None,
):
    """→ (mix_state, was_out, scene0, pos_seq, vel_seq, params, slot_cfg,
    bank), all on `device` (default: the CUDA card; raises when there is
    none).

    `row_align=frame_count` aligns the bank, cursors and clip lengths for
    the wide-row unit-pitch read (resample_block row_width=frame_count)."""
    if np.dtype(bank_dtype) != np.float32 or int16_state:
        raise NotImplementedError(
            "int16 banks and PCM intermediates are not ported yet: "
            "ROADMAP Queue 4, item 1"
        )
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_sources

    clip_len = int(clip_seconds * mix_rate) // row_align * row_align
    clips = [
        ((rng.standard_normal((clip_len, 2)) * 0.1).astype(np.float32), True)
        for _ in range(num_clips)
    ]
    bank_data, bases = build_bank(clips, frame_count, max_pitch=2.0, align=row_align)
    base = np.asarray(bases, np.int32)[np.arange(n) % num_clips]

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    bank = SampleBank(
        data=t(bank_data),
        base=t(base),
        length=t(np.full(n, clip_len, np.int32)),
        loop=t(np.ones(n, bool)),
    )
    state = make_mix_state(n, num_buses=1, filter_channels=1,
                           chain_effects=chain_effects, device=dev)
    aligned_cursors = (rng.integers(0, clip_len // row_align, n) * row_align).astype(np.int32)
    state = state.replace(
        active=t(np.ones(n, bool)),
        has_frames=t(np.ones(n, bool)),
        cursor_idx=t(aligned_cursors),
    )
    was_out = t(np.zeros(n, bool))

    params = default_source_params(n, device=dev)
    params = params.replace(doppler_enabled=t(np.full(n, doppler, bool)))

    # orbiting sources: radius 2..40 m, angular speed up to 2 rad/s
    radius = rng.uniform(2.0, 40.0, n)
    height = rng.uniform(-3.0, 3.0, n)
    phase0 = rng.uniform(0, 2 * np.pi, n)
    omega = rng.uniform(-2.0, 2.0, n)
    dt = frame_count / mix_rate
    k = np.arange(num_blocks)[:, None]
    ang = phase0[None, :] + omega[None, :] * (k * dt)  # [K,N]
    pos = np.stack(
        [radius * np.cos(ang), np.broadcast_to(height, ang.shape), radius * np.sin(ang)],
        axis=-1,
    ).astype(np.float32)  # [K,N,3]
    vel = np.stack(
        [-radius * omega * np.sin(ang), np.zeros_like(ang), radius * omega * np.cos(ang)],
        axis=-1,
    ).astype(np.float32)

    scene0 = build_scene_state(pos[0], [ListenerDesc()], [], {"Master": 0}, device=dev)
    slot_cfg = default_slot_config(n, use_chain=use_chain, device=dev)
    return state, was_out, scene0, t(pos), t(vel), params, slot_cfg, bank
