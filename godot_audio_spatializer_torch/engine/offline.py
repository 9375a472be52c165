"""Offline / headless rendering (PyTorch port of engine/offline.py).

One physics tick (Stage A geometry) and one audio block (Stage B mix +
bus reduction) per step, looped over a scene trajectory with MixState
carried from block to block.  This is the throughput path: benchmarks,
offline bakes, batch auralization.  PyTorch runs eagerly, so the JAX
package's one-dispatch ``lax.scan`` is a Python loop here; on a CUDA
device every block enqueues its kernels without waiting for the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import (
    DOPPLER_PITCH_MAX,
    DOPPLER_PITCH_MIN,
    PLAYBACK_DISABLE_THRESHOLD_DB,
    SPEAKER_MODE_CHANNEL_COUNT,
    SpeakerMode,
)
from ..ops.geometry import SceneState, SourceParams, SpatializeResult, calculate_spatialization
from ..ops.mix import BlockParams, MixState, SampleBank, mix_block
from ..ops.resample import quantize_pitch
from ..utils.device import resolve_device
from .server import bus_graph_reduce


@dataclass
class SlotConfig:
    """Per-slot playback config that isn't part of Stage A geometry."""

    mix_channel_mode: torch.Tensor  # [N] bool
    threshold_db: torch.Tensor  # [N] f32
    paused: torch.Tensor  # [N] bool
    use_chain: torch.Tensor  # [N] bool — effect-family sources

    def replace(self, **changes) -> "SlotConfig":
        return dataclasses.replace(self, **changes)


def default_slot_config(n: int, use_chain: bool = False, device=None) -> SlotConfig:
    """Reference defaults on `device` (default: the CUDA card; raises
    when there is none)."""
    dev = resolve_device(device)
    return SlotConfig(
        mix_channel_mode=torch.zeros(n, dtype=torch.bool, device=dev),
        threshold_db=torch.full((n,), PLAYBACK_DISABLE_THRESHOLD_DB, dtype=torch.float32, device=dev),
        paused=torch.zeros(n, dtype=torch.bool, device=dev),
        use_chain=torch.full((n,), use_chain, dtype=torch.bool, device=dev),
    )


def _dense_bus_targets(r: SpatializeResult, mix_channel_mode, num_buses: int):
    """Dense server bus-volume targets [N, B, 4, 2] from the per-slot bus
    routing (get_bus_map semantics: mode A sends the mix volumes to each
    routed bus, mode B the per-bus ratio)."""
    mv = r.mix_volumes
    buses = torch.arange(num_buses, device=mv.device)
    onehot = (
        (r.bus_index[..., None] == buses[None, None, :]) & (r.bus_index[..., None] >= 0)
    ).to(torch.float32)
    mv_s = mv[:, None]
    safe_mv = torch.where(mv_s > 0, mv_s, torch.ones_like(mv_s))
    ratio = torch.where(mv_s > 0.0, r.bus_volumes / safe_mv, torch.zeros_like(r.bus_volumes))
    val_a = mv_s.expand_as(r.bus_volumes)
    val = torch.where(mix_channel_mode[:, None, None, None], ratio, val_a)
    return torch.einsum("nsb,nsce->nbce", onehot, val)


def _block_params(r: SpatializeResult, slot_cfg: SlotConfig) -> BlockParams:
    return BlockParams(
        mix_volumes=r.mix_volumes,
        pitch_fp=quantize_pitch(r.pitch_scale),
        linear_attenuation=r.linear_attenuation,
        attenuation_filter_cutoff_hz=r.attenuation_filter_cutoff_hz,
        mix_channel_mode=slot_cfg.mix_channel_mode,
        threshold_db=slot_cfg.threshold_db,
        paused=slot_cfg.paused,
    )


def engine_step(
    mix_state: MixState,
    was_out: torch.Tensor,
    scene: SceneState,
    params: SourceParams,
    slot_cfg: SlotConfig,
    bank: SampleBank,
    *,
    speaker_mode: SpeakerMode,
    mix_rate: float,
    frame_count: int,
    mix_channel_enabled: bool = False,
    global_panning_strength: float = 1.0,
    biquad_method: Optional[str] = None,
    sends: Tuple[int, ...] = (-1,),
    bus_volumes_db: Tuple[float, ...] = (0.0,),
    chain: Tuple = (),
    max_pitch: float = 8.0,
    unit_pitch_aligned: bool = False,
    resample_gather: Optional[str] = None,
    unit_row_width: int = 128,
    fused_bus: Optional[bool] = None,
    planar: Optional[bool] = None,
    doppler_wrow: int = 128,
):
    """One physics tick + one audio block, sources == slots (1:1).

    Knobs as ``render_trajectory``.  Returns (new_mix_state, new_was_out,
    master [C, F, 2], peaks [N])."""
    result = calculate_spatialization(
        scene, params, was_out, speaker_mode, global_panning_strength
    )
    dense = _dense_bus_targets(result, slot_cfg.mix_channel_mode, mix_state.srv_prev.shape[1])
    mix_state = mix_state.replace(srv_target=torch.where(
        result.update_parameters[:, None, None, None], dense, mix_state.srv_target
    ))
    channel_count = SPEAKER_MODE_CHANNEL_COUNT[SpeakerMode(speaker_mode)]
    new_state, bus_in, peaks = mix_block(
        mix_state, _block_params(result, slot_cfg), bank,
        mix_rate=mix_rate, frame_count=frame_count, channel_count=channel_count,
        mix_channel_enabled=mix_channel_enabled, biquad_method=biquad_method,
        chain=chain, max_pitch=max_pitch, unit_pitch_aligned=unit_pitch_aligned,
        resample_gather=resample_gather, unit_row_width=unit_row_width,
        fused_bus=fused_bus, planar=planar, doppler_wrow=doppler_wrow,
    )
    empty = tuple(() for _ in sends)
    master, _ = bus_graph_reduce(bus_in, sends, bus_volumes_db, empty, empty, channel_count)
    return new_state, result.was_out_of_range, master, peaks


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def trajectory_pitch_bound(scene0, source_vel_seq, params, ceiling: float = 8.0) -> float:
    """Host upper bound on the maximum Stage-A pitch over a trajectory —
    the `max_pitch="auto"` derivation for `render_trajectory`:
    ps·sos/(sos − max_{k,l}|v_src − v_lis|) bounds every tick's doppler
    pitch, ×1.002 margin for f32 arithmetic; `ceiling` (the reference's
    8.0 doppler clamp) stays the hard clamp."""
    ps = _np(params.pitch_scale).astype(np.float64)
    if ps.size == 0:
        return min(1.0, float(ceiling))
    bound = float(ps.max())
    dop = _np(params.doppler_enabled).astype(bool)
    if dop.any():
        sos = _np(params.doppler_speed_of_sound).astype(np.float64)
        v = _np(source_vel_seq).astype(np.float64)  # [K, N, 3]
        lv = _np(scene0.listener_vel).astype(np.float64)  # [L, 3]
        if lv.size:
            rel = np.linalg.norm(v[:, :, None, :] - lv[None, None, :, :], axis=-1)
            vmax = rel.max(axis=(0, 2))  # [N]
        else:
            vmax = np.zeros(ps.shape)
        with np.errstate(divide="ignore", over="ignore"):
            b = np.where(
                vmax >= sos,
                DOPPLER_PITCH_MAX,
                np.minimum(ps * sos / np.maximum(sos - vmax, 1e-12), DOPPLER_PITCH_MAX),
            )
        b = np.maximum(np.maximum(b, ps), DOPPLER_PITCH_MIN) * 1.002
        b = np.where(vmax > 0.0, b, ps)  # zero relative velocity: mask off
        bound = max(bound, float(np.where(dop, b, ps).max()))
    return min(bound, float(ceiling))


def render_trajectory(
    mix_state: MixState,
    was_out: torch.Tensor,
    scene0: SceneState,
    source_pos_seq: torch.Tensor,  # [K, N, 3] per-block source positions
    source_vel_seq: torch.Tensor,  # [K, N, 3]
    params: SourceParams,
    slot_cfg: SlotConfig,
    bank: SampleBank,
    *,
    speaker_mode: SpeakerMode,
    mix_rate: float,
    frame_count: int,
    mix_channel_enabled: bool = False,
    global_panning_strength: float = 1.0,
    biquad_method: Optional[str] = None,
    sends: Tuple[int, ...] = (-1,),
    bus_volumes_db: Tuple[float, ...] = (0.0,),
    collect_master: bool = True,
    chain: Tuple = (),
    max_pitch=8.0,
    unit_pitch_aligned: bool = False,
    physics_every: int = 1,
    resample_gather: Optional[str] = None,
    unit_row_width: int = 128,
    fused_bus: Optional[bool] = None,
    planar: Optional[bool] = None,
    doppler_wrow: int = 128,
):
    """Render K blocks with per-block source motion.

    Returns (final_state, was_out, master [K, C, F, 2] — or, with
    ``collect_master=False``, the running power Σ master² as a 0-d
    tensor).

    The tensors' device decides where it runs (the builders put them on
    the CUDA card by default).  ``biquad_method`` / ``resample_gather``:
    "kernel" (the CUDA kernels; their plain twins for CPU tensors) or
    "plain" (plain PyTorch); None picks "kernel" on a CUDA device and
    "plain" elsewhere.  ``planar``: None takes the planar doppler route
    when its gates hold (N % 1024 == 0, kernels, variable pitch), False
    takes the split route, True requires the planar one.

    ``physics_every=k`` runs Stage A once per k blocks (the reference's
    own cadence: 60 Hz physics ticks, ~94 Hz audio blocks); K must be a
    multiple of k.  Stage A sees tick g's positions with the previous
    tick's out-of-range flag (the two-frame hysteresis, cpp:466-471).

    ``max_pitch="auto"`` derives the resample-window bound from the
    trajectory (``trajectory_pitch_bound``)."""
    if max_pitch == "auto":
        max_pitch = trajectory_pitch_bound(scene0, source_vel_seq, params)
    k = physics_every
    K = source_pos_seq.shape[0]
    if K % k:
        raise ValueError("num_blocks must be a multiple of physics_every")
    channel_count = SPEAKER_MODE_CHANNEL_COUNT[SpeakerMode(speaker_mode)]
    num_buses = mix_state.srv_prev.shape[1]
    empty = tuple(() for _ in sends)
    state = mix_state
    outs = []
    acc = torch.zeros((), dtype=torch.float32, device=source_pos_seq.device)
    for g in range(K // k):
        scene = scene0.replace(source_pos=source_pos_seq[g * k], source_vel=source_vel_seq[g * k])
        r = calculate_spatialization(
            scene, params, was_out, speaker_mode, global_panning_strength
        )
        was_out = r.was_out_of_range
        dense = _dense_bus_targets(r, slot_cfg.mix_channel_mode, num_buses)
        state = state.replace(srv_target=torch.where(
            r.update_parameters[:, None, None, None], dense, state.srv_target
        ))
        bp = _block_params(r, slot_cfg)
        for _ in range(k):
            state, bus_in, _ = mix_block(
                state, bp, bank,
                mix_rate=mix_rate, frame_count=frame_count,
                channel_count=channel_count,
                mix_channel_enabled=mix_channel_enabled,
                biquad_method=biquad_method, chain=chain,
                max_pitch=max_pitch, unit_pitch_aligned=unit_pitch_aligned,
                resample_gather=resample_gather, unit_row_width=unit_row_width,
                fused_bus=fused_bus, planar=planar, doppler_wrow=doppler_wrow,
            )
            master, _ = bus_graph_reduce(
                bus_in, sends, bus_volumes_db, empty, empty, channel_count
            )
            if collect_master:
                outs.append(master)
            else:
                acc = acc + (master * master).sum()
    return state, was_out, (torch.stack(outs) if collect_master else acc)
