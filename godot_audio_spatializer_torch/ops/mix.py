"""Stage B — the batched per-block mix engine, mode A (PyTorch port of
ops/mix.py).

One array program over N source lanes per audio block (reference
``_mix_from_playback_list``, audio_spatializer.cpp:326-527, and the
AudioSpatializer3D frame processors, audio_spatializer_3d.cpp:491-609):

  resample → lookahead delay/end-fade → interpolated highshelf biquad →
  peak/auto-disable → bus contraction with the server volume ramp.

All temporal state lives in an explicit ``MixState``.  Functions are
pure: they return new containers and never write to their inputs.

Only process-frames mode (mode A, ``mix_channel_enabled=False``) is
ported.  Mode B, effect chains, custom ``_mix_channel`` processors, the
in-kernel bus contraction, int16 intermediates and wide doppler windows
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..constants import (
    FADEOUT_BASE,
    HIGHSHELF_GAIN_EPSILON,
    LOOKAHEAD_BUFFER_SIZE,
    MAX_CHANNELS_PER_BUS,
)
from ..utils.device import resolve_device
from ..utils.dsp import db_to_linear
from .biquad import biquad_interp_block, highshelf_coeffs
from .kernels.mix_mode_a import fused_mode_a, fused_mode_a_planar
from .resample import resample_block

_MODE_B = "ROADMAP Queue 1, item 8 (mode B and speaker modes)"
_CHAINS = "ROADMAP Queue 1, item 9 (effects)"
_INT16 = "ROADMAP Queue 4, item 1 (int16 PCM intermediates)"
_WROW = "ROADMAP Queue 4, item 2 (wide doppler window rows)"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: {item}")


@dataclass
class SampleBank:
    """Flat device-resident audio clip store + per-slot addressing."""

    data: torch.Tensor  # [T, 2] f32
    base: torch.Tensor  # [N] i32
    length: torch.Tensor  # [N] i32
    loop: torch.Tensor  # [N] bool
    loop_begin: Optional[torch.Tensor] = None  # [N] i32; None = 0


@dataclass
class MixState:
    """All carried audio-thread state, one lane per source slot."""

    cursor_idx: torch.Tensor  # [N] i32
    cursor_frac: torch.Tensor  # [N] i32
    active: torch.Tensor  # [N] bool
    has_frames: torch.Tensor  # [N] bool
    lookahead: torch.Tensor  # [N, 64, 2] f32
    prev_mix_volumes: torch.Tensor  # [N, 4, 2] f32
    filter_coeffs: torch.Tensor  # [N, 5] f32
    filter_state: torch.Tensor  # [N, 1, 2, 4] f32 — (x1, x2, y1, y2)
    srv_prev: torch.Tensor  # [N, B, 4, 2] f32 — server ramp "from"
    srv_target: torch.Tensor  # [N, B, 4, 2] f32 — server ramp "to"

    def replace(self, **changes) -> "MixState":
        return dataclasses.replace(self, **changes)


def make_mix_state(n: int, num_buses: int, filter_channels: int = 1,
                   chain_effects=(), sample_dtype=torch.float32,
                   device=None) -> MixState:
    """Zeroed state for `n` lanes and `num_buses` buses on `device`
    (default: the CUDA card; raises when there is none)."""
    if filter_channels != 1:
        raise _not_ported("per-channel filter state (mode B)", _MODE_B)
    if chain_effects:
        raise _not_ported("per-source effect chains", _CHAINS)
    if sample_dtype != torch.float32:
        raise _not_ported("int16 PCM intermediates", _INT16)
    dev = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return MixState(
        cursor_idx=z(n, dtype=torch.int32),
        cursor_frac=z(n, dtype=torch.int32),
        active=z(n, dtype=torch.bool),
        has_frames=z(n, dtype=torch.bool),
        lookahead=z(n, LOOKAHEAD_BUFFER_SIZE, 2),
        prev_mix_volumes=z(n, MAX_CHANNELS_PER_BUS, 2),
        filter_coeffs=z(n, 5),
        filter_state=z(n, 1, 2, 4),
        srv_prev=z(n, num_buses, MAX_CHANNELS_PER_BUS, 2),
        srv_target=z(n, num_buses, MAX_CHANNELS_PER_BUS, 2),
    )


@dataclass
class BlockParams:
    """Per-block snapshot of SpatializerParameters3D lanes (Stage A output
    after the engine's physics-tick bookkeeping)."""

    mix_volumes: torch.Tensor  # [N, 4, 2] f32
    pitch_fp: torch.Tensor  # [N] i32
    linear_attenuation: torch.Tensor  # [N] f32
    attenuation_filter_cutoff_hz: torch.Tensor  # [N] f32
    mix_channel_mode: torch.Tensor  # [N] bool
    threshold_db: torch.Tensor  # [N] f32
    paused: torch.Tensor  # [N] or [N, 4] bool (per channel-pair proxy)
    voice_gain: Optional[torch.Tensor] = None  # [N] f32; None = all ones


def _end_fade_factor(mixed, frame_count: int):
    """Fade factor over combined-buffer positions for a partial mix
    (reference audio_spatializer.cpp:380-398): positions < mixed pass
    through, the next 64 get 0.96^(k+1)·(64-k)/64, the rest are zeroed."""
    f = torch.arange(frame_count, dtype=torch.int32, device=mixed.device)[None, :]
    k = f - mixed[:, None]  # [N, F]
    kf = k.to(torch.float32)
    la = float(LOOKAHEAD_BUFFER_SIZE)
    fade = torch.exp(math.log(FADEOUT_BASE) * (kf + 1.0)) * (la - kf) / la
    zero = torch.zeros((), dtype=torch.float32, device=mixed.device)
    return torch.where(
        k < 0, torch.ones_like(fade),
        torch.where(k < LOOKAHEAD_BUFFER_SIZE, fade, zero),
    )


def _first_max_index(x):
    """Index of the FIRST maximum along the last axis (jnp.argmax ties:
    zero volumes tie often, and the first channel must win)."""
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    big = torch.full_like(idx, x.shape[-1])
    return torch.where(x == x.amax(dim=-1, keepdim=True), idx, big).amin(dim=-1)


def default_methods(device) -> Tuple[str, str]:
    """(biquad_method, resample_gather) defaults for a device: the CUDA
    kernels on the card, the plain PyTorch path elsewhere."""
    return ("kernel", "kernel") if torch.device(device).type == "cuda" else (
        "plain", "plain")


def mix_block(
    state: MixState,
    params: BlockParams,
    bank: SampleBank,
    *,
    mix_rate: float,
    frame_count: int,
    channel_count: int,
    mix_channel_enabled: bool = False,
    biquad_method: Optional[str] = None,
    chain: tuple = (),
    mc_chain: tuple = (),
    max_pitch: float = 8.0,
    unit_pitch_aligned: bool = False,
    resample_gather: Optional[str] = None,
    unit_row_width: int = 128,
    fused_bus: Optional[bool] = None,
    planar: Optional[bool] = None,
    doppler_wrow: int = 128,
):
    """One audio block for all N sources.

    Returns (new_state, bus_input [B, 4, F, 2], peaks [N]).

    ``biquad_method``: "kernel" runs the fused mode-A frame path
    (``ops/kernels/mix_mode_a.py``: the CUDA kernel for CUDA tensors, its
    plain twin for CPU tensors); "plain" runs the delay line and end fade
    as tensor ops and the biquad as ``biquad_interp_block(method="scan")``.
    ``resample_gather``: "kernel" (the CUDA resampler) or "plain".  Both
    default to "kernel" on a CUDA device and "plain" elsewhere.

    ``planar``: None takes the planar doppler route (resampler raw layout
    straight into ``fused_mode_a_planar``) whenever its gates hold;
    True requires it and raises ``ValueError`` when a gate is off; False
    takes the split route.  ``channel_count`` is the speaker-mode
    channel-pair count.
    """
    F = frame_count
    la = LOOKAHEAD_BUFFER_SIZE
    assert F >= la, "block size must cover the lookahead buffer"
    N = params.mix_volumes.shape[0]
    dev = params.mix_volumes.device
    d_bq, d_rs = default_methods(bank.data.device)
    biquad_method = d_bq if biquad_method is None else biquad_method
    resample_gather = d_rs if resample_gather is None else resample_gather

    if mix_channel_enabled:
        raise _not_ported("mix_channel mode (mode B)", _MODE_B)
    if chain or mc_chain:
        raise _not_ported("effect chains and custom _mix_channel processors", _CHAINS)
    if fused_bus:
        raise _not_ported(
            "the in-kernel bus contraction (fused_bus=True)",
            "ROADMAP Queue 2, rows 4-5 (fused_mode_a_bus, fused_mode_a_bus_planar)",
        )
    if doppler_wrow != 128:
        raise _not_ported("wide doppler window rows (doppler_wrow != 128)", _WROW)
    if state.lookahead.dtype == torch.int16 or bank.data.dtype == torch.int16:
        raise _not_ported("int16 PCM intermediates", _INT16)

    # pause is a per-proxy flag; a mode-A lane has exactly one proxy
    pch = params.paused
    if pch.dim() == 1:
        pch = pch[:, None].expand(N, MAX_CHANNELS_PER_BUS)
    lane_paused = pch[:, 0]
    active0 = state.active & ~lane_paused
    has0 = state.has_frames

    # ---- 1. resample (L0 AudioStreamPlayback::mix) ----
    planar_base = (
        biquad_method == "kernel"
        and resample_gather == "kernel"
        and not unit_pitch_aligned
        and params.voice_gain is None
        and (planar if planar is not None else True)
        and F % 128 == 0
        and N % 1024 == 0
    )
    if planar is True and not planar_base:
        raise ValueError(
            "planar=True requested but the planar path is gated off "
            "(needs biquad_method='kernel', resample_gather='kernel', "
            "variable pitch, no voice gain, F % 128 == 0 and N % 1024 == 0; "
            f"got N={N}, F={F}, biquad_method={biquad_method!r}, "
            f"resample_gather={resample_gather!r})"
        )
    frames, mixed, nidx, nfrac = resample_block(
        bank.data, bank.base, bank.length, bank.loop,
        state.cursor_idx, state.cursor_frac, params.pitch_fp, F,
        max_pitch=max_pitch, unit_pitch_aligned=unit_pitch_aligned,
        gather_method=resample_gather, loop_begin=bank.loop_begin,
        row_width=unit_row_width,
        layout="planar" if planar_base else "interleaved",
    )
    if planar_base:
        mixed_padded = mixed  # [Np] — the planar wrapper takes the pad too
        mixed = mixed[:N]
    if params.voice_gain is not None:
        frames = frames * params.voice_gain[:, None, None]
    do_mix = active0 & has0
    new_cursor_idx = torch.where(do_mix, nidx, state.cursor_idx)
    new_cursor_frac = torch.where(do_mix, nfrac, state.cursor_frac)

    # ---- 2/3. masks + highshelf config ----
    full = mixed == F
    new_has_frames = has0 & full
    gain = params.linear_attenuation
    apply_f = gain >= HIGHSHELF_GAIN_EPSILON
    target = highshelf_coeffs(mix_rate, params.attenuation_filter_cutoff_hz, gain)
    t = torch.arange(F, dtype=torch.float32, device=dev) / float(F)  # [F] ramp

    prev0 = state.prev_mix_volumes[:, 0]  # [N, 2]
    just_started = (prev0[:, 0] == 0) & (prev0[:, 1] == 0)
    stA = state.filter_state[:, 0]  # [N, 2, 4]
    stA = torch.where((just_started & apply_f)[:, None, None], torch.zeros_like(stA), stA)

    if planar_base:
        # ---- 4a (fused, planar input): the resampler's raw layout flows
        # straight into the mix kernel ----
        sigA, new_lookahead, nstA, ncA, peakA = fused_mode_a_planar(
            frames, state.lookahead, state.filter_coeffs, target, stA,
            mixed_padded, do_mix, apply_f, F,
        )
    elif biquad_method == "kernel":
        # ---- 4a (fused): delay line + fade + mask + biquad + peak +
        # lookahead update in one kernel ----
        sigA, new_lookahead, nstA, ncA, peakA = fused_mode_a(
            frames, state.lookahead, state.filter_coeffs, target, stA,
            mixed, do_mix, apply_f, F,
        )
    else:
        # ---- 2'. lookahead delay line + end-of-stream fade ----
        combined = torch.cat([state.lookahead, frames[:, : F - la]], dim=1)
        factor = _end_fade_factor(mixed, F)  # [N, F]
        combined = torch.where(full[:, None, None], combined, combined * factor[..., None])
        combined = torch.where(do_mix[:, None, None], combined, torch.zeros_like(combined))
        new_lookahead = torch.where(
            (do_mix & full)[:, None, None], frames[:, F - la : F], state.lookahead
        )
        # ---- 4a. mode A: process_frames (filter only, 1 proxy channel) ----
        yA, nstA, ncA2 = biquad_interp_block(
            combined.movedim(1, 2),  # [N, 2, F]
            state.filter_coeffs[:, None, :].expand(N, 2, 5),
            target[:, None, :].expand(N, 2, 5),
            stA,
            apply_f[:, None].expand(N, 2),
            method="scan" if biquad_method == "plain" else biquad_method,
        )
        sigA = yA.movedim(2, 1)  # [N, F, 2]
        ncA = ncA2[:, 0]
        peakA = sigA.abs().amax(dim=(1, 2))

    # prev volume := loudest channel's volume (cpp:537-551)
    flat = params.mix_volumes.reshape(N, -1)  # (channel, ear) order
    max_c = _first_max_index(flat) // 2
    prevA_new = params.mix_volumes[torch.arange(N, device=dev), max_c]  # [N, 2]

    peak = peakA
    new_prev = state.prev_mix_volumes.clone()
    new_prev[:, 0] = prevA_new
    new_fstate = state.filter_state.clone()
    new_fstate[:, 0] = nstA
    new_coeffs = ncA

    # freeze state on inactive lanes
    inz = active0
    new_prev = torch.where(inz[:, None, None], new_prev, state.prev_mix_volumes)
    new_fstate = torch.where(inz[:, None, None, None], new_fstate, state.filter_state)
    new_coeffs = torch.where(inz[:, None], new_coeffs, state.filter_coeffs)
    new_lookahead = torch.where(inz[:, None, None], new_lookahead, state.lookahead)
    new_has_frames = torch.where(inz, new_has_frames, has0)

    # ---- 5. auto-disable at threshold (cpp:464-469) ----
    thr = db_to_linear(params.threshold_db)
    new_active = active0 & ~((~new_has_frames) & (peak <= thr))
    new_active = torch.where(lane_paused, state.active, new_active)

    # ---- 6. bus contraction with the server-side volume ramp ----
    # bus[b,c,f,e] = Σ_n sig·(v0·(1−t) + v1·t); the active mask folds into
    # the (tiny) volume lanes rather than the [N, F, 2] signal
    mA = active0.to(torch.float32)[:, None, None, None]
    v0 = state.srv_prev * mA
    v1 = state.srv_target * mA
    bus0 = torch.einsum("nfe,nbce->bcfe", sigA, v0)
    bus1 = torch.einsum("nfe,nbce->bcfe", sigA, v1)
    bus = bus0 * (1.0 - t)[None, None, :, None] + bus1 * t[None, None, :, None]

    # ramp completed → hold at target (frozen while paused/inactive)
    ramp_done = (active0[:, None] & (~pch | ~params.mix_channel_mode[:, None]))
    new_state = MixState(
        cursor_idx=new_cursor_idx,
        cursor_frac=new_cursor_frac,
        active=new_active,
        has_frames=new_has_frames,
        lookahead=new_lookahead,
        prev_mix_volumes=new_prev,
        filter_coeffs=new_coeffs,
        filter_state=new_fstate,
        srv_prev=torch.where(ramp_done[:, None, :, None], state.srv_target, state.srv_prev),
        srv_target=state.srv_target,
    )
    return new_state, bus, peak
