"""Stage A — batched ``calculate_spatialization`` (PyTorch port of
ops/geometry.py).

The reference's per-player scalar loop over cameras
(audio_spatializer_3d.cpp:277-489) is one array program over axes
[N sources, L listeners]: the camera loop is a listeners axis with a
max-combine reduction (cpp:258-266), area selection is a masked first
match, and the out-of-range two-frame hysteresis (cpp:466-471) is a
carried boolean lane.

The f32 operation order follows the JAX package wherever a rounding
difference could move a quantized value (the doppler pitch feeds the
16-bit fixed-point resampler cursor).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..constants import (
    DOPPLER_PITCH_MAX,
    DOPPLER_PITCH_MIN,
    MAX_BUSES_PER_PLAYBACK,
    SpeakerMode,
)
from ..utils.dsp import db_to_linear, norm3, safe_normalize
from .attenuation import attenuation_multiplier
from .pan import calc_output_vol
from .reverb import calc_reverb_vol


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class SourceParams(_Replace):
    """Per-source spatializer + player configuration, all tensors [N]
    (AudioSpatializer3D tunables, reference audio_spatializer_3d.h:151-241,
    plus the owning player's volume/pitch/bus properties)."""

    attenuation_model: torch.Tensor  # i32
    unit_size: torch.Tensor  # f32, default 10
    max_distance: torch.Tensor  # f32, 0 = unlimited
    panning_strength: torch.Tensor  # f32, default 1
    area_mask: torch.Tensor  # i32, default 1
    emission_angle_enabled: torch.Tensor  # bool
    emission_angle_cos: torch.Tensor  # f32 — cos(emission_angle_degrees)
    emission_angle_filter_attenuation_db: torch.Tensor  # f32, default -12
    attenuation_filter_cutoff_hz: torch.Tensor  # f32, default 5000
    attenuation_filter_db: torch.Tensor  # f32, default -24
    doppler_enabled: torch.Tensor  # bool
    doppler_speed_of_sound: torch.Tensor  # f32, default 343
    volume_db: torch.Tensor  # f32 player volume
    max_db: torch.Tensor  # f32 player max_db, default 3
    volume_linear: torch.Tensor  # f32 = db_to_linear(volume_db), host f64
    max_linear: torch.Tensor  # f32 = db_to_linear(max_db), host f64
    pitch_scale: torch.Tensor  # f32 player pitch
    bus_index: torch.Tensor  # i32 player bus


@dataclass
class SceneState(_Replace):
    """Per-physics-tick world state, tensors [N] / [L] / [A]."""

    source_pos: torch.Tensor  # [N,3]
    source_vel: torch.Tensor  # [N,3]
    source_z_axis: torch.Tensor  # [N,3] player basis column 2
    source_active: torch.Tensor  # [N] bool
    listener_rot: torch.Tensor  # [L,3,3] orthonormalized row basis
    listener_inv: torch.Tensor  # [L,3,3] full basis inverse
    listener_origin: torch.Tensor  # [L,3]
    listener_vel: torch.Tensor  # [L,3]
    listener_active: torch.Tensor  # [L] bool
    area_center: torch.Tensor  # [A,3]
    area_half: torch.Tensor  # [A,3] box half-extents; radius in [.,0]
    area_shape: torch.Tensor  # [A] i32: 0 box, 1 sphere, 2 capsule, 3 cylinder, 4 convex
    area_rot: torch.Tensor  # [A,3,3] world→local rotation
    area_mask: torch.Tensor  # [A] i32
    area_override_bus: torch.Tensor  # [A] i32, -1 = none
    area_reverb_bus: torch.Tensor  # [A] i32, -1 = none
    area_reverb_amount: torch.Tensor  # [A] f32
    area_reverb_uniformity: torch.Tensor  # [A] f32
    area_active: torch.Tensor  # [A] bool
    area_planes: torch.Tensor  # [A,P,4] convex half-spaces n·x ≤ d
    area_edges: torch.Tensor  # [A,E,2,3] convex hull edges


@dataclass
class SpatializeResult(_Replace):
    """Batched SpatializerParameters(3D), one lane per source
    (reference spatializer_parameters.h:39-67)."""

    mix_volumes: torch.Tensor  # [N,4,2]
    pitch_scale: torch.Tensor  # [N]
    linear_attenuation: torch.Tensor  # [N]
    attenuation_filter_cutoff_hz: torch.Tensor  # [N]
    bus_index: torch.Tensor  # [N,S] i32, -1 = unused (S = 6)
    bus_volumes: torch.Tensor  # [N,S,4,2]
    update_parameters: torch.Tensor  # [N] bool
    was_out_of_range: torch.Tensor  # [N] bool — carry to next tick


def _first_index(mask, dim):
    """Index of the first True along `dim`, 0 when there is none (the
    jnp.argmax-of-bool semantics)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).reshape(shape).expand_as(mask)
    first = torch.where(mask, idx, torch.full_like(idx, n)).amin(dim=dim)
    return torch.where(first == n, torch.zeros_like(first), first)


def _clip(x, lo, hi):
    """jnp.clip order: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _capsule_seg_rel(local, half):
    """Offset from a local-frame point to the capsule's Y-axis core
    segment (half-length in half[..., 1])."""
    hs = half[..., 1]
    core_y = _clip(local[..., 1], -hs, hs)
    seg = torch.zeros_like(local)
    seg[..., 1] = core_y
    return seg, local - seg


def _select_area(scene: SceneState, params: SourceParams):
    """_get_overriding_area (reference audio_spatializer_3d.cpp:208-245):
    first active area containing the source point, mask-matched, that
    overrides the bus or provides reverb."""
    rel = scene.source_pos[:, None, :] - scene.area_center[None, :, :]  # [N,A,3]
    local = torch.einsum("aij,naj->nai", scene.area_rot, rel)
    box_in = torch.all(local.abs() <= scene.area_half[None, :, :], dim=-1)
    r2 = scene.area_half[None, :, 0] ** 2
    sph_in = (rel * rel).sum(dim=-1) <= r2
    _, cap_d = _capsule_seg_rel(local, scene.area_half[None, :, :])
    cap_in = (cap_d * cap_d).sum(dim=-1) <= r2
    cyl_in = (local[..., 0] ** 2 + local[..., 2] ** 2 <= r2) & (
        local[..., 1].abs() <= scene.area_half[None, :, 1]
    )
    shape = scene.area_shape[None, :]
    contains = torch.where(
        shape == 3, cyl_in,
        torch.where(shape == 2, cap_in, torch.where(shape == 1, sph_in, box_in)),
    )  # [N,A]
    if scene.area_planes.shape[1] > 1:  # the scene holds a convex area
        pn = scene.area_planes[..., :3]
        pd = scene.area_planes[..., 3]
        conv_in = torch.all(
            torch.einsum("api,nai->nap", pn, local) <= pd[None, :, :], dim=-1
        )
        contains = torch.where(shape == 4, conv_in, contains)
    mask_match = (scene.area_mask[None, :] & params.area_mask[:, None]) != 0
    relevant = (scene.area_override_bus >= 0) | (scene.area_reverb_bus >= 0)
    found = contains & mask_match & relevant[None, :] & scene.area_active[None, :]
    return found.any(dim=1), _first_index(found, 1)


def _convex_closest_points(scene: SceneState):
    """Closest point of every convex area's hull to every listener, [A,L,3]
    world frame (inside points stay put).  Candidates: face-plane
    projections that satisfy every plane, and clamped edge projections;
    the nearest wins."""
    rel = scene.listener_origin[None, :, :] - scene.area_center[:, None, :]
    loc = torch.einsum("aij,alj->ali", scene.area_rot, rel)  # [A,L,3]
    pn = scene.area_planes[..., :3]  # [A,P,3]
    pd = scene.area_planes[..., 3]  # [A,P]
    sd = torch.einsum("api,ali->alp", pn, loc) - pd[:, None, :]
    inside = torch.all(sd <= 0.0, dim=-1)  # [A,L]
    qf = loc[:, :, None, :] - sd[..., None] * pn[:, None, :, :]  # [A,L,P,3]
    qf_sd = torch.einsum("aqi,alpi->alpq", pn, qf) - pd[:, None, None, :]
    qf_ok = torch.all(qf_sd <= 3e-5, dim=-1)
    df2 = torch.where(
        qf_ok, ((qf - loc[:, :, None, :]) ** 2).sum(-1),
        torch.full_like(qf_ok, float("inf"), dtype=qf.dtype),
    )
    ea = scene.area_edges[:, :, 0]  # [A,E,3]
    ab = scene.area_edges[:, :, 1] - ea
    ap = loc[:, :, None, :] - ea[:, None, :, :]  # [A,L,E,3]
    denom = torch.clamp((ab * ab).sum(-1), min=1e-20)  # [A,E]
    t = torch.clamp((ap * ab[:, None]).sum(-1) / denom[:, None], 0.0, 1.0)
    qe = ea[:, None] + t[..., None] * ab[:, None]  # [A,L,E,3]
    de2 = ((qe - loc[:, :, None, :]) ** 2).sum(-1)
    cand = torch.cat([qf, qe], dim=2)  # [A,L,P+E,3]
    d2 = torch.cat([df2, de2], dim=2)
    best = _first_index(d2 == d2.amin(dim=2, keepdim=True), 2)  # [A,L]
    q = torch.gather(cand, 2, best[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    q = torch.where(inside[..., None], loc, q)
    return scene.area_center[:, None, :] + torch.einsum("aji,alj->ali", scene.area_rot, q)


def calculate_spatialization(
    scene: SceneState,
    params: SourceParams,
    was_out_of_range: torch.Tensor,  # [N] bool, carried
    speaker_mode: SpeakerMode,
    global_panning_strength: float = 1.0,
    *,
    has_areas: bool = True,
    any_doppler: bool = True,
) -> SpatializeResult:
    """`has_areas`/`any_doppler` skip the area and doppler math; they must
    be conservative upper bounds (with the flag False the skipped math
    contributes exactly its all-inactive value)."""
    N = scene.source_pos.shape[0]
    L = scene.listener_origin.shape[0]
    dev = scene.source_pos.device
    f32 = torch.float32

    # ---- area selection (per source) ----
    if has_areas:
        has_area, area_idx = _select_area(scene, params)
        a_center = scene.area_center[area_idx]  # [N,3]
        a_half = scene.area_half[area_idx]
        neg = torch.full_like(scene.area_override_bus[area_idx], -1)
        a_override_bus = torch.where(has_area, scene.area_override_bus[area_idx], neg)
        a_reverb_bus = torch.where(has_area, scene.area_reverb_bus[area_idx], neg)
        a_amount = scene.area_reverb_amount[area_idx]
        a_uniformity = scene.area_reverb_uniformity[area_idx]
        use_reverb = has_area & (a_reverb_bus >= 0)
        reverb_uniform = use_reverb & (a_uniformity > 0)

    # ---- listener-local position (cpp:342) ----
    diff = scene.source_pos[:, None, :] - scene.listener_origin[None, :, :]  # [N,L,3]
    local_pos = torch.einsum("lij,nli->nlj", scene.listener_rot, diff)
    dist = norm3(local_pos)  # [N,L]

    # ---- listener_area_pos (closest point on the area shape, cpp:350-353) ----
    if has_areas:
        a_shape = scene.area_shape[area_idx]  # [N]
        a_rot = scene.area_rot[area_idx]  # [N,3,3]
        rel_l = scene.listener_origin[None, :, :] - a_center[:, None, :]  # [N,L,3]
        # oriented box: clamp in the local frame, rotate back
        local_l = torch.einsum("nij,nlj->nli", a_rot, rel_l)
        clamped = _clip(local_l, -a_half[:, None, :], a_half[:, None, :])
        box_cp = a_center[:, None, :] + torch.einsum("nji,nlj->nli", a_rot, clamped)
        one = torch.ones((), dtype=f32, device=dev)

        def surface_scale(d, r):  # pull onto the surface when outside
            return torch.where((d > r) & (d > 0), r / torch.where(d > 0, d, one), one)

        d_l = norm3(rel_l)
        radius = a_half[:, None, 0]
        sph_cp = a_center[:, None, :] + rel_l * surface_scale(d_l, radius)[..., None]
        cap_seg, cap_d = _capsule_seg_rel(local_l, a_half[:, None, :])
        cap_local = cap_seg + cap_d * surface_scale(norm3(cap_d), radius)[..., None]
        cap_cp = a_center[:, None, :] + torch.einsum("nji,nlj->nli", a_rot, cap_local)
        # cylinder = disk (x,z) × interval (y)
        cyl_rad = torch.sqrt(local_l[..., 0] ** 2 + local_l[..., 2] ** 2)
        cyl_scale = surface_scale(cyl_rad, radius)
        cyl_local = torch.stack(
            [
                local_l[..., 0] * cyl_scale,
                _clip(local_l[..., 1], -a_half[:, None, 1], a_half[:, None, 1]),
                local_l[..., 2] * cyl_scale,
            ],
            dim=-1,
        )
        cyl_cp = a_center[:, None, :] + torch.einsum("nji,nlj->nli", a_rot, cyl_local)
        sh = a_shape[:, None, None]
        closest = torch.where(
            sh == 3, cyl_cp,
            torch.where(sh == 2, cap_cp, torch.where(sh == 1, sph_cp, box_cp)),
        )
        if scene.area_planes.shape[1] > 1:  # the scene holds a convex area
            conv_cp = _convex_closest_points(scene)[area_idx]  # [N,L,3]
            closest = torch.where(sh == 4, conv_cp, closest)
        lap_diff = closest - scene.listener_origin[None, :, :]
        listener_area_pos = torch.einsum("lij,nlj->nli", scene.listener_inv, lap_diff)
        lap_len = norm3(listener_area_pos)
        lap_len = torch.where(reverb_uniform[:, None], lap_len, torch.zeros_like(lap_len))
        listener_area_pos = torch.where(
            reverb_uniform[:, None, None], listener_area_pos,
            torch.zeros_like(listener_area_pos),
        )

    # ---- attenuation multiplier (cpp:359-373), linear domain ----
    multiplier = attenuation_multiplier(
        dist,
        params.attenuation_model[:, None],
        params.unit_size[:, None],
        params.volume_linear[:, None],
        params.max_linear[:, None],
    )  # [N,L]
    max_d = params.max_distance[:, None]
    has_max = max_d > 0
    if has_areas:
        total_max = torch.where(
            reverb_uniform[:, None], torch.maximum(max_d, lap_len), max_d
        )
        out_of_range = has_max & ((dist > total_max) | (total_max > max_d))
    else:
        out_of_range = has_max & (dist > max_d)
    rolloff = torch.clamp(
        1.0 - dist / torch.where(has_max, max_d, torch.ones_like(max_d)), min=0.0
    )
    multiplier = torch.where(has_max, multiplier * rolloff, multiplier)

    in_range = (~out_of_range) & scene.listener_active[None, :]  # [N,L]
    has_any = in_range.any(dim=1)  # [N]

    # ---- highshelf attenuation db (cpp:376-385) ----
    db_att = (1.0 - torch.clamp(multiplier, max=1.0)) * params.attenuation_filter_db[:, None]
    lt_dir = safe_normalize(diff)  # [N,L,3]
    z_dir = safe_normalize(scene.source_z_axis)  # [N,3]
    cone_cos = torch.einsum("nli,ni->nl", lt_dir, z_dir)
    outside_cone = cone_cos < params.emission_angle_cos[:, None]
    db_att = torch.where(
        params.emission_angle_enabled[:, None] & outside_cone,
        db_att + params.emission_angle_filter_attenuation_db[:, None],
        db_att,
    )
    linear_attenuation_nl = db_to_linear(db_att)  # [N,L]
    # "last in-range listener wins" (set inside the loop at cpp:387)
    last_in = (L - 1) - _first_index(torch.flip(in_range, dims=(1,)), 1)
    last_in = torch.where(has_any, last_in, torch.zeros_like(last_in))
    linear_attenuation = torch.where(
        has_any,
        torch.gather(linear_attenuation_nl, 1, last_in[:, None])[:, 0],
        torch.zeros((), dtype=f32, device=dev),
    )

    # ---- pan volumes, max-combined across listeners (cpp:390-396) ----
    tmp_volume = calc_output_vol(
        local_pos, params.panning_strength[:, None], speaker_mode,
        global_panning_strength,
    )  # [N,L,4,2]
    tmp_volume = tmp_volume * multiplier[..., None, None]
    tmp_volume = torch.where(
        in_range[..., None, None], tmp_volume, torch.zeros_like(tmp_volume)
    )
    output_volume = tmp_volume.amax(dim=1)  # [N,4,2]

    # ---- reverb volumes (cpp:399-402) ----
    if has_areas:
        reverb_nl = calc_reverb_vol(
            a_uniformity[:, None], a_amount[:, None], listener_area_pos, lap_len,
            tmp_volume, params.attenuation_model[:, None], params.unit_size[:, None],
            params.volume_linear[:, None], params.max_linear[:, None],
            params.panning_strength[:, None], speaker_mode, global_panning_strength,
        )  # [N,L,4,2]
        reverb_nl = torch.where(
            (in_range & use_reverb[:, None])[..., None, None], reverb_nl,
            torch.zeros_like(reverb_nl),
        )
        reverb_volume = reverb_nl.amax(dim=1)
    else:
        reverb_volume = torch.zeros_like(output_volume)

    # ---- doppler (cpp:405-434) ----
    if not any_doppler:
        pitch = params.pitch_scale
    else:
        rel_vel = scene.source_vel[:, None, :] - scene.listener_vel[None, :, :]
        local_velocity = torch.einsum("lij,nli->nlj", scene.listener_rot, rel_vel)
        lv_norm = norm3(local_velocity)  # [N,L]
        nonzero_vel = (local_velocity != 0.0).any(dim=-1)
        approaching = torch.einsum(
            "nli,nli->nl", safe_normalize(local_pos), safe_normalize(local_velocity)
        )
        sos = params.doppler_speed_of_sound[:, None]
        # f32 op order as the JAX package: (ps·sos) / (sos + |v|·cos)
        doppler_pitch = params.pitch_scale[:, None] * sos / (sos + lv_norm * approaching)
        doppler_pitch = torch.clamp(doppler_pitch, DOPPLER_PITCH_MIN, DOPPLER_PITCH_MAX)
        weight = tmp_volume.amax(dim=(2, 3))  # [N,L] — _get_max_volume
        dop_mask = params.doppler_enabled[:, None] & nonzero_vel & in_range
        if L == 1:
            # single listener: the weighted log-domain average is the
            # listener's own pitch — no log2/exp2 round trip
            pitch = torch.where(
                dop_mask[:, 0] & (weight[:, 0] > 0), doppler_pitch[:, 0],
                params.pitch_scale,
            )
        else:
            w = torch.where(dop_mask, weight, torch.zeros_like(weight))
            log_pitch = (w * torch.log2(doppler_pitch)).sum(dim=1)
            w_sum = w.sum(dim=1)
            pitch = torch.where(
                w_sum > 0,
                torch.exp2(log_pitch / torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))),
                params.pitch_scale,
            )

    # ---- bus routing (cpp:437-461) ----
    neg1 = torch.full((N,), -1, dtype=torch.int32, device=dev)
    if has_areas:
        main_bus = torch.where(
            has_area & (a_override_bus >= 0), a_override_bus, params.bus_index
        )
        rev_idx = torch.where(has_any & use_reverb, a_reverb_bus, neg1)
    else:
        main_bus = params.bus_index
        rev_idx = neg1
    S = MAX_BUSES_PER_PLAYBACK
    bus_index = torch.cat(
        [
            torch.stack([torch.where(has_any, main_bus, neg1), rev_idx], dim=1),
            torch.full((N, S - 2), -1, dtype=torch.int32, device=dev),
        ],
        dim=1,
    ).to(torch.int32)
    bus_volumes = torch.cat(
        [
            torch.stack([output_volume, reverb_volume], dim=1),
            torch.zeros((N, S - 2) + tuple(output_volume.shape[1:]), dtype=f32, device=dev),
        ],
        dim=1,
    )

    # ---- update flag + hysteresis (cpp:466-471) ----
    skip = (~has_any) & was_out_of_range
    update = (~skip) & scene.source_active

    return SpatializeResult(
        mix_volumes=output_volume,
        pitch_scale=pitch,
        linear_attenuation=linear_attenuation,
        attenuation_filter_cutoff_hz=params.attenuation_filter_cutoff_hz,
        bus_index=bus_index,
        bus_volumes=bus_volumes,
        update_parameters=update,
        was_out_of_range=~has_any,
    )
