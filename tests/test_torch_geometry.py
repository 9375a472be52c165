"""Parity of the port's Stage A (``calculate_spatialization``) with the
JAX package on random scenes, on the CPU: no areas and each of the five
area shapes (box axis-aligned and rotated, sphere, capsule, cylinder,
convex hull), 1 and 3 listeners, doppler on and off.

Tolerance: f32 fields at rtol 1e-5 (atol 1e-6 for values near zero —
the same f32 expressions, contractions summed in another order); bus
routing, update and out-of-range flags equal; the 16-bit fixed-point
pitch equal (a one-step flip would move every later cursor).

Listeners stay outside every area.  For a listener inside a uniform
reverb area the closest point is the listener itself, and the reverb pan
direction is the direction of a ~1e-7 round-off vector on both sides
(ROADMAP Queue 3), so no tolerance holds there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from godot_audio_spatializer_torch.engine import scene as sct  # noqa: E402
from godot_audio_spatializer_torch.ops import geometry as gt  # noqa: E402
from godot_audio_spatializer_torch.ops.resample import quantize_pitch as qt  # noqa: E402
from godot_audio_spatializer_tpu.constants import SpeakerMode  # noqa: E402
from godot_audio_spatializer_tpu.engine import scene as scj  # noqa: E402
from godot_audio_spatializer_tpu.ops import geometry as gj  # noqa: E402
from godot_audio_spatializer_tpu.ops.resample import quantize_pitch as qj  # noqa: E402

N = 48
BUSES = {"Master": 0, "Ambient": 1, "Reverb": 2}
SHAPES = ["none", "box", "rotated_box", "sphere", "capsule", "cylinder", "convex"]
LISTENERS = [(1, True), (3, True), (3, False)]  # (listeners, doppler)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _areas(rng, shape, mod):
    if shape == "none":
        return []
    out = []
    for i in range(3):
        kw = dict(shape=shape)
        if shape == "rotated_box":
            kw = dict(shape="box", basis=_rot(rng))
        elif shape == "convex":
            kw["points"] = rng.uniform(-3, 3, (10, 3))
            kw["basis"] = _rot(rng)
        elif shape in ("capsule", "cylinder"):
            kw["basis"] = _rot(rng)
        out.append(mod.AreaDesc(
            # every area lies within 12.2 m of the origin, listeners beyond 13 m
            center=rng.uniform(-4, 4, 3), half_extents=rng.uniform(1, 3, 3),
            mask=1 if i else 3,
            override_bus="Ambient" if i % 2 else None, reverb_bus="Reverb",
            reverb_amount=float(rng.uniform(0.2, 1)),
            reverb_uniformity=float(rng.uniform(0, 1)) if i < 2 else 0.0, **kw,
        ))
    return out


def _scene(seed, shape, n_listeners, doppler):
    """Matched (JAX, port) scene, params and carried out-of-range flags."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_listeners, 3))
    origins = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * rng.uniform(13, 16, (n_listeners, 1))
    lis = [dict(basis=_rot(rng), origin=origins[i],
                velocity=rng.uniform(-30, 30, 3) if doppler else np.zeros(3))
           for i in range(n_listeners)]
    area_rng = np.random.default_rng(seed + 1000)
    areas_j = _areas(area_rng, shape, scj)
    areas_t = _areas(np.random.default_rng(seed + 1000), shape, sct)
    pos = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    vel = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
    z = rng.normal(size=(N, 3)).astype(np.float32)
    active = rng.random(N) < 0.9
    sj = scj.build_scene_state(pos, [scj.ListenerDesc(**d) for d in lis], areas_j, BUSES,
                               vel, z, active)
    st = sct.build_scene_state(pos, [sct.ListenerDesc(**d) for d in lis], areas_t, BUSES,
                               vel, z, active, device="cpu")
    vol_db = rng.uniform(-12, 6, N).astype(np.float32)
    p = dict(
        attenuation_model=rng.integers(0, 4, N).astype(np.int32),
        unit_size=rng.uniform(2, 12, N).astype(np.float32),
        max_distance=np.where(rng.random(N) < 0.4, rng.uniform(14, 30, N), 0).astype(np.float32),
        panning_strength=rng.uniform(0, 1.5, N).astype(np.float32),
        area_mask=rng.integers(1, 4, N).astype(np.int32),
        emission_angle_enabled=rng.random(N) < 0.5,
        emission_angle_filter_attenuation_db=rng.uniform(-20, 0, N).astype(np.float32),
        doppler_enabled=np.full(N, doppler) & (rng.random(N) < 0.8),
        volume_db=vol_db,
        volume_linear=scj.db_to_linear_host(vol_db).astype(np.float32),
        pitch_scale=rng.uniform(0.7, 1.3, N).astype(np.float32),
    )
    pj = scj.default_source_params(N).replace(**p)
    pt = sct.default_source_params(N, device="cpu").replace(
        **{k: torch.as_tensor(v) for k, v in p.items()})
    was_out = rng.random(N) < 0.3
    return (sj, pj, np.asarray(was_out)), (st, pt, torch.as_tensor(was_out))


def _compare(rj, rt):
    for f in dataclasses.fields(rt):
        a = getattr(rt, f.name).numpy()
        b = np.asarray(getattr(rj, f.name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(qt(rt.pitch_scale).numpy(), np.asarray(qj(rj.pitch_scale)))


@pytest.mark.parametrize("listeners,doppler", LISTENERS, ids=["1L_doppler", "3L_doppler", "3L_static"])
@pytest.mark.parametrize("shape", SHAPES)
def test_calculate_spatialization_matches_jax(shape, listeners, doppler):
    seed = SHAPES.index(shape) * 10 + listeners + int(doppler)
    mode = SpeakerMode.SURROUND_71 if seed % 2 else SpeakerMode.STEREO
    (sj, pj, wj), (st, pt, wt) = _scene(seed, shape, listeners, doppler)
    for f in dataclasses.fields(st):  # the packers build the same arrays
        np.testing.assert_array_equal(getattr(st, f.name).numpy(), np.asarray(getattr(sj, f.name)),
                                      err_msg=f.name)
    rj = gj.calculate_spatialization(sj, pj, wj, mode, 0.8)
    rt = gt.calculate_spatialization(st, pt, wt, mode, 0.8)
    _compare(rj, rt)
    if shape != "none":
        assert (np.asarray(rj.bus_index)[:, 1] >= 0).any(), "some source must hit a reverb area"


def test_static_eliders_value_identical():
    """has_areas=False / any_doppler=False on a scene with neither give
    the same values as the full program (NaN where SPCAP pans a source
    straight behind the head, as the reference does)."""
    (_, _, _), (st, pt, wt) = _scene(3, "none", 1, False)
    full = gt.calculate_spatialization(st, pt, wt, SpeakerMode.SURROUND_51)
    lean = gt.calculate_spatialization(st, pt, wt, SpeakerMode.SURROUND_51,
                                       has_areas=False, any_doppler=False)
    for f in dataclasses.fields(full):
        torch.testing.assert_close(getattr(lean, f.name), getattr(full, f.name),
                                   rtol=0, atol=0, equal_nan=True, msg=f.name)
