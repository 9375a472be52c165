"""Host-side scene description → device tensors (PyTorch port of
engine/scene.py).

Listener-transform orthonormalization and inversion are O(L) float64
host work (the reference does them per physics tick on the CPU,
audio_spatializer_3d.cpp:342,352); the O(N·L) geometry runs on the
device in ops.geometry.  The packers are NumPy, identical to the JAX
package's; only the containers differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.geometry import SceneState, SourceParams
from ..utils.device import resolve_device


def orthonormalize_basis(basis: np.ndarray) -> np.ndarray:
    """Godot Basis::orthonormalize — Gram-Schmidt on columns x, y, z."""
    b = np.asarray(basis, np.float64)
    x, y, z = b[:, 0], b[:, 1], b[:, 2]
    x = x / np.linalg.norm(x)
    y = y - x * float(x @ y)
    y = y / np.linalg.norm(y)
    z = z - x * float(x @ z) - y * float(y @ z)
    z = z / np.linalg.norm(z)
    return np.stack([x, y, z], axis=1)


@dataclass
class ListenerDesc:
    """A camera/AudioListener3D stand-in (viewport audio listener)."""

    basis: np.ndarray = field(default_factory=lambda: np.eye(3))
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3))
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class AreaDesc:
    """Area3D for bus override / reverb routing.

    shape: "box" (oriented when `basis` is set), "sphere" (radius =
    half_extents[0]), "capsule" (radius = half_extents[0], total
    half-height incl. caps = half_extents[1], axis = local Y),
    "cylinder" (radius = half_extents[0], half-height = half_extents[1])
    or "convex" (`points` [K,3] in the area's local frame; the hull is
    computed at pack time)."""

    center: np.ndarray
    half_extents: np.ndarray
    mask: int = 1
    override_bus: Optional[str] = None
    reverb_bus: Optional[str] = None
    reverb_amount: float = 0.0
    reverb_uniformity: float = 0.0
    shape: str = "box"
    basis: Optional[np.ndarray] = None  # [3,3] local axes as columns
    points: Optional[np.ndarray] = None  # [K,3] local points (convex only)


def convex_hull_data(points: np.ndarray):
    """(planes [P,4], edges [E,2,3]) of the convex hull of local `points`:
    unit-normal half-spaces n·x ≤ d and the hull's unique vertex-pair
    segments."""
    from scipy.spatial import ConvexHull, QhullError

    if points is None:
        raise ValueError('shape="convex" areas need `points` ([K,3] local)')
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] < 4:
        raise ValueError("convex area needs `points` of shape [K>=4, 3]")
    try:
        hull = ConvexHull(pts)
    except QhullError as e:
        raise ValueError(
            "convex area points are degenerate (coplanar/collinear) — the "
            "hull must enclose a volume"
        ) from e
    eqs = hull.equations  # n·x + b <= 0, |n| = 1
    planes = np.concatenate([eqs[:, :3], -eqs[:, 3:4]], axis=1)
    edge_set = set()
    for simplex in hull.simplices:
        k = len(simplex)
        for i in range(k):
            a, b = int(simplex[i]), int(simplex[(i + 1) % k])
            edge_set.add((min(a, b), max(a, b)))
    edges = np.stack([np.stack([pts[a], pts[b]]) for a, b in sorted(edge_set)])
    return planes, edges


def pack_listeners(listeners: Sequence[ListenerDesc], pad_to: Optional[int] = None):
    """→ dict of NumPy arrays for the SceneState listener fields."""
    L = max(len(listeners), 1)
    if pad_to is not None:
        L = max(L, pad_to)
    rot = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    inv = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    origin = np.zeros((L, 3), np.float32)
    vel = np.zeros((L, 3), np.float32)
    active = np.zeros((L,), bool)
    for i, l in enumerate(listeners):
        rot[i] = orthonormalize_basis(l.basis).astype(np.float32)
        inv[i] = np.linalg.inv(np.asarray(l.basis, np.float64)).astype(np.float32)
        origin[i] = np.asarray(l.origin, np.float32)
        vel[i] = np.asarray(l.velocity, np.float32)
        active[i] = True
    return dict(
        listener_rot=rot,
        listener_inv=inv,
        listener_origin=origin,
        listener_vel=vel,
        listener_active=active,
    )


def pack_areas(areas: Sequence[AreaDesc], bus_name_to_index: Dict[str, int],
               pad_to: Optional[int] = None):
    """→ dict of NumPy arrays for the SceneState area fields."""
    A = max(len(areas), 1)
    if pad_to is not None:
        A = max(A, pad_to)
    center = np.zeros((A, 3), np.float32)
    half = np.zeros((A, 3), np.float32)
    shape = np.zeros((A,), np.int32)
    rot = np.tile(np.eye(3, dtype=np.float32), (A, 1, 1))
    mask = np.zeros((A,), np.int32)
    override_bus = np.full((A,), -1, np.int32)
    reverb_bus = np.full((A,), -1, np.int32)
    amount = np.zeros((A,), np.float32)
    uniformity = np.zeros((A,), np.float32)
    active = np.zeros((A,), bool)
    hulls = {}  # area index -> (planes [P,4], edges [E,2,3])
    for i, a in enumerate(areas):
        center[i] = np.asarray(a.center, np.float32)
        half[i] = np.asarray(a.half_extents, np.float32)
        if a.shape == "sphere":
            shape[i] = 1
        elif a.shape == "capsule":
            shape[i] = 2
            # the device tests against the core segment: total half-height
            # minus the cap radius
            half[i, 1] = max(float(a.half_extents[1]) - float(a.half_extents[0]), 0.0)
        elif a.shape == "cylinder":
            shape[i] = 3
        elif a.shape == "convex":
            shape[i] = 4
            h = a.__dict__.get("_hull_cache")  # `points` is immutable once packed
            if h is None:
                h = convex_hull_data(a.points)
                a.__dict__["_hull_cache"] = h
            hulls[i] = h
        elif a.shape != "box":
            raise ValueError(f"unknown area shape {a.shape!r}")
        if a.basis is not None:
            # world→local = basisᵀ for orthonormal columns
            rot[i] = orthonormalize_basis(np.asarray(a.basis, np.float64)).T.astype(np.float32)
        mask[i] = a.mask
        if a.override_bus is not None:
            override_bus[i] = bus_name_to_index[a.override_bus]
        if a.reverb_bus is not None:
            reverb_bus[i] = bus_name_to_index[a.reverb_bus]
        amount[i] = a.reverb_amount
        uniformity[i] = a.reverb_uniformity
        active[i] = True
    # Convex lanes padded to the scene-wide max plane/edge counts: other
    # rows carry an always-satisfied plane (n=0, d=1) and a point edge;
    # convex rows repeat their first plane/edge (a duplicate is exact).
    Pmax = max([1] + [h[0].shape[0] for h in hulls.values()])
    Emax = max([1] + [h[1].shape[0] for h in hulls.values()])
    planes = np.zeros((A, Pmax, 4), np.float32)
    planes[:, :, 3] = 1.0
    edges = np.zeros((A, Emax, 2, 3), np.float32)
    for i, (pl, ed) in hulls.items():
        planes[i] = np.concatenate([pl, np.repeat(pl[:1], Pmax - pl.shape[0], axis=0)])
        edges[i] = np.concatenate([ed, np.repeat(ed[:1], Emax - ed.shape[0], axis=0)])
    return dict(
        area_center=center,
        area_half=half,
        area_shape=shape,
        area_rot=rot,
        area_mask=mask,
        area_override_bus=override_bus,
        area_reverb_bus=reverb_bus,
        area_reverb_amount=amount,
        area_reverb_uniformity=uniformity,
        area_active=active,
        area_planes=planes,
        area_edges=edges,
    )


def db_to_linear_host(db) -> np.ndarray:
    """float64 host-side db→linear (feeds SourceParams.volume_linear)."""
    return np.exp(np.asarray(db, np.float64) * 0.11512925464970228420089957273422)


def _tensors(cls, arrays: dict, device):
    return cls(**{k: torch.as_tensor(np.asarray(v), device=device) for k, v in arrays.items()})


def default_source_params(n: int, num_buses_master_index: int = 0,
                          device=None) -> SourceParams:
    """SourceParams filled with the reference defaults
    (audio_spatializer_3d.cpp:807-825), on `device` (default: the CUDA
    card; raises when there is none)."""
    dev = resolve_device(device)
    return _tensors(SourceParams, dict(
        attenuation_model=np.zeros(n, np.int32),
        unit_size=np.full(n, 10.0, np.float32),
        max_distance=np.zeros(n, np.float32),
        panning_strength=np.ones(n, np.float32),
        area_mask=np.ones(n, np.int32),
        emission_angle_enabled=np.zeros(n, bool),
        emission_angle_cos=np.full(n, math.cos(math.radians(45.0)), np.float32),
        emission_angle_filter_attenuation_db=np.full(n, -12.0, np.float32),
        attenuation_filter_cutoff_hz=np.full(n, 5000.0, np.float32),
        attenuation_filter_db=np.full(n, -24.0, np.float32),
        doppler_enabled=np.zeros(n, bool),
        doppler_speed_of_sound=np.full(n, 343.0, np.float32),
        volume_db=np.zeros(n, np.float32),
        max_db=np.full(n, 3.0, np.float32),
        volume_linear=np.ones(n, np.float32),
        max_linear=np.full(n, db_to_linear_host(3.0), np.float32),
        pitch_scale=np.ones(n, np.float32),
        bus_index=np.full(n, num_buses_master_index, np.int32),
    ), dev)


def build_scene_state(
    source_pos: np.ndarray,
    listeners: Sequence[ListenerDesc],
    areas: Sequence[AreaDesc] = (),
    bus_name_to_index: Optional[Dict[str, int]] = None,
    source_vel: Optional[np.ndarray] = None,
    source_z_axis: Optional[np.ndarray] = None,
    source_active: Optional[np.ndarray] = None,
    *,
    device=None,
) -> SceneState:
    """SceneState on `device` (default: the CUDA card; raises when there
    is none) from host arrays and descriptors."""
    dev = resolve_device(device)
    source_pos = np.asarray(source_pos, np.float32)
    n = source_pos.shape[0]
    if source_vel is None:
        source_vel = np.zeros((n, 3), np.float32)
    if source_z_axis is None:
        source_z_axis = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    if source_active is None:
        source_active = np.ones((n,), bool)
    return _tensors(SceneState, dict(
        source_pos=source_pos,
        source_vel=np.asarray(source_vel, np.float32),
        source_z_axis=np.asarray(source_z_axis, np.float32),
        source_active=np.asarray(source_active, bool),
        **pack_listeners(listeners),
        **pack_areas(areas, bus_name_to_index or {"Master": 0}),
    ), dev)
