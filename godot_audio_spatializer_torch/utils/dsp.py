"""PyTorch dsp helpers shared across ops (batched counterparts of the
golden scalars)."""

from __future__ import annotations

import torch

from ..constants import DB_TO_LINEAR_SCALE, LINEAR_TO_DB_SCALE


def linear_to_db(x):
    """Godot Math::linear_to_db: 20/ln(10) * ln(x)."""
    return torch.log(x) * LINEAR_TO_DB_SCALE


def db_to_linear(db):
    """Godot Math::db_to_linear: exp(db * ln(10)/20)."""
    return torch.exp(db * DB_TO_LINEAR_SCALE)


def norm3(v):
    """Euclidean norm over the last axis, sqrt(Σ v²) as jnp.linalg.norm
    computes it (no rescaling, so the f32 rounding is the same)."""
    return torch.sqrt((v * v).sum(dim=-1))


def safe_normalize(v, eps=0.0):
    """Normalize along the last axis; zero vectors stay zero (Godot
    normalize())."""
    n = norm3(v)[..., None]
    return torch.where(
        n > eps, v / torch.where(n > 0, n, torch.ones_like(n)), torch.zeros_like(v)
    )
