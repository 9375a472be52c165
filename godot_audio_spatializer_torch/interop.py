"""State carried across from the JAX package.

Each converter takes the leaves of one JAX-package container as a
mapping of field name → array (NumPy, or anything ``np.asarray`` takes)
and builds the port's container on `device`, bit for bit.
``leaves(obj)`` makes such a mapping from any dataclass (the JAX
package's ``flax.struct`` containers are dataclasses), so this module
needs neither ``jax`` nor the JAX package::

    state_t = mix_state(leaves(jax_state), device="cuda")
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .engine.offline import SlotConfig
from .ops.geometry import SceneState, SourceParams
from .ops.mix import MixState, SampleBank
from .utils.device import resolve_device


def leaves(obj) -> dict:
    """{field name: np.asarray(value)} of a dataclass instance; None and
    empty tuples pass through as they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, tuple) else np.asarray(v)
    return out


def _convert(cls, data: Mapping[str, Any], device):
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__}: missing field {f.name!r}")
            continue
        v = data[f.name]
        kwargs[f.name] = None if v is None else torch.as_tensor(np.array(v), device=dev)
    extra = set(data) - {f.name for f in dataclasses.fields(cls)}
    for name in sorted(extra):
        v = data[name]
        if not (v is None or (isinstance(v, tuple) and not v)):
            raise NotImplementedError(
                f"{cls.__name__}.{name} is set but the port does not carry it yet "
                "(effect chains and mode B: ROADMAP Queue 1, items 8-9)"
            )
    return cls(**kwargs)


def mix_state(data: Mapping[str, Any], device=None) -> MixState:
    return _convert(MixState, data, device)


def sample_bank(data: Mapping[str, Any], device=None) -> SampleBank:
    return _convert(SampleBank, data, device)


def scene_state(data: Mapping[str, Any], device=None) -> SceneState:
    return _convert(SceneState, data, device)


def source_params(data: Mapping[str, Any], device=None) -> SourceParams:
    return _convert(SourceParams, data, device)


def slot_config(data: Mapping[str, Any], device=None) -> SlotConfig:
    return _convert(SlotConfig, data, device)
