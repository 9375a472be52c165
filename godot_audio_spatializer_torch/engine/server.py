"""Bus graph (PyTorch port of the ``bus_graph_reduce`` part of
engine/server.py).

The streaming ``AudioEngine`` is not ported yet (ROADMAP Queue 1,
item 6); the offline renderer needs only the bus reduction.
"""

from __future__ import annotations

import numpy as np

from ..constants import DB_TO_LINEAR_SCALE


def bus_graph_reduce(bus_in, sends, bus_volumes_db, effects, fx_states,
                     channel_count, bus_flags=None):
    """Apply per-bus faders, mute/solo and the send reduction → master.

    bus_in: [B,4,F,2].  Processing order newest→Master so sends flow
    downstream (L0 AudioServer behavior).  `bus_flags` = (mutes, solos,
    bypasses, fx_enabled) static tuples; None = everything audible.
    Per-bus effect chains are not ported: a non-empty chain raises.
    Returns (master [C,F,2], fx_states)."""
    if any(len(e) for e in effects):
        raise NotImplementedError(
            "bus effect chains are not ported yet: ROADMAP Queue 1, item 9 (effects)"
        )
    B = bus_in.shape[0]
    mutes, solos, _, _ = bus_flags or ((), (), (), ())
    any_solo = any(solos)
    bufs = [bus_in[b] for b in range(B)]
    for b in list(range(B - 1, 0, -1)) + [0]:
        # the fader gain as an f32 exp, computed on the host
        gain = float(np.exp(np.float32(bus_volumes_db[b] * DB_TO_LINEAR_SCALE)))
        buf = bufs[b] * gain
        # mute, and solo elsewhere, silence this bus's contribution (Master
        # stays audible unless itself muted — Godot semantics)
        audible = not (b < len(mutes) and mutes[b]) and (
            not any_solo or b == 0 or (b < len(solos) and solos[b])
        )
        if not audible:
            buf = buf * 0.0
        bufs[b] = buf
        if b != 0 and sends[b] >= 0:
            bufs[sends[b]] = bufs[sends[b]] + buf
    return bufs[0][:channel_count], tuple(tuple(s) for s in fx_states)
