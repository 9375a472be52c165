"""Parity of the port's mode-A ``mix_block`` with the JAX package over
three chained blocks, on the CPU (N = 1024, F = 128, two buses, the
tests/test_planar.py scene: looping and one-shot clips, inactive and
bypass lanes, pitches 0.8-1.4).

Routes: planar (resampler raw layout → fused_mode_a_planar), split
(resampler → fused_mode_a), both against the Pallas kernels in
interpret mode, and plain against JAX's "scan"/"xla" path.
Tolerance: bus and peaks ≤ 2e-5 (f32 sums over 1024 sources in another
order); cursors, active and has_frames equal; the rest of the state
≤ 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from godot_audio_spatializer_torch.ops import mix as mt  # noqa: E402
from godot_audio_spatializer_tpu.ops import mix as mj  # noqa: E402
from godot_audio_spatializer_tpu.ops.resample import build_bank, quantize_pitch  # noqa: E402

F, B = 128, 2
ROUTES = {
    # route: (JAX knobs, port knobs)
    "planar": (dict(biquad_method="pallas", resample_gather="kernel", planar=True),
               dict(biquad_method="kernel", resample_gather="kernel", planar=True)),
    "split": (dict(biquad_method="pallas", resample_gather="kernel", planar=False),
              dict(biquad_method="kernel", resample_gather="kernel", planar=False)),
    "plain": (dict(biquad_method="scan", resample_gather="xla"),
              dict(biquad_method="plain", resample_gather="plain")),
}


def _scene(n=1024, seed=9):
    """NumPy leaves of (state, params, bank)."""
    rng = np.random.default_rng(seed)
    clips = [
        ((rng.standard_normal((4000, 2)) * 0.5).astype(np.float32), True),
        ((rng.standard_normal((700, 2)) * 0.5).astype(np.float32), False),
    ]
    bank_data, bases = build_bank(clips, F, 2.0)
    pick = rng.integers(0, 2, n)
    bank = dict(
        data=bank_data,
        base=np.array([bases[i] for i in pick], np.int32),
        length=np.array([clips[i][0].shape[0] for i in pick], np.int32),
        loop=np.array([clips[i][1] for i in pick]),
    )
    state = dict(
        active=rng.random(n) < 0.9,
        has_frames=np.ones(n, bool),
        cursor_idx=rng.integers(0, 400, n).astype(np.int32),
        lookahead=(rng.standard_normal((n, 64, 2)) * 0.1).astype(np.float32),
        srv_prev=(rng.random((n, B, 4, 2)) * 0.5).astype(np.float32),
        srv_target=(rng.random((n, B, 4, 2)) * 0.5).astype(np.float32),
    )
    vols = rng.random((n, 4, 2)).astype(np.float32)
    vols[: n // 8] = 0.0  # silent lanes: every channel ties in the argmax
    params = dict(
        mix_volumes=vols,
        pitch_fp=np.array(quantize_pitch(jnp.asarray(0.8 + 0.6 * rng.random(n).astype(np.float32)))),
        linear_attenuation=np.where(rng.random(n) < 0.3, 0.0, rng.random(n)).astype(np.float32),
        attenuation_filter_cutoff_hz=np.full(n, 5000.0, np.float32),
        mix_channel_mode=np.zeros(n, bool),
        threshold_db=np.full(n, -80.0, np.float32),
        paused=np.zeros(n, bool),
    )
    return state, params, bank


def _jax_side(state, params, bank):
    s = mj.make_mix_state(len(state["active"]), B).replace(**{k: jnp.asarray(v) for k, v in state.items()})
    return (s, mj.BlockParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            mj.SampleBank(**{k: jnp.asarray(v) for k, v in bank.items()}))


def _port_side(state, params, bank):
    s = mt.make_mix_state(len(state["active"]), B, device="cpu").replace(
        **{k: torch.as_tensor(v) for k, v in state.items()})
    return (s, mt.BlockParams(**{k: torch.as_tensor(v) for k, v in params.items()}),
            mt.SampleBank(**{k: torch.as_tensor(v) for k, v in bank.items()}))


def _run(mod, side, knobs, blocks=3):
    state, params, bank = side
    out = []
    for _ in range(blocks):
        state, bus, peak = mod.mix_block(
            state, params, bank, mix_rate=44100.0, frame_count=F, channel_count=4,
            max_pitch=2.0, **knobs)
        out.append((np.asarray(bus), np.asarray(peak)))
    return state, out


@pytest.mark.parametrize("route", list(ROUTES))
def test_mix_block_matches_jax(route):
    kj, kt = ROUTES[route]
    leaves = _scene()
    sj, outj = _run(mj, _jax_side(*leaves), kj)
    st, outt = _run(mt, _port_side(*leaves), kt)
    for b, ((bus_j, pk_j), (bus_t, pk_t)) in enumerate(zip(outj, outt)):
        np.testing.assert_allclose(bus_t, bus_j, rtol=0, atol=2e-5, err_msg=f"bus block {b}")
        np.testing.assert_allclose(pk_t, pk_j, rtol=0, atol=2e-5, err_msg=f"peak block {b}")
    for name in ("cursor_idx", "cursor_frac", "active", "has_frames"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=name)
    for name in ("lookahead", "prev_mix_volumes", "filter_coeffs", "filter_state",
                 "srv_prev", "srv_target"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert not np.asarray(sj.has_frames).all(), "a one-shot stream must end in the run"


def test_planar_gate_raises_where_jax_raises():
    """planar=True on a gated-off path (N % 1024 != 0) is a ValueError on
    both sides, never a silent fallback."""
    leaves = _scene(n=1000)
    kj, kt = ROUTES["planar"]
    with pytest.raises(ValueError):
        _run(mj, _jax_side(*leaves), kj, blocks=1)
    with pytest.raises(ValueError):
        _run(mt, _port_side(*leaves), kt, blocks=1)


@pytest.mark.parametrize("knobs", [
    dict(mix_channel_enabled=True),
    dict(fused_bus=True),
    dict(chain=("lowpass",)),
    dict(mc_chain=("custom",)),
    dict(doppler_wrow=256),
    dict(biquad_method="pallas"),
    dict(biquad_method="scan_df"),
    dict(biquad_method="assoc"),
], ids=["mode_b", "fused_bus", "chain", "mc_chain", "doppler_wrow", "pallas", "scan_df", "assoc"])
def test_unported_features_raise(knobs):
    side = _port_side(*_scene(n=64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(mt, side, dict(resample_gather="plain", **knobs), blocks=1)


def test_biquad_interp_block_matches_jax():
    """The "scan" highshelf with bypass lanes (gain < 0.001 passes x
    through; history and coefficients stay).  Coefficients ≤ 1e-6; y and
    state ≤ 5e-5: XLA's CPU code may contract the recurrence's products
    into FMAs where the port rounds each one, and the poles carry a
    one-ulp step difference through 128 frames of an O(1) signal."""
    from godot_audio_spatializer_torch.ops import biquad as bt
    from godot_audio_spatializer_tpu.ops import biquad as bj

    rng = np.random.default_rng(2)
    n = 64
    gain = np.where(rng.random(n) < 0.3, 0.0, rng.random(n)).astype(np.float32)
    cut = (500.0 + 15000.0 * rng.random(n)).astype(np.float32)
    x = (rng.standard_normal((n, F)) * 0.5).astype(np.float32)
    st = (rng.standard_normal((n, 4)) * 0.1).astype(np.float32)
    c0 = np.array(bj.highshelf_coeffs(44100.0, jnp.asarray(cut), jnp.asarray(gain * 0.7)))
    tj = bj.highshelf_coeffs(44100.0, jnp.asarray(cut), jnp.asarray(gain))
    tt = bt.highshelf_coeffs(44100.0, torch.as_tensor(cut), torch.as_tensor(gain))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-7)
    apply = gain >= 0.001
    outj = bj.biquad_interp_block(jnp.asarray(x), jnp.asarray(c0), tj, jnp.asarray(st),
                                  jnp.asarray(apply), method="scan")
    outt = bt.biquad_interp_block(torch.as_tensor(x), torch.as_tensor(c0), torch.as_tensor(np.array(tj)),
                                  torch.as_tensor(st), torch.as_tensor(apply), method="scan")
    for name, a, b, tol in zip(("y", "state", "coeffs"), outt, outj, (5e-5, 5e-5, 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol, err_msg=name)
    np.testing.assert_array_equal(outt[0].numpy()[~apply], x[~apply])
