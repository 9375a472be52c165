"""Parity of the port's offline renderer (``render_trajectory``) with the
JAX package on the bench scene, on the CPU: 7.1, 48 kHz, F = 128, four
blocks, doppler on, both sides started from identical bits through
``godot_audio_spatializer_torch.interop``.

The JAX side runs its "scan"/"xla" reference path; the port runs its
plain path, its kernels' plain twins on the split route, or (at
N = 1024) on the planar route.  Tolerance: master ≤ 1e-4 (the project's
−80 dBFS bar); final cursors and out-of-range flags equal; Stage A's
16-bit fixed-point pitch equal on every lane and tick (a failure names
the lanes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from godot_audio_spatializer_torch import interop  # noqa: E402
from godot_audio_spatializer_torch.engine import offline as ot  # noqa: E402
from godot_audio_spatializer_torch.ops.geometry import calculate_spatialization as cs_t  # noqa: E402
from godot_audio_spatializer_torch.ops.resample import quantize_pitch as q_t  # noqa: E402
from godot_audio_spatializer_torch.utils.benchscene import build_bench_scene as bench_t  # noqa: E402
from godot_audio_spatializer_tpu.constants import SpeakerMode  # noqa: E402
from godot_audio_spatializer_tpu.engine import offline as oj  # noqa: E402
from godot_audio_spatializer_tpu.ops.geometry import calculate_spatialization as cs_j  # noqa: E402
from godot_audio_spatializer_tpu.ops.resample import quantize_pitch as q_j  # noqa: E402
from godot_audio_spatializer_tpu.utils.benchscene import build_bench_scene as bench_j  # noqa: E402

F, K, RATE = 128, 4, 48000.0
MODE = SpeakerMode.SURROUND_71
CASES = {
    # id: (N, physics_every, port methods, radial velocity m/s)
    "n64_plain": (64, 1, "plain", 0.0),
    "n64_split_tick2": (64, 2, "kernel", 0.0),
    "n64_radial_auto_pitch": (64, 1, "kernel", 25.0),
    "n1024_planar": (1024, 1, "kernel", 0.0),
    "n1024_plain_tick2": (1024, 2, "plain", 0.0),
}


def _to_port(jargs):
    st, wo, sc, pos, vel, pa, sl, bk = jargs
    return (
        interop.mix_state(interop.leaves(st), "cpu"),
        torch.as_tensor(np.array(wo)),
        interop.scene_state(interop.leaves(sc), "cpu"),
        torch.as_tensor(np.array(pos)),
        torch.as_tensor(np.array(vel)),
        interop.source_params(interop.leaves(pa), "cpu"),
        interop.slot_config(interop.leaves(sl), "cpu"),
        interop.sample_bank(interop.leaves(bk), "cpu"),
    )


def _check_pitch(jargs, targs):
    """Stage A's quantized pitch, tick by tick, on both sides."""
    _, _, scj, posj, velj, paj, _, _ = jargs
    _, _, sct, post, velt, pat, _, _ = targs
    for k in range(K):
        rj = cs_j(scj.replace(source_pos=posj[k], source_vel=velj[k]), paj,
                  jnp.zeros(posj.shape[1], bool), MODE)
        rt = cs_t(sct.replace(source_pos=post[k], source_vel=velt[k]), pat,
                  torch.zeros(post.shape[1], dtype=torch.bool), MODE)
        pj = np.asarray(q_j(rj.pitch_scale))
        pt = q_t(rt.pitch_scale).numpy()
        bad = np.flatnonzero(pj != pt)
        assert bad.size == 0, (
            f"tick {k}: quantized pitch differs on lanes {bad.tolist()} "
            f"(JAX {pj[bad].tolist()} vs port {pt[bad].tolist()})")
    return pj


@pytest.mark.parametrize("case", list(CASES))
def test_render_trajectory_matches_jax(case):
    n, every, methods, radial = CASES[case]
    jargs = list(bench_j(n, K, F, RATE, doppler=True))
    if radial:
        pos = np.asarray(jargs[3])
        unit = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
        jargs[4] = jnp.asarray(np.asarray(jargs[4]) + radial * unit.astype(np.float32))
    jargs = tuple(jargs)
    targs = _to_port(jargs)
    pitch_fp = _check_pitch(jargs, targs)
    if radial:
        assert (pitch_fp != 1 << 16).any(), "the radial case must move the pitch off 1"
        max_pitch = "auto"
        assert ot.trajectory_pitch_bound(targs[2], targs[4], targs[5]) == \
            oj.trajectory_pitch_bound(jargs[2], jargs[4], jargs[5])
    else:
        max_pitch = 1.4
    kw = dict(speaker_mode=MODE, mix_rate=RATE, frame_count=F, physics_every=every,
              max_pitch=max_pitch)
    sj, wj, mj = oj.render_trajectory(*jargs, biquad_method="scan", resample_gather="xla", **kw)
    st, wt, mt = ot.render_trajectory(*targs, biquad_method=methods, resample_gather=methods, **kw)
    assert tuple(mt.shape) == (K, 4, F, 2)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-4, err_msg="master")
    for name in ("cursor_idx", "cursor_frac", "active", "has_frames"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_engine_step_matches_jax():
    """One physics tick + one block through ``engine_step`` (N = 64, the
    kernels' plain twins): master ≤ 1e-4, cursors and flags equal."""
    jargs = bench_j(64, 1, F, RATE, doppler=True)
    targs = _to_port(jargs)
    st, wo, sc, pos, vel, pa, sl, bk = jargs
    tst, two, tsc, tpos, tvel, tpa, tsl, tbk = targs
    kw = dict(speaker_mode=MODE, mix_rate=RATE, frame_count=F, max_pitch=1.4)
    sj, wj, mj, pj = oj.engine_step(st, wo, sc.replace(source_pos=pos[0], source_vel=vel[0]),
                                    pa, sl, bk, biquad_method="scan", resample_gather="xla", **kw)
    s_t, w_t, m_t, p_t = ot.engine_step(tst, two, tsc.replace(source_pos=tpos[0], source_vel=tvel[0]),
                                        tpa, tsl, tbk, biquad_method="kernel",
                                        resample_gather="kernel", **kw)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(mj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(s_t.cursor_idx.numpy(), np.asarray(sj.cursor_idx))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(wj))


def test_collect_master_false_is_running_power():
    targs = bench_t(64, K, F, RATE, device="cpu")
    kw = dict(speaker_mode=MODE, mix_rate=RATE, frame_count=F, max_pitch=1.4)
    _, _, master = ot.render_trajectory(*targs, **kw)
    _, _, power = ot.render_trajectory(*targs, collect_master=False, **kw)
    torch.testing.assert_close(power, (master * master).sum(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("flags", [
    None,
    ((False, True, False), (), (), ()),  # bus 1 muted
    ((), (False, False, True), (), ()),  # bus 2 soloed: bus 1 silent, Master stays
], ids=["plain", "mute", "solo"])
def test_bus_graph_reduce_matches_jax(flags):
    """Faders, sends (2 → 1 → Master), mute and solo on three buses:
    master ≤ 1e-6 (a handful of f32 adds and products)."""
    from godot_audio_spatializer_torch.engine.server import bus_graph_reduce as bgr_t
    from godot_audio_spatializer_tpu.engine.server import bus_graph_reduce as bgr_j

    bus_in = np.random.default_rng(4).standard_normal((3, 4, F, 2)).astype(np.float32)
    sends, vol_db, empty = (-1, 0, 1), (0.0, -6.0, 3.5), ((), (), ())
    mj, _ = bgr_j(jnp.asarray(bus_in), sends, vol_db, empty, empty, 3, flags)
    mt, _ = bgr_t(torch.as_tensor(bus_in), sends, vol_db, empty, empty, 3, flags)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bgr_t(torch.as_tensor(bus_in), sends, vol_db, ((), ("reverb",), ()), empty, 3)
