"""Parity of the port's resampler (godot_audio_spatializer_torch.ops.resample
and its kernel's plain twin) with the JAX package, on the CPU.

Inputs are made with NumPy from a seed and handed to both sides.
Tolerances: cursors, fixed-point positions and mixed counts are integer
and must be equal; frames ≤ 1e-6 against the XLA gather (the same f32
lerp expression) and ≤ 2e-5 against the Pallas kernel in interpret mode
(its bf16 hi/lo split dot, the bound tests/test_planar.py uses).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from godot_audio_spatializer_torch.ops import resample as rt  # noqa: E402
from godot_audio_spatializer_torch.ops.kernels import resample as rkt  # noqa: E402
from godot_audio_spatializer_tpu.ops import resample as rj  # noqa: E402
from godot_audio_spatializer_tpu.ops.pallas.resample_kernel import (  # noqa: E402
    resample_block_kernel as jax_resample_kernel,
)

F = 128
MAX_PITCH = 2.0



def _clips(rng):
    return [
        ((rng.standard_normal((3000, 2)) * 0.5).astype(np.float32), True),
        ((rng.standard_normal((700, 2)) * 0.5).astype(np.float32), False),
        ((rng.standard_normal((1500, 2)) * 0.5).astype(np.float32), True, 400),
        (rng.standard_normal(260).astype(np.float32), False),  # mono
    ]


@pytest.mark.parametrize("align", [128, 512])
def test_build_bank_equal(align):
    rng = np.random.default_rng(0)
    clips = _clips(rng)
    bank_t, bases_t = rt.build_bank(clips, F, MAX_PITCH, align=align)
    bank_j, bases_j = rj.build_bank(clips, F, MAX_PITCH, align=align)
    assert bases_t == bases_j
    np.testing.assert_array_equal(bank_t, bank_j)
    assert rt.window_rows(512, 1.4) == rj.window_rows(512, 1.4)
    assert rt.margin_samples(512, 1.4) == rj.margin_samples(512, 1.4)


def _lanes(n, seed, unit=False):
    """Seeded per-source lanes over the `_clips` bank: some streams end
    inside the block, looping ones wrap (with a loop_begin region)."""
    rng = np.random.default_rng(seed)
    clips = _clips(rng)
    bank, bases = rj.build_bank(clips, F, MAX_PITCH)
    pick = rng.integers(0, len(clips), n)
    lengths = np.array([np.asarray(clips[i][0]).shape[0] for i in pick], np.int32)
    if unit:
        cursor = (rng.integers(0, 4, n) * 128).astype(np.int32)
        frac = np.zeros(n, np.int32)
        pitch = np.full(n, rj.FP_LEN, np.int32)
    else:
        cursor = np.minimum(rng.integers(0, 3000, n), lengths - 1).astype(np.int32)
        frac = rng.integers(0, rj.FP_LEN, n).astype(np.int32)
        pitch = np.round((0.3 + 1.9 * rng.random(n)) * rj.FP_LEN).astype(np.int32)
    return dict(
        bank=bank,
        base=np.array([bases[i] for i in pick], np.int32),
        length=lengths,
        loop=np.array([clips[i][1] for i in pick]),
        cursor_idx=cursor,
        cursor_frac=frac,
        pitch_fp=pitch,
        loop_begin=np.array(
            [clips[i][2] if len(clips[i]) > 2 else 0 for i in pick], np.int32
        ),
    )


def _as(lanes, mod):
    if mod is jnp:
        return {k: jnp.asarray(v) for k, v in lanes.items()}
    return {k: torch.as_tensor(v) for k, v in lanes.items()}


@pytest.mark.parametrize("unit", [True, False], ids=["unit_pitch", "general"])
def test_resample_block_plain_matches_jax(unit):
    """The plain gather vs JAX's XLA path, N = 13, one block: cursors and
    mixed counts equal, frames ≤ 1e-6."""
    lanes = _lanes(13, seed=3, unit=unit)
    lj, lt = _as(lanes, jnp), _as(lanes, torch)

    def args(d):
        return (d["bank"], d["base"], d["length"], d["loop"], d["cursor_idx"],
                d["cursor_frac"], d["pitch_fp"], F)

    kw = dict(max_pitch=MAX_PITCH, unit_pitch_aligned=unit)
    fj, mj, ij, qj = rj.resample_block(*args(lj), loop_begin=lj["loop_begin"],
                                       gather_method="xla", **kw)
    ft, mt, it, qt = rt.resample_block(*args(lt), loop_begin=lt["loop_begin"],
                                       gather_method="plain", **kw)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    if not unit:
        pj, fracj = rj._positions(lj["cursor_idx"], lj["cursor_frac"], lj["pitch_fp"], F)
        pt, fract = rt._positions(lt["cursor_idx"], lt["cursor_frac"], lt["pitch_fp"], F)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(fract.numpy(), np.asarray(fracj))
        assert (mt < F).any(), "the scene must hold a stream that ends"


@pytest.mark.parametrize("raw", [False, True], ids=["interleaved", "raw_planar"])
def test_kernel_plain_twin_matches_jax_kernel(raw):
    """The CUDA resampler's plain twin vs the Pallas resample_block_kernel
    in interpret mode (N = 64): mixed counts equal, frames ≤ 2e-5."""
    lanes = _lanes(64, seed=5)
    pitch = np.minimum(lanes["pitch_fp"], round(MAX_PITCH * rj.FP_LEN)).astype(np.int32)
    lj, lt = _as(lanes, jnp), _as(lanes, torch)
    bank_t = lj["bank"].reshape(-1, 128, 2).transpose(0, 2, 1)
    yj, mj = jax_resample_kernel(
        bank_t, lj["base"], lj["length"], lj["loop"], lj["cursor_idx"],
        lj["cursor_frac"], jnp.asarray(pitch), F, MAX_PITCH, interpret=True, raw=raw,
    )
    yt, mt = rkt.resample_block_kernel(
        lt["bank"], lt["base"], lt["length"], lt["loop"], lt["cursor_idx"],
        lt["cursor_frac"], torch.as_tensor(pitch), F, rt.window_rows(F, MAX_PITCH), raw=raw,
    )
    yj = np.asarray(yj)
    if not raw:
        yj = np.moveaxis(yj, 1, 2)  # JAX returns [N, 2, F]
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj)[:64])
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=2e-5)


def test_planar_layout_pads_to_1024():
    """resample_block(layout="planar"): Np = 1024 pad lanes at unit pitch,
    length 1; the first N lanes equal the interleaved read (N = 13)."""
    lanes = _as(_lanes(13, seed=7), torch)
    args = (lanes["bank"], lanes["base"], lanes["length"], lanes["loop"],
            lanes["cursor_idx"], lanes["cursor_frac"], lanes["pitch_fp"], F)
    y, mp, ip, qp = rt.resample_block(*args, max_pitch=MAX_PITCH, gather_method="kernel",
                                      layout="planar")
    f, m, i, q = rt.resample_block(*args, max_pitch=MAX_PITCH, gather_method="kernel")
    assert tuple(y.shape) == (2, 1, 1024, 128) and tuple(mp.shape) == (1024,)
    np.testing.assert_array_equal(mp[:13].numpy(), m.numpy())
    np.testing.assert_array_equal(mp[13:].numpy(), np.ones(1024 - 13, np.int32))
    np.testing.assert_array_equal(rkt.to_raw(f).numpy(), y[:, :, :13].numpy())
    assert torch.equal(ip, i) and torch.equal(qp, q)


def test_quantize_pitch_round_half_even():
    """Round-half-even of the f32 product, as JAX quantizes."""
    p = np.array([1.0, 0.5 + 0.5 / rj.FP_LEN, 1.5 / rj.FP_LEN, 2.5 / rj.FP_LEN,
                  1.3049999, 0.77777], np.float32)
    np.testing.assert_array_equal(
        rt.quantize_pitch(torch.as_tensor(p)).numpy(), np.asarray(rj.quantize_pitch(jnp.asarray(p)))
    )
