"""Parity of the port's fused mode-A frame path (the plain twin of
csrc/mix_mode_a.cu) with the JAX package's Pallas kernels in interpret
mode, on the CPU, at N = 1024, F = 128 (the size tests/test_planar.py
uses).  Inputs hold partial mixes (streams that end inside the block),
bypass lanes and masked lanes.

Tolerance: sig, state, lookahead and peak ≤ 1e-5 (the same f32
recurrence in the same operation order; the slack covers XLA's
contraction of the interpret-mode loop body).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from godot_audio_spatializer_torch.ops.biquad import highshelf_coeffs  # noqa: E402
from godot_audio_spatializer_torch.ops.kernels import mix_mode_a as mkt  # noqa: E402
from godot_audio_spatializer_torch.ops.kernels.resample import to_raw  # noqa: E402
from godot_audio_spatializer_tpu.ops.pallas import mix_kernel as mkj  # noqa: E402

N, F, LA = 1024, 128, 64
TOL = 1e-5


def _inputs(seed=21):
    rng = np.random.default_rng(seed)
    gain = np.where(rng.random(N) < 0.3, 0.0, 0.05 + rng.random(N)).astype(np.float32)
    cut = torch.as_tensor((2000.0 + 8000.0 * rng.random(N)).astype(np.float32))
    mixed = np.where(rng.random(N) < 0.25, rng.integers(0, F, N), F).astype(np.int32)
    return dict(
        frames=(rng.standard_normal((N, F, 2)) * 0.3).astype(np.float32),
        lookahead=(rng.standard_normal((N, LA, 2)) * 0.3).astype(np.float32),
        coeffs=highshelf_coeffs(44100.0, cut, torch.as_tensor(np.clip(gain * 1.4, 0, 1.1))).numpy(),
        target=highshelf_coeffs(44100.0, cut, torch.as_tensor(gain)).numpy(),
        state=(rng.standard_normal((N, 2, 4)) * 0.1).astype(np.float32),
        mixed=mixed,
        signal_mask=rng.random(N) < 0.85,
        apply_mask=gain >= 0.001,
    )


ORDER = ("lookahead", "coeffs", "target", "state", "mixed", "signal_mask", "apply_mask")
NAMES = ("sig", "lookahead", "state", "coeffs", "peak")


@pytest.mark.parametrize("planar", [False, True], ids=["fused_mode_a", "fused_mode_a_planar"])
def test_plain_twin_matches_jax_kernel(planar):
    d = _inputs()
    assert (d["mixed"] < F).any() and (~d["apply_mask"]).any() and (~d["signal_mask"]).any()
    if planar:
        xj = np.asarray(to_raw(torch.as_tensor(d["frames"])))  # [2, F/128, N, 128]
        out_j = mkj.fused_mode_a_planar(jnp.asarray(xj), *[jnp.asarray(d[k]) for k in ORDER], F)
        out_t = mkt.fused_mode_a_planar(torch.as_tensor(xj), *[torch.as_tensor(d[k]) for k in ORDER], F)
    else:
        out_j = mkj.fused_mode_a(jnp.asarray(d["frames"]), *[jnp.asarray(d[k]) for k in ORDER], F)
        out_t = mkt.fused_mode_a(torch.as_tensor(d["frames"]), *[torch.as_tensor(d[k]) for k in ORDER], F)
    for name, a, b in zip(NAMES, out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=name)
    # bypass lanes keep their history and coefficients untouched
    byp = ~d["apply_mask"]
    np.testing.assert_array_equal(out_t[2].numpy()[byp], d["state"][byp])
    np.testing.assert_array_equal(out_t[3].numpy()[byp], d["coeffs"][byp])


def test_planar_wrapper_gates():
    d = _inputs()
    x = to_raw(torch.as_tensor(d["frames"][:1000]))
    with pytest.raises(ValueError):
        mkt.fused_mode_a_planar(x, *[torch.as_tensor(d[k][:1000]) for k in ORDER], F)
    with pytest.raises(NotImplementedError):
        mkt.fused_mode_a(torch.as_tensor(d["frames"]).to(torch.int16),
                         *[torch.as_tensor(d[k]) for k in ORDER], F)
