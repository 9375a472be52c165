"""The port's CUDA kernels against their plain PyTorch twins, on a card.

These need a CUDA card and skip without one.  They import neither JAX
nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Inputs are made with NumPy from a seed: streams that end inside the
block, mixed pitches, bypass and masked lanes.  Tolerances: mixed counts
equal and frames ≤ 1e-6 for the resampler (the same f32 lerp, no FMA
contraction); ≤ 1e-5 for the mode-A frame path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from godot_audio_spatializer_torch.ops.biquad import highshelf_coeffs  # noqa: E402
from godot_audio_spatializer_torch.ops.kernels import LAUNCHES, reset_launches  # noqa: E402
from godot_audio_spatializer_torch.ops.kernels import mix_mode_a as mk  # noqa: E402
from godot_audio_spatializer_torch.ops.kernels import resample as rk  # noqa: E402
from godot_audio_spatializer_torch.ops.resample import FP_LEN, build_bank, window_rows  # noqa: E402

pytestmark = pytest.mark.gpu

N, F = 2048, 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_kernels_gpu.py")
    return torch.device("cuda")


def _resample_args(dev, seed=3):
    rng = np.random.default_rng(seed)
    clips = [((rng.standard_normal((5000, 2)) * 0.3).astype(np.float32), i % 2 == 0)
             for i in range(4)]
    bank, bases = build_bank(clips, F, 2.0)
    pick = rng.integers(0, 4, N)
    loop = np.array([clips[i][1] for i in pick])
    cursor = np.where(loop, rng.integers(0, 5000, N), 5000 - rng.integers(0, 3 * F, N))
    pitch = np.round((0.3 + 1.7 * rng.random(N)) * FP_LEN)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt), device=dev)  # noqa: E731
    return (t(bank), t([bases[i] for i in pick], np.int32), t(np.full(N, 5000), np.int32),
            t(loop), t(cursor, np.int32), t(rng.integers(0, FP_LEN, N), np.int32),
            t(pitch, np.int32), F, window_rows(F, 2.0))


@pytest.mark.parametrize("raw", [False, True], ids=["interleaved", "raw_planar"])
def test_resample_kernel_matches_plain(dev, raw):
    args = _resample_args(dev)
    reset_launches()
    yk, mk_ = rk.resample_block_kernel(*args, raw=raw)
    assert LAUNCHES["resample_block_kernel"] == 1
    yp, mp = rk.resample_block_plain(*args, raw=raw)
    torch.cuda.synchronize()
    assert torch.equal(mk_, mp)
    assert (mp < F).any()
    assert float((yk - yp).abs().max()) <= 1e-6


@pytest.mark.parametrize("planar", [False, True], ids=["fused_mode_a", "fused_mode_a_planar"])
def test_mix_kernel_matches_plain(dev, planar):
    rng = np.random.default_rng(7)
    args = _resample_args(dev)
    frames, mixed = rk.resample_block_kernel(*args)
    gain = np.where(rng.random(N) < 0.3, 0.0, 0.05 + rng.random(N)).astype(np.float32)
    cut = torch.as_tensor((2000.0 + 8000.0 * rng.random(N)).astype(np.float32), device=dev)
    rest = (
        torch.as_tensor((rng.standard_normal((N, 64, 2)) * 0.3).astype(np.float32), device=dev),
        highshelf_coeffs(48000.0, cut, torch.as_tensor(np.clip(gain * 1.3, 0, 1.2), device=dev)),
        highshelf_coeffs(48000.0, cut, torch.as_tensor(gain, device=dev)),
        torch.as_tensor((rng.standard_normal((N, 2, 4)) * 0.1).astype(np.float32), device=dev),
        mixed,
        torch.as_tensor(rng.random(N) < 0.9, device=dev),
        torch.as_tensor(gain >= 0.001, device=dev),
    )
    x = rk.to_raw(frames) if planar else frames
    fn = mk.fused_mode_a_planar if planar else mk.fused_mode_a
    reset_launches()
    got = fn(x, *rest, F)
    assert LAUNCHES[fn.__name__] == 1
    want = fn(x.cpu(), *[a.cpu() for a in rest], F)
    for name, a, b in zip(("sig", "lookahead", "state", "coeffs", "peak"), got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-5, name


def test_wrappers_reject_bad_inputs(dev):
    args = list(_resample_args(dev))
    args[4] = args[4].to(torch.int64)  # cursor_idx must be int32
    with pytest.raises(ValueError, match="cursor_idx"):
        rk.resample_block_kernel(*args)
