"""Package rules of the PyTorch port: no JAX, explicit devices, pinned
f32 matmuls, a kernel build that fails loudly, and a chip smoke script
that refuses to run without a card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import pkgutil, importlib, sys
import godot_audio_spatializer_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "flax", "godot_audio_spatializer_tpu")))
print(len(names), bad)
assert not bad, bad
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_no_jax():
    out = _run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 15  # every module of the slice was imported


def test_precision_pinned():
    import godot_audio_spatializer_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _entry_points():
    from godot_audio_spatializer_torch.engine.offline import default_slot_config
    from godot_audio_spatializer_torch.engine.scene import (
        ListenerDesc, build_scene_state, default_source_params)
    from godot_audio_spatializer_torch.ops.mix import make_mix_state
    from godot_audio_spatializer_torch.utils.benchscene import build_bench_scene

    return {
        "build_bench_scene": lambda **kw: build_bench_scene(8, 2, 128, 48000.0, **kw),
        "make_mix_state": lambda **kw: make_mix_state(8, 1, **kw),
        "default_source_params": lambda **kw: default_source_params(8, **kw),
        "default_slot_config": lambda **kw: default_slot_config(8, **kw),
        "build_scene_state": lambda **kw: build_scene_state(
            np.zeros((8, 3), np.float32), [ListenerDesc()], **kw),
    }


@pytest.mark.parametrize("name", ["build_bench_scene", "make_mix_state", "default_source_params",
                                  "default_slot_config", "build_scene_state"])
def test_entry_points_need_a_card_or_explicit_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    out = fn(device="cpu")
    first = out[0] if isinstance(out, tuple) else out
    leaf = next(v for v in vars(first).values() if isinstance(v, torch.Tensor))
    assert leaf.device.type == "cpu"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from godot_audio_spatializer_torch.ops.kernels import build

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_cpu_tensors_take_the_plain_twins_without_counting():
    from godot_audio_spatializer_torch.ops.kernels import LAUNCHES, reset_launches
    from godot_audio_spatializer_torch.utils.benchscene import build_bench_scene
    from godot_audio_spatializer_torch.engine.offline import render_trajectory
    from godot_audio_spatializer_torch.constants import SpeakerMode

    reset_launches()
    args = build_bench_scene(16, 2, 128, 48000.0, device="cpu")
    _, _, master = render_trajectory(*args, speaker_mode=SpeakerMode.STEREO, mix_rate=48000.0,
                                     frame_count=128, max_pitch=1.4,
                                     biquad_method="kernel", resample_gather="kernel")
    assert bool(torch.isfinite(master).all())
    assert not any(LAUNCHES.values()), LAUNCHES


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: non-zero exit, no result line.  Alone in a directory
    (without the port beside it): the same."""
    out = _run([sys.executable, "chip_smoke.py"], cwd=ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout, out.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = _run([sys.executable, str(lone)], cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout, out.stdout
