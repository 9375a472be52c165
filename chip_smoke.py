#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile every CUDA kernel from ``godot_audio_spatializer_torch/
   csrc`` (nvcc, one process per source, started together);
3. kernels: each kernel against its plain PyTorch twin on the card at
   the doppler slice's shapes (N = 4096 sources, F = 512 frames,
   max_pitch 1.4), with ending streams, bypass lanes and masked lanes;
   error and median time (CUDA events) of kernel and twin;
4. slice: ``render_trajectory`` on the 4096-source 7.1 48 kHz bench
   scene, K blocks, through (a) the planar doppler route, (b) the split
   route, (c) the unit-pitch non-doppler north star; launch counts show
   which kernels ran, (a) is held against (b) and against the whole
   plain PyTorch path; ms per block and real-time factor.  Then (d): the
   same scene with a radial velocity added, so the doppler pitch leaves
   1 and the kernels take their fractional-pitch reads, held against
   the plain path over RADIAL_BLOCKS blocks.

The line before the last lists every kernel with its launches (the sum
over the driven routes, and per route in ``launches_by_route``), error,
times and bound; the last line is the result object.  Imports nothing
of JAX.  Without a CUDA device, or without the port beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_SRC = 4096
FRAMES = 512
MIX_RATE = 48000.0
MAX_PITCH = 1.4
BLOCKS = 64
RADIAL_BLOCKS = 16
RADIAL_SPEED = 25.0  # m/s added along each source's line of sight
REPS = 20

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

TOL_RESAMPLE = 1e-6
TOL_MIX = 1e-5
TOL_ROUTES = 1e-5
TOL_PLAIN_PATH = 1e-4  # the project's -80 dBFS bar


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(tag: str, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def median_ms(fn, torch, reps=REPS, windows=5, warm=3):
    """Per-call time: the median over `windows` CUDA-event windows, each
    around `reps` back-to-back calls of fn(), after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_inputs(torch, np, dev):
    """Seeded inputs at the slice's shapes: looping and one-shot clips
    (some streams end inside the block), mixed pitches, masked and
    bypass lanes."""
    from godot_audio_spatializer_torch.ops.biquad import highshelf_coeffs
    from godot_audio_spatializer_torch.ops.resample import FP_LEN, build_bank, window_rows

    rng = np.random.default_rng(1234)
    n, F = N_SRC, FRAMES
    clips = [((rng.standard_normal((48000, 2)) * 0.2).astype(np.float32), i % 2 == 0)
             for i in range(8)]
    bank_np, bases = build_bank(clips, F, 2.0)
    pick = rng.integers(0, 8, n)
    length = np.array([clips[i][0].shape[0] for i in pick], np.int32)
    loop = np.array([clips[i][1] for i in pick])
    # one-shot lanes start near their end so a quarter of them run out
    cursor = np.where(loop, rng.integers(0, 48000, n),
                      48000 - rng.integers(0, 4 * F, n)).astype(np.int32)
    pitch = np.minimum(np.round((0.6 + 0.8 * rng.random(n)) * FP_LEN),
                       round(MAX_PITCH * FP_LEN)).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    rs = dict(
        bank=t(bank_np), base=t(np.array([bases[i] for i in pick], np.int32)),
        length=t(length), loop=t(loop), cursor_idx=t(cursor),
        cursor_frac=t(rng.integers(0, FP_LEN, n).astype(np.int32)), pitch_fp=t(pitch),
        frame_count=F, win_rows=window_rows(F, MAX_PITCH),
    )
    gain = np.where(rng.random(n) < 0.3, 0.0, 0.05 + rng.random(n)).astype(np.float32)
    cut = t((2000.0 + 8000.0 * rng.random(n)).astype(np.float32))
    mix = dict(
        lookahead=t((rng.standard_normal((n, 64, 2)) * 0.2).astype(np.float32)),
        coeffs=highshelf_coeffs(MIX_RATE, cut, t(np.clip(gain * 1.3, 0, 1.2))),
        target=highshelf_coeffs(MIX_RATE, cut, t(gain)),
        state=t((rng.standard_normal((n, 2, 4)) * 0.1).astype(np.float32)),
        signal_mask=t(rng.random(n) < 0.9),
        apply_mask=t(gain >= 0.001),
    )
    return rs, mix


def check_kernels(torch, np, dev):
    from godot_audio_spatializer_torch.ops.kernels import mix_mode_a as mk
    from godot_audio_spatializer_torch.ops.kernels import resample as rk

    rs, mix = kernel_inputs(torch, np, dev)
    F = FRAMES
    rows = []

    # ---- kernel 1: the resampler, both layouts; timed in the planar
    # (raw) layout that the default doppler route runs ----
    worst = 0.0
    for raw in (False, True):
        y_k, m_k = rk.resample_block_kernel(**rs, raw=raw)
        y_p, m_p = rk.resample_block_plain(**rs, raw=raw)
        torch.cuda.synchronize()
        if not torch.equal(m_k, m_p):
            fail(f"resample (raw={raw}): mixed counts differ on "
                 f"{int((m_k != m_p).sum())} sources")
        worst = max(worst, float((y_k - y_p).abs().max()))
    if worst > TOL_RESAMPLE:
        fail(f"resample: frames differ by {worst:.3e} > {TOL_RESAMPLE}")
    ended = int((m_k < F).sum())
    ms = median_ms(lambda: rk.resample_block_kernel(**rs, raw=True), torch)
    plain_ms = median_ms(lambda: rk.resample_block_plain(**rs, raw=True), torch)
    n_valid = int(m_k.sum())
    b_ms, b_by = bound(
        nbytes(rs["bank"], rs["base"], rs["length"], rs["loop"], rs["cursor_idx"],
               rs["cursor_frac"], rs["pitch_fp"], y_k, m_k),
        n_valid * 2 * 3.0,  # per mixed frame and channel: 2 products, 1 sum
    )
    phase("kernel", name="resample_block_kernel", max_abs_err=f"{worst:.3e}",
          ended_streams=ended, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{b_ms:.4f}")
    rows.append(dict(name="resample_block_kernel", route="cuda",
                     source="godot_audio_spatializer_torch/csrc/resample.cu",
                     replaces="godot_audio_spatializer_tpu/ops/pallas/resample_kernel.py:212",
                     max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))

    # ---- kernels 2 and 3: the fused mode-A frame path ----
    frames, mixed = rk.resample_block_kernel(**rs)
    frames_planar, mixed_p = rk.resample_block_kernel(**rs, raw=True)
    c0, inc = mk.precondition_coeffs(mix["coeffs"], mix["target"], mix["apply_mask"], F)
    for name, x, planar, line in (
        ("fused_mode_a", frames, False, 249),
        ("fused_mode_a_planar", frames_planar, True, 672),
    ):
        args = (mix["lookahead"], c0, inc, mix["state"], mixed, mix["signal_mask"], F)
        got = mk._launch(x, planar, *args)
        want = mk.mix_mode_a_plain(frames, *args)
        torch.cuda.synchronize()
        errs = {k: float((a - b).abs().max()) for k, a, b in zip(
            ("sig", "lookahead", "state", "coeffs", "peak"), got, want)}
        err = max(errs.values())
        if err > TOL_MIX:
            fail(f"{name}: kernel vs plain {errs} > {TOL_MIX}")
        # the public wrapper (bypass restore, max over ears) as mix_block calls it
        wrap = getattr(mk, name)(x, mix["lookahead"], mix["coeffs"], mix["target"],
                                 mix["state"], mixed_p if planar else mixed,
                                 mix["signal_mask"], mix["apply_mask"], F)
        if not bool(torch.isfinite(wrap[0]).all()):
            fail(f"{name}: non-finite signal")
        ms = median_ms(lambda: mk._launch(x, planar, *args), torch)
        plain_ms = median_ms(lambda: mk.mix_mode_a_plain(frames, *args), torch,
                             reps=5, windows=4, warm=1)
        lanes = 2 * N_SRC
        b_ms, b_by = bound(
            nbytes(x, *[a for a in args if isinstance(a, torch.Tensor)], *got),
            lanes * F * 22.0,  # per lane-frame: 5 affine coeffs, 5 products, 4 sums, mask, peak
        )
        phase("kernel", name=name, max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}")
        rows.append(dict(name=name, route="cuda",
                         source="godot_audio_spatializer_torch/csrc/mix_mode_a.cu",
                         replaces=f"godot_audio_spatializer_tpu/ops/pallas/mix_kernel.py:{line}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None))
    return rows


def run_slice(torch, np, dev):
    """The offline doppler renderer, four routes; returns launches per
    kernel and route, {kernel: {route: count}}, over the driven runs."""
    from godot_audio_spatializer_torch.constants import SpeakerMode
    from godot_audio_spatializer_torch.engine.offline import render_trajectory
    from godot_audio_spatializer_torch.ops.kernels import LAUNCHES, reset_launches
    from godot_audio_spatializer_torch.utils.benchscene import build_bench_scene

    common = dict(speaker_mode=SpeakerMode.SURROUND_71, mix_rate=MIX_RATE,
                  frame_count=FRAMES)
    doppler = build_bench_scene(N_SRC, BLOCKS, FRAMES, MIX_RATE, doppler=True, device=dev)
    unit = build_bench_scene(N_SRC, BLOCKS, FRAMES, MIX_RATE, doppler=False,
                             row_align=FRAMES, device=dev)
    variants = {
        "a_planar": (doppler, dict(max_pitch=MAX_PITCH),
                     {"resample_block_kernel", "fused_mode_a_planar"}),
        "b_split": (doppler, dict(max_pitch=MAX_PITCH, planar=False),
                    {"resample_block_kernel", "fused_mode_a"}),
        "c_unit_pitch": (unit, dict(unit_pitch_aligned=True, unit_row_width=FRAMES),
                         {"fused_mode_a"}),
    }
    by_route = {k: {} for k in LAUNCHES}
    results = {}
    for name, (scene, kw, expect) in variants.items():
        warm = (*scene[:3], scene[3][:2], scene[4][:2], *scene[5:])
        render_trajectory(*warm, **common, **kw)  # first-call set-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, _, master = render_trajectory(*scene, **common, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        ran = {k for k, v in counts.items() if v > 0}
        if ran != expect:
            fail(f"{name}: kernels launched {counts}, expected exactly {sorted(expect)}")
        if any(counts[k] != BLOCKS for k in expect):
            fail(f"{name}: expected {BLOCKS} launches of each of {sorted(expect)}, got {counts}")
        if tuple(master.shape) != (BLOCKS, 4, FRAMES, 2) or not bool(torch.isfinite(master).all()):
            fail(f"{name}: master {tuple(master.shape)} not finite / wrong shape")
        for k in expect:
            by_route[k][name] = counts[k]
        results[name] = (state, master)
        phase("slice", route=name, blocks=BLOCKS, ms_per_block=f"{secs / BLOCKS * 1e3:.4f}",
              rtf=f"{BLOCKS * FRAMES / MIX_RATE / secs:.3f}",
              master_rms=f"{float(master.pow(2).mean().sqrt()):.5f}",
              launches=json.dumps(counts, separators=(",", ":")))

    (sa, ma), (sb, mb) = results["a_planar"], results["b_split"]
    d_ab = float((ma - mb).abs().max())
    if d_ab > TOL_ROUTES:
        fail(f"planar vs split master differ by {d_ab:.3e} > {TOL_ROUTES}")
    reset_launches()
    t0 = time.perf_counter()
    sp, _, mp = render_trajectory(*doppler, **common, max_pitch=MAX_PITCH,
                                  biquad_method="plain", resample_gather="plain")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if any(LAUNCHES.values()):
        fail(f"plain path launched kernels: {LAUNCHES}")
    d_plain = float((ma - mp).abs().max())
    if d_plain > TOL_PLAIN_PATH:
        fail(f"kernel path vs plain path master differ by {d_plain:.3e} > {TOL_PLAIN_PATH}")
    for field in ("cursor_idx", "cursor_frac"):
        if not torch.equal(getattr(sa, field), getattr(sp, field)):
            fail(f"kernel path vs plain path: {field} differ")
    phase("slice", route="plain_reference", ms_per_block=f"{secs / BLOCKS * 1e3:.4f}",
          planar_vs_split=f"{d_ab:.3e}", kernel_vs_plain=f"{d_plain:.3e}", cursors="equal")

    # (d) radial motion: the pitch leaves 1, so the kernels read between
    # samples; the default (planar) kernel route against the plain path
    pos, vel = doppler[3][:RADIAL_BLOCKS], doppler[4][:RADIAL_BLOCKS]
    vel = vel + RADIAL_SPEED * pos / pos.norm(dim=-1, keepdim=True)
    radial = (*doppler[:3], pos, vel, *doppler[5:])
    expect = {"resample_block_kernel", "fused_mode_a_planar"}
    reset_launches()
    t0 = time.perf_counter()
    sr, _, mr = render_trajectory(*radial, **common, max_pitch=MAX_PITCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    if {k for k, v in counts.items() if v > 0} != expect or any(
            counts[k] != RADIAL_BLOCKS for k in expect):
        fail(f"d_radial: kernels launched {counts}, expected {RADIAL_BLOCKS} "
             f"of each of {sorted(expect)}")
    for k in expect:
        by_route[k]["d_radial"] = counts[k]
    fractional = int((sr.cursor_frac != 0).sum())
    if fractional == 0:
        fail("d_radial: every cursor is whole, so no lane read between samples")
    reset_launches()
    sq, _, mq = render_trajectory(*radial, **common, max_pitch=MAX_PITCH,
                                  biquad_method="plain", resample_gather="plain")
    if any(LAUNCHES.values()):
        fail(f"plain path launched kernels: {LAUNCHES}")
    if not bool(torch.isfinite(mr).all()):
        fail("d_radial: master not finite")
    d_radial = float((mr - mq).abs().max())
    if d_radial > TOL_PLAIN_PATH:
        fail(f"d_radial: kernel path vs plain path master differ by {d_radial:.3e} "
             f"> {TOL_PLAIN_PATH}")
    for field in ("cursor_idx", "cursor_frac"):
        if not torch.equal(getattr(sr, field), getattr(sq, field)):
            fail(f"d_radial: kernel path vs plain path: {field} differ")
    phase("slice", route="d_radial", blocks=RADIAL_BLOCKS,
          ms_per_block=f"{secs / RADIAL_BLOCKS * 1e3:.4f}", fractional_cursors=fractional,
          kernel_vs_plain=f"{d_radial:.3e}", cursors="equal",
          launches=json.dumps(counts, separators=(",", ":")))
    return by_route


def main():
    if not (ROOT / "godot_audio_spatializer_torch" / "__init__.py").is_file():
        fail("the godot_audio_spatializer_torch package is not beside this script")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())

    import godot_audio_spatializer_torch  # noqa: F401  (precision pins)
    from godot_audio_spatializer_torch.ops.kernels import LAUNCHES
    from godot_audio_spatializer_torch.ops.kernels.build import build_all, build_seconds

    secs = build_seconds()
    regs = []
    for name, lib in build_all().items():
        log = lib.with_name(f"{name}.log")
        if log.is_file():
            regs += [f"{name}: {ln.strip()}" for ln in log.read_text().splitlines()
                     if "registers" in ln]
    phase("build", seconds=f"{secs:.2f}", ptxas=json.dumps(regs))

    rows = check_kernels(torch, np, dev)
    launches = run_slice(torch, np, dev)
    for r in rows:
        r["launches_by_route"] = launches[r["name"]]
        r["launches"] = sum(r["launches_by_route"].values())
        if r["launches"] == 0:
            fail(f"{r['name']} was never launched on the main path")
    order = ("name", "route", "source", "replaces", "launches", "launches_by_route",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in rows]}), flush=True)
    if set(LAUNCHES) != {r["name"] for r in rows}:
        fail(f"kernel table {sorted(r['name'] for r in rows)} != counters {sorted(LAUNCHES)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
