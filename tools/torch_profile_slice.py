#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's offline doppler slice.

    python3 tools/torch_profile_slice.py [--blocks 32] [--route planar|split|unit]

Renders the 4096-source 7.1 48 kHz bench scene (F = 512, max_pitch 1.4)
through ``render_trajectory`` on the CUDA card under ``torch.profiler``
and prints: host ms per block, device busy ms per block, the device's
idle share, and device time per kernel name (top 15).  Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--route", choices=("planar", "split", "unit"), default="planar")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from godot_audio_spatializer_torch.constants import SpeakerMode
    from godot_audio_spatializer_torch.engine.offline import render_trajectory
    from godot_audio_spatializer_torch.ops.kernels.build import build_seconds
    from godot_audio_spatializer_torch.utils.benchscene import build_bench_scene

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    build_seconds()
    K, F, rate = args.blocks, 512, 48000.0
    unit = args.route == "unit"
    scene = build_bench_scene(4096, K, F, rate, doppler=not unit,
                              row_align=F if unit else 128, device="cuda")
    kw = dict(speaker_mode=SpeakerMode.SURROUND_71, mix_rate=rate, frame_count=F)
    if unit:
        kw.update(unit_pitch_aligned=True, unit_row_width=F)
    else:
        kw.update(max_pitch=1.4, planar=args.route == "planar")
    render_trajectory(*scene, **kw)  # warm-up: allocator, cuBLAS, kernel build
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_trajectory(*scene, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, memcpy/memset): an operator's own
    # row also carries its kernels' time, which would count them twice
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_us = sum(r[0] for r in rows)
    print(f"route={args.route} blocks={K} host_ms_per_block={wall / K * 1e3:.4f} "
          f"device_busy_ms_per_block={busy_us / K / 1e3:.4f} "
          f"device_idle_share={1.0 - busy_us / 1e6 / wall:.4f} "
          f"kernel_launches_per_block={sum(r[1] for r in rows) / K:.1f}")
    for us, count, key in sorted(rows, reverse=True)[:15]:
        print(f"  {us / K:10.2f} us/block  {count / K:6.1f} calls/block  {key[:90]}")


if __name__ == "__main__":
    main()
