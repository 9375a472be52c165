"""Kernel 1: the fixed-point resampler (``csrc/resample.cu``).

Counterpart of ``ops/pallas/resample_kernel.py: resample_block_kernel``
in the JAX package.  ``resample_block_kernel`` launches the CUDA kernel
for a CUDA bank and runs ``resample_block_plain``, its plain PyTorch
twin, for a CPU bank (also the ``"plain"`` read of ``ops/resample.py``).
Positions are the JAX package's 16-bit fixed point, bit for bit; the
kernel's lerp rounds like the twin's f32 expression.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .build import check_launch, check_tensor, load_library

FP_BITS = 16
FP_MASK = (1 << FP_BITS) - 1
ROW = 128


def positions(cursor_idx, cursor_frac, pitch_fp, frame_count):
    """Absolute read positions of every output frame: (idx [N,F] i32,
    frac [N,F] f32), 16-bit fixed point exactly as the JAX package."""
    i = torch.arange(frame_count, dtype=torch.int32, device=cursor_idx.device)
    pitch_int = pitch_fp >> FP_BITS
    pitch_frac = pitch_fp & FP_MASK
    acc = cursor_frac[:, None] + i[None, :] * pitch_frac[:, None]
    idx = cursor_idx[:, None] + i[None, :] * pitch_int[:, None] + (acc >> FP_BITS)
    frac = (acc & FP_MASK).to(torch.float32) * (1.0 / (1 << FP_BITS))
    return idx, frac


def gather_lerp(bank, base, length, loop, cursor_idx, cursor_frac, pitch_fp,
                frame_count, win_rows):
    """Plain-PyTorch block read: frames [N,F,2] and mixed [N] i32.

    Reads through the source's window of `win_rows` bank rows starting
    at the 128-aligned cursor, each row clamped to the bank (the window
    gather of the JAX package, without materialising the window)."""
    num_rows = bank.shape[0] // ROW
    idx, frac = positions(cursor_idx, cursor_frac, pitch_fp, frame_count)
    valid = loop[:, None] | (idx <= torch.clamp(length, min=1)[:, None] - 1)
    start_al = (cursor_idx >> 7) << 7
    row0 = (base + start_al) >> 7
    rel = torch.clamp(idx - start_al[:, None], 0, win_rows * ROW - 2)

    def tap(r):
        rows = torch.clamp(row0[:, None] + (r >> 7), 0, num_rows - 1)
        return bank[(rows * ROW + (r & (ROW - 1))).long()]  # [N, F, 2]

    s0, s1 = tap(rel), tap(rel + 1)
    frames = s0 * (1.0 - frac)[..., None] + s1 * frac[..., None]
    frames = torch.where(valid[..., None], frames, torch.zeros((), device=bank.device))
    return frames, valid.sum(dim=1, dtype=torch.int32)


def to_raw(frames):
    """[N, F, 2] → the kernel's raw planar layout [2, F/128, N, 128]."""
    n, f, _ = frames.shape
    return frames.reshape(n, f // ROW, ROW, 2).permute(3, 1, 0, 2).contiguous()


def resample_block_plain(bank, base, length, loop, cursor_idx, cursor_frac,
                         pitch_fp, frame_count, win_rows, *, raw=False):
    frames, mixed = gather_lerp(
        bank, base, length, loop, cursor_idx, cursor_frac, pitch_fp,
        frame_count, win_rows,
    )
    return (to_raw(frames) if raw else frames), mixed


def resample_block_kernel(bank, base, length, loop, cursor_idx, cursor_frac,
                          pitch_fp, frame_count, win_rows, *, raw=False):
    """One block of `frame_count` frames per source.

    bank [T, 2] f32 (T % 128 == 0); base/length/cursor_idx/cursor_frac/
    pitch_fp [N] i32 (pitch pre-clamped by the caller); loop [N] bool;
    `win_rows` bounds each source's window (ops/resample.window_rows).
    Returns (frames [N, F, 2], mixed [N] i32), or with ``raw=True``
    (frames [2, F/128, N, 128], mixed [N]); F % 128 == 0 for raw."""
    if bank.dtype == torch.int16:
        raise NotImplementedError(
            "int16 banks are not ported yet (ROADMAP Queue 4, item 1)"
        )
    if raw and frame_count % ROW:
        raise ValueError("raw layout needs frame_count % 128 == 0")
    if bank.device.type == "cpu":
        return resample_block_plain(
            bank, base, length, loop, cursor_idx, cursor_frac, pitch_fp,
            frame_count, win_rows, raw=raw,
        )
    n = base.shape[0]
    if bank.dim() != 2 or bank.shape[1] != 2 or bank.shape[0] % ROW:
        raise ValueError(f"bank must be [T, 2] with T % 128 == 0 (got {tuple(bank.shape)})")
    check_tensor(bank, "bank", torch.float32)
    for nm, t in (("base", base), ("length", length), ("cursor_idx", cursor_idx),
                  ("cursor_frac", cursor_frac), ("pitch_fp", pitch_fp)):
        check_tensor(t, nm, torch.int32, (n,))
    check_tensor(loop, "loop", torch.bool, (n,))
    F = frame_count
    if raw:
        out = torch.empty((2, F // ROW, n, ROW), dtype=torch.float32, device=bank.device)
    else:
        out = torch.empty((n, F, 2), dtype=torch.float32, device=bank.device)
    mixed = torch.empty((n,), dtype=torch.int32, device=bank.device)
    lib = load_library("resample")
    fn = lib.gas_resample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    rc = fn(
        bank.data_ptr(), bank.shape[0] // ROW, base.data_ptr(), length.data_ptr(),
        loop.data_ptr(), cursor_idx.data_ptr(), cursor_frac.data_ptr(),
        pitch_fp.data_ptr(), n, F, win_rows, int(raw), out.data_ptr(),
        mixed.data_ptr(), torch.cuda.current_stream(bank.device).cuda_stream,
    )
    check_launch(rc, "resample")
    LAUNCHES["resample_block_kernel"] += 1
    return out, mixed
