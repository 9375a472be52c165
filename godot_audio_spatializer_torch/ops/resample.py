"""Batched fixed-point linear resampler (PyTorch port of ops/resample.py).

Cursors are integer (sample_index, 16-bit fraction) pairs, so the port,
the JAX package and the golden scalar reference advance bit-identically.
Clips live in one flat bank with 128-aligned bases and a margin after
each clip (loop clips: the clip repeated; one-shot clips: the last sample
replicated, which reproduces the golden's interpolation clamp).

Three read paths, as in the JAX package:

* unit pitch (pitch 1, aligned cursors): whole-row reads, no per-frame
  position math;
* ``gather_method="plain"``: per-frame positions and a two-tap gather in
  plain PyTorch;
* ``gather_method="kernel"``: the CUDA resampler (``ops/kernels/
  resample.py``; its plain twin on a CPU bank), interleaved or in the raw
  planar layout that the planar mix kernel reads.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .kernels.resample import FP_BITS, FP_MASK, ROW, gather_lerp, resample_block_kernel
from .kernels.resample import positions as _positions

FP_LEN = 1 << FP_BITS


def quantize_pitch(pitch_scale):
    """pitch → 16-bit fixed point: round-half-even of the f32 product."""
    return torch.round(pitch_scale.to(torch.float32) * FP_LEN).to(torch.int32)


def window_rows(frame_count: int, max_pitch: float, wrow: int = ROW) -> int:
    """Rows per source window: offset (< wrow) + F·max_pitch + interp margin."""
    need = (wrow - 1) + int(np.ceil(frame_count * max_pitch)) + 2
    return need // wrow + 1


def margin_samples(frame_count: int, max_pitch: float) -> int:
    return (window_rows(frame_count, max_pitch) + 1) * ROW


def build_bank(
    clips: Sequence[Tuple[np.ndarray, bool]],
    frame_count: int,
    max_pitch: float,
    dtype=np.float32,
    align: int = ROW,
) -> Tuple[np.ndarray, List[int]]:
    """Pack (data [S,2], loop[, loop_begin]) clips into a flat bank with
    aligned bases and margins.  Returns (bank [T,2] f32 or int16, bases).
    NumPy, identical to the JAX package's build_bank (the total length is
    padded to a 512 multiple there for its wide-row regroup; kept so the
    two banks are the same array)."""
    assert align % ROW == 0
    margin = margin_samples(frame_count, max_pitch)
    chunks = []
    bases = []
    pos = 0
    for clip in clips:
        data, loop = clip[0], clip[1]
        begin = clip[2] if len(clip) > 2 else 0  # loop-region start
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = np.stack([data, data], axis=-1)
        s = data.shape[0]
        if loop:
            region = data[begin:]
            reps = int(np.ceil(margin / max(region.shape[0], 1))) + 1
            tail = np.tile(region, (reps, 1))[:margin]
        else:
            tail = np.tile(data[-1:], (margin, 1)) if s else np.zeros((margin, 2), np.float32)
        body = np.concatenate([data, tail], axis=0)
        pad = (-body.shape[0]) % align
        if pad:
            body = np.concatenate([body, np.tile(body[-1:], (pad, 1))], axis=0)
        bases.append(pos)
        chunks.append(body)
        pos += body.shape[0]
    bank = np.concatenate(chunks, axis=0) if chunks else np.zeros((align, 2), np.float32)
    tpad = (-bank.shape[0]) % 512
    if tpad:
        bank = np.concatenate([bank, np.zeros((tpad, 2), bank.dtype)])
    if np.dtype(dtype) == np.int16:
        bank = np.clip(np.round(bank * 32767.0), -32768, 32767).astype(np.int16)
    return bank, bases


def _advance(cursor_idx, cursor_frac, pitch_fp, frame_count, length, loop,
             loop_begin=None):
    pitch_int = pitch_fp >> FP_BITS
    pitch_frac = pitch_fp & FP_MASK
    acc_f = cursor_frac + frame_count * pitch_frac
    new_idx = cursor_idx + frame_count * pitch_int + (acc_f >> FP_BITS)
    new_frac = acc_f & FP_MASK
    # loop wrap into [loop_begin, length); a cursor still in the pre-loop
    # head (idx < length) is untouched (Godot AudioStreamWAV loop_begin)
    if loop_begin is None:
        loop_begin = torch.zeros_like(length)
    span = torch.clamp(length - loop_begin, min=1)
    wrapped = loop_begin + torch.remainder(new_idx - loop_begin, span)  # floor-mod
    new_idx = torch.where(loop & (new_idx >= length), wrapped, new_idx)
    return new_idx, new_frac


def resample_block(
    bank,  # [T, 2] f32 (build_bank: aligned bases + margins)
    base,  # [N] i32, 128-aligned
    length,  # [N] i32 logical clip length
    loop,  # [N] bool
    cursor_idx,  # [N] i32
    cursor_frac,  # [N] i32
    pitch_fp,  # [N] i32
    frame_count: int,
    *,
    max_pitch: float = 8.0,
    unit_pitch_aligned: bool = False,
    gather_method: str = "plain",
    loop_begin=None,  # [N] i32 loop-region start (None = 0)
    layout: str = "interleaved",
    row_width: int = ROW,
):
    """Read one block of F frames per source at fractional rate.

    Returns (frames [N,F,2], mixed [N], new_cursor_idx, new_cursor_frac).
    With ``gather_method="kernel"`` and ``layout="planar"`` the frames
    are the kernel's raw [2, F/128, Np, 128] layout and mixed is [Np]
    (Np = N padded to a 1024 multiple; pad lanes read bank row 0 at unit
    pitch and are dropped downstream).

    ``gather_method``: "plain" (PyTorch gather) or "kernel" (the CUDA
    resampler; F % 128 == 0).  Cursor math is bit-identical between them.
    """
    if bank.dtype == torch.int16:
        raise NotImplementedError(
            "int16 banks are not ported yet (ROADMAP Queue 4, item 1)"
        )
    F = frame_count
    N = base.shape[0]
    length_e = torch.clamp(length, min=1)

    if unit_pitch_aligned:
        W = row_width
        assert W % ROW == 0 and F % W == 0, "row_width: 128-multiple dividing F"
        wide = bank.reshape(-1, W, 2)
        nwide = wide.shape[0]
        nr = F // W
        row0 = torch.div(base + cursor_idx, W, rounding_mode="floor")
        rows = row0[:, None] + torch.arange(nr, dtype=torch.int32, device=bank.device)
        frames = wide[torch.clamp(rows, 0, nwide - 1).long()].reshape(N, F, 2)
        idx = cursor_idx[:, None] + torch.arange(F, dtype=torch.int32, device=bank.device)
        # the row read starts at the cursor only when (base + cursor) % W
        # == 0; a misaligned lane reads as silence, never as the wrong
        # samples
        aligned = torch.remainder(base + cursor_idx, W) == 0
        valid = (loop[:, None] | (idx <= length_e[:, None] - 1)) & aligned[:, None]
        frames = torch.where(valid[..., None], frames, torch.zeros((), device=bank.device))
        mixed = valid.sum(dim=1, dtype=torch.int32)
        new_idx, _ = _advance(
            cursor_idx, cursor_frac * 0, torch.full_like(cursor_idx, FP_LEN),
            F, length, loop, loop_begin,
        )
        return frames, mixed, new_idx, cursor_frac

    pitch_fp = torch.clamp(pitch_fp, max=int(round(max_pitch * FP_LEN)))
    R = window_rows(F, max_pitch)
    new_idx, new_frac = _advance(
        cursor_idx, cursor_frac, pitch_fp, F, length, loop, loop_begin
    )

    if gather_method == "kernel":
        if layout == "planar":
            Np = -(-N // 1024) * 1024
            pad = Np - N

            def padn(a, fill=0):
                if not pad:
                    return a
                return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype, device=a.device)])

            y, mixed_p = resample_block_kernel(
                bank, padn(base), padn(length, 1), padn(loop), padn(cursor_idx),
                padn(cursor_frac), padn(pitch_fp, FP_LEN), F, R, raw=True,
            )
            return y, mixed_p, new_idx, new_frac
        frames, mixed = resample_block_kernel(
            bank, base, length, loop, cursor_idx, cursor_frac, pitch_fp, F, R,
        )
        return frames, mixed, new_idx, new_frac
    if gather_method != "plain":
        raise ValueError(f"gather_method must be 'plain' or 'kernel' (got {gather_method!r})")

    frames, mixed = gather_lerp(
        bank, base, length, loop, cursor_idx, cursor_frac, pitch_fp, F, R
    )
    return frames, mixed, new_idx, new_frac
