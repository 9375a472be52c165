"""Kernels 2 and 3: the fused mode-A frame path (``csrc/mix_mode_a.cu``).

Counterparts of ``ops/pallas/mix_kernel.py: fused_mode_a`` and
``fused_mode_a_planar`` in the JAX package: one CUDA source, templated on
the input indexing.  Each wrapper launches the CUDA kernel for CUDA
tensors and runs ``mix_mode_a_plain``, the plain PyTorch twin, for CPU
tensors.

Wrapper semantics carried over from the JAX package: bypass lanes enter
the loop as the identity filter with zero increments
(``_precondition_coeffs``) and get their stored history and coefficients
back afterwards (``_restore_bypass``); the peak is the max over ears.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import FADEOUT_BASE, LOOKAHEAD_BUFFER_SIZE
from . import LAUNCHES
from .build import check_launch, check_tensor, load_library

LA = LOOKAHEAD_BUFFER_SIZE
ROW = 128


def precondition_coeffs(coeffs, target, apply_mask, frame_count):
    """Bypass lanes become the identity filter [1,0,0,0,0] with zero
    increments, so the loop needs no per-step select.
    Returns (c0_eff [N,5], inc_eff [N,5])."""
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                         device=coeffs.device)
    m = apply_mask[:, None]
    c0_eff = torch.where(m, coeffs, ident[None])
    inc_eff = torch.where(m, (target - coeffs) / frame_count, torch.zeros_like(coeffs))
    return c0_eff, inc_eff


def restore_bypass(sto, co, state, coeffs, apply_mask):
    """Bypass lanes keep their history and coefficients (reference
    semantics: a bypassed filter neither advances nor ramps)."""
    new_state = torch.where(apply_mask[:, None, None], sto, state)
    new_coeffs = torch.where(apply_mask[:, None], co, coeffs)
    return new_state, new_coeffs


def planar_to_frames(frames_planar, n):
    """Raw planar [2, F/128, Np, 128] → interleaved [n, F, 2]."""
    _, nch, _, _ = frames_planar.shape
    return frames_planar[:, :, :n].permute(2, 1, 3, 0).reshape(n, nch * ROW, 2)


def mix_mode_a_plain(x, la, c0, inc, st, mixed, mask, frame_count):
    """Plain twin of the kernel loop, vectorised over (source, ear) lanes.

    x [N,F,2] stream frames; la [N,LA,2]; c0/inc [N,5] preconditioned;
    st [N,2,4]; mixed [N] i32; mask [N] bool.  Returns (sig [N,F,2],
    la_out [N,LA,2], st_out [N,2,4], co [N,5], peak [N,2]).  Same
    expressions in the same order as the CUDA kernel."""
    F = frame_count
    mf = mixed.to(torch.float32)[:, None]  # [N,1] — broadcast over ears
    zms = mask.to(torch.float32)[:, None]
    zm_over_la = zms * (1.0 / LA)
    combined = torch.cat([la, x[:, : F - LA]], dim=1)  # delay-line view
    x1, x2, y1, y2 = st.unbind(-1)  # [N,2] each
    fadec = torch.ones_like(x1)
    peak = torch.zeros_like(x1)
    c = [c0[:, j : j + 1] for j in range(5)]
    d = [inc[:, j : j + 1] for j in range(5)]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for f in range(F):
        k = float(f) - mf
        in_fade = (k >= 0.0) & (k < float(LA))
        fadec = torch.where(in_fade, fadec * FADEOUT_BASE, fadec)
        factor = torch.where(
            k < 0.0, zms, torch.where(in_fade, (fadec * (float(LA) - k)) * zm_over_la, zero)
        )
        xt = combined[:, f] * factor
        kf = 1.0 + float(f)
        yf = ((((c[0] + kf * d[0]) * xt + (c[1] + kf * d[1]) * x1)
               + (c[2] + kf * d[2]) * x2) + (c[3] + kf * d[3]) * y1) \
            + (c[4] + kf * d[4]) * y2
        ys.append(yf)
        peak = torch.maximum(peak, yf.abs())
        x1, x2, y1, y2 = xt, x1, yf, y1
    sig = torch.stack(ys, dim=1)
    st_out = torch.stack([x1, x2, y1, y2], dim=-1)
    co = c0 + float(F) * inc
    full = ((mixed >= F) & mask)[:, None, None]
    la_out = torch.where(full, x[:, F - LA : F], la)
    return sig, la_out, st_out, co, peak


def _launch(x, planar, la, c0, inc, st, mixed, mask, frame_count):
    """Launch the CUDA kernel; same outputs as ``mix_mode_a_plain``."""
    n = la.shape[0]
    F = frame_count
    np_ = x.shape[2] if planar else n
    if planar:
        check_tensor(x, "frames_planar", torch.float32, (2, F // ROW, np_, ROW))
        if np_ < n:
            raise ValueError(f"planar frames hold {np_} sources, need >= {n}")
    else:
        check_tensor(x, "frames", torch.float32, (n, F, 2))
    check_tensor(la, "lookahead", torch.float32, (n, LA, 2))
    check_tensor(c0, "coeffs", torch.float32, (n, 5))
    check_tensor(inc, "increments", torch.float32, (n, 5))
    check_tensor(st, "state", torch.float32, (n, 2, 4))
    check_tensor(mixed, "mixed", torch.int32, (n,))
    check_tensor(mask, "signal_mask", torch.bool, (n,))
    dev = x.device
    sig = torch.empty((n, F, 2), dtype=torch.float32, device=dev)
    la_out = torch.empty((n, LA, 2), dtype=torch.float32, device=dev)
    st_out = torch.empty((n, 2, 4), dtype=torch.float32, device=dev)
    co = torch.empty((n, 5), dtype=torch.float32, device=dev)
    peak = torch.empty((n, 2), dtype=torch.float32, device=dev)
    fn = load_library("mix_mode_a").gas_mix_mode_a
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    rc = fn(
        x.data_ptr(), int(planar), np_, la.data_ptr(), c0.data_ptr(),
        inc.data_ptr(), st.data_ptr(), mixed.data_ptr(), mask.data_ptr(), n, F,
        sig.data_ptr(), la_out.data_ptr(), st_out.data_ptr(), co.data_ptr(),
        peak.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc, "mix_mode_a")
    LAUNCHES["fused_mode_a_planar" if planar else "fused_mode_a"] += 1
    return sig, la_out, st_out, co, peak


def _run(x, planar, lookahead, coeffs, target, state, mixed, signal_mask,
         apply_mask, frame_count):
    n = lookahead.shape[0]
    if lookahead.dtype == torch.int16 or x.dtype == torch.int16:
        raise NotImplementedError(
            "int16 PCM intermediates are not ported yet (ROADMAP Queue 4, item 1)"
        )
    c0, inc = precondition_coeffs(coeffs, target, apply_mask, frame_count)
    if x.device.type == "cpu":
        xf = planar_to_frames(x, n) if planar else x
        out = mix_mode_a_plain(
            xf, lookahead, c0, inc, state, mixed[:n], signal_mask, frame_count
        )
    else:
        out = _launch(
            x, planar, lookahead.contiguous(), c0.contiguous(), inc.contiguous(),
            state.contiguous(), mixed[:n].contiguous(), signal_mask.contiguous(),
            frame_count,
        )
    sig, la_out, sto, co, peak = out
    new_state, new_coeffs = restore_bypass(sto, co, state, coeffs, apply_mask)
    return sig, la_out, new_state, new_coeffs, peak.amax(dim=1)


def fused_mode_a(frames, lookahead, coeffs, target, state, mixed, signal_mask,
                 apply_mask, frame_count):
    """Fused mode-A block.  frames [N,F,2]; lookahead [N,LA,2];
    coeffs/target [N,5]; state [N,2,4] (after the just-started clear);
    mixed [N] i32; signal_mask/apply_mask [N] bool.  Returns (sig [N,F,2],
    new_lookahead, new_state [N,2,4], new_coeffs [N,5], peak [N])."""
    return _run(frames, False, lookahead, coeffs, target, state, mixed,
                signal_mask, apply_mask, frame_count)


def fused_mode_a_planar(frames_planar, lookahead, coeffs, target, state, mixed,
                        signal_mask, apply_mask, frame_count):
    """As ``fused_mode_a``, reading the resampler's raw planar output
    [2, F/128, Np, 128] and its padded mixed counts [Np]."""
    if frames_planar.shape[2] % 1024 or frame_count % ROW:
        raise ValueError("planar frames need Np % 1024 == 0 and F % 128 == 0")
    return _run(frames_planar, True, lookahead, coeffs, target, state, mixed,
                signal_mask, apply_mask, frame_count)
