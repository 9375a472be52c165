"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper adds one to its entry in ``LAUNCHES`` where it launches its
kernel, and nowhere else: a run that zeroes the counts, drives a path and
reads them back shows which kernels the path went through.
"""

LAUNCHES = {
    "resample_block_kernel": 0,
    "fused_mode_a": 0,
    "fused_mode_a_planar": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
