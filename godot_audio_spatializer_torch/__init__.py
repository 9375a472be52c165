"""PyTorch / CUDA port of the spatial audio engine, for NVIDIA Hopper.

A second package beside ``godot_audio_spatializer_tpu`` (the JAX
reference).  Its module layout mirrors the reference's: ``ops/mix.py``
here is the counterpart of ``ops/mix.py`` there.  Every Pallas kernel on
a ported path is a hand-written CUDA kernel under ``csrc/``, bound in
``ops/kernels/``, with a plain PyTorch twin that the CPU uses.

This package imports neither ``jax`` nor anything of the JAX package.
"""

__version__ = "0.1.0"

from .utils.device import pin_precision as _pin_precision

_pin_precision()

from .constants import AttenuationModel, DopplerTracking, SpeakerMode  # noqa: E402,F401
