"""Engine-wide constants.

Mirrors the reference module's hard limits (see SURVEY.md §2):
  - MAX_CHANNELS_PER_BUS, LOOKAHEAD_BUFFER_SIZE, MAX_BUSES_PER_PLAYBACK,
    MAX_INTERSECT_AREAS: reference audio_spatializer.h:47-52
  - CMP_EPSILON: Godot core math constant used by the attenuation models
    (reference audio_spatializer_3d.cpp:127-135)
  - speaker-mode channel layout: reference audio_spatializer_3d.cpp:57-98
"""

from __future__ import annotations

import enum

# reference audio_spatializer.h:48 — 4 stereo channel pairs per bus.
MAX_CHANNELS_PER_BUS = 4
# reference audio_spatializer.h:49 — frames kept for end-of-stream fade-out.
LOOKAHEAD_BUFFER_SIZE = 64
# reference audio_spatializer.h:50
MAX_BUSES_PER_PLAYBACK = 6
# reference audio_spatializer.h:51
MAX_INTERSECT_AREAS = 32

# Godot core CMP_EPSILON (used at reference audio_spatializer_3d.cpp:127).
CMP_EPSILON = 0.00001

# Godot Math::linear_to_db / db_to_linear constants (20/ln(10) and ln(10)/20).
LINEAR_TO_DB_SCALE = 8.6858896380650365530225783783321
DB_TO_LINEAR_SCALE = 0.11512925464970228420089957273422

# reference audio_spatializer.cpp:384 — end-of-stream fade-out base.
FADEOUT_BASE = 0.96

# reference audio_spatializer.cpp:598 — default auto-disable threshold.
PLAYBACK_DISABLE_THRESHOLD_DB = -80.0

# reference audio_spatializer_3d.cpp:503/568 — highshelf bypass threshold.
HIGHSHELF_GAIN_EPSILON = 0.001

# reference audio_spatializer_3d.cpp:421 — doppler pitch clamp.
DOPPLER_PITCH_MIN = 1.0 / 8.0
DOPPLER_PITCH_MAX = 8.0


class SpeakerMode(enum.IntEnum):
    """AudioServer speaker modes (reference audio_spatializer_3d.cpp:59-72)."""

    STEREO = 0
    SURROUND_31 = 1
    SURROUND_51 = 2
    SURROUND_71 = 3


# Number of stereo channel pairs per speaker mode
# (AudioServer::get_channel_count(); used at reference
# audio_spatializer_3d.cpp:167 and audio_spatializer.cpp:176).
SPEAKER_MODE_CHANNEL_COUNT = {
    SpeakerMode.STEREO: 1,
    SpeakerMode.SURROUND_31: 2,
    SpeakerMode.SURROUND_51: 3,
    SpeakerMode.SURROUND_71: 4,
}

# Number of main (non-LFE) speakers per mode
# (reference audio_spatializer_3d.cpp:59-72).
SPEAKER_MODE_SPEAKER_COUNT = {
    SpeakerMode.STEREO: 2,
    SpeakerMode.SURROUND_31: 3,
    SpeakerMode.SURROUND_51: 5,
    SpeakerMode.SURROUND_71: 7,
}

# Uniform per-speaker energy fraction indexed by channel_count-1
# (reference audio_spatializer_3d.cpp:166).
REVERB_CENTER_VALUES = (0.5, 0.25, 0.16666, 0.125)


class AttenuationModel(enum.IntEnum):
    """reference audio_spatializer_3d.cpp:827-830."""

    INVERSE_DISTANCE = 0
    INVERSE_SQUARE_DISTANCE = 1
    LOGARITHMIC = 2
    DISABLED = 3


class DopplerTracking(enum.IntEnum):
    """reference audio_spatializer_3d.cpp:832-834."""

    DISABLED = 0
    IDLE_STEP = 1
    PHYSICS_STEP = 2


# Default 7-speaker direction table (reference audio_spatializer_3d.cpp:47-55).
# Order: front-left, front-right, center, rear-left, rear-right,
#        side-left, side-right.  Normalized in plain Python to keep this file
# import-light; consumers convert to their array type.
_SQRT_HALF = 0.7071067811865476
DEFAULT_SPEAKER_DIRECTIONS = (
    (-_SQRT_HALF, 0.0, -_SQRT_HALF),  # front-left
    (_SQRT_HALF, 0.0, -_SQRT_HALF),  # front-right
    (0.0, 0.0, -1.0),  # center
    (-_SQRT_HALF, 0.0, _SQRT_HALF),  # rear-left
    (_SQRT_HALF, 0.0, _SQRT_HALF),  # rear-right
    (-1.0, 0.0, 0.0),  # side-left
    (1.0, 0.0, 0.0),  # side-right
)
