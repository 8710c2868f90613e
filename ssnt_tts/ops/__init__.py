from ssnt_tts.ops import (
    backtrace,
    beam_common,
    beam_v1,
    beam_v2,
    checks,
    edit_distance,
    lattice,
    tone_latent,
    upsample,
)

__all__ = [
    "backtrace",
    "beam_common",
    "beam_v1",
    "beam_v2",
    "checks",
    "edit_distance",
    "lattice",
    "tone_latent",
    "upsample",
]
