"""ssnt_tts — an SSNT/transducer alignment engine in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
nii-yamagishilab/ssnt-tts-rust (reference mounted at /root/reference), plus
the training-side components the reference omits (forward-backward lattice
loss, encoder/decoder TTS model, distributed execution).

Public API parity with the reference Python wrapper
(/root/reference/ssnt-tts-tensorflow/ssnt_tts_tensorflow/__init__.py):

  beam_search_decode              (v1 emit/shift step, __init__.py:8)
  extract_best_beam_branch        (__init__.py:24)
  ssnt_tts_v2_beam_search_decode  (__init__.py:33)
  order_beam_branch               (__init__.py:76)
  upsample_source_indexes         (__init__.py:85)
  tone_latent_beam_search_decode  (__init__.py:99)
  levenshtein_edit_distance       (__init__.py:130)

Capabilities the reference lacks (see ops.lattice, models, parallel):

  ssnt_loss                       forward-backward emit/shift lattice NLL
  ssnt_duration_loss              duration-class (v2) lattice NLL
"""

from ssnt_tts.ops.beam_v1 import (
    beam_search_decode,
    beam_search_decode_batched,
)
from ssnt_tts.ops.beam_v2 import (
    beam_search_decode as ssnt_tts_v2_beam_search_decode,
)
from ssnt_tts.ops.tone_latent import (
    beam_search_decode as tone_latent_beam_search_decode,
)
from ssnt_tts.ops.backtrace import (
    extract_best_beam_branch,
    order_beam_branch,
)
from ssnt_tts.ops.upsample import upsample_source_indexes
from ssnt_tts.ops.edit_distance import levenshtein_edit_distance
from ssnt_tts.ops.lattice import ssnt_loss, ssnt_duration_loss

__version__ = "0.1.0"

__all__ = [
    "beam_search_decode",
    "beam_search_decode_batched",
    "ssnt_tts_v2_beam_search_decode",
    "tone_latent_beam_search_decode",
    "extract_best_beam_branch",
    "order_beam_branch",
    "upsample_source_indexes",
    "levenshtein_edit_distance",
    "ssnt_loss",
    "ssnt_duration_loss",
]
