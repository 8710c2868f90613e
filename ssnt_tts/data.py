"""Input pipeline: synthetic SSNT-TTS dataset + double-buffered host->device
prefetch.

The reference has no data layer at all (SURVEY.md §0; the TF model repo owned
it). Accelerator requirements implemented here:
  - static shapes: every batch padded to (max_input_length, max_output_length)
    with true lengths carried alongside (the masking contract of
    ops.lattice.ssnt_loss and the beam steps)
  - host->device overlap: a background thread stages the next batch with
    jax.device_put (to the mesh's data sharding when given) while the current
    step runs, hiding the host-to-device transfer behind compute

The synthetic generator produces structurally faithful data: monotone
alignments (random emit/shift walks), mel trajectories that are piecewise
functions of the aligned token, and duration/tone targets consistent with the
alignment — enough to overfit and to validate end-to-end training.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import jax
import numpy as np


class SyntheticTTSDataset:
    def __init__(
        self,
        vocab_size: int = 128,
        mel_dim: int = 80,
        max_input_length: int = 80,
        max_output_length: int = 400,
        duration_class_size: int = 10,
        tone_class_size: int = 8,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.mel_dim = mel_dim
        self.max_T = max_input_length
        self.max_U = max_output_length
        self.D = duration_class_size
        self.K = tone_class_size
        self._rng = np.random.default_rng(seed)
        # Fixed random embedding of tokens -> mel space so mel frames are a
        # learnable function of the aligned token.
        self._tok_mel = self._rng.normal(
            0, 1, (vocab_size, mel_dim)
        ).astype(np.float32)

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        B = batch_size
        T, U = self.max_T, self.max_U
        tokens = rng.integers(1, self.vocab_size, (B, T)).astype(np.int32)
        input_length = rng.integers(
            max(2, T // 2), T + 1, B
        ).astype(np.int32)
        output_length = np.zeros(B, np.int32)
        mel = np.zeros((B, U, self.mel_dim), np.float32)
        duration = np.zeros((B, T), np.int32)
        align = np.zeros((B, U), np.int32)
        for b in range(B):
            Tb = input_length[b]
            # Random positive durations summing to <= U: expected U/T frames
            # per token, at least 1 (every token emits), at most D-1 so the
            # duration-CLASS targets are exactly the durations. (Round-5
            # fix: the generator previously drew durations up to
            # (U//Tb)*2-1 > D-1 and clipped only the class targets, so
            # sum(duration_target) != output_length and — when
            # (D-1)*Tb < output_length — the utterance was INFEASIBLE in
            # the v2 alignment space: no class sequence can land
            # output_length exactly, the state where the reference
            # panics (src/v2.rs:292). A large part of the eval
            # empty-beam rate was this data inconsistency, not decode
            # behavior.)
            max_per = max(1, min((U // Tb) * 2 - 1, self.D - 1))
            d = rng.integers(1, max_per + 1, Tb)
            scale = min(1.0, (U - Tb) / max(1, d.sum() - Tb))
            d = np.maximum(1, np.round(d * scale)).astype(np.int64)
            while d.sum() > U:
                i = int(np.argmax(d))
                d[i] -= 1
            duration[b, :Tb] = d
            Ub = int(d.sum())
            output_length[b] = Ub
            pos = np.repeat(np.arange(Tb), d)
            align[b, :Ub] = pos
            mel[b, :Ub] = self._tok_mel[tokens[b, pos]]
        mel += rng.normal(0, 0.05, mel.shape).astype(np.float32)
        tone = (tokens % self.K).astype(np.int32)
        dur_class = np.clip(duration, 0, self.D - 1).astype(np.int32)
        return {
            "tokens": tokens,
            "mel": mel,
            "input_length": input_length,
            "output_length": output_length,
            "duration_target": dur_class,
            "tone_target": tone,
            "alignment": align,
        }

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(batch_size)


def prefetch_to_device(
    it: Iterator[Dict[str, np.ndarray]],
    size: int = 2,
    sharding=None,
) -> Iterator[Dict[str, jax.Array]]:
    """Double-buffered host->device staging. With `sharding`
    (e.g. mesh_lib.data_sharding(mesh)) batches land pre-sharded."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _SENTINEL = object()

    def producer():
        try:
            for batch in it:
                if sharding is not None:
                    batch = jax.device_put(batch, sharding)
                else:
                    batch = jax.device_put(batch)
                q.put(batch)
            q.put(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
