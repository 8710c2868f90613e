"""SSNTModel — the flagship end-to-end SSNT-TTS network.

Ties together (one parameter tree, so training and decode share weights):

  text encoder -> enc (B, T, H)
  AR decoder cell (teacher-forced GRU scan over mel frames) -> dec (B, U, H)
  transition / frame joints -> (U, B, T) time-major lattice quantities
  ops.lattice.ssnt_loss -> per-example NLL  (training)
  duration / tone heads -> per-position class log-probs consumed by the
    v2 / tone-latent beam steps (decode-time conditioning, reference h inputs)

The reference repo holds only the decode kernels (SURVEY.md §0); this model
supplies the layer the reference assumed (the absent TF model repo): static
shapes, scan-based AR state, matmul-factorized lattice joints, bf16
compute.

The model is plain JAX. `SSNTModel(config)` is a description;
`init(rng, ...)` builds the parameter pytree and
`apply(params, *args, method=...)` runs a method with those parameters, as
in `model.apply(params, tokens, input_length, method=model.encode)`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ssnt_tts.models import decoder, encoder
from ssnt_tts.models.layers import length_mask
from ssnt_tts.ops import lattice
from ssnt_tts.utils.config import ModelConfig


def _lattice_loss(le, ls, lf, input_length, output_length):
    """Lattice NLL in the time-major (U, B, T) layout the joints emit.

    Long-context path: under a tshard_lattice context (entered by
    make_sharded_train_step when ModelConfig.lattice_tshard_min_cells is
    set), lattices above the cell threshold shard their T axis over the
    mesh with ring frontier exchange (ops/lattice_sharded)."""
    from ssnt_tts.ops import lattice_sharded

    U, B, T = le.shape
    ts = lattice_sharded.active_tshard(U, B, T)
    if ts is not None:
        mesh, axis = ts
        return lattice_sharded.ssnt_loss_tsharded(
            le, ls, lf, input_length, output_length, mesh, axis=axis,
        )
    return lattice.ssnt_loss(
        le, ls, lf, input_length, output_length, layout="ubt"
    )


class SSNTModel:
    """The network for one ModelConfig, optionally bound to parameters."""

    def __init__(self, config: ModelConfig, params=None):
        self.config = config
        self.params = params

    @property
    def dtype(self):
        return jnp.dtype(self.config.dtype)

    # ------------------------------------------------------- init / apply

    def init(self, rng, *args, method=None, **kwargs):
        """The parameter pytree (float32 leaves). The arguments a method
        would take are accepted and ignored: every shape follows from the
        config."""
        del args, kwargs, method
        cfg = self.config
        ks = jax.random.split(rng, 8)
        return {
            "encoder": encoder.text_encoder_init(
                ks[0], cfg.vocab_size, cfg.encoder_dim, cfg.encoder_layers
            ),
            "ar_cell": decoder.ar_decoder_cell_init(
                ks[1], cfg.mel_dim, cfg.decoder_dim
            ),
            "transition": decoder.transition_joint_init(
                ks[2], cfg.encoder_dim, cfg.decoder_dim, cfg.joint_rank
            ),
            "frame": decoder.frame_joint_init(
                ks[3], cfg.encoder_dim, cfg.decoder_dim, cfg.mel_dim
            ),
            "duration_head": encoder.class_head_init(
                ks[4], cfg.encoder_dim, cfg.encoder_dim,
                cfg.duration_class_size,
            ),
            "tone_head": encoder.class_head_init(
                ks[5], cfg.encoder_dim, cfg.encoder_dim, cfg.tone_class_size
            ),
            # Per-beam AR class state (reference production path feeds
            # per-beam h (B, W, D) to the v2/tone ops — SURVEY §3.1).
            "duration_ar": encoder.ar_class_cell_init(
                ks[6], cfg.duration_class_size, cfg.encoder_dim,
                cfg.decoder_dim,
            ),
            "tone_ar": encoder.ar_class_cell_init(
                ks[7], cfg.tone_class_size, cfg.encoder_dim, cfg.decoder_dim
            ),
        }

    def apply(self, params, *args, method=None, **kwargs):
        """Run `method` (default `__call__`) with `params`. `method` is a
        method of this class (bound or not) or a function taking the bound
        model first."""
        bound = SSNTModel(self.config, params)
        if method is None:
            return bound(*args, **kwargs)
        fn = getattr(method, "__func__", method)
        return fn(bound, *args, **kwargs)

    def _p(self, name):
        if self.params is None:
            raise ValueError("SSNTModel is unbound: call it through apply()")
        return self.params[name]

    # ------------------------------------------------------------- pieces

    def encode(self, tokens, input_length=None):
        return encoder.text_encoder(
            self._p("encoder"), tokens, input_length,
            self.config.encoder_heads, self.dtype,
        )

    def decoder_states(self, mel_target, *, chunk: int = 8):
        """Teacher-forced AR states: dec[u] summarizes frames < u.

        mel_target (B, U, M) -> (B, U, H); frame 0 sees a zero frame.

        The scan runs over U/chunk outer steps whose body applies the cell
        to `chunk` frames inline, under jax.checkpoint. A plain scan's
        transpose is a length-U loop regardless of `unroll`, so the
        teacher-forced GRU backward would be U sequential thin iterations;
        chunked remat makes it U/chunk iterations of recompute-then-
        differentiate work and stores only chunk-boundary carries.
        """
        B, U, M = mel_target.shape
        p = self._p("ar_cell")
        dtype = self.dtype
        shifted = jnp.concatenate(
            [jnp.zeros((B, 1, M), mel_target.dtype), mel_target[:, :-1]],
            axis=1,
        )
        pad = (-U) % chunk
        if pad:
            shifted = jnp.concatenate(
                [shifted, jnp.zeros((B, pad, M), shifted.dtype)], axis=1
            )
        n = shifted.shape[1] // chunk
        xs = jnp.moveaxis(shifted.reshape(B, n, chunk, M), 1, 0)

        @functools.partial(jax.checkpoint, prevent_cse=False)
        def chunk_body(c, x):
            outs = []
            for j in range(chunk):
                c = decoder.ar_decoder_cell(p, c, x[:, j], dtype)
                outs.append(c)
            return c, jnp.stack(outs, axis=1)

        carry0 = jnp.zeros((B, self.config.decoder_dim), jnp.float32)
        _, dec = jax.lax.scan(chunk_body, carry0, xs)  # (n, B, chunk, H)
        dec = jnp.moveaxis(dec, 0, 1).reshape(B, n * chunk, -1)
        return dec[:, :U]

    def lattice_quantities(self, enc, dec, mel_target):
        """Time-major (U, B, T) (log_emit, log_shift, log_frame)."""
        le, ls = decoder.transition_joint(
            self._p("transition"), enc, dec, self.dtype
        )
        lf = decoder.frame_joint(
            self._p("frame"), enc, dec, mel_target, self.dtype
        )
        return le, ls, lf

    # ------------------------------------------------------------ training

    def __call__(self, tokens, mel_target, input_length=None,
                 output_length=None):
        """Training forward: per-example SSNT NLL (B,)."""
        enc = self.encode(tokens, input_length)
        dec = self.decoder_states(mel_target)
        q = self.lattice_quantities(enc, dec, mel_target)
        return _lattice_loss(*q, input_length, output_length)

    def loss(self, tokens, mel_target, input_length=None, output_length=None,
             duration_target=None, tone_target=None):
        """Total training loss (scalar) + metrics dict.

        Auxiliary heads train from optional targets: durations (B, T) i32 and
        tones (B, T) i32, masked by input_length.
        """
        B, U, M = mel_target.shape
        T = tokens.shape[1]
        enc = self.encode(tokens, input_length)
        dec = self.decoder_states(mel_target)
        q = self.lattice_quantities(enc, dec, mel_target)
        nll = _lattice_loss(*q, input_length, output_length)
        if output_length is None:
            frames = jnp.full((B,), U, jnp.float32)
        else:
            frames = output_length.astype(jnp.float32)
        loss = jnp.mean(nll / jnp.maximum(frames, 1.0))
        metrics = {"nll_per_frame": loss}

        tmask = (
            length_mask(input_length, T)
            if input_length is not None
            else jnp.ones((B, T), bool)
        )
        denom = jnp.maximum(jnp.sum(tmask), 1)
        if duration_target is not None:
            # Teacher-forced AR CE — trains the same per-beam conditioning
            # parameters v2_duration_decode steps with.
            dlogp = self.duration_ar_log_probs(enc, duration_target)
            dur_nll = -jnp.take_along_axis(
                dlogp, duration_target[..., None], axis=-1
            )[..., 0]
            dur_loss = jnp.sum(jnp.where(tmask, dur_nll, 0.0)) / denom
            loss = loss + dur_loss
            metrics["duration_nll"] = dur_loss
        cfg = self.config
        if cfg.use_duration_lattice and output_length is not None:
            # Marginal likelihood over the v2 alignment space
            # (src/v2.rs:119-166): sum over all class sequences whose
            # durations total exactly output_length. Trains the per-position
            # head without needing duration targets.
            dlogp_pos = self._class_log_probs("duration_head", enc)
            dur_lat_nll = lattice.ssnt_duration_loss(
                dlogp_pos, cfg.duration_table, input_length, output_length
            )
            frames_d = output_length.astype(jnp.float32)
            dur_lat = jnp.mean(dur_lat_nll / jnp.maximum(frames_d, 1.0))
            loss = loss + cfg.duration_lattice_weight * dur_lat
            metrics["duration_lattice_nll_per_frame"] = dur_lat
        if tone_target is not None:
            klogp = self.tone_ar_log_probs(enc, tone_target)  # (B, T, K)
            tone_nll = -jnp.take_along_axis(
                klogp, tone_target[..., None], axis=-1
            )[..., 0]
            tone_loss = jnp.sum(jnp.where(tmask, tone_nll, 0.0)) / denom
            loss = loss + tone_loss
            metrics["tone_nll"] = tone_loss
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------- heads

    def _class_log_probs(self, head, enc):
        return jax.nn.log_softmax(
            encoder.class_head_logits(self._p(head), enc, self.dtype),
            axis=-1,
        )

    def duration_log_probs(self, tokens, input_length=None):
        """(B, T, D) per-position log-probs (non-AR; the duration-lattice
        NLL's input and the broadcast decode fallback)."""
        return self._class_log_probs(
            "duration_head", self.encode(tokens, input_length)
        )

    def tone_log_probs(self, tokens, input_length=None):
        """(B, T, K) per-position log-probs."""
        return self._class_log_probs(
            "tone_head", self.encode(tokens, input_length)
        )

    def _ar_class_log_probs(self, head, ar, enc, classes):
        """Teacher-forced AR class log-probs: (B, T) target ids ->
        (B, T, D). Trains the same parameters the per-beam decode steps use,
        so decode-time h is consistent with training."""
        B, T, _ = enc.shape
        hp, ap, dtype = self._p(head), self._p(ar), self.dtype
        base = encoder.class_head_logits(hp, enc, dtype)  # (B, T, D)
        prev = jnp.concatenate(
            [jnp.zeros((B, 1), classes.dtype), classes[:, :-1]], axis=1
        )

        def body(state, xs):
            enc_t, prev_t, base_t = xs
            return encoder.ar_class_cell_step(
                ap, state, enc_t, prev_t, base_t, dtype
            )

        state0 = jnp.zeros((B, self.config.decoder_dim), jnp.float32)
        xs = tuple(jnp.moveaxis(x, 1, 0) for x in (enc, prev, base))
        _, logp = jax.lax.scan(body, state0, xs)
        return jnp.moveaxis(logp, 0, 1)

    def duration_ar_log_probs(self, enc, duration_classes):
        return self._ar_class_log_probs(
            "duration_head", "duration_ar", enc, duration_classes
        )

    def tone_ar_log_probs(self, enc, tone_classes):
        return self._ar_class_log_probs(
            "tone_head", "tone_ar", enc, tone_classes
        )

    def duration_decode_step(self, enc, beam_t, state, prev_class):
        """Per-beam v2 conditioning (reference h input, SURVEY §3.1).

        enc (B, T, H); beam_t (B, W) source positions; state (B, W, H');
        prev_class (B, W) previous predicted duration class.
        Returns (h (B, W, D) log-probs, new_state)."""
        return self._class_decode_step(
            "duration_head", "duration_ar", enc, beam_t, state, prev_class
        )

    def tone_decode_step(self, enc, beam_t, state, prev_class):
        """Per-beam tone conditioning — (h (B, W, K), new_state)."""
        return self._class_decode_step(
            "tone_head", "tone_ar", enc, beam_t, state, prev_class
        )

    def _class_decode_step(self, head, ar, enc, beam_t, state, prev_class):
        B, T, _ = enc.shape
        enc_t = jnp.take_along_axis(
            enc, jnp.clip(beam_t, 0, T - 1)[..., None], axis=1
        )  # (B, W, H)
        base = encoder.class_head_logits(self._p(head), enc_t, self.dtype)
        new_state, h = encoder.ar_class_cell_step(
            self._p(ar), state, enc_t, prev_class, base, self.dtype
        )
        return h, new_state

    # ------------------------------------------------------------- decode

    def synthesize_from_alignment(self, enc, source_indexes):
        """Generate mel frames attending through a decoded alignment map.

        Completes the v2 production path (SURVEY.md §3.3): after
        v2_duration_decode produces frame->source indices, the AR decoder
        walks the frames, attending to enc at each frame's source position.

        enc (B, T, H); source_indexes (B, U) i32 (out-of-range entries
        clipped — callers mask with the true output length).
        Returns mel (B, U, M).
        """
        B, T, H = enc.shape
        src = jnp.clip(source_indexes, 0, T - 1)
        enc_path = jnp.take_along_axis(enc, src[..., None], axis=1)
        cp, fp, dtype = self._p("ar_cell"), self._p("frame"), self.dtype

        def body(carry, enc_t):
            gru_state, prev_mel = carry
            new_state = decoder.ar_decoder_cell(cp, gru_state, prev_mel, dtype)
            mel = decoder.frame_joint_predict(fp, enc_t, new_state, dtype)
            return (new_state, mel), mel

        init = (
            jnp.zeros((B, self.config.decoder_dim), jnp.float32),
            jnp.zeros((B, self.config.mel_dim), jnp.float32),
        )
        _, mel = jax.lax.scan(body, init, jnp.moveaxis(enc_path, 1, 0))
        return jnp.moveaxis(mel, 0, 1)

    def decode_step(self, enc, beam_t, dec_state, prev_mel):
        """One decode step for all beams of all utterances.

        enc (B, T, H); beam_t (B, W) current source positions;
        dec_state (B, W, H) GRU carries; prev_mel (B, W, M).
        Returns (h (B, W, 2) transition log-probs, new dec_state, mel (B,W,M))
        — h feeds ops.beam_v1.beam_search_step.
        """
        enc_t = jnp.take_along_axis(enc, beam_t[..., None], axis=1)
        new_state = decoder.ar_decoder_cell(
            self._p("ar_cell"), dec_state, prev_mel, self.dtype
        )
        h = decoder.transition_joint_step(
            self._p("transition"), enc_t, new_state, self.dtype
        )
        mel = decoder.frame_joint_predict(
            self._p("frame"), enc_t, new_state, self.dtype
        )
        return h, new_state, mel
