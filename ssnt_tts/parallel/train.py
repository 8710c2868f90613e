"""Sharded training step (DP x TP over a Mesh via jit + shardings).

The idiomatic recipe ("pick a mesh, annotate shardings, let XLA insert the
collectives"): inputs carry data-axis shardings, parameters carry model-axis
shardings, the loss is a mean over the global batch — XLA inserts the
gradient psum over "data" and the activation collectives over "model".
Nothing in the step function mentions a collective explicitly.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ssnt_tts.parallel import mesh as mesh_lib
from ssnt_tts.utils.config import TrainConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    step: jax.Array
    params: Any
    opt_state: Any


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(10 * cfg.warmup_steps, cfg.warmup_steps + 1),
    )
    return optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_norm),
        optax.adamw(schedule, weight_decay=cfg.weight_decay),
    )


def init_train_state(model, rng, batch, cfg: TrainConfig) -> TrainState:
    tx = make_optimizer(cfg)

    @jax.jit
    def _init(rng):
        # Init through model.loss with dummy aux targets so every head
        # (duration/tone) creates its parameters, not just the main path.
        tokens = batch["tokens"]
        dummy_dur = jnp.zeros(tokens.shape, jnp.int32)
        dummy_tone = jnp.zeros(tokens.shape, jnp.int32)
        params = model.init(
            rng,
            tokens,
            batch["mel"],
            batch.get("input_length"),
            batch.get("output_length"),
            dummy_dur,
            dummy_tone,
            method=model.loss,
        )
        return TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
        )

    return _init(rng)


def train_step(model, tx, state: TrainState, batch: Dict[str, jax.Array]
               ) -> Tuple[TrainState, Dict[str, jax.Array]]:
    """One optimizer step. Pure; jit/shard at the call site."""

    def loss_fn(params):
        loss, metrics = model.apply(
            params,
            batch["tokens"],
            batch["mel"],
            batch.get("input_length"),
            batch.get("output_length"),
            batch.get("duration_target"),
            batch.get("tone_target"),
            method=model.loss,
        )
        return loss, metrics

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params
    )
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    new_state = TrainState(
        step=state.step + 1, params=new_params, opt_state=new_opt
    )
    metrics = dict(metrics)
    metrics["grad_norm"] = optax.global_norm(grads)
    return new_state, metrics


def make_sharded_train_step(model, tx, mesh: Mesh, state: TrainState):
    """jit the train step with explicit input/output shardings over `mesh`.

    Batch arrays shard over "data"; parameters/optimizer state follow
    mesh_lib.param_sharding (wide matrices over "model", rest replicated).
    Returns (jitted_step, sharded_state).
    """
    param_specs = mesh_lib.param_sharding(mesh, state.params)
    opt_specs = jax.tree.map(
        lambda _: mesh_lib.replicated(mesh), state.opt_state,
        is_leaf=lambda x: isinstance(x, jax.Array),
    )
    state_shardings = TrainState(
        step=mesh_lib.replicated(mesh),
        params=param_specs,
        opt_state=opt_specs,
    )
    data_spec = mesh_lib.data_sharding(mesh)

    sharded_state = jax.device_put(state, state_shardings)

    base_step = partial(train_step, model, tx)
    min_cells = getattr(model.config, "lattice_tshard_min_cells", None)
    if min_cells is not None:
        # Route big lattices to the T-sharded loss (ops/lattice_sharded):
        # the context is active while jit traces the step, which is when
        # the dispatch in models.ssnt._lattice_loss_fn consults it.
        from ssnt_tts.ops import lattice_sharded

        def base_step(state_, batch_, _bs=partial(train_step, model, tx)):
            with lattice_sharded.tshard_lattice(
                mesh, "model", min_cells
            ):
                return _bs(state_, batch_)

    step_fn = jax.jit(
        base_step,
        in_shardings=(state_shardings, data_spec),
        out_shardings=(state_shardings, mesh_lib.replicated(mesh)),
        donate_argnums=(0,),
    )
    return step_fn, sharded_state
