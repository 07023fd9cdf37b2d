"""Sharding rules and the sharded train steps (port of
``ml_audio_inpainting_tpu/parallel/sharding.py``).

Layout, as the JAX package's: the batch is split over ``data`` and the
parameters replicated across it; over ``model``, the only matrices worth
splitting at this model scale are the BiLSTM's layer-0 input projections
``w_ih`` (``freq_bins * hidden / 2`` rows, 16448 x 512 at full width) and
the dense ``projection`` (4112 outputs), each split on its large dimension
when it is at least :data:`_TP_MIN_DIM` and divides by the model width.
Everything else is replicated.  The rules go by name and shape, on the
port's layout: the port keeps JAX's ``(in, out)`` ``w_ih``, and torch's
``nn.Linear`` weight is ``(out, in)``, so both split ``dim 0``.

A state is placed (:func:`place_state`: each rank keeps its block of a
sharded parameter, of its Adam moments and of its EMA) and gathered back
(:func:`gather_state`: the one-device checkpoint tree, for saves) in
place of JAX's ``device_put``; :func:`make_sharded_step` runs a step
inside :func:`~ml_audio_inpainting_torch.parallel.collectives.use_mesh`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from ml_audio_inpainting_torch.parallel.collectives import all_gather_cat, use_mesh
from ml_audio_inpainting_torch.parallel.mesh import REPLICATED, Mesh, Sharding

__all__ = ["param_sharding_rules", "state_shardings", "make_sharded_step", "place_state",
           "gather_state"]

# Minimum size of a dimension before tensor-sharding it pays for the
# collectives it induces.
_TP_MIN_DIM = 1024
ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")


def param_sharding_rules(mesh: Mesh) -> Callable[[str, torch.Tensor], Sharding]:
    """``rule(name, tensor) -> Sharding`` for one parameter of the port."""
    model_size = mesh.shape["model"]

    def rule(name: str, leaf: torch.Tensor) -> Sharding:
        if model_size == 1 or leaf.ndim < 2:
            return REPLICATED
        wide = leaf.shape[0] >= _TP_MIN_DIM and leaf.shape[0] % model_size == 0
        # BiLSTM input projection (in, 4H): shard the wide input dim.  Dense
        # projection (out, in): shard the wide output dim.
        if wide and ("w_ih" in name or "projection" in name):
            return Sharding("model", 0)
        return REPLICATED

    return rule


def _states(state: Any):
    """The train states in ``state``: one (a dataclass with ``model``), or a
    mapping or tuple of them."""
    if isinstance(state, Mapping):
        return list(state.values())
    if isinstance(state, (tuple, list)):
        return list(state)
    return [state]


def state_shardings(state: Any, mesh: Mesh):
    """``{parameter name: Sharding}`` of a train state's model (a list of
    them for a mapping or tuple of states).  Adam's moments and the EMA
    follow their parameter."""
    rule = param_sharding_rules(mesh)
    out = [{n: rule(n, p) for n, p in s.model.named_parameters()} for s in _states(state)]
    return out if isinstance(state, (Mapping, tuple, list)) else out[0]


def _sharded(state, mesh: Mesh) -> Dict[str, Sharding]:
    """The model-split parameters of one (unplaced) train state."""
    rule = param_sharding_rules(mesh)
    return {n: s for n, p in state.model.named_parameters() if (s := rule(n, p)).axis}


def place_state(state: Any, mesh: Mesh) -> Any:
    """Keep this rank's block of every sharded parameter of ``state`` (a
    full one-device state, fresh or restored), of its Adam moments and of
    its EMA, in place, and record the split parameters in the state's
    ``shardings``; returns ``state``."""
    for s in _states(state):
        if s.shardings:
            raise ValueError("the state is placed already")
        params = dict(s.model.named_parameters())
        s.shardings = _sharded(s, mesh)
        for name, sharding in s.shardings.items():
            p = params[name]
            slot = s.optimizer.state.get(p, {})
            for k in ADAM_MOMENTS:
                if k in slot:
                    slot[k] = sharding.local(slot[k], mesh).clone()
            if s.ema_params is not None:
                s.ema_params[name] = sharding.local(s.ema_params[name], mesh).clone()
            p.data = sharding.local(p.data, mesh).clone()
    return state


def gather_state(state: Any, mesh: Mesh) -> Any:
    """The checkpoint tree of ``state``
    (:func:`~ml_audio_inpainting_torch.train.checkpoints.state_tree`: CPU
    copies in the one-device layout) with every sharded parameter, Adam
    moment and EMA gathered over ``model``.  Collective: every rank of the
    mesh calls it."""
    from ml_audio_inpainting_torch.train.checkpoints import state_tree

    if isinstance(state, Mapping):
        return {k: gather_state(v, mesh) for k, v in state.items()}
    tree = state_tree(state)
    if not state.shardings:
        return tree
    group = mesh.group("model")
    names = [n for n, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    opt_state = tree["optimizer"]["state"]
    for name, sharding in state.shardings.items():
        p = params[name]
        tree["model"][name] = all_gather_cat(p.detach(), group, sharding.dim).cpu()
        slot = state.optimizer.state.get(p, {})
        for k in ADAM_MOMENTS:
            if k in slot:
                full = all_gather_cat(slot[k], group, sharding.dim).cpu()
                opt_state[names.index(name)][k] = full
        if state.ema_params is not None:
            tree["ema_params"][name] = all_gather_cat(state.ema_params[name], group,
                                                      sharding.dim).cpu()
    return tree


def make_sharded_step(step_fn: Callable, state_template: Any, mesh: Mesh) -> Callable:
    """``step_fn`` (a train or eval step of either family) over ``mesh``: it
    takes the states placed by :func:`place_state` and this rank's rows of
    the global batch (:func:`~ml_audio_inpainting_torch.parallel.mesh.shard_batch`)
    and computes the one-device step of the global batch, its collectives
    over ``mesh``'s groups.  ``state_template`` is JAX's argument, from
    which it derives the shardings; here the placed state carries its own
    (:func:`state_shardings` of the template gives them)."""
    if not mesh.is_member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.ranks}")

    def step(*args, **kwargs):
        with use_mesh(mesh):
            return step_fn(*args, **kwargs)

    return step
