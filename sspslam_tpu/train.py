"""Gradient-based training through the simulator (the nengo_dl analog).

The engine's per-dt update is already a pure function
``step(state, xs, params)`` with every weight — scaled encoders, solved
decoders, connection transforms — in the traced ``params`` pytree
(nef/executor.py:build_params).  That makes end-to-end backprop a
composition, not a feature port:

* :func:`make_episode_fn` closes a whole episode (``lax.scan`` over the
  step) into a differentiable ``episode(params, xs, state0)``, with
  sqrt-T rematerialisation — the time axis is split into segments, each
  segment scan wrapped in ``jax.checkpoint`` so the backward pass stores
  only segment-boundary carries and recomputes activations within a
  segment (memory ``O(T/S · state + S · activations)`` instead of
  ``O(T · activations)``);
* :class:`~sspslam_tpu.nef.SurrogateLIF` makes spiking dynamics
  differentiable: forward bit-equal to ``LIF``, fast-sigmoid surrogate
  through the spike threshold in the backward pass.  Rate-based training
  (nengo_dl's default) is ``Simulator(net, default_neuron_type=LIFRate())``;
* :func:`fit` runs an optax loop over any subset of the parameter tree
  selected by path predicate (train just one connection's decoders, all
  encoders, ...), holding the rest frozen.

The reference stack has no trainable-by-backprop path at all (its decoder
weights come from lstsq solves and PES; nengo_dl fills this role in the
nengo ecosystem but is not part of the reference).  This module is a
capability the functional-step design gives for free and is therefore
*additive* to parity — nothing in experiments/ depends on it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_episode_fn", "make_batched_episode_fn", "episode_inputs",
           "batched_initial_state", "probe_index", "connection_param_path",
           "learning_rate_path", "partition_params", "merge_params", "fit"]


def probe_index(sim, probe) -> int:
    """Emit-dict key of ``probe`` in the episode outputs."""
    bp = next(p for p in sim.model.probes if p.obj is probe)
    return bp.index


def connection_param_path(sim, conn) -> str:
    """Params-tree path of a Connection's solved decoders ("conn/<i>/D"),
    for use as a :func:`partition_params` / :func:`fit` trainable
    predicate target.

    Raises for connections whose decoders the step consumes via a batched
    ``dstack`` group einsum instead of the individual leaf (the leaf still
    exists for weight probes, but training it would be a silent no-op)."""
    from .nef.executor import _ea_batch_decode_groups, _elem_decode_groups
    bc = next(c for c in sim.model.connections if c.obj is conn)
    if bc.decoders is None:
        raise ValueError("connection has no decoders (direct/transform-only)")
    if bc.learned_slot is not None:
        # learned (PES/Voja) decoders live in the scan CARRY, not the params
        # tree — build_params emits no conn/<i>/D leaf for them, so the
        # returned path would select nothing and fit() would silently train
        # an empty subset
        raise ValueError(
            f"connection conn/{bc.index} is learned online (PES/Voja): its "
            "decoders are scan-carry state, not a params leaf; tune the "
            "rule through the online dynamics instead via "
            "learning_rate_path(sim, conn)")
    for groups in (_elem_decode_groups(sim.model),
                   _ea_batch_decode_groups(sim.model)):
        for key, bcs in groups.items():
            if any(b is bc for b in bcs):
                raise ValueError(
                    f"connection's decoders are consumed via the batched "
                    f"group einsum dstack/{key} (rows shared with "
                    f"{len(bcs) - 1} other connection(s)); training the "
                    f"individual conn/{bc.index}/D leaf would not affect "
                    f"the step")
    return f"conn/{bc.index}/D"


def learning_rate_path(sim, conn) -> str:
    """Params-tree path of a learned Connection's PES/Voja learning rate
    ("hyper/lr/<slot>").  Learning rates are traced scalars consumed inside
    the in-scan weight updates, so selecting this path in :func:`fit` does
    gradient-based hyperparameter optimisation THROUGH the online learning
    dynamics (meta-learning) — no reference counterpart."""
    bc = next(c for c in sim.model.connections if c.obj is conn)
    if bc.learned_slot is None:
        raise ValueError("connection has no PES/Voja learning rule")
    return f"hyper/lr/{bc.learned_slot}"


def episode_inputs(sim, n_steps: int) -> np.ndarray:
    """Packed ``(n_steps, sum input widths)`` host table of the network's
    tabulated input nodes, starting at the simulator's current step."""
    return sim._pack_cols(sim._tabulate_inputs(n_steps))


def _make_episode(sim, n_steps: int, segment_steps: Optional[int],
                  remat: bool, batched: bool):
    """Shared lowering of :func:`make_episode_fn` (``batched=False``) and
    :func:`make_batched_episode_fn` (``batched=True``): an outer scan over
    segments, each segment's scan optionally wrapped in ``jax.checkpoint``;
    the batched variant scans ``vmap(step)`` over time-major inputs."""
    step = sim._step_fn
    splits = sim._input_splits()
    width = sum(n.size_out for n in sim.model.input_nodes)
    if segment_steps is None:
        segment_steps = min(n_steps, 100)
    seg = int(segment_steps)
    if n_steps % seg:
        raise ValueError(
            f"n_steps={n_steps} must be a multiple of segment_steps={seg} "
            "(the remat scan needs equal segments)")
    n_seg = n_steps // seg
    body_step = jax.vmap(step, in_axes=(0, 0, None)) if batched else step

    def seg_fn(state, xs_seg, params):
        # xs_seg: (seg, width) or time-major (seg, B, width)
        cols = [xs_seg[..., a:b] for a, b in splits]

        def body(carry, xs):
            return body_step(carry, xs, params)
        return jax.lax.scan(body, state, cols, length=seg)

    if remat:
        seg_fn = jax.checkpoint(seg_fn)

    def episode(params, xs_packed, state0):
        xs_packed = jnp.asarray(xs_packed, jnp.float32)
        if batched:
            B = xs_packed.shape[0]
            # (B, T, w) -> (n_seg, seg, B, w)
            xs = jnp.moveaxis(xs_packed, 0, 1).reshape(n_seg, seg, B, width)
        else:
            xs = xs_packed.reshape(n_seg, seg, width)

        def outer(carry, xs_seg):
            return seg_fn(carry, xs_seg, params)

        final_state, emits = jax.lax.scan(outer, state0, xs)

        def fix(e):
            e = e.reshape((n_steps,) + e.shape[2:])
            # time-major back to (B, n_steps, ...)
            return jnp.moveaxis(e, 0, 1) if batched else e
        emits = jax.tree_util.tree_map(fix, emits)
        return final_state, emits

    return episode


def make_episode_fn(sim, n_steps: int, segment_steps: Optional[int] = None,
                    remat: bool = True):
    """Build ``episode(params, xs_packed, state0) -> (final_state, emits)``.

    ``emits`` maps probe index (see :func:`probe_index`) to the
    ``(n_steps, ...)`` probe trace; both outputs are differentiable w.r.t.
    ``params`` (and ``xs_packed``).  ``state0`` defaults are NOT baked in —
    pass ``sim.model.initial_state()`` (or a checkpointed carry) so one
    compiled episode serves warm starts.

    ``segment_steps`` controls the remat granularity: the backward pass
    keeps one carry per segment and recomputes inside.  For a carry of
    size C and per-step activation residuals of size A, peak memory is
    ``(n_steps/S)·C + S·A`` — minimised near ``S = sqrt(n_steps·C/A)``;
    the default 100 is a good setting for the model scales in tests/
    experiments.  With ``remat=False`` the plain scan stores all residuals
    (fastest, memory ``O(n_steps·A)``).
    """
    return _make_episode(sim, n_steps, segment_steps, remat, batched=False)


def batched_initial_state(sim, batch: int):
    """``sim.model.initial_state()`` broadcast to a leading episode axis —
    the ``state0`` of a :func:`make_batched_episode_fn` episode."""
    return jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (batch,) + np.shape(x)).copy(),
        sim.model.initial_state())


def make_batched_episode_fn(sim, n_steps: int,
                            segment_steps: Optional[int] = None,
                            remat: bool = True):
    """Batched (data-parallel) variant of :func:`make_episode_fn`.

    Returns ``episode(params, xs_packed, state0) -> (final_state, emits)``
    where ``xs_packed`` is ``(B, n_steps, width)`` (one packed input table
    per episode — :func:`episode_inputs` rows, stacked), ``state0`` has a
    leading episode axis on every leaf (:func:`batched_initial_state`), and
    ``emits`` maps probe index to ``(B, n_steps, ...)``.

    Lowering matches ``parallel.trials.run_batched_episodes``: ONE scan over
    time whose body is ``vmap(step)``, inputs transposed time-major inside
    the jitted program so each step reads a contiguous ``(B, width)`` block.
    Under a mesh, shard ``xs``/``state0`` along the episode axis and
    replicate ``params`` (see :func:`fit`'s ``mesh`` argument) — the
    backward pass then yields data-parallel gradients with XLA inserting
    the single all-reduce.
    """
    return _make_episode(sim, n_steps, segment_steps, remat, batched=True)


# ---------------------------------------------------------------------------
# Parameter partitioning: train a path-selected subset, freeze the rest
# ---------------------------------------------------------------------------

def _path_str(path) -> str:
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def partition_params(params, predicate: Callable[[str], bool]):
    """Split the params pytree into ``(trainable, frozen)`` by a predicate
    on slash-joined leaf paths (e.g. ``"conn/3/D"``, ``"ens/0/bias"``,
    ``"ens/1/scaled_encoders"``).  Both trees have the full structure with
    ``None`` at the complementary leaves; recombine with
    :func:`merge_params`."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    treedef = jax.tree_util.tree_structure(params)
    t_leaves, f_leaves = [], []
    for path, leaf in flat:
        if predicate(_path_str(path)):
            t_leaves.append(leaf)
            f_leaves.append(None)
        else:
            t_leaves.append(None)
            f_leaves.append(leaf)
    return (jax.tree_util.tree_unflatten(treedef, t_leaves),
            jax.tree_util.tree_unflatten(treedef, f_leaves))


def merge_params(trainable, frozen):
    """Inverse of :func:`partition_params` (leaf-wise first-non-None)."""
    return jax.tree_util.tree_map(
        lambda t, f: f if t is None else t,
        trainable, frozen, is_leaf=lambda x: x is None)


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def fit(episode, params, xs, state0,
        loss_fn: Callable[[Dict[int, jax.Array], dict], jax.Array],
        trainable: Callable[[str], bool],
        optimizer=None, steps: int = 100,
        callback: Optional[Callable[[int, float], None]] = None,
        mesh=None, batch_axis: str = "data", keep_best: bool = False
        ) -> Tuple[dict, list]:
    """Minimise ``loss_fn(emits, final_state)`` over the path-selected
    parameter subset with optax (Adam 1e-3 by default).

    Returns ``(updated full params, per-step losses)``.  The update step is
    jitted once; every iteration is a single device program (forward scan,
    rematerialised backward, optimizer update).

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``batch_axis`` axis for
    data-parallel training of a :func:`make_batched_episode_fn` episode —
    ``xs`` (``(B, T, width)``) and ``state0`` (leading episode axis) are
    sharded along ``batch_axis``; the trainable/frozen parameters and
    optimizer state are replicated.  The computation follows the data:
    each device runs its episode shard, and GSPMD inserts ONE gradient
    all-reduce per update (the canonical DP layout — gradients cross devices,
    parameters never move).  Results are numerically the unsharded batched
    fit (same loss sequence up to reduction order).

    Learning-rate scale: Adam's per-coordinate step is ~the learning rate
    itself, and NEF decoder weights are small (O(1e-3) for a population
    decoding an O(1) signal) — a 5e-3 rate OVERSHOOTS decoders by >1x per
    iteration and diverges.  Start around 1e-4..1e-3 when training
    decoder-scale leaves; encoder-scale leaves (O(1)) tolerate more.
    """
    import optax
    if optimizer is None:
        optimizer = optax.adam(1e-3)

    train_p, frozen_p = partition_params(params, trainable)
    train_p = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), train_p)
    opt_state = optimizer.init(train_p)
    xs = jnp.asarray(xs, jnp.float32)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if batch_axis not in mesh.shape:
            raise ValueError(f"mesh has no '{batch_axis}' axis: {mesh}")
        repl = NamedSharding(mesh, P())
        batched = NamedSharding(mesh, P(batch_axis))
        xs = jax.device_put(xs, batched)
        state0 = jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), batched), state0)
        train_p = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, repl), train_p)
        frozen_p = jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), repl), frozen_p)
        opt_state = jax.device_put(opt_state, repl)

    def loss_of(tp):
        full = merge_params(tp, frozen_p)
        final_state, emits = episode(full, xs, state0)
        return loss_fn(emits, final_state)

    @jax.jit
    def update(tp, opt_state):
        loss, grads = jax.value_and_grad(loss_of)(tp)
        updates, opt_state = optimizer.update(grads, opt_state, tp)
        tp = optax.apply_updates(tp, updates)
        return tp, opt_state, loss

    losses = []
    best_tp, best_loss = None, float("inf")
    for i in range(steps):
        prev_tp = train_p
        train_p, opt_state, loss = update(train_p, opt_state)
        losses.append(float(loss))   # loss at prev_tp (pre-update)
        if keep_best and losses[-1] < best_loss:
            best_loss, best_tp = losses[-1], prev_tp
        if callback is not None:
            callback(i, losses[-1])
    if keep_best:
        # the final iterate was never evaluated in the loop
        final_loss = float(jax.jit(loss_of)(train_p))
        if final_loss < best_loss:
            best_loss, best_tp = final_loss, train_p
        if best_tp is None:
            # every evaluated loss was non-finite; fall back to the last
            # iterate rather than returning a tree with holes
            best_tp = train_p
        return merge_params(best_tp, frozen_p), losses
    return merge_params(train_p, frozen_p), losses
