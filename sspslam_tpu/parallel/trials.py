"""Batched multi-episode execution (the data-parallel axis).

The reference's statistical harness is multi-seed trials run one process at
a time (SURVEY.md §4); here a batch of episodes of the same built model —
different input streams (paths, landmark encounters) — runs as ONE vmapped
scan, optionally sharded over a device-mesh 'data' axis.  Each episode
carries its own neuron/synapse/learned-weight state, so online learning is
independent per episode.

Lowering (experiments/dp_probe.py): ONE unbatched ``lax.scan`` whose body
is ``vmap(step)``, with time-major input tables (T, B, size) so each scan
iteration slices a contiguous (B, size) block (vmap-of-scan would slice xs
along a non-leading axis), and parameters device_put once.  Multi-device
deployments shard the batch axis over devices.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..nef.simulator import Simulator

__all__ = ["run_batched_episodes"]


def run_batched_episodes(sim: Simulator, input_tables: List[np.ndarray],
                         n_steps: int, mesh=None, axis: str = "data",
                         model_axis: str = "model", unroll: int = 4):
    """Run B episodes in parallel.

    sim : a built Simulator (its current state is the common starting state).
    input_tables : one (B, n_steps, size) array per tabulated input node, in
        ``sim.model.input_nodes`` order.
    mesh : optional Mesh with a ``data`` axis to shard the batch over chips.
        If the mesh ALSO has a ``model_axis``, data and model parallelism
        compose in one program: episodes shard over ``axis`` while each
        episode's carry shards over ``model_axis`` (VCO bank / neuron /
        learned-weight axes, exactly as in the single-episode
        ``sharding.state_shardings``) — the dp x tp layout of a pod run.

    Returns {probe_object: (B, n_steps, ...)} for dense probes, and leaves
    ``sim`` untouched.
    """
    model = sim.model
    assert len(input_tables) == len(model.input_nodes), (
        f"expected {len(model.input_nodes)} input tables")
    B = input_tables[0].shape[0] if input_tables else 1
    step = sim._step_fn
    vstep = jax.vmap(step, in_axes=(0, 0, None))

    def scan_fn(state, xs_cols, params):
        def body(carry, xs):
            return vstep(carry, xs, params)
        return jax.lax.scan(body, state, xs_cols, length=n_steps,
                            unroll=max(1, min(unroll, n_steps)))

    if mesh is not None:
        from .sharding import replicated, state_shardings
        from jax.sharding import NamedSharding, PartitionSpec as P
        if model_axis in mesh.shape and mesh.shape[model_axis] > 1:
            # dp x tp: prepend the episode axis to each leaf's model spec
            base = state_shardings(model, mesh, axis=model_axis)
            state_sh = jax.tree_util.tree_map(
                lambda ns: NamedSharding(mesh, P(axis, *ns.spec)), base)
        else:
            batch_sh = NamedSharding(mesh, P(axis))
            state_sh = jax.tree_util.tree_map(
                lambda _: batch_sh, sim.model.initial_state())
        # time-major xs: batch is axis 1
        xs_sh = [NamedSharding(mesh, P(None, axis))] * len(input_tables)
        params_sh = jax.tree_util.tree_map(lambda _: replicated(mesh),
                                           sim.params)
        run = jax.jit(scan_fn, in_shardings=(state_sh, xs_sh, params_sh))
    else:
        run = jax.jit(scan_fn)

    state0 = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(),
        sim.state)
    # (B, T, s) -> time-major (T, B, s): each scan step reads a contiguous
    # (B, s) block instead of a strided gather
    xs = [jnp.asarray(np.swapaxes(np.asarray(tab, np.float32), 0, 1))
          for tab in input_tables]
    params_dev = (jax.device_put(sim.params) if mesh is None else sim.params)
    final_state, emits = run(state0, xs, params_dev)

    out = {}
    for bp in model.probes:
        if bp.sparse:
            continue
        v = np.swapaxes(np.asarray(emits[bp.index]), 0, 1)  # -> (B, n_steps, ...)
        if bp.period_steps > 1:
            v = v[:, bp.period_steps - 1::bp.period_steps]
        out[bp.obj] = v
    return out, final_state


def run_seed_sweep(sims, n_steps: int, segment_steps: int = 1000):
    """Multi-seed trial sweep on one device: run each built Simulator's
    episode SEQUENTIALLY through a single compiled program.

    All sims must share the same network structure (different seeds/params/
    inputs are fine — parameters are traced arguments, so the jitted scan
    from the first sim is reused for every other with zero recompilation).
    Differently-SEEDED models have different parameters, which the batched
    path cannot share, so this sequential sweep is the tool for seed sweeps;
    for many episodes of ONE built model, ``run_batched_episodes`` is
    faster (one vmapped scan for all episodes).

    Returns a list of {probe_object: (n_steps, ...)} per sim.
    """
    lead = sims[0]
    results = []
    for sim in sims:
        run_segment = lead._get_scan(min(segment_steps, n_steps))
        packed = Simulator._pack_cols(sim._tabulate_inputs(n_steps))
        done = 0
        emits_chunks = {bp.index: [] for bp in sim.model.probes
                        if not bp.sparse}
        state = sim.state
        while done < n_steps:
            seg = min(segment_steps, n_steps - done)
            if seg != segment_steps:
                run_segment = lead._get_scan(seg)
            xs = packed[done:done + seg]
            state, emits = run_segment(state, xs, sim.params)
            for k in emits_chunks:
                emits_chunks[k].append(emits[k])
            done += seg
        sim.state = state
        sim.n_steps += n_steps
        out = {}
        for bp in sim.model.probes:
            if bp.sparse:
                continue
            v = np.concatenate([np.asarray(c) for c in emits_chunks[bp.index]])
            if bp.period_steps > 1:
                v = v[bp.period_steps - 1::bp.period_steps]
            out[bp.obj] = v
        results.append(out)
    return results
