"""Multi-chip execution: mesh construction and carry/param shardings.

The reference's only multi-device story is Loihi's 15-chip place-and-route
(run_slam.py:205-210).  The counterpart here (SURVEY.md §5) shards the
*model state itself* over a device mesh with GSPMD:

* the (d+1)//2 independent VCOs of the path integrator — a tensor-parallel
  axis needing communication only at the d-wide Fourier reassembly matvec
  (an all-reduce XLA inserts automatically);
* neuron axes of large single ensembles (memory / OVC / error populations)
  — decoded outputs are psum-reductions over neuron shards;
* learned PES/Voja weight matrices along their neuron axis (the outer-product
  updates are local to each shard);
* an optional data axis vmapping independent trials (multi-seed episodes,
  the reference's statistical harness) across chips.

Everything goes through ``jax.sharding`` + jit: we annotate the carry, XLA
inserts the collectives and partitions the einsums.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..nef.builder import Model

__all__ = ["make_mesh", "state_shardings", "shard_state", "replicated"]


def make_mesh(n_devices: Optional[int] = None, axis_names=("model",),
              shape=None) -> Mesh:
    """Build a device mesh. Default: 1-D 'model' axis over all devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = np.asarray(devs[:n_devices])
    if shape is None:
        shape = (n_devices,)
    return Mesh(devs.reshape(shape), axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _shard_leading(mesh: Mesh, axis: str, ndim: int, size0: int,
                   min_size: int = 2, size1: int = 0) -> NamedSharding:
    """Shard the leading axis over ``axis`` when it is worth it, falling
    back to axis 1 (e.g. the NEURON axis of a small-k fused-singles group
    like the k=3 memory/error/recall trio, whose n is mesh-padded).

    device_put requires divisibility; axes divisible by neither stay
    replicated at rest (GSPMD still partitions the einsums inside jit)."""
    n = mesh.shape[axis]
    if size0 >= max(n, min_size) and size0 % n == 0:
        spec = [axis] + [None] * (ndim - 1)
        return NamedSharding(mesh, P(*spec))
    if ndim >= 2 and size1 >= max(n, min_size) and size1 % n == 0:
        spec = [None, axis] + [None] * (ndim - 2)
        return NamedSharding(mesh, P(*spec))
    return replicated(mesh)


def state_shardings(model: Model, mesh: Mesh, axis: str = "model"):
    """Sharding pytree matching ``model.initial_state()``.

    Batched ensemble groups (EnsembleArrays — the VCO bank, the circular-
    convolution product arrays) shard over their element axis; large single
    ensembles shard over neurons; learned weights shard over their neuron
    axis; small filters replicate."""
    neurons = []
    for be in model.ensembles:
        spec = {}
        proto = be.neuron_type.init_state((be.k, be.n) if be.batched else (be.n,))
        for key, val in proto.items():
            spec[key] = _shard_leading(
                mesh, axis, val.ndim,
                val.shape[0] if val.ndim else 1,
                size1=val.shape[1] if val.ndim >= 2 else 0)
        neurons.append(spec)

    filters = []
    for shape, _a, _b in model.filter_specs:
        if len(shape) >= 2:
            filters.append(_shard_leading(mesh, axis, len(shape), shape[0],
                                          size1=shape[1]))
        elif len(shape) == 1 and shape[0] >= 4 * mesh.shape[axis]:
            filters.append(_shard_leading(mesh, axis, 1, shape[0]))
        else:
            filters.append(replicated(mesh))

    learned = {}
    for key, val in model.learned_init.items():
        learned[key] = _shard_leading(mesh, axis, np.ndim(val),
                                      np.shape(val)[0])

    return {
        "step": replicated(mesh),
        "neurons": neurons,
        "filters": filters,
        "learned": learned,
        # stateful-node scratch (latches/timers): tiny, replicate
        "nodes": {k: replicated(mesh)
                  for k in model.node_state_init},
    }


def shard_state(model: Model, state, mesh: Mesh, axis: str = "model"):
    """device_put the carry according to :func:`state_shardings`."""
    shardings = state_shardings(model, mesh, axis)
    return jax.tree_util.tree_map(jax.device_put, state, shardings)


def _group_axis(mesh: Mesh, axis: str, be) -> Optional[int]:
    """Which axis of ensemble ``be``'s (k, n) state the carry shards over
    (mirrors :func:`_shard_leading` on the neuron-state proto): 0 = the
    element axis, 1 = the neuron axis, None = replicated.  Parameter
    shardings must MATCH this choice or GSPMD inserts reshardings."""
    n_dev = mesh.shape[axis]
    if be.batched:
        if be.k >= max(n_dev, 2) and be.k % n_dev == 0:
            return 0
        if be.n >= max(n_dev, 2) and be.n % n_dev == 0:
            return 1
        return None
    if be.n >= max(n_dev, 2) and be.n % n_dev == 0:
        return 0
    return None


def _spec_for(mesh, axis, shape, shard_axis) -> NamedSharding:
    n_dev = mesh.shape[axis]
    if (shard_axis is None or shard_axis >= len(shape)
            or shape[shard_axis] % n_dev != 0
            or shape[shard_axis] < n_dev):
        # fused-EA MEMBER decoders are row-slices of the padded group (a
        # (13, n, d) slice of a k=16 bank) — indivisible slices replicate
        return replicated(mesh)
    spec = [None] * len(shape)
    spec[shard_axis] = axis
    return NamedSharding(mesh, P(*spec))


def _maybe_q(mesh, axis, param, shard_axis):
    """Sharding entry for a param that may be a quantised QTensor: the
    int8 payload shards like the full-precision array; the per-slice
    scale drops the contracted axis, so its sharding drops that axis too
    (replicated when the shard axis WAS the contracted one)."""
    from ..ops.quantize import QTensor
    if isinstance(param, QTensor):
        q_sh = _spec_for(mesh, axis, param.q.shape, shard_axis)
        if (shard_axis is None or shard_axis == param.caxis
                or param.q.shape[shard_axis] % mesh.shape[axis] != 0):
            s_ax = None
        else:
            s_ax = shard_axis - (1 if shard_axis > param.caxis else 0)
        s_sh = _spec_for(mesh, axis, np.shape(param.s), s_ax)
        return QTensor(q_sh, s_sh, param.caxis)
    return _spec_for(mesh, axis, np.shape(param), shard_axis)


def params_shardings(params, mesh: Mesh, axis: str = "model", model=None):
    """Shardings for the traced parameter pytree.

    Without ``model``: replicated, except large hoisted 2-D banks (the
    clean-up sample bank under SSPSLAM_HOIST_CLEANUP=1) which shard over
    rows.

    With ``model``: the LARGE static banks — encoders, solved decoders,
    batched transform/decode stacks — shard along the same axis the
    ensemble's carry shards over (element axis of the VCO bank, neuron
    axis of the big memory/OVC populations).  This is what makes TP
    divide the parameter-read HBM bytes: at the HBM-bound scale (d>=385
    single-episode) the binding resource is parameter reads, and a
    replicated-at-rest bank is read in full by every device (measured
    d=727: per-device FLOPs 1.05x ideal but BYTES 1.92x at mesh 2 before
    this; see docs/MULTICHIP.md round-5 table for after)."""
    rep = replicated(mesh)
    sh = jax.tree_util.tree_map(lambda _: rep, params)
    n = mesh.shape[axis]
    for key, d in params.get("hoisted", {}).items():
        for k2, v in d.items():
            if (np.ndim(v) == 2 and np.shape(v)[0] >= n
                    and np.shape(v)[0] % n == 0):
                sh["hoisted"][key][k2] = NamedSharding(mesh, P(axis, None))
    if model is None:
        return sh

    from ..nef.executor import (_ea_batch_decode_groups,
                                _elem_decode_groups)

    gaxis = {be.index: _group_axis(mesh, axis, be)
             for be in model.ensembles}
    for i, be in enumerate(model.ensembles):
        ga = gaxis[be.index]
        ep = params["ens"][i]
        # scaled_encoders (k, n, d) / (n, d): shard like the neuron state
        sh["ens"][i]["scaled_encoders"] = _maybe_q(
            mesh, axis, ep["scaled_encoders"], ga)
        for k2 in ("bias", "gain"):     # (k, n) / (n,)
            sh["ens"][i][k2] = _spec_for(mesh, axis, np.shape(ep[k2]), ga)
    for bc in model.connections:
        entry = params["conn"].get(str(bc.index), {})
        if "D" in entry and getattr(bc.pre, "index", None) is not None:
            ga = gaxis.get(bc.pre.index)
            d_param = entry["D"]
            nd = (d_param.q.ndim if hasattr(d_param, "q")
                  else np.ndim(d_param))
            if bc.pre_kind == "ea_batch" and nd == 3:
                sh["conn"][str(bc.index)]["D"] = _maybe_q(
                    mesh, axis, d_param, ga)
            elif nd == 2 and not be_batched(bc.pre):
                # single-ensemble decoders (n, d): shard the neuron axis
                sh["conn"][str(bc.index)]["D"] = _maybe_q(
                    mesh, axis, d_param, 0 if ga == 0 else None)
        if "W" in entry and bc.full_weights \
                and getattr(bc.pre, "index", None) is not None:
            ga = gaxis.get(bc.pre.index)
            w = entry["W"]
            nd = w.q.ndim if hasattr(w, "q") else np.ndim(w)
            if nd == 3:     # (k, n, m) per-element full weights
                sh["conn"][str(bc.index)]["W"] = _maybe_q(mesh, axis, w, ga)
    # batched decode stacks: (g, n, d) elem groups follow the pre group's
    # NEURON axis (stacked acts are (g, n)); (k, n, d) fused-EA layered
    # stacks follow the pre group's element axis
    for key, bcs in _elem_decode_groups(model).items():
        ga = gaxis.get(bcs[0].pre.index)
        sh["dstack"][key] = _maybe_q(
            mesh, axis, params["dstack"][key], 1 if ga == 1 else None)
    for key, bcs in _ea_batch_decode_groups(model).items():
        ga = gaxis.get(bcs[0].pre.index)
        sh["dstack"][key] = _maybe_q(
            mesh, axis, params["dstack"][key], ga)
    for bp in model.probes:
        entry = params["probe"].get(str(bp.index), {})
        if "D" in entry and getattr(bp.target, "index", None) is not None:
            ga = gaxis.get(bp.target.index)
            d_param = entry["D"]
            nd = (d_param.q.ndim if hasattr(d_param, "q")
                  else np.ndim(d_param))
            if nd == 2 and not be_batched(bp.target) and ga == 0:
                sh["probe"][str(bp.index)]["D"] = _maybe_q(
                    mesh, axis, d_param, 0)
    return sh


def be_batched(be) -> bool:
    return bool(getattr(be, "batched", False))
