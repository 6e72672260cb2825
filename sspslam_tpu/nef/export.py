"""AOT serving export: ship a compiled model, not a Python graph.

The reference stack has no deployment story — every process that runs a
model re-executes the Python network construction and the nengo build
(decoder solving) before it can step (reference
``experiments/run_slam.py:171-210``).  For production serving that is all
dead weight: the serving process needs only the compiled step function,
the solved parameters, and the initial state.

``save_bundle(sim, path)`` serializes exactly that:

- ``step.jaxexport`` — the jitted scan segment lowered to StableHLO via
  :mod:`jax.export` (portable across processes and jax minor versions,
  and across platforms when ``platforms=[...]`` is given at export time);
- ``arrays.npz`` — the params pytree (solved decoders / encoders /
  gains / biases) and the initial scan carry;
- ``meta.json`` — dt, segment length, input-node column splits, and
  dense-probe descriptors.

``ServingModel(path)`` loads the bundle and steps it — **no model graph,
no builder, no decoder solving** — so a fleet of serving workers can load
one artifact built once on a dev box.  Learned state (PES decoders, Voja
encoders) lives in the carry, so a bundle whose carry was saved after
training ships the learned map with it; :meth:`ServingModel.load_state`
swaps in any later :meth:`Simulator.save_checkpoint` file.

Mesh-sharded Simulators export SHARDED bundles: the mesh geometry and
per-leaf ``PartitionSpec``s are recorded in ``meta.json``, and the serving
process rebuilds the mesh (same device count required) and jit-wraps the
exported program with the recorded shardings — multi-chip tensor-parallel
serving from the same single artifact.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import jax
import numpy as np

__all__ = ["save_bundle", "ServingModel"]


def _need_flatbuffers():
    """``jax.export`` (de)serialization imports the pure-Python
    ``flatbuffers`` runtime.  Where no such package is installed, the copy
    vendored in ``sspslam_tpu/_vendor`` goes on the import path."""
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        sys.path.append(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "_vendor"))


# ---------------------------------------------------------------------------
# JSON-portable pytree (de)construction — no pickle in the artifact.
def _flatten(x, leaves: list):
    from ..ops.quantize import QTensor
    if isinstance(x, QTensor):
        # quantised param (int8 payload + f32 scales + static caxis)
        return {"t": "qtensor", "caxis": x.caxis,
                "c": [_flatten(np.asarray(x.q), leaves),
                      _flatten(np.asarray(x.s), leaves)]}
    if isinstance(x, dict):
        keys = sorted(x.keys())
        return {"t": "dict", "keys": list(keys),
                "c": [_flatten(x[k], leaves) for k in keys]}
    if isinstance(x, (list, tuple)):
        return {"t": "list" if isinstance(x, list) else "tuple",
                "c": [_flatten(v, leaves) for v in x]}
    leaf = np.asarray(x)
    spec = {"t": "leaf", "i": len(leaves)}
    if leaf.dtype.kind not in "biufc":
        # ml_dtypes extension types (bfloat16, float8_*) survive np.savez
        # only as raw void bytes — tag the dtype name so _build can view
        # the bytes back (jax rejects |V2 arrays otherwise)
        spec["dtype"] = leaf.dtype.name
    leaves.append(leaf)
    return spec


def _build(spec, leaves):
    t = spec["t"]
    if t == "qtensor":
        from ..ops.quantize import QTensor
        return QTensor(_build(spec["c"][0], leaves),
                       _build(spec["c"][1], leaves), spec["caxis"])
    if t == "dict":
        return {k: _build(c, leaves) for k, c in zip(spec["keys"], spec["c"])}
    if t in ("list", "tuple"):
        seq = [_build(c, leaves) for c in spec["c"]]
        return seq if t == "list" else tuple(seq)
    leaf = leaves[spec["i"]]
    if "dtype" in spec and leaf.dtype.kind == "V":
        import ml_dtypes  # noqa: F401  (registers the extension dtypes)
        leaf = leaf.view(np.dtype(spec["dtype"]))
    return leaf


def _shape_structs(tree):
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        tree)


# -- PartitionSpec (de)serialization for sharded (mesh) bundles -------------
def _spec_to_json(sharding):
    # entries are None | str | tuple[str]
    return [list(e) if isinstance(e, tuple) else e for e in sharding.spec]


def _spec_from_json(entries):
    from jax.sharding import PartitionSpec
    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in entries])


def _tree_specs(shardings_tree):
    leaves, _ = jax.tree_util.tree_flatten(shardings_tree)
    return [_spec_to_json(s) for s in leaves]


# ---------------------------------------------------------------------------
def save_bundle(sim, path: str, segment_steps: int = 1000,
                platforms=None) -> None:
    """Write an AOT serving bundle for ``sim``'s model to directory ``path``.

    ``segment_steps`` is baked into the exported program (scan length is
    static); serving calls consume input tables in chunks of this size.
    ``platforms``: optional list (e.g. ``["cpu", "cuda"]``) to lower for
    multiple backends; default is the exporting process's platform.

    The bundle captures ``sim``'s CURRENT carry as the initial state, so
    exporting after a training run ships the learned weights.
    """
    model = sim.model
    step = sim._step_fn
    splits = sim._input_splits()
    width = splits[-1][1] if splits else 0
    seg = int(segment_steps)
    unroll = max(1, min(sim.scan_unroll, seg))

    def run_segment(state, xs_packed, params):
        xs_cols = [xs_packed[:, a:b] for a, b in splits]

        def body(carry, xs):
            return step(carry, xs, params)
        new_state, emits = jax.lax.scan(body, state, xs_cols, length=seg,
                                        unroll=unroll)
        # jax.export only serializes string dict keys; probe indices are ints
        return new_state, {str(k): v for k, v in emits.items()}

    state_now = jax.tree_util.tree_map(np.asarray, sim.state)
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = list(platforms)
    mesh_meta = None
    if sim.mesh is not None:
        # sharded (multi-chip) bundle: export the mesh-jitted program and
        # record the mesh geometry + per-leaf PartitionSpecs so the
        # serving process can rebuild the same sharding layout
        from ..parallel.sharding import (params_shardings, replicated,
                                         state_shardings)
        st_sh = state_shardings(sim.model, sim.mesh)
        p_sh = params_shardings(sim.params, sim.mesh, model=sim.model)
        jitted = jax.jit(run_segment,
                         in_shardings=(st_sh, replicated(sim.mesh), p_sh))
        mesh_meta = {
            "axis_names": list(sim.mesh.axis_names),
            "shape": [int(s) for s in sim.mesh.devices.shape],
            "state_specs": _tree_specs(st_sh),
            "params_specs": _tree_specs(p_sh),
        }
    else:
        jitted = jax.jit(run_segment)
    exp = jax.export.export(jitted, **kwargs)(
        _shape_structs(state_now),
        jax.ShapeDtypeStruct((seg, width), np.float32),
        _shape_structs(sim.params))

    os.makedirs(path, exist_ok=True)
    _need_flatbuffers()
    with open(os.path.join(path, "step.jaxexport"), "wb") as f:
        f.write(exp.serialize())

    p_leaves, s_leaves = [], []
    params_spec = _flatten(jax.tree_util.tree_map(np.asarray, sim.params),
                           p_leaves)
    state_spec = _flatten(state_now, s_leaves)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"p{i}": a for i, a in enumerate(p_leaves)},
             **{f"s{i}": a for i, a in enumerate(s_leaves)})

    # labels key the serving-side dicts, so force uniqueness here rather
    # than silently merging two same-labeled probes/nodes at load time
    def _unique(labels):
        seen, out = set(), []
        for lab in labels:
            if lab in seen:
                k = 2
                while f"{lab}_{k}" in seen:
                    k += 1
                lab = f"{lab}_{k}"
            seen.add(lab)
            out.append(lab)
        return out

    in_labels = _unique([(n.label or f"input_{i}")
                         for i, n in enumerate(model.input_nodes)])
    dense_probes = [bp for bp in model.probes if not bp.sparse]
    pr_labels = _unique([(getattr(bp.obj, "label", None)
                          or f"probe_{bp.index}") for bp in dense_probes])
    meta = {
        "format_version": 1,
        "dt": sim.dt,
        "segment_steps": seg,
        "n_steps_at_export": int(sim.n_steps),
        "platforms": list(exp.platforms),
        "input_width": width,
        "inputs": [{"label": lab, "a": a, "b": b}
                   for lab, (a, b) in zip(in_labels, splits)],
        # dense probes only: sparse (weights/encoders) snapshots are read
        # from the carry by the builder's helpers, which need the model —
        # serving consumers read learned state from the carry directly
        "probes": [{"index": bp.index,
                    "label": lab,
                    "shape": list(bp.shape),
                    "period_steps": bp.period_steps}
                   for lab, bp in zip(pr_labels, dense_probes)],
        "params_spec": params_spec,
        "state_spec": state_spec,
        "mesh": mesh_meta,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


class ServingModel:
    """Load and step an AOT bundle written by :func:`save_bundle`.

    Needs only jax + numpy — the network definition, builder, and solvers
    never run in the serving process.

        m = ServingModel("/path/to/bundle")
        out = m.run(xs_table)          # {probe label: (n, d) array}

    ``xs_table`` rows are the packed input columns (``m.inputs`` gives the
    per-node column ranges); rows beyond a segment multiple are clamped by
    repeating the final row, matching the Simulator's TimeTable semantics.
    State carries across calls; :meth:`reset` restores the exported carry.
    """

    def __init__(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        _need_flatbuffers()
        with open(os.path.join(path, "step.jaxexport"), "rb") as f:
            self._exp = jax.export.deserialize(bytearray(f.read()))
        data = np.load(os.path.join(path, "arrays.npz"))
        p_leaves = [data[f"p{i}"] for i in range(
            sum(1 for k in data.files if k.startswith("p")))]
        s_leaves = [data[f"s{i}"] for i in range(
            sum(1 for k in data.files if k.startswith("s")))]
        self.params = _build(self.meta["params_spec"], p_leaves)
        self._state0 = _build(self.meta["state_spec"], s_leaves)
        self.mesh = None
        self._state_sh = None
        self._call = self._exp.call
        mm = self.meta.get("mesh")
        if mm:
            # sharded bundle: rebuild the mesh geometry and jit-wrap the
            # exported call with the recorded per-leaf shardings (an
            # exported n-device program must be invoked from an n-device
            # jit context)
            from jax.sharding import Mesh, NamedSharding, PartitionSpec
            n_dev = int(np.prod(mm["shape"]))
            devs = jax.devices()
            if len(devs) < n_dev:
                raise RuntimeError(
                    f"bundle was exported for a {mm['shape']} mesh "
                    f"({n_dev} devices); this process has {len(devs)}")
            self.mesh = Mesh(np.asarray(devs[:n_dev]).reshape(mm["shape"]),
                             tuple(mm["axis_names"]))

            def shardings_from(specs, tree):
                leaves, treedef = jax.tree_util.tree_flatten(tree)
                shs = [NamedSharding(self.mesh, _spec_from_json(s))
                       for s in specs]
                if len(shs) != len(leaves):
                    raise ValueError("bundle sharding specs do not match "
                                     "the array tree")
                return jax.tree_util.tree_unflatten(treedef, shs)

            self._state_sh = shardings_from(mm["state_specs"], self._state0)
            p_sh = shardings_from(mm["params_specs"], self.params)
            rep = NamedSharding(self.mesh, PartitionSpec())
            self.params = jax.device_put(self.params, p_sh)
            self._state0 = jax.device_put(self._state0, self._state_sh)
            self._call = jax.jit(self._exp.call,
                                 in_shardings=(self._state_sh, rep, p_sh))
        self.state = self._state0
        self.dt = float(self.meta["dt"])
        self.segment_steps = int(self.meta["segment_steps"])
        self.inputs = {d["label"]: (d["a"], d["b"])
                       for d in self.meta["inputs"]}
        # the exported carry sits at this global step; subsampled-probe
        # thinning phases off it (a bundle exported mid-run continues the
        # live Simulator's sampling grid, not a fresh one)
        self._n_steps0 = int(self.meta.get("n_steps_at_export", 0))
        self.n_steps = self._n_steps0

    @property
    def input_width(self) -> int:
        return int(self.meta["input_width"])

    def reset(self) -> None:
        self.state = self._state0
        self.n_steps = self._n_steps0

    def load_state(self, checkpoint_path: str) -> None:
        """Swap in a carry saved by :meth:`Simulator.save_checkpoint`
        (e.g. a later training checkpoint of the same model).  The
        checkpoint's step counter is restored too, so subsampled probes
        stay on the same sampling grid as the originating Simulator."""
        if (not os.path.exists(checkpoint_path)
                and os.path.exists(checkpoint_path + ".npz")):
            checkpoint_path += ".npz"
        with np.load(checkpoint_path) as f:
            n = int(f["n_leaves"])
            leaves = [f[f"leaf_{i}"] for i in range(n)]
            n_steps = int(f["n_steps"])
        ref = jax.tree_util.tree_structure(self.state)
        state = jax.tree_util.tree_unflatten(ref, leaves)
        if self._state_sh is not None:
            state = jax.device_put(state, self._state_sh)
        self.state = state
        self.n_steps = n_steps

    def step_segment(self, xs_packed: np.ndarray):
        """Advance exactly ``segment_steps`` steps.  Returns the raw emit
        dict ``{str(probe index): (segment_steps, ...) array}``."""
        seg = self.segment_steps
        if xs_packed.shape != (seg, self.input_width):
            raise ValueError(f"xs_packed must be ({seg}, {self.input_width})"
                             f", got {xs_packed.shape}")
        self.state, emits = self._call(self.state, xs_packed, self.params)
        self.n_steps += seg
        return emits

    def run(self, xs_table: np.ndarray,
            probes: Optional[list] = None) -> Dict[str, np.ndarray]:
        """Run ``len(xs_table)`` steps (chained segments).  Returns
        ``{probe label: (n_rows, ...) array}`` with subsampled probes
        thinned at their ``period_steps``.

        The exported program has a fixed scan length, so when ``n`` is not
        a multiple of ``segment_steps`` the final segment is padded by
        repeating the last input row: its emissions are trimmed to ``n``
        rows, but the CARRY advances to the next segment boundary on the
        clamped inputs.  Use segment-multiple lengths when subsequent calls
        must continue bit-exactly from step ``n``."""
        xs_table = np.asarray(xs_table, np.float32)
        n = xs_table.shape[0]
        seg = self.segment_steps
        descs = [d for d in self.meta["probes"]
                 if probes is None or d["label"] in probes]
        out = {d["label"]: [] for d in descs}
        done = 0
        while done < n:
            xs = xs_table[done:done + seg]
            take = xs.shape[0]
            if take < seg:
                xs = np.concatenate(
                    [xs, np.repeat(xs[-1:], seg - take, axis=0)])
            cum = self.n_steps
            emits = self.step_segment(xs)
            for d in descs:
                # device-side slicing only; the host transfer is deferred
                # to the final concatenate so segment dispatches pipeline
                # instead of blocking on each emit readback
                e = emits[str(d["index"])][:take]
                p = d["period_steps"]
                if p > 1:
                    phase = (p - 1 - cum % p) % p
                    e = e[phase::p]
                out[d["label"]].append(e)
            done += take
        shapes = {d["label"]: tuple(d["shape"]) for d in descs}
        return {k: (np.concatenate([np.asarray(c) for c in v], axis=0)
                    if v else np.zeros((0,) + shapes[k]))
                for k, v in out.items()}
