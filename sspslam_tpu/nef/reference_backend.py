"""Pure-NumPy per-step reference interpreter.

Plays the role nengo's CPU simulator plays for the reference project: a
slow, transparent oracle.  It executes the SAME built Model with the same
op schedule as the jitted executor, but step-by-step on the host in NumPy —
used (a) to cross-check the compiled path (the analogue of the
reference's cpu-vs-ocl backend cross-check, SURVEY.md §4; see
:func:`cross_check`) and (b) as the measured baseline for bench.py's
speedup figures.

jnp-traceable node functions are evaluated through numpy where possible;
functions written with jax.numpy also accept numpy inputs and return jax
arrays on the default backend — to keep this backend host-only, outputs are
converted with np.asarray (on CPU builds this is free).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ops import learning as _  # noqa: F401  (parity of rules documented there)
from .builder import BuiltConnection, Model

__all__ = ["NumpyStepper", "compare_traces", "cross_check"]


def _lif_step_np(nt, state, J, dt):
    voltage = state["voltage"]
    refractory = state["refractory"] - dt
    delta_t = np.clip(dt - refractory, 0.0, dt)
    voltage = voltage + (J - voltage) * -np.expm1(-delta_t / nt.tau_rc)
    spiked = voltage > 1.0
    denom = np.where(spiked, np.maximum(J - 1.0, 1e-12), 1.0)
    overshoot = np.clip((voltage - 1.0) / denom, 0.0, 1.0 - 1e-6)
    t_spike = dt + nt.tau_rc * np.log1p(-overshoot)
    out = np.where(spiked, nt.amplitude / dt, 0.0)
    voltage = np.where(spiked, 0.0, np.maximum(voltage, nt.min_voltage))
    refractory = np.where(spiked, nt.tau_ref + t_spike, refractory)
    return {"voltage": voltage, "refractory": refractory}, out


def _neuron_step_np(nt, state, J, dt):
    kind = type(nt).__name__
    if kind in ("LIF", "SurrogateLIF"):  # identical forward pass
        return _lif_step_np(nt, state, J, dt)
    if kind == "QuantizedLIF":
        st, out = _lif_step_np(nt, state, J, dt)
        q = float(nt.levels)
        st["voltage"] = np.round(st["voltage"] * q) / q
        return st, out
    if kind == "LoihiLIF":
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = np.clip(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -np.expm1(-delta_t / nt.tau_rc)
        spiked = voltage > 1.0
        out = np.where(spiked, nt.amplitude / dt, 0.0)
        voltage = np.where(spiked, 0.0, np.maximum(voltage, nt.min_voltage))
        tau_ref_q = dt * np.round(nt.tau_ref / dt)
        refractory = np.where(spiked, tau_ref_q + dt, refractory)
        return {"voltage": voltage.astype(np.float32),
                "refractory": refractory.astype(np.float32)}, out
    if kind in ("LIFRate", "RectifiedLinear"):
        return state, nt.rates_np(J)
    if kind == "SpikingRectifiedLinear":
        v = state["voltage"] + np.maximum(J, 0.0) * dt
        n_spikes = np.floor(v)
        return {"voltage": v - n_spikes}, (nt.amplitude / dt) * n_spikes
    raise NotImplementedError(kind)


class NumpyStepper:
    """Interpret a built Model one dt at a time on the host."""

    def __init__(self, model: Model, hoisted: Optional[dict] = None):
        self.model = model
        self.dt = model.dt
        # hoisted node consts (SSPSLAM_HOIST_GATE): default to the
        # build-time values; pass sim.params["hoisted"] (as host arrays)
        # to cross-check a swept config whose traced consts were rewritten
        self.hoisted = ({k: dict(v) for k, v in model.hoisted.items()}
                        if hoisted is None
                        else {k: dict(v) for k, v in hoisted.items()})
        self.state = self._initial_state()
        self._filt_coeffs = [(a, b) for (_s, a, b) in model.filter_specs]
        # incoming connection tables (same grouping as the jit executor)
        self.node_in: Dict[int, list] = {}
        self.ens_in: Dict[int, list] = {}
        self.ens_cur: Dict[int, list] = {}
        for bc in model.connections:
            if bc.post_kind == "node":
                self.node_in.setdefault(id(bc.post), []).append(bc)
            elif bc.post_kind in ("ens", "ea_elem", "ea_batch"):
                self.ens_in.setdefault(bc.post.index, []).append(bc)
            elif bc.post_kind == "neurons":
                self.ens_cur.setdefault(bc.post.index, []).append(bc)
        # decoders may be device-resident jax arrays (nef/solvers.py device
        # solve paths); materialise host float32 copies ONCE — converting
        # inside the per-step loop would serialise a device round trip per
        # connection per dt
        self._np_dec: Dict[int, np.ndarray] = {
            bc.index: np.asarray(bc.decoders, np.float32)
            for bc in model.connections if bc.decoders is not None}
        self._np_probe_dec: Dict[int, np.ndarray] = {
            bp.index: np.asarray(bp.decoders, np.float32)
            for bp in model.probes if bp.decoders is not None}

    def _initial_state(self):
        m = self.model
        neurons = []
        for be in m.ensembles:
            shape = (be.k, be.n) if be.batched else (be.n,)
            nt = be.neuron_type
            if nt.spiking:
                st = {"voltage": np.zeros(shape, np.float32)}
                if type(nt).__name__ in ("LIF", "QuantizedLIF", "LoihiLIF",
                                         "SurrogateLIF"):
                    st["refractory"] = np.zeros(shape, np.float32)
                neurons.append(st)
            else:
                neurons.append({})
        return {
            "step": 0,
            "neurons": neurons,
            "filters": [np.zeros(s, np.float32) for s, _a, _b in m.filter_specs],
            "learned": {k: np.array(v, np.float32)
                        for k, v in m.learned_init.items()},
            "nodes": {k: np.array(v, np.float32)
                      for k, v in m.node_state_init.items()},
        }

    def sparse_probe(self, bp):
        """Read a sparse (weights / scaled_encoders) probe from the current
        interpreter state — same semantics as the compiled path's
        segment-boundary reads."""
        from .executor import sparse_probe_value
        return sparse_probe_value(self.model, self.state, bp)

    # ------------------------------------------------------------------
    def run_steps(self, n_steps: int, input_tables):
        """input_tables: list of (n_steps, size) arrays in model.input_nodes
        order.  Returns probe emissions {probe_index: (n_steps, ...)} for
        dense probes."""
        import contextlib
        try:
            import jax
            ctx = jax.default_device(jax.devices("cpu")[0])
        except Exception:
            ctx = contextlib.nullcontext()
        m = self.model
        emits = {bp.index: [] for bp in m.probes if not bp.sparse}
        with ctx:  # keep any jnp node functions on the host backend
            for i in range(n_steps):
                xs = [tab[i] for tab in input_tables]
                out = self._step(xs)
                for k, v in out.items():
                    emits[k].append(v)
        return {k: np.stack(v) for k, v in emits.items()}

    def _step(self, xs):
        m = self.model
        dt = self.dt
        st = self.state
        t = (st["step"] + 1) * dt
        filters = st["filters"]
        learned = st["learned"]
        sig_node: Dict[int, np.ndarray] = {}
        sig_act: Dict[int, np.ndarray] = {}
        input_index = {id(n): i for i, n in enumerate(m.input_nodes)}

        def decoders_of(bc):
            if bc.learned_slot is not None:
                return learned[bc.learned_slot]
            return self._np_dec[bc.index]

        def pre_value(bc: BuiltConnection):
            if bc.pre_kind == "node":
                v = sig_node[id(bc.pre)]
                if bc.pre_indices is not None:
                    v = v[bc.pre_indices]
                return v
            act = sig_act[bc.pre.index]
            if bc.pre_kind in ("ens", "ens_view"):
                return act @ decoders_of(bc)
            if bc.pre_kind == "ea_elem":
                return act[bc.ea_elem_index] @ decoders_of(bc)
            if bc.pre_kind == "ea_batch":
                if bc.ea_rows is not None:   # fused-EA member rows
                    off, kk = bc.ea_rows
                    act = act[off:off + kk]
                return np.einsum("kn,knd->kd", act, decoders_of(bc))
            if bc.pre_kind == "neurons":
                nl = bc.pre.n - bc.pre.n_pad
                if bc.ea_elem_index is not None:  # fused-group element
                    v = act[bc.ea_elem_index]
                    return v if (bc.full_weights or bc.pre.n_pad == 0) \
                        else v[:nl]
                if bc.full_weights or bc.pre.n_pad == 0:
                    return act.reshape(-1)
                return act[..., :nl].reshape(-1)
            if bc.pre_kind == "ea_neurons":
                if bc.ea_rows is not None:
                    off, kk = bc.ea_rows
                    return act[off:off + kk]
                return act              # (k, n) raw activities
            raise TypeError(bc.pre_kind)

        def current_value(bc):
            v = pre_value(bc)
            if bc.jnp_function is not None:
                np_f = getattr(bc.jnp_function, "np_function", None)
                f = np_f if np_f is not None else bc.jnp_function
                v = np.asarray(f(v)).reshape(-1)
            if bc.pre_kind == "ea_batch" and bc.post_kind == "node":
                v = v.reshape(-1)
            if bc.weights is not None:
                W = bc.weights.astype(np.float32)
                if bc.full_weights:  # neuron->neuron currents (solver_weights)
                    v = (np.einsum("knm,km->kn", W, v) if W.ndim == 3
                         else W @ v)
                elif W.ndim == 3:
                    v = np.einsum("kds,s->kd", W, v)
                else:
                    v = W @ v
            elif bc.scalar_weight != 1.0:
                v = bc.scalar_weight * v
            return np.asarray(v, np.float32)

        def conn_output(bc):
            if bc.synapse is not None:
                return filters[bc.filt_index]
            return current_value(bc)

        for kind, obj in m.topo_units:
            if kind == "node":
                info = m.node_info[id(obj)]
                nk = info["kind"]
                if nk == "tabulated":
                    sig_node[id(obj)] = np.asarray(xs[input_index[id(obj)]],
                                                   np.float32)
                elif nk == "const":
                    sig_node[id(obj)] = info["const"].astype(np.float32)
                else:
                    x = np.zeros(obj.size_in, np.float32)
                    for bc in self.node_in.get(id(obj), []):
                        v = conn_output(bc)
                        if bc.post_indices is not None:
                            x[bc.post_indices] += v
                        else:
                            x += v
                    if nk == "jnp_func":
                        np_f = info.get("np_func")
                        hk = info.get("hoisted_key")
                        slot = info.get("state_slot")
                        if slot is not None:
                            # stateful node: (t, x, s, consts=None) ->
                            # (out, s'); prefer the NumPy mirror
                            f = np_f if np_f is not None else obj.output
                            kw = ({"consts": self.hoisted[hk]}
                                  if hk is not None else {})
                            out, ns = f(t, x, st["nodes"][slot], **kw)
                            st["nodes"][slot] = np.asarray(ns, np.float32)
                        elif np_f is not None:
                            # pure-NumPy mirror: stays on the host even
                            # when the jax default backend is an
                            # accelerator (eager jnp dispatch per op is
                            # NOT a fair CPU baseline).  Hoisted consts
                            # are forwarded so
                            # the mirror tracks swept gate params exactly
                            # like the jit path
                            if hk is not None:
                                out = np_f(t, x, consts=self.hoisted[hk])
                            else:
                                out = np_f(t, x)
                        elif hk is not None:
                            out = obj.output(t, x,
                                             consts=self.hoisted[hk])
                        elif obj.size_in > 0:
                            out = obj.output(t, x)
                        else:
                            out = obj.output(t)
                        sig_node[id(obj)] = np.asarray(out, np.float32).reshape(-1)
                    else:
                        sig_node[id(obj)] = x
            else:
                be = obj
                shape = (be.k, be.dim) if be.batched else (be.dim,)
                x = np.zeros(shape, np.float32)
                for bc in self.ens_in.get(be.index, []):
                    v = conn_output(bc)
                    if bc.post_kind == "ea_batch":
                        if bc.ea_rows is not None:
                            off, kk = bc.ea_rows
                            x[off:off + kk] += v.reshape(
                                (kk,) + shape[1:])
                        else:
                            x += v.reshape(shape)
                    elif bc.post_kind == "ea_elem":
                        if bc.post_indices is not None:
                            x[bc.post_elem_index, bc.post_indices] += v
                        else:
                            x[bc.post_elem_index] += v
                    else:
                        if bc.post_indices is not None:
                            x[bc.post_indices] += v
                        else:
                            x += v
                E = (learned[f"voja_{be.voja_conn_index}"]
                     if be.voja_conn_index is not None
                     else be.scaled_encoders.astype(np.float32))
                if be.batched:
                    J = np.einsum("knd,kd->kn", E, x) + be.bias.astype(np.float32)
                else:
                    J = E @ x + be.bias.astype(np.float32)
                for bc in self.ens_cur.get(be.index, []):
                    v = conn_output(bc)
                    nl = be.n - be.n_pad
                    if bc.full_weights or be.n_pad == 0:
                        if bc.post_elem_index is not None:  # fused element
                            J = J.copy()
                            J[bc.post_elem_index] += v
                        else:
                            J = J + (v.reshape(J.shape)
                                     if v.size == J.size else v)
                    elif bc.post_elem_index is not None:
                        J = J.copy()
                        J[bc.post_elem_index, :nl] += v
                    else:
                        J = J.copy()
                        J[..., :nl] += v.reshape(J.shape[:-1] + (nl,))
                ns, out = _neuron_step_np(be.neuron_type,
                                          st["neurons"][be.index], J, dt)
                st["neurons"][be.index] = ns
                sig_act[be.index] = out

        new_filters = list(filters)
        cascade = m.filter_cascade

        def update_filter(fi, u):
            a, b = self._filt_coeffs[fi]
            if fi in cascade:  # Alpha: first stage feeds the output stage
                h = cascade[fi]
                ah, bh = self._filt_coeffs[h]
                u = ah * filters[h] + bh * u
                new_filters[h] = u
            new_filters[fi] = a * filters[fi] + b * u

        for bc in m.connections:
            if bc.filt_index is not None:
                update_filter(bc.filt_index, current_value(bc))
            if bc.pes_act_filt_index is not None:
                src = (sig_act[bc.post.index] if bc.voja_rule is not None
                       else sig_act[bc.pre.index])
                update_filter(bc.pes_act_filt_index, src)

        for bc in m.connections:
            if bc.pes_rule is not None:
                err = np.zeros(bc.decoders.shape[-1], np.float32)
                for rci in bc.rule_target_conns:
                    err = err + conn_output(m.connections[rci])
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[bc.pre.index])
                alpha = (bc.pes_rule.learning_rate * dt
                         / (bc.pre.n - bc.pre.n_pad))
                learned[bc.learned_slot] = (
                    learned[bc.learned_slot] - alpha * np.outer(acts, err))
            elif bc.voja_rule is not None:
                gate = 0.0
                for rci in bc.rule_target_conns:
                    gate = gate + conn_output(m.connections[rci])
                ls = 1.0 + np.asarray(gate).reshape(-1)[0]
                be = bc.post
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[be.index])
                pre_v = current_value(bc)
                scale = (be.gain / be.radius).astype(np.float32)
                alpha = bc.voja_rule.learning_rate * dt * ls
                E = learned[bc.learned_slot]
                learned[bc.learned_slot] = E + alpha * (
                    scale[:, None] * np.outer(acts, pre_v)
                    - acts[:, None] * E)

        out = {}
        for bp in m.probes:
            if bp.kind == "node":
                v = sig_node[id(bp.target)]
            elif bp.kind == "ens_decoded":
                act = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    act = act[bp.elem_index]
                v = act @ self._np_probe_dec[bp.index]
            elif bp.kind == "activities":
                v = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "voltage":
                v = st["neurons"][bp.target.index]["voltage"]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "weights":
                D = (learned[bp.target.learned_slot]
                     if bp.target.learned_slot
                     else self._np_dec[bp.target.index])
                v = D.T if D.ndim == 2 else D
            elif bp.kind == "scaled_encoders":
                v = learned[bp.target.learned_slot]
            else:
                raise TypeError(bp.kind)
            if bp.filt_index is not None:
                a, b = self._filt_coeffs[bp.filt_index]
                if bp.filt_index in cascade:
                    h = cascade[bp.filt_index]
                    ah, bh = self._filt_coeffs[h]
                    v = ah * new_filters[h] + bh * v
                    new_filters[h] = v
                v = a * new_filters[bp.filt_index] + b * v
                new_filters[bp.filt_index] = v
            if not bp.sparse:
                out[bp.index] = np.array(v)

        st["filters"] = new_filters
        st["step"] += 1
        return out


# ---------------------------------------------------------------------------
# Compiled-vs-interpreted agreement
# ---------------------------------------------------------------------------

def compare_traces(jit_v, ref_v, atol=1e-3, spike_flip_tolerant=False,
                   label="probe"):
    """Check a compiled probe trace against a reference trace of the same
    (T, ...) shape; raise ``AssertionError`` naming the statistic that
    failed, else return the statistics (errors relative to
    ``max(max|ref|, 1)``).

    Without ``spike_flip_tolerant`` the max error must stay below
    ``atol``.  Spiking models are chaotic: two backends that accumulate
    matmuls in different orders can flip a single LIF spike by one dt, and
    online PES/Voja then amplifies the flip into a transient excursion.
    The tolerant statistic therefore requires the BULK of timesteps to
    agree at float32 tightness and bounds the excursions instead: a spike
    flip shows up as scattered 1-2 step blips, while a genuine mismatch
    diverges and STAYS diverged — so both the excursion fraction and the
    longest consecutive run above 5*atol are bounded."""
    jit_v = np.asarray(jit_v)
    ref_v = np.asarray(ref_v)
    if jit_v.shape != ref_v.shape:
        raise AssertionError(f"{label}: shape {jit_v.shape} vs "
                             f"{ref_v.shape}")
    per_t = np.max(np.abs(jit_v - ref_v), axis=tuple(range(1, jit_v.ndim)))
    scale = max(float(np.max(np.abs(ref_v))), 1.0)
    stats = {"max": float(per_t.max() / scale)}
    if not spike_flip_tolerant:
        if not stats["max"] < atol:
            raise AssertionError(f"{label}: err {stats['max']} >= {atol}")
        return stats
    exc = per_t / scale > 5 * atol
    run, longest_run = 0, 0
    for e in exc:
        run = run + 1 if e else 0
        longest_run = max(longest_run, run)
    stats.update(median=float(np.median(per_t) / scale),
                 q80=float(np.quantile(per_t, 0.80) / scale),
                 frac_exc=float(np.mean(exc)), longest_run=longest_run)
    checks = [
        ("median err", stats["median"] < atol),
        ("q80 err", stats["q80"] < 5 * atol),
        ("peak err", stats["max"] < 0.25),
        # excursions must stay RARE and BRIEF
        ("fraction of steps above 5*atol", stats["frac_exc"] < 0.10),
        ("longest run above 5*atol (diverged and stayed diverged)",
         longest_run <= max(5, int(0.03 * len(exc)))),
    ]
    for name, ok in checks:
        if not ok:
            raise AssertionError(f"{label}: {name} out of bounds: {stats}")
    return stats


def cross_check(sim, n_steps, atol=1e-3, spike_flip_tolerant=False,
                segment_steps=None):
    """Run a fresh Simulator ``sim`` and the :class:`NumpyStepper` on the
    same built model and inputs for ``n_steps`` and compare every dense
    probe with :func:`compare_traces`.  Advances ``sim`` by ``n_steps``;
    returns ``{probe index: statistics}``."""
    if sim.n_steps != 0:
        raise ValueError("cross_check needs a Simulator at step 0")
    tables = [np.asarray(c) for c in sim._tabulate_inputs(n_steps)]
    ref_out = NumpyStepper(sim.model).run_steps(n_steps, tables)
    sim.run_steps(n_steps, segment_steps=segment_steps)
    return {bp.index: compare_traces(sim.probe_data(bp.obj),
                                     ref_out[bp.index], atol,
                                     spike_flip_tolerant,
                                     label=f"probe {bp.index}")
            for bp in sim.model.probes if not bp.sparse}
