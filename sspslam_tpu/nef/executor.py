"""Emit the jitted per-timestep function from a built Model.

``make_step_fn(model)`` returns ``step(state, xs) -> (state, emits)`` — a
pure jnp function executing the whole network update on device: ensemble
currents (batched einsums), neuron dynamics, synapse filters
(one fused multiply-add each), PES/Voja outer-product learning, gates and
clean-ups, and probe collection.  ``lax.scan`` over it is the simulation
loop; XLA fuses the elementwise chains between the matmuls.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..ops import learning as learning_ops
from ..ops.quantize import QTensor, quantize
from .builder import BuiltConnection, BuiltProbe, Model

__all__ = ["make_step_fn", "STEP_PRECISION"]

#: Matmul precision of every float32 contraction in the simulation step,
#: applied to the whole step whatever precision the process or an outer
#: ``jax.default_matmul_precision`` context sets.  The platform default
#: may round f32 matmul inputs to TF32 (~3 decimal digits) depending on
#: how XLA lowers each dot; "highest" does not depend on that, and the
#: step is launch-bound, so it costs no measurable time
#: (experiments/precision_probe.py, README "Precision").  bf16/int8/fp8
#: parameter banks (``matmul_dtype``) feed bf16 inputs and are unaffected.
STEP_PRECISION = "highest"


def _parse_param_dtype(matmul_dtype):
    """Normalise the ``matmul_dtype`` knob into (cast_dtype, quant_kind).

    Accepted: None / "f32" (full precision), jnp.bfloat16 / "bf16" (bf16
    storage + matmul inputs, f32 accumulation), "int8" / "fp8" (1-byte
    storage with per-slice scales — see ops/quantize.py — dequantised
    after the contraction; matmul inputs bf16, accumulation f32)."""
    if matmul_dtype is None or matmul_dtype == "f32":
        return None, None
    if matmul_dtype == "bf16" or matmul_dtype is jnp.bfloat16:
        return jnp.bfloat16, None
    if matmul_dtype in ("int8", "fp8"):
        return jnp.bfloat16, matmul_dtype
    return matmul_dtype, None   # any other explicit jnp dtype


#: params whose contracted-axis length is below this stay in the cast
#: dtype — per-slice scales on a (n, 1) gate transform would outweigh the
#: int8 payload
_QUANT_MIN_CONTRACT = 32


def _contig(idx):
    """(start, stop) if idx is a contiguous ascending range, else None.
    Static slices lower to cheap dynamic-update-slices (and vmap well),
    unlike integer-array scatter/gather."""
    import numpy as np
    idx = np.asarray(idx)
    if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
        return int(idx[0]), int(idx[0] + idx.size)
    return None


def _ea_batch_decode_groups(model: Model):
    """Static decodes of row-slices of the SAME fused-EA group with the same
    output width, layered so each layer's members cover disjoint rows —
    each layer lowers as ONE (k, n) x (k, n, d) einsum over the whole group
    followed by cheap row slices, instead of one sliced einsum per member
    (the two circular-convolution product arrays' square decodes in
    SLAMNetwork)."""
    import numpy as np
    by_spec = {}
    for bc in model.connections:
        if (bc.pre_kind == "ea_batch" and bc.decoders is not None
                and bc.learned_slot is None and bc.ea_rows is not None):
            key = (bc.pre.index, int(np.shape(bc.decoders)[-1]))
            by_spec.setdefault(key, []).append(bc)
    groups = {}
    for (pre_idx, d), bcs in by_spec.items():
        layers = []
        for bc in bcs:
            off, kk = bc.ea_rows
            for layer in layers:
                if all(off + kk <= o or off >= o + k
                       for (o, k), _ in layer):
                    layer.append(((off, kk), bc))
                    break
            else:
                layers.append([((off, kk), bc)])
        for li, layer in enumerate(layers):
            if len(layer) >= 2:
                groups[f"eab{pre_idx}_{d}_{li}"] = [bc for _, bc in layer]
    return groups


def _elem_decode_groups(model: Model):
    """Static (non-learned) per-element decodes off the SAME batched group
    with the same output width, e.g. the memory/error/recall taps of the
    fused SLAM trio — each is a separate (1, n) @ (n, d) matvec per step;
    batched together they lower as ONE (g, n) x (g, n, d) einsum (the step
    is op-latency-bound, not FLOP-bound)."""
    import numpy as np
    groups = {}
    for bc in model.connections:
        if (bc.pre_kind == "ea_elem" and bc.decoders is not None
                and bc.learned_slot is None):
            key = f"{bc.pre.index}_{int(np.shape(bc.decoders)[-1])}"
            groups.setdefault(key, []).append(bc)
    return {k: v for k, v in groups.items() if len(v) >= 2}


def build_params(model: Model, matmul_dtype=None):
    """Parameter pytree passed to the step as a traced argument (NOT
    embedded as jit constants) so the persistent compilation cache hits
    across different seeds/data of the same model shape.  They become
    device-resident on the first jitted call (device-solved decoders
    already are and stay there).

    ``matmul_dtype`` (e.g. jnp.bfloat16) STORES the matmul-side parameters
    (encoders / decoders / transforms) in that dtype.  The step is
    HBM-bandwidth-bound at reference scale (~20 MB of parameter reads per
    dt, dominated by the VCO decoder bank) — casting inside the step only
    changes the matmul input dtype while the HBM read stays f32; storing
    in bf16 actually halves the traffic.  ``"int8"`` / ``"fp8"`` go one
    step further: static matmul params are stored 1 byte/weight with
    per-slice scales applied after the contraction (ops/quantize.py, the
    Loihi-8-bit-synapse analog) — 4x less parameter traffic than f32.
    Bias/gain and all learned (PES/Voja) state stay float32."""
    import numpy as np

    cast_dtype, quant_kind = _parse_param_dtype(matmul_dtype)

    def _p(x, caxis=None):
        # device-resident solver outputs (jax arrays) stay on device — a
        # np.asarray here would add a device->host->device round trip per
        # parameter
        if (quant_kind is not None and caxis is not None
                and np.ndim(x) >= 2
                and np.shape(x)[caxis] >= _QUANT_MIN_CONTRACT):
            return quantize(x, caxis, quant_kind)
        target = cast_dtype if cast_dtype is not None else np.float32
        if isinstance(x, np.ndarray) or np.isscalar(x):
            return np.asarray(x).astype(target)
        return x.astype(target)

    enc_params = []
    for be in model.ensembles:
        enc_params.append({
            # encoders contract the representation axis (their LAST)
            "scaled_encoders": _p(be.scaled_encoders, caxis=-1),
            "bias": np.asarray(be.bias, np.float32),
            "gain": np.asarray(be.gain, np.float32),
        })
    def _recurrent(bc):
        # a connection whose pre and post are the same built ensemble
        # group — the VCO limit-cycle feedback (and any other attractor
        # recurrence).  Its decoded feedback is applied ~1000x/s, so the
        # 0.4%-of-amax int8 rounding compounds where a feedforward path
        # sees it once; and the bank is a negligible fraction of the
        # parameter bytes at scale (the 10k-neuron memory/OVC banks
        # dominate).  Keep it in the cast dtype — measured at d=393,
        # int8-everywhere lost tracking on 1/4 seeds (0.83 median) while
        # int8-except-recurrence holds f32 parity (0.094 vs 0.090
        # overall, VALIDATION.md) at the same ~4x traffic cut on the
        # dominant banks.
        return (bc.post_kind in ("ens", "ea_elem", "ea_batch", "neurons")
                and getattr(bc.post, "index", None) is not None
                and getattr(bc.pre, "index", "x") == bc.post.index
                and bc.pre_kind != "node")

    conn_const = {}
    for bc in model.connections:
        d = {}
        if bc.weights is not None:
            # every W form contracts its LAST axis (input dim / pre
            # neurons): matmul(W, v), ein("kds,s->kd"), ein("knm,km->kn")
            d["W"] = _p(bc.weights, caxis=None if _recurrent(bc) else -1)
        if bc.decoders is not None and bc.learned_slot is None:
            # decoders contract the NEURON axis (second-to-last):
            # matmul(act, D), ein("kn,knd->kd")
            d["D"] = _p(bc.decoders, caxis=None if _recurrent(bc) else -2)
        conn_const[str(bc.index)] = d
    probe_const = {}
    for bp in model.probes:
        d = {}
        if bp.decoders is not None:
            d["D"] = _p(bp.decoders, caxis=-2)
        probe_const[str(bp.index)] = d
    # batched per-element decode stacks (g, n, d); the members keep their
    # individual "D" entries too (read only by weights probes, never in the
    # hot step path — XLA dead-code-eliminates unused inputs)
    dstack = {}
    for key, bcs in _elem_decode_groups(model).items():
        mats = [np.asarray(bc.decoders, np.float32)
                if isinstance(bc.decoders, np.ndarray)
                else bc.decoders for bc in bcs]
        stacked = (jnp.stack([jnp.asarray(m) for m in mats])
                   if any(not isinstance(m, np.ndarray) for m in mats)
                   else np.stack(mats))
        dstack[key] = _p(stacked, caxis=-2)
    # fused-EA layered decode stacks: full-group (k_tot, n, d) matrices with
    # each member's (k_ea, n, d) decoders scattered into its rows
    for key, bcs in _ea_batch_decode_groups(model).items():
        be = bcs[0].pre
        d_out = int(np.shape(bcs[0].decoders)[-1])
        full = jnp.zeros((be.k, be.n, d_out), jnp.float32)
        for bc in bcs:
            off, kk = bc.ea_rows
            full = full.at[off:off + kk].set(
                jnp.asarray(bc.decoders, jnp.float32))
        dstack[key] = _p(full, caxis=-2)
    # learning rates as traced values, NOT jit constants: one compiled
    # executable serves every learning-rate setting of a model shape.
    # Filter coefficients stay BAKED: traced versions measurably slow the
    # step (see make_step_fn.coeff).
    hyper = {}
    lr = {}
    for bc in model.connections:
        if bc.pes_rule is not None:
            lr[bc.learned_slot] = np.float32(bc.pes_rule.learning_rate)
        elif bc.voja_rule is not None:
            lr[bc.learned_slot] = np.float32(bc.voja_rule.learning_rate)
    hyper["lr"] = lr
    hoisted = {k: dict(v) for k, v in model.hoisted.items()}
    return {"ens": enc_params, "conn": conn_const, "probe": probe_const,
            "dstack": dstack, "hyper": hyper, "hoisted": hoisted}


def make_step_fn(model: Model, dtype=jnp.float32, matmul_dtype=None):
    """Returns ``step(state, xs, params) -> (state, emits)``.

    ``matmul_dtype``: optional reduced precision (jnp.bfloat16) for the
    encoder/decoder/weight matmul INPUTS (accumulation stays float32 via
    preferred_element_type).  Parameter reads dominate the per-step HBM
    traffic of large models; bf16 params halve it.  ``"int8"``/``"fp8"``
    read QTensor params (1 byte/weight) and apply the per-slice scale to
    the contraction OUTPUT — exact factorisation, see ops/quantize.py.
    State, filters and learned weights remain float32."""
    dt = model.dt
    filt_coeffs = [(a, b) for (_shape, a, b) in model.filter_specs]
    cascade = model.filter_cascade  # Alpha synapses: out slot -> hidden slot
    mm, _quant_kind = _parse_param_dtype(matmul_dtype)

    def cast(a):
        return a.astype(mm) if mm is not None else a

    def _qop(op, a, b):
        """Contraction with one possibly-QTensor operand: contract the
        1-byte payload (cast to the matmul input dtype; int8 <= 127 is
        exact in bf16), then restore the per-slice scale on the output —
        the scale's shape is the param's non-contracted axes, which are
        the output's trailing axes for every contraction in the step."""
        if isinstance(b, QTensor):
            return op(cast(a), b.q.astype(mm)) * b.s
        if isinstance(a, QTensor):
            return op(a.q.astype(mm), cast(b)) * a.s
        if mm is None:
            return op(a, b)
        return op(cast(a), cast(b))

    def matmul(a, b):
        if mm is None and not isinstance(b, QTensor) \
                and not isinstance(a, QTensor):
            return a @ b
        return _qop(lambda x, y: jnp.matmul(
            x, y, preferred_element_type=dtype), a, b)

    def ein(spec, a, b):
        if mm is None and not isinstance(b, QTensor) \
                and not isinstance(a, QTensor):
            return jnp.einsum(spec, a, b)
        return _qop(lambda x, y: jnp.einsum(
            spec, x, y, preferred_element_type=dtype), a, b)

    # incoming connections per unit
    node_in: Dict[int, list] = {}
    ens_in: Dict[int, list] = {}
    ens_cur: Dict[int, list] = {}   # direct neuron-current connections
    for bc in model.connections:
        if bc.post_kind == "node":
            node_in.setdefault(id(bc.post), []).append(bc)
        elif bc.post_kind in ("ens", "ea_elem", "ea_batch"):
            ens_in.setdefault(bc.post.index, []).append(bc)
        elif bc.post_kind == "neurons":
            ens_cur.setdefault(bc.post.index, []).append(bc)
        # pes/voja handled in the learning phase

    input_index = {id(n): i for i, n in enumerate(model.input_nodes)}

    # fused-EA groups whose inputs EXACTLY tile the row axis (one route per
    # member, disjoint, covering [0, k)): build the group input by
    # concatenation instead of zeros + scatter-adds
    _tiled_inputs = {}
    for be_idx, bcs in ens_in.items():
        if not all(bc.post_kind == "ea_batch" and bc.ea_rows is not None
                   for bc in bcs) or len(bcs) < 2:
            continue
        order = sorted(bcs, key=lambda bc: bc.ea_rows[0])
        pos = 0
        for bc in order:
            off, kk = bc.ea_rows
            if off != pos:
                break
            pos = off + kk
        else:
            if pos == order[0].post.k:
                _tiled_inputs[be_idx] = order

    # batched per-element decode groups: bc.index -> (group key, row)
    _elem_groups = _elem_decode_groups(model)
    _elem_pos = {bc.index: (key, i)
                 for key, bcs in _elem_groups.items()
                 for i, bc in enumerate(bcs)}
    # fused-EA layered decode groups: bc.index -> group key
    _eab_pos = {bc.index: key
                for key, bcs in _ea_batch_decode_groups(model).items()
                for bc in bcs}

    def step(state, xs, params):
        with jax.default_matmul_precision(STEP_PRECISION):
            return _step(state, xs, params)

    def _step(state, xs, params):
        enc_params = params["ens"]
        conn_const = params["conn"]
        probe_const = params["probe"]
        step_no = state["step"]
        t = (step_no.astype(dtype) + 1.0) * dt
        filters = state["filters"]
        learned = state["learned"]
        node_states = state.get("nodes", {})
        new_node_states = dict(node_states)
        sig_node: Dict[int, jax.Array] = {}
        sig_act: Dict[int, jax.Array] = {}
        new_neurons = list(state["neurons"])
        dec_cache: Dict[str, jax.Array] = {}

        def elem_decode(bc):
            """Row of the batched (g, n) x (g, n, d) group decode."""
            key, i = _elem_pos[bc.index]
            if key not in dec_cache:
                bcs = _elem_groups[key]
                act = sig_act[bc.pre.index]
                acts = jnp.stack([act[b.ea_elem_index] for b in bcs])
                dec_cache[key] = ein("gn,gnd->gd", acts,
                                     params["dstack"][key])
            return dec_cache[key][i]

        def decoders_of(bc):
            if bc.learned_slot is not None:
                return learned[bc.learned_slot]
            return conn_const[str(bc.index)]["D"]

        def pre_value(bc: BuiltConnection):
            if bc.pre_kind == "node":
                v = sig_node[id(bc.pre)]
                if bc.pre_indices is not None:
                    rng = _contig(bc.pre_indices)
                    v = (v[rng[0]:rng[1]] if rng
                         else v[jnp.asarray(bc.pre_indices)])
                return v
            act = sig_act[bc.pre.index]
            if bc.pre_kind in ("ens", "ens_view"):
                return matmul(act, decoders_of(bc))
            if bc.pre_kind == "ea_elem":
                if bc.index in _elem_pos:
                    return elem_decode(bc)
                return matmul(act[bc.ea_elem_index], decoders_of(bc))
            if bc.pre_kind == "ea_batch":
                if bc.index in _eab_pos:
                    # layered group decode: ONE einsum over the whole
                    # fused group, members read their row slice
                    key = _eab_pos[bc.index]
                    if key not in dec_cache:
                        dec_cache[key] = ein("kn,knd->kd", act,
                                             params["dstack"][key])
                    off, kk = bc.ea_rows
                    return dec_cache[key][off:off + kk]
                if bc.ea_rows is not None:   # fused-EA member rows
                    off, kk = bc.ea_rows
                    act = act[off:off + kk]
                return ein("kn,knd->kd", act, decoders_of(bc))
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

        def current_value(bc: BuiltConnection):
            v = pre_value(bc)
            if bc.jnp_function is not None:
                v = jnp.asarray(bc.jnp_function(v)).reshape(-1)
            if bc.pre_kind == "ea_batch" and bc.post_kind == "node":
                v = v.reshape(-1)
            if bc.weights is not None:
                W = conn_const[str(bc.index)]["W"]
                if bc.full_weights:  # neuron->neuron currents (solver_weights)
                    v = (ein("knm,km->kn", W, v) if W.ndim == 3
                         else matmul(W, v))
                elif W.ndim == 3:  # batched input transforms (k, dim, s)
                    v = ein("kds,s->kd", W, v)
                else:
                    v = matmul(W, v)
            elif bc.scalar_weight != 1.0:
                v = bc.scalar_weight * v
            return v

        def conn_output(bc: BuiltConnection):
            if bc.synapse is not None:
                return filters[bc.filt_index]
            return current_value(bc)

        def gather_node_input(node):
            x = jnp.zeros((node.size_in,), dtype)
            for bc in node_in.get(id(node), []):
                v = conn_output(bc)
                if bc.post_indices is not None:
                    rng = _contig(bc.post_indices)
                    if rng:
                        x = x.at[rng[0]:rng[1]].add(v)
                    else:
                        x = x.at[jnp.asarray(bc.post_indices)].add(v)
                else:
                    x = x + v
            return x

        def gather_ens_input(be):
            shape = (be.k, be.dim) if be.batched else (be.dim,)
            if be.index in _tiled_inputs:
                return jnp.concatenate(
                    [conn_output(bc).reshape((bc.ea_rows[1],) + shape[1:])
                     for bc in _tiled_inputs[be.index]], axis=0)
            x = jnp.zeros(shape, dtype)
            for bc in ens_in.get(be.index, []):
                v = conn_output(bc)
                if bc.post_kind == "ea_batch":
                    if bc.ea_rows is not None:   # fused-EA member rows
                        off, kk = bc.ea_rows
                        x = x.at[off:off + kk].add(
                            v.reshape((kk,) + shape[1:]))
                    else:
                        x = x + v.reshape(shape)
                elif bc.post_kind == "ea_elem":
                    if bc.post_indices is not None:
                        rng = _contig(bc.post_indices)
                        if rng:
                            x = x.at[bc.post_elem_index,
                                     rng[0]:rng[1]].add(v)
                        else:
                            x = x.at[bc.post_elem_index,
                                     jnp.asarray(bc.post_indices)].add(v)
                    else:
                        x = x.at[bc.post_elem_index].add(v)
                else:  # ens
                    if bc.post_indices is not None:
                        rng = _contig(bc.post_indices)
                        if rng:
                            x = x.at[rng[0]:rng[1]].add(v)
                        else:
                            x = x.at[jnp.asarray(bc.post_indices)].add(v)
                    else:
                        x = x + v
            return x

        # ---- same-step topological evaluation -----------------------------
        for kind, obj in model.topo_units:
            if kind == "node":
                info = model.node_info[id(obj)]
                nk = info["kind"]
                if nk == "tabulated":
                    sig_node[id(obj)] = xs[input_index[id(obj)]]
                elif nk == "const":
                    sig_node[id(obj)] = jnp.asarray(info["const"], dtype)
                elif nk == "jnp_func":
                    x = gather_node_input(obj)
                    hk = info.get("hoisted_key")
                    slot = info.get("state_slot")
                    if slot is not None:
                        # stateful node: f(t, x, s, consts=None)->(out, s')
                        kw = ({"consts": params["hoisted"][hk]}
                              if hk is not None else {})
                        out, ns = obj.output(t, x, node_states[slot], **kw)
                        new_node_states[slot] = jnp.asarray(ns, jnp.float32)
                    elif hk is not None:
                        out = obj.output(t, x,
                                         consts=params["hoisted"][hk])
                    elif obj.size_in > 0:
                        out = obj.output(t, x)
                    else:
                        out = obj.output(t)
                    sig_node[id(obj)] = jnp.asarray(out, dtype).reshape(-1)
                else:  # passthrough
                    sig_node[id(obj)] = gather_node_input(obj)
            else:  # ensemble group
                be = obj
                p = enc_params[be.index]
                E = (learned[f"voja_{be.voja_conn_index}"]
                     if be.voja_conn_index is not None else p["scaled_encoders"])
                x = gather_ens_input(be)
                if be.batched:
                    J = ein("knd,kd->kn", E, x) + p["bias"]
                else:
                    J = matmul(E, x) + p["bias"]
                for bc in ens_cur.get(be.index, []):
                    v = conn_output(bc)
                    nl = be.n - be.n_pad
                    if bc.full_weights or be.n_pad == 0:
                        if bc.post_elem_index is not None:  # fused element
                            J = J.at[bc.post_elem_index].add(v)
                        else:
                            J = J + v.reshape(J.shape)
                    elif bc.post_elem_index is not None:
                        J = J.at[bc.post_elem_index, :nl].add(v)
                    else:
                        J = J.at[..., :nl].add(
                            v.reshape(J.shape[:-1] + (nl,)))
                ns, out = be.neuron_type.step(new_neurons[be.index], J, dt)
                new_neurons[be.index] = ns
                sig_act[be.index] = out

        # ---- filter updates ----------------------------------------------
        new_filters = list(filters)

        def coeff(fi):
            # literal (a, b): runtime scalars in every filter update
            # defeat XLA's constant folding into the surrounding fusions.
            # Learning rates stay traced (used once per step);
            # synapse-tau changes recompile.
            return filt_coeffs[fi]

        def update_filter(fi, u):
            a, b = coeff(fi)
            if fi in cascade:  # Alpha: first stage feeds the output stage
                h = cascade[fi]
                ah, bh = coeff(h)
                u = ah * filters[h] + bh * u
                new_filters[h] = u
            new_filters[fi] = a * filters[fi] + b * u

        for bc in model.connections:
            if bc.filt_index is not None:
                update_filter(bc.filt_index, current_value(bc))
            if bc.pes_act_filt_index is not None:
                src = (sig_act[bc.post.index] if bc.voja_rule is not None
                       else sig_act[bc.pre.index])
                update_filter(bc.pes_act_filt_index, src)

        # ---- learning updates --------------------------------------------
        new_learned = dict(learned)
        for bc in model.connections:
            if bc.pes_rule is not None:
                err = jnp.zeros((bc.decoders.shape[-1]
                                 if bc.decoders is not None else 0,), dtype)
                for rci in bc.rule_target_conns:
                    rc = model.connections[rci]
                    err = err + conn_output(rc)
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[bc.pre.index])
                new_learned[bc.learned_slot] = learning_ops.pes_update(
                    learned[bc.learned_slot], acts, err,
                    params["hyper"]["lr"][bc.learned_slot], dt,
                    n_neurons=bc.pre.n - bc.pre.n_pad)
            elif bc.voja_rule is not None:
                gate = jnp.zeros((1,), dtype)
                for rci in bc.rule_target_conns:
                    rc = model.connections[rci]
                    gate = gate + conn_output(rc)
                learning_signal = 1.0 + gate[0]
                be = bc.post
                acts = (new_filters[bc.pes_act_filt_index]
                        if bc.pes_act_filt_index is not None
                        else sig_act[be.index])
                pre_v = current_value(bc)
                scale = enc_params[be.index]["gain"] / be.radius
                new_learned[bc.learned_slot] = learning_ops.voja_update(
                    learned[bc.learned_slot], acts, pre_v, learning_signal,
                    scale, params["hyper"]["lr"][bc.learned_slot], dt)

        # ---- probes -------------------------------------------------------
        emits = {}
        for bp in model.probes:
            if bp.kind == "node":
                v = sig_node[id(bp.target)]
            elif bp.kind == "ens_decoded":
                act = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    act = act[bp.elem_index]
                v = matmul(act, probe_const[str(bp.index)]["D"])
            elif bp.kind == "activities":
                v = sig_act[bp.target.index]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "voltage":
                v = new_neurons[bp.target.index]["voltage"]
                if bp.elem_index is not None:
                    v = v[bp.elem_index]
                if bp.target.n_pad:
                    v = v[..., :bp.target.n - bp.target.n_pad]
            elif bp.kind == "weights":
                D = (new_learned[bp.target.learned_slot]
                     if bp.target.learned_slot else conn_const[str(bp.target.index)]["D"])
                if isinstance(D, QTensor):   # quantised static decoders
                    D = D.dequant()
                v = D.T if D.ndim == 2 else D
            elif bp.kind == "scaled_encoders":
                v = new_learned[bp.target.learned_slot]
            else:
                raise TypeError(bp.kind)
            if bp.filt_index is not None:
                a, b = coeff(bp.filt_index)
                if bp.filt_index in cascade:
                    h = cascade[bp.filt_index]
                    ah, bh = coeff(h)
                    v = ah * new_filters[h] + bh * v
                    new_filters[h] = v
                v = a * new_filters[bp.filt_index] + b * v
                new_filters[bp.filt_index] = v
            if not bp.sparse:
                emits[bp.index] = v

        new_state = {
            "step": step_no + 1,
            "neurons": new_neurons,
            "filters": new_filters,
            "learned": new_learned,
            "nodes": new_node_states,
        }
        return new_state, emits

    return step


def sparse_probe_value(model: Model, state, bp: BuiltProbe):
    """Host-side read of a sparse (weights / scaled_encoders) probe from the
    carry at a segment boundary."""
    if bp.kind == "weights":
        D = (state["learned"][bp.target.learned_slot]
             if bp.target.learned_slot else bp.target.decoders)
        import numpy as np
        D = np.asarray(D)
        return D.T if D.ndim == 2 else D
    if bp.kind == "scaled_encoders":
        import numpy as np
        return np.asarray(state["learned"][bp.target.learned_slot])
    raise TypeError(bp.kind)
