"""Explicit shard_map tensor parallelism for the VCO path integrator.

The automatic path (``Simulator(mesh=...)``) lets GSPMD partition the
generic step.  This module is the hand-laid-out counterpart from SURVEY.md
§5: the (d+1)//2 oscillators are split across the mesh's ``model`` axis —
each device owns its VCOs' neurons, encoders and decoders, and the ONLY
per-step communication is a single ``psum`` of the (1, d) SSP contribution
at the Fourier-reassembly matvec.  The correction input and velocity are
replicated; the filtered output is identical on every device after the
psum, so no further synchronisation is needed.

The parameters come from the engine's own solver pipeline
(:func:`vco_params` builds a :class:`PathIntegration` and reads its built
arrays), and :func:`vco_reference_scan` — the same step on one device,
plain jnp — is what the sharded scan and the generic engine are checked
against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.neurons import LIF

__all__ = ["VCOParams", "VCOState", "vco_params", "vco_initial_state",
           "vco_reference_step", "vco_reference_scan", "pad_vco_params",
           "make_sharded_vco_scan"]

F32 = jnp.float32

#: the (n, k) / (1, k) / (k, d) parameter arrays, in step order
_ARRAY_FIELDS = ("enc0", "enc1", "enc2", "bias", "drec0", "drec1", "drec2",
                 "dout0", "dout1", "velT_T", "tf0T", "tf1T", "ts0T", "ts1T",
                 "dc_mask")


class VCOParams(NamedTuple):
    """Static per-model parameters (all float32, all 2-D).

    enc0/1/2 : (n, k) scaled encoders per state component
    bias : (n, k)
    drec0/1/2 : (n, k) recurrent decoders (DC oscillator column zeroed)
    dout0/1 : (n, k) output (identity) decoders, Re/Im components
    velT_T : (N, k) velocity -> per-VCO frequency projection
    tf0T/tf1T : (d, k) SSP-correction -> per-VCO Re/Im projection
    ts0T/ts1T : (k, d) per-VCO Re/Im -> SSP reconstruction
    dc_mask : (1, k) one-hot on the DC oscillator (its [1,0,0] pin)
    """
    enc0: jax.Array
    enc1: jax.Array
    enc2: jax.Array
    bias: jax.Array
    drec0: jax.Array
    drec1: jax.Array
    drec2: jax.Array
    dout0: jax.Array
    dout1: jax.Array
    velT_T: jax.Array
    tf0T: jax.Array
    tf1T: jax.Array
    ts0T: jax.Array
    ts1T: jax.Array
    dc_mask: jax.Array
    a_rec: float
    b_rec: float
    a_out: float
    b_out: float
    tau_rc: float
    tau_ref: float
    dt: float


class VCOState(NamedTuple):
    voltage: jax.Array      # (n, k)
    refractory: jax.Array   # (n, k)
    f0: jax.Array           # (1, k) filtered recurrent Re
    f1: jax.Array           # (1, k) filtered recurrent Im
    f2: jax.Array           # (1, k) filtered recurrent freq
    fout: jax.Array         # (1, d) filtered output SSP


def vco_params(ssp_space, n_neurons, recurrent_tau=0.05, scaling_factor=1.0,
               stable=True, max_radius=1.0, tau_probe=0.05,
               seed: Optional[int] = 0, dt: float = 0.001) -> VCOParams:
    """Build a spiking-LIF :class:`PathIntegration` through the engine and
    lay its VCO bank out as (n, k) slabs — the same encoders, decoders and
    gains the generic step uses."""
    from ..models.pathintegration import PathIntegration
    from ..nef import Network, Node
    from ..nef.builder import build
    from ..ops import vsa

    d = ssp_space.ssp_dim
    N = ssp_space.domain_dim
    k = (d + 1) // 2
    with Network(seed=seed) as net:
        Node(size_in=N, output=None, label="vel_stub")
        PathIntegration(ssp_space, n_neurons, recurrent_tau,
                        scaling_factor=scaling_factor, stable=stable,
                        max_radius=max_radius, neuron_type=LIF())
    model = build(net, dt=dt, seed=seed)
    be = next(b for b in model.ensembles if b.batched)
    rec_bc = next(c for c in model.connections
                  if c.pre_kind == "ea_batch" and c.post_kind == "ea_batch")
    out_bc = next(c for c in model.connections
                  if c.pre_kind == "ea_batch" and c.post_kind == "node")
    a_rec = np.exp(-dt / recurrent_tau)
    a_out = np.exp(-dt / tau_probe)
    nt = be.neuron_type

    enc = np.asarray(be.scaled_encoders)      # (k, n, 3)
    drec = np.asarray(rec_bc.decoders)        # (k, n, 3)
    dout = np.asarray(out_bc.decoders)        # (k, n, 3)
    tof = vsa.to_fourier_matrix(d)            # (3k, d)
    fromf = vsa.from_fourier_matrix(d)        # (d, 3k)

    def f32(a):
        return jnp.asarray(a, F32)

    return VCOParams(
        enc0=f32(enc[:, :, 0].T), enc1=f32(enc[:, :, 1].T),
        enc2=f32(enc[:, :, 2].T), bias=f32(np.asarray(be.bias).T),
        drec0=f32(drec[:, :, 0].T), drec1=f32(drec[:, :, 1].T),
        drec2=f32(drec[:, :, 2].T),
        dout0=f32(dout[:, :, 0].T), dout1=f32(dout[:, :, 1].T),
        velT_T=f32(ssp_space.phase_matrix[:k].T),
        tf0T=f32(tof[0::3, :].T), tf1T=f32(tof[1::3, :].T),
        ts0T=f32(fromf[:, 0::3].T), ts1T=f32(fromf[:, 1::3].T),
        dc_mask=jnp.zeros((1, k), F32).at[0, 0].set(1.0),
        a_rec=float(a_rec), b_rec=float(1 - a_rec),
        a_out=float(a_out), b_out=float(1 - a_out),
        tau_rc=float(nt.tau_rc), tau_ref=float(nt.tau_ref), dt=float(dt))


def vco_initial_state(params: VCOParams) -> VCOState:
    n, k = params.bias.shape
    d = params.ts0T.shape[1]
    z = jnp.zeros
    return VCOState(voltage=z((n, k), F32), refractory=z((n, k), F32),
                    f0=z((1, k), F32), f1=z((1, k), F32), f2=z((1, k), F32),
                    fout=z((1, d), F32))


def _vco_step(p: VCOParams, state: VCOState, vel_row, corr_row,
              reduce_ssp=lambda x: x):
    """One dt of the VCO bank in (n, k)/(1, k) layout.  ``p``'s arrays may
    be one device's oscillator shard; ``reduce_ssp`` sums the partial
    (1, d) SSP over shards (identity on one device)."""
    x0 = state.f0 + corr_row @ p.tf0T + p.dc_mask
    x1 = state.f1 + corr_row @ p.tf1T
    x2 = state.f2 + vel_row @ p.velT_T
    J = p.enc0 * x0 + p.enc1 * x1 + p.enc2 * x2 + p.bias
    neurons, act = LIF(tau_rc=p.tau_rc, tau_ref=p.tau_ref).step(
        {"voltage": state.voltage, "refractory": state.refractory}, J, p.dt)

    def decode(D):
        return jnp.sum(act * D, axis=0, keepdims=True)   # (1, k)

    a, b = p.a_rec, p.b_rec
    f0 = a * state.f0 + b * decode(p.drec0)
    f1 = a * state.f1 + b * decode(p.drec1)
    f2 = a * state.f2 + b * decode(p.drec2)
    ssp = reduce_ssp(decode(p.dout0) @ p.ts0T + decode(p.dout1) @ p.ts1T)
    fout = p.a_out * state.fout + p.b_out * ssp
    return VCOState(neurons["voltage"], neurons["refractory"], f0, f1, f2,
                    fout)


def vco_reference_step(params: VCOParams, state: VCOState, vel, corr):
    """One unsharded step: returns ``(state, (d,) filtered SSP)``."""
    new = _vco_step(params, state,
                    jnp.asarray(vel, F32).reshape(1, -1),
                    jnp.asarray(corr, F32).reshape(1, -1))
    return new, new.fout[0]


@jax.jit
def vco_reference_scan(params: VCOParams, state: VCOState, vels, corrs):
    """:func:`vco_reference_step` over (T, N) velocities and (T, d)
    corrections; returns ``(state, (T, d) filtered SSP trace)``."""
    def body(s, xs):
        return vco_reference_step(params, s, *xs)
    return jax.lax.scan(body, state, (jnp.asarray(vels, F32),
                                      jnp.asarray(corrs, F32)))


def _pad_axis(arr, axis, to):
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, to - arr.shape[axis])
    return jnp.asarray(np.pad(np.asarray(arr), pad))


def pad_vco_params(params: VCOParams, n_shards: int) -> VCOParams:
    """Pad the oscillator axis k to a multiple of the mesh size (padded
    oscillators have zero encoders/decoders/bias, so they stay silent)."""
    k = params.bias.shape[1]
    k_pad = ((k + n_shards - 1) // n_shards) * n_shards
    if k_pad == k:
        return params
    rep = {name: _pad_axis(getattr(params, name),
                           0 if name in ("ts0T", "ts1T") else 1, k_pad)
           for name in _ARRAY_FIELDS}
    return params._replace(**rep)


def make_sharded_vco_scan(params: VCOParams, mesh: Mesh, n_steps: int,
                          axis: str = "model"):
    """Build ``fn(state, vel_chunk, corr_chunk) -> (state, ssp_chunk)`` with
    the oscillator axis sharded over ``mesh[axis]`` via shard_map.

    state must be created with ``fn.initial_state()`` (its k axis padded
    to the mesh size).
    """
    n_shards = mesh.shape[axis]
    params = pad_vco_params(params, n_shards)

    # shard specs: oscillator (k) axis split; d/N axes replicated
    kshard2 = P(None, axis)      # (n, k) and (1, k) and (m, k) arrays
    kshard0 = P(axis, None)      # (k, d) reassembly matrices
    rep = P(None, None)
    array_specs = tuple(kshard0 if f in ("ts0T", "ts1T") else kshard2
                        for f in _ARRAY_FIELDS)
    state_specs = VCOState(voltage=kshard2, refractory=kshard2,
                           f0=kshard2, f1=kshard2, f2=kshard2, fout=rep)

    def local_chunk(p_arrays, state: VCOState, vel_chunk, corr_chunk):
        """Runs on each device with its local oscillator shard."""
        p = params._replace(**dict(zip(_ARRAY_FIELDS, p_arrays)))

        def step(s, xs):
            # THE collective: one psum of the partial SSP over the mesh
            s = _vco_step(p, s, xs[0], xs[1],
                          reduce_ssp=lambda x: jax.lax.psum(x, axis))
            return s, s.fout
        state, outs = jax.lax.scan(step, state, (vel_chunk, corr_chunk),
                                   length=n_steps, unroll=4)
        return state, outs[:, 0, :]

    sharded = shard_map(local_chunk, mesh=mesh,
                        in_specs=(array_specs, state_specs, rep, rep),
                        out_specs=(state_specs, P(None, None)))

    dev_params = tuple(
        jax.device_put(jnp.asarray(getattr(params, f), F32),
                       NamedSharding(mesh, spec))
        for f, spec in zip(_ARRAY_FIELDS, array_specs))

    @jax.jit
    def run(state: VCOState, vel_chunk, corr_chunk):
        # (T, N) / (T, d) tables -> (T, 1, .) rows for the row-vector step
        return sharded(dev_params, state,
                       jnp.asarray(vel_chunk, F32)[:, None, :],
                       jnp.asarray(corr_chunk, F32)[:, None, :])

    def initial_state() -> VCOState:
        return jax.device_put(
            vco_initial_state(params),
            VCOState(*[NamedSharding(mesh, s) for s in state_specs]))

    run.initial_state = initial_state
    run.padded_params = params
    return run
