"""Neuron models: rate curves, gain/bias solving, and stateful spiking
updates as pure jnp functions.

These supply the capability the reference obtains from nengo's neuron types
(``LIF``, ``LIFRate``, ``RectifiedLinear`` — selected at reference
run_pathint.py:111-116) but as functional state transformers usable inside
``lax.scan``.  All state arrays broadcast: shapes may be (n,) or (k, n)
for batched ensemble arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NeuronType", "LIF", "LIFRate", "RectifiedLinear",
           "SpikingRectifiedLinear", "QuantizedLIF", "LoihiLIF",
           "SurrogateLIF"]


@dataclasses.dataclass(frozen=True)
class NeuronType:
    """Base neuron type. ``rates`` is the static response curve used for
    decoder solving; ``step`` advances dynamic state one dt."""

    amplitude: float = 1.0
    spiking: bool = False

    def gain_bias(self, max_rates: np.ndarray, intercepts: np.ndarray):
        raise NotImplementedError

    def rates(self, J):
        raise NotImplementedError

    def rates_np(self, J: np.ndarray) -> np.ndarray:
        """Host NumPy twin of ``rates`` for build-time decoder solving."""
        raise NotImplementedError

    def init_state(self, shape, dtype=np.float32):
        """Zero state as host arrays (converted on first device call)."""
        return {}

    def step(self, state: Dict[str, jax.Array], J: jax.Array, dt: float):
        """Return (new_state, output). Output units: spikes are scaled by
        amplitude/dt so filtered spike trains approximate rates."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RectifiedLinear(NeuronType):
    """rate = amplitude * max(J, 0)."""

    def gain_bias(self, max_rates, intercepts):
        gain = max_rates / (1.0 - intercepts)
        bias = -intercepts * gain
        return gain, bias

    def rates(self, J):
        return self.amplitude * jnp.maximum(J, 0.0)

    def rates_np(self, J):
        return self.amplitude * np.maximum(J, 0.0)

    def step(self, state, J, dt):
        return state, self.rates(J)


@dataclasses.dataclass(frozen=True)
class SpikingRectifiedLinear(RectifiedLinear):
    """Integrate-and-fire with a linear response curve."""

    spiking: bool = True

    def init_state(self, shape, dtype=np.float32):
        return {"voltage": np.zeros(shape, dtype)}

    def step(self, state, J, dt):
        v = state["voltage"] + jnp.maximum(J, 0.0) * dt
        n_spikes = jnp.floor(v)
        out = (self.amplitude / dt) * n_spikes
        return {"voltage": v - n_spikes}, out


@dataclasses.dataclass(frozen=True)
class LIFRate(NeuronType):
    """Leaky integrate-and-fire rate approximation:
    rate = amplitude / (tau_ref + tau_rc * log1p(1/(J-1))) for J > 1."""

    tau_rc: float = 0.02
    tau_ref: float = 0.002

    def gain_bias(self, max_rates, intercepts):
        inv = 1.0 / (1.0 - np.exp(
            np.clip((self.tau_ref - 1.0 / np.asarray(max_rates)) / self.tau_rc,
                    None, -1e-15)))
        gain = (inv - 1.0) / (1.0 - np.asarray(intercepts))
        bias = 1.0 - gain * np.asarray(intercepts)
        return gain, bias

    def rates(self, J):
        Jm1 = jnp.maximum(J - 1.0, 0.0)
        # guard the log for J <= 1 (rate is 0 there)
        r = self.amplitude / (
            self.tau_ref + self.tau_rc * jnp.log1p(1.0 / jnp.maximum(Jm1, 1e-12)))
        return jnp.where(J > 1.0 + 1e-9, r, 0.0)

    def rates_np(self, J):
        J = np.asarray(J)
        Jm1 = np.maximum(J - 1.0, 0.0)
        r = self.amplitude / (
            self.tau_ref + self.tau_rc * np.log1p(1.0 / np.maximum(Jm1, 1e-12)))
        return np.where(J > 1.0 + 1e-9, r, 0.0)

    def step(self, state, J, dt):
        return state, self.rates(J)


@dataclasses.dataclass(frozen=True)
class LIF(LIFRate):
    """Spiking LIF with refractory period.

    Membrane relaxes toward J with time constant tau_rc; a spike is emitted
    when v crosses 1, v resets, and the neuron is refractory for tau_ref
    (with sub-dt spike-time interpolation for accuracy, the same integration
    scheme nengo's reference LIF uses).
    """

    spiking: bool = True
    min_voltage: float = 0.0

    def init_state(self, shape, dtype=np.float32):
        return {"voltage": np.zeros(shape, dtype),
                "refractory": np.zeros(shape, dtype)}

    def step(self, state, J, dt):
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = jnp.clip(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -jnp.expm1(-delta_t / self.tau_rc)

        spiked = voltage > 1.0
        # interpolate the spike time within the step for smoother rates
        denom = jnp.where(spiked, jnp.maximum(J - 1.0, 1e-12), 1.0)
        overshoot = jnp.clip((voltage - 1.0) / denom, 0.0, 1.0 - 1e-6)
        t_spike = dt + self.tau_rc * jnp.log1p(-overshoot)

        out = jnp.where(spiked, self.amplitude / dt, 0.0)
        voltage = jnp.where(spiked, 0.0, jnp.maximum(voltage, self.min_voltage))
        refractory = jnp.where(spiked, self.tau_ref + t_spike, refractory)
        return {"voltage": voltage, "refractory": refractory}, out


@dataclasses.dataclass(frozen=True)
class LoihiLIF(LIF):
    """Loihi-chip LIF discretisation (the neuron the reference's Loihi
    backends run — selected at reference run_slam.py:202-210 via
    nengo_loihi).

    Differences from the continuous-time ``LIF``:

    - no sub-dt spike-time interpolation: spikes land exactly on the dt
      grid and the membrane resets to 0, discarding overshoot;
    - the refractory period is quantised to a whole number of steps,
      ``round(tau_ref/dt)``, enforced as ``refractory = tau_ref_q + dt``;
    - consequently inter-spike intervals for constant input are EXACT
      integer step counts: ``isi = round(tau_ref/dt) +
      ceil((tau_rc/dt)·log1p(1/(J-1)))``, and the static rate curve used for
      decoder solving is ``amplitude / (dt·isi)`` — the discrete update law's
      own closed form, so the rate curve and the spiking dynamics agree
      bit-exactly (tests/test_nef.py::TestLoihiLIF).

    ``dt`` here is the discretisation step baked into the rate curve; it
    must match the simulator dt (default 0.001 everywhere).
    """

    dt: float = 0.001

    def _isi_steps_np(self, J):
        j = np.asarray(J, np.float64) - 1.0
        r = np.round(self.tau_ref / self.dt)
        m = np.ceil((self.tau_rc / self.dt)
                    * np.log1p(1.0 / np.maximum(j, 1e-12)))
        return r + m

    def rates_np(self, J):
        isi = self._isi_steps_np(J)
        r = self.amplitude / (self.dt * isi)
        return np.where(np.asarray(J) > 1.0 + 1e-9, r, 0.0)

    def rates(self, J):
        j = jnp.maximum(J - 1.0, 1e-12)
        rq = round(self.tau_ref / self.dt)
        m = jnp.ceil((self.tau_rc / self.dt) * jnp.log1p(1.0 / j))
        r = self.amplitude / (self.dt * (rq + m))
        return jnp.where(J > 1.0 + 1e-9, r, 0.0)

    def step(self, state, J, dt):
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = jnp.clip(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -jnp.expm1(-delta_t / self.tau_rc)
        spiked = voltage > 1.0
        out = jnp.where(spiked, self.amplitude / dt, 0.0)
        voltage = jnp.where(spiked, 0.0, jnp.maximum(voltage, self.min_voltage))
        tau_ref_q = dt * np.round(self.tau_ref / dt)
        refractory = jnp.where(spiked, tau_ref_q + dt, refractory)
        return {"voltage": voltage, "refractory": refractory}, out


@jax.custom_jvp
def _spike_surrogate(x, beta):
    """Heaviside(x) forward; fast-sigmoid pseudo-derivative backward.

    The standard surrogate-gradient trick for backprop through spiking
    networks: the primal is the exact 0/1 spike indicator, the tangent is
    d/dx [sigmoid-like] = beta / (beta*|x| + 1)^2 (SuperSpike / Zenke &
    Ganguli 2018 form), so ``jax.grad`` sees a smooth spike while the
    forward simulation stays bit-identical to the hard threshold."""
    x = jnp.asarray(x)
    return (x > 0).astype(x.dtype)


@_spike_surrogate.defjvp
def _spike_surrogate_jvp(primals, tangents):
    x, beta = primals
    dx, _ = tangents
    y = _spike_surrogate(x, beta)
    sg = beta / jnp.square(beta * jnp.abs(x) + 1.0)
    return y, sg * dx


@dataclasses.dataclass(frozen=True)
class SurrogateLIF(LIF):
    """Spiking LIF whose FORWARD pass is :class:`LIF` (same spike trains;
    agreement to f32 roundoff) but whose spike nonlinearity carries a
    surrogate gradient, making the simulator's ``lax.scan`` differentiable
    end-to-end (``sspslam_tpu.train``).

    The reference stack has no trainable-by-backprop path (nengo_dl fills
    that role in the nengo ecosystem); here it falls out of the jitted
    functional step: spikes become ``_spike_surrogate(v - 1)`` — 0/1 in the
    primal, a fast-sigmoid bump of width ``1/beta`` in the tangent — and all
    select/reset arithmetic is written multiplicatively so gradients flow
    through voltage, current, and (via the chain through encoders/decoders)
    every upstream parameter.

    ``beta``: surrogate sharpness; larger = closer to the true (zero-a.e.)
    derivative, smaller = smoother/lower-variance gradients.
    """

    beta: float = 10.0

    def step(self, state, J, dt):
        voltage = state["voltage"]
        refractory = state["refractory"] - dt
        delta_t = jnp.clip(dt - refractory, 0.0, dt)
        voltage = voltage + (J - voltage) * -jnp.expm1(-delta_t / self.tau_rc)

        s = _spike_surrogate(voltage - 1.0, self.beta)   # 0/1, smooth tangent
        spiked = voltage > 1.0                            # hard mask for guards
        denom = jnp.where(spiked, jnp.maximum(J - 1.0, 1e-12), 1.0)
        overshoot = jnp.clip((voltage - 1.0) / denom, 0.0, 1.0 - 1e-6)
        t_spike = dt + self.tau_rc * jnp.log1p(-overshoot)

        out = s * (self.amplitude / dt)
        # multiplicative reset/select: forward-equal to LIF's where() (s is
        # exactly 0 or 1) but differentiable through both branches
        voltage = (1.0 - s) * jnp.maximum(voltage, self.min_voltage)
        refractory = (s * (self.tau_ref + t_spike)
                      + (1.0 - s) * refractory)
        return {"voltage": voltage, "refractory": refractory}, out


@dataclasses.dataclass(frozen=True)
class QuantizedLIF(LIF):
    """LIF with voltage/current quantisation, the execution-config analogue
    of neuromorphic-hardware neurons (the reference's Loihi deployments run
    LoihiLIF with fixed-point state; here quantisation emulates that
    discretisation while staying a pure jnp state update).

    ``levels``: number of representable voltage levels in [0, 1].
    """

    levels: int = 256

    def step(self, state, J, dt):
        q = float(self.levels)
        state, out = LIF.step(self, state, J, dt)
        v = jnp.round(state["voltage"] * q) / q
        return {"voltage": v, "refractory": state["refractory"]}, out
