"""Input signal processes.

``WhiteSignal`` reproduces the band-limited noise process the reference uses
to generate random paths (run_pathint.py:75, via nengo.processes.WhiteSignal):
Gaussian white noise shaped in the Fourier domain with a hard cutoff, unit
RMS, optionally clipped to ``y0`` at t=0."""

from __future__ import annotations

import numpy as np

__all__ = ["TimeTable", "WhiteSignal", "clamp_table", "white_signal"]


class TimeTable:
    """Time-indexed input signal backed by a precomputed (T, size) array.

    Callable ``f(t) -> row`` for parity with plain node callables (the
    reference's input nodes are all closures indexing numpy arrays by t,
    e.g. slam.py:394), but the Simulator recognises the type and SLICES the
    array directly when tabulating — the generic per-step Python call loop
    costs microseconds per step per node on the host, which at
    path-integrator scale rivals the entire on-device step.  Rows past the end repeat the last
    value (matching the closures' clamped indexing)."""

    def __init__(self, values, dt: float = 0.001):
        values = np.asarray(values, np.float32)
        self.values = values.reshape(len(values), -1)
        self.dt = float(dt)

    def __call__(self, t):
        i = int(round((t - self.dt) / self.dt))
        return self.values[min(max(i, 0), len(self.values) - 1)]

    def rows(self, start_step: int, n_steps: int) -> np.ndarray:
        """Rows for simulation steps [start_step, start_step + n_steps)."""
        T = len(self.values)
        if start_step + n_steps <= T:
            return self.values[start_step:start_step + n_steps]
        idx = np.minimum(np.arange(start_step, start_step + n_steps), T - 1)
        return self.values[idx]


def clamp_table(value, t_on: float, dt: float = 0.001) -> TimeTable:
    """TimeTable holding ``value`` while t < t_on and zeros afterwards — the
    reference's initial-state clamp node pattern (run_pathint.py:136)."""
    value = np.asarray(value, np.float32).reshape(-1)
    n_on = max(0, int(np.ceil(t_on / dt)) - 1)
    rows = np.vstack([np.tile(value, (n_on, 1)),
                      np.zeros((1, value.size), np.float32)])
    return TimeTable(rows, dt)


def white_signal(period, dt, high, rms=0.5, seed=None, size_out=1, y0=None):
    rng = np.random.default_rng(seed)
    n_steps = int(np.round(period / dt))
    n_coeffs = n_steps // 2 + 1
    freqs = np.fft.rfftfreq(n_steps, d=dt)
    coeffs = 1j * rng.standard_normal((n_coeffs, size_out))
    coeffs += rng.standard_normal((n_coeffs, size_out))
    coeffs[0] = 0.0
    coeffs[freqs > high] = 0.0
    if n_steps % 2 == 0:
        coeffs[-1] = coeffs[-1].real + 0j
    sig = np.fft.irfft(coeffs, n=n_steps, axis=0)
    cur_rms = np.sqrt(np.mean(sig**2, axis=0, keepdims=True))
    sig *= rms / np.maximum(cur_rms, 1e-12)
    if y0 is not None:
        # roll so the signal starts near y0
        idx = np.argmin(np.abs(sig[:, 0] - y0))
        sig = np.roll(sig, -idx, axis=0)
    return sig


class WhiteSignal:
    """Band-limited white-noise signal generator.

    Parameters mirror nengo.processes.WhiteSignal: period (s), high (Hz
    cutoff), rms amplitude.  ``run(t, dt)`` returns a (steps, size_out)
    array."""

    def __init__(self, period: float, high: float, rms: float = 0.5,
                 y0: float = None, seed: int = None):
        self.period = period
        self.high = high
        self.rms = rms
        self.y0 = y0
        self.seed = seed

    def run(self, t: float, dt: float = 0.001, size_out: int = 1) -> np.ndarray:
        sig = white_signal(self.period, dt, self.high, rms=self.rms,
                           seed=self.seed, size_out=size_out, y0=self.y0)
        n_steps = int(np.round(t / dt))
        reps = int(np.ceil(n_steps / sig.shape[0]))
        return np.tile(sig, (reps, 1))[:n_steps]
