"""Decoder solving: regularised least squares over sampled evaluation points.

Replaces nengo's ``LstsqL2`` build step (used for every decoded connection in
the reference, e.g. pathintegration.py:180-185).  Solves are a build-time
activity; they run in float64 on the host for numerical robustness — the VCO
limit-cycle feedback function is sensitive to decoder error.  A batched
variant solves all elements of an EnsembleArray in one call.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lstsq_l2", "lstsq_l2_batched", "solve_decoders_on_device",
           "solve_decoders_batched_on_device"]

#: ensembles with at least this many neurons route their decoder solve
#: through the accelerator (J/rates/normal-equations/Cholesky on device);
#: below it, host BLAS wins (no transfer, f64 factorisation)
DEVICE_SOLVE_MIN_NEURONS = 2048

#: batched (EnsembleArray) solves move on-device when the rate tabulation
#: k*P*n exceeds this — at reference scale the VCO bank's host rates_np and
#: batched normal equations dominate build time (~60 s on the 1-core host)
DEVICE_SOLVE_MIN_BATCH_ELEMS = 5_000_000


#: jitted solver pipelines, keyed by (kind, neuron_type identity, reg) — a
#: fresh ``@jax.jit`` per call would recompile the identical program for
#: every ensemble group in the model
_jit_solver_cache: dict = {}

#: matmul precision of the device solves: float32 throughout, as the host
#: solve is.  Left to the platform default, the (n, n) Gram matrices would
#: run in TF32 on a GPU's tensor cores (~3 decimal digits), and the solved
#: decoders would differ from the host's by more than float32 rounding.
SOLVE_PRECISION = "highest"


def _neuron_key(neuron_type):
    items = []
    for k, v in sorted(vars(neuron_type).items()):
        try:
            hash(v)
        except TypeError:
            # unhashable attribute (e.g. a per-neuron array parameter):
            # key by identity — the solve still jits (neuron_type is a
            # closure constant), it just doesn't share a cache entry
            v = (type(v).__name__, id(v))
        items.append((k, v))
    return (type(neuron_type).__name__, tuple(items))


def solve_decoders_on_device(neuron_type, scaled_encoders, bias, eval_points,
                             targets, reg: float = 0.1):
    """Full decoder-solve pipeline on the accelerator for LARGE ensembles:
    currents, rate curves, the (n, n) normal equations and the Cholesky
    factorisation all run on device in float32 (the reference's accelerated
    backend solves in f32 as well); only encoders/eval points go UP — the
    solved decoders stay device-resident (returned as a jax array) so they
    never cross the host boundary at all: the compiled executor consumes
    them in place, and anything host-side (interpreter, checkpoints)
    converts lazily.  Unlocks the BASELINE scaled sweep (1e4-neuron
    ensembles) on a single-core host and keeps build time off the
    host-device link."""
    import jax
    import jax.numpy as jnp

    key = ("single", _neuron_key(neuron_type), float(reg))
    _solve = _jit_solver_cache.get(key)
    if _solve is None:
        @jax.jit
        @jax.default_matmul_precision(SOLVE_PRECISION)
        def _solve(E, b, ep, Y):
            A = neuron_type.rates(ep @ E.T + b[None, :])      # (m, n)
            m = A.shape[0]
            sigma = reg * jnp.max(A)
            G = A.T @ A + m * sigma**2 * jnp.eye(A.shape[1], dtype=A.dtype)
            B = A.T @ Y
            L = jnp.linalg.cholesky(G)
            z = jax.scipy.linalg.solve_triangular(L, B, lower=True)
            return jax.scipy.linalg.solve_triangular(L.T, z, lower=False)
        _jit_solver_cache[key] = _solve

    return _solve(jnp.asarray(scaled_encoders, jnp.float32),
                  jnp.asarray(bias, jnp.float32),
                  jnp.asarray(eval_points, jnp.float32),
                  jnp.asarray(targets, jnp.float32))


def solve_decoders_batched_on_device(neuron_type, scaled_encoders, bias,
                                     eval_points, targets,
                                     reg: float = 0.1):
    """Batched (EnsembleArray) decoder solve fully on the accelerator:
    currents, rate curves, per-element normal equations and Cholesky solves.
    Only encoders/bias/eval-points go up; the (k, n, d) decoders stay
    device-resident (jax array return — see
    :func:`solve_decoders_on_device`).  Numerics match
    :func:`lstsq_l2_batched` (f32, per-element sigma).

    scaled_encoders (k, n, dim), bias (k, n), eval_points (P, dim),
    targets (P, d) or (k, P, d)  ->  (k, n, d)
    """
    import jax
    import jax.numpy as jnp

    key = ("batched", _neuron_key(neuron_type), float(reg))
    _solve = _jit_solver_cache.get(key)
    if _solve is None:
        @jax.jit
        @jax.default_matmul_precision(SOLVE_PRECISION)
        def _solve(E, b, ep, Y):
            J = (jnp.einsum("kpd,knd->kpn", ep, E) if ep.ndim == 3
                 else jnp.einsum("pd,knd->kpn", ep, E)) + b[:, None, :]
            A = neuron_type.rates(J)                          # (k, P, n)
            m = A.shape[1]
            n = A.shape[2]
            sigma = reg * jnp.max(A, axis=(1, 2))             # (k,)
            G = jnp.einsum("kpn,kpm->knm", A, A) + (
                m * sigma[:, None, None] ** 2
                * jnp.eye(n, dtype=A.dtype)[None])
            B = jnp.einsum("kpn,kpd->knd", A, Y)
            L = jnp.linalg.cholesky(G)
            z = jax.scipy.linalg.solve_triangular(L, B, lower=True)
            return jax.scipy.linalg.solve_triangular(
                jnp.swapaxes(L, -1, -2), z, lower=False)
        _jit_solver_cache[key] = _solve

    k = scaled_encoders.shape[0]
    Y = np.asarray(targets, np.float32)
    if Y.ndim == 2:
        Y = np.broadcast_to(Y, (k,) + Y.shape)
    return _solve(jnp.asarray(scaled_encoders, jnp.float32),
                  jnp.asarray(bias, jnp.float32),
                  jnp.asarray(eval_points, jnp.float32),
                  jnp.asarray(Y))


def lstsq_l2(activities: np.ndarray, targets: np.ndarray, reg: float = 0.1):
    """Solve decoders D minimising ||A D - Y||^2 + m sigma^2 ||D||^2,
    sigma = reg * max(A).

    activities : (m, n); targets : (m, d)  ->  D : (n, d)
    """
    A = np.asarray(activities, dtype=np.float32)
    Y = np.asarray(targets, dtype=np.float32)
    m, n = A.shape
    sigma = reg * A.max() if A.size else reg
    G = A.T @ A + (m * sigma**2 * np.eye(n)).astype(np.float32)
    B = A.T @ Y
    return np.linalg.solve(G, B)


def lstsq_l2_batched(activities: np.ndarray, targets: np.ndarray,
                     reg: float = 0.1):
    """Batched solve: activities (k, m, n), targets (k, m, d) or (m, d)
    shared  ->  (k, n, d)."""
    A = np.asarray(activities, dtype=np.float32)
    Y = np.asarray(targets, dtype=np.float32)
    k, m, n = A.shape
    if Y.ndim == 2:
        Y = np.broadcast_to(Y, (k,) + Y.shape)
    sigma = reg * A.max(axis=(1, 2), keepdims=True)
    At = np.ascontiguousarray(A.transpose(0, 2, 1))
    G = At @ A + (m * sigma**2 * np.eye(n)[None, :, :]).astype(np.float32)
    B = At @ Y
    return np.linalg.solve(G, B)
