"""Shared experiment-script machinery: CLI flags, path/world generation,
backend selection, and npz saving — the common skeleton of the reference's
experiments/*.py scripts.

Backend mapping (reference run_slam.py:198-210 offers cpu/ocl/loihi-sim/
loihi):

* ``jit``  (default; alias ``ocl``) — the compiled XLA path on the
  default accelerator.  This is the performance backend.
* ``cpu`` — the compiled XLA path pinned to the host CPU backend.
* ``numpy`` — the NumPy per-step reference interpreter (slow oracle;
  plays the role of nengo's CPU simulator).
* ``gated`` (aliases ``loihi-sim``, ``loihi``) — in run_slam: use the
  all-neural gated model (SLAMGatedNetwork, the reference's
  Loihi-compatible rewrite) on the jit backend.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sspslam_tpu  # noqa: E402
from sspslam_tpu.nef import WhiteSignal  # noqa: E402

DT = 0.001


def add_common_args(parser: argparse.ArgumentParser, default_T=20.0):
    parser.add_argument("--backend", default="jit", type=str,
                        help="jit|cpu|numpy|gated (ocl aliases jit; "
                             "loihi-sim/loihi alias gated)")
    parser.add_argument("--path-data", default=None, type=str,
                        help="Path to a .npy (n_timesteps x domain_dim) "
                             "trajectory; random WhiteSignal path if omitted")
    parser.add_argument("--data-dt", default=0.001, type=float)
    parser.add_argument("--domain-dim", default=2, type=int)
    parser.add_argument("--limit", default=0.1, type=float,
                        help="Max frequency content of the random path (Hz)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--T", default=default_T, type=float)
    parser.add_argument("--ssp-dim", default=97, type=int)
    parser.add_argument("--n-scales", default=0, type=int)
    parser.add_argument("--n-rotates", default=3, type=int)
    parser.add_argument("--use-rand", action="store_true")
    parser.add_argument("--length-scale", default=0.2, type=float)
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--save-plot", action="store_true")
    parser.add_argument("--save-dir", default="data")
    parser.add_argument("--save-name-extra", default="")


def normalize_backend(name: str) -> str:
    name = name.lower()
    if name in ("jit", "ocl"):
        return "jit"
    if name == "cpu":
        return "cpu"
    if name == "numpy":
        return "numpy"
    if name in ("gated", "loihi", "loihi-sim"):
        return "gated"
    raise SystemExit(f"unknown backend {name!r}")


def force_cpu_backend():
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass


def stretch_trajectory(traj, original_dt=0.02, new_dt=0.001):
    """Linear-interpolate a trajectory onto the simulation dt (reference
    run_pathint.py:57-66)."""
    n_steps = traj.shape[0]
    total_time = n_steps * original_dt
    n_timesteps = int(total_time / new_dt)
    t_orig = np.linspace(0, total_time, n_steps)
    t_new = np.linspace(0, total_time, n_timesteps)
    out = np.zeros((n_timesteps, traj.shape[1]))
    for i in range(traj.shape[1]):
        out[:, i] = np.interp(t_new, t_orig, traj[:, i])
    return out


def make_path(args, radius=1.0, max_steps=None):
    """Random band-limited path or loaded .npy, rescaled into
    [-0.9 r, 0.9 r]; returns (path, vels, T, domain_dim)."""
    dt = DT
    if args.path_data is None:
        T = args.T
        domain_dim = args.domain_dim
        path = np.hstack([
            WhiteSignal(T, high=args.limit, seed=args.seed + i).run(T, dt=dt)
            for i in range(domain_dim)])
    else:
        path = np.load(os.path.join(os.getcwd(), args.path_data))
        if max_steps:
            path = path[:max_steps]
        if args.data_dt != dt:
            path = stretch_trajectory(path, original_dt=args.data_dt, new_dt=dt)
        T = path.shape[0] * dt
        domain_dim = path.shape[1]

    for i in range(path.shape[1]):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                      * 1.8 * radius - 0.9 * radius)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    return path, vels, T, domain_dim


def make_space(args, domain_dim, radius=1.0):
    bounds = radius * np.tile([-1, 1], (domain_dim, 1))
    if args.use_rand:
        return sspslam_tpu.RandomSSPSpace(
            domain_dim, ssp_dim=args.ssp_dim, domain_bounds=bounds,
            length_scale=args.length_scale, seed=args.seed)
    if args.n_scales > 0:
        return sspslam_tpu.HexagonalSSPSpace(
            domain_dim, n_scales=args.n_scales, n_rotates=args.n_rotates,
            domain_bounds=bounds, length_scale=args.length_scale,
            seed=args.seed)
    return sspslam_tpu.HexagonalSSPSpace(
        domain_dim, ssp_dim=args.ssp_dim, domain_bounds=bounds,
        length_scale=args.length_scale, seed=args.seed)


def decode_output(ssp_space, data, domain_dim, grid=None,
                  method="from-set"):
    """``method='direct-optim'`` adds the batched on-device Newton polish
    after the grid argmax: at scale the coarse grid's quantisation alone
    contributes ~0.06 tracking error (a 30/axis grid over [-1,1]^3 has
    0.033 half-cell spacing per axis) — the polish removes the floor
    without the 10^6-row bank a reference-density 100/dim grid would
    need (SURVEY.md 'hard parts')."""
    grid = grid if grid is not None else (100 if domain_dim < 3 else 30)
    return ssp_space.decode(data, method, "grid", grid)


def kernel_value(space, r, M=200, seed=0):
    """Mean SSP similarity K(r) = cos(phi(x), phi(x + r u)) over random
    points and directions — the space's own distance->similarity map.
    Used to DERIVE gate thresholds from the space instead of hand
    constants (trigger=K(view_rad), exit=0.8 K(vr/2), cons mid-band —
    VALIDATION.md 'Derived thresholds')."""
    rng = np.random.default_rng(seed)
    dim = space.domain_dim
    u = rng.standard_normal((M, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x = rng.uniform(-0.5, 0.5, (M, dim))
    a = np.asarray(space.encode(x))
    b = np.asarray(space.encode(x + r * u))
    cs = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                  * np.linalg.norm(b, axis=1))
    return float(np.mean(cs))


def run_with_backend(sim_or_net, backend, T, **sim_kwargs):
    """Run either the jit Simulator or the NumPy interpreter; returns
    (probe_getter, elapsed_time, elapsed_thread_time)."""
    import time

    from sspslam_tpu.nef import Simulator
    from sspslam_tpu.nef.reference_backend import NumpyStepper

    if backend == "cpu":
        force_cpu_backend()
    if backend in ("jit", "cpu", "gated"):
        sim = (sim_or_net if isinstance(sim_or_net, Simulator)
               else Simulator(sim_or_net, **sim_kwargs))
        t0t = time.thread_time()
        t0 = time.time()
        sim.run(T)
        return sim.data.__getitem__, time.time() - t0, time.thread_time() - t0t
    # numpy interpreter
    sim = (sim_or_net if isinstance(sim_or_net, Simulator)
           else Simulator(sim_or_net, **sim_kwargs))
    n_steps = int(round(T / sim.dt))
    tables = [np.asarray(c) for c in sim._tabulate_inputs(n_steps)]
    stepper = NumpyStepper(sim.model)
    t0t = time.thread_time()
    t0 = time.time()
    out = stepper.run_steps(n_steps, tables)
    elapsed, elapsed_t = time.time() - t0, time.thread_time() - t0t

    def getter(probe):
        bp = next(p for p in sim.model.probes if p.obj is probe)
        return out[bp.index]

    return getter, elapsed, elapsed_t


def save_npz(args, filename, **arrays):
    os.makedirs(os.path.join(os.getcwd(), args.save_dir), exist_ok=True)
    path = os.path.join(os.getcwd(), args.save_dir, filename)
    np.savez(path, **arrays, args=np.array(vars(args), dtype=object))
    print(f"saved {path}")
