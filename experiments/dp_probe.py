"""Diagnose/compare batched-episode (data-parallel) scan lowerings.

vmap(scan(step)) was once found to collapse aggregate throughput even for
the PI-only model.  Candidate causes and the variants probing them:

  A  single          scan(step) over (T, s) xs — the baseline
  B  vmap-outer      vmap(scan) with xs (B, T, s)  [current run_batched_episodes]
  C  vmap-outer-T    vmap(scan) with xs (T, B, s), in_axes=1 for xs — makes
                     the per-step xs slice contiguous
  D  scan-inner      ONE scan whose body is vmap(step), xs (T, B, s) — the
                     scan itself is unbatched, so carry layouts stay put

Usage: python experiments/dp_probe.py [--batch 4] [--steps 1000] [--pi-n 800]
Prints a steps/s table (aggregate = episodes * steps / s).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--pi-n", type=int, default=800)
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--unroll", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="A,B,C,D")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    from sspslam_tpu import HexagonalSSPSpace
    from sspslam_tpu.models import PathIntegration
    from sspslam_tpu.nef import Connection, Network, Node, Probe, Simulator

    log(f"devices: {jax.devices()}")
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=0,
                              length_scale=0.3, domain_bounds=bounds)
    T, B = args.steps, args.batch
    rng = np.random.default_rng(0)
    vels = (0.02 * rng.normal(size=(T, 2))).astype(np.float32)

    with Network(seed=0) as net:
        vel = Node(lambda t: vels[min(int(round((t - 0.001) / 0.001)),
                                      len(vels) - 1)])
        pi = PathIntegration(space, args.pi_n, 0.05)
        Connection(vel, pi.velocity_input, synapse=None)
        Probe(pi.output, synapse=0.05)
    sim = Simulator(net, seed=0)
    step = sim._step_fn
    # device-resident params ONCE — passing host arrays would re-upload all
    # parameters on every chained call
    params = jax.device_put(sim.params)
    state0 = sim.model.initial_state()
    xs_cols = [np.asarray(c)[:T] for c in sim._tabulate_inputs(T)]
    unroll = args.unroll

    def scan_one(state, xs):
        def body(carry, x):
            return step(carry, x, params)
        return jax.lax.scan(body, state, xs, unroll=unroll)

    def batched_state():
        return jax.tree_util.tree_map(
            lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(),
            state0)

    results = {}

    def timeit(name, fn, state, xs, n_chain=5):
        """Chain n_chain dependent calls and only synchronise on the final
        carry: a per-call host round trip would otherwise dominate, and
        emits stay device-resident (no transfer)."""
        t0 = time.time()
        s, _ = fn(state, xs)
        jax.block_until_ready(s)
        log(f"{name}: compile+first {time.time() - t0:.1f}s")
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            s = state
            for _ in range(n_chain):
                s, _emits = fn(s, xs)
            jax.block_until_ready(s)
            times.append(time.time() - t0)
        dt_med = float(np.median(times))
        eps = (1 if name == "A" else B) * n_chain * T / dt_med
        results[name] = eps
        log(f"{name}: median {dt_med * 1e3:.1f} ms for {n_chain}x{T} steps "
            f"-> {eps:.0f} agg steps/s")

    want = set(args.variants.split(","))

    if "A" in want:
        fA = jax.jit(scan_one)
        timeit("A", fA, state0, [jnp.asarray(c) for c in xs_cols])

    if "B" in want:
        fB = jax.jit(jax.vmap(scan_one))
        xsB = [jnp.asarray(np.broadcast_to(c, (B,) + c.shape).copy())
               for c in xs_cols]
        timeit("B", fB, batched_state(), xsB)

    if "C" in want:
        fC = jax.jit(jax.vmap(scan_one, in_axes=(0, 1)))
        xsC = [jnp.asarray(np.broadcast_to(c[:, None], (T, B) + c.shape[1:])
                           .copy()) for c in xs_cols]
        timeit("C", fC, batched_state(), xsC)

    if "D" in want:
        vstep = jax.vmap(step, in_axes=(0, 0, None))

        @jax.jit
        def fD(state, xs):
            def body(carry, x):
                return vstep(carry, x, params)
            return jax.lax.scan(body, state, xs, unroll=unroll)
        xsD = [jnp.asarray(np.broadcast_to(c[:, None], (T, B) + c.shape[1:])
                           .copy()) for c in xs_cols]
        timeit("D", fD, batched_state(), xsD)

    log("")
    base = results.get("A")
    for k in sorted(results):
        rel = f"  ({results[k] / base:.2f}x single)" if base else ""
        log(f"  {k}: {results[k]:>12.0f} agg steps/s{rel}")


if __name__ == "__main__":
    main()
