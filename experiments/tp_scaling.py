"""Tensor-parallel scaling probe: the FULL SLAM learning step sharded over a
{1,2,4,8}-device mesh of virtual CPU devices (see docs/MULTICHIP.md).

For each mesh size this measures
  * median wall time per scan segment (NOTE: the virtual devices share one
    physical host core, so wall time measures sharding OVERHEAD, not speedup
    — the interesting wall-clock column is how little it degrades);
  * the collective inventory of the compiled program (all-reduce / all-gather
    / collective-permute instruction counts and all-reduce bytes) — the
    per-step inter-device traffic a real multi-device run would carry;
  * per-device FLOPs from XLA's cost analysis, which SHOULD fall ~1/n.

Usage: JAX_PLATFORMS=cpu python experiments/tp_scaling.py [--steps 200]
"""

import argparse
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# hoist the clean-up sample bank into the traced params so its similarity
# matvec can SHARD over the mesh (params_shardings) instead of running
# replicated on every device (~2 MFLOP/step at reference scale)
os.environ.setdefault("SSPSLAM_HOIST_CLEANUP", "1")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_slam(args, mesh=None):
    import sspslam_tpu
    from sspslam_tpu import HexagonalSSPSpace, SPSpace
    from sspslam_tpu.models import SLAMNetwork, get_slam_input_functions
    from sspslam_tpu.nef import Connection, Network, Node, Probe, Simulator

    dt = 0.001
    seed = 0
    rng = np.random.default_rng(seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=seed,
                              length_scale=0.3, domain_bounds=bounds)
    d = space.ssp_dim
    n_steps = args.steps + 10
    ts = dt * np.arange(n_steps)
    path = 0.6 * np.stack([np.sin(2 * ts), np.cos(3 * ts)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = rng.uniform(-0.5, 0.5, size=(args.n_landmarks, 2))
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = SPSpace(args.n_landmarks, d, seed=seed)
    (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec_to_lm, 0.8)
    ssp0 = space.encode(path[:1]).flatten()
    with Network(seed=seed) as net:
        vel = Node(velocity_func)
        init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        lm_id = Node(sp_f)
        lm_ssp = Node(vecssp_f)
        in_view = Node(in_view_f)
        slam = SLAMNetwork(space, lm_space, 0.8, args.n_landmarks,
                           pi_n_neurons=args.pi_n_neurons,
                           mem_n_neurons=args.mem_n_neurons,
                           circonv_n_neurons=args.circonv_n_neurons,
                           vel_scaling_factor=scale,
                           cleanup_samples_per_dim=30, seed=seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        Probe(slam.pathintegrator.output, synapse=0.05)
    sim = Simulator(net, seed=seed, mesh=mesh)
    return sim


def collective_stats(compiled):
    txt = compiled.as_text()
    stats = {}
    for op in ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all"):
        stats[op] = len(re.findall(rf"\b{op}(?:-start)?\(", txt)) + \
            len(re.findall(rf"= {op}", txt))
    # crude all-reduce byte count: f32[...] shapes on all-reduce lines
    ar_bytes = 0
    for line in txt.splitlines():
        if "all-reduce" in line and "=" in line:
            m = re.search(r"f32\[([0-9,]*)\]", line)
            if m:
                dims = [int(x) for x in m.group(1).split(",") if x]
                ar_bytes += 4 * int(np.prod(dims)) if dims else 4
    stats["all_reduce_bytes"] = ar_bytes
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ssp-dim", type=int, default=55)
    ap.add_argument("--pi-n-neurons", type=int, default=200)
    ap.add_argument("--mem-n-neurons", type=int, default=400)
    ap.add_argument("--circonv-n-neurons", type=int, default=50)
    ap.add_argument("--n-landmarks", type=int, default=8)
    ap.add_argument("--mesh-sizes", default="1,2,4,8")
    ap.add_argument("--unroll", type=int, default=4,
                    help="scan-body unroll (the collective/FLOP/bytes "
                         "analysis is unroll-independent; 1 keeps the "
                         "d=727 compile tractable on a single host core)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--build-once", action="store_true",
                    help="build a single model padded to the LARGEST mesh "
                         "and reuse it for every mesh size (phantom rows "
                         "are exact zeros; all sizes divide the max pad, "
                         "and the shared padding makes the per-device "
                         "FLOP/byte ratios directly comparable)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import jax
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from sspslam_tpu.parallel.sharding import state_shardings

    cpu_devs = np.asarray(jax.devices("cpu"))
    log(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}; "
        f"mesh devices: {len(cpu_devs)} cpu")

    def cpu_mesh(n):
        return Mesh(cpu_devs[:n], ("model",))

    mesh_sizes = [int(x) for x in args.mesh_sizes.split(",")]
    shared_sim = None
    if args.build_once:
        t0 = time.time()
        shared_sim = build_slam(args, mesh=cpu_mesh(max(mesh_sizes)))
        # pull solved params to host: the analysis jits re-place them on
        # each CPU mesh
        shared_params = jax.tree_util.tree_map(np.asarray, shared_sim.params)
        log(f"built once (pad={max(mesh_sizes)}) in {time.time() - t0:.0f}s")

    rows = []
    ideal_flops = None
    ideal_bytes = None
    for n_dev in mesh_sizes:
        mesh = cpu_mesh(n_dev)
        if shared_sim is not None:
            sim, params = shared_sim, shared_params
        else:
            # rebuild per mesh: batched element axes pad to n_dev multiples
            # (builder pad_batched_to) so GSPMD shards them evenly — the
            # d=97 flagship's k=49 VCO bank divides no power-of-two mesh
            # unpadded
            sim = build_slam(args, mesh=mesh if n_dev > 1 else None)
            params = jax.tree_util.tree_map(np.asarray, sim.params)
        model = sim.model
        step = sim._step_fn
        T = args.steps
        xs_cols = [np.asarray(c)[:T] for c in sim._tabulate_inputs(T)]
        n_neurons = sum((be.k * be.n if be.batched else be.n)
                        for be in model.ensembles)
        ks = [be.k for be in model.ensembles if be.batched]
        log(f"mesh={n_dev}: total neurons={n_neurons}, "
            f"batched group sizes={ks}")
        shardings = state_shardings(model, mesh)
        state0 = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(np.asarray(x), s),
            model.initial_state(), shardings)

        def scan_fn(state, xs, params):
            def body(carry, x):
                return step(carry, x, params)
            return jax.lax.scan(body, state, xs, unroll=args.unroll)

        from sspslam_tpu.parallel.sharding import (params_shardings,
                                                   replicated)
        rep = replicated(mesh)
        fn = jax.jit(scan_fn,
                     in_shardings=(shardings, [rep] * len(xs_cols),
                                   params_shardings(params, mesh, model=model)))
        lowered = fn.lower(state0, xs_cols, params)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        flops = float(cost.get("flops", float("nan"))) if cost else float("nan")
        # per-device HBM traffic of the compiled per-device program.  At
        # the HBM-bound scale (d>=385 single-episode; VALIDATION.md scale
        # table) the binding resource is parameter-read BYTES, not FLOPs —
        # TP pays exactly when this column falls ~1/n (each shard reads
        # only its slice of the decoder/encoder banks)
        bytes_acc = (float(cost.get("bytes accessed", float("nan")))
                     if cost else float("nan"))
        stats = collective_stats(compiled)

        out = fn(state0, xs_cols, params)
        jax.block_until_ready(out)
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            out = fn(state0, xs_cols, params)
            jax.block_until_ready(out)
            times.append(time.time() - t0)
        med = float(np.median(times))
        if n_dev == 1 and ideal_flops is None:
            ideal_flops = flops
            ideal_bytes = bytes_acc
        ratio = (flops / (ideal_flops / n_dev)
                 if ideal_flops and np.isfinite(flops) else float("nan"))
        bratio = (bytes_acc / (ideal_bytes / n_dev)
                  if ideal_bytes and np.isfinite(bytes_acc)
                  else float("nan"))
        row = {"mesh": n_dev, "wall_s_per_segment": round(med, 4),
               "steps_per_s": round(T / med, 1),
               "flops_per_segment": flops,
               "per_device_flops_vs_ideal": round(ratio, 3),
               "bytes_accessed_per_segment": bytes_acc,
               "per_device_bytes_vs_ideal": round(bratio, 3), **stats}
        rows.append(row)
        log(f"mesh={n_dev}: {med*1e3:.1f} ms/segment ({T/med:.0f} steps/s), "
            f"all-reduce={stats['all-reduce']} "
            f"({stats['all_reduce_bytes']/1e3:.1f} kB/step-segment), "
            f"all-gather={stats['all-gather']}, flops={flops:.3g}, "
            f"vs-ideal={row['per_device_flops_vs_ideal']}; "
            f"bytes={bytes_acc:.3g}, "
            f"bytes-vs-ideal={row['per_device_bytes_vs_ideal']}")

    print(json.dumps(rows, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
