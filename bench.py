"""Benchmark: SLAMNetwork sim-step throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N}

Config matches the reference's run_slam.py defaults (ssp_dim=97 hexagonal
2-D, 800 LIF/VCO x 49 VCOs, 970-neuron memory/error/recall, 100-neuron/dim
circular-convolution nets — ~1e5 LIF neurons at dt=1 ms; reference
experiments/run_slam.py:23-34).

``vs_baseline`` is the measured speedup over this repo's NumPy per-step
interpreter (sspslam_tpu/nef/reference_backend.py) running the SAME built
model on this host — the stand-in for the reference's nengo CPU loop, which
cannot run here (nengo is not installable in this environment; the reference
repo itself publishes no numbers, see BASELINE.md).

Without ``--cpu`` the run needs a GPU and fails when JAX finds none.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: accuracy gate: a perf change that degrades tracking below this marks
#: the JSON accuracy_pass=false (round-3 review: nothing failed if an
#: optimisation silently traded correctness for steps/s)
ACCURACY_GATE = 0.93


def model_flops_per_step(model) -> float:
    from sspslam_tpu.utils.profiling import model_utilization_summary
    return float(sum(r["flops_per_step"]
                     for r in model_utilization_summary(model)))


def measure_device_us_per_step(sim, steps=2000, seg=1000):
    """Device self-time per step from XLA's own per-op accounting (the
    experiments/device_time_probe.py method), read from a profiler trace
    with ``xprof``, which must be installed."""
    import glob
    import tempfile

    import jax
    from xprof.convert import raw_to_tool_data as rtd

    tdir = tempfile.mkdtemp(prefix="bench_devtime_")
    jax.profiler.start_trace(tdir)
    sim.run_steps(steps, segment_steps=seg)
    jax.block_until_ready(sim.state)
    jax.profiler.stop_trace()
    f = glob.glob(os.path.join(tdir, "plugins/profile/*/*.xplane.pb"))
    data, _ = rtd.xspace_to_tool_data(f, "hlo_stats", {})
    rows = json.loads(data)
    cols = [c["label"] for c in rows["cols"]]
    i_t = cols.index("Total self time (us)")
    total_us = sum((r["c"][i_t].get("v") or 0) for r in rows["rows"])
    return total_us / steps


def tracking_cosine(out, space, path):
    """Mean cosine between the decoded-SSP probe ``out`` and the encoded
    true path over the last quarter of the simulated (and tabulated)
    steps — the accuracy figure gated by :data:`ACCURACY_GATE`."""
    k = min(out.shape[0], path.shape[0])
    out = out[:k]
    real = space.encode(path[:k])
    sims = np.sum(out * real, axis=1) / np.maximum(
        np.linalg.norm(out, axis=1), 1e-9)
    return float(np.mean(sims[-k // 4:]))


def trace_segment(sim, seg, trace_dir):
    """Trace one ``seg``-step segment of ``sim`` with jax.profiler into
    ``trace_dir`` and reduce the GPU kernels to per-step figures."""
    from sspslam_tpu.utils.profiling import gpu_trace_summary, trace_run
    with trace_run(trace_dir):
        sim.run_steps(seg, segment_steps=seg)
        sim.sync()
    t = gpu_trace_summary(trace_dir)
    trace = {"steps": seg, "kernels_per_step": t["n_kernels"] / seg,
             "traced_us_per_step": t["window_ns"] / seg / 1e3,
             "busy_us_per_step": t["busy_ns"] / seg / 1e3,
             "idle_share": t["idle_share"]}
    log(f"trace of {seg} steps in {trace_dir}: {trace}")
    return trace


def build(args, matmul_dtype=None, mesh=None):
    """The flagship model: returns ``(sim, probe, space, path)``.
    ``matmul_dtype`` overrides ``--bf16`` (``"int8"``, ``"fp8"``, ...);
    ``mesh`` shards the Simulator (tensor parallelism)."""
    from sspslam_tpu import HexagonalSSPSpace, SPSpace
    from sspslam_tpu.models import SLAMNetwork, get_slam_input_functions
    from sspslam_tpu.nef import Connection, LIF, Network, Node, Probe, Simulator

    dt = 0.001
    seed = args.seed
    rng = np.random.default_rng(seed)
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=seed,
                              length_scale=0.3, domain_bounds=bounds)
    d = space.ssp_dim
    # FIXED world length: the path/landmark world (and so the tracking
    # sanity figure) must not change with the timing knobs (segment length
    # / timed steps); 14 s matches the round-1/2 default world.  Steps
    # beyond the horizon run on clamped (last-row) inputs and are excluded
    # from the tracking comparison.
    T_data = args.world_T
    n_steps = int(T_data / dt)
    ts = dt * np.arange(n_steps)
    path = 0.8 * np.stack([np.sin(2 * np.pi * ts / T_data),
                           np.cos(4 * np.pi * ts / T_data)], axis=1)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    landmarks = rng.uniform(-0.7, 0.7, size=(args.n_landmarks, 2))
    vec_to_lm = landmarks[None, :, :] - path[:, None, :]
    lm_space = SPSpace(args.n_landmarks, d, seed=seed)

    (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
        get_slam_input_functions(space, lm_space, vels, vec_to_lm, 0.8)

    ssp0 = space.encode(path[:1]).flatten()
    from sspslam_tpu.nef.processes import TimeTable, clamp_table

    def tabulate(f):
        # pre-sample the input closure into an array-backed node: the
        # Simulator slices TimeTables instead of running a 5-10 us/call
        # Python loop per step per node inside the timed region
        rows = np.stack([np.asarray(f((i + 1) * dt), np.float32).reshape(-1)
                         for i in range(n_steps)])
        return TimeTable(rows, dt)

    with Network(seed=seed) as net:
        vel = Node(tabulate(velocity_func), label="velocity")
        init = Node(clamp_table(ssp0, 0.05, dt))
        lm_id = Node(tabulate(sp_f))
        lm_ssp = Node(tabulate(vecssp_f))
        in_view = Node(tabulate(in_view_f))
        slam = SLAMNetwork(space, lm_space, 0.8, args.n_landmarks,
                           pi_n_neurons=args.pi_n_neurons,
                           mem_n_neurons=args.mem_n_neurons,
                           circonv_n_neurons=args.circonv_n_neurons,
                           vel_scaling_factor=scale,
                           cleanup_samples_per_dim=args.cleanup_samples,
                           seed=seed)
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        p = Probe(slam.pathintegrator.output, synapse=0.05)

    t0 = time.time()
    mm = matmul_dtype
    if mm is None and args.bf16:
        mm = "bf16"
    sim = Simulator(net, seed=seed, scan_unroll=args.scan_unroll,
                    matmul_dtype=mm, mesh=mesh)
    log(f"build: {time.time() - t0:.1f}s")
    n_neurons = sum((be.k * be.n if be.batched else be.n)
                    for be in sim.model.ensembles)
    log(f"model: d={d}, total neurons={n_neurons}")
    return sim, p, space, path


def bench_pi(args):
    """PI-only benchmark (reference run_pathint.py scale) on the generic
    engine."""
    from sspslam_tpu import HexagonalSSPSpace
    from sspslam_tpu.models import PathIntegration
    from sspslam_tpu.nef import Connection, Network, Node, Probe, Simulator
    from sspslam_tpu.nef.processes import TimeTable

    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    space = HexagonalSSPSpace(2, ssp_dim=args.ssp_dim, seed=args.seed,
                              length_scale=0.3, domain_bounds=bounds)
    seg = args.segment_steps
    T = args.timed_steps
    rng = np.random.default_rng(args.seed)
    vels = (0.02 * rng.normal(size=(T + seg, 2))).astype(np.float32)
    with Network(seed=args.seed) as net:
        vel = Node(TimeTable(vels))
        pi = PathIntegration(space, args.pi_n_neurons, 0.05)
        Connection(vel, pi.velocity_input, synapse=None)
        Probe(pi.output, synapse=0.05)
    sim = Simulator(net, seed=args.seed)
    t0 = time.time()
    sim.run_steps(seg, segment_steps=seg)
    sim.sync()
    log(f"compile+warmup: {time.time() - t0:.1f}s")
    n_timed = max(seg, T // seg * seg)
    t0 = time.time()
    sim.run_steps(n_timed, segment_steps=seg)
    sim.sync()
    sps = n_timed / (time.time() - t0)
    log(f"PathIntegration generic engine: {sps:.0f} steps/s "
        f"({1e6 / sps:.2f} us/step)")
    # a traced window, separate from the timed one
    trace = (trace_segment(sim, seg, args.trace_dir) if args.trace_dir
             else None)
    print(json.dumps({
        "metric": "PathIntegration generic engine sim-steps/s at dt=1ms "
                  f"(ssp_dim={space.ssp_dim}, {args.pi_n_neurons} LIF/VCO)",
        "value": round(sps, 1), "unit": "steps/s", "vs_baseline": None,
        "us_per_step": round(1e6 / sps, 3), "trace": trace,
        **device_fields()}))


def device_fields():
    """What every result line says about the device it ran on."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def bench_batched(args, sim):
    """Aggregate throughput of B data-parallel episodes of the full SLAM
    model (scan-of-vmapped-step lowering, parallel/trials.py)."""
    import jax
    import jax.numpy as jnp
    from sspslam_tpu.utils.profiling import mfu
    B = args.batch
    step = sim._step_fn
    params = jax.device_put(sim.params)
    vstep = jax.vmap(step, in_axes=(0, 0, None))
    seg = args.segment_steps
    unroll = max(1, min(args.scan_unroll, seg))

    def scan_fn(state, xs):
        def body(c, x):
            c2, _emits = vstep(c, x, params)
            # drop probe emissions at TRACE level: no (seg, B, d) output
            # buffers exist in the compiled program at all — at B>=32 the
            # ~124 MB/call probe allocations were churning the device
            # allocator and decaying throughput across reps
            return c2, None
        return jax.lax.scan(body, state, xs, unroll=unroll)

    fn = jax.jit(scan_fn)
    inputs = sim._tabulate_inputs(seg)
    xs = [jnp.asarray(np.broadcast_to(
        np.asarray(c, np.float32)[:, None], (seg, B) + c.shape[1:]).copy())
        for c in inputs]
    state0 = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(),
        sim.model.initial_state())
    t0 = time.time()
    state, _ = fn(state0, xs)
    jax.block_until_ready(state); np.asarray(state["step"])
    log(f"batched compile+first: {time.time() - t0:.1f}s")
    n_chain = max(1, args.timed_steps // seg)
    mode = "off" if args.no_chain else getattr(args, "chain_mode", "auto")
    chained = n_chain > 1 and mode != "off"
    if chained:
        # one dispatch per rep: outer scan repeats the segment body over
        # the same device-resident xs block (reps replay identical inputs
        # anyway; state carries)
        def chain_fn(state, xs):
            def outer(c, _):
                c2, _e = scan_fn(c, xs)
                return c2, None
            s2, _ = jax.lax.scan(outer, state, None, length=n_chain)
            return s2
        fn_chain = jax.jit(chain_fn)
        t0 = time.time()
        s = fn_chain(state0, xs)
        jax.block_until_ready(s); np.asarray(s["step"])
        log(f"chained batched compile+first: {time.time() - t0:.1f}s")
    if chained and mode == "auto":
        # same auto-probe as the single-episode path
        def probe(use_chain):
            t0 = time.time()
            if use_chain:
                s = fn_chain(state0, xs)
            else:
                s = state0
                for _ in range(n_chain):
                    s, _e = fn(s, xs)
            jax.block_until_ready(s); np.asarray(s["step"])
            return B * n_chain * seg / (time.time() - t0)
        r_chain, r_plain = probe(True), probe(False)
        chained = r_chain > r_plain
        log(f"chain-mode auto (batched): chained {r_chain:.0f} vs "
            f"per-segment {r_plain:.0f} agg steps/s -> "
            f"{'chained' if chained else 'per-segment'}")
    rates = []
    for rep in range(args.reps):
        t0 = time.time()
        if chained:
            s = fn_chain(state0, xs)
        else:
            s = state0
            for _ in range(n_chain):
                s, _e = fn(s, xs)
        jax.block_until_ready(s); np.asarray(s["step"])
        el = time.time() - t0
        rates.append(B * n_chain * seg / el)
        log(f"batched rep {rep}: {rates[-1]:.0f} agg steps/s")
    agg = float(np.median(rates))
    flops = model_flops_per_step(sim.model)
    util = mfu(flops * agg, jax.devices()[0].device_kind,
               "bf16" if args.bf16 else None)
    row = {
        "B": B, "agg_steps_per_s": round(agg, 1),
        # wall time of ONE vmapped scan iteration (advances B episodes 1 dt)
        "us_per_iteration": round(1e6 * B / agg, 3),
        # amortised wall time per episode-step
        "us_per_episode_step": round(1e6 / agg, 4),
        "mfu": None if util is None else round(util, 6),
        "rep_range": [round(min(rates), 1), round(max(rates), 1)],
    }
    print(json.dumps({
        "metric": f"SLAMNetwork {B}-episode data-parallel aggregate "
                  f"sim-steps/s/chip at dt=1ms (ssp_dim={args.ssp_dim})",
        "value": round(agg, 1), "unit": "steps/s", "vs_baseline": None,
        "rep_range": row["rep_range"],
        "mfu": row["mfu"],
        "n_reps": args.reps, **device_fields()}))
    return row


def make_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["slam", "pi"], default="slam")
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--n-landmarks", type=int, default=10)
    ap.add_argument("--cleanup-samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup-steps", type=int, default=200)
    ap.add_argument("--world-T", type=float, default=14.0,
                    help="trajectory length in seconds (fixed, independent "
                         "of the timing knobs)")
    # long segments amortise per-call dispatch over device-resident input
    # tables; the length is not yet tuned on the GPU (ROADMAP)
    ap.add_argument("--segment-steps", type=int, default=10000)
    ap.add_argument("--timed-steps", type=int, default=50000)
    ap.add_argument("--baseline-steps", type=int, default=100)
    ap.add_argument("--baseline-reps", type=int, default=3)
    # scan-body unroll; not yet tuned on the GPU (ROADMAP)
    ap.add_argument("--scan-unroll", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 matmul inputs (params), f32 accumulation")
    ap.add_argument("--batch", type=int, default=0,
                    help="bench B data-parallel SLAM episodes (aggregate)")
    ap.add_argument("--batch-sweep", default=None,
                    help="comma list of B values: DP saturation-knee sweep "
                         "with MFU per point (e.g. 8,16,32,64)")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--chain-mode", choices=("auto", "on", "off"),
                    default="auto",
                    help="'on': one chained scan-of-scans dispatch per timed "
                         "block; 'off': dispatch per segment (async calls "
                         "pipeline); 'auto' (default): time one warm block "
                         "each way and keep the faster")
    ap.add_argument("--no-chain", action="store_true",
                    help="alias for --chain-mode off")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (smoke tests); without it "
                         "the run needs a GPU")
    ap.add_argument("--device-time", action="store_true",
                    help="also report XLA per-op device self-time per step "
                         "from a profiler trace (needs the xprof package)")
    ap.add_argument("--trace-dir", default=None,
                    help="after the timed reps, write a jax.profiler "
                         "trace of one segment to this directory and report "
                         "kernels per step and the idle share (one-episode "
                         "runs)")
    ap.add_argument("--scaled", action="store_true",
                    help="run the scaled-regime flagship instead (BASELINE "
                         "config 5: 3-D, ssp_dim=201, 10k-neuron memory, "
                         "vmapped multi-seed episodes) via "
                         "experiments/scaled_slam.py and forward its JSON")
    ap.add_argument("--scaled-T", type=float, default=120.0)
    ap.add_argument("--scaled-seeds", default="0,1,2,3")
    ap.add_argument("--no-scaled-spot", action="store_true",
                    help="skip the scaled-regime int8 spot row embedded in "
                         "the default JSON")
    ap.add_argument("--scaled-spot-T", type=float, default=40.0)
    return ap


def main():
    ap = make_parser()
    args = ap.parse_args()
    if args.trace_dir and (args.batch > 1 or args.batch_sweep):
        ap.error("--trace-dir traces one-episode runs only")

    # --scaled and the scaled spot row run experiments/scaled_slam.py as
    # CHILD processes.  This process must not touch JAX until they have
    # ended: a JAX process reserves most of the GPU's memory when it first
    # uses it, so a child started after that would fail for want of it.
    if args.scaled:
        import subprocess
        cmd = [sys.executable,
               os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "experiments", "scaled_slam.py"),
               "--T", str(args.scaled_T), "--seeds", args.scaled_seeds]
        if args.bf16:
            cmd.append("--bf16")
        if args.cpu:
            cmd.append("--cpu")
        out = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(out.stderr)
        lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
        if not lines or out.returncode != 0:
            sys.stderr.write(out.stdout)
            raise SystemExit(out.returncode or 1)
        print(lines[-1])
        return

    # scaled-regime spot row (BASELINE config 5 at int8 parameter storage):
    # gated on decoded tracking error <= the view radius — the
    # distance-error gate the flagship's cosine gate can't provide.
    scaled_spot = None
    if not args.no_scaled_spot and not args.cpu and not args.batch_sweep \
            and args.batch <= 1 and args.model == "slam":
        import subprocess
        cmd = [sys.executable,
               os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "experiments", "scaled_slam.py"),
               "--T", str(args.scaled_spot_T), "--seeds", "0,1",
               "--param-dtype", "int8", "--no-pi-control"]
        log("scaled int8 spot run (subprocess)...")
        # soft-fail THROUGHOUT (including the timeout): the flagship row
        # must still print whatever happens to the spot run
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=1800)
            lines = [l for l in out.stdout.splitlines()
                     if l.startswith('{"')]
            r = json.loads(lines[-1])
            gate = 0.4   # the view radius: tracking must stay inside it
            scaled_spot = {
                "agg_steps_per_s": r["agg_steps_per_s"],
                "mfu": r["mfu"],
                "median_err_slam": r["median_err_slam"],
                "param_dtype": "int8",
                "ssp_dim": r["config"]["ssp_dim"],
                "T": r["T"],
                "accuracy_gate": gate,
                "accuracy_pass": bool(r["median_err_slam"] <= gate),
            }
            log(f"scaled spot: {r['agg_steps_per_s']:.0f} agg steps/s, "
                f"median err {r['median_err_slam']:.3f} (gate {gate})")
        except Exception as e:
            scaled_spot = {"error": f"{type(e).__name__}: {e}"}
            stderr_tail = getattr(locals().get("out"), "stderr", None)
            if stderr_tail:
                scaled_spot["stderr_tail"] = stderr_tail[-500:]
            log(f"scaled spot failed: {scaled_spot['error']}")

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU found (devices: {jax.devices()}); "
                         "pass --cpu for a CPU smoke run")
    log(f"devices: {jax.devices()}")

    if args.model == "pi":
        bench_pi(args)
        return

    sim, probe, space, path = build(args)

    if args.batch_sweep:
        rows = []
        for B in [int(x) for x in args.batch_sweep.split(",")]:
            args.batch = B
            rows.append(bench_batched(args, sim))
        print(json.dumps({
            "metric": "SLAMNetwork DP batch-scaling sweep "
                      f"(ssp_dim={args.ssp_dim}, dt=1ms)",
            "value": rows[-1]["agg_steps_per_s"], "unit": "steps/s",
            "vs_baseline": None, "batch_sweep": rows, **device_fields()}))
        return
    if args.batch > 1:
        bench_batched(args, sim)
        return

    # one fixed scan segment length, compiled once and reused; the input
    # table device-puts ONCE sized for warmup + one timed block — between
    # reps the input pointer rewinds (same rows replayed; state carries
    # on), keeping the device table ~70 MB instead of reps x block
    seg = args.segment_steps
    n_timed = max(seg, args.timed_steps // seg * seg)
    t0 = time.time()
    sim.preload_inputs(seg + n_timed)
    if sim._preloaded_dev is not None:
        jax.block_until_ready(sim._preloaded_dev)
        mb = sim._preloaded_dev.size * 4 / 1e6
        log(f"input table upload: {mb:.0f} MB in {time.time() - t0:.1f}s")
    t0 = time.time()
    sim.run_steps(seg, segment_steps=seg)
    sim.sync()
    log(f"compile+warmup ({seg} steps): {time.time() - t0:.1f}s")
    # chaining only engages over the device-resident table; without one
    # the "warmup" would just be an untimed full run
    mode = "off" if args.no_chain else args.chain_mode
    if sim._preloaded_dev is None:
        mode = "off"

    def timed_block(chain):
        """One warm timed block; rewinds the input pointer after."""
        t0 = time.time()
        sim.run_steps(n_timed, segment_steps=seg, chain=chain)
        sim.sync()
        el = time.time() - t0
        sim._preload_start = sim.n_steps - seg
        return n_timed / el

    if mode in ("on", "auto"):
        # warm the chained executable (one scan-of-scans dispatch per
        # timed block).  Runs the same input window rep 0 would (rows
        # seg..seg+n_timed), keeping the probe's early rows a contiguous
        # world replay for the tracking sanity metric.
        t0 = time.time()
        sim.run_steps(n_timed, segment_steps=seg, chain=True)
        sim.sync()
        log(f"chained warmup ({n_timed} steps): {time.time() - t0:.1f}s")
        sim._preload_start = sim.n_steps - seg
    if mode == "auto":
        # chaining removes per-segment call overhead but the outer scan
        # may compile differently; time one warm block each way and keep
        # the faster
        r_chain = timed_block(True)
        r_plain = timed_block(False)
        chain = r_chain > r_plain
        log(f"chain-mode auto: chained {r_chain:.0f} vs per-segment "
            f"{r_plain:.0f} steps/s -> {'chained' if chain else 'per-segment'}")
    else:
        chain = mode == "on"

    rates = []
    for rep in range(args.reps):
        t0 = time.time()
        sim.run_steps(n_timed, segment_steps=seg, chain=chain)
        sim.sync()
        elapsed = time.time() - t0
        rates.append(n_timed / elapsed)
        log(f"timed rep {rep}: {n_timed} steps in {elapsed:.2f}s "
            f"-> {rates[-1]:.0f} steps/s")
        # rewind the input pointer so the next rep replays the same timed
        # block (simulation state continues; throughput is unaffected)
        sim._preload_start = sim.n_steps - seg
    steps_per_s = float(np.median(rates))
    log(f"median {steps_per_s:.0f} steps/s over {args.reps} reps "
        f"(range {min(rates):.0f}-{max(rates):.0f})")

    # sanity: tracking quality over what was simulated
    tracking_cos = tracking_cosine(sim.data[probe], space, path)
    log(f"tracking cosine sim (last quarter): {tracking_cos:.3f}")

    trace = None
    if args.trace_dir:
        trace = trace_segment(sim, seg, args.trace_dir)
        sim._preload_start = sim.n_steps - seg

    device_us = None
    if args.device_time:
        device_us = measure_device_us_per_step(sim, steps=seg, seg=seg)
        log(f"device self-time: {device_us:.2f} us/step")
        sim._preload_start = sim.n_steps - seg

    vs_baseline = float("nan")
    ref_sps = None
    if not args.skip_baseline:
        # Host-only NumPy interpreter baseline.  The model's jnp node
        # functions (clean-up argmax, gate) are evaluated through their
        # np_function mirrors, so NO step work dispatches to the
        # accelerator — measured >=100 steps x 3 reps, median.
        from sspslam_tpu.nef.reference_backend import NumpyStepper
        ref = NumpyStepper(sim.model)
        n_base = args.baseline_steps
        tables = [np.asarray(c)[:n_base]
                  for c in sim._tabulate_inputs(n_base)]
        ref.run_steps(5, tables)  # warm caches
        base_rates = []
        for _ in range(args.baseline_reps):
            t0 = time.time()
            ref.run_steps(n_base, tables)
            base_rates.append(n_base / (time.time() - t0))
        ref_sps = float(np.median(base_rates))
        log(f"numpy reference interpreter: {ref_sps:.1f} steps/s "
            f"(median of {args.baseline_reps}x{n_base} steps; "
            f"range {min(base_rates):.1f}-{max(base_rates):.1f})")
        vs_baseline = steps_per_s / ref_sps
        if device_us is not None:
            log(f"device-time ratio: {1e6 / device_us / ref_sps:.1f}x "
                "(XLA self-time vs interpreter)")

    from sspslam_tpu.utils.profiling import mfu
    n_neurons = sum((be.k * be.n if be.batched else be.n)
                    for be in sim.model.ensembles)
    flops_step = model_flops_per_step(sim.model)
    util = mfu(flops_step * steps_per_s, jax.devices()[0].device_kind,
               "bf16" if args.bf16 else None)
    print(json.dumps({
        "metric": f"SLAMNetwork sim-steps/s/chip at dt=1ms (ssp_dim={args.ssp_dim}, "
                  f"{n_neurons} LIF neurons; median of {args.reps} reps; "
                  "vs_baseline = speedup over NumPy per-step interpreter on "
                  "same model/host — nengo is not installable here, see "
                  "BASELINE.md)",
        "value": round(steps_per_s, 1),
        "unit": "steps/s",
        **device_fields(),
        "vs_baseline": (round(vs_baseline, 1)
                        if np.isfinite(vs_baseline) else None),
        # provenance for the host-dependent ratio: its measured denominator
        # and (with --device-time) the XLA device self-time
        "baseline_steps_per_s": (None if ref_sps is None
                                 else round(ref_sps, 1)),
        "device_us_per_step": (None if device_us is None
                               else round(device_us, 3)),
        "device_time_ratio": (
            None if (device_us is None or ref_sps is None)
            else round(1e6 / device_us / ref_sps, 1)),
        "rep_range": [round(min(rates), 1), round(max(rates), 1)],
        "n_reps": args.reps,
        "flops_per_step": flops_step,
        # --trace-dir: kernels per step, busy time and idle share
        "trace": trace,
        # null for a device without published peaks
        "mfu": None if util is None else round(util, 6),
        # sanity metric: cosine(path-integrator output, encode(true pos))
        # over the last quarter of the 14 s world (PI+SLAM correction at
        # reference-default hyperparameters; the loop-closure quality
        # protocol with tuned config lives in validate_loop_closure.py)
        "tracking_cosine": round(tracking_cos, 4),
        # accuracy gate: a perf change may not silently trade tracking
        # quality for steps/s
        "accuracy_gate": ACCURACY_GATE,
        "accuracy_pass": bool(tracking_cos >= ACCURACY_GATE),
        # scaled-regime int8 spot row (None when skipped): BASELINE
        # config 5 with 1-byte parameter storage, gated on decoded
        # tracking error <= the view radius
        "scaled": scaled_spot,
    }))


if __name__ == "__main__":
    main()
