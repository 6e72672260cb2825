"""Scaled-regime SLAM: BASELINE config 5 — 3-D domain, ssp_dim>=201,
10k-neuron memory ensembles, vmapped multi-seed episodes on one chip.

At the reference's flagship scale (2-D, d=97, ~82k LIF) the compiled step
is op-latency-bound and MFU is fractions of a percent; here the memory/OVC
populations are 10x wider, the circular-convolution banks 2x, and B
independent worlds (different paths AND landmark layouts, same built model)
advance inside ONE vmapped ``lax.scan`` — the matmuls are (B x) 10k-wide.

Protocol scaling follows the reference CLI's defaults relative to its own
scale (/root/reference/experiments/run_slam.py:23-34): random band-limited
path per seed, Rd-sampled landmarks, view-radius landmark observations,
tuned loop-closure hyperparameters (tune_loop_closure.py round 3).

Per-seed worlds share one built model: landmark SPs and all network
parameters are common; each episode's path, landmark placement and learned
map (PES/Voja state in the vmapped carry) are independent — the one-program
rendering of the reference's one-process-per-seed trial harness.

Usage (defaults = the committed VALIDATION.md run):
  python experiments/scaled_slam.py --T 120 --seeds 0,1,2,3
  python experiments/scaled_slam.py --dp-sweep 1,2,4,8 --T 20   # knee only
Prints one JSON line; add --save for the npz.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sspslam_tpu
from sspslam_tpu import HexagonalSSPSpace
from sspslam_tpu.models import (PathIntegration, SLAMNetwork,
                                get_slam_input_functions2)
from sspslam_tpu.nef import Connection, Network, Node, Probe, Simulator
from sspslam_tpu.nef.processes import TimeTable, clamp_table
from sspslam_tpu.utils.sampling import Rd_sampling

from experiments.common import DT, decode_output


def make_world(args, space, lm_space, seed, shared_scale, space_seed=0):
    """One seed's world: 3-D band-limited path + Rd landmarks, rendered to
    the five input tables (vel, init-clamp, lm-sp, lm-vecssp, in-view).

    The landmark-SSP table rendering is encode-heavy (~1 min/seed at
    d~400, T=120 s) and identical across the dtype x B campaign sweeps of
    one config — cache the scale-independent tables on disk keyed by the
    world parameters (velocity scaling is applied at load: the shared
    scale depends on the whole SEED SET, not this world)."""
    from sspslam_tpu.nef import WhiteSignal
    dt = DT
    n_steps = int(args.T / dt)
    dim = args.domain_dim
    cache = None
    if args.table_cache:
        os.makedirs(args.table_cache, exist_ok=True)
        # the encoded tables depend on the SSP/SP space (seeded from the
        # seed SET's first element), not just this world — a key without
        # it would silently serve tables from a different space when the
        # seed list changes (e.g. --seeds 0,1 then --seeds 1,2)
        cache = os.path.join(
            args.table_cache,
            f"w{seed}_T{args.T:g}_dim{dim}_d{space.ssp_dim}"
            f"_ls{args.length_scale:g}_lim{args.limit:g}"
            f"_L{args.n_landmarks}_vr{args.view_rad:g}"
            f"_sp{space_seed}.npz")
    if cache and os.path.exists(cache):
        with np.load(cache) as f:
            path, vels = f["path"], f["vels"]
            tables = {k: f[k] for k in
                      ("init", "lm_sp", "lm_vecssp", "in_view")}
        tables["vel"] = (vels * shared_scale).astype(np.float32)
        return path, vels, tables
    path = np.hstack([
        WhiteSignal(args.T, high=args.limit, seed=seed + 77 * i).run(
            args.T, dt=dt)
        for i in range(dim)])[:n_steps]
    for i in range(dim):
        lo, hi = path[:, i].min(), path[:, i].max()
        path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12) * 1.8 - 0.9)
    vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
    obj_locs = 0.9 * 2 * (Rd_sampling(args.n_landmarks, dim, seed=seed) - 0.5)
    vec_to_lm = obj_locs[None, :, :] - path[:, None, :]

    (_, _, in_view_f, _, sp_f, _, vecssp_f) = get_slam_input_functions2(
        space, lm_space, vels, vec_to_lm, args.view_rad)
    # the velocity scale is baked into the MODEL's VCO transforms, so all
    # episodes must share one; rows are built here from the shared factor
    tables = {
        "vel": (vels * shared_scale).astype(np.float32),
        "init": clamp_table(space.encode(path[:1]).flatten(), 0.05,
                            dt).rows(0, n_steps),
        "lm_sp": sp_f.rows(0, n_steps),
        "lm_vecssp": vecssp_f.rows(0, n_steps),
        "in_view": in_view_f.rows(0, n_steps),
    }
    if cache:
        np.savez(cache, path=path, vels=vels,
                 **{k: tables[k] for k in
                    ("init", "lm_sp", "lm_vecssp", "in_view")})
    return path, vels, tables


def main():
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--T", type=float, default=120.0)
    ap.add_argument("--seeds", default="0,1,2,3",
                    help="one vmapped episode (world) per seed")
    ap.add_argument("--domain-dim", type=int, default=3)
    ap.add_argument("--ssp-dim", type=int, default=201)
    ap.add_argument("--length-scale", type=float, default=0.3)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=10000)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--n-landmarks", type=int, default=100)
    ap.add_argument("--view-rad", type=float, default=0.4)
    ap.add_argument("--limit", type=float, default=0.1)
    # tuned loop-closure config (experiments/tune_loop_closure.py, round 3)
    ap.add_argument("--update-thres", type=float, default=0.4)
    ap.add_argument("--shift-rate", type=float, default=0.1)
    ap.add_argument("--pes-lr", type=float, default=2e-2)
    ap.add_argument("--voja-lr", type=float, default=1e-4)
    ap.add_argument("--intercept", type=float, default=0.3)
    ap.add_argument("--cleanup-samples", type=int, default=20,
                    help="clean-up bank samples per domain axis (20^3 rows "
                         "in 3-D; the reference's 100/dim grid would be a "
                         "10^6-row bank, SURVEY.md 'hard parts')")
    ap.add_argument("--decode-grid", type=int, default=30)
    ap.add_argument("--gate-mode", default="reference",
                    choices=["reference", "auto_recovery"],
                    help="auto_recovery compiles the in-model tracking-"
                         "loss controller into the step — the d=393 f32 "
                         "runs show LATE losses (final err 0.8-1.4 on "
                         "2/4 seeds) the reference gate cannot rescue")
    ap.add_argument("--anchor-k", type=int, default=0,
                    help="survey this many landmarks (known allocentric "
                         "pose) and enable the gate's absolute channels "
                         "(requires --gate-mode auto_recovery): the late "
                         "co-drift losses are invisible to every internal "
                         "statistic — map and pose agree with each other "
                         "but not the world — so only a world-referenced "
                         "channel can rescue them.  Chosen as the top-K "
                         "most-often-nearest-in-view over the first half "
                         "of all episodes (landmark LAYOUTS are shared "
                         "across episodes; Rd sampling is "
                         "seed-independent)")
    ap.add_argument("--decode-method", default="from-set",
                    choices=["from-set", "direct-optim"],
                    help="offline readout: direct-optim adds the batched "
                         "Newton polish, removing the ~0.06 grid-"
                         "quantisation floor of the 30/axis 3-D grid")
    ap.add_argument("--segment-steps", type=int, default=5000)
    ap.add_argument("--probe-every", type=float, default=0.05)
    # unroll=2 is the measured sweet spot at this scale (VALIDATION
    # "DP knee": 1->7.5k, 2->11.0k, 4->8.9k, 8->5.4k single-episode;
    # B=8 knee 26.1k at unroll=2) — unlike the flagship d=97 config,
    # where the sweep is flat, the 42-MFLOP step bloats under unrolling.
    ap.add_argument("--scan-unroll", type=int, default=2)
    ap.add_argument("--bf16", action="store_true",
                    help="alias for --param-dtype bf16")
    ap.add_argument("--param-dtype", default=None,
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="static matmul-parameter storage: bf16 halves the "
                         "HBM parameter traffic, int8/fp8 quarter it "
                         "(per-slice scales, f32 accumulation — the "
                         "Loihi-8-bit-synapse analog, ops/quantize.py)")
    ap.add_argument("--no-pi-control", action="store_true",
                    help="skip the PI-only control model (halves the VCO "
                         "count; the SLAM-vs-drift separation is then not "
                         "measured)")
    ap.add_argument("--dp-sweep", default=None,
                    help="comma list of B: throughput-only episode-batch "
                         "sweep at this scale (world 0 replicated)")
    ap.add_argument("--roofline", action="store_true",
                    help="no simulation: lower ONE fully-unrolled segment "
                         "(seg=unroll=4) of the B-episode step, read XLA's "
                         "cost analysis (FLOPs, HBM bytes accessed per "
                         "step), print the roofline bounds and exit — "
                         "the scaled counterpart of step_roofline.py "
                         "(which is pinned to the flagship bench config)")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="peak FLOP/s for --roofline (default: the "
                         "device's published peak at the step precision, "
                         "utils/profiling.DEVICE_PEAKS)")
    ap.add_argument("--peak-bw", type=float, default=None,
                    help="HBM bytes/s for --roofline (default: the "
                         "device's published bandwidth)")
    ap.add_argument("--measured-us", type=float, default=None,
                    help="with --roofline: measured us per EPISODE-step "
                         "at this config/B (from a prior run or --dp-sweep "
                         "row) to print the fraction-of-roofline")
    ap.add_argument("--probe-gate", action="store_true",
                    help="with --gate-mode auto_recovery: probe the "
                         "in-model controller's output (correction + "
                         "suppress channel) and report per-seed recovery "
                         "enters/duty in the JSON (saved as gate_out "
                         "with --save)")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--save-dir", default="data")
    ap.add_argument("--table-cache", default="data/table_cache",
                    help="directory for the scale-independent input-table "
                         "cache ('' disables); ~0.6 GB/seed at d~400, "
                         "saves ~1 min/seed/invocation of encode time "
                         "across campaign sweeps")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (smoke tests); without "
                         "it the run needs a GPU")
    args = ap.parse_args()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU found (devices: {jax.devices()}); "
                         "pass --cpu for a CPU smoke run")
    import jax.numpy as jnp
    from sspslam_tpu.utils.profiling import device_peaks, mfu, step_peak_flops
    kind = jax.devices()[0].device_kind

    def mfu_of(flops_per_s):
        u = mfu(flops_per_s, kind, pd)
        return None if u is None else round(u, 6)

    dt = DT
    n_steps = int(args.T / dt)
    seeds = [int(s) for s in args.seeds.split(",")]
    B = len(seeds)
    dim = args.domain_dim

    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (dim, 1))
    space = HexagonalSSPSpace(dim, ssp_dim=args.ssp_dim, seed=seeds[0],
                              length_scale=args.length_scale,
                              domain_bounds=bounds)
    d = space.ssp_dim
    lm_space = sspslam_tpu.SPSpace(args.n_landmarks, d, seed=seeds[0])
    print(f"space: {dim}-D, ssp_dim={d} "
          f"({(d + 1) // 2} VCOs)", flush=True)

    # shared velocity scale across worlds (baked into the VCO transforms)
    t0 = time.time()
    from sspslam_tpu.nef import WhiteSignal
    worlds_raw = []
    max_freq = 0.0
    for s in seeds:
        path = np.hstack([
            WhiteSignal(args.T, high=args.limit, seed=s + 77 * i).run(
                args.T, dt=dt) for i in range(dim)])[:n_steps]
        for i in range(dim):
            lo, hi = path[:, i].min(), path[:, i].max()
            path[:, i] = ((path[:, i] - lo) / max(hi - lo, 1e-12)
                          * 1.8 - 0.9)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        max_freq = max(max_freq, float(np.max(
            np.abs(space.phase_matrix @ vels.T))))
        worlds_raw.append(path)
    if max_freq == 0.0:
        raise SystemExit(
            f"degenerate trajectories: WhiteSignal(T={args.T}, "
            f"high={args.limit}) has no spectral content below its "
            f"frequency resolution 1/T={1 / args.T:.3g} Hz — raise --T "
            f"or --limit so that T*limit >= 1")
    shared_scale = 1.0 / max_freq

    paths, tables_by_seed = [], []
    for s in seeds:
        path, vels, tables = make_world(args, space, lm_space, s,
                                        shared_scale, space_seed=seeds[0])
        paths.append(path)
        tables_by_seed.append(tables)
    print(f"worlds: {B} built in {time.time() - t0:.1f}s", flush=True)

    use_anchor = args.anchor_k > 0
    if use_anchor:
        if args.gate_mode != "auto_recovery":
            raise SystemExit("--anchor-k requires --gate-mode "
                             "auto_recovery")
        # landmark layouts are SHARED across episodes (Rd_sampling's seed
        # is a sequence offset; integer seeds are a no-op), so one
        # surveyed set serves every vmapped world.  Survey = top-K
        # most-often-nearest-in-view over the first half of each episode
        # (leak-free: the late losses live in the last third).  Each
        # episode renders its own beacon tables (paths differ).
        from sspslam_tpu.models import get_anchor_input_functions
        obj_locs = 0.9 * 2 * (
            Rd_sampling(args.n_landmarks, dim, seed=seeds[0]) - 0.5)
        counts = np.zeros(args.n_landmarks, np.int64)
        for path in paths:
            half = path[:n_steps // 2]
            dists = np.linalg.norm(
                obj_locs[None, :, :] - half[:, None, :], axis=2)
            nearest = dists.argmin(axis=1)
            iv = dists[np.arange(len(half)), nearest] <= args.view_rad
            counts += np.bincount(nearest[iv],
                                  minlength=args.n_landmarks)
        anchor_lms = np.sort(np.argsort(counts)[::-1][:args.anchor_k])
        for s, path, tables in zip(seeds, paths, tables_by_seed):
            # beacon tables are encode-heavy like the world tables and
            # identical across the dtype x B sweeps of one config — cache
            # them keyed by world + space seed + the surveyed set
            acache = None
            if args.table_cache:
                aid = "-".join(str(i) for i in anchor_lms.tolist())
                acache = os.path.join(
                    args.table_cache,
                    f"anc{s}_T{args.T:g}_dim{dim}_d{space.ssp_dim}"
                    f"_ls{args.length_scale:g}_lim{args.limit:g}"
                    f"_L{args.n_landmarks}_vr{args.view_rad:g}"
                    f"_sp{seeds[0]}_k{aid}.npz")
            if acache and os.path.exists(acache):
                with np.load(acache) as f:
                    for k in ("anc_pos", "anc_vec", "anc_iv"):
                        tables[k] = f[k]
                continue
            vec_to_lm = obj_locs[None, :, :] - path[:, None, :]
            pos_f, vec_f, iv_f = get_anchor_input_functions(
                space, vec_to_lm, anchor_lms, obj_locs[anchor_lms],
                args.view_rad)
            tables["anc_pos"] = pos_f.rows(0, n_steps)
            tables["anc_vec"] = vec_f.rows(0, n_steps)
            tables["anc_iv"] = iv_f.rows(0, n_steps)
            if acache:
                np.savez(acache, **{k: tables[k] for k in
                                    ("anc_pos", "anc_vec", "anc_iv")})
        from experiments.common import kernel_value
        anchor_trigger = round(kernel_value(space, args.view_rad), 3)
        duty = [float((t["anc_iv"][:, 0] < 1e-3).mean())
                for t in tables_by_seed]
        print(f"anchors: {anchor_lms.tolist()} "
              f"(trigger K(vr)={anchor_trigger}; beacon-in-view duty "
              f"{[round(x, 3) for x in duty]})", flush=True)

    node_key = {}
    with Network(seed=seeds[0]) as net:
        # input nodes carry world 0; per-episode tables override them below
        t0w = tables_by_seed[0]
        vel = Node(TimeTable(t0w["vel"], dt)); node_key[vel] = "vel"
        init = Node(TimeTable(t0w["init"], dt)); node_key[init] = "init"
        lm_id = Node(TimeTable(t0w["lm_sp"], dt)); node_key[lm_id] = "lm_sp"
        lm_ssp = Node(TimeTable(t0w["lm_vecssp"], dt))
        node_key[lm_ssp] = "lm_vecssp"
        in_view = Node(TimeTable(t0w["in_view"], dt))
        node_key[in_view] = "in_view"
        if use_anchor:
            anc_pos = Node(TimeTable(t0w["anc_pos"], dt))
            node_key[anc_pos] = "anc_pos"
            anc_vec = Node(TimeTable(t0w["anc_vec"], dt))
            node_key[anc_vec] = "anc_vec"
            anc_iv = Node(TimeTable(t0w["anc_iv"], dt))
            node_key[anc_iv] = "anc_iv"

        slam = SLAMNetwork(
            space, lm_space, args.view_rad, args.n_landmarks,
            args.pi_n_neurons, args.mem_n_neurons, args.circonv_n_neurons,
            update_thres=args.update_thres, shift_rate=args.shift_rate,
            voja_learning_rate=args.voja_lr, pes_learning_rate=args.pes_lr,
            intercept=args.intercept, vel_scaling_factor=shared_scale,
            cleanup_samples_per_dim=args.cleanup_samples, seed=seeds[0],
            gate_mode=args.gate_mode, anchor=use_anchor,
            gate_kwargs=({"anchor_trigger": anchor_trigger}
                         if use_anchor else None))
        Connection(vel, slam.velocity_input, synapse=None)
        Connection(init, slam.pathintegrator.input, synapse=None)
        Connection(lm_id, slam.landmark_id_input, synapse=None)
        Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
        Connection(in_view, slam.no_landmark_in_view, synapse=None)
        if use_anchor:
            Connection(anc_pos, slam.anchor_pos_input, synapse=None)
            Connection(anc_vec, slam.anchor_vec_ssp, synapse=None)
            Connection(anc_iv, slam.no_anchor_in_view, synapse=None)
        slam_p = Probe(slam.pathintegrator.output, synapse=0.05)
        gate_p = None
        if args.probe_gate:
            if args.gate_mode != "auto_recovery":
                raise SystemExit("--probe-gate requires --gate-mode "
                                 "auto_recovery")
            # output layout [correction(d), suppress(1)]; suppress > 5
            # marks the controller's recovery window
            gate_p = Probe(slam.update_state, synapse=None)
        pi_p = None
        if not args.no_pi_control:
            pi_only = PathIntegration(space, args.pi_n_neurons, 0.05,
                                      scaling_factor=shared_scale,
                                      stable=True)
            Connection(vel, pi_only.velocity_input, synapse=None)
            Connection(init, pi_only.input, synapse=None)
            pi_p = Probe(pi_only.output, synapse=0.05)

    t0 = time.time()
    pd = args.param_dtype or ("bf16" if args.bf16 else "f32")
    mm = None if pd == "f32" else pd
    sim = Simulator(net, seed=seeds[0], matmul_dtype=mm)
    build_s = time.time() - t0
    n_neurons = sum((be.k * be.n if be.batched else be.n)
                    for be in sim.model.ensembles)
    from sspslam_tpu.utils.profiling import model_utilization_summary
    flops_step = float(sum(r["flops_per_step"]
                           for r in model_utilization_summary(sim.model)))
    print(f"build: {build_s:.1f}s; {n_neurons:,} LIF neurons, "
          f"{flops_step / 1e6:.1f} MFLOP/step/episode", flush=True)

    # ---- vmapped multi-episode segment loop (compiled once) ----
    step = sim._step_fn
    vstep = jax.vmap(step, in_axes=(0, 0, None))
    seg = min(args.segment_steps, n_steps)
    unroll = max(1, min(args.scan_unroll, seg))

    # Device-resident input tables (the flagship bench's zero-upload rule,
    # VALIDATION "Throughput": the wall/device gap was per-segment input
    # transfer).  The full time-major (n_steps, B, size) table per input
    # node is uploaded ONCE; each segment slices it ON DEVICE with a
    # traced start offset, so one executable serves every offset and the
    # timed loop moves no input bytes over the host link.
    def seg_fn(state, tables, start, params):
        xs = [jax.lax.dynamic_slice_in_dim(t, start, seg, axis=0)
              for t in tables]
        def body(c, x):
            return vstep(c, x, params)
        return jax.lax.scan(body, state, xs, unroll=unroll)

    def seg_fn_drop(state, tables, start, params):
        # throughput-only mode: drop probe emissions at TRACE level so no
        # (seg, B, d) output buffers exist in the compiled program at all
        # (the same rule as bench.py's batched path — at scale the emit
        # allocations churn the device allocator)
        xs = [jax.lax.dynamic_slice_in_dim(t, start, seg, axis=0)
              for t in tables]
        def body(c, x):
            c2, _emits = vstep(c, x, params)
            return c2, None
        s2, _ = jax.lax.scan(body, state, xs, unroll=unroll)
        return s2, None

    run_seg = jax.jit(seg_fn)
    run_seg_drop = jax.jit(seg_fn_drop)
    params_dev = jax.device_put(sim.params)

    input_keys = [node_key[n] for n in sim.model.input_nodes]
    per = max(1, int(round(args.probe_every / dt)))

    def run_episodes(tabs, total_steps, collect=True):
        B_eff = len(tabs)
        state = jax.tree_util.tree_map(
            lambda x: np.broadcast_to(
                np.asarray(x), (B_eff,) + np.shape(x)).copy(), sim.state)
        t0 = time.time()
        tables_dev = [
            jnp.asarray(np.stack([t[k][:total_steps] for t in tabs], axis=1))
            for k in input_keys]
        jax.block_until_ready(tables_dev)
        upload_s = time.time() - t0
        kept = ({p: [] for p in (slam_p, pi_p, gate_p) if p is not None}
                if collect else None)
        # --probe-gate also snapshots the controller's INTERNAL state
        # ([armed, agree_ema, timer, cons_ema(, anchor_ema)]) at each
        # segment boundary — the stateful node's carry slot — giving a
        # seg-resolution trace of the arming latch and the evidence EMAs
        gate_states = [] if (collect and gate_p is not None) else None
        # compile/warm on the first segment, then time the rest
        t_compile = t_run = 0.0
        done = 0
        while done < total_steps:
            hi = min(done + seg, total_steps)
            if hi - done < seg:     # tail: pad by clamping (skip timing)
                break
            t0 = time.time()
            state, emits = (run_seg if collect else run_seg_drop)(
                state, tables_dev, jnp.int32(done), params_dev)
            jax.block_until_ready(state["step"])
            el = time.time() - t0
            if done == 0:
                t_compile = el
                print(f"  tables uploaded once ({upload_s:.2f}s); "
                      f"compile+warm {el:.1f}s", flush=True)
            else:
                t_run += el
            if collect:
                for p in kept:
                    idx = _bp_index(sim, p)
                    e = np.asarray(emits[idx])      # (seg, B, d)
                    phase = (per - 1 - done % per) % per
                    kept[p].append(e[phase::per])
                if gate_states is not None:
                    gate_states.append({k: np.asarray(v) for k, v
                                        in state["nodes"].items()})
            done = hi
        steps_timed = done - seg
        if t_run > 0:
            agg = B_eff * steps_timed / t_run
        else:   # single-segment smoke runs: compile+run is all we have
            agg = B_eff * done / max(t_compile, 1e-9)
        probes = None
        if collect:
            probes = {p: np.swapaxes(np.concatenate(v), 0, 1)
                      for p, v in kept.items() if p is not None}
            if gate_states is not None:
                # (n_segments, B, state_dim) per stateful-node slot
                probes["gate_states"] = {
                    k: np.stack([gs[k] for gs in gate_states])
                    for k in gate_states[0]} if gate_states else {}
        return probes, agg, t_compile, done

    def _bp_index(sim, probe):
        if probe is None:
            return None
        return next(bp.index for bp in sim.model.probes if bp.obj is probe)

    if args.roofline:
        # XLA's cost analysis counts a `while` body ONCE regardless of trip
        # count, so lower a short FULLY-unrolled segment (no while loop)
        # and divide by its length.  Lowered from ShapeDtypeStructs with
        # the inputs pre-sliced to (seg, B, size): nothing is uploaded and
        # no step executes, so this is safe alongside other device work.
        seg_r = 4

        def roof_fn(state, xs, params):
            def body(c, x):
                c2, _emits = vstep(c, x, params)
                return c2, None
            s2, _ = jax.lax.scan(body, state, xs, unroll=seg_r)
            return s2

        state_sds = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(
                (B,) + tuple(np.shape(x)), np.asarray(x).dtype), sim.state)
        xs_sds = [jax.ShapeDtypeStruct(
            (seg_r, B, tables_by_seed[0][k].shape[1]), np.float32)
            for k in input_keys]
        params_sds = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(jnp.shape(x), x.dtype),
            sim.params)
        cost = jax.jit(roof_fn).lower(
            state_sds, xs_sds, params_sds).compile().cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        fl = float(cost.get("flops", float("nan"))) / seg_r
        by = float(cost.get("bytes accessed", float("nan"))) / seg_r
        peak_fl = args.peak_flops or step_peak_flops(kind, pd)
        peak_bw = args.peak_bw or (device_peaks(kind) or {}).get(
            "hbm_bytes_per_s")
        out = {
            "metric": f"scaled roofline (ssp_dim={d}, B={B}, dtype={pd})",
            "device_kind": kind,
            "flops_per_step": fl,
            "hbm_bytes_per_step": by,
            "bytes_per_episode_step": round(by / B, 1),
            # bounds are null for a device without published peaks
            "compute_bound_us_per_episode_step": None,
            "bandwidth_bound_us_per_episode_step": None,
            "roofline_us_per_episode_step": None,
        }
        if peak_fl and peak_bw:
            t_c = fl / peak_fl
            t_b = by / peak_bw
            out.update({
                "compute_bound_us_per_episode_step": round(
                    t_c * 1e6 / B, 3),
                "bandwidth_bound_us_per_episode_step": round(
                    t_b * 1e6 / B, 3),
                "roofline_us_per_episode_step": round(
                    max(t_c, t_b) * 1e6 / B, 3),
            })
        if args.measured_us and peak_fl and peak_bw:
            out["measured_us_per_episode_step"] = args.measured_us
            out["fraction_of_roofline"] = round(
                max(t_c, t_b) * 1e6 / B / args.measured_us, 3)
        print(json.dumps(out))
        return

    if args.dp_sweep:
        rows = []
        for Bx in [int(x) for x in args.dp_sweep.split(",")]:
            tabs = [tables_by_seed[0]] * Bx
            _, agg, t_c, done = run_episodes(tabs, n_steps, collect=False)
            r = {"B": Bx, "agg_steps_per_s": round(agg, 1),
                 "mfu": mfu_of(flops_step * agg),
                 "compile_s": round(t_c, 1)}
            rows.append(r)
            print(json.dumps(r), flush=True)
        print(json.dumps({
            "metric": f"scaled {dim}-D SLAM DP sweep (ssp_dim={d}, "
                      f"mem={args.mem_n_neurons}, dtype={pd})",
            "value": rows[-1]["agg_steps_per_s"], "unit": "steps/s",
            "vs_baseline": None, "dp_sweep": rows}))
        return

    t0 = time.time()
    probes, agg, t_compile, done = run_episodes(tables_by_seed, n_steps)
    wall = time.time() - t0
    print(f"sim: {B} episodes x {done} steps, compile+first {t_compile:.1f}s,"
          f" steady {agg:.0f} agg steps/s, total {wall:.1f}s", flush=True)

    # decoded tracking error per seed (skip the first 10 s of map building)
    results = []
    k = probes[slam_p].shape[1]
    for b, s in enumerate(seeds):
        path_s = paths[b][per - 1::per][:k]
        entry = {"seed": s}
        for name, p in (("slam", slam_p), ("pi_only", pi_p)):
            if p is None:
                continue
            est = decode_output(space, probes[p][b], dim,
                                grid=args.decode_grid,
                                method=args.decode_method)
            err = np.sqrt(np.sum((path_s - est) ** 2, axis=1))
            half = err[len(err) // 2:]
            entry[name] = {"median_err": round(float(np.median(half)), 4),
                           "final_err": round(float(err[-1]), 4)}
        if gate_p is not None:
            sup = probes[gate_p][b][:, -1] > 5.0
            rises = int(np.sum(sup[1:] & ~sup[:-1])) + int(sup[0])
            entry["gate"] = {
                "enters": rises,
                "recovery_frac": round(float(sup.mean()), 4),
                "first_enter_s": (round(float(
                    np.argmax(sup) * args.probe_every), 2)
                    if sup.any() else None)}
            # controller-internal state at the LAST segment boundary:
            # [armed, agree_ema, timer, cons_ema(, anchor_ema)]
            for slot, tr in probes["gate_states"].items():
                if tr.shape[-1] in (4, 5):
                    entry["gate"]["final_state"] = [
                        round(float(v), 4) for v in tr[-1, b]]
        results.append(entry)
        print(json.dumps(entry), flush=True)

    med_slam = float(np.median([r["slam"]["median_err"] for r in results]))
    out = {
        "metric": f"scaled {dim}-D SLAM (ssp_dim={d}, "
                  f"mem={args.mem_n_neurons}, {n_neurons} LIF, "
                  f"B={B} vmapped episodes, dtype="
                  f"{pd})",
        "value": round(agg, 1), "unit": "steps/s",
        "agg_steps_per_s": round(agg, 1),
        "us_per_episode_step": round(1e6 / agg, 3),
        "mfu": mfu_of(flops_step * agg),
        "flops_per_step_per_episode": flops_step,
        "median_err_slam": round(med_slam, 4),
        "per_seed": results,
        "T": args.T, "config": {
            "ssp_dim": d, "domain_dim": dim,
            "length_scale": args.length_scale,
            "param_dtype": pd, "decode_method": args.decode_method,
            "mem_n_neurons": args.mem_n_neurons,
            "pi_n_neurons": args.pi_n_neurons,
            "n_landmarks": args.n_landmarks, "view_rad": args.view_rad,
            "update_thres": args.update_thres,
            "shift_rate": args.shift_rate, "pes_lr": args.pes_lr,
            "voja_lr": args.voja_lr, "intercept": args.intercept,
            "gate_mode": args.gate_mode, "anchor_k": args.anchor_k},
    }
    if use_anchor:
        out["anchors"] = {"landmarks": anchor_lms.tolist(),
                          "trigger": anchor_trigger}
    print(json.dumps(out))
    if args.save:
        os.makedirs(args.save_dir, exist_ok=True)
        fn = os.path.join(args.save_dir,
                          f"scaled_slam_d{d}_dim{dim}_"
                          f"mem{args.mem_n_neurons}_B{B}_T{int(args.T)}"
                          f"_{pd}.npz")
        extra = {}
        if gate_p is not None:
            extra["gate_out"] = probes[gate_p]
            for slot, tr in probes["gate_states"].items():
                extra[f"gate_state_{slot}"] = tr
        np.savez(fn, slam_out=probes[slam_p],
                 pi_out=(probes[pi_p] if pi_p else np.array([])),
                 paths=np.stack(paths), meta=np.array([json.dumps(out)]),
                 **extra)
        print(f"saved {fn}")


if __name__ == "__main__":
    main()
