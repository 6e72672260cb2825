"""Smoke test: the flagship SLAM simulation on one GPU, end to end.

Builds the flagship model (bench.py's: the reference run_slam.py defaults,
HexagonalSSPSpace d=97, 49 VCOs x 800 LIF, a 970-neuron memory trio,
~1e5 LIF at dt = 1 ms) and drives it through the user entry points
(``Simulator``, ``preload_inputs``, ``run_steps``, ``save_bundle``,
``ServingModel``).  Phases:

  a. device     a GPU is present; its kind, name and power limit
  b. flagship   the 14 s world: finite probes, tracking cosine >= gate;
                build, compile and synced steps/s
  c. parity     300 steps with an f32 clean-up against the NumPy
                interpreter (cross_check), and the production run (bf16
                clean-up) against that f32 clean-up run over the whole 14 s
  d. banks      int8 and fp8 parameter banks against the f32 run
  e. serving    an AOT bundle exported for "cuda", reloaded, one segment
                against the live Simulator
  f. four GPUs  (only with --four, and then no other phase but a.) tensor-
                parallel flagship, data-parallel episodes and the shard_map
                VCO scan, each against its single-GPU result

Usage: python chip_smoke.py [--four]

Any failed check raises, so the exit code is non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; it is printed only
when every phase passed.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

#: scan segment length of every run here: divides every run length below,
#: so each Simulator compiles exactly one segment program
SEG = 100
#: steps compared step by step against the NumPy interpreter: long enough
#: for the initial clamp, VCO and memory dynamics to settle, short enough
#: that chaotic spike-flip divergence has not set in
PARITY_STEPS = 300
#: length of the reduced-precision bank runs (phase d)
BANK_STEPS = 2000
#: the per-step statistic's atol (relative to max(|ref|, 1)), as the
#: repo's full-SLAM interpreter test uses it
ATOL = 1e-3

#: 14 s comparisons (phases c and f).  Two runs of the model whose
#: arithmetic differs only in summation order or rounding separate
#: chaotically once a spike flips, so over 14 s they are compared on what
#: must still agree: both pass the tracking gate, their tracking cosines
#: differ by at most COS_SPREAD (the same model re-run with another
#: segment length, i.e. other compiled kernels, moved it by up to 0.007 on
#: an H100), and their decoded positions stay within PATH_GAP (domain
#: units, median over the run; the arena is 2.2 wide, the view radius 0.8)
COS_SPREAD = 0.03
PATH_GAP = 0.1
#: phase d: int8/fp8 banks store 1 byte per weight with per-slice scales
#: (ops/quantize.py); over BANK_STEPS their tracking cosine must stay this
#: close to the f32 run's
BANK_COS = 0.02


def log(*a):
    print(*a, flush=True)


def load_bench():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench
    return bench


def phase_device(n_gpus):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs}")
    if len(devs) < n_gpus:
        raise SystemExit(f"need {n_gpus} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[a] jax: {len(devs)} x {devs[0].device_kind}; nvidia-smi name, "
        "power limit:")
    log(smi)
    return smi.splitlines()[0]


def checked_cosine(bench, out, space, path, what):
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"{what}: non-finite probe values")
    cos = bench.tracking_cosine(out, space, path)
    log(f"[{what[0]}] {what}: tracking cosine {cos:.4f}")
    return cos


def decoded_gap(space, a, b, stride=10):
    """Median and max distance between the positions decoded from two
    SSP traces (every ``stride``-th row)."""
    pa = space.decode(a[::stride], num_samples=200)
    pb = space.decode(b[::stride], num_samples=200)
    dist = np.linalg.norm(pa - pb, axis=1)
    return float(np.median(dist)), float(np.max(dist))


def check_same_path(bench, cos_a, cos_b, median_gap, what):
    if min(cos_a, cos_b) < bench.ACCURACY_GATE:
        raise AssertionError(f"{what}: tracking cosine below the gate")
    if abs(cos_a - cos_b) > COS_SPREAD:
        raise AssertionError(f"{what}: tracking cosines differ by more "
                             f"than {COS_SPREAD}")
    if median_gap > PATH_GAP:
        raise AssertionError(f"{what}: decoded paths differ by more than "
                             f"{PATH_GAP}")


def phase_flagship(bench, args, card):
    """b: the 14 s world at full width; also exports the bundle of
    phase e from the fresh carry."""
    from sspslam_tpu.nef import save_bundle

    t0 = time.time()
    sim, probe, space, path = bench.build(args)
    build_s = time.time() - t0
    n = path.shape[0]
    xs0 = sim._pack_cols(sim._tabulate_inputs(SEG))
    bundle = tempfile.mkdtemp(prefix="sspslam_bundle_")
    t0 = time.time()
    save_bundle(sim, bundle, segment_steps=SEG, platforms=["cuda"])
    export_s = time.time() - t0

    sim.preload_inputs(n)
    t0 = time.time()
    sim.compile(n, segment_steps=SEG)
    compile_s = time.time() - t0
    t0 = time.time()
    sim.run_steps(n, segment_steps=SEG)
    done = sim.sync()
    run_s = time.time() - t0
    if done != n:
        raise AssertionError(f"ran {done} steps, expected {n}")
    out = sim.data[probe]
    if out.shape != (n, space.ssp_dim):
        raise AssertionError(f"probe shape {out.shape}")
    cos = checked_cosine(bench, out, space, path, "b flagship 14 s")
    if cos < bench.ACCURACY_GATE:
        raise AssertionError(f"tracking cosine {cos:.4f} < gate "
                             f"{bench.ACCURACY_GATE}")
    n_neurons = sum(be.k * be.n if be.batched else be.n
                    for be in sim.model.ensembles)
    log(f"[b] {n_neurons} neurons, {n} steps; build {build_s:.1f} s, "
        f"compile {compile_s:.1f} s, bundle export {export_s:.1f} s, "
        f"run {run_s:.2f} s = {n / run_s:.0f} synced steps/s "
        f"(segment {SEG}, unroll {args.scan_unroll}) on {card}")
    return out, space, path, bundle, xs0


def phase_parity(bench, args, prod_out, space, path):
    """c: the step (at its one matmul precision, nef/executor
    STEP_PRECISION) with an f32 clean-up against the NumPy interpreter,
    and the production run, whose clean-up compares in bf16, against the
    f32 clean-up run."""
    from sspslam_tpu.nef.reference_backend import cross_check

    # the NumPy mirror of the clean-up compares in float32
    os.environ["SSPSLAM_CLEANUP_F32"] = "1"
    try:
        sim, probe, _, _ = bench.build(args)
    finally:
        del os.environ["SSPSLAM_CLEANUP_F32"]
    t0 = time.time()
    stats = cross_check(sim, PARITY_STEPS, atol=ATOL,
                        spike_flip_tolerant=True, segment_steps=SEG)
    for idx, st in stats.items():
        log(f"[c] f32 clean-up vs NumPy interpreter, probe {idx}, "
            f"{PARITY_STEPS} steps: " + ", ".join(
                f"{k} {v:.3g}" for k, v in st.items()))
    n = path.shape[0]
    sim.run_steps(n - PARITY_STEPS, segment_steps=SEG)
    f32_out = sim.data[probe]
    log(f"[c] parity runs {time.time() - t0:.1f} s")
    cos_f = checked_cosine(bench, f32_out, space, path,
                           "c f32 clean-up 14 s")
    cos_p = bench.tracking_cosine(prod_out, space, path)
    med, peak = decoded_gap(space, prod_out, f32_out)
    log(f"[c] production (bf16 clean-up) vs f32 clean-up over 14 s: "
        f"tracking cosine {cos_p:.4f} vs {cos_f:.4f}; decoded-path gap "
        f"median {med:.4f}, max {peak:.4f} (bounds: cosine {COS_SPREAD}, "
        f"median gap {PATH_GAP})")
    check_same_path(bench, cos_p, cos_f, med, "bf16 vs f32 clean-up")


def phase_banks(bench, args, prod_out, path):
    """d: int8 and fp8 parameter banks against the f32 run."""
    cos_f = None
    for kind in ("int8", "fp8"):
        t0 = time.time()
        sim, probe, space, _ = bench.build(args, matmul_dtype=kind)
        sim.run_steps(BANK_STEPS, segment_steps=SEG)
        out = sim.data[probe]
        if cos_f is None:
            cos_f = bench.tracking_cosine(prod_out[:BANK_STEPS], space,
                                          path[:BANK_STEPS])
        cos = checked_cosine(bench, out, space, path[:BANK_STEPS],
                             f"d {kind} {BANK_STEPS} steps")
        log(f"[d] {kind}: cosine {cos:.4f} vs f32 {cos_f:.4f} "
            f"(bound {BANK_COS}); {time.time() - t0:.1f} s")
        if abs(cos - cos_f) > BANK_COS:
            raise AssertionError(f"{kind} bank: cosine gap")


def phase_serving(prod_out, bundle, xs0):
    """e: the exported bundle's first segment against the live run."""
    from sspslam_tpu.nef import ServingModel
    from sspslam_tpu.nef.reference_backend import compare_traces

    t0 = time.time()
    try:
        (got,) = ServingModel(bundle).run(xs0).values()
    finally:
        shutil.rmtree(bundle)
    want = prod_out[:SEG]
    exact = bool(np.array_equal(got, want))
    st = compare_traces(got, want, ATOL, spike_flip_tolerant=True,
                        label="bundle vs live")
    log(f"[e] bundle vs live Simulator, {SEG} steps: "
        f"{'bit-exact' if exact else 'not bit-exact'}; " + ", ".join(
            f"{k} {v:.3g}" for k, v in st.items())
        + f"; {time.time() - t0:.1f} s")


def phase_four(bench, args, card):
    """f: the multi-GPU paths against their single-GPU results."""
    from sspslam_tpu.nef.reference_backend import compare_traces
    from sspslam_tpu.parallel import make_mesh, run_batched_episodes
    from sspslam_tpu.parallel.shard_step import (make_sharded_vco_scan,
                                                 vco_initial_state,
                                                 vco_params,
                                                 vco_reference_scan)

    sim1, probe, space, path = bench.build(args)
    n = path.shape[0]

    # data-parallel episodes: 4 seeded odometry-noise variants of the
    # world, one vmapped scan on one GPU vs the batch sharded over 4
    tabs = [np.asarray(c, np.float32) for c in sim1._tabulate_inputs(n)]
    vi = [nd.label for nd in sim1.model.input_nodes].index("velocity")
    episodes = []
    for b in range(4):
        ep = [t.copy() for t in tabs]
        rng = np.random.default_rng(b)
        ep[vi] = ep[vi] + (0.05 * b * np.abs(ep[vi]).max()
                           * rng.normal(size=ep[vi].shape)).astype(np.float32)
        episodes.append(ep)
    stacked = [np.stack([ep[i] for ep in episodes]) for i in range(len(tabs))]
    t0 = time.time()
    one, _ = run_batched_episodes(sim1, stacked, n)
    t1 = time.time()
    four, _ = run_batched_episodes(
        sim1, stacked, n, mesh=make_mesh(4, axis_names=("data",)))
    t2 = time.time()
    for b in range(4):
        a1, a4 = one[probe][b], four[probe][b]
        st = compare_traces(a4[:PARITY_STEPS], a1[:PARITY_STEPS], ATOL,
                            spike_flip_tolerant=True, label=f"episode {b}")
        c1 = checked_cosine(bench, a1, space, path, f"f DP episode {b} 1 GPU")
        c4 = checked_cosine(bench, a4, space, path, f"f DP episode {b} 4 GPUs")
        med, _ = decoded_gap(space, a1, a4)
        log(f"[f] DP episode {b}: decoded-path gap median {med:.4f}; "
            + ", ".join(f"{k} {v:.3g}" for k, v in st.items()))
        check_same_path(bench, c1, c4, med, f"DP episode {b}")
    log(f"[f] 4 episodes x {n} steps: 1 GPU {t1 - t0:.1f} s, "
        f"4 GPUs {t2 - t1:.1f} s (compile included) on {card}")

    # tensor parallelism over the VCO and neuron axes (GSPMD)
    sim1.run_steps(n, segment_steps=SEG)
    ref = sim1.data[probe]
    simtp, probetp, _, _ = bench.build(args, mesh=make_mesh(4))
    t0 = time.time()
    simtp.run_steps(n, segment_steps=SEG)
    simtp.sync()
    tp = simtp.data[probetp]
    st = compare_traces(tp[:PARITY_STEPS], ref[:PARITY_STEPS], ATOL,
                        spike_flip_tolerant=True, label="TP flagship")
    c1 = checked_cosine(bench, ref, space, path, "f flagship 1 GPU")
    c4 = checked_cosine(bench, tp, space, path, "f flagship TP 4 GPUs")
    med, _ = decoded_gap(space, ref, tp)
    log(f"[f] TP flagship: decoded-path gap median {med:.4f}; " + ", ".join(
        f"{k} {v:.3g}" for k, v in st.items())
        + f"; {time.time() - t0:.1f} s (compile included)")
    check_same_path(bench, c1, c4, med, "TP flagship")

    # explicit shard_map VCO scan (one psum per step) vs its jnp reference
    params = vco_params(space, args.pi_n_neurons, seed=args.seed)
    T = 1000
    rng = np.random.default_rng(0)
    vels = (0.03 * rng.normal(size=(T, 2))).astype(np.float32)
    corr = np.zeros((T, space.ssp_dim), np.float32)
    corr[:50] = space.encode(np.array([[0.1, -0.1]])).flatten()
    run = make_sharded_vco_scan(params, make_mesh(4), T)
    _, out4 = run(run.initial_state(), vels, corr)
    _, out1 = vco_reference_scan(params, vco_initial_state(params), vels,
                                 corr)
    st = compare_traces(np.asarray(out4), np.asarray(out1), ATOL,
                        spike_flip_tolerant=True, label="shard_map VCO")
    log(f"[f] shard_map VCO scan, {T} steps: " + ", ".join(
        f"{k} {v:.3g}" for k, v in st.items()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (f)")
    opts = ap.parse_args()

    n_gpus = 4 if opts.four else 1
    card = phase_device(n_gpus)
    bench = load_bench()
    args = bench.make_parser().parse_args([])
    t_all = time.time()
    if opts.four:
        phase_four(bench, args, card)
    else:
        out, space, path, bundle, xs0 = phase_flagship(bench, args, card)
        phase_parity(bench, args, out, space, path)
        phase_banks(bench, args, out, path)
        phase_serving(out, bundle, xs0)
    log(f"all phases passed in {time.time() - t_all:.1f} s on {card}")

    import jax
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
