"""Throughput vs model scale: where does the engine leave latency-bound?

The flagship reference config (ssp_dim=97, ~82k LIF) is op-latency-bound:
its step time is set by the number of small kernels, not by FLOPs
(PERF.md "Where the time goes").  Production
deployments run larger maps: higher SSP dimensionality (finer spatial
resolution / larger arenas at fixed length_scale) and proportionally larger
memory populations.  This sweep measures how the compiled step scales with
model size and where bf16 parameter storage (Simulator(matmul_dtype=...))
starts to pay — the regime the reference's OpenCL backend never reaches
(nengo_ocl is single-precision only; reference experiments/run_slam.py:200).

Populations scale with d the same way the reference CLI's defaults relate
to d=97: mem_n_neurons = 10*d, pi_n_neurons fixed per VCO, circonv 100/dim.

Usage:
  python experiments/scale_study.py [--dims 97,193,385,769] [--steps 10000]
Prints a markdown table (and one JSON line per row on stderr).
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def measure(bench, d, steps, seg, bf16, seed=0, reps=3):
    args = argparse.Namespace(
        ssp_dim=d, pi_n_neurons=800, mem_n_neurons=10 * d,
        circonv_n_neurons=100, n_landmarks=10, cleanup_samples=100,
        seed=seed, warmup_steps=200, segment_steps=seg, timed_steps=steps,
        baseline_steps=0, scan_unroll=8, reps=1, bf16=bf16, batch=0,
        skip_baseline=True, world_T=14.0)
    t0 = time.time()
    sim, p, space, path = bench.build(args)
    build_s = time.time() - t0
    n_neurons = sum((be.k * be.n if be.batched else be.n)
                    for be in sim.model.ensembles)
    d_real = space.ssp_dim

    # cover warmup + ALL reps: the reps continue the simulation, so a
    # (steps + seg) table would run out after rep 1 and push later reps
    # onto the unwarmed host-xs path mid-measurement
    sim.preload_inputs(reps * steps + seg, device=True)
    t0 = time.time()
    sim.run_steps(seg, segment_steps=seg)
    sim.sync()
    compile_s = time.time() - t0

    best = 0.0
    for _ in range(reps):
        t0 = time.time()
        sim.run_steps(steps, segment_steps=seg)
        sim.sync()
        wall = time.time() - t0
        best = max(best, steps / wall)
    from sspslam_tpu.utils.profiling import model_utilization_summary
    flops = float(sum(r["flops_per_step"]
                      for r in model_utilization_summary(sim.model)))
    return {"d": d_real, "neurons": n_neurons, "bf16": bf16,
            "build_s": round(build_s, 1), "compile_s": round(compile_s, 1),
            "steps_per_s": round(best, 0),
            "us_per_step": round(1e6 / best, 2),
            "mflop_per_step": round(flops / 1e6, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="97,193,385,769")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--segment-steps", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--f32-only", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    bench = load_bench()

    rows = []
    for d in [int(x) for x in args.dims.split(",")]:
        for bf16 in ([False] if args.f32_only else [False, True]):
            r = measure(bench, d, args.steps, args.segment_steps, bf16,
                        reps=args.reps)
            rows.append(r)
            print(json.dumps(r), file=sys.stderr, flush=True)

    print("| d | LIF neurons | params dtype | MFLOP/step | steps/s "
          "(best of reps, synced) | us/step |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['d']} | {r['neurons']:,} | "
              f"{'bf16' if r['bf16'] else 'f32'} | {r['mflop_per_step']} | "
              f"{r['steps_per_s']:,.0f} | {r['us_per_step']} |")


if __name__ == "__main__":
    main()
