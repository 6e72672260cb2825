"""Precise device-time measurement of the SLAM step via the profiler.

Wall-clock timing includes host dispatch and shares the host's CPU with
other work; XLA's own per-op accounting does not.
This builds the bench SLAM model, traces a run, and reports total device
self-time per step plus the top op categories — the number to use when
comparing step-level optimisations.

Usage: python experiments/device_time_probe.py [--bf16] [--scan-unroll 8]
"""

import argparse
import glob
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ssp-dim", type=int, default=97)
    ap.add_argument("--pi-n-neurons", type=int, default=800)
    ap.add_argument("--mem-n-neurons", type=int, default=970)
    ap.add_argument("--circonv-n-neurons", type=int, default=100)
    ap.add_argument("--n-landmarks", type=int, default=10)
    ap.add_argument("--cleanup-samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan-unroll", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--segment-steps", type=int, default=1000)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--top", type=int, default=0, help="print top-N ops")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    bargs = argparse.Namespace(
        ssp_dim=args.ssp_dim, pi_n_neurons=args.pi_n_neurons,
        mem_n_neurons=args.mem_n_neurons,
        circonv_n_neurons=args.circonv_n_neurons,
        n_landmarks=args.n_landmarks, cleanup_samples=args.cleanup_samples,
        seed=args.seed, warmup_steps=200, segment_steps=args.segment_steps,
        timed_steps=args.steps, baseline_steps=0, scan_unroll=args.scan_unroll,
        reps=1, bf16=args.bf16, batch=0, skip_baseline=True, world_T=14.0)
    sim, p, space, path = bench.build(bargs)

    import jax
    sim.run_steps(args.segment_steps, segment_steps=args.segment_steps)
    jax.block_until_ready(sim.state)

    tdir = tempfile.mkdtemp(prefix="slam_devtime_")
    jax.profiler.start_trace(tdir)
    sim.run_steps(args.steps, segment_steps=args.segment_steps)
    jax.block_until_ready(sim.state)
    jax.profiler.stop_trace()

    from xprof.convert import raw_to_tool_data as rtd
    f = glob.glob(os.path.join(tdir, "plugins/profile/*/*.xplane.pb"))
    data, _ = rtd.xspace_to_tool_data(f, "hlo_stats", {})
    d = json.loads(data)
    cols = [c["label"] for c in d["cols"]]
    I = {c: i for i, c in enumerate(cols)}
    rows = [[c.get("v") for c in r["c"]] for r in d["rows"]]
    total_us = sum(r[I["Total self time (us)"]] or 0 for r in rows)
    import collections
    catt = collections.defaultdict(float)
    for r in rows:
        catt[r[I["HLO op category"]]] += r[I["Total self time (us)"]] or 0
    print(f"device time: {total_us / args.steps:.3f} us/step "
          f"({args.steps} steps, total {total_us / 1e3:.1f} ms)")
    for k, v in sorted(catt.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {v / args.steps:7.3f} us/step  {k}")
    if args.top:
        rows.sort(key=lambda r: -(r[I["Total self time (us)"]] or 0))
        for r in rows[:args.top]:
            t = (r[I["Total self time (us)"]] or 0) / args.steps
            txt = str(r[I["HLO op text"]])[:120].replace("\n", " ")
            print(f"  {t:7.3f} us/step  {txt}")
    print(json.dumps({"metric": "SLAM device us/step",
                      "value": round(total_us / args.steps, 3),
                      "unit": "us/step"}))


if __name__ == "__main__":
    main()
