"""Roofline analysis of the full-SLAM step vs the measured device time.

How far is the compiled SLAM step from the hardware bound?  This script
produces that evidence:

1. builds the bench SLAM model and compiles one scan segment;
2. reads XLA's own cost analysis (FLOPs, bytes accessed) per step;
3. computes the two roofline bounds on the device —
     compute bound   = flops / peak_flops
     bandwidth bound = hbm_bytes / peak_bw
   and their max (the speed-of-light step time IF every operand restaged
   from device memory; operands that stay in cache make the true bound
   lower);
4. compares with the profiler-measured device time (device_time_probe).

Peaks default to the device's published ones at the step's matmul
precision (sspslam_tpu/utils/profiling.DEVICE_PEAKS); a device without
them gets null bounds unless --peak-flops/--peak-bw are given.

Usage: python experiments/step_roofline.py [--steps 2000]
"""

import argparse
import json
import os
import sys

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
    # seg == unroll: the scan fully unrolls (no while loop), so XLA's
    # cost analysis counts exactly seg steps (a while body is counted
    # ONCE regardless of trip count)
    ap.add_argument("--seg", type=int, default=8)
    ap.add_argument("--scan-unroll", type=int, default=8)
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="peak FLOP/s (default: the device's published "
                         "peak at the step precision)")
    ap.add_argument("--peak-bw", type=float, default=None,
                    help="device-memory bytes/s (default: the device's "
                         "published bandwidth)")
    ap.add_argument("--measured-us", type=float, default=None,
                    help="profiler-measured device us/step "
                         "(device_time_probe); printed alongside if given")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests; the cost "
                         "analysis then reflects the CPU lowering)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    benchmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(benchmod)

    class A:
        pass

    b = A()
    for k in ("ssp_dim", "pi_n_neurons", "mem_n_neurons",
              "circonv_n_neurons", "n_landmarks", "seed"):
        setattr(b, k, getattr(args, k, 0))
    b.seed = 0
    b.cleanup_samples = args.cleanup_samples
    b.timed_steps = args.seg
    b.segment_steps = args.seg
    b.scan_unroll = args.scan_unroll
    b.bf16 = False
    b.world_T = 4.0
    sim, probe, _space, _path = benchmod.build(b)

    import jax
    run_segment = sim._get_scan(args.seg)
    width = sum(n.size_out for n in sim.model.input_nodes)
    xs = np.zeros((args.seg, width), np.float32)
    state = sim.model.initial_state()
    lowered = jax.jit(
        run_segment.__wrapped__ if hasattr(run_segment, "__wrapped__")
        else run_segment).lower(state, xs, sim.params) \
        if not hasattr(run_segment, "lower") else run_segment.lower(
            state, xs, sim.params)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    flops_seg = float(cost.get("flops", float("nan")))
    bytes_seg = float(cost.get("bytes accessed", float("nan")))
    flops = flops_seg / args.seg
    byts = bytes_seg / args.seg

    from sspslam_tpu.utils.profiling import device_peaks, step_peak_flops
    kind = jax.devices()[0].device_kind
    peak_flops = args.peak_flops or step_peak_flops(kind)
    peak_bw = args.peak_bw or (device_peaks(kind) or {}).get(
        "hbm_bytes_per_s")
    report = {
        "device_kind": kind,
        "flops_per_step": flops,
        "hbm_bytes_per_step": byts,
        # bounds are null for a device without published peaks
        "compute_bound_us": None,
        "bandwidth_bound_us": None,
        "roofline_us_per_step": None,
    }
    if peak_flops and peak_bw:
        t_compute = flops / peak_flops
        t_bw = byts / peak_bw
        t_roof = max(t_compute, t_bw)
        report.update(compute_bound_us=round(t_compute * 1e6, 3),
                      bandwidth_bound_us=round(t_bw * 1e6, 3),
                      roofline_us_per_step=round(t_roof * 1e6, 3))
    if args.measured_us and peak_flops and peak_bw:
        report["measured_us_per_step"] = args.measured_us
        report["fraction_of_roofline"] = round(t_roof * 1e6 / args.measured_us, 3)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
