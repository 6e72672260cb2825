"""Cost and parity of the simulation step at each matmul precision.

The package runs the step at one matmul precision,
``nef/executor.STEP_PRECISION``.  This probe rebinds that constant while
each of its Simulators is built, compiled and run, to measure what another
precision would cost and whether the NumPy-interpreter statistic tells it
apart.  For each precision it

  * times the flagship (bench.py's model and model options) over
    ``--timed-steps`` in ``--segment-steps`` segments from a
    device-resident input table, in the order a b b a so that drift of the
    host clock cancels;
  * runs ``cross_check`` (nef/reference_backend.py) against the NumPy
    interpreter for ``--parity-steps`` steps with an f32 clean-up, as
    chip_smoke.py phase c does, and records its statistics or the
    statistic that failed.

Usage: python experiments/precision_probe.py
           [--precisions highest,tensorfloat32] [--parity-steps 300]
           [bench.py options, e.g. --segment-steps 1000 --timed-steps 10000]
Prints one JSON line.
"""

import contextlib
import importlib.util
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, ROOT)


def load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@contextlib.contextmanager
def step_precision(precision, cleanup_f32=False):
    """Build and compile step programs at ``precision`` (and, with
    ``cleanup_f32``, with the clean-up comparing in float32)."""
    from sspslam_tpu.nef import executor
    old = executor.STEP_PRECISION
    executor.STEP_PRECISION = precision
    if cleanup_f32:
        os.environ["SSPSLAM_CLEANUP_F32"] = "1"
    try:
        yield
    finally:
        executor.STEP_PRECISION = old
        if cleanup_f32:
            del os.environ["SSPSLAM_CLEANUP_F32"]


def main():
    bench = load_bench()
    ap = bench.make_parser()
    ap.description = __doc__.split("\n")[0]
    ap.add_argument("--precisions", default="highest,tensorfloat32",
                    help="comma list of jax.default_matmul_precision names")
    ap.add_argument("--parity-steps", type=int, default=300)
    args = ap.parse_args()
    import jax
    import numpy as np
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sspslam_tpu.nef.reference_backend import cross_check

    precs = args.precisions.split(",")
    seg = args.segment_steps
    n = max(seg, args.timed_steps // seg * seg)
    sims, result = {}, {}
    for p in precs:
        with step_precision(p):
            sim, _, _, _ = bench.build(args)
            # what the step's dots carry, to show the rebinding took
            xs = [np.asarray(c)[0] for c in sim._tabulate_inputs(1)]
            text = str(jax.make_jaxpr(sim._step_fn)(
                sim.model.initial_state(), xs, sim.params))
            dots = sorted(set(re.findall(r"precision=\((\S+),", text)))
            sim.preload_inputs(seg + n)
            t0 = time.time()
            # compiles the one segment program every timed run reuses
            sim.run_steps(seg, segment_steps=seg)
            sim.sync()
        sims[p] = sim
        result[p] = {"dot_precisions": dots,
                     "compile_s": time.time() - t0, "steps_per_s": []}
        with step_precision(p, cleanup_f32=True):
            psim, _, _, _ = bench.build(args)
            try:
                stats = cross_check(psim, args.parity_steps, atol=1e-3,
                                    spike_flip_tolerant=True,
                                    segment_steps=min(100, args.parity_steps))
                result[p]["parity"] = {str(k): v for k, v in stats.items()}
            except AssertionError as e:
                result[p]["parity"] = f"failed: {e}"
        bench.log(f"{p}: parity {result[p]['parity']}")

    for p in precs + precs[::-1]:
        sim = sims[p]
        t0 = time.time()
        with step_precision(p):
            sim.run_steps(n, segment_steps=seg)
            sim.sync()
        result[p]["steps_per_s"].append(n / (time.time() - t0))
        # rewind onto the same device-resident input rows
        sim._preload_start = sim.n_steps - seg
        bench.log(f"{p}: {result[p]['steps_per_s'][-1]:.0f} steps/s")

    print(json.dumps({
        "metric": f"flagship steps/s and interpreter parity per matmul "
                  f"precision (segment {seg}, {n} timed steps)",
        "precisions": result, **bench.device_fields()}))


if __name__ == "__main__":
    main()
