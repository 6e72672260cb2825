"""Tracing / resource profiling.

The analog of the aux instrumentation the reference exposes (SURVEY.md §5):
wall/thread timing is recorded by the experiment scripts; the Loihi
utilization summary (compartments / axons / synapses per chip,
run_slam.py:212-227) maps here to a model resource summary — neurons,
weight-matrix memory and estimated FLOPs per step — plus the device-peak
table that utilization figures divide by, and a ``jax.profiler`` trace
wrapper for timeline inspection.
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import List, Optional

__all__ = ["model_utilization_summary", "print_utilization_summary",
           "trace_run", "DEVICE_PEAKS", "device_peaks", "step_peak_flops",
           "mfu", "kernel_busy_summary", "gpu_trace_summary"]

#: Published dense peak rates, keyed on ``jax.Device.device_kind``.
#: NVIDIA H100 SXM data sheet, without sparsity, at the full 700 W power
#: limit: FLOP/s per matmul input precision ("f32" is the non-tensor-core
#: float32 rate that a "highest"-precision f32 matmul runs at) and HBM
#: bytes/s.  A device not listed has no peak: utilization is then None,
#: never a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
                  "fp8": 1979e12, "int8": 1979e12},
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> Optional[dict]:
    return DEVICE_PEAKS.get(device_kind)


def _step_precision_key(matmul_dtype) -> str:
    """Which peak the step's matmuls run at: reduced-precision parameter
    banks (bf16/int8/fp8) feed bf16 inputs; float32 banks follow the
    step's matmul precision (nef/executor.STEP_PRECISION)."""
    if matmul_dtype is not None and matmul_dtype != "f32":
        return "bf16"
    from ..nef.executor import STEP_PRECISION
    if STEP_PRECISION in ("highest", "float32"):
        return "f32"
    if STEP_PRECISION in ("bfloat16", "fastest"):
        return "bf16"
    return "tf32"


def step_peak_flops(device_kind: str, matmul_dtype=None) -> Optional[float]:
    """Peak FLOP/s of ``device_kind`` at the simulation step's matmul
    precision, or None for a device without published peaks."""
    peaks = device_peaks(device_kind)
    if peaks is None:
        return None
    return peaks["flops"][_step_precision_key(matmul_dtype)]


def mfu(flops_per_s: float, device_kind: str,
        matmul_dtype=None) -> Optional[float]:
    """Achieved model FLOP/s over the device's peak at the step's
    precision; None when the device has no published peak."""
    peak = step_peak_flops(device_kind, matmul_dtype)
    return None if peak is None else flops_per_s / peak


def model_utilization_summary(model) -> List[dict]:
    """Per-ensemble-group resource rows for a built Model."""
    rows = []
    conn_by_pre = {}
    for bc in model.connections:
        if bc.decoders is not None:
            conn_by_pre.setdefault(id(bc.pre), []).append(bc)

    for be in model.ensembles:
        n_neurons = be.k * be.n if be.batched else be.n
        enc_bytes = be.scaled_encoders.size * 4
        dec_elems = sum(bc.decoders.size for bc in conn_by_pre.get(id(be), []))
        dec_bytes = dec_elems * 4
        # J matvec + decode matvecs, 2 flops per MAC
        flops = 2 * (be.scaled_encoders.size + dec_elems)
        state_bytes = sum(
            v.size * 4 for v in be.neuron_type.init_state(
                (be.k, be.n) if be.batched else (be.n,)).values())
        rows.append({
            "label": getattr(be.obj, "label", None) or f"ens{be.index}",
            "batched": be.batched,
            "neurons": int(n_neurons),
            "encoder_bytes": int(enc_bytes),
            "decoder_bytes": int(dec_bytes),
            "state_bytes": int(state_bytes),
            "flops_per_step": int(flops),
        })
    return rows


def print_utilization_summary(model, file=None):
    rows = model_utilization_summary(model)
    total_neurons = sum(r["neurons"] for r in rows)
    total_bytes = sum(r["encoder_bytes"] + r["decoder_bytes"]
                      + r["state_bytes"] for r in rows)
    total_flops = sum(r["flops_per_step"] for r in rows)
    print(f"model resources: {len(rows)} ensemble groups, "
          f"{total_neurons} neurons, "
          f"{total_bytes / 2**20:.1f} MiB weights+state, "
          f"~{total_flops / 1e6:.2f} MFLOP/step", file=file)
    for r in sorted(rows, key=lambda r: -r["flops_per_step"])[:8]:
        print(f"  {r['label']:<24} {r['neurons']:>7} neurons  "
              f"{(r['encoder_bytes'] + r['decoder_bytes']) / 2**10:>8.0f} KiB  "
              f"{r['flops_per_step'] / 1e3:>8.0f} kFLOP/step", file=file)
    return rows


@contextlib.contextmanager
def trace_run(logdir: str):
    """jax.profiler trace context: ``with trace_run('/tmp/trace'): sim.run(..)``
    then inspect with TensorBoard/XProf."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def kernel_busy_summary(intervals) -> dict:
    """Reduce device kernel intervals ``[(start_ns, end_ns), ...]`` to
    the kernel count, the window from the first start to the last end,
    the busy time (the union of the intervals) and the idle share
    (1 - busy / window)."""
    ivs = sorted(intervals)
    if not ivs:
        raise ValueError("no kernel intervals")
    busy = 0
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in ivs) - ivs[0][0]
    return {"n_kernels": len(ivs), "window_ns": window, "busy_ns": busy,
            "idle_share": 1.0 - busy / window if window else 0.0}


def gpu_trace_summary(trace_dir: str) -> dict:
    """:func:`kernel_busy_summary` of the GPU compute-stream kernels in the
    newest ``jax.profiler`` trace under ``trace_dir``."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no profiler trace under {trace_dir}")
    pd = ProfileData.from_file(files[-1])
    ivs = [(e.start_ns, e.start_ns + e.duration_ns)
           for plane in pd.planes if plane.name.startswith("/device:GPU")
           for line in plane.lines if "Compute" in line.name
           for e in line.events]
    return kernel_busy_summary(ivs)
