"""Platform plumbing: where the compile cache lives, the matmul precision
of the step and of the device solves, the device-peak table that
utilization figures divide by, and chip_smoke.py refusing to run without
a GPU."""

import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from sspslam_tpu.nef import (LIF, Connection, Ensemble, Network, Node, Probe,
                             Simulator, simulator, solvers)
from sspslam_tpu.nef.processes import TimeTable
from sspslam_tpu.utils.profiling import (device_peaks, kernel_busy_summary,
                                         mfu, step_peak_flops)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


class TestCompileCache:
    @pytest.mark.parametrize("env_set", [True, False])
    def test_cache_dir(self, env_set, tmp_path):
        """JAX_COMPILATION_CACHE_DIR when it is set, else the fixed
        directory inside the checkout; in a fresh process, as a user
        starts one."""
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = os.path.join(ROOT, ".jax_cache")
        if env_set:
            env["JAX_COMPILATION_CACHE_DIR"] = want = str(tmp_path)
        code = ("import jax\n"
                "from sspslam_tpu.nef import simulator\n"
                "for _ in range(2):\n"
                "    simulator._enable_compilation_cache()\n"
                "    print(jax.config.jax_compilation_cache_dir)\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300, check=True)
        # a second Simulator in the same process keeps the same dir
        assert proc.stdout.split() == [want, want]
        if not env_set:
            with open(os.path.join(ROOT, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()


class TestStepPrecision:
    def test_step_dots_run_at_highest_under_any_context(self):
        """Every dot of the step carries "highest" precision, even when
        the process asks for TF32 around it."""
        with Network(seed=0) as net:
            u = Node(TimeTable(np.ones((10, 2), np.float32)))
            a = Ensemble(50, 2)
            b = Ensemble(40, 2)
            Connection(u, a, synapse=None)
            Connection(a, b)
            Probe(b, synapse=0.01)
        sim = Simulator(net, seed=0)
        xs = [np.asarray(c)[0] for c in sim._tabulate_inputs(1)]
        with jax.default_matmul_precision("tensorfloat32"):
            text = str(jax.make_jaxpr(sim._step_fn)(
                sim.model.initial_state(), xs, sim.params))
        assert_all_dots_highest(text)

    @pytest.mark.parametrize("batched", [False, True])
    def test_device_solves_run_at_highest_under_any_context(self, batched):
        """The device decoder solves (large ensembles) form their Gram
        matrices in float32, as the host solve does, whatever the
        platform default."""
        rng = np.random.default_rng(0)
        ep = rng.uniform(-1, 1, (30, 2)).astype(np.float32)
        if batched:
            solve = solvers.solve_decoders_batched_on_device
            enc = rng.normal(size=(3, 20, 2)).astype(np.float32)
            bias = rng.normal(size=(3, 20)).astype(np.float32)
        else:
            solve = solvers.solve_decoders_on_device
            enc = rng.normal(size=(20, 2)).astype(np.float32)
            bias = rng.normal(size=20).astype(np.float32)
        solvers._jit_solver_cache.clear()
        with jax.default_matmul_precision("tensorfloat32"):
            text = str(jax.make_jaxpr(
                lambda e: solve(LIF(), e, bias, ep, ep))(enc))
        assert_all_dots_highest(text)


def assert_all_dots_highest(jaxpr_text):
    precs = re.findall(r"precision=(\S+ \S+)", jaxpr_text)
    assert len(precs) == jaxpr_text.count("dot_general") > 0
    assert set(precs) == {"(Precision.HIGHEST, Precision.HIGHEST)"}


class TestDevicePeaks:
    def test_h100_has_peaks(self):
        assert device_peaks(H100)["hbm_bytes_per_s"] == 3.35e12
        # the f32 step runs at "highest" precision: the non-tensor-core
        # float32 rate; reduced-precision banks feed bf16 inputs
        assert step_peak_flops(H100) == 67e12
        assert step_peak_flops(H100, "int8") == 989e12
        assert mfu(67e9, H100) == pytest.approx(1e-3)

    def test_unknown_device_has_no_peak(self):
        kind = jax.devices()[0].device_kind
        assert device_peaks(kind) is None
        assert step_peak_flops(kind) is None
        assert mfu(1e9, kind) is None


class TestTraceReduction:
    def test_busy_is_union_of_kernel_intervals(self):
        # two overlapping kernels (10-30, 20-40), a gap, one more (60-70)
        s = kernel_busy_summary([(60, 70), (10, 30), (20, 40)])
        assert s["n_kernels"] == 3
        assert s["window_ns"] == 60 and s["busy_ns"] == 40
        assert s["idle_share"] == pytest.approx(1 / 3)
        with pytest.raises(ValueError):
            kernel_busy_summary([])


class TestChipSmokeNeedsGPU:
    @pytest.mark.parametrize("alone", [False, True])
    def test_refuses_without_gpu(self, alone, tmp_path):
        """No CPU fallback: without a GPU (or without the rest of the repo
        beside it) the smoke exits non-zero and prints no result."""
        cwd = ROOT
        if alone:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
            cwd = str(tmp_path)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
