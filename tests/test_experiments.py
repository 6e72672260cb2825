"""Smoke tests for the experiment CLI layer (tiny configs, CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(name, args, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SSPSLAM_FORCE_CPU"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "experiments", name)] + args,
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


class TestExperimentScripts:
    def test_run_pathint(self, tmp_path):
        out = run_script("run_pathint.py", [
            "--T", "2", "--limit", "1.0", "--pi-n-neurons", "100",
            "--ssp-dim", "31", "--save", "--save-dir", str(tmp_path),
            "--backend", "cpu"])
        assert "final distance error" in out
        assert any(f.endswith(".npz") for f in os.listdir(tmp_path))

    def test_run_slam(self, tmp_path):
        out = run_script("run_slam.py", [
            "--T", "2", "--limit", "1.0", "--pi-n-neurons", "80",
            "--mem-n-neurons", "100", "--circonv-n-neurons", "20",
            "--ssp-dim", "31", "--n-landmarks", "4", "--view-rad", "0.6",
            "--single-obj", "--save", "--save-dir", str(tmp_path),
            "--backend", "cpu"])
        assert "final distance error" in out

    def test_run_slamview(self, tmp_path):
        out = run_script("run_slamview.py", [
            "--T", "2", "--limit", "1.0", "--pi-n-neurons", "80",
            "--mem-n-neurons", "100", "--circonv-n-neurons", "20",
            "--ssp-dim", "31", "--n-landmarks", "4", "--view-rad", "0.6",
            "--save", "--save-dir", str(tmp_path), "--backend", "cpu"])
        assert "final distance error" in out

    def test_plot_trials(self, tmp_path):
        # generate one PI trial then aggregate it
        run_script("run_pathint.py", [
            "--T", "2", "--limit", "1.0", "--pi-n-neurons", "80",
            "--ssp-dim", "31", "--save", "--save-dir", str(tmp_path),
            "--backend", "cpu"])
        out = run_script("plot_trials_2d.py", [
            "--data-dir", str(tmp_path),
            "--out", str(tmp_path / "trials.png")])
        assert os.path.exists(tmp_path / "trials.png")

    def test_run_pathint_gif(self, tmp_path):
        out = run_script("run_pathint_gif.py", [
            "--T", "1", "--limit", "2.0", "--pi-n-neurons", "60",
            "--ssp-dim", "19", "--n-frames", "5", "--n-grid", "15",
            "--out", str(tmp_path / "pi.gif"), "--backend", "cpu"])
        assert os.path.exists(tmp_path / "pi.gif")

    def test_run_slam_map_gif(self, tmp_path):
        out = run_script("run_slam_map_gif.py", [
            "--T", "2", "--limit", "1.0", "--pi-n-neurons", "60",
            "--mem-n-neurons", "80", "--circonv-n-neurons", "16",
            "--ssp-dim", "19", "--n-landmarks", "3", "--n-frames", "4",
            "--n-grid", "12", "--out", str(tmp_path / "map.gif"),
            "--backend", "cpu"])
        assert os.path.exists(tmp_path / "map.gif")

    def test_train_pathint(self, tmp_path):
        out = run_script("train_pathint.py", [
            "--cpu", "--ssp-dim", "19", "--pi-n-neurons", "40",
            "--T-steps", "300", "--segment-steps", "100",
            "--fit-steps", "8", "--save", "--save-dir", str(tmp_path)])
        assert "backprop-tuned" in out
        assert any(f.startswith("trainpi_") for f in os.listdir(tmp_path))

    def test_train_slam(self, tmp_path):
        out = run_script("train_slam.py", [
            "--cpu", "--T", "1", "--ssp-dim", "19", "--pi-n-neurons", "30",
            "--mem-n-neurons", "60", "--cc-n-neurons", "16",
            "--n-landmarks", "4", "--segment-steps", "100",
            "--fit-steps", "3", "--save", "--save-dir", str(tmp_path)],
            timeout=600)
        assert "gradient-tuned" in out
        assert any(f.startswith("trainslam_") for f in os.listdir(tmp_path))

    def test_slam_map_new(self, tmp_path):
        out = run_script("slam_map_new.py", [
            "--T", "4", "--pi-n-neurons", "60", "--circonv-n-neurons", "16",
            "--n-scales", "3", "--n-rotates", "3",
            "--save-dir", str(tmp_path), "--backend", "cpu"], timeout=600)
        assert "area query sims" in out
        assert os.path.exists(tmp_path / "slam_map_queries.png")

    def test_closed_loop_nav(self):
        import json
        out = run_script("closed_loop_nav.py", [
            "--cpu", "--ssp-dim", "31", "--pi-n-neurons", "80",
            "--mem-n-neurons", "100", "--circonv-n-neurons", "20",
            "--n-landmarks", "4", "--tick-steps", "25",
            "--explore-T", "1", "--nav-T", "2", "--decode-grid", "31"],
            timeout=600)
        result = json.loads(out.strip().splitlines()[-1])
        # tiny populations: just require the loop to run and the estimate
        # to stay inside the arena-scale error band during exploration
        assert result["n_ticks"] == 120
        assert result["explore_est_err_median"] < 0.8
        assert result["tick_latency_ms_median"] > 0


class TestServingProbe:
    def test_serving_probe_cpu(self):
        import json
        out = run_script("serving_probe.py", [
            "--cpu", "--ssp-dim", "31", "--pi-n-neurons", "60",
            "--mem-n-neurons", "80", "--circonv-n-neurons", "30",
            "--cleanup-samples", "10", "--world-T", "2",
            "--segment-steps", "500", "--timed-steps", "1000",
            "--reps", "2"], timeout=600)
        result = json.loads(out.strip().splitlines()[-1])
        assert result["value"] > 0
        assert result["live_engine_steps_per_s"] > 0
        assert result["bundle_mb"] > 0


class TestBenchSmoke:
    def test_bench_cpu_tiny(self):
        """bench.py end-to-end on CPU at toy scale, including the chained
        timed path and the host-interpreter baseline — this is the
        artifact the driver runs at round end."""
        import json
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench.py"),
             "--cpu", "--ssp-dim", "31", "--pi-n-neurons", "60",
             "--mem-n-neurons", "80", "--circonv-n-neurons", "30",
             "--cleanup-samples", "10", "--world-T", "2",
             "--segment-steps", "500", "--timed-steps", "1000",
             "--reps", "2", "--baseline-steps", "30",
             "--baseline-reps", "2"],
            capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["unit"] == "steps/s" and line["value"] > 0
        assert line["vs_baseline"] and line["vs_baseline"] > 1
        assert "tracking_cosine" in line
        # the CPU has no published peak: MFU is null, never a default
        assert line["device_kind"] == "cpu" and line["mfu"] is None


class TestPrecisionProbe:
    def test_precision_probe_cpu(self):
        """Both precisions are timed (a b b a) and checked against the
        NumPy interpreter; the package's own precision is restored."""
        import json
        out = run_script("precision_probe.py", [
            "--cpu", "--ssp-dim", "31", "--pi-n-neurons", "60",
            "--mem-n-neurons", "80", "--circonv-n-neurons", "30",
            "--cleanup-samples", "10", "--world-T", "1",
            "--segment-steps", "100", "--timed-steps", "200",
            "--parity-steps", "40"], timeout=600)
        line = json.loads(out.strip().splitlines()[-1])
        res = line["precisions"]
        assert set(res) == {"highest", "tensorfloat32"}
        assert res["highest"]["dot_precisions"] == ["Precision.HIGHEST"]
        assert res["tensorfloat32"]["dot_precisions"] == ["Precision.HIGH"]
        for r in res.values():
            assert len(r["steps_per_s"]) == 2 and min(r["steps_per_s"]) > 0
            # the CPU ignores TF32: both pass the interpreter statistic
            assert isinstance(r["parity"], dict)


class TestValidateLoopClosureSmoke:
    def test_tiny_cpu(self):
        """The headline reproducer runs end-to-end at toy scale and SLAM
        beats the PI-only control on its own output."""
        import json
        out = run_script("validate_loop_closure.py", [
            "--cpu", "--T", "8", "--ssp-dim", "31", "--n-landmarks", "6",
            "--pi-n-neurons", "100", "--mem-n-neurons", "150",
            "--circonv-n-neurons", "30", "--view-rad", "0.4", "--tuned"],
            timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["slam_median"] < line["pi_median"] * 1.5
        assert np.isfinite(line["slam_final"])


class TestKidnappedRobotSmoke:
    def test_tiny_cpu(self):
        """Relocalization probe runs end-to-end: two-phase world with a
        real teleport, mid-run traced-param gate/learning-rate flips, and
        per-model recovery metrics.  Tracking quality is meaningless at
        toy scale (see VALIDATION for the reference-scale result); this
        asserts the mechanics."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--T", "20", "--limit", "0.4", "--ssp-dim", "31",
            "--n-landmarks", "8", "--pi-n-neurons", "80",
            "--mem-n-neurons", "120", "--circonv-n-neurons", "30",
            "--view-rad", "0.4", "--recovery-window", "4",
            "--min-jump", "0.5"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["jump"] >= 0.3
        for model in ("strict", "adaptive", "pi_only"):
            assert "post_err" in line[model] and "recovery_s" in line[model]
            assert np.isfinite(line[model]["pre_err"])

    def test_in_model_cpu(self):
        """--in-model: the recovery controller is a stateful node in the
        carry; one straight simulation, no host decisions; the suppress
        channel reconstructs its decisions."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--in-model", "--T", "12", "--limit", "0.5",
            "--ssp-dim", "31", "--n-landmarks", "8",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--view-rad", "0.4",
            "--min-jump", "0.4"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["auto"]["mode"] == "in_model"
        assert "recovery_frac_post" in line["auto"]

    def test_in_model_anchor_cpu(self):
        """--anchor: the absolute-anchor channels (surveyed-beacon
        landmark) compile into the in-model gate; the JSON reports the
        chosen landmark and its in-view coverage."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--in-model", "--anchor", "--T", "12", "--limit",
            "0.5", "--ssp-dim", "31", "--n-landmarks", "8",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--view-rad", "0.4",
            "--min-jump", "0.4"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["auto"]["mode"] == "in_model"
        anc = line["anchor"]
        assert anc["landmarks"] and all(0 <= i < 8 for i in anc["landmarks"])
        assert anc["in_view_frac_pre"] > 0
        assert np.isfinite(line["adaptive"]["pre_err"])

    def test_in_model_anchor_view_cpu(self):
        """--model view --anchor: the beacon channels are the view
        family's only detection path (VALIDATION part 9 — its internal
        statistics carry no kidnap signature); the wiring must compile
        and report the same anchor JSON."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--in-model", "--anchor", "--model", "view", "--T",
            "12", "--limit", "0.5", "--ssp-dim", "31", "--n-landmarks",
            "8", "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--view-rad", "0.4",
            "--min-jump", "0.4"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["model"] == "view"
        assert line["auto"]["mode"] == "in_model"
        anc = line["anchor"]
        assert anc["landmarks"] and all(0 <= i < 8 for i in anc["landmarks"])
        assert np.isfinite(line["adaptive"]["pre_err"])

    def test_auto_monitor_cpu(self):
        """--auto mode: the tick monitor runs (at toy scale tracking never
        establishes, so the correct behavior is an armed=False monitor
        with zero events)."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--auto", "--T", "12", "--limit", "0.5",
            "--ssp-dim", "31", "--n-landmarks", "8",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--view-rad", "0.4",
            "--min-jump", "0.4"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        auto = line["auto"]
        assert {"events", "false_triggers", "detect_s",
                "recovery_exit_s"} <= set(auto)

    def test_view_model_in_model_cpu(self):
        """--model view: the auto-recovery controller on the view-cell
        family (round-5 port); same mechanics contract as the landmark
        family."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--model", "view", "--in-model", "--T", "12",
            "--limit", "0.5", "--ssp-dim", "31", "--n-landmarks", "8",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--view-rad", "0.4",
            "--min-jump", "0.4"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["model"] == "view"
        assert line["auto"]["mode"] == "in_model"

    def test_3d_derived_thresholds_cpu(self):
        """--domain-dim 3 --auto-derive: the scaled-config probe derives
        the detection thresholds from the space's similarity kernel
        instead of hand constants, and they land in sane ranges."""
        import json
        out = run_script("kidnapped_robot.py", [
            "--cpu", "--in-model", "--auto-derive", "--T", "10",
            "--limit", "0.6", "--domain-dim", "3", "--length-scale",
            "0.3", "--ssp-dim", "41", "--n-landmarks", "8",
            "--pi-n-neurons", "60", "--mem-n-neurons", "100",
            "--circonv-n-neurons", "20", "--view-rad", "0.4",
            "--min-jump", "0.4"], timeout=1200)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["domain_dim"] == 3
        th = line["derived_thresholds"]
        # K is monotone-decreasing: trigger=K(vr) < cons < exit-ish bands
        assert 0.0 < th["trigger"] < th["cons_trigger"] < 1.0
        assert 0.2 < th["exit"] < 1.0


class TestMapMergeSmoke:
    def test_tiny_cpu(self):
        """Two-agent map merge runs end-to-end: identical draws across
        three programs, carry extraction, decoder/encoder delta merge,
        state injection into a learning-frozen localization run."""
        import json
        out = run_script("map_merge.py", [
            "--cpu", "--T-explore", "6", "--T-test", "5",
            "--limit", "0.5", "--ssp-dim", "31", "--n-landmarks", "8",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--view-rad", "0.4",
            "--eval-gate", "auto_recovery"],
            timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        for cond in ("merged", "agent_A_only", "agent_B_only", "empty"):
            assert np.isfinite(line[cond]["median"])
            assert "left_p90" in line[cond]


class TestTpScalingSmoke:
    def test_virtual_mesh_tiny(self, tmp_path):
        """tp_scaling (the MULTICHIP.md evidence generator) runs on the
        virtual mesh and emits per-mesh FLOP ratios."""
        import json
        out = run_script("tp_scaling.py", [
            "--steps", "20", "--ssp-dim", "31", "--pi-n-neurons", "48",
            "--mem-n-neurons", "64", "--circonv-n-neurons", "16",
            "--n-landmarks", "4", "--mesh-sizes", "1,2", "--reps", "1",
            "--json-out", str(tmp_path / "tp.json")], timeout=900)
        data = json.load(open(tmp_path / "tp.json"))
        meshes = {r["mesh"] for r in data["rows"]} if "rows" in data \
            else {r["mesh"] for r in data}
        assert {1, 2} <= meshes


class TestTuneLoopClosureSmoke:
    def test_quick_sweep_cpu(self):
        """The zero-recompile tuning sweep (hoisted gate params) runs its
        trimmed grid end-to-end and ranks configs."""
        out = run_script("tune_loop_closure.py", [
            "--cpu", "--quick", "--T", "2", "--final-T", "3",
            "--ssp-dim", "31", "--n-landmarks", "4", "--view-rad", "0.6",
            "--limit", "1.0", "--pi-n-neurons", "60",
            "--mem-n-neurons", "80", "--circonv-n-neurons", "20",
            "--segment-steps", "500", "--top", "1"], timeout=900)
        assert "best gate" in out
        assert "stage-2 ranking" in out
        assert "stage-3 confirmation" in out


class TestAnalysisProbesSmoke:
    def test_step_roofline_cpu(self):
        import json
        out = run_script("step_roofline.py", [
            "--cpu", "--ssp-dim", "31", "--pi-n-neurons", "60",
            "--mem-n-neurons", "80", "--circonv-n-neurons", "30",
            "--cleanup-samples", "10", "--seg", "4",
            "--scan-unroll", "4"], timeout=600)
        report = json.loads(out.strip())
        flat = json.dumps(report)
        assert "flop" in flat.lower() and "byte" in flat.lower()

    def test_dp_probe_cpu(self):
        out = run_script("dp_probe.py", [
            "--cpu", "--batch", "2", "--steps", "50", "--pi-n", "40",
            "--ssp-dim", "19", "--reps", "1", "--variants", "A"],
            timeout=600)
        # results go to stderr via log(); returncode 0 is the contract
        assert out is not None

    def test_gate_fidelity_tiny(self):
        out = run_script("gate_fidelity.py", [
            "--T", "2", "--ssp-dim", "19", "--pi-n-neurons", "60",
            "--mem-n-neurons", "80", "--circonv-n-neurons", "20",
            "--n-landmarks", "3"], timeout=600)
        assert "engaged frac" in out

    def test_make_example_paths(self, tmp_path):
        out = run_script("make_example_paths.py", [
            "--out-dir", str(tmp_path)])
        assert os.path.exists(tmp_path / "twoRooms_path.npy")
        arr = np.load(tmp_path / "twoRooms_path.npy")
        assert arr.ndim == 2 and arr.shape[1] == 2

    def test_device_time_probe_cpu(self):
        import json
        out = run_script("device_time_probe.py", [
            "--cpu", "--ssp-dim", "19", "--pi-n-neurons", "40",
            "--mem-n-neurons", "60", "--circonv-n-neurons", "16",
            "--cleanup-samples", "8", "--steps", "50",
            "--segment-steps", "50"], timeout=600)
        line = json.loads(out.strip().splitlines()[-1])
        # CPU has no device-lane trace events, so the measured value is 0
        # here — the smoke test pins the pipeline + JSON contract; the
        # nonzero measurement is accelerator-only
        assert line["unit"] == "us/step" and line["value"] >= 0

    def test_bf16_drift_tiny(self):
        out = run_script("bf16_drift.py", [
            "--cpu", "--T", "1", "--ssp-dim", "19",
            "--pi-n-neurons", "40", "--segment-steps", "250",
            "--limit", "2.0"], timeout=600)
        assert "trajectory cosine" in out

    def test_scale_study_tiny(self):
        out = run_script("scale_study.py", [
            "--cpu", "--dims", "19", "--steps", "100",
            "--segment-steps", "100", "--reps", "1", "--f32-only"],
            timeout=600)
        assert "MFLOP/step" in out


class TestScaledSlamSmoke:
    def test_tiny_cpu(self):
        """Config-5 protocol mechanics at toy scale: multi-seed vmapped
        episodes + PI control in one program, per-seed decoded error,
        aggregate throughput JSON (the reference-scale result is in
        VALIDATION.md 'Scaled sweep')."""
        import json
        out = run_script("scaled_slam.py", [
            "--cpu", "--T", "1.2", "--domain-dim", "2", "--ssp-dim", "31",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--n-landmarks", "6",
            "--view-rad", "0.6", "--limit", "2.0", "--seeds", "0,1",
            "--segment-steps", "300", "--cleanup-samples", "6",
            "--decode-grid", "8"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["unit"] == "steps/s" and line["value"] > 0
        assert len(line["per_seed"]) == 2
        for entry in line["per_seed"]:
            assert np.isfinite(entry["slam"]["median_err"])
            assert np.isfinite(entry["pi_only"]["median_err"])

    def test_anchor_gate_cpu(self):
        """--gate-mode auto_recovery --anchor-k: the scaled campaign's
        anchored configuration (in-model controller + surveyed-beacon
        channels) builds, runs vmapped, and records anchor provenance in
        the JSON."""
        import json
        out = run_script("scaled_slam.py", [
            "--cpu", "--T", "1.2", "--domain-dim", "2", "--ssp-dim", "31",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--n-landmarks", "6",
            "--view-rad", "0.6", "--limit", "2.0", "--seeds", "0,1",
            "--segment-steps", "300", "--cleanup-samples", "6",
            "--decode-grid", "8", "--gate-mode", "auto_recovery",
            "--anchor-k", "2"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["config"]["gate_mode"] == "auto_recovery"
        assert line["config"]["anchor_k"] == 2
        assert len(line["anchors"]["landmarks"]) == 2
        assert np.isfinite(line["anchors"]["trigger"])
        for entry in line["per_seed"]:
            assert np.isfinite(entry["slam"]["median_err"])

    def test_roofline_cpu(self):
        """--roofline: lowers one unrolled segment, reads XLA cost
        analysis, prints bounds without simulating.  The CPU has no
        published peaks, so the test passes explicit ones."""
        import json
        out = run_script("scaled_slam.py", [
            "--cpu", "--T", "1.2", "--domain-dim", "2", "--ssp-dim", "31",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--n-landmarks", "6",
            "--view-rad", "0.6", "--limit", "2.0", "--seeds", "0,1",
            "--cleanup-samples", "6", "--roofline",
            "--peak-flops", "67e12", "--peak-bw", "3.35e12",
            "--measured-us", "50"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert line["device_kind"] == "cpu"
        assert line["flops_per_step"] > 0
        assert line["hbm_bytes_per_step"] > 0
        assert (line["roofline_us_per_episode_step"] ==
                max(line["compute_bound_us_per_episode_step"],
                    line["bandwidth_bound_us_per_episode_step"]))
        assert 0 < line["fraction_of_roofline"] <= 1.0

    def test_dp_sweep_cpu(self):
        """--dp-sweep: throughput-only mode (probe emits dropped at trace
        level) reports one row per B."""
        import json
        out = run_script("scaled_slam.py", [
            "--cpu", "--T", "1.2", "--domain-dim", "2", "--ssp-dim", "31",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--n-landmarks", "6",
            "--view-rad", "0.6", "--limit", "2.0", "--seeds", "0",
            "--segment-steps", "300", "--cleanup-samples", "6",
            "--no-pi-control", "--dp-sweep", "1,2"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        assert [r["B"] for r in line["dp_sweep"]] == [1, 2]
        assert all(r["agg_steps_per_s"] > 0 for r in line["dp_sweep"])


class TestLiveMergeSmoke:
    def test_tiny_cpu(self):
        """Two vmapped agents with periodic in-sim map exchange: both the
        exchange and no-exchange arms run, and the JSON carries crossover
        metrics per agent."""
        import json
        out = run_script("live_merge.py", [
            "--cpu", "--T", "3", "--exchange-s", "0.5", "--ssp-dim", "31",
            "--n-landmarks", "6", "--view-rad", "0.6",
            "--pi-n-neurons", "80", "--mem-n-neurons", "120",
            "--circonv-n-neurons", "30", "--limit", "2.0"], timeout=900)
        line = json.loads(out.strip().splitlines()[-1])
        for arm in ("exchange", "no_exchange"):
            for agent in ("agent_A", "agent_B"):
                assert np.isfinite(
                    line["results"][arm][agent]["cross_median"])
