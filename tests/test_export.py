"""AOT serving-bundle export (nef/export.py).

The reference has no deployment artifact — every process re-runs network
construction + the nengo build.  These tests pin the bundle's contract:
bit-exact equivalence with the live Simulator, learned (PES) state shipping
with the carry, checkpoint swap-in, and loading in a fresh process that
never constructs the model graph.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sspslam_tpu.nef import (Connection, Ensemble, LIFRate, Network, Node,
                             PES, Probe, ServingModel, Simulator, TimeTable,
                             save_bundle)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(n, dt=0.001):
    ts = dt * np.arange(1, n + 1)
    return np.sin(2 * np.pi * 3.0 * ts).astype(np.float32)[:, None]


def _build(n_steps, seed=0, learned=False):
    with Network(seed=seed) as net:
        inp = Node(TimeTable(_table(n_steps)), label="drive")
        a = Ensemble(40, 1, neuron_type=LIFRate())
        Connection(inp, a, synapse=None)
        extras = {}
        if learned:
            b = Ensemble(40, 1, neuron_type=LIFRate())
            c = Connection(a, b, function=lambda x: x * 0,
                           learning_rule_type=PES(1e-2))
            err = Node(lambda t, x: x, size_in=1)
            Connection(b, err, synapse=0.005)
            Connection(inp, err, transform=-1, synapse=0.005)
            Connection(err, c.learning_rule, synapse=None)
            extras["pb"] = Probe(b, synapse=0.01, label="out_b")
        p = Probe(a, synapse=0.01, label="out_a")
    sim = Simulator(net, seed=seed)
    return sim, p, extras


class TestRoundTrip:
    def test_bundle_matches_live_simulator(self, tmp_path):
        n, seg = 120, 40
        sim, p, _ = _build(n)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)

        sim.run_steps(n, segment_steps=seg)
        want = sim.data[p]

        m = ServingModel(str(tmp_path / "b"))
        out = m.run(xs)
        np.testing.assert_array_equal(out["out_a"], want)
        assert m.n_steps == n

    def test_chained_calls_continue_state(self, tmp_path):
        n, seg = 80, 40
        sim, p, _ = _build(n)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        sim.run_steps(n, segment_steps=seg)
        want = sim.data[p]

        m = ServingModel(str(tmp_path / "b"))
        got = np.concatenate([m.run(xs[:seg])["out_a"],
                              m.run(xs[seg:])["out_a"]])
        np.testing.assert_array_equal(got, want)
        m.reset()
        np.testing.assert_array_equal(m.run(xs)["out_a"], want)

    def test_learned_state_ships_with_carry(self, tmp_path):
        """Exporting AFTER a training run bakes the learned PES decoders
        into the bundle's initial carry."""
        n, seg = 200, 50
        sim, p, extras = _build(2 * n, learned=True)
        xs_all = sim._pack_cols(sim._tabulate_inputs(2 * n))
        sim.run_steps(n, segment_steps=seg)        # online learning happens
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        sim.run_steps(n, segment_steps=seg)        # continue the live run
        want = sim.data[extras["pb"]][n:]

        m = ServingModel(str(tmp_path / "b"))
        got = m.run(xs_all[n:])["out_b"]           # same future input rows
        np.testing.assert_array_equal(got, want)

    def test_checkpoint_swap_in(self, tmp_path):
        n, seg = 80, 40
        sim, p, _ = _build(n)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        sim.run_steps(seg, segment_steps=seg)
        sim.save_checkpoint(str(tmp_path / "ckpt"))
        sim.run_steps(seg, segment_steps=seg)
        want = sim.data[p][seg:]

        m = ServingModel(str(tmp_path / "b"))
        m.load_state(str(tmp_path / "ckpt"))
        np.testing.assert_array_equal(m.run(xs[seg:])["out_a"], want)

    def test_subsampled_probe_thinning(self, tmp_path):
        n, seg = 120, 40
        with Network(seed=0) as net:
            inp = Node(TimeTable(_table(n)), label="drive")
            a = Ensemble(30, 1, neuron_type=LIFRate())
            Connection(inp, a, synapse=None)
            p = Probe(a, synapse=0.01, sample_every=0.01, label="thin")
        sim = Simulator(net, seed=0)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        sim.run_steps(n, segment_steps=seg)
        want = sim.data[p]

        m = ServingModel(str(tmp_path / "b"))
        np.testing.assert_array_equal(m.run(xs)["thin"], want)

    def test_midrun_export_keeps_sampling_grid(self, tmp_path):
        """A bundle exported at a non-period-aligned step continues the
        live Simulator's subsampled-probe grid (phase comes from the
        exported step counter, not zero)."""
        n, seg = 150, 30   # period 10; export at step 15 (mid-period)
        with Network(seed=0) as net:
            inp = Node(TimeTable(_table(n)), label="drive")
            a = Ensemble(30, 1, neuron_type=LIFRate())
            Connection(inp, a, synapse=None)
            p = Probe(a, synapse=0.01, sample_every=0.01, label="thin")
        sim = Simulator(net, seed=0)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        sim.run_steps(15, segment_steps=15)
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        # continue the live run with the SAME segment length the bundle
        # uses — different scan lengths fuse differently and drift 1 ulp
        sim.run_steps(120, segment_steps=seg)
        want = sim.data[p]          # rows at steps 10, 20, 30, ...

        m = ServingModel(str(tmp_path / "b"))
        assert m.n_steps == 15
        got = m.run(xs[15:15 + 120])["thin"]    # 4 whole segments
        np.testing.assert_array_equal(got, want[1:1 + got.shape[0]])
        # checkpoint swap-in restores the saved step counter too
        sim.save_checkpoint(str(tmp_path / "ckpt"))
        m.load_state(str(tmp_path / "ckpt"))
        assert m.n_steps == sim.n_steps

    def test_empty_table_keeps_probe_shape(self, tmp_path):
        n, seg = 40, 20
        sim, p, _ = _build(n)
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        m = ServingModel(str(tmp_path / "b"))
        out = m.run(np.zeros((0, m.input_width), np.float32))
        assert out["out_a"].shape == (0, 1)

    def test_duplicate_labels_stay_distinct(self, tmp_path):
        n, seg = 40, 20
        with Network(seed=0) as net:
            inp = Node(TimeTable(_table(n)), label="drive")
            a = Ensemble(20, 1, neuron_type=LIFRate())
            b = Ensemble(20, 1, neuron_type=LIFRate())
            Connection(inp, a, synapse=None)
            Connection(inp, b, transform=-1, synapse=None)
            pa = Probe(a, synapse=0.01, label="out")
            pb = Probe(b, synapse=0.01, label="out")
        sim = Simulator(net, seed=0)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        sim.run_steps(n, segment_steps=seg)
        m = ServingModel(str(tmp_path / "b"))
        out = m.run(xs)
        assert set(out) == {"out", "out_2"}
        np.testing.assert_array_equal(out["out"], sim.data[pa])
        np.testing.assert_array_equal(out["out_2"], sim.data[pb])


class TestShardedBundle:
    def test_mesh_bundle_roundtrip(self, tmp_path):
        """A bundle exported from a mesh-sharded Simulator records the mesh
        geometry + per-leaf PartitionSpecs; ServingModel rebuilds the mesh
        and serves the sharded program (multi-chip serving from one
        artifact)."""
        import jax
        from sspslam_tpu.parallel import make_mesh
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
        n, seg = 80, 40

        def build(mesh=None):
            with Network(seed=0) as net:
                inp = Node(TimeTable(_table(n)), label="drive")
                a = Ensemble(64, 1, neuron_type=LIFRate())
                Connection(inp, a, synapse=None)
                p = Probe(a, synapse=0.01, label="out")
            return Simulator(net, seed=0, mesh=mesh), p

        mesh = make_mesh(8)
        sim, p = build(mesh)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        meta = json.load(open(tmp_path / "b" / "meta.json"))
        assert meta["mesh"]["shape"] == [8]
        sim.run_steps(n, segment_steps=seg)
        want = sim.data[p]

        m = ServingModel(str(tmp_path / "b"))
        assert m.mesh is not None
        out = m.run(xs)["out"]
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)


    def test_mesh_bundle_rejects_too_few_devices(self, tmp_path):
        """Loading an 8-device bundle in a 1-device process must fail with
        a clear error, not a shape crash deep in XLA."""
        import jax
        from sspslam_tpu.parallel import make_mesh
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
        n, seg = 40, 20
        with Network(seed=0) as net:
            inp = Node(TimeTable(_table(n)), label="drive")
            a = Ensemble(64, 1, neuron_type=LIFRate())
            Connection(inp, a, synapse=None)
            Probe(a, synapse=0.01, label="out")
        sim = Simulator(net, seed=0, mesh=make_mesh(8))
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)

        script = f"""
import jax
jax.config.update("jax_platforms", "cpu")
from sspslam_tpu.nef.export import ServingModel
try:
    ServingModel({str(str(tmp_path / 'b'))!r})
except RuntimeError as e:
    assert "8 devices" in str(e) or "mesh" in str(e), e
    print("REJECTED_OK")
"""
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "REJECTED_OK" in r.stdout


class TestServingProcess:
    @pytest.mark.parametrize("vendored", [False, True])
    def test_loads_without_model_graph(self, tmp_path, vendored):
        """A fresh process loads the bundle and steps it WITHOUT ever
        constructing a Network / running the builder — the deployment
        contract.  ``vendored``: the process has no installed
        ``flatbuffers`` package, so (de)serialization runs on the copy in
        sspslam_tpu/_vendor."""
        n, seg = 80, 40
        sim, p, _ = _build(n)
        xs = sim._pack_cols(sim._tabulate_inputs(n))
        np.save(tmp_path / "xs.npy", xs)
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        sim.run_steps(n, segment_steps=seg)
        np.save(tmp_path / "want.npy", sim.data[p])

        hide = """
import importlib.abc, importlib.machinery, sys
class HideInstalled(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] != "flatbuffers":
            return None
        vendor = [p for p in sys.path if p.endswith("_vendor")]
        if not vendor:
            raise ModuleNotFoundError(name)
        return importlib.machinery.PathFinder.find_spec(name, path or vendor)
sys.meta_path.insert(0, HideInstalled())
""" if vendored else ""
        script = hide + f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from sspslam_tpu.nef.export import ServingModel
m = ServingModel({str(str(tmp_path / 'b'))!r})
xs = np.load({str(str(tmp_path / 'xs.npy'))!r})
out = m.run(xs)["out_a"]
np.testing.assert_array_equal(out, np.load({str(str(tmp_path / 'want.npy'))!r}))
again = jax.export.deserialize(m._exp.serialize())
assert again.mlir_module_serialized == m._exp.mlir_module_serialized
import flatbuffers
print("SERVED_OK", out.shape, flatbuffers.__file__)
"""
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "SERVED_OK" in r.stdout
        assert ("_vendor" in r.stdout) == vendored

    def test_meta_contents(self, tmp_path):
        n, seg = 40, 20
        sim, p, _ = _build(n)
        save_bundle(sim, str(tmp_path / "b"), segment_steps=seg)
        meta = json.load(open(tmp_path / "b" / "meta.json"))
        assert meta["segment_steps"] == seg
        assert meta["dt"] == pytest.approx(0.001)
        labels = [d["label"] for d in meta["inputs"]]
        assert "drive" in labels
        assert any(d["label"] == "out_a" for d in meta["probes"])
