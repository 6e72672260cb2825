"""Multi-device tests on the virtual 8-CPU mesh: model-parallel sharded
simulation, batched data-parallel episodes, and checkpoint/resume."""

import numpy as np
import jax
import pytest

from sspslam_tpu import HexagonalSSPSpace
from sspslam_tpu.models import PathIntegration
from sspslam_tpu.nef import (Connection, Ensemble, LIFRate, Network, Node,
                             Probe, Simulator)
from sspslam_tpu.parallel import make_mesh, run_batched_episodes


def make_pi_net(space, seed=0, n_neurons=80):
    d = space.ssp_dim
    ssp0 = space.encode(np.array([[0.1, -0.2]])).flatten()
    with Network(seed=seed) as net:
        vel = Node(lambda t: np.array([0.1, 0.0]))
        init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
        pi = PathIntegration(space, n_neurons, 0.05, neuron_type=LIFRate())
        Connection(vel, pi.velocity_input, synapse=None)
        Connection(init, pi.input, synapse=None)
        p = Probe(pi.output, synapse=0.05)
    return net, p


@pytest.fixture(scope="module")
def space():
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    return HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                             domain_bounds=bounds)


class TestShardedSim:
    def test_mesh_sim_matches_single_device(self, space):
        net, p = make_pi_net(space, seed=0)
        sim1 = Simulator(net, seed=0)
        sim1.run(0.1)
        ref = sim1.data[p]

        net2, p2 = make_pi_net(space, seed=0)
        mesh = make_mesh(8)
        sim2 = Simulator(net2, seed=0, mesh=mesh)
        sim2.run(0.1)
        got = sim2.data[p2]
        assert np.allclose(ref, got, atol=5e-4)


class TestBatchedEpisodes:
    def test_three_channels(self):
        vals = np.array([[0.5], [-0.3], [0.1]])
        with Network(seed=1) as net:
            inp = Node(lambda t: np.zeros(1))
            ens = Ensemble(150, 1, neuron_type=LIFRate(), seed=1)
            out = Node(size_in=1)
            Connection(inp, ens, synapse=None)
            Connection(ens, out, synapse=0.02)
            p = Probe(out)
        sim = Simulator(net, seed=1)
        n_steps = 200
        tables = [np.tile(vals[:, None, :], (1, n_steps, 1))]
        res, _ = run_batched_episodes(sim, tables, n_steps)
        got = res[p][:, -50:].mean(axis=1)
        assert np.allclose(got, vals, atol=0.06)

    def test_batched_with_data_mesh(self, space):
        mesh = make_mesh(4, axis_names=("data",))
        with Network(seed=2) as net:
            inp = Node(lambda t: np.zeros(1))
            ens = Ensemble(100, 1, neuron_type=LIFRate(), seed=2)
            out = Node(size_in=1)
            Connection(inp, ens, synapse=None)
            Connection(ens, out, synapse=0.02)
            p = Probe(out)
        sim = Simulator(net, seed=2)
        vals = np.linspace(-0.6, 0.6, 4)[:, None]
        n_steps = 150
        tables = [np.tile(vals[:, None, :], (1, n_steps, 1))]
        res, _ = run_batched_episodes(sim, tables, n_steps, mesh=mesh,
                                      axis="data")
        got = res[p][:, -30:].mean(axis=1)[:, 0]
        assert np.allclose(got, vals[:, 0], atol=0.08)

    def test_batched_with_dp_tp_mesh(self, space):
        """dp x tp composition: 2-way episode batch x 4-way model shards in
        one program, matching the unsharded batched run."""
        mesh = make_mesh(8, axis_names=("data", "model"), shape=(2, 4))
        bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = HexagonalSSPSpace(2, ssp_dim=33, seed=0, length_scale=0.3,
                                  domain_bounds=bounds)  # 16 VCOs: 4-way TP
        net, p = make_pi_net(space, seed=5)
        sim = Simulator(net, seed=5)
        n_steps = 120
        cols = sim._tabulate_inputs(n_steps)
        tables = [np.broadcast_to(c, (2,) + c.shape).copy() for c in cols]
        res2d, _ = run_batched_episodes(sim, tables, n_steps, mesh=mesh)
        res1d, _ = run_batched_episodes(sim, tables, n_steps)
        a, b = np.asarray(res2d[p]), np.asarray(res1d[p])
        assert a.shape == b.shape == (2,) + np.asarray(res1d[p]).shape[1:]
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)


class TestCheckpoint:
    def test_save_resume_bitexact(self, space, tmp_path):
        net, p = make_pi_net(space, seed=3)
        sim = Simulator(net, seed=3)
        sim.run_steps(100, segment_steps=50)
        ck = str(tmp_path / "ck.npz")
        sim.save_checkpoint(ck)
        sim.run_steps(100, segment_steps=50)
        full = sim.data[p]

        net2, p2 = make_pi_net(space, seed=3)
        sim2 = Simulator(net2, seed=3)
        sim2.load_checkpoint(ck)
        sim2.run_steps(100, segment_steps=50)
        resumed = sim2.data[p2]
        assert np.array_equal(full[100:], resumed)


class TestShardMapVCO:
    def test_sharded_pi_matches_reference(self, space):
        """Explicit shard_map TP over the oscillator axis: identical output
        to the unsharded reference step (one psum per step)."""
        from sspslam_tpu.parallel.shard_step import (make_sharded_vco_scan,
                                                     vco_initial_state,
                                                     vco_params,
                                                     vco_reference_step)

        params = vco_params(space, 40, seed=0)
        T = 30
        rng = np.random.default_rng(0)
        vels = (0.03 * rng.normal(size=(T, 2))).astype(np.float32)
        corr = np.zeros((T, space.ssp_dim), np.float32)
        corr[0] = space.encode(np.array([[0.1, -0.1]])).flatten()

        mesh = make_mesh(8)
        run = make_sharded_vco_scan(params, mesh, T)
        state = run.initial_state()
        _, out = run(state, vels, corr)
        out = np.asarray(out)

        ref_state = vco_initial_state(params)
        ref = []
        for t in range(T):
            ref_state, y = vco_reference_step(params, ref_state,
                                              vels[t], corr[t])
            ref.append(np.asarray(y))
        ref = np.stack(ref)
        assert np.allclose(out, ref, atol=2e-4), np.abs(out - ref).max()


class TestSeedSweep:
    def test_sequential_sweep_shares_compilation(self, space):
        """Three seeds, one compiled program: results match per-sim runs."""
        from sspslam_tpu.parallel import run_seed_sweep

        sims, probes = [], []
        for seed in (0, 1, 2):
            net, p = make_pi_net(space, seed=seed)
            sims.append(Simulator(net, seed=seed))
            probes.append(p)
        results = run_seed_sweep(sims, 80, segment_steps=40)
        # independent single runs for comparison
        for seed, p in zip((0, 1, 2), probes):
            net2, p2 = make_pi_net(space, seed=seed)
            solo = Simulator(net2, seed=seed)
            solo.run_steps(80, segment_steps=40)
            want = solo.data[p2]
            got = results[seed][p]
            assert np.allclose(got, want, atol=1e-5), \
                np.abs(got - want).max()
        # different seeds genuinely differ
        assert not np.allclose(results[0][probes[0]], results[1][probes[1]],
                               atol=1e-3)


class TestMeshPadding:
    """pad_batched_to: phantom VCO rows / phantom neurons must leave the
    simulation bitwise identical to the unpadded build (their encoders and
    decoders are exact zeros and they never spike), while making every EA
    element axis and padded neuron axis divide the mesh."""

    def _slam_net(self, space, seed=0):
        import numpy as np
        from sspslam_tpu import SPSpace
        from sspslam_tpu.models import SLAMNetwork, get_slam_input_functions
        from sspslam_tpu.nef import Connection, Network, Node, Probe
        from sspslam_tpu.nef.processes import TimeTable
        dt = 0.001
        n_steps = 150
        ts = dt * np.arange(n_steps)
        path = 0.5 * np.stack([np.sin(2 * np.pi * ts / 0.15),
                               np.cos(2 * np.pi * ts / 0.15)], 1)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        rng = np.random.default_rng(seed)
        landmarks = rng.uniform(-0.3, 0.3, size=(2, 2))
        vec_to_lm = landmarks[None, :, :] - path[:, None, :]
        lm_space = SPSpace(2, space.ssp_dim, seed=seed)
        fns = get_slam_input_functions(space, lm_space, vels, vec_to_lm, 2.0)
        (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = fns
        with Network(seed=seed) as net:
            vel = Node(velocity_func)
            lm_id = Node(sp_f)
            lm_ssp = Node(vecssp_f)
            in_view = Node(in_view_f)
            # 61 neurons: indivisible by 8, forces n_pad on every ensemble
            slam = SLAMNetwork(space, lm_space, 2.0, 2, pi_n_neurons=61,
                               mem_n_neurons=77, circonv_n_neurons=26,
                               vel_scaling_factor=scale,
                               cleanup_samples_per_dim=10, seed=seed)
            Connection(vel, slam.velocity_input, synapse=None)
            Connection(lm_id, slam.landmark_id_input, synapse=None)
            Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
            Connection(in_view, slam.no_landmark_in_view, synapse=None)
            p_out = Probe(slam.pathintegrator.output, synapse=0.02)
            p_act = Probe(slam.assomemory.memory.neurons)
        return net, p_out, p_act, n_steps

    def test_padded_build_bitwise_identical(self, space):
        import numpy as np
        from sspslam_tpu.nef import Simulator
        from sspslam_tpu.nef.builder import build
        netA, pA, paA, n = self._slam_net(space)
        simA = Simulator(netA, seed=0)
        assert all(be.n_pad == 0 for be in simA.model.ensembles)
        simA.run_steps(n, segment_steps=n)

        netB, pB, paB, _ = self._slam_net(space)
        # padded build WITHOUT a mesh: exercises the phantom rows on the
        # ordinary single-device path
        simB = Simulator.__new__(Simulator)
        Simulator.__init__(simB, netB, seed=0)
        simB.model = build(netB, dt=0.001, seed=0, pad_batched_to=8)
        from sspslam_tpu.nef.executor import build_params, make_step_fn
        import jax
        simB._step_fn = make_step_fn(simB.model)
        simB.params = jax.device_put(build_params(simB.model))
        simB._scan_cache = {}
        simB.state = simB.model.initial_state()
        simB._probe_data = {bp.index: [] for bp in simB.model.probes}
        simB._sparse_steps = {bp.index: [] for bp in simB.model.probes}
        assert any(be.n_pad > 0 for be in simB.model.ensembles)
        from sspslam_tpu.nef.graph import EnsembleArray
        for be in simB.model.ensembles:
            obj = be.obj[0] if isinstance(be.obj, tuple) else be.obj
            if isinstance(obj, EnsembleArray):
                assert be.k % 8 == 0, (be.k, be.n)   # EAs shard over k
            else:
                assert be.n % 8 == 0, (be.k, be.n)   # singles over neurons
        simB.run_steps(n, segment_steps=n)

        outA = np.asarray(simA.data[pA])
        outB = np.asarray(simB.data[pB])
        assert np.array_equal(outA, outB), np.max(np.abs(outA - outB))
        # activity probes report the LOGICAL neuron count
        actA = np.asarray(simA.data[paA])
        actB = np.asarray(simB.data[paB])
        assert actA.shape == actB.shape == (n, 77)
        assert np.array_equal(actA, actB)


class TestParamsShardings:
    """Model-aware parameter-bank shardings (round 5): the large static
    banks shard along the same axis the owning ensemble's carry shards
    over — this is what makes TP divide the parameter-read HBM bytes
    that bind single-chip throughput at d>=385 (docs/MULTICHIP.md)."""

    def _build(self, space, matmul_dtype=None):
        net, p = make_pi_net(space, seed=0)
        mesh = make_mesh(4)
        sim = Simulator(net, seed=0, mesh=mesh, matmul_dtype=matmul_dtype)
        from sspslam_tpu.parallel.sharding import params_shardings
        sh = params_shardings(sim.params, mesh, model=sim.model)
        return sim, sh

    def test_vco_bank_shards_element_axis(self, space):
        sim, sh = self._build(space)
        # the VCO bank is batched with k padded to a mesh multiple: its
        # encoders must shard the leading (element) axis
        from jax.sharding import PartitionSpec as P
        found = False
        for i, be in enumerate(sim.model.ensembles):
            if be.batched and be.k % 4 == 0:
                spec = sh["ens"][i]["scaled_encoders"].spec
                assert spec == P("model", None, None), spec
                found = True
        assert found, "no shardable batched bank in the PI model"

    def test_member_slice_decoders_replicate(self, space):
        sim, sh = self._build(space)
        from jax.sharding import PartitionSpec as P
        import numpy as np_
        for bc in sim.model.connections:
            entry = sim.params["conn"].get(str(bc.index), {})
            D = entry.get("D")
            if D is None or bc.learned_slot is not None:
                continue
            spec = sh["conn"][str(bc.index)]["D"].spec
            shape = D.q.shape if hasattr(D, "q") else np_.shape(D)
            for ax, name in enumerate(spec):
                if name is not None:
                    # any sharded axis must actually divide
                    assert shape[ax] % 4 == 0, (shape, spec)

    def test_quantized_banks_shard_payload_and_scale(self):
        # a model whose contracted axes clear the quantization floor:
        # 64-neuron, 40-dim ensemble -> encoders (64, 40) contract 40
        # (shard the neuron rows), decoders (64, 40) contract 64 (the
        # shard axis IS the contracted one -> payload shards, the
        # per-slice scale replicates)
        from jax.sharding import PartitionSpec as P
        from sspslam_tpu.ops.quantize import QTensor
        with Network(seed=0) as net:
            src = Node(lambda t: np.zeros(40))
            ens = Ensemble(64, 40, neuron_type=LIFRate())
            out = Node(size_in=40)
            Connection(src, ens, synapse=None)
            Connection(ens, out, synapse=0.01)
        mesh = make_mesh(4)
        sim = Simulator(net, seed=0, mesh=mesh, matmul_dtype="int8")
        from sspslam_tpu.parallel.sharding import params_shardings
        sh = params_shardings(sim.params, mesh, model=sim.model)
        (i,) = [i for i, be in enumerate(sim.model.ensembles)]
        enc, enc_sh = (sim.params["ens"][i]["scaled_encoders"],
                       sh["ens"][i]["scaled_encoders"])
        assert isinstance(enc, QTensor) and isinstance(enc_sh, QTensor)
        assert enc_sh.q.spec == P("model", None)
        assert enc_sh.s.spec == P("model")
        d_entries = [(sim.params["conn"][k]["D"], sh["conn"][k]["D"])
                     for k in sim.params["conn"]
                     if "D" in sim.params["conn"][k]]
        assert d_entries
        for d_p, d_sh in d_entries:
            assert isinstance(d_p, QTensor) and isinstance(d_sh, QTensor)
            assert d_sh.q.spec == P("model", None)
            assert d_sh.s.spec == P()   # scale has no neuron axis left

    def test_sharded_quantized_run_matches_unsharded(self, space):
        net, p = make_pi_net(space, seed=0)
        sim1 = Simulator(net, seed=0, matmul_dtype="int8")
        sim1.run(0.1)
        ref = sim1.data[p]
        net2, p2 = make_pi_net(space, seed=0)
        sim2 = Simulator(net2, seed=0, mesh=make_mesh(4),
                         matmul_dtype="int8")
        sim2.run(0.1)
        assert np.allclose(ref, sim2.data[p2], atol=5e-4)


class TestAnchoredGateUnderMesh:
    """The stateful auto-recovery gate node — including the round-5
    absolute-anchor beacon channels — must ride the mesh-sharded step:
    the gate's scalar state vector and the three beacon input nodes are
    the one part of the scaled/kidnap configuration nothing else
    exercises multi-device.  Pins mesh-vs-single-device probe parity for
    SLAMNetwork(gate_mode='auto_recovery', anchor=True)."""

    def _build(self, space, mesh=None):
        from sspslam_tpu import SPSpace
        from sspslam_tpu.models import (SLAMNetwork,
                                        get_anchor_input_functions,
                                        get_slam_input_functions)
        d = space.ssp_dim
        T, dt = 0.2, 0.001
        n_steps = int(T / dt)
        ts = dt * np.arange(n_steps)
        path = 0.4 * np.stack([np.sin(2 * np.pi * ts / T),
                               np.cos(2 * np.pi * ts / T)], axis=1)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        landmarks = np.array([[0.2, 0.1], [-0.3, 0.3], [0.1, -0.4]])
        vec_to_lm = landmarks[None, :, :] - path[:, None, :]
        lm_space = SPSpace(3, d, seed=0)
        (vel_f, scale, in_view_f, _, sp_f, _, vecssp_f) = \
            get_slam_input_functions(space, lm_space, vels, vec_to_lm, 0.8)
        pos_f, vec_f, iv_f = get_anchor_input_functions(
            space, vec_to_lm, np.array([0, 1]), landmarks[:2], 0.8, dt=dt)
        ssp0 = space.encode(path[:1]).flatten()
        with Network(seed=0) as net:
            vel = Node(vel_f)
            init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
            lm_id = Node(sp_f)
            lm_ssp = Node(vecssp_f)
            in_view = Node(in_view_f)
            anc_pos, anc_vec, anc_iv = Node(pos_f), Node(vec_f), Node(iv_f)
            slam = SLAMNetwork(space, lm_space, 0.8, 3,
                               pi_n_neurons=64, mem_n_neurons=80,
                               circonv_n_neurons=24,
                               vel_scaling_factor=scale,
                               cleanup_samples_per_dim=10, seed=0,
                               gate_mode="auto_recovery", anchor=True,
                               gate_kwargs={"anchor_trigger": 0.3})
            Connection(vel, slam.velocity_input, synapse=None)
            Connection(init, slam.pathintegrator.input, synapse=None)
            Connection(lm_id, slam.landmark_id_input, synapse=None)
            Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
            Connection(in_view, slam.no_landmark_in_view, synapse=None)
            Connection(anc_pos, slam.anchor_pos_input, synapse=None)
            Connection(anc_vec, slam.anchor_vec_ssp, synapse=None)
            Connection(anc_iv, slam.no_anchor_in_view, synapse=None)
            p = Probe(slam.pathintegrator.output, synapse=0.05)
        from sspslam_tpu.nef import LIFRate
        sim = Simulator(net, seed=0, mesh=mesh,
                        default_neuron_type=LIFRate())
        return sim, p, T

    def test_mesh_matches_single_device(self, space):
        sim1, p1, T = self._build(space)
        sim1.run(T)
        ref = sim1.data[p1]
        sim2, p2, _ = self._build(space, mesh=make_mesh(8))
        sim2.run(T)
        got = sim2.data[p2]
        assert ref.shape == got.shape
        assert np.all(np.isfinite(got))
        assert np.allclose(ref, got, atol=5e-4)
