"""Compiled-vs-interpreted backend cross-check — the analogue of the
reference's cpu-vs-ocl validation (SURVEY.md §4): the jitted lax.scan
executor and the NumPy per-step interpreter must agree on the same built
model to float32 tolerance."""

import numpy as np

from sspslam_tpu import HexagonalSSPSpace
from sspslam_tpu.models import PathIntegration
from sspslam_tpu.nef import (Connection, Ensemble, LIF, LIFRate, Network,
                             Node, PES, Probe, Simulator)
from sspslam_tpu.nef.reference_backend import (NumpyStepper,
                                             cross_check as _cross_check)


def cross_check(net, T=0.2, seed=0, atol=1e-3, spike_flip_tolerant=False):
    sim = Simulator(net, seed=seed)
    _cross_check(sim, int(T / sim.dt), atol=atol,
                 spike_flip_tolerant=spike_flip_tolerant)


class TestBackendCrossCheck:
    def test_stateful_latch_node(self):
        """Stateful jnp node (state_init attribute): the node's state is a
        carry leaf; jit scan and the host interpreter agree on a running-
        max latch."""
        import jax.numpy as jnp

        def latch(t, x, s, consts=None):
            ns = jnp.maximum(s, x)
            return ns, ns
        latch.state_init = np.zeros(2, np.float32)

        def latch_np(t, x, s, consts=None):
            ns = np.maximum(s, x)
            return ns, ns
        latch.np_function = latch_np

        with Network(seed=0) as net:
            inp = Node(lambda t: np.array([np.sin(7 * t), np.cos(5 * t)]))
            n = Node(latch, size_in=2, size_out=2)
            Connection(inp, n, synapse=None)
            out = Node(size_in=2)
            Connection(n, out, synapse=0.02)
            Probe(out, synapse=None)
        cross_check(net, T=0.25, seed=0, atol=1e-5)
        # and the latch actually latched: final probe row equals the
        # running max, which is nondecreasing
        sim = Simulator(net, seed=0)
        sim.run_steps(250)
        v = np.asarray(sim.state["nodes"]["ns0"])
        assert v.shape == (2,) and (v > 0.9).all()

    def test_channel_with_learning(self):
        val = np.array([0.5, -0.2])
        with Network(seed=0) as net:
            inp = Node(lambda t: val)
            ens = Ensemble(120, 2, neuron_type=LIFRate(), seed=0)
            out = Node(size_in=2)
            Connection(inp, ens, synapse=None)
            c = Connection(ens, out, function=lambda x: np.zeros(2),
                           learning_rule_type=PES(1e-3), synapse=0.02)
            err = Node(size_in=2)
            Connection(out, err, synapse=0.02)
            Connection(inp, err, transform=-1.0, synapse=0.02)
            Connection(err, c.learning_rule, synapse=0.02)
            p = Probe(out, synapse=0.02)
        cross_check(net, T=0.3, seed=0)

    def test_spiking_pathintegration(self):
        bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                                  domain_bounds=bounds)
        d = space.ssp_dim
        ssp0 = space.encode(np.array([[0.1, -0.1]])).flatten()
        with Network(seed=1) as net:
            vel = Node(lambda t: np.array([0.1, 0.05]))
            init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
            pi = PathIntegration(space, 60, 0.05, neuron_type=LIF())
            Connection(vel, pi.velocity_input, synapse=None)
            Connection(init, pi.input, synapse=None)
            p = Probe(pi.output, synapse=0.05)
        cross_check(net, T=0.15, seed=1, atol=5e-3)

    def test_voja_associative_memory(self):
        """Voja encoder learning (post-synapse-filtered activities) agrees
        between the compiled scan and the interpreter."""
        from sspslam_tpu.models import AssociativeMemory
        rng = np.random.default_rng(3)
        keys = rng.standard_normal((2, 4))
        keys /= np.linalg.norm(keys, axis=1, keepdims=True)
        vals = rng.standard_normal((2, 3)) * 0.5
        with Network(seed=2) as net:
            key_in = Node(lambda t: keys[int(t > 0.1)])
            val_in = Node(lambda t: vals[int(t > 0.1)])
            learn = Node(lambda t: np.zeros(1))  # 0 = learning on
            am = AssociativeMemory(80, 4, 3, intercept=0.1,
                                   neuron_type=LIFRate(), seed=2)
            Connection(key_in, am.key_input, synapse=None)
            Connection(val_in, am.value_input, synapse=None)
            Connection(learn, am.learning, synapse=None)
            p = Probe(am.recall, synapse=0.02)
        cross_check(net, T=0.25, seed=2, atol=2e-3)

    def test_alpha_synapse(self):
        from sspslam_tpu.nef import Alpha
        with Network(seed=0) as net:
            inp = Node(lambda t: np.array([np.sin(8 * t)]))
            ens = Ensemble(60, 1, neuron_type=LIFRate(), seed=0)
            out = Node(size_in=1)
            Connection(inp, ens, synapse=Alpha(0.01))
            Connection(ens, out, synapse=Alpha(0.02))
            p = Probe(out, synapse=None)
        cross_check(net, T=0.2, seed=0)

    def test_quantized_lif(self):
        from sspslam_tpu.ops.neurons import QuantizedLIF
        with Network(seed=4) as net:
            inp = Node(lambda t: np.array([0.4, -0.3]))
            ens = Ensemble(90, 2, neuron_type=QuantizedLIF(), seed=4)
            p = Probe(ens, synapse=0.03)
        # note: missing input connection would leave ens at bias only
        with net:
            Connection(inp, ens, synapse=None)
        cross_check(net, T=0.15, seed=4, atol=5e-3)

    def test_solver_weights(self):
        with Network(seed=5) as net:
            inp = Node(lambda t: np.array([0.5, 0.1]))
            a = Ensemble(70, 2, neuron_type=LIFRate(), seed=5)
            b = Ensemble(70, 2, neuron_type=LIFRate(), seed=6)
            Connection(inp, a, synapse=None)
            Connection(a, b, synapse=0.01, solver_weights=True)
            p = Probe(b, synapse=0.02)
        cross_check(net, T=0.15, seed=5)


class TestLongHorizonDrift:
    def test_20k_step_rate_pi_bounded_drift(self):
        """20k-step (20 s) LIFRate path-integrator run: compiled scan vs
        interpreter must stay within a small relative envelope over the full
        horizon — guards against accumulating float-order drift in the
        recurrent dynamics (the reference's T=200 s default is 10x this;
        drift here is the leading indicator)."""
        bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = HexagonalSSPSpace(2, ssp_dim=13, seed=0, length_scale=0.3,
                                  domain_bounds=bounds)
        d = space.ssp_dim
        ssp0 = space.encode(np.array([[0.0, 0.0]])).flatten()
        with Network(seed=6) as net:
            vel = Node(lambda t: 0.08 * np.array([np.cos(0.7 * t),
                                                  np.sin(0.9 * t)]))
            init = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
            pi = PathIntegration(space, 40, 0.05, neuron_type=LIFRate())
            Connection(vel, pi.velocity_input, synapse=None)
            Connection(init, pi.input, synapse=None)
            p = Probe(pi.output, synapse=0.05)
        sim = Simulator(net, seed=6)
        n_steps = 20000
        inputs = sim._tabulate_inputs(n_steps)
        ref = NumpyStepper(sim.model)
        ref_out = ref.run_steps(n_steps, [np.asarray(c) for c in inputs])
        sim.run_steps(n_steps)
        bp = sim.model.probes[0]
        jit_v = np.concatenate(
            [np.asarray(c) for c in sim._probe_data[bp.index]], axis=0)
        err = np.abs(jit_v - ref_out[bp.index]).max(axis=1)
        scale = max(np.abs(ref_out[bp.index]).max(), 1.0)
        # drift must stay bounded across the whole horizon, not just the end
        assert err.max() / scale < 2e-2, f"max drift {err.max()/scale}"
        assert err[-1] / scale < 2e-2


class TestFullSLAMCrossCheck:
    """Full SLAMNetwork (cleanup node + gate + Voja/PES memory + circonv)
    interpreter-vs-jit agreement.  Exercises the host-only np_function
    mirrors of the jnp node functions: a divergence between a mirror and
    its jnp original shows up here as a backend mismatch."""

    def test_slam_model(self, monkeypatch):
        monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
        from sspslam_tpu import SPSpace
        from sspslam_tpu.models import SLAMNetwork, get_slam_input_functions
        T, dt, seed = 0.15, 0.001, 0
        bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = HexagonalSSPSpace(2, ssp_dim=31, seed=seed, length_scale=0.3,
                                  domain_bounds=bounds)
        d = space.ssp_dim
        # deterministic MOVING path: a 0.15 s WhiteSignal(high=2.0) has no
        # frequency bin under its cutoff and is identically zero, which
        # made the velocity/VCO path dead (NaN-scaled, squashed by LIF)
        # and the cross-check vacuous
        ts = dt * np.arange(int(T / dt))
        path = 0.25 * np.stack([np.sin(2 * np.pi * ts / T),
                                np.cos(2 * np.pi * ts / T) - 1.0], axis=1)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        assert np.abs(vels).max() > 0
        rng = np.random.default_rng(seed)
        landmarks = rng.uniform(-0.3, 0.3, size=(2, 2))
        vec_to_lm = landmarks[None, :, :] - path[:, None, :]
        lm_space = SPSpace(2, d, seed=seed)
        (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
            get_slam_input_functions(space, lm_space, vels, vec_to_lm, 2.0)
        with Network(seed=seed) as net:
            vel = Node(velocity_func)
            lm_id = Node(sp_f)
            lm_ssp = Node(vecssp_f)
            in_view = Node(in_view_f)
            slam = SLAMNetwork(space, lm_space, 2.0, 2,
                               pi_n_neurons=60, mem_n_neurons=80,
                               circonv_n_neurons=30,
                               vel_scaling_factor=scale,
                               cleanup_samples_per_dim=10, seed=seed)
            Connection(vel, slam.velocity_input, synapse=None)
            Connection(lm_id, slam.landmark_id_input, synapse=None)
            Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
            Connection(in_view, slam.no_landmark_in_view, synapse=None)
            Probe(slam.pathintegrator.output, synapse=0.02)
            Probe(slam.assomemory.recall, synapse=0.02)
        cross_check(net, T=T, seed=seed, atol=1e-3, spike_flip_tolerant=True)

    def test_slam_auto_recovery_gate(self, monkeypatch):
        """gate_mode='auto_recovery': the stateful in-model controller
        (latch + EMA + timer, hoisted thresholds) agrees between the jit
        scan and the host interpreter, including its node-state leaf."""
        monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
        from sspslam_tpu import SPSpace
        from sspslam_tpu.models import SLAMNetwork, get_slam_input_functions
        T, dt, seed = 0.15, 0.001, 0
        bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = HexagonalSSPSpace(2, ssp_dim=31, seed=seed, length_scale=0.3,
                                  domain_bounds=bounds)
        d = space.ssp_dim
        ts = dt * np.arange(int(T / dt))
        path = 0.25 * np.stack([np.sin(2 * np.pi * ts / T),
                                np.cos(2 * np.pi * ts / T) - 1.0], axis=1)
        vels = (1 / dt) * np.diff(path, axis=0, prepend=path[:1])
        rng = np.random.default_rng(seed)
        landmarks = rng.uniform(-0.3, 0.3, size=(2, 2))
        vec_to_lm = landmarks[None, :, :] - path[:, None, :]
        lm_space = SPSpace(2, d, seed=seed)
        (velocity_func, scale, in_view_f, _, sp_f, _, vecssp_f) = \
            get_slam_input_functions(space, lm_space, vels, vec_to_lm, 2.0)
        with Network(seed=seed) as net:
            vel = Node(velocity_func)
            lm_id = Node(sp_f)
            lm_ssp = Node(vecssp_f)
            in_view = Node(in_view_f)
            slam = SLAMNetwork(space, lm_space, 2.0, 2,
                               pi_n_neurons=60, mem_n_neurons=80,
                               circonv_n_neurons=30,
                               vel_scaling_factor=scale,
                               cleanup_samples_per_dim=10, seed=seed,
                               gate_mode="auto_recovery",
                               gate_kwargs={"familiar": 0.05,
                                            "exit_thres": 0.3})
            Connection(vel, slam.velocity_input, synapse=None)
            Connection(lm_id, slam.landmark_id_input, synapse=None)
            Connection(lm_ssp, slam.landmark_vec_ssp, synapse=None)
            Connection(in_view, slam.no_landmark_in_view, synapse=None)
            Probe(slam.pathintegrator.output, synapse=0.02)
            Probe(slam.update_state, synapse=None)
        cross_check(net, T=T, seed=seed, atol=1e-3, spike_flip_tolerant=True)
        sim = Simulator(net, seed=seed)
        sim.run_steps(int(T / dt))
        (slot,) = sim.state["nodes"]
        armed, ema, timer, cons_ema = np.asarray(sim.state["nodes"][slot])
        assert timer >= 0 and np.isfinite(ema) and -1.01 <= cons_ema <= 1.01

    def test_np_mirrors_registered(self):
        """The SLAM model's jnp node functions all carry host mirrors."""
        from sspslam_tpu import SPSpace
        from sspslam_tpu.models import SLAMNetwork
        bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
        space = HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                                  domain_bounds=bounds)
        lm_space = SPSpace(2, space.ssp_dim, seed=0)
        with Network(seed=0) as net:
            slam = SLAMNetwork(space, lm_space, 0.6, 2,
                               pi_n_neurons=50, mem_n_neurons=60,
                               circonv_n_neurons=20,
                               cleanup_samples_per_dim=10, seed=0)
        sim = Simulator(net, seed=0)
        jnp_nodes = [info for info in sim.model.node_info.values()
                     if info["kind"] == "jnp_func"]
        assert jnp_nodes, "expected jnp node functions in the SLAM model"
        assert all(info.get("np_func") is not None for info in jnp_nodes)

    def test_gate_np_mirror_honors_hoisted_consts(self, monkeypatch):
        """Under SSPSLAM_HOIST_GATE the numpy mirror must apply the SAME
        (possibly rewritten) consts as the traced gate — a swept
        shift_rate/update_thres otherwise silently diverges between the
        interpreter and the jit path."""
        monkeypatch.setenv("SSPSLAM_HOIST_GATE", "1")
        import jax.numpy as jnp
        from sspslam_tpu.models.slam import make_update_state_func
        d = 3
        f = make_update_state_func(0.9, 0.1, d)   # baked: gate CLOSED
        assert f.hoisted_consts is not None
        v = np.full(d, 0.5, np.float32)
        x = np.concatenate([v, 0.9 * v, [0.0]]).astype(np.float32)
        # dot = 0.675: swept consts OPEN the gate with a new rate
        consts = {"update_thres": np.float32(0.5),
                  "shift_rate": np.float32(0.7)}
        jit_out = np.asarray(f(0.0, jnp.asarray(x), consts=consts))
        np_out = np.asarray(f.np_function(0.0, x, consts=consts))
        assert np.abs(jit_out).max() > 0, "swept consts should open the gate"
        np.testing.assert_allclose(np_out, jit_out, rtol=1e-6)
        # without consts both fall back to the baked (closed) gate
        assert np.all(np.asarray(f(0.0, jnp.asarray(x))) == 0)
        assert np.all(np.asarray(f.np_function(0.0, x)) == 0)

    def test_hoisted_gate_cross_check(self, monkeypatch):
        """End-to-end: interpreter (which prefers np mirrors) agrees with
        the jit path when the gate consts are hoisted to traced params."""
        monkeypatch.setenv("SSPSLAM_HOIST_GATE", "1")
        monkeypatch.setenv("SSPSLAM_CLEANUP_F32", "1")
        from sspslam_tpu.models.slam import make_update_state_func
        d = 4
        f = make_update_state_func(-1.0, 0.3, d)   # always open
        rng = np.random.default_rng(0)
        rows = rng.normal(size=(60, 2 * d + 1)).astype(np.float32)
        from sspslam_tpu.nef import TimeTable
        with Network(seed=0) as net:
            drive = Node(TimeTable(rows))
            gate = Node(f, size_in=2 * d + 1, size_out=d)
            Connection(drive, gate, synapse=None)
            Probe(gate, synapse=None)
        cross_check(net, T=0.06, seed=0, atol=1e-5)
