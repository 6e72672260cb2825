"""The plain-jnp VCO bank step (parallel/shard_step.py) against the generic
engine: same solver pipeline, same update order."""

import numpy as np
import pytest

from sspslam_tpu import HexagonalSSPSpace
from sspslam_tpu.models import PathIntegration
from sspslam_tpu.nef import Connection, LIF, Network, Node, Probe, Simulator
from sspslam_tpu.parallel.shard_step import (vco_initial_state, vco_params,
                                             vco_reference_scan)


@pytest.fixture(scope="module")
def space():
    bounds = 1.1 * np.tile(np.array([-1, 1.0]), (2, 1))
    return HexagonalSSPSpace(2, ssp_dim=31, seed=0, length_scale=0.3,
                             domain_bounds=bounds)


class TestVCOReferenceScan:
    def test_matches_generic_engine(self, space):
        """Same parameters, same inputs: the (n, k)-layout VCO scan tracks
        the generic executor's PathIntegration output closely."""
        d = space.ssp_dim
        n_neurons = 48
        seed = 0
        T_steps = 300
        rng = np.random.default_rng(1)
        vels = (0.05 * rng.normal(size=(T_steps, 2))).astype(np.float32)
        ssp0 = space.encode(np.array([[0.15, -0.1]])).flatten()
        corr = np.zeros((T_steps, d), np.float32)
        corr[:49] = ssp0  # the initial clamp (t < 0.05, i.e. steps 1..49)

        with Network(seed=seed) as net:
            vel_n = Node(lambda t: vels[min(int(round((t - 0.001) / 0.001)),
                                            T_steps - 1)])
            init_n = Node(lambda t: ssp0 if t < 0.05 else np.zeros(d))
            pi = PathIntegration(space, n_neurons, 0.05, neuron_type=LIF())
            Connection(vel_n, pi.velocity_input, synapse=None)
            Connection(init_n, pi.input, synapse=None)
            p = Probe(pi.output, synapse=0.05)
        sim = Simulator(net, seed=seed)
        sim.run_steps(T_steps)
        generic = sim.data[p]

        params = vco_params(space, n_neurons, seed=seed)
        _, ref = vco_reference_scan(params, vco_initial_state(params), vels,
                                    corr)

        # identical parameter pipeline + identical update order -> outputs
        # agree to float accumulation tolerance
        err = np.max(np.abs(np.asarray(ref) - generic))
        assert err < 5e-3, err

    def test_integration_accuracy(self, space):
        """The VCO scan integrates a constant velocity correctly."""
        d = space.ssp_dim
        v = np.array([0.2, -0.1])
        scale = 1 / np.max(np.abs(space.phase_matrix @ v.reshape(2, 1)))
        T_steps = 800
        vels = np.tile(v * scale, (T_steps, 1)).astype(np.float32)
        ssp0 = space.encode(np.zeros((1, 2))).flatten()
        corr = np.zeros((T_steps, d), np.float32)
        corr[:50] = ssp0
        params = vco_params(space, 300, seed=3, scaling_factor=scale)
        _, out = vco_reference_scan(params, vco_initial_state(params), vels,
                                    corr)
        dec = space.decode(np.asarray(out)[-1][None, :], num_samples=50)
        target = v * T_steps * 0.001
        assert np.linalg.norm(dec - target) < 0.25
