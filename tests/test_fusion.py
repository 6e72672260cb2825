"""Builder-level ensemble fusion: same-shaped single ensembles execute as
ONE batched group (an op-count optimisation) with identical parameters
and near-identical trajectories to the unfused build."""

import numpy as np

from sspslam_tpu.nef import (Connection, Ensemble, LIFRate, Network, Neurons,
                             Node, Probe, Simulator)
from sspslam_tpu.nef.builder import build


def _three_chain(seed=3):
    """a -> b -> c chain of same-shaped ensembles + a neuron-inhibition
    connection into b (the SLAM error-population pattern)."""
    with Network(seed=seed) as net:
        inp = Node(lambda t: np.array([0.6 * np.sin(5 * t), -0.3]))
        gate = Node(lambda t: np.array([2.0]) if t > 0.2 else np.zeros(1))
        a = Ensemble(80, 2, neuron_type=LIFRate())
        b = Ensemble(80, 2, neuron_type=LIFRate())
        c = Ensemble(80, 2, neuron_type=LIFRate())
        Connection(inp, a, synapse=None)
        Connection(a, b, synapse=0.01)
        Connection(b, c, synapse=0.01)
        Connection(gate, b.neurons, transform=-3.0 * np.ones((80, 1)),
                   synapse=None)
        pa = Probe(a, synapse=0.02)
        pc = Probe(c, synapse=0.02)
        pn = Probe(Neurons(b), synapse=0.02)
    return net, (pa, pc, pn)


class TestEnsembleFusion:
    def test_fused_build_groups(self):
        net, _ = _three_chain()
        m_f = build(net, seed=3, fuse_ensembles=True)
        m_u = build(net, seed=3, fuse_ensembles=False)
        assert len(m_u.ensembles) == 3
        assert len(m_f.ensembles) == 1 and m_f.ensembles[0].k == 3
        # identical per-element parameters (same seeded draws)
        for j in range(3):
            assert np.allclose(m_f.ensembles[0].scaled_encoders[j],
                               m_u.ensembles[j].scaled_encoders)
            assert np.allclose(m_f.ensembles[0].bias[j],
                               m_u.ensembles[j].bias)

    def test_fused_matches_unfused_trajectories(self):
        net, (pa, pc, pn) = _three_chain()
        s1 = Simulator(net, seed=3)
        s1.run(0.4)
        y1 = {p: s1.data[p] for p in (pa, pc, pn)}
        assert any(be.batched and be.k == 3 for be in s1.model.ensembles)

        net2, (pa2, pc2, pn2) = _three_chain()
        s2 = Simulator(net2, seed=3, fuse_ensembles=False)
        s2.run(0.4)
        y2 = {p2: s2.data[p2] for p2 in (pa2, pc2, pn2)}
        assert all(not be.batched for be in s2.model.ensembles)

        for (p1, v1), (p2, v2) in zip(y1.items(), y2.items()):
            scale = max(np.abs(v2).max(), 1.0)
            assert np.max(np.abs(v1 - v2)) / scale < 2e-3, p1

    def test_instantaneous_loop_falls_back(self):
        """Two same-shaped ensembles wired in a synapse=None loop must not
        break the build — fusion detects the cycle and rebuilds unfused."""
        with Network(seed=0) as net:
            a = Ensemble(40, 1, neuron_type=LIFRate())
            b = Ensemble(40, 1, neuron_type=LIFRate())
            Connection(a, b, synapse=None)
            Connection(b, a, synapse=0.01)
            Probe(a)
        m = build(net, seed=0, fuse_ensembles=True)
        assert len(m.ensembles) == 2  # unfused fallback
