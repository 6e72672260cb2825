"""Fully-neural gated SLAM (the reference's Loihi-compatible rewrite).

Capability parity with reference slam_loihi.py:10-298 (``SLAMLoihiNetwork``):
no Voja (fixed encoders sampled from the landmark SPs), an inline PES memory,
no clean-up, an explicit ``correction`` ensemble (position estimate minus PI
output, fed back through a long 0.1 s synapse), and a neural gate — a
``threshold`` population with intercept ``update_thres`` driven by a neural
dot product built from two squaring ensemble arrays, inhibiting the
correction population.

The reference needed this variant because Loihi cannot run host nodes; in
a compiled step the gate maths could be a jnp node (see SLAMNetwork), but
the all-neural
version is retained as a model family: it is the configuration whose
dynamics were validated on neuromorphic hardware.
"""

from __future__ import annotations

import numpy as np

from ..nef import (Choice, Connection, Ensemble, EnsembleArray, Network,
                   Node, PES)
from .binding import CircularConvolution
from .pathintegration import PathIntegration

__all__ = ["SLAMGatedNetwork", "SLAMLoihiNetwork"]


class SLAMGatedNetwork(Network):
    def __init__(self, ssp_space, lm_space, view_rad, n_landmarks,
                 pi_n_neurons, mem_n_neurons, circonv_n_neurons,
                 dotprod_n_neurons,
                 velocity_input=None, landmark_vecssp_input=None,
                 landmark_sp_input=None, no_landmark_in_view=None,
                 tau=0.01, tau_pi=0.05,
                 update_thres=0.2, vel_scaling_factor=1.0,
                 rad_scaling_factor=1, shift_rate=0.1,
                 pes_learning_rate=1e-2, encoders=None,
                 pi_solver_weights=False, seed=0, label="slamgated",
                 gate_semantics="loihi"):
        super().__init__(label=label, seed=seed)

        d = ssp_space.ssp_dim
        domain_dim = ssp_space.domain_dim

        landmark_sps = lm_space.vectors
        rng = np.random.RandomState(seed=seed)
        if encoders is None:
            encoders = landmark_sps[rng.randint(n_landmarks, size=mem_n_neurons), :]
        intercept = (landmark_sps @ landmark_sps.T - np.eye(n_landmarks)).max()

        with self:
            self.velocity_input = (Node(size_in=domain_dim, label="vel_input")
                                   if velocity_input is None else velocity_input)
            self.landmark_vecssp_input = (
                Node(size_in=d, label="lm_vecssp_input")
                if landmark_vecssp_input is None else landmark_vecssp_input)
            self.landmark_sp_input = (
                Node(size_in=d, label="lm_sp_input")
                if landmark_sp_input is None else landmark_sp_input)
            self.no_landmark_in_view = (
                Node(size_in=1, label="lm_in_view_input")
                if no_landmark_in_view is None else no_landmark_in_view)

            # path integrator
            self.pathintegrator = PathIntegration(
                ssp_space, pi_n_neurons, tau_pi,
                max_radius=rad_scaling_factor,
                scaling_factor=vel_scaling_factor, stable=True,
                with_gcs=False, solver_weights=pi_solver_weights,
                label="pathint")
            Connection(self.velocity_input, self.pathintegrator.velocity_input,
                       synapse=None)
            self.output = self.pathintegrator.output

            # landmark perception: bind PI output with the egocentric SSP
            self.landmark_ssp_ens = CircularConvolution(
                circonv_n_neurons, dimensions=d, label="landmark_circonv")
            Connection(self.pathintegrator.output,
                       self.landmark_ssp_ens.input_a, synapse=tau)
            Connection(self.landmark_vecssp_input,
                       self.landmark_ssp_ens.input_b, synapse=0)

            # inline PES associative memory (fixed encoders, no Voja)
            self.assomemory = Network(label="assomem")
            with self.assomemory:
                self.assomemory.memory = Ensemble(
                    mem_n_neurons, d, intercepts=float(intercept),
                    encoders=encoders, radius=1, label="memory")
                self.assomemory.recall = Ensemble(mem_n_neurons, d,
                                                  label="memory_recall")
            Connection(self.landmark_sp_input, self.assomemory.memory,
                       synapse=None, label="map_conn_in")
            self.assomemory.conn_out = Connection(
                self.assomemory.memory, self.assomemory.recall,
                learning_rule_type=PES(pes_learning_rate),
                function=lambda x: np.zeros(d), label="map_conn_pes")

            mem_error = Ensemble(mem_n_neurons, d, label="memory_pes_error")
            Connection(self.no_landmark_in_view, mem_error.neurons,
                       transform=-2.5 * np.ones((mem_n_neurons, 1)),
                       synapse=None)
            Connection(self.landmark_ssp_ens.output, mem_error, transform=-1,
                       synapse=tau)
            Connection(self.assomemory.recall, mem_error, synapse=tau)
            Connection(mem_error, self.assomemory.conn_out.learning_rule,
                       synapse=tau)

            # position estimate: unbind recall by the egocentric SSP
            self.position_estimate = CircularConvolution(
                circonv_n_neurons, d, input_magnitude=1, invert_a=True,
                label="newpos_circonv")
            Connection(self.landmark_vecssp_input,
                       self.position_estimate.input_a, synapse=None)
            Connection(self.assomemory.recall, self.position_estimate.input_b,
                       synapse=tau)

            # correction = estimate - PI, through a long feedback synapse
            self.correction = Ensemble(mem_n_neurons, d, label="correction_ens")
            Connection(self.position_estimate.output, self.correction,
                       synapse=tau, transform=1)
            Connection(self.pathintegrator.output, self.correction,
                       synapse=tau, transform=-1)
            Connection(self.correction, self.pathintegrator.input,
                       synapse=0.1, transform=shift_rate)

            # neural gate: threshold population fed a neural dot product.
            # The threshold represents (1 + no_view - dot(est, PI)) and
            # inhibits the correction when it exceeds its intercept:
            #  * 'loihi' (faithful to the reference wiring,
            #    slam_loihi.py:268-274): intercept = update_thres, so
            #    corrections only engage when dot > 1 - update_thres — a far
            #    stricter gate than SLAMNetwork's.
            #  * 'matched': intercept = 1 - update_thres, reproducing
            #    SLAMNetwork's engage-when-dot > update_thres semantics.
            gate_intercept = (update_thres if gate_semantics == "loihi"
                              else 1.0 - update_thres)
            bias = Node(1.0, label="threshold_bias")
            self.threshold = Ensemble(
                circonv_n_neurons, 1, intercepts=Choice([gate_intercept]),
                encoders=np.ones((circonv_n_neurons, 1)), label="threshold")
            Connection(bias, self.threshold, synapse=None)
            Connection(self.no_landmark_in_view, self.threshold, synapse=None)
            Connection(self.threshold, self.correction.neurons,
                       transform=-5.0 * np.ones((mem_n_neurons, 1)),
                       synapse=0.05)

            # dot(estimate, PI) via the Gosmann squaring decomposition,
            # signs flipped so the gate *inhibits* when similarity is low
            sq1 = EnsembleArray(max(1, dotprod_n_neurons // 2), d,
                                ens_dimensions=1, radius=np.sqrt(2),
                                label="dotprod_sq1")
            sq2 = EnsembleArray(max(1, dotprod_n_neurons // 2), d,
                                ens_dimensions=1, radius=np.sqrt(2),
                                label="dotprod_sq2")
            tr = 1.0 / np.sqrt(2.0)
            Connection(self.position_estimate.output, sq1.input, transform=tr,
                       synapse=tau)
            Connection(self.pathintegrator.output, sq1.input, transform=tr,
                       synapse=tau)
            Connection(self.position_estimate.output, sq2.input, transform=tr,
                       synapse=tau)
            Connection(self.pathintegrator.output, sq2.input, transform=-tr,
                       synapse=tau)
            sq1_out = sq1.add_output("negsquare", lambda x: -0.5 * x**2)
            sq2_out = sq2.add_output("possquare", lambda x: 0.5 * x**2)
            Connection(sq1_out, self.threshold,
                       transform=np.ones((1, d)), synapse=tau)
            Connection(sq2_out, self.threshold,
                       transform=np.ones((1, d)), synapse=tau)


# historical alias matching the reference class name
SLAMLoihiNetwork = SLAMGatedNetwork
