"""Full SSP-SLAM CLI — parity with reference experiments/run_slam.py
(flags, metrics, learned-map extraction, npz schema), on the compiled
XLA backend.  backend=gated builds the all-neural SLAMGatedNetwork
(the reference's Loihi-compatible model family)."""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from experiments.common import (DT, add_common_args, decode_output,
                                force_cpu_backend, make_path, make_space,
                                normalize_backend, save_npz)

import sspslam_tpu
from sspslam_tpu.models import (SLAMGatedNetwork, SLAMNetwork,
                                get_slam_input_functions,
                                get_slam_input_functions2)
from sspslam_tpu.nef import (Connection, Ensemble, Network, Node, Probe,
                             Simulator)
from sspslam_tpu.utils import Rd_sampling


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_args(parser, default_T=200.0)
    parser.add_argument("--n-landmarks", default=50, type=int)
    parser.add_argument("--view-rad", default=0.2, type=float)
    parser.add_argument("--update-thres", default=0.2, type=float)
    parser.add_argument("--shift-rate", default=0.2, type=float)
    parser.add_argument("--intercept", default=0.1, type=float)
    parser.add_argument("--tuned", action="store_true",
                        help="apply the tuned loop-closure config found by "
                             "experiments/tune_loop_closure.py (round 3): "
                             "update_thres 0.4, shift_rate 0.1, pes_lr 2e-2, "
                             "voja_lr 1e-4, intercept 0.3 — median distance "
                             "error 0.043 vs 0.184 at reference defaults on "
                             "the validate_loop_closure protocol")
    # the reference hardcodes these (run_slam.py:183-184, with a TODO to
    # expose them); SLAMNetwork's own defaults (voja 5e-4 / pes 1e-2) track
    # noticeably better over long horizons than the reference CLI's values
    parser.add_argument("--voja-lr", default=1e-4, type=float)
    parser.add_argument("--pes-lr", default=5e-3, type=float)
    parser.add_argument("--pi-n-neurons", default=800, type=int)
    parser.add_argument("--mem-n-neurons", default=970, type=int)
    parser.add_argument("--circonv-n-neurons", default=100, type=int)
    parser.add_argument("--gc-n-neurons", default=0, type=int)
    parser.add_argument("--no-voja", action="store_true")
    parser.add_argument("--no-cleanup", action="store_true")
    parser.add_argument("--single-obj", action="store_true")
    parser.add_argument("--approx-vel", action="store_true")
    parser.add_argument("--vel-n-neurons", default=500, type=int)
    parser.add_argument("--neuron-type", default="lif",
                        help="lif | loihi | quantized (model-wide default; "
                             "loihi = dt-grid Loihi-discretised LIF)")
    args = parser.parse_args()
    if args.tuned:
        args.update_thres, args.shift_rate = 0.4, 0.1
        args.pes_lr, args.voja_lr, args.intercept = 2e-2, 1e-4, 0.3
    backend = normalize_backend(args.backend)
    if backend == "cpu":
        force_cpu_backend()

    dt = DT
    tau = 0.05
    radius = 1.0
    path, vels, T, domain_dim = make_path(args, radius=radius,
                                          max_steps=99999)
    pathlen = path.shape[0]

    view_rad = args.view_rad
    n_landmarks = args.n_landmarks
    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(n_landmarks, domain_dim, seed=args.seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]

    ssp_space = make_space(args, domain_dim, radius=radius)
    d = ssp_space.ssp_dim
    # encode only rows actually consumed (init clamp + strided error eval);
    # a full-path encode is ~T*d^2 host FLOPs and dominates start-up for
    # long trajectories
    real_init = ssp_space.encode(path[:60])
    landmark_ssps = ssp_space.encode(obj_locs)
    lm_space = sspslam_tpu.SPSpace(n_landmarks, d, seed=args.seed)

    get_fns = (get_slam_input_functions if args.single_obj
               else get_slam_input_functions2)
    (velocity_func, vel_scaling_factor, is_landmark_in_view, _,
     landmark_sp_func, _, landmark_vecssp_func) = get_fns(
        ssp_space, lm_space, vels, vec_to_landmarks, view_rad)

    clean_up_method = None if args.no_cleanup else "grid"

    with Network(seed=args.seed) as model:
        if args.approx_vel:
            vel_syn = 0.01
            _vel_input = Node(velocity_func, label="vel_input")
            vel_input = Ensemble(args.vel_n_neurons, domain_dim)
            Connection(_vel_input, vel_input, synapse=None)
            vel_p = Probe(vel_input, synapse=vel_syn)
            _vel_p = Probe(_vel_input, synapse=None)
        else:
            vel_syn = None
            vel_input = Node(velocity_func, label="vel_input")
        init_state = Node(lambda t: real_init[min(int((t - dt) / dt), 59)]
                          if t < 0.05 else np.zeros(d), label="init_state")
        landmark_vec = Node(landmark_vecssp_func, label="lm_vecssp_input")
        landmark_id = Node(landmark_sp_func, label="lm_sp_input")
        is_landmark = Node(is_landmark_in_view, label="lm_in_view_input")

        if backend == "gated":
            slam = SLAMGatedNetwork(
                ssp_space, lm_space, view_rad, n_landmarks,
                args.pi_n_neurons, args.mem_n_neurons,
                args.circonv_n_neurons, args.circonv_n_neurons,
                vel_input, landmark_vec, landmark_id, is_landmark,
                tau_pi=tau, update_thres=args.update_thres,
                vel_scaling_factor=vel_scaling_factor,
                shift_rate=0.1, pes_learning_rate=1e-3, seed=args.seed)
        else:
            slam = SLAMNetwork(
                ssp_space, lm_space, view_rad, n_landmarks,
                args.pi_n_neurons, args.mem_n_neurons,
                args.circonv_n_neurons,
                tau_pi=tau, update_thres=args.update_thres,
                vel_scaling_factor=vel_scaling_factor,
                shift_rate=args.shift_rate, voja_learning_rate=args.voja_lr,
                pes_learning_rate=args.pes_lr, intercept=args.intercept,
                clean_up_method=clean_up_method,
                gc_n_neurons=args.gc_n_neurons,
                voja=not args.no_voja, seed=args.seed)
            Connection(landmark_vec, slam.landmark_vec_ssp, synapse=None)
            Connection(landmark_id, slam.landmark_id_input, synapse=None)
            Connection(is_landmark, slam.no_landmark_in_view, synapse=None)
            Connection(vel_input, slam.velocity_input, synapse=vel_syn)
        Connection(init_state, slam.pathintegrator.input, synapse=None)

        slam_output_p = Probe(slam.pathintegrator.output, synapse=0.05)
        if args.save and backend != "gated":
            mem_weights = Probe(slam.assomemory.conn_out, attr="weights",
                                sample_every=T)
            if not args.no_voja:
                mem_encoders = Probe(slam.assomemory.conn_in.learning_rule,
                                     attr="scaled_encoders", sample_every=T)

    from sspslam_tpu.nef import (LIF, LIFRate, LoihiLIF, QuantizedLIF,
                                 RectifiedLinear)
    neuron_type = {"lif": LIF(), "lifrate": LIFRate(),
                   "relu": RectifiedLinear(), "loihi": LoihiLIF(),
                   "quantized": QuantizedLIF()}[args.neuron_type]
    sim = Simulator(model, seed=args.seed, progress=True,
                    default_neuron_type=neuron_type)
    # resource summary (the analog of the reference's Loihi utilization
    # printout, run_slam.py:212-227)
    from sspslam_tpu.utils.profiling import print_utilization_summary
    print_utilization_summary(sim.model)
    if backend == "numpy":
        from experiments.common import run_with_backend
        getter, elapsed_time, elapsed_thread_time = run_with_backend(
            sim, "numpy", T)
        slam_out_full = getter(slam_output_p)
    else:
        # tabulate inputs + compile the scan programs OUTSIDE the timed
        # region (analogous to the reference's untimed nengo build)
        n_run_steps = int(round(T / dt))
        sim.preload_inputs(n_run_steps)
        t0c = time.time()
        sim.compile(n_run_steps)
        print(f"compile: {time.time() - t0c:.1f}s")
        start_t = time.thread_time()
        start = time.time()
        sim.run(T)
        sim.sync()
        elapsed_thread_time = time.thread_time() - start_t
        elapsed_time = time.time() - start
        slam_out_full = sim.data[slam_output_p]
    print(f"sim wall time: {elapsed_time:.2f}s "
          f"({slam_out_full.shape[0] / elapsed_time:.0f} steps/s)")

    skip = 100 if path.shape[0] > 100000 else 1
    slam_sim_out = slam_out_full[::skip]
    ts = dt * np.arange(1, pathlen + 1)[::skip]
    path_s = path[::skip]
    real_s = ssp_space.encode(path[::skip])
    sim_path_est = decode_output(ssp_space, slam_sim_out, domain_dim)
    slam_sims = np.sum(slam_sim_out * real_s, axis=1) / np.maximum(
        1e-6, np.linalg.norm(slam_sim_out, axis=1))
    slam_error = np.sqrt(np.sum((path_s - sim_path_est) ** 2, axis=1))
    print(f"final distance error: {slam_error[-1]:.3f}; "
          f"median: {np.median(slam_error):.3f}")

    if args.save:
        if args.approx_vel:
            v_in = sim.data[_vel_p]
            v_est = sim.data[vel_p]
            sig_to_noise_ratio = 10 * np.log10(
                np.var(v_in) / np.var(v_in - v_est))
        else:
            sig_to_noise_ratio = 0

        if backend != "gated":
            # learned-map extraction: final PES decoders x memory activities
            # on the landmark SPs.  Unlike the reference (run_slam.py:263-268,
            # which notes it lacks the final Voja encoders), the final
            # scaled_encoders are probed, so the map uses the true learned
            # tuning.
            decoders = sim.data[mem_weights][-1].T          # (n, d)
            be = next(b for b in sim.model.ensembles
                      if b.obj is slam.assomemory.memory)
            if not args.no_voja:
                scaled_enc = sim.data[mem_encoders][-1]
            else:
                scaled_enc = be.scaled_encoders
            J = lm_space.vectors @ scaled_enc.T + be.bias
            activities = be.neuron_type.rates_np(J)
            landmark_ssps_est = activities @ decoders
            landmark_loc_est = decode_output(ssp_space, landmark_ssps_est,
                                             domain_dim)
            map_err = np.linalg.norm(landmark_loc_est - obj_locs, axis=1)
            print(f"learned-map median landmark error: {np.median(map_err):.3f}")
        else:
            landmark_ssps_est = np.array([])
            landmark_loc_est = np.array([])

        extra = args.save_name_extra
        if args.domain_dim != 2:
            extra = "_dim_" + str(args.domain_dim)
        if backend != "cpu":
            extra = "_backend_" + backend + extra
        if args.approx_vel:
            extra += f"_velnneurons_{args.vel_n_neurons}"
        filename = (f"slam_{extra}_sspdim_{d}_pinneurons_{args.pi_n_neurons}"
                    f"_memnneurons_{args.mem_n_neurons}"
                    f"_ccnneurons_{args.circonv_n_neurons}"
                    f"_T_{int(T)}_limit_{args.limit}_seed_{args.seed}.npz")
        save_npz(args, filename,
                 timesteps=np.arange(0, T, dt), ts=ts, path=path_s,
                 real_ssp=real_s, obj_locs=obj_locs, view_rad=view_rad,
                 slam_sim_out=slam_sim_out, slam_sims=slam_sims,
                 slam_path=sim_path_est, slam_error=slam_error,
                 landmark_ssps_est=landmark_ssps_est,
                 landmark_loc_est=landmark_loc_est,
                 elapsed_time=elapsed_time,
                 elapsed_thread_time=elapsed_thread_time,
                 sig_to_noise_ratio=sig_to_noise_ratio)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(5.5, 4))
        spec = fig.add_gridspec(3, 2)
        ax0 = fig.add_subplot(spec[0, :])
        ax0.plot(ts, 1 - slam_sims)
        ax0.set_ylabel("Cosine Error"); ax0.set_xlabel("Time (s)")
        ax1 = fig.add_subplot(spec[1, :])
        ax1.plot(ts, slam_error)
        ax1.set_ylabel("Distance Error"); ax1.set_xlabel("Time (s)")
        for j in range(min(2, domain_dim)):
            axn = fig.add_subplot(spec[2, j])
            axn.plot(ts, path_s[:, j], color="gray")
            axn.plot(ts, sim_path_est[:, j], "--", color="k")
            axn.set_xlabel("Time (s)"); axn.set_ylabel("xy"[j])
        fig.suptitle("SLAM output")
        os.makedirs("figures", exist_ok=True)
        out = os.path.join("figures", f"slam_{backend}.png")
        fig.savefig(out, dpi=120)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
