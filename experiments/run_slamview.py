"""Local-view-cell SLAM CLI — parity with reference
experiments/run_slamview.py (SLAMViewNetwork on recorded or random paths)."""

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
from sspslam_tpu.models import SLAMViewNetwork, get_slamview_input_functions
from sspslam_tpu.nef import Connection, Network, Node, Probe, Simulator
from sspslam_tpu.utils import Rd_sampling


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_args(parser, default_T=100.0)
    parser.add_argument("--n-landmarks", default=10, type=int)
    parser.add_argument("--view-rad", default=0.3, type=float)
    parser.add_argument("--update-thres", default=0.2, type=float)
    parser.add_argument("--shift-rate", default=0.1, type=float)
    parser.add_argument("--pi-n-neurons", default=700, type=int)
    parser.add_argument("--mem-n-neurons", default=970, type=int)
    parser.add_argument("--circonv-n-neurons", default=100, type=int)
    parser.add_argument("--gc-n-neurons", default=0, type=int)
    parser.add_argument("--neuron-type", default="lif",
                        help="lif | loihi | quantized (model-wide default; "
                             "loihi = dt-grid Loihi-discretised LIF)")
    parser.add_argument("--no-voja", action="store_true")
    parser.add_argument("--no-cleanup", action="store_true")
    parser.add_argument("--vel-noise", default=0.0, type=float,
                        help="Std of Gaussian noise added to the velocity "
                             "signal")
    args = parser.parse_args()
    backend = normalize_backend(args.backend)
    if backend == "cpu":
        force_cpu_backend()

    dt = DT
    tau = 0.05
    radius = 1.0
    path, vels, T, domain_dim = make_path(args, radius=radius,
                                          max_steps=99999)
    pathlen = path.shape[0]

    obj_locs = 0.9 * radius * 2 * (
        Rd_sampling(args.n_landmarks, domain_dim, seed=args.seed) - 0.5)
    vec_to_landmarks = obj_locs[None, :, :] - path[:, None, :]

    ssp_space = make_space(args, domain_dim, radius=radius)
    d = ssp_space.ssp_dim
    # encode only the rows actually consumed (init clamp + strided error
    # eval) — a full-path encode is ~T*d^2 host FLOPs and dominated start-up
    # for long trajectories
    real_init = ssp_space.encode(path[:60])
    lm_space = sspslam_tpu.SPSpace(args.n_landmarks, d, seed=args.seed)

    if args.vel_noise > 0:
        rng = np.random.default_rng(args.seed)
        vels = vels + rng.normal(0, args.vel_noise, size=vels.shape)

    velocity_func, vel_scaling_factor, is_landmark_in_view, landmark_func = \
        get_slamview_input_functions(ssp_space, lm_space, vels,
                                     vec_to_landmarks, args.view_rad)

    with Network(seed=args.seed) as model:
        vel_input = Node(velocity_func, label="vel_input")
        init_state = Node(lambda t: real_init[min(int((t - dt) / dt), 59)]
                          if t < 0.05 else np.zeros(d), label="init_state")
        view = Node(landmark_func, label="lm_input")
        is_landmark = Node(is_landmark_in_view, label="lm_in_view_input")

        slam = SLAMViewNetwork(
            ssp_space, lm_space, args.view_rad, args.n_landmarks,
            args.pi_n_neurons, args.mem_n_neurons, args.circonv_n_neurons,
            tau_pi=tau, update_thres=args.update_thres,
            vel_scaling_factor=vel_scaling_factor,
            shift_rate=args.shift_rate,
            clean_up_method=None if args.no_cleanup else "grid",
            gc_n_neurons=args.gc_n_neurons, voja=not args.no_voja,
            seed=args.seed)
        Connection(vel_input, slam.velocity_input, synapse=None)
        Connection(view, slam.view_input, synapse=None)
        Connection(is_landmark, slam.no_landmark_in_view, synapse=None)
        Connection(init_state, slam.pathintegrator.input, synapse=None)
        slam_output_p = Probe(slam.pathintegrator.output, synapse=0.05)

    from sspslam_tpu.nef import (LIF, LIFRate, LoihiLIF, QuantizedLIF,
                                 RectifiedLinear)
    neuron_type = {"lif": LIF(), "lifrate": LIFRate(),
                   "relu": RectifiedLinear(), "loihi": LoihiLIF(),
                   "quantized": QuantizedLIF()}[args.neuron_type]
    sim = Simulator(model, seed=args.seed, progress=True,
                    default_neuron_type=neuron_type)
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
        extra = args.save_name_extra
        if backend != "cpu":
            extra = "_backend_" + backend + extra
        filename = (f"slamview_{extra}_sspdim_{d}"
                    f"_pinneurons_{args.pi_n_neurons}"
                    f"_memnneurons_{args.mem_n_neurons}"
                    f"_ccnneurons_{args.circonv_n_neurons}"
                    f"_T_{int(T)}_limit_{args.limit}_seed_{args.seed}.npz")
        save_npz(args, filename, ts=ts, path=path_s, real_ssp=real_s,
                 obj_locs=obj_locs, view_rad=args.view_rad,
                 slam_sim_out=slam_sim_out, slam_sims=slam_sims,
                 slam_path=sim_path_est, slam_error=slam_error,
                 elapsed_time=elapsed_time,
                 elapsed_thread_time=elapsed_thread_time)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, 1, figsize=(5.5, 4), sharex=True)
        axes[0].plot(ts, 1 - slam_sims)
        axes[0].set_ylabel("Cosine Error")
        axes[1].plot(ts, slam_error)
        axes[1].set_ylabel("Distance Error")
        axes[1].set_xlabel("Time (s)")
        os.makedirs("figures", exist_ok=True)
        out = os.path.join("figures", f"slamview_{args.seed}.png")
        fig.savefig(out, dpi=120)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
