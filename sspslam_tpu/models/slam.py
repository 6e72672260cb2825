"""SSP-SLAM: path integration + associative map + landmark loop closure.

Capability parity with reference slam.py:8-307 (``SLAMNetwork``) and its data
adapters (:312-497), re-designed so the entire loop — including the clean-up
argmax and the correction gate, which the reference runs as host callbacks —
is jnp fused into the on-device step.

Loop closure dataflow (reference slam.py:227-307, SURVEY.md §3.4):
OVC population represents the SSP of the vector to the landmark in view;
CircularConvolution binds it with the cleaned self-position into a global
landmark SSP; the AssociativeMemory learns landmark-SP -> landmark-SSP; a
second CircularConvolution (invert_a) unbinds the recalled landmark SSP by
the egocentric vector to yield a position estimate; a gated correction nudges
the path integrator toward it when a landmark is in view and the estimate is
trustworthy (dot with the PI output above ``update_thres``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..nef import Connection, Ensemble, Network, Node, ScatteredHypersphere
from ..nef.distributions import CosineSimilarity
from ..ops import vsa
from .associativememory import AssociativeMemory
from .binding import CircularConvolution
from .pathintegration import PathIntegration

__all__ = ["SLAMNetwork", "get_slam_input_functions",
           "get_anchor_input_functions",
           "get_slam_input_functions2", "make_cleanup_fun"]


def make_cleanup_fun(ssp_space, method="grid", samples_per_dim=100,
                     sim_dtype=None, newton_iters=8):
    """Return (cleanup_fun, sample_ssps, sample_points): a jnp-traceable
    clean-up running fully inside the compiled step — the on-device
    replacement for the host callback the reference passes through as
    ``clean_up_method`` (reference slam.py:212-222, slam_view.py:65,209).

    Methods (parity with the reference's decode-method pass-through):

    - ``'grid'``: argmax over a precomputed SSP sample bank — one matvec.
    - ``'direct-optim'``: grid argmax init, then ``newton_iters`` damped-
      Newton iterations maximising the Fourier-domain similarity
      (sspspace._newton_refine_core — the traceable analogue of the
      reference's per-call scipy L-BFGS-B, sspspace.py:359-396), then
      re-encode phi(x*).  All inside the step: this is an on-device
      continuous clean-up the reference could only run as a host callback.
    - ``'network'``: trained MLP decoder (train_decoder_net) + re-encode.
    - ``'network-optim'``: MLP init + Newton polish + re-encode.
    - ``None``: no clean-up (callers skip the node).

    ``sim_dtype``: dtype for the grid similarity matmul (default bfloat16;
    set SSPSLAM_CLEANUP_F32=1 or pass jnp.float32 to compare in full
    precision).

    With SSPSLAM_HOIST_CLEANUP=1 the grid callable carries
    ``hoisted_consts`` — the sample bank(s) as a params-pytree
    contribution — so the builder passes them as TRACED arrays instead of
    baking ~4-6 MB of constants into the compiled executable (embedded
    constants inflate the serialized program and the persistent
    compilation cache).  Default is OFF: a constant bank lets XLA keep it
    out of the per-step argument traffic; which wins on the GPU is not
    measured yet (ROADMAP).  Called directly (without consts) the
    function always falls back to the closure."""
    import os
    import numpy as _np
    if method is None:
        return None, None, None
    if method not in ("grid", "direct-optim", "network", "network-optim"):
        raise ValueError(
            f"clean_up_method {method!r}: use 'grid', 'direct-optim', "
            "'network', 'network-optim' or None")

    sdt = vsa.default_cleanup_dtype() if sim_dtype is None else sim_dtype
    phase = jnp.asarray(ssp_space.phase_matrix, jnp.float32)
    ls = jnp.asarray(_np.asarray(ssp_space.length_scale).flatten(),
                     jnp.float32)

    sample_ssps = sample_points = None
    if method in ("grid", "direct-optim"):
        sample_ssps, sample_points = ssp_space.get_sample_pts_and_ssps(
            samples_per_dim)
        bank_np = _np.asarray(sample_ssps, _np.float32)
        bank = jnp.asarray(bank_np)
        bank_sim = bank.astype(sdt)
        points = jnp.asarray(sample_points, jnp.float32)

    if method in ("network", "network-optim"):
        if ssp_space.decoder_params is None:
            ssp_space.train_decoder_net()
        mlp_params = ssp_space.decoder_params

    if method in ("direct-optim", "network-optim"):
        from ..sspspace import _newton_refine_core
        d = ssp_space.ssp_dim
        mat = jnp.asarray(
            ssp_space.phase_matrix / _np.asarray(
                ssp_space.length_scale).reshape(1, -1), jnp.float32)
        # DFT matrices for the target spectrum conj(F(v)) in real
        # arithmetic: F = C v - i S v, conj(F) = C v + i S v
        jk = 2 * _np.pi * _np.outer(_np.arange(d), _np.arange(d)) / d
        C_mat = jnp.asarray(_np.cos(jk), jnp.float32)
        S_mat = jnp.asarray(_np.sin(jk), jnp.float32)
        lo_hi = None
        if ssp_space.domain_bounds is not None:
            lo_hi = (jnp.asarray(ssp_space.domain_bounds[:, 0], jnp.float32),
                     jnp.asarray(ssp_space.domain_bounds[:, 1], jnp.float32))

        def newton_polish(v, x0):
            u = vsa.make_unitary(v)
            t_re = C_mat @ u
            t_im = S_mat @ u
            x = _newton_refine_core(mat, t_re, t_im, x0, lo_hi,
                                    newton_iters)
            return vsa.encode(phase, x, ls)

    if method == "grid":
        def cleanup_fun(x, consts=None):
            b32 = bank if consts is None else consts["bank"]
            bsim = bank_sim if consts is None else consts["bank_sim"]
            sims = jnp.einsum("md,...d->...m", bsim, x.astype(bsim.dtype))
            best = jnp.argmax(sims, axis=-1)
            return jnp.take(b32, best, axis=0)

        # pure-NumPy mirror for the host interpreter (one einsum+argmax;
        # keeps the NumpyStepper baseline strictly host-only).  Takes the
        # hoisted consts too so the interpreter tracks a rewritten bank
        def _cleanup_np(x, consts=None):
            b = (bank_np if consts is None
                 else _np.asarray(consts["bank"], _np.float32))
            sims = b @ _np.asarray(x, _np.float32)
            return b[int(_np.argmax(sims))]
        cleanup_fun.np_function = _cleanup_np

        if os.environ.get("SSPSLAM_HOIST_CLEANUP"):
            cleanup_fun.hoisted_consts = {
                "bank": bank_np, "bank_sim": bank_np.astype(sdt)}
    elif method == "direct-optim":
        def cleanup_fun(x):
            sims = jnp.einsum("md,d->m", bank_sim, x.astype(bank_sim.dtype))
            x0 = points[jnp.argmax(sims)]
            return newton_polish(x, x0)
    elif method == "network":
        def cleanup_fun(x):
            from ..sspspace import _mlp_apply
            pt = _mlp_apply(mlp_params, x[None, :])[0]
            return vsa.encode(phase, pt, ls)
    else:  # network-optim
        def cleanup_fun(x):
            from ..sspspace import _mlp_apply
            x0 = _mlp_apply(mlp_params, x[None, :])[0]
            return newton_polish(x, x0)

    return cleanup_fun, sample_ssps, sample_points


def make_update_state_func(update_thres, shift_rate, d):
    """Loop-closure correction gate shared by SLAMNetwork and
    SLAMViewNetwork (reference slam.py:233-237, slam_view.py:275-276):
    emit ``shift_rate * (estimate - PI)`` when a landmark is in view AND
    the estimate agrees with the PI output above ``update_thres``.

    With SSPSLAM_HOIST_GATE=1 the thresholds become TRACED params
    (``hoisted_consts``): one compiled executable serves every
    (update_thres, shift_rate) setting — the loop-closure sweep machinery
    rewrites them in ``Simulator.params`` without a recompile.  Default is
    baked closure constants (the fastest single-config step, same rule as
    the filter coefficients).  The NumPy host mirror takes the same
    ``consts`` so the interpreter agrees with the jit path under hoisting
    too (the interpreter passes its current hoisted table when the node
    has a hoisted key)."""
    def update_state_func(t, x, consts=None):
        thr = update_thres if consts is None else consts["update_thres"]
        sr = shift_rate if consts is None else consts["shift_rate"]
        pos_est = x[:d]
        pi_est = x[d:2 * d]
        no_view = x[-1]
        ok = (jnp.abs(no_view) < 1e-3) & (
            jnp.sum(pos_est * pi_est) > thr)
        return jnp.where(ok, sr * (pos_est - pi_est),
                         jnp.zeros_like(x[:d]))

    import os as _os
    if _os.environ.get("SSPSLAM_HOIST_GATE"):
        update_state_func.hoisted_consts = {
            "update_thres": np.float32(update_thres),
            "shift_rate": np.float32(shift_rate)}

    def _update_state_np(t, x, consts=None):
        # host-interpreter mirror of the gate (reference slam.py:233-237)
        thr = update_thres if consts is None else float(
            consts["update_thres"])
        sr = shift_rate if consts is None else float(consts["shift_rate"])
        pos_est, pi_est = x[:d], x[d:2 * d]
        if abs(float(x[-1])) < 1e-3 and float(pos_est @ pi_est) > thr:
            return sr * (pos_est - pi_est)
        return np.zeros(d, np.float32)
    update_state_func.np_function = _update_state_np
    return update_state_func


def make_auto_recovery_gate_func(update_thres, shift_rate, d, dt=0.001,
                                 recovery_shift_rate=0.3, trigger=0.2,
                                 exit_thres=0.6, familiar=0.25,
                                 ema_tau=0.5, recovery_T=25.0,
                                 arm_at_start=False, cons_trigger=0.5,
                                 cons_ema_tau=0.25, recovery_decay=True,
                                 anchor=False, anchor_trigger=0.2):
    """Self-healing correction gate (no reference counterpart).

    Extends the reference gate (slam.py:233-237) with an IN-MODEL
    tracking-loss controller, runnable entirely inside the compiled step
    via a stateful node (state = [armed, agreement_ema, recovery_timer,
    cons_ema]):

    * arm once the smoothed agreement cos(estimate, PI) first exceeds
      ``exit_thres`` (before the map is learned, low agreement is normal);
    * a tick is EVIDENCE only while a landmark is in view AND the memory
      recognises it (recall magnitude >= ``familiar``) — unlearned
      landmarks give a noise estimate, not a loss signal;
    * trigger on EITHER of two loss signals while armed:
      (a) sustained low agreement (EMA < ``trigger``) — the slow signal;
      (b) **map inconsistency**: an EMA (``cons_ema_tau``, held across
      inconclusive steps) of cos(recall, value) on FAMILIAR landmarks
      falling below ``cons_trigger``.  ``value`` is the incoming bound
      landmark-location SSP (recovered as recall - err from the PES
      error population the gate already reads).  The geometry makes
      this the signal that survives FAST learning rates: PES drags the
      recall COLINEARLY toward the value, so during initial learning
      of a landmark cos(recall, value) ~ +1 even while |err| is large,
      and in steady tracking recall ~ value so it is ~ +1 again — but
      after a kidnap the value stream binds the true relative vector to
      a wrong self-estimate, giving value ~ phi(l + x_wrong - x_true),
      near-ORTHOGONAL to the learned recall phi(l) for displacements
      beyond the kernel width.  The agreement signal, by contrast, is
      ERASED within ~1/(lr * a * n) seconds of a kidnap by the map
      rewriting itself to match the wrong PI (measured: undetectable at
      pes_lr=2e-2), and the raw |err| magnitude is non-discriminative
      (measured pre/post tick means 0.61 vs 0.65 — initial learning
      keeps it high for minutes); cos(recall, value) separates cleanly
      (measured pre-kidnap floor 0.76-0.82 vs post-kidnap dips to
      0.27-0.44 across seeds 0-2, VALIDATION.md);
    * on trigger, enter recovery for ``recovery_T`` seconds: corrections
      always applied at ``recovery_shift_rate``, and map learning
      suppressed through the extra ``suppress`` output channel (a wrong
      self-estimate would otherwise rewrite the map).  SLAMNetwork wires
      that channel into the PES error population (inhibition) AND,
      sign-inverted, into the Voja rule so its 1+gate learning signal
      cancels to zero — see the wiring comment in
      ``SLAMNetwork.__init__``;
    * the timer re-triggers immediately if agreement is still low at
      expiry, so recovery effectively holds until tracking restores;
    * with ``recovery_decay`` (default) the recovery shift rate DECAYS
      linearly from ``recovery_shift_rate`` to ``shift_rate`` over the
      window instead of holding: a fresh (gross) loss gets the full pull
      while the handback approaches steady-state strength smoothly —
      re-triggers during normal tracking then cost steady-state-like
      jitter instead of the measured ~2x precision hit of a constant
      high-rate window (VALIDATION.md map-merge armed-gate numbers).

    These rules and constants come from the measured kidnapped-robot
    study (VALIDATION.md).  Inputs: ``x = [pos_est(d), pi_est(d),
    recall(d), err(d), no_view(1)]`` (``err`` = the memory's PES error
    population output); outputs ``[correction(d), suppress(1)]``.
    All thresholds/rates are hoisted traced params.

    **Absolute anchor channels (optional, ``anchor=True``).**  Both
    measured observability limits of the internal channels — the
    co-drifting map at d=393 (map and pose agree with each other but
    not the world) and the scaled 2x-view-radius kidnap (the signature
    lives in the ~1 s window the familiarity floor masks; VALIDATION
    "Part 8b") — are invisible to ANY statistic built from the model's
    own state.  The principled fix is a set of SURVEYED landmarks whose
    allocentric positions are known (beacons — the analog of the
    reference's Loihi deployment assumption of a known start pose,
    run_slam.py).  The beacon observation arrives as two extra d-dim
    inputs plus a flag — ``anchor_pos`` (the surveyed position SSP of
    the nearest surveyed landmark in view, a ground-truth table, NOT
    learned state), ``anchor_vec`` (the egocentric vector SSP to it)
    and ``anchor_no_view`` — i.e. exactly what a beacon-recognising
    perception stack reports.  They deliberately do NOT ride the
    model's landmark inputs: the multi-landmark adapter superimposes
    all in-view SPs (get_slam_input_functions2), which dilutes any
    in-gate identity match by 1/sqrt(k) and makes the bundled vec-SSP
    useless as an absolute reference (measured: a 10-anchor in-gate
    matcher never fired at the 3-D 100-landmark config).  Input layout
    becomes ``[pos(d), pi(d), recall(d), err(d), anchor_pos(d),
    anchor_vec(d), anchor_no_view(1), no_view(1)]`` (6d+2) and the
    state gains one element:

    * **absolute agreement** ``cos(pi (x) anchor_vec, anchor_pos)``
      while a surveyed landmark is in view — equals K(pose error)
      directly, measuring the pose against the WORLD rather than
      against the map, so it dips for co-drift and masked kidnaps
      alike; EMA'd (``cons_ema_tau``), held across non-anchor steps,
      trigger below ``anchor_trigger`` (derive as K(view_rad), same
      rationale as the consistency trigger);
    * **absolute correction**: during recovery, while a surveyed
      landmark is in view, the correction pulls toward ``phi(x_true) =
      ~anchor_vec (x) anchor_pos`` (two inputs that do not pass through
      the learned map) instead of the map's position estimate — a wrong
      map cannot poison the recovery.
    """
    alpha = float(dt / ema_tau)
    alpha_c = float(dt / cons_ema_tau)
    R = float(recovery_T / dt)
    has_anchor = bool(anchor)

    def gate(t, x, s, consts):
        thr = consts["update_thres"]
        sr = consts["shift_rate"]
        rsr = consts["recovery_shift_rate"]
        trig = consts["trigger"]
        exitt = consts["exit_thres"]
        fam_floor = consts["familiar"]
        cons_trig = consts["cons_trigger"]
        pos_est, pi_est = x[:d], x[d:2 * d]
        recall, err = x[2 * d:3 * d], x[3 * d:4 * d]
        no_view = x[-1]
        in_view = jnp.abs(no_view) < 1e-3
        dot = jnp.sum(pos_est * pi_est)
        agree = dot / (jnp.linalg.norm(pos_est)
                       * jnp.linalg.norm(pi_est) + 1e-9)
        conclusive = in_view & (jnp.linalg.norm(recall) >= fam_floor)
        ema = jnp.where(conclusive, (1 - alpha) * s[1] + alpha * agree,
                        s[1])
        # map-consistency evidence HOLDS across inconclusive steps (out of
        # view / unfamiliar): the statistic is only defined on familiar
        # encounters, and relaxing between them erases the dip before the
        # next encounter confirms it (measured — relax-to-1 never reaches
        # the trigger at any tau)
        value = recall - err
        cons = (jnp.sum(recall * value)
                / (jnp.linalg.norm(recall) * jnp.linalg.norm(value) + 1e-9))
        cons_ema = jnp.where(conclusive,
                             (1 - alpha_c) * s[3] + alpha_c * cons, s[3])
        armed = jnp.maximum(s[0], (ema >= exitt).astype(jnp.float32))
        timer = jnp.maximum(s[2] - 1.0, 0.0)
        lost = ((ema < trig) | (cons_ema < cons_trig)) & conclusive
        if has_anchor:
            anc_pos = x[4 * d:5 * d]
            anc_vec = x[5 * d:6 * d]
            a_trig = consts["anchor_trigger"]
            anchor_seen = jnp.abs(x[-2]) < 1e-3
            bound = vsa.bind(pi_est, anc_vec)
            a_agree = (jnp.sum(bound * anc_pos)
                       / (jnp.linalg.norm(bound)
                          * jnp.linalg.norm(anc_pos) + 1e-9))
            a_ema = jnp.where(anchor_seen,
                              (1 - alpha_c) * s[4] + alpha_c * a_agree,
                              s[4])
            lost = lost | ((a_ema < a_trig) & anchor_seen)
        trigger_now = (armed > 0) & lost & (timer <= 0)
        timer = jnp.where(trigger_now, R, timer)
        in_rec = timer > 0
        # entering recovery resets the consistency evidence: learning is
        # suppressed inside (the error population is inhibited, so
        # value-as-recall-minus-err degenerates) and whatever evidence
        # remains is not new
        cons_ema = jnp.where(trigger_now, 1.0, cons_ema)
        gate_ok = in_view & ((dot > thr) | in_rec)
        rsr_eff = (sr + (rsr - sr) * timer / R) if recovery_decay else rsr
        target = pos_est - pi_est
        if has_anchor:
            a_ema = jnp.where(trigger_now, 1.0, a_ema)
            pose_abs = vsa.unbind(anc_vec, anc_pos)
            target = jnp.where(in_rec & anchor_seen,
                               pose_abs - pi_est, target)
        corr = jnp.where(gate_ok,
                         jnp.where(in_rec, rsr_eff, sr) * target,
                         jnp.zeros(d, jnp.float32))
        suppress = jnp.where(in_rec, 10.0, 0.0)
        out = jnp.concatenate([corr, suppress[None]])
        state = [armed, ema, timer, cons_ema] + ([a_ema] if has_anchor
                                                 else [])
        return out, jnp.stack(state)

    # trusted-map / localization mode: a pre-learned map was injected and
    # the agent may start outside its coverage, so waiting for tracking to
    # be established first (the arming latch) would lock the gate out —
    # start armed instead
    gate.state_init = np.array(
        [1.0 if arm_at_start else 0.0, 0.0, 0.0, 1.0]
        + ([1.0] if has_anchor else []), np.float32)
    gate.hoisted_consts = {
        "update_thres": np.float32(update_thres),
        "shift_rate": np.float32(shift_rate),
        "recovery_shift_rate": np.float32(recovery_shift_rate),
        "trigger": np.float32(trigger),
        "exit_thres": np.float32(exit_thres),
        "familiar": np.float32(familiar),
        "cons_trigger": np.float32(cons_trigger),
    }
    if has_anchor:
        gate.hoisted_consts["anchor_trigger"] = np.float32(anchor_trigger)

    def _gate_np(t, x, s, consts):
        thr, sr = float(consts["update_thres"]), float(consts["shift_rate"])
        rsr = float(consts["recovery_shift_rate"])
        trig = float(consts["trigger"])
        exitt = float(consts["exit_thres"])
        fam_floor = float(consts["familiar"])
        cons_trig = float(consts["cons_trigger"])
        pos_est, pi_est = x[:d], x[d:2 * d]
        recall, err = x[2 * d:3 * d], x[3 * d:4 * d]
        no_view = x[-1]
        in_view = abs(float(no_view)) < 1e-3
        dot = float(pos_est @ pi_est)
        agree = dot / (np.linalg.norm(pos_est)
                       * np.linalg.norm(pi_est) + 1e-9)
        conclusive = in_view and np.linalg.norm(recall) >= fam_floor
        armed, ema, timer, cons_ema = (float(s[0]), float(s[1]),
                                       float(s[2]), float(s[3]))
        if conclusive:
            ema = (1 - alpha) * ema + alpha * agree
            value = recall - err
            cons = float(recall @ value) / float(
                np.linalg.norm(recall) * np.linalg.norm(value) + 1e-9)
            cons_ema = (1 - alpha_c) * cons_ema + alpha_c * cons
        armed = max(armed, float(ema >= exitt))
        timer = max(timer - 1.0, 0.0)
        lost = (ema < trig or cons_ema < cons_trig) and conclusive
        anchor_seen = False
        a_ema = float(s[4]) if has_anchor else 1.0
        if has_anchor:
            anc_pos, anc_vec = x[4 * d:5 * d], x[5 * d:6 * d]
            a_trig = float(consts["anchor_trigger"])
            anchor_seen = abs(float(x[-2])) < 1e-3
            if anchor_seen:
                bound = np.fft.ifft(np.fft.fft(pi_est)
                                    * np.fft.fft(anc_vec)).real
                a_agree = float(bound @ anc_pos) / float(
                    np.linalg.norm(bound) * np.linalg.norm(anc_pos) + 1e-9)
                a_ema = (1 - alpha_c) * a_ema + alpha_c * a_agree
                lost = lost or a_ema < a_trig
        if armed > 0 and lost and timer <= 0:
            timer = R
            cons_ema = 1.0
            a_ema = 1.0
        in_rec = timer > 0
        out = np.zeros(d + 1, np.float32)
        rsr_eff = (sr + (rsr - sr) * timer / R) if recovery_decay else rsr
        if in_view and (dot > thr or in_rec):
            target = pos_est - pi_est
            if has_anchor and in_rec and anchor_seen:
                pose_abs = np.fft.ifft(
                    np.conj(np.fft.fft(anc_vec))
                    * np.fft.fft(anc_pos)).real
                target = pose_abs - pi_est
            out[:d] = (rsr_eff if in_rec else sr) * target
        out[d] = 10.0 if in_rec else 0.0
        state = [armed, ema, timer, cons_ema] + ([a_ema] if has_anchor
                                                 else [])
        return out, np.array(state, np.float32)

    gate.np_function = _gate_np
    return gate


def _wrap_cleanup_node(clean_up_fun):
    """Wrap a cleanup callable into a ``(t, x)`` node function, carrying
    through its ``hoisted_consts`` (traced-bank variant) and
    ``np_function`` (host-interpreter mirror) attributes."""
    hc = getattr(clean_up_fun, "hoisted_consts", None)
    if hc is not None:
        def cleanup_node_fn(t, x, consts=None, _f=clean_up_fun):
            return _f(x, consts)
        cleanup_node_fn.hoisted_consts = hc
    else:
        def cleanup_node_fn(t, x, _f=clean_up_fun):
            return _f(x)
    npf = getattr(clean_up_fun, "np_function", None)
    if npf is not None:
        if hc is not None:
            # hoisted nodes: the interpreter forwards its current consts
            cleanup_node_fn.np_function = (
                lambda t, x, consts=None, _f=npf: _f(x, consts))
        else:
            cleanup_node_fn.np_function = lambda t, x, _f=npf: _f(x)
    return cleanup_node_fn


class SLAMNetwork(Network):
    """Full SSP-SLAM network.

    Required inputs: ``velocity_input`` (domain_dim), ``landmark_vec_ssp``
    (d), ``landmark_id_input`` (d; the landmark SP), ``no_landmark_in_view``
    (1; 0 when a landmark is visible, large otherwise).
    Output: ``output`` — the path integrator's SSP self-position estimate.
    """

    def __init__(self, ssp_space, lm_space, view_rad, n_landmarks,
                 pi_n_neurons, mem_n_neurons, circonv_n_neurons,
                 tau=0.01, tau_pi=0.05,
                 update_thres=0.2, vel_scaling_factor=1.0,
                 rad_scaling_factor=1.0, shift_rate=0.1,
                 voja_learning_rate=5e-4, pes_learning_rate=1e-2,
                 clean_up_method="grid", gc_n_neurons=0, encoders=None,
                 voja=True, seed=0, landmark_sps=None, intercept=None,
                 cleanup_samples_per_dim=100, gate_mode="reference",
                 gate_kwargs=None, anchor=False, label="slam"):
        super().__init__(label=label, seed=seed)

        domain_dim = ssp_space.domain_dim
        d = ssp_space.ssp_dim

        rng = np.random.RandomState(seed=seed)
        if landmark_sps is None:
            landmark_sps = lm_space.vectors
        if (not voja) and (encoders is None):
            encoders = landmark_sps[rng.randint(n_landmarks, size=mem_n_neurons), :]
        if intercept is None:
            intercept = min(
                (landmark_sps @ landmark_sps.T - np.eye(n_landmarks)).max(), 0.5)

        # object-vector-cell encoders: SSPs of scattered displacement vectors
        ovc_n_neurons = mem_n_neurons
        ovc_vectors = ScatteredHypersphere(
            surface=False, min_magnitude=1e-3).sample(
            ovc_n_neurons, domain_dim, rng=np.random.default_rng(seed))
        OVC_encoders = ssp_space.encode(ovc_vectors)

        clean_up_fun, sample_ssps, sample_points = make_cleanup_fun(
            ssp_space, method=clean_up_method,
            samples_per_dim=cleanup_samples_per_dim)
        if sample_ssps is not None:
            self.sample_ssps = sample_ssps
            self.sample_points = sample_points
        self.clean_up_fun = clean_up_fun

        if gate_mode == "auto_recovery":
            gk = dict(gate_kwargs or {})
            if anchor:
                # anchor=True adds the beacon-observation channels: the
                # model grows anchor_pos_input / anchor_vec_ssp /
                # no_anchor_in_view inputs for the surveyed-landmark
                # perception stream (see the gate docstring and
                # get_anchor_input_functions)
                gk.setdefault("anchor", True)
            update_state_func = make_auto_recovery_gate_func(
                update_thres, shift_rate, d, **gk)
            gate_in = (6 * d + 2) if anchor else (4 * d + 1)
            gate_out = d + 1
        else:
            assert gate_mode == "reference", gate_mode
            if anchor:
                raise ValueError(
                    "anchor= requires gate_mode='auto_recovery' (the "
                    "reference gate has no detection channels to feed)")
            update_state_func = make_update_state_func(
                update_thres, shift_rate, d)
            gate_in, gate_out = 2 * d + 1, d

        mk_unitary = _np_make_unitary

        with self:
            self.velocity_input = Node(size_in=domain_dim, label="vel_input")
            self.landmark_id_input = Node(size_in=d, label="lm_id_input")
            self.landmark_vec_ssp = Node(size_in=d, label="lm_vecssp_input")
            self.no_landmark_in_view = Node(size_in=1, label="lm_in_view_input")

            self.update_state = Node(update_state_func, size_in=gate_in,
                                     size_out=gate_out)
            Connection(self.no_landmark_in_view, self.update_state[-1],
                       synapse=None)

            # path integrator
            self.pathintegrator = PathIntegration(
                ssp_space, pi_n_neurons, tau_pi,
                max_radius=rad_scaling_factor,
                scaling_factor=vel_scaling_factor, stable=True,
                label="pathint")
            self.output = self.pathintegrator.output
            Connection(self.velocity_input, self.pathintegrator.velocity_input,
                       synapse=None)
            corr_src = (self.update_state[:d]
                        if gate_mode == "auto_recovery" else
                        self.update_state)
            Connection(corr_src, self.pathintegrator.input, synapse=None)

            # object vector cells
            self.ovc_ens = Ensemble(ovc_n_neurons, d, encoders=OVC_encoders,
                                    label="ovc")
            Connection(self.landmark_vec_ssp, self.ovc_ens, synapse=None)

            # bind cleaned self-position with the egocentric landmark SSP
            self.landmark_ssp_ens = CircularConvolution(
                circonv_n_neurons, dimensions=d, label="landmark_circonv")
            Connection(self.ovc_ens, self.landmark_ssp_ens.input_b,
                       synapse=None)

            # clean-up of the PI output
            if clean_up_fun is not None:
                cleanup_node_fn = _wrap_cleanup_node(clean_up_fun)
            if clean_up_fun is None:
                self.gridcells = None
                Connection(self.pathintegrator.output,
                           self.landmark_ssp_ens.input_a, synapse=tau)
            elif gc_n_neurons <= 0:
                self.gridcells = Node(cleanup_node_fn, size_in=d,
                                      size_out=d, label="cleanup")
                Connection(self.pathintegrator.output, self.gridcells,
                           synapse=tau)
                Connection(self.gridcells, self.landmark_ssp_ens.input_a,
                           synapse=None)
            else:
                gc_encoders = ssp_space.sample_grid_encoders(gc_n_neurons)
                self.cleanup = Node(cleanup_node_fn, size_in=d,
                                    size_out=d, label="cleanup")
                self.gridcells = Ensemble(
                    gc_n_neurons, d, encoders=gc_encoders,
                    intercepts=CosineSimilarity(d + 2), label="gridcells")
                Connection(self.pathintegrator.output, self.cleanup,
                           synapse=tau)
                Connection(self.cleanup, self.gridcells, synapse=None)
                Connection(self.gridcells, self.landmark_ssp_ens.input_a,
                           synapse=tau)

            # environment map
            self.assomemory = AssociativeMemory(
                mem_n_neurons, d, d, intercept,
                voja_learning_rate=voja_learning_rate,
                pes_learning_rate=pes_learning_rate,
                voja=voja, encoders=encoders)
            Connection(self.landmark_id_input, self.assomemory.key_input,
                       synapse=None)
            Connection(self.landmark_ssp_ens.output,
                       self.assomemory.value_input, synapse=tau)
            Connection(self.no_landmark_in_view, self.assomemory.learning,
                       synapse=None)

            # position estimate: unbind recalled landmark SSP by the OVC vector
            self.position_estimate = CircularConvolution(
                circonv_n_neurons, d, invert_a=True, label="newpos_circonv")
            Connection(self.ovc_ens, self.position_estimate.input_a,
                       synapse=tau, function=mk_unitary)
            Connection(self.assomemory.recall, self.position_estimate.input_b,
                       synapse=tau, function=mk_unitary)

            # gated correction into the path integrator.  The auto gate's
            # loss statistics (agreement + map consistency) were validated
            # against 50 ms-filtered signals (the host tick monitor's
            # probes); at this model's control tau=0.01 the per-step
            # decodes are ~5x noisier and cos(recall, value) sits 0.3-0.4
            # LOWER (decode noise inflates the norms and decorrelates the
            # vectors — measured: live cons EMA 0.33-0.70 in healthy
            # phase-A tracking vs 0.81+ on the same run's 50 ms probes),
            # so the controller false-triggers right after arming.  Feed
            # the gate through a dedicated evidence synapse instead; the
            # extra ~40 ms of lag is negligible against the 25 s recovery
            # window and the EMA time constants.
            ev_tau = max(tau, 0.05) if gate_mode == "auto_recovery" else tau
            Connection(self.position_estimate.output, self.update_state[:d],
                       synapse=ev_tau)
            Connection(self.pathintegrator.output,
                       self.update_state[d:2 * d], synapse=ev_tau)
            if gate_mode == "auto_recovery":
                # the controller's extra inputs/outputs: raw recall
                # magnitude is the landmark-familiarity evidence, and the
                # suppress channel (value 10 during recovery) freezes map
                # learning.  It must NOT ride the `learning` node: that
                # node inhibits the PES error population, but the Voja
                # rule's learning signal is 1 + gate (nengo semantics), so
                # +10 there would ACCELERATE encoder drift 11x while a
                # landmark is in view — the opposite of suppression.
                # Instead wire the two effects with the correct signs:
                # -2.5/neuron into the error population (the same
                # inhibition the in-view signal applies, freezing PES) and
                # -0.1 into the Voja rule so its signal is 1 - 1 = 0.
                Connection(self.assomemory.recall,
                           self.update_state[2 * d:3 * d], synapse=ev_tau)
                # the PES error population output (recall - value) feeds
                # the gate's map-CONSISTENCY channel: the controller
                # reconstructs value = recall - err and uses
                # cos(recall, value) on familiar landmarks as the
                # learning-rate-invariant kidnap signal (see the gate
                # docstring)
                Connection(self.assomemory.error,
                           self.update_state[3 * d:4 * d], synapse=ev_tau)
                if anchor:
                    # beacon-observation channels: ground-truth tables
                    # from the perception adapter (the surveyed position
                    # SSP of the nearest surveyed landmark in view, the
                    # egocentric vector SSP to it, and its in-view flag)
                    # — deliberately NOT the model's bundled landmark
                    # inputs, see the gate docstring
                    self.anchor_pos_input = Node(size_in=d,
                                                 label="anchor_pos_input")
                    self.anchor_vec_ssp = Node(size_in=d,
                                               label="anchor_vecssp_input")
                    self.no_anchor_in_view = Node(
                        size_in=1, label="anchor_in_view_input")
                    Connection(self.anchor_pos_input,
                               self.update_state[4 * d:5 * d], synapse=None)
                    Connection(self.anchor_vec_ssp,
                               self.update_state[5 * d:6 * d], synapse=None)
                    Connection(self.no_anchor_in_view,
                               self.update_state[6 * d], synapse=None)
                Connection(self.update_state[d],
                           self.assomemory.error.neurons,
                           transform=-2.5 * np.ones((mem_n_neurons, 1)),
                           synapse=None)
                if voja:
                    Connection(self.update_state[d],
                               self.assomemory.conn_in.learning_rule,
                               transform=-0.1, synapse=None)


def _vel_scale(max_abs_freq) -> float:
    """1/max|A v| velocity normalisation (reference slam.py:392-394), with
    the degenerate all-zero-velocity world guarded: the reference's bare
    divide turns a stationary path into inf scale and NaN velocities that
    LIF silently squashes to zero spikes — fail soft to scale 1 instead."""
    m = float(max_abs_freq)
    return 1.0 / m if np.isfinite(m) and m > 0 else 1.0


def _np_make_unitary(x):
    """NumPy make-unitary for decoder solving (vectorised over rows)."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    fx = np.fft.fft(x, axis=-1)
    fx = fx / np.maximum(np.abs(fx), 1e-8)
    out = np.fft.ifft(fx, axis=-1).real
    return out if out.shape[0] > 1 else out[0]


# ---------------------------------------------------------------------------
# Data -> input-signal adapters (reference slam.py:312-497)
# ---------------------------------------------------------------------------

def get_slam_input_functions(ssp_space, lm_space, velocity_data,
                             vec_to_landmarks_data, view_rad, dt=0.001):
    """Convert recorded trajectory/landmark data into time-callables for
    input nodes (single nearest landmark in view).

    Returns (velocity_func, vel_scaling_factor, is_landmark_in_view,
    landmark_id_func, landmark_sp_func, landmark_vec_func,
    landmark_vecssp_func) — all are ``f(t)`` and get tabulated to device
    arrays at run start."""
    pathlen, n_landmarks, domain_dim = vec_to_landmarks_data.shape
    d = ssp_space.ssp_dim
    landmark_sps = lm_space.vectors

    vel_scaling_factor = _vel_scale(np.max(
        np.abs(ssp_space.phase_matrix @ velocity_data.T)))
    vels_scaled = velocity_data * vel_scaling_factor

    def step_of(t):
        return min(max(int(round((t - dt) / dt)), 0), pathlen - 1)

    # precompute nearest-in-view landmark per timestep
    dists = np.linalg.norm(vec_to_landmarks_data, axis=2)  # (T, L)
    nearest = np.argmin(dists, axis=1)
    in_view = dists[np.arange(pathlen), nearest] <= view_rad
    lm_ids = np.where(in_view, nearest, -1)

    vec_rows = vec_to_landmarks_data[np.arange(pathlen), nearest, :]
    vec_ssp_rows = np.asarray(ssp_space.encode(vec_rows))

    # array-backed (TimeTable) signals: the Simulator slices these directly
    # instead of looping a Python call per step (see nef/processes.py)
    from ..nef.processes import TimeTable
    seen = in_view[:, None]
    velocity_func = TimeTable(vels_scaled, dt)
    landmark_vec_func = TimeTable(np.where(seen, vec_rows, 0.0), dt)
    landmark_sp_func = TimeTable(
        np.where(seen, landmark_sps[np.maximum(lm_ids, 0)], 0.0), dt)
    landmark_vecssp_func = TimeTable(np.where(seen, vec_ssp_rows, 0.0), dt)
    is_landmark_in_view = TimeTable(np.where(in_view, 0.0, 10.0), dt)

    def landmark_id_func(t):
        return lm_ids[step_of(t)]

    return (velocity_func, vel_scaling_factor, is_landmark_in_view,
            landmark_id_func, landmark_sp_func, landmark_vec_func,
            landmark_vecssp_func)


def get_slam_input_functions2(ssp_space, lm_space, velocity_data,
                              vec_to_landmarks_data, view_rad, dt=0.001):
    """Multi-landmark version: superimposes the SPs / vec-SSPs of all
    landmarks within the view radius (reference slam.py:442-497)."""
    pathlen, n_landmarks, domain_dim = vec_to_landmarks_data.shape
    d = ssp_space.ssp_dim
    landmark_sps = lm_space.vectors

    vel_scaling_factor = _vel_scale(np.max(
        np.abs(ssp_space.phase_matrix @ velocity_data.T)))
    vels_scaled = velocity_data * vel_scaling_factor

    def step_of(t):
        return min(max(int(round((t - dt) / dt)), 0), pathlen - 1)

    dists = np.linalg.norm(vec_to_landmarks_data, axis=2)  # (T, L)
    mask = dists <= view_rad                               # (T, L)
    any_in_view = mask.any(axis=1)

    sum_vecs = np.einsum("tl,tln->tn", mask, vec_to_landmarks_data)
    sum_sps = mask.astype(np.float64) @ landmark_sps        # (T, d)
    # Masked superposition of the in-view vector SSPs, factorised via FPE
    # additivity (phi(a+b) = phi(a) (*) phi(b), binding distributes over
    # addition):  sum_l m_tl phi(x_l - x_t)
    #           = phi(x_0 - x_t) (*) [m_t @ phi(x_l - x_0)]
    # i.e. encode L landmark offsets ONCE plus T shift rows, then one
    # masked matmul and a batched FFT bind — instead of encoding all T*L
    # displacement points (10^7 at reference scale: minutes of host time
    # and GBs of intermediates; this is the same factorisation as the
    # SLAMView adapter).
    #
    # The factorisation is exact ONLY for rigid data: every landmark's
    # displacement differs from its t=0 value by the same agent motion,
    # vec[t, l] == vec[0, l] + (vec[t, 0] - vec[0, 0]).  That holds for
    # the reference's static noise-free landmark setup (vec = obj - path,
    # run_slam.py:120); per-landmark-noisy or moving-landmark inputs break
    # it, so verify on sampled timesteps and fall back to the exact
    # per-point encode (the reference's own semantics, slam.py:470-489)
    # when the data is non-rigid.
    probe_t = np.unique(np.linspace(0, pathlen - 1, 8).astype(int))
    delta = (vec_to_landmarks_data[probe_t] - vec_to_landmarks_data[0]
             )  # (P, L, n)
    rigid = np.allclose(delta, delta[:, :1, :], atol=1e-6)
    if rigid:
        base_ssps = np.asarray(ssp_space.encode(
            vec_to_landmarks_data[0]))                      # (L, d)
        shift = np.asarray(ssp_space.encode(
            vec_to_landmarks_data[:, 0, :]
            - vec_to_landmarks_data[0, 0, :]))              # (T, d): x_0-x_t
        masked_base = mask @ base_ssps                      # (T, d)
        sum_vec_ssps = np.fft.ifft(
            np.fft.fft(shift, axis=1) * np.fft.fft(masked_base, axis=1),
            axis=1).real
    else:
        # exact path, chunked over time to bound the (chunk*L, d) encode
        sum_vec_ssps = np.empty((pathlen, d))
        chunk = max(1, 2_000_000 // max(n_landmarks * d, 1))
        for lo in range(0, pathlen, chunk):
            hi = min(lo + chunk, pathlen)
            enc = np.asarray(ssp_space.encode(
                vec_to_landmarks_data[lo:hi].reshape(-1, domain_dim)))
            enc = enc.reshape(hi - lo, n_landmarks, d)
            sum_vec_ssps[lo:hi] = np.einsum("tl,tld->td", mask[lo:hi], enc)

    from ..nef.processes import TimeTable
    velocity_func = TimeTable(vels_scaled, dt)
    landmark_vec_func = TimeTable(sum_vecs, dt)
    landmark_sp_func = TimeTable(sum_sps, dt)
    landmark_vecssp_func = TimeTable(sum_vec_ssps, dt)
    is_landmark_in_view = TimeTable(np.where(any_in_view, 0.0, 10.0), dt)

    def landmark_id_func(t):
        i = step_of(t)
        return np.where(mask[i])[0] if any_in_view[i] else None

    return (velocity_func, vel_scaling_factor, is_landmark_in_view,
            landmark_id_func, landmark_sp_func, landmark_vec_func,
            landmark_vecssp_func)


def get_anchor_input_functions(ssp_space, vec_to_landmarks_data,
                               anchor_lms, anchor_locs, view_rad, dt=0.001):
    """Beacon perception stream for the anchor gate channels.

    Given the surveyed landmark indices and their KNOWN allocentric
    positions, render the three tables the gate's absolute channels
    consume (``SLAMNetwork(anchor=True)``): per step, the nearest
    surveyed landmark within ``view_rad`` yields its surveyed position
    SSP (ground truth, not learned state), the egocentric vector SSP to
    it, and an in-view flag (0 seen / 10 not).  This deliberately stays
    OFF the model's landmark inputs: the multi-landmark adapter
    (get_slam_input_functions2) superimposes all in-view SPs, which is
    useless as an absolute reference — see the anchor section of the
    make_auto_recovery_gate_func docstring.

    Returns ``(anchor_pos_func, anchor_vecssp_func,
    no_anchor_in_view_func)`` as array-backed TimeTables.
    """
    from ..nef.processes import TimeTable
    anchor_lms = np.asarray(anchor_lms, int)
    if anchor_lms.size == 0:
        raise ValueError(
            "no surveyed landmarks: the anchor survey came up empty "
            "(no landmark was ever nearest-in-view during the survey "
            "phase) — widen view_rad, lengthen the survey window, or "
            "pass explicit anchor indices")
    sub = vec_to_landmarks_data[:, anchor_lms, :]      # (T, K, n)
    dists = np.linalg.norm(sub, axis=2)                # (T, K)
    nearest = dists.argmin(axis=1)
    rows = np.arange(len(sub))
    seen = dists[rows, nearest] <= view_rad
    vec_ssp_rows = np.asarray(ssp_space.encode(sub[rows, nearest]))
    pos_rows = np.asarray(ssp_space.encode(
        np.asarray(anchor_locs)))[nearest]             # (T, d)
    s = seen[:, None]
    return (TimeTable(np.where(s, pos_rows, 0.0).astype(np.float32), dt),
            TimeTable(np.where(s, vec_ssp_rows, 0.0).astype(np.float32),
                      dt),
            TimeTable(np.where(seen, 0.0, 10.0).astype(np.float32), dt))
