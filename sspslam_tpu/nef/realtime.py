"""Closed-loop (robot-in-the-loop) stepping: host code in the sensory loop.

In the reference stack, any ``nengo.Node`` may run arbitrary host Python
each dt — controllers, robot drivers, loggers — because the CPU simulator
calls back into Python every step (the reference wires its models from such
nodes, e.g. velocity/view inputs at
``/root/reference/experiments/run_slam.py:151-170``).  On an accelerator
that design is untenable: a host callback per dt forces a device round trip
every millisecond of simulated time, five orders of magnitude slower than
the compiled step.

The compiled-step replacement is TICK-GRANULAR exchange: the device
integrates a short fixed chunk of steps (one compiled, carry-donating
program, reused forever), then the host reads the decoded probes and
supplies the next chunk of inputs.  Control loops in robotics run at
10-100 Hz against a 1 kHz neural dt, so a 10-100 step tick matches the
physical architecture: the neural model IS the fast inner loop, the host
controller the slow outer one.

    session = ClosedLoopSession(sim, live_inputs=[vel], outputs=[p_out],
                                tick_steps=20)
    while not done:
        out = session.tick({vel: controller(est)})   # (20, d) per probe
        est = out[p_out][-1]

Everything not marked live keeps its build-time behavior (TimeTable /
function-of-time tabulation).  State (neurons, filters, learned PES/Voja
weights) carries across ticks bitwise-identically to an uninterrupted run —
the tick program is the same compiled segment ``run_steps`` uses.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np

from .graph import Node, Probe

__all__ = ["ClosedLoopSession"]


class ClosedLoopSession:
    """Step a built :class:`Simulator` in fixed ticks with host-supplied
    inputs.

    Parameters
    ----------
    sim : Simulator
        A built simulator.  The session advances ``sim.state`` /
        ``sim.n_steps`` in place; interleaving with ``sim.run_steps`` is
        allowed (e.g. an open-loop warm-up before closing the loop).
    live_inputs : sequence of Node, optional
        Input nodes the host will supply each tick.  Nodes omitted here
        keep their tabulated (TimeTable / f(t)) behavior.  Defaults to
        ALL input nodes.
    outputs : sequence of Probe, optional
        Dense probes returned from :meth:`tick`.  Defaults to all dense
        probes.  Probe synapses carry across ticks (their filter state
        lives in the scan carry).
    tick_steps : int
        Simulation steps per tick (dt units).  One executable per value.
    record : bool
        Also append tick emissions to ``sim``'s probe buffers so
        ``sim.data[probe]`` afterwards covers the closed-loop run (dense
        full-rate probes only; dense SUBSAMPLED probes are not recorded
        across ticks — probe at full rate or use :meth:`tick` outputs).
        Sparse (weights/encoders) probes are snapshotted independently of
        ``record``: whenever a tick crosses their sample period, the
        snapshot is taken at the tick boundary and the true step recorded
        (tick windows need not align with the period).
    """

    def __init__(self, sim, live_inputs: Optional[Sequence[Node]] = None,
                 outputs: Optional[Sequence[Probe]] = None,
                 tick_steps: int = 10, record: bool = False):
        self.sim = sim
        self.tick_steps = int(tick_steps)
        if self.tick_steps < 1:
            raise ValueError("tick_steps must be >= 1")
        self.record = record
        model = sim.model
        if live_inputs is None:
            live = list(model.input_nodes)
        else:
            live = list(live_inputs)
        known = {id(n) for n in model.input_nodes}
        for n in live:
            if id(n) not in known:
                raise ValueError(f"{n} is not an input node of this model "
                                 "(only function-of-time / TimeTable nodes "
                                 "can be driven live)")
        self._live_ids = {id(n) for n in live}
        self._splits = sim._input_splits()
        self._nodes = list(model.input_nodes)

        if outputs is None:
            self._out_probes = [bp for bp in model.probes if not bp.sparse]
        else:
            by_obj = {id(bp.obj): bp for bp in model.probes}
            self._out_probes = []
            for p in outputs:
                bp = by_obj.get(id(p))
                if bp is None:
                    raise ValueError(f"{p} is not a probe of this model")
                if bp.sparse:
                    raise ValueError(
                        "sparse (weights/encoders) probes cannot be tick "
                        "outputs; they are snapshotted automatically when a "
                        "tick crosses their sample period — read "
                        "sim.data[probe] after the run")
                self._out_probes.append(bp)
        # sparse probes are snapshotted at most once per tick (the carry
        # only exists at tick boundaries) — a period shorter than the tick
        # therefore yields fewer samples than an uninterrupted run_steps
        # would record; say so once up front rather than dropping silently
        fast = [bp for bp in model.probes
                if bp.sparse and bp.period_steps < self.tick_steps]
        if fast:
            import warnings
            warnings.warn(
                f"{len(fast)} sparse probe(s) have sample periods shorter "
                f"than tick_steps={self.tick_steps}: closed-loop ticks "
                "snapshot at most once per tick (at the tick-end step), so "
                "they will record fewer samples than run_steps would; "
                "shorten tick_steps or lengthen sample_every for a full "
                "sample grid", stacklevel=2)
        self._run = sim._get_scan(self.tick_steps)

    # ------------------------------------------------------------------
    def compile(self) -> None:
        """Warm the tick executable outside any latency-sensitive region
        (first compile costs seconds-to-minutes on remote backends).

        Warms the HOST-xs program :meth:`tick` actually runs — not
        ``Simulator.compile``, which after ``preload_inputs`` would warm
        the device-table program (a different executable) and leave the
        first tick to compile inside the control loop."""
        sim, seg = self.sim, self.tick_steps
        state = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                       sim.model.initial_state())
        width = self._splits[-1][1] if self._splits else 0
        xs = np.zeros((seg, width), np.float32)
        out_state, _ = self._run(state, xs, sim.params)
        jax.block_until_ready(out_state)
        np.asarray(out_state["step"])   # real barrier (see Simulator.sync)

    @property
    def t(self) -> float:
        """Current simulation time (end of the last tick)."""
        return self.sim.n_steps * self.sim.dt

    def _pack_tick(self, inputs: Dict[Node, np.ndarray]) -> np.ndarray:
        sim, seg = self.sim, self.tick_steps
        for n in inputs:
            if id(n) not in self._live_ids:
                raise ValueError(f"{n} was not declared in live_inputs")
        width = self._splits[-1][1] if self._splits else 0
        xs = np.empty((seg, width), np.float32)
        tabulated = None
        for i, (node, (a, b)) in enumerate(zip(self._nodes, self._splits)):
            if id(node) in self._live_ids:
                if node not in inputs:
                    raise ValueError(f"live input {node} missing from tick()")
                v = np.asarray(inputs[node], np.float32)
                if v.ndim <= 1:           # constant over the tick
                    xs[:, a:b] = v.reshape(1, -1)
                else:                     # per-step rows (seg, size)
                    if v.shape != (seg, b - a):
                        raise ValueError(
                            f"input for {node}: expected shape ({seg}, "
                            f"{b - a}) or ({b - a},), got {v.shape}")
                    xs[:, a:b] = v
            else:
                if tabulated is None:
                    # tabulate only the NON-live nodes for this window (the
                    # live nodes' build-time outputs may be per-step Python
                    # callables — evaluating them just to overwrite the
                    # columns would put host work back in the control loop)
                    tabulated = sim._tabulate_inputs(
                        seg, only=set(id(n) for n in self._nodes)
                        - self._live_ids)
                xs[:, a:b] = tabulated[i]
        return xs

    def tick(self, inputs: Optional[Dict[Node, np.ndarray]] = None
             ) -> Dict[Probe, np.ndarray]:
        """Advance ``tick_steps`` steps and return the decoded outputs.

        ``inputs[node]`` is either a ``(size,)`` vector held constant over
        the tick (zero-order hold, the usual controller output) or a
        ``(tick_steps, size)`` array of per-dt rows.  Returns
        ``{probe: (tick_steps, d) ndarray}`` — the conversion to numpy is
        the device->host pull and therefore the real synchronisation point
        of the loop.
        """
        sim, seg = self.sim, self.tick_steps
        xs = self._pack_tick(inputs or {})
        sim.state, emits = self._run(sim.state, xs, sim.params)
        cum = sim.n_steps
        sim.n_steps += seg
        if getattr(sim, "_preloaded", None) is not None:
            # any preloaded table is now misaligned with the step counter
            sim._preloaded = None
            sim._preloaded_dev = None
        # sparse (weights/encoders) probes: tick windows need not align with
        # the sample period, and the snapshot is read from the carry (it
        # only exists "now") — so when this tick CROSSED a period boundary,
        # snapshot at the tick end and record the true step, rather than
        # silently dropping the sample forever
        for bp in sim.model.probes:
            if bp.sparse and (cum // bp.period_steps
                              != (cum + seg) // bp.period_steps):
                from .executor import sparse_probe_value
                sim._probe_data[bp.index].append(
                    sparse_probe_value(sim.model, sim.state, bp)[None])
                sim._sparse_steps[bp.index].append(cum + seg)
        out = {bp.obj: np.asarray(emits[bp.index]) for bp in self._out_probes}
        if self.record:
            for bp in sim.model.probes:
                if not bp.sparse and bp.period_steps == 1:
                    sim._probe_data[bp.index].append(emits[bp.index])
        return out
