"""Fixed-dt simulator: tabulate inputs, jit the step, scan over time.

Replaces the external backend layer the reference selects at
run_slam.py:198-210 (nengo.Simulator / nengo_ocl / nengo_loihi).  The whole
simulation — including gates, clean-ups and learning — runs on device;
the host only supplies pre-tabulated input arrays and collects probe data.

The run is split into segments (one compiled ``lax.scan`` reused across
segments) so that sparse probes (learned-weight snapshots with large
``sample_every``) are read from the carry at segment boundaries instead of
being materialised every step, and so progress can be reported.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .builder import Model, build
from .executor import build_params, make_step_fn, sparse_probe_value
from .graph import Network, Probe

__all__ = ["Simulator"]


#: compile cache used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: directory inside the checkout (gitignored), so every process of one
#: checkout shares the compiled scan programs
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _enable_compilation_cache():
    """Persistent compilation cache: scan-step compiles are the bulk of a
    cold run and fully cacheable across processes.  The cache dir JAX is
    configured with (JAX reads JAX_COMPILATION_CACHE_DIR when it is
    imported) when there is one, else :data:`DEFAULT_CACHE_DIR`."""
    jax.config.update("jax_compilation_cache_dir",
                      jax.config.jax_compilation_cache_dir
                      or DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


class Simulator:
    """``mesh``: an optional ``jax.sharding.Mesh`` — the carry is annotated
    with model-parallel shardings (VCO/neuron axes) and the scan jitted over
    the mesh, letting GSPMD partition the step across chips."""

    def __init__(self, network: Network, dt: float = 0.001,
                 seed: Optional[int] = None, default_neuron_type=None,
                 progress: bool = False, dtype=jnp.float32, mesh=None,
                 scan_unroll: int = 4, fuse_ensembles: bool = True,
                 matmul_dtype=None):
        _enable_compilation_cache()
        self.scan_unroll = scan_unroll
        self.dt = float(dt)
        self.progress = progress
        # under a model-parallel mesh, pad batched element axes to mesh
        # multiples so GSPMD shards them evenly (phantom rows are exact
        # zeros; see builder.build pad_batched_to)
        pad = 1
        if mesh is not None and "model" in getattr(mesh, "shape", {}):
            pad = int(mesh.shape["model"])
        self.model: Model = build(network, dt=dt, seed=seed,
                                  default_neuron_type=default_neuron_type,
                                  fuse_ensembles=fuse_ensembles,
                                  pad_batched_to=pad)
        self._step_fn = make_step_fn(self.model, dtype=dtype,
                                     matmul_dtype=matmul_dtype)
        # device-resident once: passing host arrays would re-transfer the
        # whole parameter set on every segment call
        self.params = jax.device_put(
            build_params(self.model, matmul_dtype=matmul_dtype))
        self._scan_cache: Dict[int, callable] = {}
        self._preloaded = None       # see preload_inputs()
        self._preloaded_dev = None   # device-resident packed table
        self.mesh = mesh
        self.state = self.model.initial_state()
        if mesh is not None:
            from ..parallel.sharding import shard_state
            self.state = shard_state(self.model, self.state, mesh)
        self.dtype = dtype
        self.n_steps = 0
        # global step at which the dense probe buffers begin — stays 0
        # unless a checkpoint is loaded into a probe-empty simulator, and
        # is what makes repeated load_checkpoint rewinds count buffered
        # rows correctly (rows buffered = samples in (_data_start, now])
        self._data_start = 0
        self._probe_data: Dict[int, list] = {bp.index: []
                                             for bp in self.model.probes}
        self._sparse_steps: Dict[int, list] = {bp.index: []
                                               for bp in self.model.probes}

    # ------------------------------------------------------------------
    def _tabulate_inputs(self, n_steps: int, only=None) -> list:
        """Evaluate f(t)-only nodes for every step on the host, once.

        Returns host ndarrays: segment slicing happens on the host (free)
        and the jitted call transfers each slice — eagerly slicing device
        arrays would compile a fresh eager op per distinct offset.

        ``only``: optional set of node ids — nodes outside it yield ``None``
        (ClosedLoopSession overwrites live-node columns anyway and must not
        pay for evaluating their build-time callables per tick)."""
        from .processes import TimeTable
        cols = []
        for node in self.model.input_nodes:
            if only is not None and id(node) not in only:
                cols.append(None)
                continue
            f = node.output
            if isinstance(f, TimeTable):
                if abs(f.dt - self.dt) < 1e-9 * self.dt:
                    # array-backed node at the simulator dt: slice, don't loop
                    cols.append(f.rows(self.n_steps, n_steps))
                else:
                    # table recorded at a different dt (e.g. 20 ms trajectory
                    # data): vectorised version of __call__'s t -> row map
                    ts = (self.n_steps + np.arange(1, n_steps + 1)) * self.dt
                    idx = np.clip(np.round((ts - f.dt) / f.dt).astype(int),
                                  0, len(f.values) - 1)
                    cols.append(f.values[idx])
                continue
            t0 = self.n_steps * self.dt
            vals = np.empty((n_steps, node.size_out), dtype=np.float32)
            for i in range(n_steps):
                vals[i] = np.asarray(f(t0 + (i + 1) * self.dt),
                                     dtype=np.float32).reshape(-1)
            cols.append(vals)
        return cols

    def _input_splits(self):
        """Static column offsets of each input node in the packed xs table."""
        sizes = [n.size_out for n in self.model.input_nodes]
        offs = np.cumsum([0] + sizes)
        return [(int(offs[i]), int(offs[i + 1])) for i in range(len(sizes))]

    def _jit_segment(self, fn, n_rep_args: int):
        """jit a segment runner ``fn(state, *aux, params)`` with the
        mesh's shardings (state sharded, ``n_rep_args`` aux args
        replicated, params per their own rule) — or a plain donate-state
        jit off-mesh.  Shared by all three scan variants."""
        if self.mesh is not None:
            from ..parallel.sharding import (params_shardings, replicated,
                                             state_shardings)
            sh = state_shardings(self.model, self.mesh)
            rep = replicated(self.mesh)
            params_sh = params_shardings(self.params, self.mesh,
                                         model=self.model)
            return jax.jit(fn,
                           in_shardings=(sh,) + (rep,) * n_rep_args
                           + (params_sh,),
                           donate_argnums=0)
        return jax.jit(fn, donate_argnums=0)

    def _get_scan(self, seg_len: int):
        if seg_len not in self._scan_cache:
            step = self._step_fn
            splits = self._input_splits()

            unroll = max(1, min(self.scan_unroll, seg_len))

            def run_segment(state, xs_packed, params):
                # ONE packed (seg, sum_sizes) input arg instead of one arg
                # per node: one host->device transfer per segment.  The
                # static column split fuses into the scan at zero cost.
                xs_cols = [xs_packed[:, a:b] for a, b in splits]

                def body(carry, xs):
                    return step(carry, xs, params)
                # unrolling the scan body amortises per-iteration loop
                # overhead
                return jax.lax.scan(body, state, xs_cols, length=seg_len,
                                    unroll=unroll)

            self._scan_cache[seg_len] = self._jit_segment(run_segment, 1)
        return self._scan_cache[seg_len]

    def _get_scan_dev(self, seg_len: int):
        """Compiled segment consuming a DEVICE-RESIDENT full input table
        plus a traced start offset: the per-segment ``dynamic_slice``
        happens on device, so a chained run dispatches each segment with
        ZERO host->device input transfer (the packed table uploads once in
        :meth:`preload_inputs`).  One executable serves every offset —
        unlike the eager device-side slicing design (see preload_inputs
        design note), the offset is data, not a new program."""
        key = ("dev", seg_len)
        if key not in self._scan_cache:
            step = self._step_fn
            splits = self._input_splits()
            unroll = max(1, min(self.scan_unroll, seg_len))

            def run_segment_dev(state, table, start, params):
                xs_packed = jax.lax.dynamic_slice_in_dim(
                    table, start, seg_len, axis=0)
                xs_cols = [xs_packed[:, a:b] for a, b in splits]

                def body(carry, xs):
                    return step(carry, xs, params)
                return jax.lax.scan(body, state, xs_cols, length=seg_len,
                                    unroll=unroll)

            self._scan_cache[key] = self._jit_segment(run_segment_dev, 2)
        return self._scan_cache[key]

    def _get_scan_dev_chained(self, seg_len: int, n_chain: int):
        """``n_chain`` compiled segments chained inside ONE jitted call
        (scan of scans) over the device-resident table: a 50k-step timed
        block becomes a single dispatch instead of ``n_chain``, removing
        the per-call host overhead.  Emits are
        returned reshaped to ``(n_chain * seg_len, ...)`` so callers treat
        the block as one long segment (same thinning arithmetic)."""
        key = ("devchain", seg_len, n_chain)
        if key not in self._scan_cache:
            step = self._step_fn
            splits = self._input_splits()
            unroll = max(1, min(self.scan_unroll, seg_len))

            def run_chained(state, table, start, params):
                def outer(carry, i):
                    xs_packed = jax.lax.dynamic_slice_in_dim(
                        table, start + i * seg_len, seg_len, axis=0)
                    xs_cols = [xs_packed[:, a:b] for a, b in splits]

                    def body(c, xs):
                        return step(c, xs, params)
                    return jax.lax.scan(body, carry, xs_cols,
                                        length=seg_len, unroll=unroll)
                state2, emits = jax.lax.scan(
                    outer, state, jnp.arange(n_chain, dtype=jnp.int32))
                emits = {k: v.reshape((n_chain * seg_len,) + v.shape[2:])
                         for k, v in emits.items()}
                return state2, emits

            self._scan_cache[key] = self._jit_segment(run_chained, 2)
        return self._scan_cache[key]

    # ------------------------------------------------------------------
    def preload_inputs(self, n_steps: int, device: bool = True) -> None:
        """Tabulate the input tables for the next ``n_steps`` simulation
        steps ONCE, packed into a single host array, and (by default)
        upload the whole table to the device.  ``run_steps`` then consumes
        the device table through a compiled ``dynamic_slice`` with a
        TRACED start offset — each chained segment dispatches with zero
        host->device input transfer, and one executable serves every
        offset.  Steps past the preloaded horizon repeat the last row,
        matching :meth:`processes.TimeTable` clamp semantics.

        Design note: an earlier (round-2) version device_put the tables
        and carved segments EAGERLY on the device: every distinct offset
        was a fresh eager program, and committed device arrays made the
        scan executable layout-specialised, missing the persistent
        compilation cache.  The traced-offset design has neither problem —
        the offset is data, the table an ordinary uncommitted argument.
        The host copy is kept: segments that overrun the device table (or
        ``device=False``) take the per-call packed-argument path.

        Table rows are padded up to a 10k multiple so different run
        lengths of the same model reuse one compiled (table-shape,
        segment) program."""
        pad = self.DEFAULT_SEGMENT_STEPS
        packed = self._pack_cols(self._tabulate_inputs(n_steps))
        self._preloaded = np.concatenate(
            [packed, np.repeat(packed[-1:], pad, axis=0)])
        self._preload_start = self.n_steps
        self._preloaded_dev = None
        if device and self._preloaded.shape[1] > 0:
            rows = self._preloaded.shape[0]
            bucket = int(math.ceil(rows / 10000.0) * 10000)
            tbl = self._preloaded
            if bucket > rows:
                tbl = np.concatenate(
                    [tbl, np.repeat(tbl[-1:], bucket - rows, axis=0)])
            self._preloaded_dev = jax.device_put(tbl)

    @staticmethod
    def _pack_cols(cols) -> np.ndarray:
        if not cols:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(
            [np.asarray(c, np.float32) for c in cols], axis=1)

    # ------------------------------------------------------------------
    def sync(self) -> int:
        """Wait for all dispatched simulation work to finish and return
        the completed step count (read back from the carry).  Call this
        before stopping a wall-clock timer."""
        jax.block_until_ready(self.state)
        return int(np.asarray(self.state["step"]))

    def run(self, t_sim: float, segment_steps: Optional[int] = None):
        self.run_steps(int(round(t_sim / self.dt)), segment_steps=segment_steps)

    def compile(self, n_steps: Optional[int] = None,
                segment_steps: Optional[int] = None) -> None:
        """Warm the compiled segment program(s) a run of ``n_steps`` will
        use, WITHOUT advancing the simulation.  Calling this before the
        timed region keeps ``run``'s wall time a measurement of simulation
        (compilation excluded), the
        way the reference's (untimed) nengo build precedes its timed
        ``sim.run``.  Runs each program once on a throwaway copy of the
        initial state."""
        segs = []
        if segment_steps is None:
            segment_steps = self._default_segment_steps(
                n_steps if n_steps is not None else self.DEFAULT_SEGMENT_STEPS)
        if n_steps is None:
            segs = [segment_steps]
        else:
            segment_steps = min(segment_steps, n_steps)
            segs = [segment_steps]
            rem = n_steps % segment_steps
            if rem:
                segs.append(rem)
        width = sum(n.size_out for n in self.model.input_nodes)
        for seg in segs:
            state = jax.tree_util.tree_map(
                lambda x: np.array(x, copy=True),
                self.model.initial_state())
            if self._preloaded_dev is not None:
                # a preloaded run consumes the DEVICE-table program
                # (different cache key / executable than the host-xs one);
                # warm that, or the scan compile lands in the timed region
                run_segment = self._get_scan_dev(seg)
                out_state, _ = run_segment(state, self._preloaded_dev,
                                           np.int32(0), self.params)
            else:
                run_segment = self._get_scan(seg)
                xs = np.zeros((seg, width), np.float32)
                out_state, _ = run_segment(state, xs, self.params)
            jax.block_until_ready(out_state)

    #: default upper bound on the compiled scan length — scan compile time
    #: grows with length, while the compiled segment is reused across calls
    #: (and across processes via the persistent compilation cache)
    DEFAULT_SEGMENT_STEPS = 1000

    def _default_segment_steps(self, n_steps: int) -> int:
        sparse = [bp for bp in self.model.probes if bp.sparse]
        if sparse:
            segment_steps = math.gcd(*[bp.period_steps for bp in sparse])
            # keep sparse periods intact but split huge segments into
            # bounded chunks when the period allows it
            while (segment_steps > 2 * self.DEFAULT_SEGMENT_STEPS
                   and segment_steps % 2 == 0):
                segment_steps //= 2
        else:
            segment_steps = self.DEFAULT_SEGMENT_STEPS
        return min(segment_steps, n_steps)

    def run_steps(self, n_steps: int, segment_steps: Optional[int] = None,
                  chain: bool = False):
        """Advance ``n_steps``.  ``chain=True`` additionally fuses whole
        multiples of ``segment_steps`` into one jitted scan-of-scans
        dispatch when the device-resident input table covers them (see
        :meth:`_get_scan_dev_chained`) — opt-in because each distinct
        (segment, multiple) pair is a fresh compile; benchmarks and long
        production runs with a fixed block size are the intended users."""
        model = self.model
        if segment_steps is None:
            segment_steps = self._default_segment_steps(n_steps)
        if getattr(self, "_preloaded", None) is not None:
            packed = self._preloaded
            base = self.n_steps - self._preload_start
        else:
            packed = self._pack_cols(self._tabulate_inputs(n_steps))
            base = 0
        if packed.shape[1] == 0:
            packed = np.zeros((n_steps + base, 0), np.float32)

        dev_table = getattr(self, "_preloaded_dev", None)
        sparse_periods = [bp.period_steps for bp in model.probes if bp.sparse]
        done = 0
        t_start = time.time()
        while done < n_steps:
            seg = min(segment_steps, n_steps - done)
            cum = self.n_steps + done
            if sparse_periods:
                # clip the segment so every sparse-probe sample time becomes
                # a segment boundary — chained runs or explicit segment
                # lengths that don't divide the period would otherwise skip
                # samples silently (the snapshot is read from the carry, so
                # it only exists at boundaries).  Each distinct clipped
                # length is a separate scan compile; the set of lengths is
                # the gaps between consecutive period boundaries (bounded,
                # small for realistic sample_every; one length when a
                # single period divides segment_steps) and each compile is
                # amortised by the persistent compilation cache.  Pick
                # sample_every dividing segment_steps to avoid clipping
                # entirely.
                to_next = min((p - cum % p) or p for p in sparse_periods)
                seg = min(seg, to_next)
            lo = base + done
            emits = None
            if (chain and not sparse_periods and dev_table is not None
                    and seg == segment_steps):
                # chain every whole remaining segment the table covers
                # into one dispatch; emits come back (n_chain*seg, ...) so
                # the shared probe bookkeeping below treats the block as
                # one long segment
                n_chain = min((n_steps - done) // seg,
                              (dev_table.shape[0] - lo) // seg)
                if n_chain > 1:
                    run_chained = self._get_scan_dev_chained(seg, n_chain)
                    self.state, emits = run_chained(
                        self.state, dev_table, np.int32(lo), self.params)
                    seg = seg * n_chain
            if emits is not None:
                pass
            elif dev_table is not None and lo + seg <= dev_table.shape[0]:
                # device-resident table: compiled dynamic_slice, no input
                # upload per segment
                run_segment = self._get_scan_dev(seg)
                self.state, emits = run_segment(
                    self.state, dev_table, np.int32(lo), self.params)
            else:
                xs = packed[lo:lo + seg]
                if xs.shape[0] < seg:
                    # past the tabulated horizon: repeat the last available
                    # row (TimeTable clamp semantics) instead of shifting
                    # the window back into stale earlier rows
                    last = xs[-1:] if xs.shape[0] else packed[-1:]
                    xs = np.concatenate(
                        [xs, np.repeat(last, seg - xs.shape[0], axis=0)])
                run_segment = self._get_scan(seg)
                self.state, emits = run_segment(self.state, xs, self.params)
            for bp in model.probes:
                if bp.sparse:
                    if (cum + seg) % bp.period_steps == 0:
                        self._probe_data[bp.index].append(
                            sparse_probe_value(model, self.state, bp)[None])
                        self._sparse_steps[bp.index].append(cum + seg)
                else:
                    e = emits[bp.index]
                    if bp.period_steps > 1:
                        # thin subsampled dense probes per segment (device
                        # slice): row j is step cum+j+1; keep steps that are
                        # period multiples.  Retaining the full buffer would
                        # hold period x the needed HBM until probe_data()
                        phase = (bp.period_steps - 1
                                 - cum % bp.period_steps) % bp.period_steps
                        e = e[phase::bp.period_steps]
                    # keep the device buffer; conversion happens lazily in
                    # probe_data() so segments pipeline without a blocking
                    # device->host transfer each
                    self._probe_data[bp.index].append(e)
            done += seg
            if self.progress:
                el = time.time() - t_start
                print(f"\r  sim {done}/{n_steps} steps "
                      f"({done / max(el, 1e-9):.0f} steps/s)", end="",
                      flush=True)
        if self.progress:
            print()
        self.n_steps += n_steps

    # ------------------------------------------------------------------
    @property
    def data(self):
        return _ProbeData(self)

    def trange(self, sample_every: Optional[float] = None):
        # integer stride arithmetic, matching the probes' row subsampling —
        # float division truncates one point short for many (n_steps,
        # sample_every) pairs (e.g. 1170 steps at 0.01)
        period = (1 if sample_every is None
                  else max(1, int(round(sample_every / self.dt))))
        n = self.n_steps // period
        return (self.dt * period) * np.arange(1, n + 1)

    def probe_data(self, probe: Probe) -> np.ndarray:
        bp = next(p for p in self.model.probes if p.obj is probe)
        chunks = self._probe_data[bp.index]
        if not chunks:
            return np.zeros((0,) + bp.shape)
        # dense subsampled probes are already thinned per segment in
        # run_steps (with global-step phase), sparse ones snapshot at
        # boundaries — chunks concatenate directly
        return np.concatenate([np.asarray(c) for c in chunks], axis=0)

    def reset(self):
        self.state = self.model.initial_state()
        self.n_steps = 0
        self._data_start = 0
        self._preloaded = None
        self._preloaded_dev = None
        for k in self._probe_data:
            self._probe_data[k] = []
        for k in self._sparse_steps:
            self._sparse_steps[k] = []

    # -- checkpoint / resume -------------------------------------------
    # The entire simulation state (neuron dynamics, synapse filters, learned
    # PES decoders and Voja encoders) is the scan carry, so checkpointing is
    # carry serialisation; resuming continues bitwise-identically.
    def save_checkpoint(self, path: str):
        leaves, treedef = jax.tree_util.tree_flatten(self.state)
        np.savez(path,
                 n_steps=self.n_steps,
                 n_leaves=len(leaves),
                 **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})

    def load_checkpoint(self, path: str):
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"   # np.savez appends the suffix save-side
        _, treedef = jax.tree_util.tree_flatten(self.model.initial_state())
        with np.load(path) as f:
            n = int(f["n_leaves"])
            leaves = [f[f"leaf_{i}"] for i in range(n)]
            self.n_steps = int(f["n_steps"])
        self.state = jax.tree_util.tree_unflatten(treedef, leaves)
        # any preloaded input table was tabulated relative to the previous
        # step counter; drop it so run_steps re-tabulates from the restored
        # position instead of feeding misaligned rows
        self._preloaded = None
        self._preloaded_dev = None
        # rewinding past steps already simulated in THIS process must also
        # rewind the probe buffers, or data[] mixes two divergent timelines.
        # Buffered dense rows cover the samples in (_data_start, previous
        # now] — count kept rows relative to _data_start, NOT step 0, or a
        # session that itself began from a loaded checkpoint keeps stale
        # divergent rows on a second load.
        start = self._data_start
        if self.n_steps < start:
            # rewound to before this process's buffers began: nothing
            # buffered can be kept (those samples were never recorded here)
            for bp in self.model.probes:
                self._probe_data[bp.index] = []
                self._sparse_steps[bp.index] = []
            self._data_start = self.n_steps
            return
        if all(not self._probe_data[bp.index]
               for bp in self.model.probes if not bp.sparse):
            # probe-empty simulator (fresh, or just reset): buffers will
            # begin at the restored step
            self._data_start = self.n_steps
        for bp in self.model.probes:
            if bp.sparse:
                keep = [i for i, s in enumerate(self._sparse_steps[bp.index])
                        if s <= self.n_steps]
                self._probe_data[bp.index] = [
                    self._probe_data[bp.index][i] for i in keep]
                self._sparse_steps[bp.index] = [
                    self._sparse_steps[bp.index][i] for i in keep]
            elif self._probe_data[bp.index]:
                p = bp.period_steps
                rows = self.n_steps // p - start // p
                full = np.concatenate(
                    [np.asarray(c) for c in self._probe_data[bp.index]],
                    axis=0)
                self._probe_data[bp.index] = [full[:rows]]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _ProbeData:
    def __init__(self, sim: Simulator):
        self._sim = sim

    def __getitem__(self, probe: Probe) -> np.ndarray:
        return self._sim.probe_data(probe)
