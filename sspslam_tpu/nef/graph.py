"""Declarative model graph: Network / Ensemble / Node / Connection / Probe.

The user-facing object model mirrors the one the reference builds its
networks from (nengo's — see e.g. reference slam.py:240-307), but it is only
a *description*: :mod:`sspslam_tpu.nef.builder` compiles a Network into a
single jitted ``step(state, inputs) -> (state, outputs)`` function run under
``lax.scan``.  Nothing here touches device memory.

Differences from nengo, chosen for a whole-step compiled program:

* ``EnsembleArray`` is first-class and compiles to *batched* (k, n, d)
  tensors — one einsum per array instead of k small matmuls.  Per-element
  transforms/recurrences use :class:`BatchedConnection`.
* ``Node`` outputs are either data (tabulated to a device array indexed by
  the step counter) or jnp-traceable ``f(t, x)`` — there are no host
  callbacks inside the hot loop.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from ..ops.neurons import LIF, NeuronType
from .distributions import Uniform, UniformHypersphere

__all__ = [
    "Network", "Ensemble", "Node", "Connection", "BatchedConnection",
    "Probe", "EnsembleArray", "ObjView", "Neurons", "LearningRule",
    "PES", "Voja", "Default",
]


class _DefaultType:
    def __repr__(self):
        return "Default"


Default = _DefaultType()

_context = threading.local()


def _ctx_stack() -> List["Network"]:
    if not hasattr(_context, "stack"):
        _context.stack = []
    return _context.stack


def _register(obj):
    stack = _ctx_stack()
    if stack:
        stack[-1]._add(obj)
    return obj


class Network:
    """Container; usable as a context manager like ``with net:``."""

    def __init__(self, label: Optional[str] = None, seed: Optional[int] = None):
        self.label = label
        self.seed = seed
        self.ensembles: List[Ensemble] = []
        self.nodes: List[Node] = []
        self.connections: List[Connection] = []
        self.probes: List[Probe] = []
        self.networks: List[Network] = []
        self.ensemble_arrays: List[EnsembleArray] = []
        _register(self)

    def _add(self, obj):
        if isinstance(obj, Ensemble):
            self.ensembles.append(obj)
        elif isinstance(obj, Node):
            self.nodes.append(obj)
        elif isinstance(obj, (Connection, BatchedConnection)):
            self.connections.append(obj)
        elif isinstance(obj, Probe):
            self.probes.append(obj)
        elif isinstance(obj, EnsembleArray):
            self.ensemble_arrays.append(obj)
        elif isinstance(obj, Network):
            self.networks.append(obj)
        else:  # pragma: no cover
            raise TypeError(f"cannot add {obj!r} to a Network")

    def __enter__(self):
        _ctx_stack().append(self)
        return self

    def __exit__(self, *exc):
        popped = _ctx_stack().pop()
        assert popped is self
        return False

    # -- traversal ----------------------------------------------------------
    def all_objects(self):
        """(ensembles, nodes, connections, probes, ensemble_arrays) incl. subnetworks."""
        ens, nodes, conns, probes, eas = [], [], [], [], []

        def rec(net):
            ens.extend(net.ensembles)
            nodes.extend(net.nodes)
            conns.extend(net.connections)
            probes.extend(net.probes)
            eas.extend(net.ensemble_arrays)
            for sub in net.networks:
                rec(sub)
            for ea in net.ensemble_arrays:
                rec(ea)  # EnsembleArray is a Network; pick up its i/o nodes

        rec(self)
        return ens, nodes, conns, probes, eas


class ObjView:
    """A slice of an Ensemble/Node used as a connection endpoint.

    Index resolution is deferred to build time: a node's slice refers to its
    *input* when used as a connection post and its *output* when used as a
    pre (sizes may differ, and function-node output sizes are only known at
    build)."""

    def __init__(self, obj, key):
        self.obj = obj
        self.key = key

    def indices_for(self, size: int) -> np.ndarray:
        if isinstance(self.key, slice):
            return np.arange(size)[self.key]
        return np.atleast_1d(np.arange(size)[self.key])

    @property
    def indices(self):
        base = self.obj
        size = base.size_out if isinstance(base, Node) else base.dimensions
        return self.indices_for(size)

    @property
    def size(self):
        return len(self.indices)

    def __repr__(self):
        return f"{self.obj}[{self.key}]"


class Neurons:
    """Direct neuron-level view of an ensemble (current injection / spikes)."""

    def __init__(self, ensemble: "Ensemble"):
        self.ensemble = ensemble

    @property
    def size_in(self):
        return self.ensemble.n_neurons

    def __repr__(self):
        return f"{self.ensemble}.neurons"


class Ensemble:
    def __init__(self, n_neurons: int, dimensions: int, radius: float = 1.0,
                 encoders=Default, intercepts=Default, max_rates=Default,
                 neuron_type: NeuronType = None, eval_points=Default,
                 n_eval_points: Optional[int] = None,
                 normalize_encoders: bool = True,
                 label: Optional[str] = None, seed: Optional[int] = None):
        self.n_neurons = int(n_neurons)
        self.dimensions = int(dimensions)
        self.radius = float(radius)
        self.encoders = encoders
        self.intercepts = Uniform(-1.0, 0.9) if intercepts is Default else intercepts
        self.max_rates = Uniform(200.0, 400.0) if max_rates is Default else max_rates
        self.neuron_type = neuron_type  # None -> network/sim default (LIF)
        self.eval_points = (UniformHypersphere(surface=False)
                            if eval_points is Default else eval_points)
        self.n_eval_points = n_eval_points
        self.normalize_encoders = normalize_encoders
        self.label = label
        self.seed = seed
        self.neurons = Neurons(self)
        _register(self)

    def __getitem__(self, key):
        return ObjView(self, key)

    def __repr__(self):
        return f"<Ensemble {self.label or hex(id(self))}>"


class Node:
    """I/O or compute node.

    output:
      * ``None`` with size_in > 0 — passthrough (sums its inputs)
      * array — constant output
      * ``f(t)`` — tabulated on the host at run start, streamed from a device
        array (no host callback in the loop)
      * ``f(t, x)`` — must be jnp-traceable; fused into the step function
    """

    def __init__(self, output=None, size_in: int = 0, size_out: Optional[int] = None,
                 label: Optional[str] = None):
        self.output = output
        self.size_in = int(size_in)
        if size_out is None:
            if output is None:
                size_out = self.size_in
            elif isinstance(output, (int, float)):
                size_out = 1
            elif isinstance(output, (list, tuple, np.ndarray)):
                size_out = np.asarray(output).size
            else:
                size_out = None  # determined by probing the callable at build
        self.size_out = size_out
        self.label = label
        _register(self)

    def __getitem__(self, key):
        return ObjView(self, key)

    def __repr__(self):
        return f"<Node {self.label or hex(id(self))}>"


class PES:
    def __init__(self, learning_rate: float = 1e-4, pre_synapse=0.005):
        self.learning_rate = learning_rate
        self.pre_synapse = pre_synapse


class Voja:
    def __init__(self, learning_rate: float = 1e-2, post_synapse=0.005):
        self.learning_rate = learning_rate
        self.post_synapse = post_synapse


class LearningRule:
    """Handle used as a connection target to feed a rule its signal
    (error for PES, gate for Voja)."""

    def __init__(self, connection: "Connection", rule):
        self.connection = connection
        self.rule = rule

    @property
    def size_in(self):
        if isinstance(self.rule, PES):
            return _endpoint_size_in(self.connection.post)
        return 1  # Voja gate

    def __repr__(self):
        return f"<LearningRule {type(self.rule).__name__}>"


def _endpoint_size_out(obj) -> int:
    if isinstance(obj, ObjView):
        return obj.size
    if isinstance(obj, Neurons):
        return obj.ensemble.n_neurons
    if isinstance(obj, Ensemble):
        return obj.dimensions
    if isinstance(obj, Node):
        if obj.size_out is None:
            raise ValueError(f"{obj} has undetermined size_out")
        return obj.size_out
    raise TypeError(f"bad endpoint {obj!r}")


def _endpoint_size_in(obj) -> int:
    if isinstance(obj, ObjView):
        return obj.size
    if isinstance(obj, Neurons):
        return obj.ensemble.n_neurons
    if isinstance(obj, Ensemble):
        return obj.dimensions
    if isinstance(obj, Node):
        return obj.size_in
    if isinstance(obj, LearningRule):
        return obj.size_in
    raise TypeError(f"bad endpoint {obj!r}")


class Connection:
    """Signal route pre -> post.

    * pre: Node / Ensemble / ObjView / Neurons
    * post: Node / Ensemble / ObjView / Neurons / LearningRule
    * function: for ensemble pre — decoded function (NumPy-evaluable on eval
      points); for node pre — jnp-traceable elementwise map.
    * transform: scalar or (post_size, pre_size) matrix, applied after
      function/decode.
    * synapse: None | tau (Lowpass) | Synapse.  Default 0.005 lowpass.
    * solver options: least-squares L2 regularisation for decoders.
    """

    def __init__(self, pre, post, transform=1.0, function: Callable = None,
                 synapse=0.005, learning_rule_type=None,
                 eval_points=None, solver_reg: float = 0.1,
                 solver_weights: bool = False,
                 label: Optional[str] = None):
        self.pre = pre
        self.post = post
        self.transform = transform
        self.function = function
        self.synapse = synapse
        self.learning_rule_type = learning_rule_type
        self.eval_points = eval_points
        self.solver_reg = solver_reg
        self.solver_weights = solver_weights
        self.label = label
        self.learning_rule = (LearningRule(self, learning_rule_type)
                              if learning_rule_type is not None else None)
        _register(self)

    def __repr__(self):
        return f"<Connection {self.pre} -> {self.post}>"


class BatchedConnection:
    """Per-element connection into/out of an EnsembleArray with distinct
    weights per element, kept batched (one einsum per step).

    * pre -> EnsembleArray with transforms (k, ens_dim, pre_size): element j
      receives transforms[j] @ pre_value.
    * EnsembleArray -> EnsembleArray (recurrent) with a decoded ``function``
      per element: decoders solved per element (vmapped lstsq), applied as a
      batched einsum.  ``element_mask`` (k,) optionally zeroes specific
      elements' contributions (e.g. the DC oscillator).
    """

    def __init__(self, pre, post, transforms=None, function=None,
                 synapse=0.005, element_mask=None, solver_reg: float = 0.1,
                 solver_weights: bool = False,
                 label: Optional[str] = None):
        self.pre = pre
        self.post = post
        self.transforms = None if transforms is None else np.asarray(transforms)
        self.function = function
        self.synapse = synapse
        self.element_mask = element_mask
        self.solver_reg = solver_reg
        self.solver_weights = solver_weights
        self.label = label
        self.learning_rule = None
        _register(self)

    def __repr__(self):
        return f"<BatchedConnection {self.pre} -> {self.post}>"


class Probe:
    """Record a signal over time.

    target: Node / Ensemble (decoded) / Neurons (activities) / Connection
    (attr='weights' for learned decoders) / LearningRule (attr='scaled_encoders').
    """

    def __init__(self, target, attr: Optional[str] = None, synapse=None,
                 sample_every: Optional[float] = None, label: Optional[str] = None):
        self.target = target
        self.attr = attr
        self.synapse = synapse
        self.sample_every = sample_every
        self.label = label
        _register(self)

    def __repr__(self):
        return f"<Probe of {self.target}>"


class EnsembleArray(Network):
    """k identical ensembles compiled to batched (k, n, d) tensors.

    API parity with nengo.networks.EnsembleArray (used throughout the
    reference, e.g. pathintegration.py:162-167): ``input``, ``output``,
    ``ea_ensembles`` (element views), ``add_output(name, function)``.
    """

    def __init__(self, n_neurons: int, n_ensembles: int, ens_dimensions: int = 1,
                 radius: float = 1.0, encoders=Default, intercepts=Default,
                 max_rates=Default, neuron_type: NeuronType = None,
                 label: Optional[str] = None, seed: Optional[int] = None,
                 **ens_kwargs):
        super().__init__(label=label, seed=seed)
        self.n_neurons_per = int(n_neurons)
        self.n_ensembles = int(n_ensembles)
        self.ens_dimensions = int(ens_dimensions)
        self.radius = float(radius)
        with self:
            self.input = Node(size_in=n_ensembles * ens_dimensions,
                              label=f"{label}_input" if label else None)
            self.output = Node(size_in=n_ensembles * ens_dimensions,
                               label=f"{label}_output" if label else None)
            # One prototype Ensemble carries the parameter spec; the builder
            # expands it to batched (k, n, d) parameters.
            self._proto = Ensemble(
                n_neurons, ens_dimensions, radius=radius, encoders=encoders,
                intercepts=intercepts, max_rates=max_rates,
                neuron_type=neuron_type, label=f"{label}_proto" if label else None,
                seed=seed, **ens_kwargs)
        # element views for per-element wiring
        self.ea_ensembles = [EAElement(self, j) for j in range(n_ensembles)]
        self._outputs = {}  # name -> (function, out_dim)
        self.neurons = Neurons(self)  # flat view over all k*n neurons

    @property
    def n_neurons(self):
        return self.n_ensembles * self.n_neurons_per

    def add_output(self, name: str, function, out_dim: Optional[int] = None,
                   solver_reg: float = 0.1):
        """Register a decoded output ``function`` applied per element;
        returns a Node carrying the concatenated (k * out_dim) signal."""
        if out_dim is None:
            test = np.asarray(function(np.zeros(self.ens_dimensions)))
            out_dim = test.size
        with self:
            node = Node(size_in=self.n_ensembles * out_dim,
                        label=f"{self.label}_{name}" if self.label else name)
        self._outputs[name] = (function, out_dim, node, solver_reg)
        setattr(self, name, node)
        return node


class EAElement:
    """View of one element of an EnsembleArray (for per-element endpoints)."""

    def __init__(self, ea: EnsembleArray, index: int):
        self.ea = ea
        self.index = index
        self.dimensions = ea.ens_dimensions
        self.n_neurons = ea.n_neurons_per

    def __getitem__(self, key):
        return ObjView(self, key)

    def __repr__(self):
        return f"<EAElement {self.ea.label}[{self.index}]>"
