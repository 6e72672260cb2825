"""Sub-bf16 parameter storage: int8 / fp8 with per-slice scales.

The Loihi-synapse analog.  The reference's production target is 15-chip
Loihi with 8-bit synaptic weights (/root/reference/experiments/
run_slam.py:205-210 — ``n_chips: 15`` hardware options; Loihi synapses are
<=8-bit mantissa+exponent).  The rendering here: the *static* matmul
parameters (solved decoders, encoders, fixed transforms — the bulk of the
per-step device-memory traffic at scale) are
stored as int8 (or float8_e4m3) with one float32 scale per contracted
slice, and dequantised *after* the contraction:

    act @ (q * s)  ==  (act @ q) * s      when s is constant along the
                                          contracted axis

so the matmul reads 1 byte/weight from memory, multiplies in bf16 (int8 values
<= 127 are exact in bf16), accumulates in f32 (``preferred_element_type``),
and one cheap output-shaped multiply restores the scale.  The factorisation
is exact — quantisation error comes only from the int8 rounding itself
(<= 0.4% of the slice amax per weight), not from the arithmetic.

Learned state (PES decoders, Voja encoders) stays float32: it is rewritten
every step, so quantised storage would round-trip the update through the
quantiser and stall learning at the rounding floor (Loihi hits exactly this
with its 8-bit synapses; the reference compensates with learning-rate
scaling we don't need to replicate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["QTensor", "quantize", "quant_error"]


@jax.tree_util.register_pytree_node_class
class QTensor:
    """Quantised parameter: ``q`` (int8 or float8_e4m3fn) plus a float32
    scale ``s`` shaped like ``q`` with the contracted axis removed.

    ``caxis`` (static) is the axis the consuming contraction reduces over —
    encoders and fixed transforms contract their LAST axis (the input dim),
    decoders contract their second-to-last (the neuron axis).  The scale is
    the per-slice symmetric amax scale over that axis, so applying it to
    the contraction OUTPUT is exact (the output's trailing axes are the
    param's non-contracted axes, in order, for every einsum in the step)."""

    def __init__(self, q, s, caxis: int):
        self.q = q
        self.s = s
        self.caxis = int(caxis)

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def shape(self):
        return self.q.shape

    def dequant(self):
        """Full-precision reconstruction (cold paths: weights probes,
        inspection). float32."""
        s = jnp.expand_dims(jnp.asarray(self.s, jnp.float32), self.caxis)
        return self.q.astype(jnp.float32) * s

    def tree_flatten(self):
        return (self.q, self.s), self.caxis

    @classmethod
    def tree_unflatten(cls, caxis, children):
        return cls(children[0], children[1], caxis)

    def __repr__(self):
        return (f"QTensor(shape={tuple(self.q.shape)}, "
                f"dtype={self.q.dtype}, caxis={self.caxis})")


# AOT bundles (nef/export.py) trace programs whose params pytree contains
# QTensor nodes; jax.export refuses unregistered custom nodes. The auxdata
# is just the static caxis. Best-effort: older jax lacks the API.
try:
    jax.export.register_pytree_node_serialization(
        QTensor,
        serialized_name="sspslam_tpu.ops.quantize.QTensor",
        serialize_auxdata=lambda caxis: str(int(caxis)).encode(),
        deserialize_auxdata=lambda b: int(bytes(b).decode()))
except Exception:   # pragma: no cover
    pass


def _amax_scale(x, caxis, qmax):
    amax = jnp.max(jnp.abs(x), axis=caxis)
    # all-zero slices (phantom mesh-padding rows are exact zeros): scale 1
    # quantises them to exact zeros instead of dividing by zero
    return jnp.where(amax > 0, amax / qmax, 1.0).astype(jnp.float32)


def quantize(x, caxis: int, kind: str = "int8") -> QTensor:
    """Symmetric per-slice quantisation of ``x`` along every axis except
    ``caxis`` (the contraction axis, which shares one scale per slice).

    ``kind``: ``"int8"`` (round-to-nearest onto [-127, 127]) or ``"fp8"``
    (cast onto float8_e4m3fn, amax mapped to its 448 max — 4 extra
    magnitude-range bits traded for 4 mantissa bits; int8 is the better
    fit for the near-uniform NEF decoder distributions, fp8 for
    heavy-tailed ones).  Both store 1 byte/weight."""
    x = jnp.asarray(x, jnp.float32)
    caxis = caxis % x.ndim
    if kind == "int8":
        s = _amax_scale(x, caxis, 127.0)
        q = jnp.round(x / jnp.expand_dims(s, caxis))
        q = jnp.clip(q, -127, 127).astype(jnp.int8)
    elif kind == "fp8":
        s = _amax_scale(x, caxis, 448.0)
        q = (x / jnp.expand_dims(s, caxis)).astype(jnp.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantisation kind: {kind!r}")
    return QTensor(q, s, caxis)


def quant_error(x, caxis: int, kind: str = "int8") -> float:
    """Max relative reconstruction error (vs per-slice amax) — diagnostic."""
    qt = quantize(x, caxis, kind)
    x = jnp.asarray(x, jnp.float32)
    amax = jnp.max(jnp.abs(x), axis=caxis, keepdims=True)
    err = jnp.abs(qt.dequant() - x) / jnp.maximum(amax, 1e-30)
    return float(jnp.max(err))
