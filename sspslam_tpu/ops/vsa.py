"""Vector-symbolic-algebra primitives (pure jnp, jit-safe).

Fractional-power SSP encoding, circular-convolution binding, unbinding,
clean-up, and the fixed linear transforms used by the neural binding /
path-integration networks.

These are the jnp equivalents of the NumPy math in the reference
implementation (``/root/reference/sspslam/sspspace.py:252-532`` and
``/root/reference/sspslam/networks/binding.py:12-89``), re-derived from the
underlying identities so everything is batched, statically shaped, and
fusable by XLA.

Conventions
-----------
* ``phase_matrix`` : (ssp_dim, domain_dim) real matrix ``A`` with
  conjugate-symmetric rows (row 0 and, when even, row d/2 are zero;
  row d-k = -row k), so that ``ifft(exp(i A x))`` is real.
* All functions treat the LAST axis as the vector axis and broadcast over
  leading batch axes.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "encode",
    "encode_fourier",
    "encode_and_deriv",
    "bind",
    "unbind",
    "invert",
    "normalize",
    "make_unitary",
    "make_unitary_fourier",
    "identity_vector",
    "similarity",
    "cleanup_from_set",
    "conjsym",
    "construct_axes_from_phases",
    "dft_half_matrices",
    "binding_input_transforms",
    "binding_output_transform",
    "to_fourier_matrix",
    "from_fourier_matrix",
    "sub_fourier_extract",
    "sub_ssp_extract",
    "sub_fourier_project",
    "sub_ssp_project",
]


# ---------------------------------------------------------------------------
# Real half-spectrum DFT machinery
# ---------------------------------------------------------------------------
# DFTs as real matmuls: no complex arithmetic and no FFT inside the step.
# Whether jnp.fft is faster on the GPU at these d~10^2 is an open
# question (ROADMAP).  All ops below are pure real arithmetic built from cached (d//2+1, d)
# forward matrices and their (d, d//2+1) conjugate-symmetric inverses.

@lru_cache(maxsize=64)
def _rdft_mats(d: int):
    """(W_re, W_im, M_c, M_s):
    forward:  Z_j = (W_re @ x)_j + i (W_im @ x)_j   for j in [0, d//2]
    inverse:  x = M_c @ Re(Z) + M_s @ Im(Z)          (conj-symmetric Z)
    """
    h = d // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(h), np.arange(d)) / d
    W_re = np.cos(ang)
    W_im = -np.sin(ang)
    coef = np.full(h, 2.0)
    coef[0] = 1.0
    if d % 2 == 0:
        coef[-1] = 1.0
    M_c = (coef[None, :] * np.cos(ang).T) / d
    M_s = -(coef[None, :] * np.sin(ang).T) / d
    f32 = np.float32
    # ensure_compile_time_eval: the first call may happen INSIDE a jit/scan
    # trace (e.g. the recovery gate's bind is the first d-dim DFT in the
    # program) — without it jnp.asarray would cache trace-local constant
    # tracers, poisoning every later trace with an UnexpectedTracerError
    with jax.ensure_compile_time_eval():
        return (jnp.asarray(W_re, f32), jnp.asarray(W_im, f32),
                jnp.asarray(M_c, f32), jnp.asarray(M_s, f32))


def rfft_pair(v: jax.Array):
    """(Re, Im) of the half-spectrum DFT of a real vector, shapes (..., h)."""
    d = v.shape[-1]
    W_re, W_im, _, _ = _rdft_mats(d)
    return (jnp.einsum("hd,...d->...h", W_re, v),
            jnp.einsum("hd,...d->...h", W_im, v))


def irfft_pair(re: jax.Array, im: jax.Array, d: int) -> jax.Array:
    """Real inverse DFT from half-spectrum (Re, Im) parts."""
    _, _, M_c, M_s = _rdft_mats(d)
    return (jnp.einsum("dh,...h->...d", M_c, re)
            + jnp.einsum("dh,...h->...d", M_s, im))


# ---------------------------------------------------------------------------
# Fractional-power encoding  phi(x) = IDFT(exp(i * A * (x / ell)))
# ---------------------------------------------------------------------------

def encode(phase_matrix: jax.Array, x: jax.Array, length_scale) -> jax.Array:
    """SSP encoding of points ``x``.

    phase_matrix : (d, n) conjugate-symmetric phase matrix A.
    x : (..., n); length_scale : scalar or (n,).
    Returns (..., d) real SSP vectors.

    Same formula as reference sspspace.py:272 (``ifft(exp(i A x/l))``) but in
    real arithmetic: cos/sin of the half-spectrum phases followed by the
    inverse-DFT matmul.
    """
    d = phase_matrix.shape[0]
    h = d // 2 + 1
    ls = jnp.broadcast_to(jnp.asarray(length_scale, dtype=x.dtype), x.shape[-1:])
    A_half = jnp.asarray(phase_matrix)[:h].astype(x.dtype)
    phases = jnp.einsum("hn,...n->...h", A_half, x / ls)
    return irfft_pair(jnp.cos(phases), jnp.sin(phases), d)


def encode_fourier(phase_matrix: jax.Array, x: jax.Array, length_scale):
    """(Re, Im) of the full Fourier coefficients exp(i A x / l), (..., d)."""
    ls = jnp.broadcast_to(jnp.asarray(length_scale, dtype=x.dtype), x.shape[-1:])
    phases = jnp.einsum("dn,...n->...d", jnp.asarray(phase_matrix).astype(x.dtype),
                        x / ls)
    return jnp.cos(phases), jnp.sin(phases)


def encode_and_deriv(phase_matrix: jax.Array, x: jax.Array, length_scale):
    """SSP encoding and its Jacobian d phi / d x: ((..., d), (..., d, n)).
    Mirrors reference sspspace.py:275-300."""
    d, n = phase_matrix.shape
    h = d // 2 + 1
    ls = jnp.broadcast_to(jnp.asarray(length_scale, dtype=x.dtype), (n,))
    A_ls = (jnp.asarray(phase_matrix) / ls[None, :]).astype(x.dtype)
    phases = jnp.einsum("hn,...n->...h", A_ls[:h], x)
    c, s = jnp.cos(phases), jnp.sin(phases)
    phi = irfft_pair(c, s, d)
    # d z/dx_j = i A_j z  ->  Re' = -sin * A_j, Im' = cos * A_j
    dre = -s[..., :, None] * A_ls[:h]                     # (..., h, n)
    dim = c[..., :, None] * A_ls[:h]
    _, _, M_c, M_s = _rdft_mats(d)
    dphi = (jnp.einsum("dh,...hn->...dn", M_c, dre)
            + jnp.einsum("dh,...hn->...dn", M_s, dim))
    return phi, dphi


# ---------------------------------------------------------------------------
# Binding algebra (circular convolution)
# ---------------------------------------------------------------------------

def bind(a: jax.Array, b: jax.Array) -> jax.Array:
    """Circular convolution a * b along the last axis (reference binding.py:12),
    as real half-spectrum matmuls."""
    d = a.shape[-1]
    ar, ai = rfft_pair(a)
    br, bi = rfft_pair(b)
    return irfft_pair(ar * br - ai * bi, ar * bi + ai * br, d)


def unbind(a: jax.Array, b: jax.Array) -> jax.Array:
    """Circular correlation: bind with the involution of ``a`` (conj in
    Fourier)."""
    d = a.shape[-1]
    ar, ai = rfft_pair(a)
    br, bi = rfft_pair(b)
    return irfft_pair(ar * br + ai * bi, ar * bi - ai * br, d)


def invert(a: jax.Array) -> jax.Array:
    """Involution a[-i mod d]: the binding inverse for unitary vectors
    (reference sspspace.py:530-532)."""
    d = a.shape[-1]
    idx = (-np.arange(d)) % d
    return a[..., idx]


def normalize(v: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Scale to unit L2 norm (safe at 0); reference sspspace.py:508."""
    nrm = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v / jnp.maximum(nrm, eps)


def make_unitary(v: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Project all Fourier coefficients onto the unit circle
    (reference sspspace.py:511-514)."""
    d = v.shape[-1]
    re, im = rfft_pair(v)
    mag = jnp.maximum(jnp.sqrt(re * re + im * im), eps)
    return irfft_pair(re / mag, im / mag, d)


def make_unitary_fourier(fv, eps: float = 1e-8):
    """Normalise (Re, Im) half-spectrum pairs onto the unit circle."""
    re, im = fv
    mag = jnp.maximum(jnp.sqrt(re * re + im * im), eps)
    return re / mag, im / mag


def identity_vector(d: int, dtype=jnp.float32) -> jax.Array:
    """Binding identity: delta at index 0."""
    return jnp.zeros((d,), dtype).at[0].set(1.0)


def similarity(vectors: jax.Array, v: jax.Array) -> jax.Array:
    """Dot products of ``v`` (..., d) against a codebook (m, d) -> (..., m)."""
    return jnp.einsum("md,...d->...m", vectors, v)


def default_cleanup_dtype():
    """Preferred dtype for clean-up similarity matmuls on the accelerator:
    bfloat16, unless SSPSLAM_CLEANUP_F32=1 requests full precision.  Model
    call sites (SLAMNetwork, PathIntegrationReencode) pass this explicitly;
    the generic :func:`cleanup_from_set` op itself defaults to float32."""
    import os
    return jnp.float32 if os.environ.get("SSPSLAM_CLEANUP_F32") \
        else jnp.bfloat16


def cleanup_from_set(sample_ssps: jax.Array, v: jax.Array,
                     sim_dtype=jnp.float32) -> jax.Array:
    """Replace ``v`` with the most similar vector from ``sample_ssps``.

    The on-device equivalent of the clean-up node at reference
    slam.py:212-215 — a single (m, d) @ (d,) matvec plus argmax inside the
    step instead of a host callback.

    ``sim_dtype``: dtype for the similarity matmul.  The generic op
    defaults to float32 (exact comparison); performance-critical model call
    sites opt into bfloat16 via :func:`default_cleanup_dtype` — the sample
    bank is the single largest constant read in the SLAM step
    (samples_per_dim^2 x d, ~4 MB at reference scale, re-read every dt) and
    the read is bandwidth-bound; only the ARGMAX of the similarities is
    consumed, so reduced precision merely risks a tie-flip to an adjacent
    grid cell, far inside the model's noise floor.  The returned vector is
    gathered from the full-precision bank.  Pass ``sim_dtype=None`` to
    compare in the input dtype.
    """
    if sim_dtype is not None:
        sims = jnp.einsum("md,...d->...m", sample_ssps.astype(sim_dtype),
                          v.astype(sim_dtype))
    else:
        sims = jnp.einsum("md,...d->...m", sample_ssps, v)
    best = jnp.argmax(sims, axis=-1)
    return jnp.take(sample_ssps, best, axis=0)


# ---------------------------------------------------------------------------
# Phase-matrix construction helper
# ---------------------------------------------------------------------------

def construct_axes_from_phases(K: np.ndarray, even: bool = False) -> np.ndarray:
    """Build unit-magnitude axis vectors from an (m, n) free-phase matrix:
    each column's conjugate-symmetric spectrum exp(i*phases) is inverse-
    transformed to a real (2m+1[+1], n) axis bank (reference
    sspspace.py:851-858)."""
    K = np.atleast_2d(np.asarray(K, dtype=np.float64))
    m, n = K.shape
    d = 2 * m + 1 + (1 if even else 0)
    F = np.ones((d, n), dtype=complex)
    F[1:m + 1] = np.exp(1j * K)
    F[d - m:] = np.conj(np.exp(1j * K))[::-1]
    return np.fft.ifft(F, axis=0).real


def conjsym(K: np.ndarray) -> np.ndarray:
    """Expand (m, n) free phases into a (2m+1, n) conjugate-symmetric phase
    matrix: row 0 zero, rows 1..m = K, rows m+1..2m = -flip(K)
    (reference sspspace.py:860-868)."""
    K = np.atleast_2d(np.asarray(K, dtype=np.float64))
    m, n = K.shape
    F = np.zeros((2 * m + 1, n))
    F[1 : m + 1] = K
    F[m + 1 :] = -np.flip(K, axis=0)
    return F


# ---------------------------------------------------------------------------
# Sub-SSP (multi-scale module) extraction / projection matrices
# ---------------------------------------------------------------------------
# A multi-scale SSP S_total of dim 2*sublen*N + 1 decomposes into N sub-SSPs,
# each owning ``sublen`` consecutive positive frequencies (plus the shared DC
# term and the conjugate-symmetric mirror).  These matrices pick out /
# reassemble sub-vectors in the Fourier or time domain — functional parity
# with reference sspspace.py:871-921.

def _sub_freq_selector(n: int, N: int, sublen: int, dc_scale: float):
    """(2*sublen+1, tot) complex-frequency selection: rows pick module n's
    positive freqs, the DC term (scaled), and the mirrored negative freqs."""
    tot = 2 * sublen * N + 1
    sel = np.zeros((2 * sublen + 1, tot))
    pos = np.arange(sublen * n, sublen * (n + 1))
    sel[np.arange(sublen), pos] = 1.0
    sel[sublen, sublen * N] = dc_scale
    neg = tot - np.arange(sublen * (n + 1), sublen * n, -1)
    sel[np.arange(sublen + 1, 2 * sublen + 1), neg] = 1.0
    return sel


def sub_fourier_extract(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """A-bar_n: F{S_n} = A-bar_n @ F{S_total} (frequency-domain pick-out)."""
    return _sub_freq_selector(n, N, sublen, dc_scale=1.0)


def sub_ssp_extract(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """A_n: S_n = A_n @ S_total (time-domain pick-out).

    Derived as IDFT_small . ifftshift(A-bar_n) . DFT_big."""
    tot = 2 * sublen * N + 1
    FA = np.fft.ifftshift(sub_fourier_extract(n, N, sublen))
    W = np.fft.fft(np.eye(tot))
    invW = np.fft.ifft(np.eye(2 * sublen + 1))
    return np.real(invW @ FA @ W)


def sub_fourier_project(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """B-bar_n: sum_n B-bar_n @ F{S_n} = F{S_total}. The DC row is scaled by
    1/N so the N sub-vectors' unit DC terms sum back to 1."""
    return _sub_freq_selector(n, N, sublen, dc_scale=1.0 / N).T


def sub_ssp_project(n: int, N: int, sublen: int = 3) -> np.ndarray:
    """B_n: sum_n B_n @ S_n = S_total (time-domain projection)."""
    tot = 2 * sublen * N + 1
    FB = np.fft.ifftshift(sub_fourier_project(n, N, sublen))
    invW = np.fft.ifft(np.eye(tot))
    W = np.fft.fft(np.eye(2 * sublen + 1))
    return np.real(invW @ FB @ W)


# ---------------------------------------------------------------------------
# Fixed linear transforms for the *neural* binding network
# ---------------------------------------------------------------------------
# The neural CircularConvolution computes DFT(a)*DFT(b) with four real
# product channels per retained frequency (Gosmann alignment; see reference
# binding.py:164-186 for the derivation):
#   channels per freq i: w=ReF*ReG, x=ImF*ImG, y=ReF*ImG, z=ImF*ReG
#   Re H[i] = w - x ; Im H[i] = y + z
# Input transform A rows per freq: [ReF, ImF, ReF, ImF]
# Input transform B rows per freq: [ReG, ImG, ImG, ReG]
# Output transform folds (w,x,y,z) -> real IDFT.

def dft_half_matrices(d: int):
    """Real/imag parts of the half-spectrum DFT matrix, shape (d//2+1, d)."""
    x = np.arange(d)
    w = np.arange(d // 2 + 1)
    M = np.exp((-2.0j * np.pi / d) * np.outer(w, x))
    return M.real, M.imag


def binding_input_transforms(d: int, invert_a: bool = False, invert_b: bool = False):
    """(tr_a, tr_b), each (4*(d//2+1), d): map inputs into aligned half-spectrum
    product channels. ``invert_*`` conjugates that operand (circular correlation)."""
    re, im = dft_half_matrices(d)
    im_a = -im if invert_a else im
    im_b = -im if invert_b else im
    h = d // 2 + 1
    tr_a = np.zeros((4 * h, d))
    tr_b = np.zeros((4 * h, d))
    tr_a[0::4] = re
    tr_a[1::4] = im_a
    tr_a[2::4] = re
    tr_a[3::4] = im_a
    tr_b[0::4] = re
    tr_b[1::4] = im_b
    tr_b[2::4] = im_b
    tr_b[3::4] = re
    return tr_a, tr_b


def binding_output_transform(d: int) -> np.ndarray:
    """(d, 4*(d//2+1)) matrix folding product channels through the inverse DFT.

    For real output: out = (1/d) * sum_i c_i * (ReW_i*ReH_i - ImW_i*ImH_i)
    where W is the half DFT, c_i = 1 for i==0 or (d even and i==d/2) else 2.
    """
    re, im = dft_half_matrices(d)
    h = d // 2 + 1
    coef = np.full(h, 2.0)
    coef[0] = 1.0
    if d % 2 == 0:
        coef[-1] = 1.0
    out = np.zeros((d, 4 * h))
    # H = (w - x) + i(y + z); IDFT real part:
    # out = (1/d) sum_i c_i [ re_i * (w_i - x_i) - im_i*(y_i + z_i) ]  with idft basis conj
    out[:, 0::4] = (coef * re.T) / d          # w  (Re channel, +)
    out[:, 1::4] = -(coef * re.T) / d         # x  (Re channel, -)
    out[:, 2::4] = (coef * im.T) / d          # y  (Im channel): conj idft -> +im
    out[:, 3::4] = (coef * im.T) / d          # z
    return out


# ---------------------------------------------------------------------------
# SSP <-> oscillator-bank Fourier layout
# ---------------------------------------------------------------------------
# The path integrator represents the SSP in the Fourier domain as
# k = (d+1)//2 triples [Re F_j, Im F_j, omega_j] (one per VCO).
# ``to_fourier_matrix`` maps an SSP into the stacked (3k,) layout (omega rows
# zero); ``from_fourier_matrix`` reconstructs the SSP from the stacked layout.
# Equivalent in function to reference pathintegration.py:816-844, derived
# directly from the DFT conjugate-symmetry relations.

def to_fourier_matrix(d: int) -> np.ndarray:
    """(3k, d) matrix: SSP -> [Re F_1..k-1, Im F_1..k-1] in VCO triple layout.

    VCO j (j>=1) rows 3j, 3j+1 get Re/Im of DFT row j; VCO 0 (the DC term)
    rows are zero — it is pinned to [1, 0, 0] by a constant input instead.
    Frequency rows (3j+2) are zero: omega comes from the velocity input.
    """
    k = (d + 1) // 2
    W = np.fft.fft(np.eye(d))
    M = np.zeros((3 * k, d))
    M[3::3] = W[1:k].real
    M[4::3] = W[1:k].imag
    return M


def from_fourier_matrix(d: int) -> np.ndarray:
    """(d, 3k) matrix: stacked VCO triples -> SSP.

    Reconstructs x = Re(IFFT(F)) with F_0 taken from VCO 0's Re component,
    F_j from VCO j, and the upper half of the spectrum by conjugate symmetry.
    For even d the Nyquist row F_{d/2} is not represented by any VCO and is
    dropped (matches the reference layout, pathintegration.py:824-844).
    """
    k = (d + 1) // 2
    invW = np.fft.ifft(np.eye(d))  # (d, d) complex, x = invW @ F
    C = np.zeros((d, d), dtype=complex)  # F = C @ stacked(Re, Im) mapping built below
    M = np.zeros((d, 3 * k))
    # columns 3j -> Re F_j contribution, 3j+1 -> Im F_j contribution
    for j in range(k):
        # F_j = Re + i Im ; F_{d-j} = Re - i Im (conjugate symmetry), j>0
        col_re = invW[:, j].copy()
        col_im = 1j * invW[:, j]
        if j > 0 and (d - j) != j:
            col_re = col_re + invW[:, d - j]
            col_im = col_im - 1j * invW[:, d - j]
        M[:, 3 * j] = col_re.real
        M[:, 3 * j + 1] = col_im.real
    return M
