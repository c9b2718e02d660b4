"""Single-qubit randomized benchmarking pulses.

The 24-element single-qubit Clifford group is generated by breadth-
first closure over pi/2 rotations about X and Y, so every Clifford
comes with a shortest decomposition into primitive pulses (at most 3
generators).  Sequences of random Cliffords plus the recovery gate are
composed with :func:`~..sequencing.concatenate`, reusing each
Clifford's cached control matrix -- the scenario of the reference's
randomized-benchmarking example
(/root/reference/examples/randomized_benchmarking.py: 24 Cliffords x
sequence lengths x samples at 301 frequencies).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import util
from ..basis import Basis
from ..pulse_sequence import PulseSequence
from ..sequencing import concatenate

__all__ = ['clifford_group', 'clifford_pulses', 'sample_sequence',
           'rb_pulse', 'clifford_control_arrays', 'batched_rb_infidelities']

_I, _X, _Y, _Z = util.paulis


def _rot(axis: np.ndarray, angle: float) -> np.ndarray:
    return (np.cos(angle / 2) * _I - 1j * np.sin(angle / 2) * axis)


def _phase_equal(u: np.ndarray, v: np.ndarray) -> bool:
    """True if u == v up to a global phase: |tr(u^dag v)| == d."""
    return abs(abs(np.trace(u.conj().T @ v)) - u.shape[0]) < 1e-9


def _find(group: list, v: np.ndarray) -> int:
    for i, (u, _) in enumerate(group):
        if _phase_equal(u, v):
            return i
    return -1


@functools.lru_cache(maxsize=None)
def clifford_group() -> Tuple[Tuple[np.ndarray, Tuple[str, ...]], ...]:
    """The 24 single-qubit Cliffords with shortest decompositions into
    the generators {X90, Y90, X-90, Y-90} (BFS closure)."""
    gens = {
        'X90': _rot(_X, np.pi / 2),
        'Y90': _rot(_Y, np.pi / 2),
        'X-90': _rot(_X, -np.pi / 2),
        'Y-90': _rot(_Y, -np.pi / 2),
    }
    group = [(_I.astype(complex), ())]
    frontier = list(group)
    while frontier:
        new_frontier = []
        for u, word in frontier:
            for name, g in gens.items():
                v = g @ u
                if _find(group, v) < 0:
                    entry = (v, word + (name,))
                    group.append(entry)
                    new_frontier.append(entry)
        frontier = new_frontier
    assert len(group) == 24, f'Clifford closure gave {len(group)} elements'
    return tuple(group)


def _primitive_pulse(name: str, tau: float,
                     basis: Optional[Basis]) -> List:
    """(oper, coeff) entries realizing one generator over duration
    tau."""
    angle = np.pi / 2 * (1 if '-' not in name else -1)
    oper = _X if name.startswith('X') else _Y
    return [oper / 2, [angle / tau]]


def clifford_pulses(tau: float = 1.0, basis: Optional[Basis] = None,
                    omega: Optional[np.ndarray] = None
                    ) -> List[PulseSequence]:
    """The 24 Cliffords as PulseSequences (with Z dephasing noise),
    each of equal duration; optionally pre-cache filter functions."""
    pulses = []
    for u, word in clifford_group():
        if not word:
            # identity: idle segment
            H_c = [[_X / 2, [0.0], 'X'], [_Y / 2, [0.0], 'Y']]
            H_n = [[_Z / 2, [1.0], 'Z']]
            pulse = PulseSequence(H_c, H_n, [tau], basis=basis)
        else:
            seg_tau = tau / len(word)
            x_coeffs, y_coeffs = [], []
            for name in word:
                angle = np.pi / 2 * (1 if '-' not in name else -1)
                if name.startswith('X'):
                    x_coeffs.append(angle / seg_tau)
                    y_coeffs.append(0.0)
                else:
                    x_coeffs.append(0.0)
                    y_coeffs.append(angle / seg_tau)
            H_c = [[_X / 2, x_coeffs, 'X'], [_Y / 2, y_coeffs, 'Y']]
            H_n = [[_Z / 2, np.ones(len(word)), 'Z']]
            pulse = PulseSequence(H_c, H_n, [seg_tau] * len(word),
                                  basis=basis)
        if omega is not None:
            pulse.cache_filter_function(omega)
        pulses.append(pulse)
    return pulses


def sample_sequence(length: int, rng: np.random.Generator
                    ) -> Tuple[List[int], int]:
    """Random Clifford indices plus the recovery index undoing their
    product (so the ideal sequence implements the identity)."""
    group = list(clifford_group())
    indices = [int(i) for i in rng.integers(0, 24, length)]
    total = _I.astype(complex)
    for i in indices:
        total = group[i][0] @ total
    recovery = _find(group, total.conj().T)
    assert recovery >= 0
    return indices, recovery


def rb_pulse(indices: Sequence[int], recovery: int,
             pulses: Sequence[PulseSequence],
             calc_filter_function: Optional[bool] = None) -> PulseSequence:
    """Concatenate the sampled Clifford sequence plus recovery gate."""
    seq = [pulses[i] for i in indices] + [pulses[recovery]]
    return concatenate(seq, calc_filter_function=calc_filter_function)


# -----------------------------------------------------------------------------
# Batched randomized benchmarking
# -----------------------------------------------------------------------------
def clifford_control_arrays(tau: float = 1.0):
    """Control coefficient / duration arrays of all 24 Cliffords, zero-
    padded to a common segment count (zero-duration segments are exact
    no-ops of the pipeline).

    Returns (c_coeffs (24, 2, G), n_coeffs (24, 1, G), dt (24, G)).
    """
    words = [word for _, word in clifford_group()]
    g_max = max(1, max(len(w) for w in words))
    c_coeffs = np.zeros((24, 2, g_max))
    dt = np.zeros((24, g_max))
    for i, word in enumerate(words):
        if not word:                       # identity: one idle segment
            dt[i, 0] = tau
            continue
        seg_tau = tau / len(word)
        for g, name in enumerate(word):
            angle = np.pi / 2 * (1 if '-' not in name else -1)
            row = 0 if name.startswith('X') else 1
            c_coeffs[i, row, g] = angle / seg_tau
            dt[i, g] = seg_tau
    n_coeffs = np.ones((24, 1, g_max))
    return c_coeffs, n_coeffs, dt


def batched_rb_infidelities(indices, omega, spectrum, tau: float = 1.0):
    """Dephasing infidelities of many Clifford sequences in ONE jitted,
    batched evaluation -- the device replacement for the
    reference's per-sequence ``concatenate`` loop with cached control
    matrices (/root/reference/examples/randomized_benchmarking.py).

    indices: (n_seq, n_cliffords) int array of Clifford indices (append
    the recovery index yourself via :func:`sample_sequence`).
    Returns (n_seq,) infidelities.

    Pipeline (all under one jit): the 24 atomic control matrices and
    total-propagator Liouvilles batch over the group; per sequence, the
    cumulative Liouville products run as a vmapped scan and the
    concatenation sum B = sum_g e^{i w t_{g-1}} B^(g) Q^(g-1) is one
    einsum (K5, numeric.py:621-704 of the reference).
    """
    indices = jnp.asarray(np.asarray(indices, dtype=int))
    ctrl, liou = _atomic_clifford_data(float(tau),
                                       tuple(np.asarray(omega).tolist()))
    return _rb_run(ctrl, liou, indices, jnp.asarray(omega),
                   jnp.asarray(spectrum), tau)


@functools.lru_cache(maxsize=8)
def _atomic_clifford_data(tau: float, omega_key: tuple):
    """The 24 atomic control matrices and total-propagator Liouvilles.

    These are constants of the (tau, omega) pair -- every RB evaluation
    reuses them, so they are computed once per grid and cached on the
    host (the reference equivalently caches per-Clifford filter
    functions once, /root/reference/examples/randomized_benchmarking.py
    'cache_filter_function' loop)."""
    from .. import functional
    from ..cplx import asc

    basis = Basis.pauli(1)
    c_coeffs, n_coeffs, dt = clifford_control_arrays(tau)
    omega = jnp.asarray(omega_key)
    p = functional.PulseArrays(
        c_opers=asc(np.stack([_X, _Y]) / 2),
        c_coeffs=jnp.asarray(c_coeffs),
        n_opers=asc((_Z / 2)[None]),
        n_coeffs=jnp.asarray(n_coeffs),
        dt=jnp.asarray(dt),
        basis=basis.dev,
    )
    ctrl, liou = _atomic_run(p, omega)
    # materialize so the cache holds concrete device buffers
    jax.block_until_ready(liou)
    return ctrl, liou


@jax.jit
def _atomic_run(p, omega):
    from .. import functional, numeric
    from ..cplx import ceinsum
    from ..superoperator import liouville_representation

    basis = Basis.pauli(1)

    def atomic(c_coeffs, n_coeffs, dt):
        single = functional.PulseArrays(p.c_opers, c_coeffs,
                                        p.n_opers, n_coeffs, dt,
                                        p.basis)
        ctrl = functional.control_matrix(single, omega)
        ham = ceinsum('jmn,jg->gmn', p.c_opers, c_coeffs)
        _, _, props = numeric._diagonalize_jit(ham, dt)
        liou = liouville_representation(props[-1], basis)
        return ctrl, liou

    return jax.vmap(atomic)(p.c_coeffs, p.n_coeffs, p.dt)


@functools.partial(jax.jit, static_argnames=('tau',))
def _rb_run(ctrl, liou, indices, omega, spectrum, tau: float):
    """The batched RB pipeline; module-level jit so repeated calls hit
    the compile cache (a jit object created per call re-traces every
    time).

    The concatenation sum B = sum_g e^{i w t_{g-1}} B^(g) Q^(g-1)
    (K5, reference numeric.py:621-704) runs as ONE batched matmul
    per sequence with the (segment, basis) pair as reduction axis;
    the cumulative Liouville transfer matrices Q are real (unitary
    PTMs), so the product needs two real matmuls, not a complex one.
    """
    from .. import util as _util
    from ..cplx import C, cexp

    # per-sequence cumulative boundary transfer matrices
    liou_seq = liou[indices[:, :-1]]             # (S, L-1, d2, d2)
    q_cum = jax.vmap(_util.adot)(liou_seq)
    # equal pulse durations: boundary phases e^{i w g tau}
    n_cliff = indices.shape[1]
    phases = cexp(jnp.arange(1, n_cliff)[:, None] * tau * omega)
    b_seq = ctrl[indices]                        # (S, L, n_nops, d2, n_w)
    first = b_seq[:, 0]
    S, Lm1 = indices.shape[0], n_cliff - 1
    n_nops, d2, n_w = b_seq.shape[2], b_seq.shape[3], b_seq.shape[4]
    bp = b_seq[:, 1:] * phases._map(
        lambda v: v[None, :, None, None, :])     # (S, g, j, k, o)
    x = bp._map(lambda v: v.transpose(0, 4, 2, 1, 3).reshape(
        S, n_w * n_nops, Lm1 * d2))              # (S, (o j), (g k))
    y = q_cum.reshape(S, Lm1 * d2, d2)           # (S, (g k), l)
    from .. import config
    if config.contraction_mode() == 'ozaki':
        from ..ops.ozaki import ozaki_matmul
        rest = C(ozaki_matmul(x.re, y), ozaki_matmul(x.im, y))
    else:
        rest = C(x.re @ y, x.im @ y)
    rest = rest.reshape(S, n_w, n_nops, d2)._map(
        lambda v: v.transpose(0, 2, 3, 1))       # (s, j, l, o)
    b_total = first + rest
    ff_diag = (b_total.re**2 + b_total.im**2).sum(axis=-2)
    infid = _util.integrate(ff_diag * spectrum, omega) \
        / (2 * np.pi * 2)
    return infid[:, 0]
