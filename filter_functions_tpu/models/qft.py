"""Quantum Fourier transform with Ising-type Hamiltonians.

Implements the simplified QFT of Ivanov, Johanning & Wunderlich,
arXiv:1503.08806 (the reference's benchmark example,
/root/reference/examples/qft.py), built from plain Pauli tensor
products -- no qutip dependency.  The 4-qubit instance (d = 16) at
1000 frequencies is the performance north star (BASELINE.json;
:func:`qft_batch` builds that workload).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import util
from ..basis import Basis
from ..pulse_sequence import PulseSequence
from ..sequencing import concatenate

__all__ = ['qft_pulse', 'qft_batch', 'r_k_pulse', 'h_k_pulse',
           't_i_pulse', 't_f_pulse', 'p_n_pulse']

_I, _X, _Y, _Z = util.paulis


def _embed(op: np.ndarray, k: int, n_qubits: int) -> np.ndarray:
    """op acting on qubit k of n."""
    factors = [_I] * n_qubits
    factors[k] = op
    return util.tensor(*factors) if n_qubits > 1 else op


def _pauli_string_label(op_char: str, k: int, n_qubits: int) -> str:
    return 'I' * k + op_char + 'I' * (n_qubits - k - 1)


def r_k_pulse(k: int, theta: float, phi: float, n_qubits: int = 4,
              tau: float = 1.0,
              basis: Optional[Basis] = None) -> PulseSequence:
    """Single-qubit rotation R_k(theta, phi) on qubit k, with X and Y
    noise on that qubit (examples/qft.py:41-60)."""
    x = _embed(_X, k, n_qubits)
    y = _embed(_Y, k, n_qubits)
    d = x.shape[0]
    H_c = [[x, [theta / 2 / tau * np.cos(phi)],
            _pauli_string_label('X', k, n_qubits)],
           [y, [theta / 2 / tau * np.sin(phi)],
            _pauli_string_label('Y', k, n_qubits)]]
    H_n = [[x / np.sqrt(d), [1.0], _pauli_string_label('X', k, n_qubits)],
           [y / np.sqrt(d), [1.0], _pauli_string_label('Y', k, n_qubits)]]
    return PulseSequence(H_c, H_n, [tau], basis=basis)


def _cyclic_z_chain(k: int, n_qubits: int) -> np.ndarray:
    """Z acting on qubit k-1 (the T-pulse terms are single-qubit Z's)."""
    return _embed(_Z, k - 1, n_qubits)


def t_i_pulse(n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None) -> PulseSequence:
    """Initial phase gate T_I (examples/qft.py:63-81)."""
    if n_qubits == 1:
        H_c = [[_I, [0.0], 'I']]
        H_n = [[_I / np.sqrt(2), [1.0], 'I']]
        return PulseSequence(H_c, H_n, [tau], basis=basis)
    H_c, H_n = [], []
    for k in range(1, n_qubits + 1):
        z = _cyclic_z_chain(k, n_qubits)
        label = 'I' * (k - 1) + 'Z' + 'I' * (n_qubits - k)
        H_c.append([z, [np.pi / 4 * (1 - 2**(1 - k)) / tau], label])
        H_n.append([z / np.sqrt(z.shape[0]), [1.0], label])
    return PulseSequence(H_c, H_n, [tau], basis=basis)


def t_f_pulse(n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None) -> PulseSequence:
    """Final phase gate T_F (examples/qft.py:84-102)."""
    if n_qubits == 1:
        H_c = [[_I, [0.0], 'I']]
        H_n = [[_I / np.sqrt(2), [1.0], 'I']]
        return PulseSequence(H_c, H_n, [tau], basis=basis)
    H_c, H_n = [], []
    for k in range(1, n_qubits + 1):
        z = _cyclic_z_chain(k, n_qubits)
        label = 'I' * (k - 1) + 'Z' + 'I' * (n_qubits - k)
        H_c.append([z, [np.pi / 4 * (1 - 2**(k - n_qubits)) / tau], label])
        H_n.append([z / np.sqrt(z.shape[0]), [1.0], label])
    return PulseSequence(H_c, H_n, [tau], basis=basis)


def p_n_pulse(n: int, n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None) -> PulseSequence:
    """Pairwise conditional-phase gate P_n (examples/qft.py:105-118)."""
    H_c, H_n = [], []
    for m in range(n + 1, n_qubits + 1):
        factors = [_I] * n_qubits
        factors[n - 1] = _Z
        factors[m - 1] = _Z
        zz = util.tensor(*factors)
        label = ('I' * (n - 1) + 'Z' + 'I' * (m - n - 1) + 'Z'
                 + 'I' * (n_qubits - m))
        H_c.append([zz, [-np.pi / 4 * 2**(n - m) / tau], label])
        H_n.append([zz / np.sqrt(zz.shape[0]), [1.0], label])
    return PulseSequence(H_c, H_n, [tau], basis=basis)


def h_k_pulse(k: int, n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None) -> PulseSequence:
    """Hadamard on qubit k as R(pi, 0) then R(pi/2, -pi/2)
    (examples/qft.py:120-122)."""
    return concatenate([r_k_pulse(k, np.pi, 0, n_qubits, tau, basis),
                        r_k_pulse(k, np.pi / 2, -np.pi / 2, n_qubits, tau,
                                  basis)])


def qft_pulse(n_qubits: int = 4, tau: float = 1.0,
              basis: Optional[Basis] = None) -> PulseSequence:
    """The full QFT pulse sequence (examples/qft.py:125-134):
    T_I, then for each qubit a Hadamard followed by conditional phases,
    and a final T_F.  Total 3 n_qubits + 1 segments."""
    pulses = [t_i_pulse(n_qubits, tau, basis)]
    for n in range(n_qubits - 1):
        pulses.append(h_k_pulse(n, n_qubits, tau, basis))
        pulses.append(p_n_pulse(n + 1, n_qubits, tau, basis))
    pulses.append(h_k_pulse(n_qubits - 1, n_qubits, tau, basis))
    pulses.append(t_f_pulse(n_qubits, tau, basis))
    return concatenate(pulses)


def qft_batch(n_qubits: int = 4, n_omega: int = 1000, batch: int = 32,
              seed: int = 0):
    """The flagship workload: the QFT pulse and a batch of its
    variants for :func:`~filter_functions_tpu.functional.batched_infidelity`
    (row 0 the pulse itself, the others with seeded 5% control-amplitude
    scatter, as an optimal-control population), at *n_omega*
    log-spaced frequencies in [1e-2, 1e2] with a 1e-4/omega spectrum.

    Returns ``(pulse, batched PulseArrays, omega, spectrum)``; omega and
    spectrum are numpy arrays.
    """
    import jax.numpy as jnp
    from ..functional import PulseArrays, make_pulse_arrays

    pulse = qft_pulse(n_qubits)
    p = make_pulse_arrays(pulse)
    scales = 1 + 0.05 * np.random.default_rng(seed).standard_normal(
        (batch, 1, 1))
    scales[0] = 1.0
    c_coeffs = np.asarray(p.c_coeffs)
    n_coeffs = np.asarray(p.n_coeffs)
    dt = np.asarray(p.dt)
    batched = PulseArrays(
        p.c_opers, jnp.asarray(c_coeffs[None] * scales), p.n_opers,
        jnp.asarray(np.broadcast_to(n_coeffs, (batch,) + n_coeffs.shape)),
        jnp.asarray(np.broadcast_to(dt, (batch,) + dt.shape)), p.basis)
    omega = np.geomspace(1e-2, 1e2, n_omega)
    return pulse, batched, omega, 1e-4 / omega


def qft_propagator(n_qubits: int) -> np.ndarray:
    """The ideal QFT unitary (bit-reversed output order), for
    verification: F_{jk} = exp(2 pi i j k / d) / sqrt(d)."""
    d = 2**n_qubits
    j, k = np.meshgrid(np.arange(d), np.arange(d), indexing='ij')
    return np.exp(2j * np.pi * j * k / d) / np.sqrt(d)


def swap_all(n_qubits: int) -> np.ndarray:
    """Unitary reversing the qubit order (QFT output bit reversal)."""
    d = 2**n_qubits
    perm = np.zeros(d, dtype=int)
    for i in range(d):
        bits = format(i, f'0{n_qubits}b')
        perm[i] = int(bits[::-1], 2)
    u = np.zeros((d, d))
    u[perm, np.arange(d)] = 1.0
    return u
