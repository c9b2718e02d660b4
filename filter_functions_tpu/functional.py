"""Purely functional, jit-first pipeline API.

The object API (:class:`~.pulse_sequence.PulseSequence`) manages caches
host-side; this module exposes the same computations as pure functions
of arrays, suitable for ``jax.jit`` / ``jax.vmap`` / ``jax.grad`` /
sharding without any host round-trips.  This is the API the benchmark
and the multi-chip training step are built on.

All complex quantities use the split representation
(:class:`~.cplx.C`); control/noise operators can be passed as numpy
complex arrays and are converted at the boundary.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import numeric, util
from .basis import Basis
from .cplx import C, asc, ceinsum, cexp

__all__ = ['PulseArrays', 'make_pulse_arrays', 'control_matrix',
           'fidelity_filter_function', 'infidelity', 'batched_infidelity',
           'error_transfer_matrix', 'batched_error_transfer_matrix']


class PulseArrays(NamedTuple):
    """The static ingredients of a pulse as a pytree."""
    c_opers: C          # (n_ctrl, d, d)
    c_coeffs: jnp.ndarray   # (n_ctrl, n_dt)
    n_opers: C          # (n_nops, d, d)
    n_coeffs: jnp.ndarray   # (n_nops, n_dt)
    dt: jnp.ndarray     # (n_dt,)
    basis: C            # (n_b, d, d)


def make_pulse_arrays(pulse) -> PulseArrays:
    """Extract PulseArrays from a :class:`PulseSequence`."""
    return PulseArrays(pulse.c_opers_dev, jnp.asarray(pulse.c_coeffs),
                       pulse.n_opers_dev, jnp.asarray(pulse.n_coeffs),
                       jnp.asarray(pulse.dt), pulse.basis.dev)


def control_matrix(p: PulseArrays, omega: jnp.ndarray,
                   escalation: str = 'auto') -> C:
    """Control matrix (n_nops, n_b, n_omega) from raw arrays: the full
    diagonalize -> propagate -> contract pipeline under one trace.

    *escalation* is forwarded to :func:`numeric._ctrlmat_contract`:
    'auto' (in-graph cond; correct unbatched), 'stat' (returns
    ``(ctrl, ratio)``; what batched callers vmap), 'force'
    (full-precision recompute)."""
    from . import config
    ham = ceinsum('jmn,jg->gmn', p.c_opers, p.c_coeffs)
    eigvals, eigvecs, propagators = numeric._diagonalize_jit(ham, p.dt)
    t = jnp.concatenate([jnp.zeros(1, p.dt.dtype), jnp.cumsum(p.dt)])
    G, d = eigvals.shape
    (_, n_t, b_t, ph, integral) = numeric._ctrlmat_step_terms(
        eigvals, eigvecs, propagators[:-1], omega, p.basis, p.n_opers,
        p.n_coeffs, p.dt, t[:-1],
        transform_dtype=config.transform_dtype(G * d * d))
    return numeric._ctrlmat_contract(n_t, integral, b_t, ph, escalation)


def fidelity_filter_function(p: PulseArrays, omega: jnp.ndarray) -> C:
    """Fidelity filter function (n_nops, n_nops, n_omega)."""
    ctrl = control_matrix(p, omega)
    return numeric.calculate_filter_function(ctrl, 'fidelity')


def infidelity(p: PulseArrays, spectrum: jnp.ndarray,
               omega: jnp.ndarray) -> jnp.ndarray:
    """Leading-order infidelity per noise operator (n_nops,) for a
    per-operator (or broadcastable) spectrum; traceless-basis path.

    Computes only the diagonal F_aa = sum_k |B_ak|^2 (n_nops x n_omega
    elementwise) instead of the full n_nops^2 cross filter function.
    """
    ctrl = control_matrix(p, omega)
    diag = (ctrl.re * ctrl.re + ctrl.im * ctrl.im).sum(axis=1)
    integrand = diag * spectrum
    d = p.c_opers.shape[-1]
    return util.integrate(integrand, omega) / (2 * np.pi * d)


def error_transfer_matrix(p: PulseArrays, spectrum, omega, basis: Basis,
                          second_order: bool = False) -> jnp.ndarray:
    """Error transfer matrix exp K from raw pulse arrays as ONE fused
    device call: diagonalization, per-step control matrices, decay
    amplitudes, (optionally) the second-order filter function and
    frequency shifts, the cumulant trace contraction, and the matrix
    exponential all run in a single executable.

    The object API (:func:`~.numeric.error_transfer_matrix`) computes
    the identical quantity with cache-population side effects; this is
    the jit/vmap/grad-composable variant.  *basis* supplies the
    (host-precombined) four-element trace tensors.
    """
    n_nops = p.n_opers.shape[0]
    spectrum = util.parse_spectrum(np.asarray(spectrum), omega,
                                   np.arange(n_nops))
    s = jnp.asarray(spectrum.real)
    s_im = jnp.asarray(spectrum.imag) if np.iscomplexobj(spectrum) \
        else None
    tg, td = numeric._cumulant_trace_combos_dev(basis)
    return _etm_core(p, s, s_im, jnp.asarray(omega), tg,
                     td if second_order else None,
                     second_order, tuple(range(n_nops)),
                     _so_shift_dtype())


def _so_shift_dtype() -> Optional[str]:
    """Working precision of the second-order frequency-shift term.

    float32 in 'ozaki' contraction mode, full precision otherwise.
    Since the
    separable-table rewrite of the K2 lattice
    (numeric._second_order_diag_shifts), float32's rounding is NOT
    amplified near resonances: entries with |y dt| < _SO_SMALL_Y take
    the cancellation-free divided-difference branch, so the factored
    general form's error stays <= eps_f32/_SO_SMALL_Y ~ 6e-6
    element-relative, ~1e-11 integrated (measured) -- inside the
    1e-10 parity budget.  Override with FF_TPU_SO_DTYPE=float64|float32
    (resolved eagerly per call and passed as a static argument, like
    FF_TPU_OZAKI_CMUL).
    """
    mode = os.environ.get('FF_TPU_SO_DTYPE')
    if mode:
        return None if mode in ('float64', 'f64') else 'float32'
    from . import config
    return 'float32' if config.contraction_mode() == 'ozaki' else None


@functools.partial(jax.jit,
                   static_argnames=('second_order', 'idx', 'so_dtype'))
def _etm_core(p: PulseArrays, s, s_im, omega, tg, td,
              second_order: bool, idx, so_dtype=None):
    ham = ceinsum('jmn,jg->gmn', p.c_opers, p.c_coeffs)
    eigvals, eigvecs, propagators = numeric._diagonalize_jit(ham, p.dt)
    t = jnp.concatenate([jnp.zeros(1, p.dt.dtype), jnp.cumsum(p.dt)])
    (_, n_t, b_t, ph, integral) = numeric._ctrlmat_step_terms(
        eigvals, eigvecs, propagators[:-1], omega, p.basis, p.n_opers,
        p.n_coeffs, p.dt, t[:-1])
    step = numeric._ctrlmat_step_contract(n_t, integral, b_t, ph)
    ctrl = step.sum(axis=0)

    idx_arr = jnp.asarray(np.asarray(idx))
    if s_im is None and s.ndim <= 2:
        # diagonal spectra: decay amplitudes with the trapezoid folded
        # into one contraction -- no (a, k, l, omega) integrand tensor
        ws_g = (s if s.ndim == 2
                else jnp.broadcast_to(s, (len(idx), s.shape[-1])))
        ws_g = ws_g * numeric.trapezoid_weights(omega) / (2 * np.pi)
        ctrl_i = ctrl._map(lambda v: v[idx_arr])
        gamma = ceinsum('ako,ao,alo->akl', ctrl_i.conj(), ws_g,
                        ctrl_i).re
    else:
        gamma_igrand = numeric._integrand_core(s, s_im, ctrl, None, idx,
                                               'total', 'generalized')
        gamma = util.integrate(gamma_igrand, omega) / (2 * np.pi)
    k_fn = numeric._cumulant_contract_core(gamma, tg)
    if second_order:
        cumul = step.cumsum(axis=0)[:-1]
        f = eigvals.dtype
        cum_pad = C(
            jnp.concatenate([jnp.zeros((1,) + cumul.re.shape[1:], f),
                             cumul.re]),
            jnp.concatenate([jnp.zeros((1,) + cumul.im.shape[1:], f),
                             cumul.im]))
        if s_im is None and s.ndim <= 2:
            # diagonal spectra: frequency shifts with the integral
            # folded into the contractions -- the (a, b, k, l, omega)
            # second-order filter function is never materialized
            ws = (s if s.ndim == 2
                  else jnp.broadcast_to(s, (len(idx), s.shape[-1])))
            ws = ws * numeric.trapezoid_weights(omega) / (2 * np.pi)
            delta = numeric._second_order_diag_shifts(
                eigvals, n_t._map(lambda v: v[idx_arr]), b_t,
                step._map(lambda v: v[:, idx_arr]),
                cum_pad._map(lambda v: v[:, idx_arr]), omega, p.dt, ws,
                dtype=so_dtype).re
        else:
            f2 = numeric._second_order_total(eigvals, n_t, b_t, step,
                                             cum_pad, omega, p.dt)
            delta_igrand = numeric._integrand_core(s, s_im, None, f2,
                                                   idx, 'total',
                                                   'generalized')
            delta = util.integrate(delta_igrand, omega) / (2 * np.pi)
        k_fn = k_fn + numeric._cumulant_contract_core(delta, td)
    k_total = k_fn.sum(axis=tuple(range(k_fn.ndim - 2)))
    from .cplx import expm_real
    return expm_real(k_total)


def batched_error_transfer_matrix(p: PulseArrays, spectrum, omega,
                                  basis: Basis,
                                  second_order: bool = False
                                  ) -> jnp.ndarray:
    """Error transfer matrices for a batch of pulses (leading batch
    axis on c_coeffs / n_coeffs / dt; shared operators, basis, spectrum
    and frequencies) in one vmapped fused executable.

    Output shape (batch, d^2, d^2)."""
    n_nops = p.n_opers.shape[0]
    if (isinstance(spectrum, jax.Array)
            and not jnp.issubdtype(spectrum.dtype, jnp.complexfloating)
            and spectrum.ndim <= 2):
        # Device-resident real diagonal spectrum: pass through without
        # the host round trip np.asarray would force (production
        # callers stage the loop-constant spectrum once; re-fetching
        # and re-uploading it every call costs two transfers).  Shape
        # errors surface at trace time.
        s = jnp.broadcast_to(spectrum, (n_nops,) * (2 - spectrum.ndim)
                             + spectrum.shape)
        s_im = None
    else:
        spectrum = util.parse_spectrum(np.asarray(spectrum), omega,
                                       np.arange(n_nops))
        s = jnp.asarray(spectrum.real)
        s_im = jnp.asarray(spectrum.imag) if np.iscomplexobj(spectrum) \
            else None
    tg, td = numeric._cumulant_trace_combos_dev(basis)
    return _etm_batched(p, s, s_im, jnp.asarray(omega), tg,
                        td if second_order else None,
                        second_order, tuple(range(n_nops)),
                        _so_shift_dtype())


@functools.partial(jax.jit,
                   static_argnames=('second_order', 'idx', 'so_dtype'))
def _etm_batched(p: PulseArrays, s, s_im, omega, tg, td,
                 second_order: bool, idx, so_dtype=None):
    def single(c_coeffs, n_coeffs, dt):
        pa = PulseArrays(p.c_opers, c_coeffs, p.n_opers, n_coeffs, dt,
                         p.basis)
        return _etm_core.__wrapped__(pa, s, s_im, omega, tg, td,
                                     second_order, idx, so_dtype)
    return jax.vmap(single)(p.c_coeffs, p.n_coeffs, p.dt)


def _infid_prep(p: PulseArrays, c_coeffs, n_coeffs, dt, omega):
    """Diagonalization + per-segment K4 ingredients of one pulse (the
    elementwise-heavy front of the infidelity pipeline)."""
    from . import config
    ham = ceinsum('jmn,jg->gmn', p.c_opers, c_coeffs)
    eigvals, eigvecs, propagators = numeric._diagonalize_jit(ham, dt)
    t = jnp.concatenate([jnp.zeros(1, dt.dtype), jnp.cumsum(dt)])
    G, d = eigvals.shape
    return numeric._ctrlmat_step_terms(
        eigvals, eigvecs, propagators[:-1], omega, p.basis, p.n_opers,
        n_coeffs, dt, t[:-1],
        transform_dtype=config.transform_dtype(G * d * d))


def _infid_contract(terms, spectrum, omega, d: int,
                    escalation: str = 'auto'):
    """Control-matrix contraction + spectral integral (the matmul-heavy
    back of the infidelity pipeline); matches :func:`infidelity`.

    With ``escalation='stat'`` returns ``(infidelity, ratio)`` where
    *ratio* is the scalar quantization-noise statistic of the deep
    factored contraction (0 when that regime is off)."""
    _, n_t, b_t, ph, integral = terms
    res = numeric._ctrlmat_contract(n_t, integral, b_t, ph, escalation)
    ctrl, ratio = res if escalation == 'stat' else (res, None)
    diag = (ctrl.re * ctrl.re + ctrl.im * ctrl.im).sum(axis=1)
    infid = util.integrate(diag * spectrum, omega) / (2 * np.pi * d)
    return (infid, ratio) if escalation == 'stat' else infid


def _escalation_tol(p: PulseArrays) -> float:
    """The active escalation threshold for this pulse's contraction, or
    0 when escalation cannot fire (native mode, unfactored, shallow /
    very deep reduction, or escalation disabled) -- resolved at trace
    time so healthy shapes never carry the recompute branch."""
    from . import config
    if (config.contraction_mode() != 'ozaki'
            or not config.ozaki_factored()):
        return 0.0
    from .ops.ozaki import DEFAULT_PRECISION_BITS, _slice_params
    G = p.dt.shape[-1]
    d = p.c_opers.shape[-1]
    sb, _ = _slice_params(G * d * d, DEFAULT_PRECISION_BITS)
    if sb not in (5, 6):
        return 0.0
    return config.ozaki_escalation_tol()


def batched_infidelity(p: PulseArrays, spectrum: jnp.ndarray,
                       omega: jnp.ndarray,
                       chunk_size: Optional[int] = None) -> jnp.ndarray:
    """Infidelity vmapped over a leading batch axis of c_coeffs /
    n_coeffs / dt (shared operators and basis).

    ``vmap`` hoists the per-pulse omega-lattice workspaces for the whole
    batch into device memory at once (~0.5 GiB/pulse for the d=16,
    1000-frequency flagship); pass ``chunk_size`` to evaluate the batch
    in sequential
    chunks of that many vmapped pulses, bounding peak memory at
    ~2 x chunk_size pulses with no accuracy impact.  The batch must
    divide evenly into chunks.

    The chunked path is SOFTWARE-PIPELINED: a skewed ``lax.scan``
    carries chunk i's contraction inputs and computes them concurrently
    with chunk i+1's preparation, so each scan body offers the
    scheduler independent matmul work (the contraction) and
    elementwise work (diagonalization, transforms, integral tables).
    Values are bit-identical to the naive serial chunking.

    Precision escalation is decided OUTSIDE the vmap: the fast pass
    collects each pulse's cancellation statistic
    (numeric._deep_quant_ratio) and a single scalar ``lax.cond`` on the
    batch maximum re-runs the whole batch at full precision only when
    some pulse predicts a parity breach.  (Leaving the reference cond
    inside the vmapped contraction lowers it to a both-branches
    ``select`` -- every healthy call then pays the escalated
    recompute.)

    Output shape (batch, n_nops)."""
    batch = p.c_coeffs.shape[0]
    d = p.c_opers.shape[-1]

    def single(c_coeffs, n_coeffs, dt, escalation):
        terms = _infid_prep(p, c_coeffs, n_coeffs, dt, omega)
        return _infid_contract(terms, spectrum, omega, d, escalation)

    if chunk_size is None or chunk_size >= batch:
        infid, ratios = jax.vmap(
            lambda cc, nc, dts: single(cc, nc, dts, 'stat'))(
            p.c_coeffs, p.n_coeffs, p.dt)
    else:
        if chunk_size < 1 or batch % chunk_size:
            raise ValueError(f'chunk_size {chunk_size} must be positive '
                             f'and divide batch {batch}')
        vprep = jax.vmap(
            lambda cc, nc, dts: _infid_prep(p, cc, nc, dts, omega))
        vcontract = jax.vmap(
            lambda terms: _infid_contract(terms, spectrum, omega, d,
                                          'stat'))

        n_chunks = batch // chunk_size
        parts = tuple(a.reshape((n_chunks, chunk_size) + a.shape[1:])
                      for a in (p.c_coeffs, p.n_coeffs, p.dt))
        carry0 = vprep(parts[0][0], parts[1][0], parts[2][0])

        def body(carry, xs):
            out = vcontract(carry)           # chunk i   (matmuls)
            new = vprep(*xs)                 # chunk i+1 (elementwise)
            return new, out

        last, outs = jax.lax.scan(body, carry0,
                                  tuple(x[1:] for x in parts))
        infid_last, ratio_last = vcontract(last)
        infid = jnp.concatenate(
            [outs[0].reshape((-1,) + outs[0].shape[2:]), infid_last])
        ratios = jnp.concatenate([outs[1].reshape(-1), ratio_last])

    tol = _escalation_tol(p)
    if tol <= 0:
        return infid

    def _forced(operand):
        pb, s, om = operand
        return _batched_infidelity_forced(pb, s, om, chunk_size)

    return jax.lax.cond(ratios.max() > tol, _forced,
                        lambda operand: infid, (p, spectrum, omega))


def _batched_infidelity_forced(p: PulseArrays, spectrum, omega,
                               chunk_size: Optional[int]) -> jnp.ndarray:
    """Full-precision recompute of the whole batch (escalated branch of
    :func:`batched_infidelity`; rare, so plain serial chunking)."""
    batch = p.c_coeffs.shape[0]
    d = p.c_opers.shape[-1]

    def single(c_coeffs, n_coeffs, dt):
        terms = _infid_prep(p, c_coeffs, n_coeffs, dt, omega)
        return _infid_contract(terms, spectrum, omega, d, 'force')

    if chunk_size is None or chunk_size >= batch:
        return jax.vmap(single)(p.c_coeffs, p.n_coeffs, p.dt)
    n_chunks = batch // chunk_size
    parts = tuple(a.reshape((n_chunks, chunk_size) + a.shape[1:])
                  for a in (p.c_coeffs, p.n_coeffs, p.dt))
    _, outs = jax.lax.scan(
        lambda carry, xs: (carry, jax.vmap(single)(*xs)), None, parts)
    return outs.reshape((-1,) + outs.shape[2:])
