"""Analytic filter-function and infidelity derivatives (JAX
rebuild of /root/reference/filter_functions/gradient.py; formalism from
Le et al., PRApplied 17, 024006 (2022)).

Only auto-correlated noise (no cross-spectra) is supported, matching
the reference (gradient.py:33-34).  In addition to these closed forms,
``jax.grad`` through :func:`~.numeric.infidelity` provides automatic
differentiation; the two serve as mutual cross-checks (see
tests/test_gradient.py).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import numeric, superoperator, util
from .basis import Basis
from .cplx import C, asc, ceinsum, cexp, matmul, where

__all__ = ['calculate_derivative_of_control_matrix_from_scratch',
           'calculate_filter_function_derivative', 'infidelity_derivative']


def _derivative_integral(omega: jnp.ndarray, eigvals: jnp.ndarray,
                         dt) -> C:
    r"""K3: the integral in the control-matrix derivative, shape
    (n_omega, d, d, d, d) indexed (o, p, q, m, n)
    (gradient.py:69-108).

    With y = omega + Omega_mn, z = y + Omega_pq,
    frac(u) = (e^{i u dt} - 1)/u (frac(0) = i dt)::

        Omega_pq != 0:  (frac(y) - frac(z)) / Omega_pq
        Omega_pq == 0:  (frac(y) - i dt e^{i y dt}) / y   (y != 0)
                        dt^2 / 2                          (y == 0)
    """
    d = eigvals.shape[0]
    d2 = d * d
    n_w = omega.shape[0]
    dE = (eigvals[:, None] - eigvals[None, :]).reshape(d2)
    y = omega[:, None] + dE[None]                        # (o, mn)

    # All lattice work on flattened (o, d^2 [* d^2]) layouts (tiny
    # trailing dims pad to full 128-lane registers), with sin/cos by
    # angle addition: O(n_w + d^2) software-emulated transcendentals
    # instead of O(n_w d^4).
    so, co = jnp.sin(omega * dt)[:, None], jnp.cos(omega * dt)[:, None]
    sd, cd = jnp.sin(dE * dt)[None], jnp.cos(dE * dt)[None]
    sy = so * cd + co * sd
    cy = co * cd - so * sd

    from .numeric import _frac_from_trig
    frac_y = _frac_from_trig(y, sy, cy, dt)              # (o, mn)

    # z[o, pq*d2 + mn] = y[o, mn] + dE[pq]; trig again by addition
    def rep(v):
        return jnp.repeat(v, d2, axis=-1)

    def til(v):
        return jnp.tile(v, (1, d2)) if v.ndim == 2 else jnp.tile(v, d2)

    z = til(y) + rep(dE)[None]
    sz = til(sy) * rep(cd) + til(cy) * rep(sd)
    cz = til(cy) * rep(cd) - til(sy) * rep(sd)
    frac_z = _frac_from_trig(z, sz, cz, dt)              # (o, pq*mn)

    mask_pq = (dE != 0.0)
    r_pq = rep(1.0 / jnp.where(mask_pq, dE, 1.0))[None]
    general = (frac_y._map(til) - frac_z) * r_pq

    mask_y = y != 0.0
    r_y = 1.0 / jnp.where(mask_y, y, 1.0)
    num = frac_y - C(-sy * dt, cy * dt)                  # frac - i dt e^{iy}
    diag_val = where(mask_y, num * r_y,
                     C(jnp.full_like(y, dt * dt / 2)))
    out = where(rep(mask_pq)[None], general, diag_val._map(til))
    return out.reshape(n_w, d, d, d, d)


def _liouville_derivative(dt: jnp.ndarray, propagators: C, basis: Basis,
                          eigvecs: C, eigvals: jnp.ndarray,
                          c_opers_transformed: C) -> jnp.ndarray:
    r"""Derivatives of the cumulative propagators in Liouville
    representation, shape (n_dt-1, n_ctrl, n_dt, d**2, d**2)
    (gradient.py:111-197).

    Unlike the reference (which masks only the diagonal,
    gradient.py:173), degenerate off-diagonal eigenvalue pairs also get
    the correct dt limit here.
    """
    n, d = eigvals.shape
    n_ctrl = c_opers_transformed.shape[1]
    omega_diff = eigvals[:, :, None] - eigvals[:, None, :]
    mask = omega_diff == 0.0
    od_safe = jnp.where(mask, 1.0, omega_diff)
    dt_b = dt[:, None, None]
    # i (1 - e^{i w dt}) / w ; w -> 0 limit dt
    e = cexp(omega_diff * dt_b)
    a_mat = where(mask, C(jnp.broadcast_to(dt_b, omega_diff.shape)),
                  C(e.im / od_safe, (1.0 - e.re) / od_safe))

    pre = matmul(matmul(propagators[1:], propagators[:-1].H), eigvecs)
    mid = ceinsum('gmn,ghmn->ghmn', a_mat, c_opers_transformed)
    # U_deriv[g, h] = -i pre (A o H) V^dag
    u_deriv = ceinsum('gab,ghbc,gdc->ghad', pre, mid, eigvecs.conj())
    u_deriv = C(u_deriv.im, -u_deriv.re)                 # multiply by -i

    # transformed: Q_{s+1}^dag U_deriv[s] Q_s  for s = 0..n-2.
    # This one is NOT a conjugation (different unitaries left/right),
    # so the d = 2 SO(3) shortcut does not apply.
    ut = ceinsum('gba,ghbc,gcd->ghad', propagators[1:n].conj(),
                 u_deriv[:n - 1], propagators[:n - 1])
    # propagators_deriv[h, t, s] = theta(s<=t) Q_{t+1} UT[s]
    pd = ceinsum('tab,shbc->htsac', propagators[1:n], ut)
    tri = jnp.tril(jnp.ones((n - 1, n - 1), bool))       # s <= t
    pd = pd * tri[None, :, :, None, None]
    # pad s axis to length n (last column identically zero)
    pad = [(0, 0)] * 5
    pad[2] = (0, 1)
    pd = C(jnp.pad(pd.re, pad), jnp.pad(pd.im, pad))

    # C_j Q_{t+1} C_k  for t = 0..n-2
    cqc = ceinsum('jab,tbc,kcd->tjkad', basis.dev, propagators[1:n],
                  basis.dev)
    liouville_deriv = ceinsum('htsba,tjkba->thsjk', pd.conj(), cqc)
    return 2.0 * liouville_deriv.re


def calculate_derivative_of_control_matrix_from_scratch(
        omega, propagators, eigvals, eigvecs, basis: Basis, t, dt,
        n_opers, n_coeffs, c_opers, n_coeffs_deriv=None,
        intermediates: Optional[Dict] = None) -> C:
    r"""Derivative of the control matrix w.r.t. control amplitudes,
    shape (n_ctrl, n_omega, n_dt, n_nops, d**2)
    (gradient.py:384-523)."""
    omega = jnp.asarray(omega)
    eigvals = jnp.asarray(eigvals)
    dt = jnp.asarray(np.asarray(dt, dtype=float))
    t = jnp.asarray(t)
    eigvecs, propagators = asc(eigvecs), asc(propagators)
    n_opers, c_opers = asc(n_opers), asc(c_opers)
    n_coeffs = jnp.asarray(np.asarray(n_coeffs, dtype=float))

    intermediates = intermediates or {}
    d = eigvecs.shape[-1]
    if d == 2:
        # closed-form SU(2) -> SO(3) conjugations (numeric._conjugate_d2)
        basis_transformed = numeric._conjugate_d2(eigvecs, basis.dev)
        c_opers_transformed = numeric._conjugate_d2(eigvecs, c_opers)
    else:
        # (g, j, d, d): V^dag C_j V  [unpropagated, unlike K4's version]
        basis_transformed = ceinsum('gba,jbc,gcd->gjad', eigvecs.conj(),
                                    basis.dev, eigvecs)
        # (g, h, d, d): V^dag H_h V   [no coefficients]
        c_opers_transformed = ceinsum('gba,hbc,gcd->ghad',
                                      eigvecs.conj(), c_opers, eigvecs)
    n_t = intermediates.get('n_opers_transformed')
    if n_t is None:
        n_t = numeric._transform_hamiltonian(eigvecs, n_opers, n_coeffs)
    n_t = n_t.swapaxes(0, 1)                             # (g, a, d, d)
    integral = intermediates.get('first_order_integral')
    if integral is None:
        integral = numeric._first_order_integral_batched(omega, eigvals, dt)

    propagators_liouville = superoperator.liouville_representation(
        propagators[:-1], basis)
    pl_deriv = _liouville_derivative(dt, propagators, basis, eigvecs,
                                     eigvals, c_opers_transformed)

    phase_factors = cexp(t[:-1, None] * omega[None, :])  # (g, o)
    n_dt = len(dt)

    # Single-segment control matrices (no Liouville propagator):
    # the reference's per-step 'o,icd,adc,odc->aio' (gradient.py:494-496)
    ctrlmat_step = ceinsum('go,gjcd,gadc,godc->gajo', phase_factors,
                           basis_transformed, n_t, integral)

    ncd = None if n_coeffs_deriv is None else jnp.asarray(
        np.asarray(n_coeffs_deriv, dtype=float))

    def body2(_, xs):
        """Per-segment derivative kernel::

            M[a,h,o,k,n] = sum_m Hbar_h[k,m] Bbar_a[m,n] I[o,k,m,m,n]
                         - sum_m Bbar_a[k,m] Hbar_h[m,n] I[o,m,n,k,m]
            dB[a,j,h,o]  = i phase[o] sum_{kn} Cbar_j[n,k] M[a,h,o,k,n]
                           (+ (ds_a/du_h / s_a) B_step[a,j,o])
        """
        if ncd is None:
            ev_g, dt_g, b_t_g, c_t_g, n_t_g, ph_g, step_g = xs
            nc_g = ncd_g = None
        else:
            (ev_g, dt_g, b_t_g, c_t_g, n_t_g, ph_g, step_g, nc_g,
             ncd_g) = xs
        di = _derivative_integral(omega, ev_g, dt_g)
        m1 = ceinsum('hkm,amn,okmmn->ahokn', c_t_g, n_t_g, di)
        m2 = ceinsum('akm,hmn,omnkm->ahokn', n_t_g, c_t_g, di)
        db = ceinsum('o,jnk,ahokn->ajho', ph_g, b_t_g, m1 - m2)
        db = C(-db.im, db.re)
        if ncd is not None:
            ratio = ncd_g / nc_g[:, None]                # (a, h)
            db = db + ceinsum('ah,ajo->ajho', ratio, step_g)
        return None, db

    xs = [eigvals, dt, basis_transformed, c_opers_transformed, n_t,
          phase_factors, ctrlmat_step]
    if ncd is not None:
        xs += [n_coeffs.T, jnp.moveaxis(ncd, -1, 0)]     # (g, a), (g, a, h)
    _, step_deriv = lax.scan(body2, None, tuple(xs))     # (g, a, j, h, o)

    # ctrlmat_deriv[h, o, g, a, k] = step_deriv[g,a,j,h,o] QL[g][j,k]
    ctrlmat_deriv = ceinsum('gajho,gjk->hogak', step_deriv,
                            propagators_liouville)
    # + sum over t,s of step[t] d(QL)/du (gradient.py:519-521)
    correction = ceinsum('tajo,thsjk->hosak', ctrlmat_step[1:], pl_deriv)
    return ctrlmat_deriv + correction


def calculate_filter_function_derivative(ctrlmat: C,
                                         ctrlmat_deriv: C) -> jnp.ndarray:
    r"""dF_a(w)/du_h(t_g) = 2 Re sum_k B*_{ak} dB_{ak}
    (gradient.py:526-556); returns (n_nops, n_dt, n_ctrl, n_omega)."""
    out = ceinsum('ako,hotak->atho', asc(ctrlmat).conj(),
                  asc(ctrlmat_deriv))
    return 2.0 * out.re


def infidelity_derivative(pulse, spectrum, omega,
                          control_identifiers=None,
                          n_oper_identifiers=None,
                          n_coeffs_deriv=None) -> jnp.ndarray:
    r"""dI/du_h(t_g) = 1/(2 pi d) int dw S(w) dF(w)/du
    (gradient.py:559-676); returns (n_nops, n_dt, n_ctrl)."""
    spectrum = util.parse_spectrum(spectrum, omega,
                                   range(len(pulse.n_opers)))
    ff_deriv = pulse.get_filter_function_derivative(
        omega, control_identifiers, n_oper_identifiers, n_coeffs_deriv)
    integrand = jnp.asarray(spectrum)[..., None, None, :] * ff_deriv
    return util.integrate(integrand, jnp.asarray(omega)) \
        / (2 * np.pi * pulse.d)
