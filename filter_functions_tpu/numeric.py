"""Numerical kernels for filter-function computation (JAX rebuild
of /root/reference/filter_functions/numeric.py).

Every kernel here is a pure function over split-complex
(:class:`~.cplx.C`) and real jnp arrays, jit-compiled with static shape
keys.  The reference's per-segment Python loops (numeric.py:846, 1636)
become batched einsum lattices or ``lax.scan`` chains; the serial
cumulative propagator product (util.adot) is a log-depth associative
scan; buffer-reuse tricks (``out=``/``where=``) become ``jnp.where``
chains that XLA fuses.

Public API parity:
  calculate_control_matrix_from_scratch    numeric.py:707-881   (K4)
  calculate_control_matrix_from_atomic     numeric.py:621-704   (K5)
  calculate_control_matrix_periodic        numeric.py:884-954   (K6)
  calculate_noise_operators_from_scratch   numeric.py:456-618   (K7)
  calculate_noise_operators_from_atomic    numeric.py:377-453   (K7)
  calculate_filter_function                numeric.py:1413-1467 (K8)
  calculate_pulse_correlation_filter_function numeric.py:1821-1883 (K9)
  calculate_second_order_filter_function_from_scratch numeric.py:1470-1699 (K10)
  calculate_second_order_filter_function_from_atomic  numeric.py:1702-1818 (K11)
  calculate_decay_amplitudes               numeric.py:1194-1337 (K13)
  calculate_frequency_shifts               numeric.py:1340-1410 (K14)
  calculate_cumulant_function              numeric.py:957-1191  (K15)
  diagonalize                              numeric.py:1886-1935 (K0)
  error_transfer_matrix                    numeric.py:1938-2059 (K16)
  infidelity                               numeric.py:2062-2332 (K17)
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import config, util
from .basis import Basis
from .cplx import (C, asc, ceinsum, ceinsum2, cexp, cexpm1, eigh,
                   expm_real, geometric_series, matmul, where)

__all__ = ['calculate_control_matrix_from_atomic',
           'calculate_control_matrix_from_scratch',
           'calculate_control_matrix_periodic', 'calculate_cumulant_function',
           'calculate_decay_amplitudes', 'calculate_filter_function',
           'calculate_frequency_shifts',
           'calculate_noise_operators_from_atomic',
           'calculate_noise_operators_from_scratch',
           'calculate_pulse_correlation_filter_function',
           'calculate_second_order_filter_function_from_scratch',
           'calculate_second_order_filter_function_from_atomic',
           'diagonalize', 'error_transfer_matrix', 'infidelity']

#: Diagnostic counters for shape-gated fast paths (tests assert the
#: branches are actually entered at scale; no runtime semantics).
from collections import Counter as _Counter
_fastpath_hits = _Counter()


# -----------------------------------------------------------------------------
# Shared helpers
# -----------------------------------------------------------------------------
def _propagate_eigenvectors(propagators: C, eigvecs: C) -> C:
    """Q_g^dag V_g, batched (numeric.py:93-95 equivalent)."""
    return matmul(propagators.H, eigvecs)


def _transform_hamiltonian(eigvecs: C, opers: C, coeffs=None) -> C:
    """s_a^(g) V^(g)dag B_a V^(g) -> shape (n_opers, G, d, d)
    (numeric.py:98-123 equivalent).

    d = 2 takes the closed-form SU(2) -> SO(3) route
    (:func:`_conjugate_d2`): elementwise, no matmuls."""
    if eigvecs.shape[-1] == 2 and opers.re.ndim == 3:
        transformed = _conjugate_d2(eigvecs, opers)._map(
            lambda x: x.swapaxes(0, 1))
    else:
        transformed = ceinsum('gba,jbc,gcd->jgad', eigvecs.conj(),
                              opers, eigvecs)
    if coeffs is not None:
        transformed = transformed * jnp.asarray(coeffs)[:, :, None, None]
    return transformed


def _transform_by_unitary(unitary: C, oper: C) -> C:
    """U^dag C_k U with broadcasting (numeric.py:126-141 equivalent)."""
    return matmul(unitary.H, matmul(oper, unitary))


def _su2_rotation(v: C) -> jnp.ndarray:
    r"""SO(3) rotation matrix M of conjugation by a 2x2 unitary:
    V^dag sigma_k V = sum_j M[..., k, j] sigma_j.

    Conjugation is insensitive to the U(1) phase, so V is projected to
    SU(2) via U = V / sqrt(det V) (branch irrelevant: +-U give the
    same rotation), the quaternion (w, x, y, z) is read off
    U = w - i(x sx + y sy + z sz) elementwise, and M is the standard
    quaternion rotation matrix -- convention verified against the
    trace formula M_kj = Tr(sigma_j V^dag sigma_k V)/2.

    Pure lane-parallel elementwise arithmetic (~40 real ops per
    matrix, no matmuls): at d = 2 this replaces the conjugation
    einsums whose tiny 2x2 operands make poor matrix products.

    v: C of shape (..., 2, 2).  Returns (..., 3, 3) real (v's dtype).
    """
    v00 = (v.re[..., 0, 0], v.im[..., 0, 0])
    v01 = (v.re[..., 0, 1], v.im[..., 0, 1])
    v10 = (v.re[..., 1, 0], v.im[..., 1, 0])
    v11 = (v.re[..., 1, 1], v.im[..., 1, 1])
    # det V (unit modulus for unitary V)
    dr = v00[0] * v11[0] - v00[1] * v11[1] \
        - (v01[0] * v10[0] - v01[1] * v10[1])
    di = v00[0] * v11[1] + v00[1] * v11[0] \
        - (v01[0] * v10[1] + v01[1] * v10[0])
    # s = sqrt(det): half-angle formulas, the dr ~ -1 branch switched
    # to the cancellation-free pair
    pos = dr >= 0.0
    root_p = jnp.sqrt(jnp.where(pos, (1.0 + dr) / 2, 1.0))
    root_m = jnp.sqrt(jnp.where(pos, 1.0, (1.0 - dr) / 2))
    sgn = jnp.where(di < 0.0, -1.0, 1.0)
    s_re = jnp.where(pos, root_p, jnp.abs(di) / (2 * root_m))
    s_im = jnp.where(pos, di / (2 * root_p), sgn * root_m)
    # U = V / s = V * conj(s); quaternion from alpha = U00, beta = U01
    w = v00[0] * s_re + v00[1] * s_im          # Re alpha
    z = -(v00[1] * s_re - v00[0] * s_im)       # -Im alpha
    y = -(v01[0] * s_re + v01[1] * s_im)       # -Re beta
    x = -(v01[1] * s_re - v01[0] * s_im)       # -Im beta
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz),
                      2 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz),
                      2 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2 * (xz - wy), 2 * (yz + wx),
                      1 - 2 * (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def _conjugate_d2(v: C, opers: C) -> C:
    r"""W_g^dag K_k W_g for all (g, k) at d = 2 via the SO(3) route:
    decompose K_k = c0 I + c . sigma (complex coefficients span every
    2x2 matrix), rotate the sigma-vector by :func:`_su2_rotation`'s M,
    and reassemble -- no matmuls, every step lane-parallel elementwise
    (the natural sequel to the closed-form 2x2 eigh fast path; cf.
    reference /root/reference/filter_functions/numeric.py:98-123 for
    the semantics).

    v: (G, 2, 2); opers: (n_k, 2, 2) shared across g, or (G, n_k, 2, 2)
    per-g (e.g. the propagator-derivative chain).  Returns
    (G, n_k, 2, 2), matching :func:`_conjugate_mxu`.
    """
    per_g = opers.re.ndim == 4
    m_rot = _su2_rotation(v)                               # (G, 3, 3)

    def decomp(o):
        c0 = (o[..., 0, 0] + o[..., 1, 1]) / 2
        cx = (o[..., 0, 1] + o[..., 1, 0]) / 2
        cz = (o[..., 0, 0] - o[..., 1, 1]) / 2
        return c0, cx, cz

    c0_re, cx_re, cz_re = decomp(opers.re)
    c0_im, cx_im, cz_im = decomp(opers.im)
    # c_y = i (B01 - B10)/2
    cy_re = -(opers.im[..., 0, 1] - opers.im[..., 1, 0]) / 2
    cy_im = (opers.re[..., 0, 1] - opers.re[..., 1, 0]) / 2
    c_re = jnp.stack([cx_re, cy_re, cz_re], axis=-1)
    c_im = jnp.stack([cx_im, cy_im, cz_im], axis=-1)
    # c'_j[g, k] = sum_m c_m[k] M[g, m, j] (M real: re/im separately)
    sig = 'gkm,gmj->gkj' if per_g else 'km,gmj->gkj'
    cp_re = jnp.einsum(sig, c_re, m_rot)
    cp_im = jnp.einsum(sig, c_im, m_rot)
    if not per_g:
        c0_re, c0_im = c0_re[None, :], c0_im[None, :]

    def assemble(c0, cp, cy_other):
        # rows: [[c0 + cz', cx' - i cy'], [cx' + i cy', c0 - cz']];
        # the i cy' cross-term swaps into the other component
        o00 = c0 + cp[..., 2]
        o11 = c0 - cp[..., 2]
        o01 = cp[..., 0] + cy_other
        o10 = cp[..., 0] - cy_other
        return jnp.stack([jnp.stack([o00, o01], axis=-1),
                          jnp.stack([o10, o11], axis=-1)], axis=-2)

    out_re = assemble(c0_re, cp_re, cp_im[..., 1])
    out_im = assemble(c0_im, cp_im, -cp_re[..., 1])
    return C(out_re, out_im)


def _conjugate_mxu(w: C, opers: C) -> C:
    """W_g^dag K_k W_g for all (g, k) -> (G, n_k, d, d) via two Ozaki
    digit-slice matmul sets instead of a float64 einsum.

    Unlike downcasting the eigenvector frame (config.transform_dtype:
    ~1e-6 flagship parity), the Ozaki truncation here is post-hoc
    RESULT noise from exact digit slices of the f64 inputs -- ~1.5e-10
    max element error at flagship shapes, 700x below the factored
    contraction's own 23-bit operand quantization.
    """
    from .ops.ozaki import ozaki_matmul_c
    G, d, _ = w.shape
    n_k = opers.shape[0]
    # stage 1: T1[(g a), (k c)] = sum_b conj(W)[g, b, a] K[k, b, c]
    a_stack = w.conj()._map(
        lambda x: x.transpose(0, 2, 1).reshape(G * d, d))
    c_flat = opers._map(
        lambda x: x.transpose(1, 0, 2).reshape(d, n_k * d))
    re1, im1 = ozaki_matmul_c(a_stack.re, a_stack.im,
                              c_flat.re, c_flat.im)
    t1 = C(re1, im1).reshape(G, d, n_k, d)._map(
        lambda x: x.transpose(0, 2, 1, 3).reshape(G, n_k * d, d))
    # stage 2: out[g, (k a), d'] = sum_c T1 W[g, c, d']
    re2, im2 = ozaki_matmul_c(t1.re, t1.im, w.re, w.im)
    return C(re2, im2).reshape(G, n_k, d, d)


def _first_order_integral_batched(omega: jnp.ndarray, eigvals: jnp.ndarray,
                                  dt: jnp.ndarray) -> C:
    r"""K1: I^{(g)}_{mn}(omega) = (e^{i phi dt_g} - 1)/(i phi),
    phi = omega + Omega_mn, with the phi -> 0 limit dt_g
    (numeric.py:144-167).

    Shapes: omega (n_omega,), eigvals (..., d), dt (...,).
    Returns C of shape (..., n_omega, d, d).  Closed form:
    I = [sin(phi dt) + 2i sin^2(phi dt / 2)] / phi.

    f64 transcendentals dominate the table cost, so the phase is
    factored: with x = (omega + Omega) dt,
    sin/cos(x) come from the angle-addition of e^{i omega dt} (one
    (..., n_w) table) and e^{i Omega dt} (one (..., d, d) table) --
    O(n_w + d^2) sins instead of O(n_w d^2).  I = -i frac(phi) with
    frac handled by :func:`_frac_from_trig`.
    """
    dE = eigvals[..., :, None] - eigvals[..., None, :]   # (..., d, d)
    dt_b = dt[..., None, None, None]
    phi = omega[:, None, None] + dE[..., None, :, :]

    a = omega * dt[..., None]                            # (..., n_w)
    sa, ca = jnp.sin(a), jnp.cos(a)
    b = dE * dt[..., None, None]                         # (..., d, d)
    sb, cb = jnp.sin(b), jnp.cos(b)
    sa, ca = sa[..., :, None, None], ca[..., :, None, None]
    sb, cb = sb[..., None, :, :], cb[..., None, :, :]
    sin_x = sa * cb + ca * sb
    cos_x = ca * cb - sa * sb

    f = _frac_from_trig(phi, sin_x, cos_x, dt_b)
    return C(f.im, -f.re)


def _frac_from_trig(u, sin_u, cos_u, dt):
    """frac(u) = (e^{iu dt}-1)/u from precomputed sin/cos(u dt); the
    Taylor branch for |u dt| < 0.05 (relative error < 1e-16) covers
    both the u -> 0 limit and the cancellation loss of angle-addition
    product forms."""
    w = u * dt
    small = jnp.abs(w) < 0.05
    inv_u = 1.0 / jnp.where(small, 1.0, u)
    w2 = w * w
    re_t = -dt * w * (0.5 + w2 * (-1.0 / 24.0 + w2 * (
        1.0 / 720.0 + w2 * (-1.0 / 40320.0))))
    im_t = dt * (1.0 + w2 * (-1.0 / 6.0 + w2 * (
        1.0 / 120.0 + w2 * (-1.0 / 5040.0))))
    return C(jnp.where(small, re_t, (cos_u - 1.0) * inv_u),
             jnp.where(small, im_t, sin_u * inv_u))


def _second_order_integral_single(omega: jnp.ndarray, eigvals: jnp.ndarray,
                                  dt) -> C:
    r"""K2: nested second-order integral I_{ijmn}(omega) for ONE segment
    (numeric.py:170-256).

    Full case analysis (x = Omega_ij - omega, y = omega + Omega_mn,
    z = Omega_ij + Omega_mn)::

        y != 0:  ( frac(x) - frac(z) ) / y
        y == 0, x != 0:  ( frac(x) - i dt e^{i x dt} ) / x
        y == 0, x == 0:  dt^2 / 2

    with frac(u) = (e^{i u dt} - 1)/u, frac(0) = i dt.  Unlike the
    reference (which only treats the omega == 0 limits and leaves exact
    omega = -Omega_mn hits untouched, numeric.py:241-255), this handles
    the y -> 0 limit at every frequency.

    Returns C of shape (n_omega, d, d, d, d) indexed (o, i, j, m, n).
    """
    d = eigvals.shape[0]
    d2 = d * d
    n_w = omega.shape[0]
    dE = eigvals[:, None] - eigvals[None, :]            # Omega_ij (d, d)
    de_flat = dE.reshape(d2)
    x = de_flat[None] - omega[:, None]                  # (o, ij)
    y = omega[:, None] + de_flat[None]                  # (o, mn)
    z = (de_flat[:, None] + de_flat[None]).reshape(d2 * d2)

    # sin/cos(x dt) by angle addition: x dt = Omega_ij dt - omega dt,
    # so only O(n_omega + d^2) f64 transcendentals instead of
    # O(n_omega d^2).  All lattice work runs on flattened
    # (o, d^2 [* d^2]) layouts.
    a = -omega * dt                                     # (o,)
    sa, ca = jnp.sin(a)[:, None], jnp.cos(a)[:, None]
    b = de_flat * dt                                    # (ij,)
    sb, cb = jnp.sin(b)[None], jnp.cos(b)[None]
    sin_x = sb * ca + cb * sa
    cos_x = cb * ca - sb * sa

    f_x = _frac_from_trig(x, sin_x, cos_x, dt)          # (o, ij)
    zdt = z * dt
    f_z = _frac_from_trig(z, jnp.sin(zdt), jnp.cos(zdt),
                          dt)                           # (ij*mn,)
    mask_y = y != 0.0                                   # (o, mn)
    # reciprocal once on the small (o, mn) table; the big
    # (o, ij*mn) lattice then only multiplies (f64 divides are far
    # costlier than multiplies under emulation)
    r_y = 1.0 / jnp.where(mask_y, y, 1.0)
    # flatten to (o, ij*mn): ij-major, so f_x repeats along lanes and
    # the mn-tables tile
    fx_big = f_x._map(lambda v: jnp.repeat(v, d2, axis=-1))
    ry_big = jnp.tile(r_y, (1, d2))
    general = (fx_big - f_z[None]) * ry_big

    # y == 0 limit, broadcast over (m, n)
    mask_x = x != 0.0
    r_x = 1.0 / jnp.where(mask_x, x, 1.0)
    num = f_x - C(-sin_x * dt, cos_x * dt)              # f(x) - i dt e^{ixdt}
    special = where(mask_x, num * r_x,
                    C(jnp.full_like(x, dt * dt / 2)))
    out = where(jnp.tile(mask_y, (1, d2)), general,
                special._map(lambda v: jnp.repeat(v, d2, axis=-1)))
    return out.reshape(n_w, d, d, d, d)


def _ds_split(x: jnp.ndarray):
    """Double-single (hi, lo) float32 split of an f64 array: hi is the
    f32 rounding, lo the f32-representable remainder; hi + lo carries
    ~2^-48 relative.  One emulated-f64 subtraction -- call on SMALL
    tables only."""
    hi = x.astype(jnp.float32)
    return hi, (x - hi.astype(x.dtype)).astype(jnp.float32)


def _ds_diff_f32(ah, al, bh, bl):
    """Correctly-rounded-to-f32 difference (ah + al) - (bh + bl) of two
    double-single operands, in six native f32 ops (Knuth two-sum
    error recovery on the hi parts).  This is the K2 lattice's only
    numerically delicate big-lattice operation: when the two operands
    are close (f(x) - f(z) with z - x = y -> 0), the naive f32
    subtraction of pre-rounded values loses everything, while the
    two-sum error term restores the information carried by the lo
    words -- the result is as accurate as computing in f64 and THEN
    rounding to f32 (error ~2^-24 relative to the DIFFERENCE, for
    |y dt| down to ~2^-48/eps_f32 ~ 6e-8 -- far below the 1e-2
    divided-difference threshold of the factored route)."""
    s = ah - bh
    v = s - ah
    e = (ah - (s - v)) - (bh + v)
    return s + (e + (al - bl))


def _frac_divdiff_f32(x, f0: C, sin_x, cos_x, dt, n_k: int) -> C:
    r"""Scaled divided-difference coefficients E_k(x) = D_k(x)/dt^k,
    D_k = -frac^{(k+1)}(x)/(k+1)!, k = 0..n_k-1, of
    frac(u) = (e^{i u dt} - 1)/u, in NATIVE float32: the ds lattice's
    small-y Taylor branch (|y dt| < _SO_SMALL_Y, f32 output target)
    evaluates sum_k E_k (y dt)^k -- both factors O(1)-bounded at every
    SI scale.  The general-purpose f64 table machinery
    (:func:`_frac_divdiff_coeffs`) costs far more than the entire rest
    of the lattice build where f64 elementwise ops are slow.

    Working variable g_k = frac^{(k)}(x)/dt^k (all O(dt)); two branches
    per lattice entry (w = x dt):

    * |w| >= 0.2: the downward recurrence obtained by differentiating
      u frac(u) = e^{i u dt} - 1 k times and rescaling,

          g_k = (i^k dt e^{i x dt} - k g_{k-1}) / w,

      seeded with g_0 = frac(x) (pre-computed f64 table, cast).  Each
      step amplifies relative error by <= k/|w| <= 5x; over three
      steps that is ~1e-6 relative on E_2 -- whose contribution to the
      lattice entry is suppressed by (y dt)^2 <= 1e-4, far below the
      f32 target.
    * |w| < 0.5: the Maclaurin series
      g_k = i^{k+1} dt sum_j (i w)^j / (j! (j + k + 1)),
      truncated at j = 9 (0.5^10/(10! 11) ~ 2e-11 relative).  The
      wide series region keeps the recurrence's numerator cancellation
      (|i^k dt e - k g_{k-1}| ~ |w|/(k+1) of its operands) below a
      2(k+1)x amplification of f32 rounding.

    x, sin_x, cos_x: (n_omega, d^2) tables (any float dtype; cast to
    f32 here); f0 = frac(x) as C.  Returns C (f32) of shape
    (n_k, n_omega, d^2) holding E_k = -g_{k+1} dt/(k+1)!.
    """
    f32 = jnp.float32
    dts = jnp.asarray(dt, f32)
    w = x.astype(f32) * dts
    e_re, e_im = cos_x.astype(f32), sin_x.astype(f32)
    small = jnp.abs(w) < 0.5
    inv_w = 1.0 / jnp.where(small, 1.0, w)

    # series: S_k = sum_{j<=9} (i w)^j / (j! (j+k+1)) by Horner
    n_j = 10
    fact = [math.factorial(j) for j in range(n_j)]
    ser = []
    for k in range(1, n_k + 1):
        s_re = jnp.full_like(w, 1.0 / (fact[n_j - 1] * (n_j + k)))
        s_im = jnp.zeros_like(w)
        for j in range(n_j - 2, -1, -1):
            c = 1.0 / (fact[j] * (j + k + 1))
            s_re, s_im = c - w * s_im, w * s_re       # s = c + i w s
        ser.append((s_re, s_im))

    # i^k cycle as (re, im) pairs
    i_pow = ((1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))
    gk_re, gk_im = f0.re.astype(f32), f0.im.astype(f32)
    out_re, out_im = [], []
    for k in range(1, n_k + 1):
        ik_re, ik_im = i_pow[k % 4]
        rec_re = ((ik_re * e_re - ik_im * e_im) * dts - k * gk_re) \
            * inv_w
        rec_im = ((ik_re * e_im + ik_im * e_re) * dts - k * gk_im) \
            * inv_w
        # series value of g_k = i^{k+1} dt S_k
        i1_re, i1_im = i_pow[(k + 1) % 4]
        s_re, s_im = ser[k - 1]
        se_re = (i1_re * s_re - i1_im * s_im) * dts
        se_im = (i1_re * s_im + i1_im * s_re) * dts
        gk_re = jnp.where(small, se_re, rec_re)
        gk_im = jnp.where(small, se_im, rec_im)
        # E_{k-1} = D_{k-1}/dt^{k-1} = -g_k dt / k!
        scale = jnp.asarray(-1.0 / math.factorial(k), f32) * dts
        out_re.append(gk_re * scale)
        out_im.append(gk_im * scale)
    return C(jnp.stack(out_re), jnp.stack(out_im))


def _second_order_integral_single_f32(omega: jnp.ndarray,
                                      eigvals: jnp.ndarray, dt) -> C:
    r"""K2 lattice for ONE segment with float32 output
    (:func:`_second_order_integral_single` semantics), built WITHOUT
    any big-lattice emulated-f64 arithmetic.

    All (n_omega + d^2)-sized tables (trig, frac, reciprocals, limits)
    stay in f64 exactly as the reference route; the (n_omega, d^4)
    lattice work -- the cost center where f64 elementwise ops are
    slow -- runs in native f32 on double-single
    splits: the cancellation-prone f(x) - f(z) uses
    :func:`_ds_diff_f32`, and the 1/y multiply is plain f32
    (post-cancellation, no amplification).

    Entries with 0 < |y dt| < _SO_SMALL_Y take the divided-difference
    Taylor branch I = sum_{k<3} D_k(x) y^k instead
    (:func:`_frac_divdiff_coeffs`; truncation ~(1e-2)^3/5! ~ 8e-9
    relative, below the f32 output eps): there the general form's
    accuracy is limited by the 48-bit double-single carry (and the f64
    lattice's by its own 53 bits -- BOTH lose everything by
    |y dt| ~ 1e-11 relative), while the series is cancellation-free.
    Output parity vs an exact lattice rounded to f32: ~2^-24 relative
    elementwise at every y, including grazing near-resonances where
    this route is strictly MORE accurate than the f64 lattice.

    Returns C (float32) of shape (n_omega, d, d, d, d).
    """
    d = eigvals.shape[0]
    d2 = d * d
    n_w = omega.shape[0]
    f32 = jnp.float32
    dE = eigvals[:, None] - eigvals[None, :]
    de_flat = dE.reshape(d2)
    x = de_flat[None] - omega[:, None]                  # (o, ij)
    y = omega[:, None] + de_flat[None]                  # (o, mn)
    z = de_flat[:, None] + de_flat[None]                # (ij, mn)

    a = -omega * dt
    sa, ca = jnp.sin(a)[:, None], jnp.cos(a)[:, None]
    b = de_flat * dt
    sb, cb = jnp.sin(b)[None], jnp.cos(b)[None]
    sin_x = sb * ca + cb * sa
    cos_x = cb * ca - sb * sa

    f_x = _frac_from_trig(x, sin_x, cos_x, dt)          # (o, ij) f64
    zdt = z * dt
    f_z = _frac_from_trig(z, jnp.sin(zdt), jnp.cos(zdt),
                          dt)                           # (ij, mn) f64
    mask_y = y != 0.0
    small_y = mask_y & (jnp.abs(y * dt) < _SO_SMALL_Y)
    r_y = (1.0 / jnp.where(mask_y, y, 1.0)).astype(f32)
    mask_x = x != 0.0
    r_x = 1.0 / jnp.where(mask_x, x, 1.0)
    num = f_x - C(-sin_x * dt, cos_x * dt)
    special = where(mask_x, num * r_x,
                    C(jnp.full_like(x, dt * dt / 2)))   # (o, ij) f64

    # divided-difference tables of the small-y Taylor branch: 3 terms
    # cover the f32 budget ((1e-2)^3 truncation ~ 8e-9 relative).  The
    # k-th term is evaluated as (D_k/dt^k) (y dt)^k -- both factors
    # O(1)-bounded, so the f32 downcast cannot over/underflow for
    # SI-unit y, dt (same scale-invariant split as the factored
    # route).  Tables come from the native-f32 recurrence/series
    # (:func:`_frac_divdiff_f32`), not the f64 general machinery.
    n_k = 3
    dks = _frac_divdiff_f32(x, f_x, sin_x, cos_x, dt, n_k)  # (3, o, ij)
    y_f32 = (jnp.where(small_y, y, 0.0) * dt).astype(f32)   # (o, mn)

    # double-single splits of the two frac tables (small, one emulated
    # f64 subtraction each); everything 3-D below is native f32
    fxr_h, fxr_l = _ds_split(f_x.re)
    fxi_h, fxi_l = _ds_split(f_x.im)
    fzr_h, fzr_l = _ds_split(f_z.re)
    fzi_h, fzi_l = _ds_split(f_z.im)

    diff_re = _ds_diff_f32(fxr_h[:, :, None], fxr_l[:, :, None],
                           fzr_h[None], fzr_l[None])    # (o, ij, mn)
    diff_im = _ds_diff_f32(fxi_h[:, :, None], fxi_l[:, :, None],
                           fzi_h[None], fzi_l[None])
    r_b = r_y[:, None, :]
    gen_re = diff_re * r_b
    gen_im = diff_im * r_b

    # small-y Taylor (Horner over the 3 divided-difference tables):
    # native-f32 multiply-adds on the big lattice
    yb = y_f32[:, None, :]
    tay_re = dks.re[0][:, :, None] + yb * (
        dks.re[1][:, :, None] + yb * dks.re[2][:, :, None])
    tay_im = dks.im[0][:, :, None] + yb * (
        dks.im[1][:, :, None] + yb * dks.im[2][:, :, None])
    s_b = small_y[:, None, :]
    gen_re = jnp.where(s_b, tay_re, gen_re)
    gen_im = jnp.where(s_b, tay_im, gen_im)

    m_b = mask_y[:, None, :]
    sp_re = special.re.astype(f32)[:, :, None]
    sp_im = special.im.astype(f32)[:, :, None]
    out_re = jnp.where(m_b, gen_re, jnp.broadcast_to(
        sp_re, gen_re.shape))
    out_im = jnp.where(m_b, gen_im, jnp.broadcast_to(
        sp_im, gen_im.shape))
    return C(out_re, out_im).reshape(n_w, d, d, d, d)


def _so_lattice_mode() -> str:
    """How the K2 integral lattice is built when the consumer works in
    float32 (the Ozaki frequency-shift route): 'ds' (default)
    native-f32 double-single arithmetic
    (:func:`_second_order_integral_single_f32`), 'f64' the emulated-f64
    lattice rounded down (bit-comparable reference, slower where f64
    elementwise ops are slow).  Override with FF_TPU_SO_LATTICE."""
    return os.environ.get('FF_TPU_SO_LATTICE', 'ds')


def _so_factored() -> bool:
    """Whether the separable-table route of the K2 lattice is enabled
    (FF_TPU_SO_FACTORED=1).  Off by default: it is slower on the
    Ozaki path and its per-shape compile cost across a test-suite's worth of
    shapes outweighs its runtime win on CPU.  The lattice route is the
    default everywhere; the factored route stays available for
    natively-f64 production workloads dominated by large n_omega d^4
    lattices."""
    return os.environ.get('FF_TPU_SO_FACTORED', '') not in ('', '0')


_SO_SMALL_Y = 1e-2   # |y dt| below which the divided-difference branch runs
_SO_SMALL_K = 6      # y-Taylor terms: truncation ~ (1e-2)^6/7! ~ 2e-16 rel
_SO_SERIES_W = 0.2   # |u dt| below which frac^(k) runs as a Maclaurin series
_SO_SERIES_J = 12    # series terms: 0.2^13/13! ~ 1e-19 rel


@functools.lru_cache(maxsize=None)
def _frac_divdiff_static(n: int):
    """Static coefficient tensors of :func:`_frac_divdiff_coeffs`.

    The argument lattice is w[o, ij] = a[o] + b[ij], so every
    polynomial in w splits binomially over the two 1-D generators:
    w^j/... = sum_{r+s=j} a^r b^s/(r! s!) normalizations.  Both
    branches then evaluate as (n, J+1, J+1) static tensors contracted
    against the two small power stacks -- the (J+1, n_omega, d^2)
    power lattice of w itself is never materialized (it dominated the
    table cost in the direct form):

    * series: frac^{(k)} = (i dt)^{k+1} sum_j i^j w^j/((j+k+1) j!)
      -> M[k, r, s] = i^{r+s} / ((r+s+k+1) r! s!)
    * closed-form helper S_k(-i w) = sum_{j<=k} (-i)^j w^j/j!
      -> B[k, r, s] = (-i)^{r+s} / (r! s!) for r+s <= k
    """
    J = _SO_SERIES_J
    m_re = np.zeros((n, J + 1, J + 1))
    m_im = np.zeros((n, J + 1, J + 1))
    b_re = np.zeros((n, J + 1, J + 1))
    b_im = np.zeros((n, J + 1, J + 1))
    for k in range(1, n + 1):
        for r in range(J + 1):
            for s in range(J + 1 - r):
                j = r + s
                cj = 1.0 / ((j + k + 1) * math.factorial(r)
                            * math.factorial(s))
                ip = (1.0, 1j, -1.0, -1j)[j % 4]
                m_re[k - 1, r, s] = (ip * cj).real
                m_im[k - 1, r, s] = (ip * cj).imag
                if j <= k:
                    cb = 1.0 / (math.factorial(r) * math.factorial(s))
                    im = (1.0, -1j, -1.0, 1j)[j % 4]
                    b_re[k - 1, r, s] = (im * cb).real
                    b_im[k - 1, r, s] = (im * cb).imag
    ks = np.arange(1, n + 1)
    sgn_fact = (-1.0) ** ks * np.array([math.factorial(k) for k in ks])
    inv_fact = -1.0 / np.array([math.factorial(k) for k in ks])
    return m_re, m_im, b_re, b_im, sgn_fact, inv_fact


def _frac_divdiff_coeffs(a, b, dt, n: int, sin_u, cos_u) -> C:
    r"""Coefficients D_k(u) = -frac^{(k+1)}(u)/(k+1)!, k = 0..n-1, of
    the divided difference

        (frac(u) - frac(u + y))/y = sum_k D_k(u) y^k

    of frac(u) = (e^{i u dt} - 1)/u, on the lattice
    u dt = a[o] + b[ij] (entire, so the series converges for every u
    and y; it is used for |y dt| < _SO_SMALL_Y where the separable
    general form of the K2 lattice would cancel catastrophically).
    Derivatives come from the closed form

        frac^{(k)}(u) = (-1)^k k!/u^{k+1} (e^{i u dt} S_k(-i dt u) - 1),
        S_k(v) = sum_{j<=k} v^j/j!,

    stable for |u dt| > _SO_SERIES_W (the relative error
    eps (k+1)!/|u dt|^{k+1} of its cancelling bracket is amplified by
    the y-suppression (y dt)^k of term k, so even k = 1 only needs
    |u dt| >= 0.2 for 1e-13), and from the Maclaurin series below.
    Both branches are polynomials in w = u dt with static complex
    coefficients, evaluated binomially from 1-D power stacks of a and
    b (:func:`_frac_divdiff_static`) -- no w-power lattice, which both
    shrinks the traced graph and keeps the arithmetic O(n_omega + d^2)
    instead of O(n_omega d^2) per power.

    sin_u/cos_u: precomputed sin/cos of w (the caller already has them
    by angle addition).  Returns C of shape (n, len(a), len(b)).
    """
    m_re, m_im, b_re, b_im, sgn_fact, inv_fact = _frac_divdiff_static(n)
    f = a.dtype
    J = _SO_SERIES_J
    w = a[:, None] + b[None, :]
    small = jnp.abs(w) <= _SO_SERIES_W
    bshape = (n, 1, 1)

    # 1-D power stacks (cumprod: a single primitive, immune to
    # elementwise-chain refusion)
    def powers(v):
        return jnp.cumprod(jnp.concatenate(
            [jnp.ones((1,) + v.shape, f),
             jnp.broadcast_to(v, (J,) + v.shape)]), axis=0)
    apow, bpow = powers(a), powers(b)                     # (J+1, o|ij)

    def poly(c_re, c_im):
        t_re = jnp.einsum('krs,ro->kso', jnp.asarray(c_re, f), apow)
        t_im = jnp.einsum('krs,ro->kso', jnp.asarray(c_im, f), apow)
        return C(jnp.einsum('kso,sm->kom', t_re, bpow),
                 jnp.einsum('kso,sm->kom', t_im, bpow))

    ser = poly(m_re, m_im)
    # (i dt)^{k+1} prefactor, i-cycle folded into static signs
    dt_pow = jnp.stack([dt ** (k + 1) for k in range(1, n + 1)])
    i_cyc = np.array([(1.0, 1j, -1.0, -1j)[(k + 1) % 4]
                      for k in range(1, n + 1)])
    pre = C(i_cyc.real * dt_pow, i_cyc.imag * dt_pow).reshape(*bshape)
    series = ser * pre

    # closed branch: (e^{iw} S_k - 1) * (-1)^k k! (dt/w)^{k+1}
    s_k = poly(b_re, b_im)
    e_u = C(cos_u, sin_u)
    base = dt / jnp.where(small, 1.0, w)                  # dt/w = 1/u
    # (dt/w)^{k+1}, k = 1..n
    ui_stack = jnp.cumprod(jnp.concatenate(
        [(base * base)[None],
         jnp.broadcast_to(base, (n - 1,) + w.shape)]), axis=0)
    ui_stack = ui_stack * jnp.asarray(sgn_fact, f).reshape(bshape)
    closed = (e_u * s_k - 1.0) * ui_stack

    fd = where(jnp.broadcast_to(small, (n,) + w.shape), series, closed)
    return fd * jnp.asarray(inv_fact, f).reshape(bshape)


def _second_order_factored_single(omega: jnp.ndarray,
                                  eigvals: jnp.ndarray, dt):
    r"""Separable tables of the K2 lattice for ONE segment.

    The general case of :func:`_second_order_integral_single` is

        I[o, ij, mn] = (f(x[o, ij]) - f(z[ij, mn])) * r[o, mn]

    with r = 1/y on y != 0 and the y == 0 entries replaced by a value
    ``special[o, ij]`` that does not depend on (m, n) at all.  Every
    factor touches at most two of the three index groups, so any
    contraction of I against an (mn)-indexed operand N splits into
    sums of [table(o, ij)] x [table(o, mn) @ N] products and the
    (n_omega, d^4) lattice -- the cost center of the second-order
    pipeline, all f64 elementwise work -- never needs
    to exist.

    Because z - x = y exactly, f_x -> f_z as y -> 0 and the factored
    general form loses ~eps/|y dt| relative precision (the elementwise
    lattice subtracts the two nearby values directly and is benign
    there).  Entries with 0 < |y dt| < _SO_SMALL_Y therefore switch to
    the divided-difference Taylor series

        I = sum_k D_k(x[o, ij]) * y^k[o, mn],

    which is separable too (:func:`_frac_divdiff_coeffs`); the
    factored general form then only runs where |y dt| >= _SO_SMALL_Y,
    bounding its error at ~2 eps/_SO_SMALL_Y ~ 4e-13 relative.

    Returns (f_x, special, f_z, r_big, m0, dks, yks):
    C (n_omega, d^2), C (n_omega, d^2), C (d^2, d^2),
    real (n_omega, d^2), real (n_omega, d^2),
    C (_SO_SMALL_K, n_omega, d^2), real (_SO_SMALL_K, n_omega, d^2),
    with ij/mn flattened row-major as in
    :func:`_second_order_integral_single`.  The lattice contraction
    against an mn-indexed operand N is

        sum_mn I N = f_x (r_big @ N) - f_z @ (r_big N)
                     + special (m0 @ N) + sum_k dks_k (yks_k @ N),

    where dks_k = D_k(x)/dt^k and yks_k = (y dt)^k (each pair's
    product is D_k y^k; the dt split keeps both tables O(1)-bounded so
    they survive a float32 downcast individually).
    """
    d = eigvals.shape[0]
    d2 = d * d
    dE = eigvals[:, None] - eigvals[None, :]
    de_flat = dE.reshape(d2)
    x = de_flat[None] - omega[:, None]                  # (o, ij)
    y = omega[:, None] + de_flat[None]                  # (o, mn)
    z = de_flat[:, None] + de_flat[None]                # (ij, mn)

    a = -omega * dt
    sa, ca = jnp.sin(a)[:, None], jnp.cos(a)[:, None]
    b = de_flat * dt
    sb, cb = jnp.sin(b)[None], jnp.cos(b)[None]
    sin_x = sb * ca + cb * sa
    cos_x = cb * ca - sb * sa

    f_x = _frac_from_trig(x, sin_x, cos_x, dt)          # (o, ij)
    zdt = z * dt
    f_z = _frac_from_trig(z, jnp.sin(zdt), jnp.cos(zdt), dt)  # (ij, mn)

    mask_y = y != 0.0
    small_y = mask_y & (jnp.abs(y * dt) < _SO_SMALL_Y)
    big_y = mask_y & ~small_y
    r_big = jnp.where(big_y, 1.0 / jnp.where(big_y, y, 1.0), 0.0)
    m0 = jnp.where(mask_y, 0.0, 1.0)

    # small-y divided-difference tables: D_k(x)/dt^k and (y dt)^k
    # moments (the k-th term's product is D_k y^k either way, but this
    # split is scale-invariant: |y dt| < _SO_SMALL_Y bounds the moment
    # at 1 and D_k/dt^k ~ dt stays O(dt), so a float32 downcast of
    # either table alone cannot overflow/underflow for SI-unit y, dt).
    # The x dt lattice is a[o] + b[ij] and the e^{i x dt} phases reuse
    # the angle-addition sin/cos tables.
    dks = _frac_divdiff_coeffs(a, b, dt, _SO_SMALL_K,
                               sin_x, cos_x)            # (K, o, ij)
    k_arr = jnp.arange(_SO_SMALL_K, dtype=x.dtype)
    dks = dks * (dt ** -k_arr)[:, None, None]
    yks = jnp.cumprod(jnp.concatenate(
        [jnp.where(small_y, 1.0, 0.0)[None],
         jnp.broadcast_to(y * dt, (_SO_SMALL_K - 1,) + y.shape)]),
        axis=0)                                         # (K, o, mn)

    mask_x = x != 0.0
    r_x = 1.0 / jnp.where(mask_x, x, 1.0)
    num = f_x - C(-sin_x * dt, cos_x * dt)              # f(x) - i dt e^{ixdt}
    special = where(mask_x, num * r_x,
                    C(jnp.full_like(x, dt * dt / 2)))
    return f_x, special, f_z, r_big, m0, dks, yks


# -----------------------------------------------------------------------------
# K0: diagonalization
# -----------------------------------------------------------------------------
def diagonalize(hamiltonian, dt) -> Tuple[jnp.ndarray, C, C]:
    r"""Diagonalize a piecewise-constant Hamiltonian and accumulate
    propagators (numeric.py:1886-1935).

    Returns (eigvals (G, d), eigvecs C (G, d, d), propagators C
    (G+1, d, d)) with Q_0 = identity.  The cumulative product runs as a
    log-depth associative scan instead of the reference's serial
    ``util.adot`` (numeric.py:1933).
    """
    h = asc(hamiltonian)
    dt = jnp.asarray(dt)
    return _diagonalize_jit(h, dt)


@jax.jit
def _diagonalize_jit(h: C, dt: jnp.ndarray):
    d = h.shape[-1]
    eigvals, eigvecs = eigh(h)
    phase = cexp(-dt[:, None] * eigvals)                # e^{-i D dt} (G, d)
    piecewise = ceinsum('gij,gj,gkj->gik', eigvecs, phase, eigvecs.conj())
    cumulative = util.adot(piecewise)
    ident = C(jnp.broadcast_to(jnp.eye(d, dtype=h.dtype), (1, d, d)))
    propagators = C(jnp.concatenate([ident.re, cumulative.re]),
                    jnp.concatenate([ident.im, cumulative.im]))
    return eigvals, eigvecs, propagators


def assemble_and_diagonalize(c_opers: C, c_coeffs, dt):
    """Hamiltonian assembly + K0 + total-propagator slice as ONE device
    call (the pulse-facing entry: eager per-op dispatch would cost one
    launch per op, so the assembly einsum and the final slice live
    inside the jit)."""
    return _assemble_diag_jit(asc(c_opers), jnp.asarray(c_coeffs),
                              jnp.asarray(dt))


@jax.jit
def _assemble_diag_jit(c_opers: C, c_coeffs: jnp.ndarray, dt: jnp.ndarray):
    h = ceinsum('jmn,jg->gmn', c_opers, c_coeffs)
    eigvals, eigvecs, propagators = _diagonalize_jit(h, dt)
    return eigvals, eigvecs, propagators, propagators[-1]


# -----------------------------------------------------------------------------
# K4: control matrix from scratch
# -----------------------------------------------------------------------------
def calculate_control_matrix_from_scratch(
        eigvals, eigvecs, propagators, omega, basis, n_opers, n_coeffs,
        dt, t=None, show_progressbar: bool = False,
        cache_intermediates: bool = False, out=None):
    r"""K4: control matrix
    B_{ak}(omega) = sum_g e^{i w t_{g-1}} s_a^g tr([Bbar_a o I(w)] Cbar_k)
    (numeric.py:707-881).

    The reference's hot Python loop over segments (numeric.py:846-869)
    is replaced by one batched contraction over the whole
    (G x n_omega x d x d) lattice (memory permitting) or a lax.scan over
    G-chunks.

    Returns a C of shape (n_nops, d**2, n_omega); with
    ``cache_intermediates`` also a dict of reusable intermediates.
    """
    eigvals = jnp.asarray(eigvals)
    dt = jnp.asarray(dt)
    if t is None:
        t = jnp.concatenate([jnp.zeros(1, dt.dtype), jnp.cumsum(dt)])
    else:
        t = jnp.asarray(t)
    omega = jnp.asarray(omega)
    basis_dev = basis.dev if isinstance(basis, Basis) else asc(basis)
    n_opers = asc(n_opers)
    n_coeffs = jnp.asarray(np.asarray(n_coeffs, dtype=float))
    eigvecs, propagators = asc(eigvecs), asc(propagators)

    G, d = eigvals.shape
    if cache_intermediates:
        result, step, cumulative, interm = _ctrlmat_scratch_cached(
            eigvals, eigvecs, propagators, omega, basis_dev, n_opers,
            n_coeffs, dt, t)
        interm = dict(interm)
        interm['control_matrix_step'] = step
        interm['control_matrix_step_cumulative'] = cumulative
        return result, interm

    # Chunked accumulation bounds the (G, n_omega, d, d) integral table.
    chunk = _pick_chunk(G, len(omega), d)
    pad = (-G) % chunk
    if pad:
        eigvals = jnp.concatenate([eigvals, jnp.zeros((pad, d))])
        eye = C(jnp.broadcast_to(jnp.eye(d, dtype=eigvals.dtype),
                                 (pad, d, d)))
        eigvecs = _concat_c(eigvecs, eye)
        propagators = _concat_c(propagators, eye)
        n_coeffs = jnp.concatenate(
            [n_coeffs, jnp.zeros((n_coeffs.shape[0], pad))], axis=1)
        dt = jnp.concatenate([dt, jnp.zeros(pad)])
        t = jnp.concatenate([t, jnp.broadcast_to(t[-1], (pad,))])
    return _ctrlmat_scratch_scan(eigvals, eigvecs, propagators, omega,
                                 basis_dev, n_opers, n_coeffs, dt, t,
                                 chunk)


def _concat_c(a: C, b: C) -> C:
    return C(jnp.concatenate([a.re, b.re]), jnp.concatenate([a.im, b.im]))


def _pick_chunk(G: int, n_omega: int, d: int,
                budget_bytes: Optional[int] = None) -> int:
    """Segments per scan step so the integral table stays within the
    device-aware memory budget (config.memory_budget: FF_TPU_MEMORY_BUDGET
    env override > fraction of reported device memory > 2 GiB)."""
    if budget_bytes is None:
        budget_bytes = config.memory_budget()
    per_seg = max(n_omega * d * d * 16, 1)
    return max(1, min(G, budget_bytes // per_seg))


def _ctrlmat_step_terms(eigvals, eigvecs, propagators, omega, basis,
                        n_opers, n_coeffs, dt, t, transform_dtype=None):
    """Per-segment ingredients of K4, batched over the leading G axis.

    ``transform_dtype`` (config.transform_dtype) computes the
    frequency-independent transform chain in f32 when the downstream
    contraction quantizes the results to 23-bit fixed point anyway
    (the deep factored regime); the phase factors and the first-order
    integral always stay in the working precision (their y -> 0
    limiting cases cancel catastrophically below f64).
    """
    if transform_dtype is not None:
        def cast(c: C) -> C:
            return c._map(lambda x: x.astype(transform_dtype))
        eigvecs_t, props_t = cast(eigvecs), cast(propagators)
        basis_t, nops_t = cast(basis), cast(n_opers)
        n_coeffs_t = n_coeffs.astype(transform_dtype)
        # reduced-precision products stay IEEE float32, never TF32
        precision = jax.default_matmul_precision('highest')
    else:
        eigvecs_t, props_t, basis_t, nops_t, n_coeffs_t = (
            eigvecs, propagators, basis, n_opers, n_coeffs)
        precision = contextlib.nullcontext()
    G, d = eigvals.shape
    with precision:
        eigvecs_propagated = _propagate_eigenvectors(props_t, eigvecs_t)
        if d == 2:
            # closed-form SU(2) -> SO(3) conjugation: no matmuls, pure
            # elementwise math (2x2 operands make poor matmuls)
            n_opers_transformed = _conjugate_d2(eigvecs_t, nops_t)._map(
                lambda x: x.swapaxes(0, 1))
            if n_coeffs_t is not None:
                n_opers_transformed = n_opers_transformed \
                    * jnp.asarray(n_coeffs_t)[:, :, None, None]
            basis_transformed = _conjugate_d2(eigvecs_propagated, basis_t)
        elif transform_dtype is None and config.transform_mxu(G * d * d):
            n_opers_transformed = _conjugate_mxu(eigvecs_t, nops_t)._map(
                lambda x: x.swapaxes(0, 1))
            if n_coeffs_t is not None:
                n_opers_transformed = n_opers_transformed \
                    * jnp.asarray(n_coeffs_t)[:, :, None, None]
            basis_transformed = _conjugate_mxu(eigvecs_propagated,
                                               basis_t)
        else:
            n_opers_transformed = _transform_hamiltonian(eigvecs_t, nops_t,
                                                         n_coeffs_t)
            basis_transformed = ceinsum('gba,kbc,gcd->gkad',
                                        eigvecs_propagated.conj(), basis_t,
                                        eigvecs_propagated)
    phase_factors = cexp(t[:, None] * omega[None, :])        # (G, n_w)
    integral = _first_order_integral_batched(omega, eigvals, dt)
    return (eigvecs_propagated, n_opers_transformed, basis_transformed,
            phase_factors, integral)


def _deep_quant_ratio(out_re, out_im, p: C, b_fac: C, c_fac: C,
                      n_nops: int, n_basis: int) -> jnp.ndarray:
    r"""Cheap in-graph bound on the RELATIVE operand-quantization noise
    the deep factored contraction leaves on the fidelity filter
    function F_a(w) = sum_k |B_{ak}(w)|^2.

    The fast path's error sources are elementwise quantizations:
    ~2^-24 of the f32 P assembly and ~2^-22 of the 23-bit fixed-point
    B (x) C product, both RELATIVE TO COLUMN SCALES -- so the absolute
    noise on out[o, (jk)] is bounded by

        mag[o, (jk)] <= eps_q * sum_K |P[o, :]| * colscale_B[j]
                        * colscale_C[k],

    a pure outer product (no matmuls: essentially free).  What can
    break the parity contract is CANCELLATION: |out| << the bound's
    scale (e.g. refocusing sequences where B(w) -> 0).  The returned
    statistic is the worst noise-to-signal ratio of the fidelity FF,

        max_{o,j} 2 sum_k |out| mag / sum_k |out|^2,

    directly comparable to a relative infidelity-parity budget because
    the infidelity integrand S(w) F(w) is nonnegative (a weighted mean
    cannot amplify elementwise-relative error).
    """
    n_w = p.shape[0]
    eps_q = jnp.float32(2.0**-21)     # 2^-22 D + 2^-24 P, 2x safety
    f32 = jnp.float32
    rowsum = (jnp.abs(p.re) + jnp.abs(p.im)).sum(-1).astype(f32)
    cb = jnp.maximum(jnp.abs(b_fac.re), jnp.abs(b_fac.im)).max(0)
    cc = jnp.maximum(jnp.abs(c_fac.re), jnp.abs(c_fac.im)).max(0)
    colscale = (cb[:, None] * cc[None, :]).astype(f32)    # (J, C)
    mag = (eps_q * rowsum)[:, None, None] * colscale      # (o, J, C)
    o_abs = jnp.sqrt(out_re * out_re + out_im * out_im).astype(
        f32).reshape(n_w, n_nops, n_basis)
    noise = 2.0 * (o_abs * mag).sum(-1)                   # (o, J)
    signal = (o_abs * o_abs).sum(-1)
    ratio = jnp.where(signal > 0, noise / jnp.where(signal > 0, signal,
                                                    1.0), 0.0)
    return ratio.max()


def _ctrlmat_contract(n_opers_transformed, integral, basis_transformed,
                      phase_factors, escalation: str = 'auto'):
    """The dominant contraction 'go,jgmn,gomn,gknm->jko'
    (numeric.py:843-869).

    Mode 'ozaki': restructured as
        P[g] (n_omega x d^2) @ D[g] (d^2 x n_nops*n_basis)
    with P = phase * integral (frequency-dependent, cheap) and
    D[(mn),(jk)] = Bbar_j[mn] * Cbar_k[nm] (frequency-independent), so
    the omega-lattice work runs as integer digit-slice matmuls (see
    ops/ozaki.py).

    *escalation* controls the deep factored path's automatic
    full-precision recompute (config.ozaki_escalation_tol):

    'auto'  -- decide in-graph under a ``lax.cond``.  Correct ONLY for
               unbatched callers: under ``jax.vmap`` the batched
               predicate lowers the cond to a both-branches ``select``
               and every call pays the escalated recompute.
    'stat'  -- never escalate here; return ``(out, ratio)`` where
               *ratio* is the scalar noise-to-signal statistic
               (:func:`_deep_quant_ratio`; 0 when the deep factored
               regime or escalation is off).  Batched callers vmap this
               variant, reduce ``max`` over the batch OUTSIDE the vmap,
               and re-run escalated under one scalar cond
               (functional.batched_infidelity).
    'force' -- the escalated computation itself: f64 operand assembly,
               ``max(30, DEFAULT_PRECISION_BITS)``-bit truncation.
    """
    from . import config
    if config.contraction_mode() != 'ozaki':
        out = ceinsum('go,jgmn,gomn,gknm->jko', phase_factors,
                      n_opers_transformed, integral, basis_transformed)
        if escalation == 'stat':
            return out, jnp.zeros((), jnp.float32)
        return out

    from .ops.ozaki import ozaki_matmul_c
    G, n_w, d, _ = integral.shape
    n_nops = n_opers_transformed.shape[0]
    n_basis = basis_transformed.shape[1]
    from .ops.ozaki import (DEEP_PRECISION_BITS,
                            DEFAULT_PRECISION_BITS, _slice_params)
    sb, _ = _slice_params(G * d * d, DEFAULT_PRECISION_BITS)
    # Depth-adaptive accuracy policy: the DEEP regime (1024 < K <=
    # 16384, slice width 5-6 bits -- large-d pulses and long trains,
    # whose results feed many-sample frequency integrals that average
    # element-level noise) runs the performance path: reduced
    # truncation, f32 P assembly (and, opt-in, int32-factored D
    # slices: config.ozaki_factored).  Shallow
    # contractions (small-d raw filter functions, no averaging) and
    # very deep ones (sqrt(K) noise amplification) keep full-precision
    # f64 assembly at DEFAULT_PRECISION_BITS: ~1e-10 flagship
    # infidelity parity (deep), reference-level raw-FF parity for
    # d = 2 trains (shallow).
    deep = sb in (5, 6) and escalation != 'force'
    bits = DEEP_PRECISION_BITS if deep else DEFAULT_PRECISION_BITS
    if escalation == 'force':
        bits = max(30, DEFAULT_PRECISION_BITS)
    f_p = config.ozaki_operand_dtype('P') if deep else jnp.float64
    f_d = config.ozaki_operand_dtype('D') if deep else jnp.float64

    def cast(x: C, f_op) -> C:
        return x if x.re.dtype == f_op else C(x.re.astype(f_op),
                                              x.im.astype(f_op))

    f64 = integral.re.dtype
    integral_full, phases_full = integral, phase_factors
    integral = cast(integral, f_p)
    phase_factors = cast(phase_factors, f_p)
    # P[g, o, m*n] = phase[g, o] * I[g, o, m, n]
    p_mat = (integral * phase_factors[:, :, None, None]).reshape(
        G, n_w, d * d)
    # Fold the segment sum into the reduction axis: one matmul with
    # K = G * d^2 (ozaki_matmul adapts its slice width to K and splits
    # reductions deeper than 2^16 into exact sub-reductions).
    p_big = p_mat._map(
        lambda x: x.transpose(1, 0, 2).reshape(n_w, G * d * d))
    if deep and config.ozaki_factored():
        # D[(g mn), (j k)] = B[j,g,mn] * C[g,k,nm] is a row-wise outer
        # product: form its digit slices in native int32 from fixed-
        # point factors instead of assembling the (K, n_nops*n_basis)
        # complex tensor in emulated f64 (ops/ozaki.py
        # ozaki_matmul_c_outer).
        from .ops.ozaki import ozaki_matmul_c_outer
        b_fac = n_opers_transformed._map(
            lambda x: x.transpose(1, 2, 3, 0).reshape(G * d * d,
                                                      n_nops))
        c_fac = basis_transformed._map(
            lambda x: x.transpose(0, 3, 2, 1).reshape(G * d * d,
                                                      n_basis))
        out_re, out_im = ozaki_matmul_c_outer(
            p_big.re, p_big.im, b_fac.re, b_fac.im, c_fac.re, c_fac.im,
            bits)
        tol = config.ozaki_escalation_tol()
        if tol > 0 and escalation == 'stat':
            # Hand the cancellation statistic to the caller, who
            # reduces it across the batch OUTSIDE any vmap and decides
            # the recompute under a single scalar cond -- the in-graph
            # cond below degenerates to a both-branches select when
            # this function is vmapped.
            ratio = _deep_quant_ratio(out_re, out_im, p_big, b_fac,
                                      c_fac, n_nops, n_basis)
            out = C(out_re.astype(f64), out_im.astype(f64)).reshape(
                n_w, n_nops, n_basis)
            return (out._map(lambda x: x.transpose(1, 2, 0)), ratio)
        if tol > 0 and escalation == 'auto':
            # Automatic escalation: the factored fast path quantizes
            # its operands (f32 P assembly, 23-bit fixed-point B/C
            # factors).  Estimate the resulting RELATIVE noise on the
            # fidelity filter function from a sampled |P| @ |D|
            # cancellation bound and, when it predicts a breach of the
            # 1e-10 infidelity-parity contract, recompute at full
            # precision inside the cond (both the f64 operand assembly
            # and the 30-bit contraction run ONLY when taken).
            ratio = _deep_quant_ratio(out_re, out_im, p_big, b_fac,
                                      c_fac, n_nops, n_basis)

            def _full_precision(args):
                intg, ph, b_f, c_f = args
                p64 = (intg * ph[:, :, None, None]).reshape(
                    G, n_w, d * d)._map(
                    lambda x: x.transpose(1, 0, 2).reshape(n_w,
                                                           G * d * d))
                d64 = (b_f[..., :, None] * c_f[..., None, :]).reshape(
                    G * d * d, n_nops * n_basis)
                return ozaki_matmul_c(p64.re, p64.im, d64.re, d64.im,
                                      max(30, DEFAULT_PRECISION_BITS))

            out_re, out_im = lax.cond(
                ratio > tol, _full_precision,
                lambda _: (out_re, out_im),
                (integral_full, phases_full, b_fac, c_fac))
    else:
        # D[g, m*n, j*k] = B[j, g, m, n] * C[g, k, n, m]
        b_t = cast(n_opers_transformed, f_d)._map(
            lambda x: x.transpose(1, 2, 3, 0))             # (g, m, n, j)
        c_t = cast(basis_transformed, f_d)._map(
            lambda x: x.transpose(0, 3, 2, 1))             # (g, m, n, k)
        d_mat = (b_t[..., :, None] * c_t[..., None, :]).reshape(
            G, d * d, n_nops * n_basis)
        d_big = d_mat.reshape(G * d * d, n_nops * n_basis)
        out_re, out_im = ozaki_matmul_c(p_big.re, p_big.im,
                                        d_big.re, d_big.im, bits)
    out = C(out_re.astype(f64), out_im.astype(f64)).reshape(
        n_w, n_nops, n_basis)
    out = out._map(lambda x: x.transpose(1, 2, 0))         # (j, k, o)
    if escalation == 'stat':
        # full-precision (or escalation-off) route: nothing to escalate
        return out, jnp.zeros((), jnp.float32)
    return out


def _ctrlmat_step_contract(n_opers_transformed, integral, basis_transformed,
                           phase_factors) -> C:
    """Per-step variant of :func:`_ctrlmat_contract`:
    'go,jgmn,gomn,gknm->gjko' keeping the segment axis.

    Mode 'ozaki': batched-over-g digit-slice matmul P[g] (n_w x d^2)
    @ D[g] (d^2 x n_nops*n_basis) instead of the f64 einsum.
    """
    from . import config
    if config.contraction_mode() != 'ozaki':
        return ceinsum('go,jgmn,gomn,gknm->gjko', phase_factors,
                       n_opers_transformed, integral, basis_transformed)

    from .ops.ozaki import DEFAULT_PRECISION_BITS, ozaki_matmul_c
    G, n_w, d, _ = integral.shape
    n_nops = n_opers_transformed.shape[0]
    n_basis = basis_transformed.shape[1]
    # Per-step control matrices feed the decay-amplitude and
    # second-order machinery, whose errors do not enjoy the flagship's
    # 1000-frequency integral averaging: keep full-precision assembly
    # and at least 30-bit truncation here (measured: letting the
    # 24-bit performance default through moved the error-transfer-
    # matrix parity from 3e-11 to 5.7e-10).
    f64 = integral.re.dtype
    p_mat = (integral * phase_factors[:, :, None, None]).reshape(
        G, n_w, d * d)
    b_t = n_opers_transformed._map(
        lambda x: x.transpose(1, 2, 3, 0))                 # (g, m, n, j)
    c_t = basis_transformed._map(
        lambda x: x.transpose(0, 3, 2, 1))                 # (g, m, n, k)
    d_mat = (b_t[..., :, None] * c_t[..., None, :]).reshape(
        G, d * d, n_nops * n_basis)
    out_re, out_im = ozaki_matmul_c(p_mat.re, p_mat.im,
                                    d_mat.re, d_mat.im,
                                    max(30, DEFAULT_PRECISION_BITS))
    out = C(out_re.astype(f64), out_im.astype(f64)).reshape(
        G, n_w, n_nops, n_basis)
    return out._map(lambda x: x.transpose(0, 2, 3, 1))    # (g, j, k, o)


@jax.jit
def _ctrlmat_scratch_cached(eigvals, eigvecs, propagators, omega, basis,
                            n_opers, n_coeffs, dt, t):
    (eigvecs_propagated, n_opers_transformed, basis_transformed,
     phase_factors, integral) = _ctrlmat_step_terms(
        eigvals, eigvecs, propagators[:-1], omega, basis, n_opers,
        n_coeffs, dt, t[:-1])
    # per-step control matrices (G, n_nops, n_basis, n_omega)
    step = _ctrlmat_step_contract(n_opers_transformed, integral,
                                  basis_transformed, phase_factors)
    result = step.sum(axis=0)
    cumulative = step.cumsum(axis=0)[:-1]
    intermediates = dict(
        n_opers_transformed=n_opers_transformed,
        eigvecs_propagated=eigvecs_propagated,
        basis_transformed=basis_transformed,
        phase_factors=phase_factors,
        first_order_integral=integral,
    )
    return result, step, cumulative, intermediates


@functools.partial(jax.jit, static_argnames='chunk')
def _ctrlmat_scratch_scan(eigvals, eigvecs, propagators, omega, basis,
                          n_opers, n_coeffs, dt, t, chunk: int):
    G, d = eigvals.shape
    n_chunks = G // chunk

    def reshape_chunks(x, lead=1):
        return jax.tree.map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[lead:]), x)

    ev = reshape_chunks(eigvals)
    V = reshape_chunks(eigvecs)
    Q = reshape_chunks(propagators[:-1])
    nc = jax.tree.map(
        lambda a: a.reshape((a.shape[0], n_chunks, chunk)).swapaxes(0, 1),
        n_coeffs)
    dts = reshape_chunks(dt)
    ts = reshape_chunks(t[:-1])

    n_nops = n_opers.shape[0]
    n_basis = basis.shape[0]
    init = C(jnp.zeros((n_nops, n_basis, len(omega)), eigvals.dtype),
             jnp.zeros((n_nops, n_basis, len(omega)), eigvals.dtype))

    tdt = config.transform_dtype(chunk * d * d)

    def body(carry, xs):
        ev_c, V_c, Q_c, nc_c, dt_c, t_c = xs
        (_, n_t, b_t, ph, integral) = _ctrlmat_step_terms(
            ev_c, V_c, Q_c, omega, basis, n_opers, nc_c, dt_c, t_c,
            transform_dtype=tdt)
        contrib = _ctrlmat_contract(n_t, integral, b_t, ph)
        return carry + contrib, None

    result, _ = lax.scan(body, init, (ev, V, Q, nc, dts, ts))
    return result


# -----------------------------------------------------------------------------
# K5 / K6: control matrix from atomic segments / periodic
# -----------------------------------------------------------------------------
@util.parse_optional_parameters(which=('total', 'correlations'))
def calculate_control_matrix_from_atomic(
        phases, control_matrix_atomic, propagators_liouville,
        show_progressbar: bool = False, which: str = 'total'):
    r"""K5: B(omega) = sum_g e^{i w t_{g-1}} B^(g)(omega) Q^(g-1)
    (numeric.py:621-704).

    phases: (G-1, n_omega) C (unity for g=0 implied).
    control_matrix_atomic: (G, n_nops, d**2, n_omega) C.
    propagators_liouville: (G-1, d**2, d**2) real or C.

    The reference's serial loop with a memory-layout swap trick
    (numeric.py:678-702) is one batched einsum here.
    """
    phases = asc(phases)
    ctrl = asc(control_matrix_atomic)
    props = propagators_liouville
    if not isinstance(props, C):
        props = jnp.asarray(props)
        if jnp.issubdtype(props.dtype, jnp.complexfloating):
            props = asc(props)
    first = ctrl[0]
    if which == 'correlations':
        steps = ceinsum('go,gjko,gkl->gjlo', phases, ctrl[1:], props)
        return C(jnp.concatenate([first.re[None], steps.re]),
                 jnp.concatenate([first.im[None], steps.im]))
    # 'total': contract the g-sum inside the contraction --
    # materializing the (G, n_nops, d**2, n_omega) per-step stack first
    # costs O(G) HBM traffic (256 MB for a 1e4-pulse train) for data
    # that is reduced away immediately.  Long trains restructure the
    # einsum as ONE complex matmul over the joint (g, k) reduction,
    # X[(j o), (g k)] @ Q[(g k), l] (through Ozaki slices in 'ozaki'
    # mode, see _so_matmul).
    g1 = phases.shape[0]
    if g1 > 64:
        _fastpath_hits['from_atomic_matmul'] += 1
        n_nops, d2 = ctrl.shape[1], ctrl.shape[2]
        n_w = phases.shape[-1]
        x = (ctrl[1:] * phases[:, None, None, :])._map(
            lambda v: v.transpose(1, 3, 0, 2).reshape(n_nops * n_w,
                                                      g1 * d2))
        if isinstance(props, C):
            out = _so_matmul(x, props.reshape(g1 * d2, -1))
        else:
            y = props.reshape(g1 * d2, -1)
            if (x.re.dtype == jnp.float64
                    and config.contraction_mode() == 'ozaki'):
                from .ops.ozaki import ozaki_matmul
                out = C(ozaki_matmul(x.re, y), ozaki_matmul(x.im, y))
            else:
                out = C(x.re @ y, x.im @ y)        # ((j o), l)
        out = out.reshape(n_nops, n_w, -1)._map(
            lambda v: v.transpose(0, 2, 1))        # (j, l, o)
        return first + out
    return first + ceinsum('go,gjko,gkl->jlo', phases, ctrl[1:], props)


def calculate_control_matrix_from_atomic_uniform(
        phases, control_matrix, propagators_liouville):
    r"""K5 for a train of identical atomic pulses: with a g-independent
    atomic control matrix B the sum factorizes exactly,
    B(omega) = B + B . sum_g e^{i w t_{g-1}} Q^(g-1),
    so no (G, n_nops, d**2, n_omega) stack is ever materialized
    (cf. :func:`calculate_control_matrix_from_atomic`).

    phases: (G-1, n_omega) C; control_matrix: (n_nops, d**2, n_omega) C;
    propagators_liouville: (G-1, d**2, d**2) real or C.
    """
    phases = asc(phases)
    ctrl = asc(control_matrix)
    props = propagators_liouville
    if not isinstance(props, C):
        props = jnp.asarray(props)
        if jnp.issubdtype(props.dtype, jnp.complexfloating):
            props = asc(props)
    if isinstance(props, C):
        m = ceinsum('go,gkl->okl', phases, props)
    else:
        m = C(jnp.einsum('go,gkl->okl', phases.re, props),
              jnp.einsum('go,gkl->okl', phases.im, props))
    return ctrl + ceinsum('jko,okl->jlo', ctrl, m)


def calculate_control_matrix_periodic(phases, control_matrix,
                                      total_propagator_liouville,
                                      repeats: int,
                                      check_invertible: bool = True) -> C:
    r"""K6: periodic control matrix via the finite geometric series
    S = sum_{g<G} (e^{i w T} Q)^g (numeric.py:884-954).

    Evaluated by branch-free binary doubling (2 log2 G batched matmuls;
    see :func:`~.cplx.geometric_series`) instead of the reference's
    conditional inverse + explicit-sum fallback -- no invertibility
    check is needed, so *check_invertible* is accepted for API
    compatibility and ignored.
    """
    return _ctrl_periodic(asc(phases), asc(control_matrix),
                          asc(total_propagator_liouville), int(repeats))


@functools.partial(jax.jit, static_argnums=3)
def _ctrl_periodic(phases: C, ctrl: C, props: C, repeats: int) -> C:
    # one fused executable: the ~2 log2 G doubling matmuls would
    # otherwise each pay an eager dispatch (host-bound for small d)
    t_mat = C(phases.re[:, None, None] * props.re[None]
              - phases.im[:, None, None] * props.im[None],
              phases.re[:, None, None] * props.im[None]
              + phases.im[:, None, None] * props.re[None])
    s = geometric_series(t_mat, repeats)                  # (n_w, d2, d2)
    return ceinsum('jko,okl->jlo', ctrl, s)


# -----------------------------------------------------------------------------
# K7: noise operators (Hilbert-space duals of K4/K5)
# -----------------------------------------------------------------------------
def calculate_noise_operators_from_scratch(
        eigvals, eigvecs, propagators, omega, n_opers, n_coeffs, dt,
        t=None, show_progressbar: bool = False,
        cache_intermediates: bool = False):
    r"""K7: interaction-picture noise operators
    Btilde_a(w) = sum_g e^{i w t_{g-1}} P^dag [Bbar_a o I](w) P,
    P = V^dag Q_{g-1}; result shape (n_omega, n_nops, d, d)
    (numeric.py:456-618).  Scales as d^2 per frequency instead of the
    control matrix's d^4."""
    eigvals = jnp.asarray(eigvals)
    dt = jnp.asarray(dt)
    if t is None:
        t = jnp.concatenate([jnp.zeros(1, dt.dtype), jnp.cumsum(dt)])
    else:
        t = jnp.asarray(t)
    omega = jnp.asarray(omega)
    n_opers = asc(n_opers)
    n_coeffs = jnp.asarray(np.asarray(n_coeffs, dtype=float))
    eigvecs, propagators = asc(eigvecs), asc(propagators)
    return _noise_opers_scratch(eigvals, eigvecs, propagators, omega,
                                n_opers, n_coeffs, dt, t,
                                cache_intermediates)


@functools.partial(jax.jit, static_argnames='cache_intermediates')
def _noise_opers_scratch(eigvals, eigvecs, propagators, omega, n_opers,
                         n_coeffs, dt, t, cache_intermediates: bool):
    # note reversed argument order vs K4: V^dag Q (numeric.py:577)
    eigvecs_propagated = _propagate_eigenvectors(eigvecs, propagators[:-1])
    n_opers_transformed = _transform_hamiltonian(eigvecs, n_opers, n_coeffs)
    phase_factors = cexp(t[:-1, None] * omega[None, :])      # (G, n_w)
    integral = _first_order_integral_batched(omega, eigvals, dt)
    # sum_g phase * P^dag (B^bar o I) P  -> (n_w, n_nops, d, d)
    inner = ceinsum('go,jgmn,gomn->gojmn', phase_factors,
                    n_opers_transformed, integral)
    # transform: U^dag X U with U = eigvecs_propagated per g, then sum g
    transformed = ceinsum('gma,gojmn,gnb->gojab',
                          eigvecs_propagated.conj(), inner,
                          eigvecs_propagated)
    noise_operators = transformed.sum(axis=0)                # (n_w, nops, d, d)
    if cache_intermediates:
        intermediates = dict(n_opers_transformed=n_opers_transformed,
                             first_order_integral=integral,
                             phase_factors=phase_factors,
                             noise_operators_step=transformed)
        return noise_operators, intermediates
    return noise_operators


def calculate_noise_operators_from_atomic(
        phases, noise_operators_atomic, propagators,
        show_progressbar: bool = False) -> C:
    r"""K7 (atomic): Btilde(w) = sum_g e^{i w t_{g-1}} Q_{g-1}^dag
    Btilde^(g)(w) Q_{g-1} (numeric.py:377-453)."""
    phases = asc(phases)
    atomic = asc(noise_operators_atomic)
    props = asc(propagators)
    first = atomic[0]
    # atomic axes: (G, n_omega, n_nops, d, d), matching the
    # from_scratch layout (the reference uses (G, n_nops, d, d, n_w)).
    rest = ceinsum('go,gojmn->gojmn', phases, atomic[1:])
    transformed = ceinsum('gmx,gojmn,gny->gojxy',
                          props.conj(), rest, props)
    return first + transformed.sum(axis=0)


# -----------------------------------------------------------------------------
# K8 / K9: filter functions from the control matrix
# -----------------------------------------------------------------------------
@util.parse_optional_parameters(which=('fidelity', 'generalized'))
def calculate_filter_function(control_matrix: C,
                              which: str = 'fidelity') -> C:
    r"""K8: F_{ab[,kl]}(w) = B*_{ak} B_{b l}(w) (numeric.py:1413-1467)."""
    ctrl = asc(control_matrix)
    sub = 'ako,bko->abo' if which == 'fidelity' else 'ako,blo->abklo'
    return ceinsum2(sub, ctrl.conj(), ctrl)


@util.parse_optional_parameters(which=('fidelity', 'generalized'))
def calculate_pulse_correlation_filter_function(control_matrix: C,
                                                which: str = 'fidelity') -> C:
    r"""K9: F^{(gg')}_{ab[,kl]}(w) (numeric.py:1821-1883)."""
    ctrl = asc(control_matrix)
    if ctrl.ndim != 4:
        raise ValueError('Expected control_matrix.ndim == 4.')
    sub = 'gako,hbko->ghabo' if which == 'fidelity' else 'gako,hblo->ghabklo'
    return ceinsum2(sub, ctrl.conj(), ctrl)


# -----------------------------------------------------------------------------
# K10 / K11: second-order filter function
# -----------------------------------------------------------------------------
def calculate_second_order_filter_function_from_scratch(
        eigvals, eigvecs, propagators, omega, basis, n_opers, n_coeffs,
        dt, intermediates: Optional[Dict[str, Any]] = None,
        show_progressbar: bool = False, cache_intermediates: bool = False,
        cache_cumulative: bool = False):
    r"""K10: second-order filter function F^(2)_{ab,kl}(w)
    (numeric.py:1470-1699).

    Per segment g the 'incomplete step' contracts the nested integral
    I_{ijmn} with noise-operator/basis products; 'complete steps' reuse
    the per-step first-order control matrices.  Here the loop is a
    lax.scan carrying (cumulative ctrl matrix, complete, incomplete).
    """
    eigvals = jnp.asarray(eigvals)
    dt = jnp.asarray(dt)
    t = jnp.concatenate([jnp.zeros(1, dt.dtype), jnp.cumsum(dt)])
    omega = jnp.asarray(omega)
    basis_dev = basis.dev if isinstance(basis, Basis) else asc(basis)
    n_opers = asc(n_opers)
    n_coeffs = jnp.asarray(np.asarray(n_coeffs, dtype=float))
    eigvecs, propagators = asc(eigvecs), asc(propagators)

    have = intermediates is not None and all(
        k in intermediates for k in
        ('n_opers_transformed', 'basis_transformed', 'control_matrix_step',
         'control_matrix_step_cumulative'))
    if have:
        n_t = intermediates['n_opers_transformed']
        b_t = intermediates['basis_transformed']
        step = intermediates['control_matrix_step']
        cumul = intermediates['control_matrix_step_cumulative']
    else:
        n_t, b_t, step, cumul = _second_order_step_terms_jit(
            eigvals, eigvecs, propagators, omega, basis_dev, n_opers,
            n_coeffs, dt, t)

    result, int2_cache, complete_steps, cumulative_ff = _second_order_scan(
        eigvals, n_t, b_t, step, cumul, omega, dt,
        cache_intermediates, cache_intermediates and cache_cumulative)

    if cache_intermediates:
        out_interm = dict(intermediates or {})
        out_interm['second_order_integral'] = int2_cache
        out_interm['second_order_complete_steps'] = complete_steps
        if cache_cumulative:
            out_interm['filter_function_2_step_cumulative'] = cumulative_ff
        if not have:
            out_interm.setdefault('n_opers_transformed', n_t)
            out_interm.setdefault('basis_transformed', b_t)
            out_interm.setdefault('control_matrix_step', step)
            out_interm.setdefault('control_matrix_step_cumulative', cumul)
        return result, out_interm
    return result


def _second_order_incomplete_contract(int2: C, nob: C) -> C:
    r"""The K10 incomplete-step contraction
    'oijmn,akij,blmn->abklo' for one segment.

    Mode 'ozaki': two digit-slice matmul stages instead of the f64
    einsum::

        T[(o ij), B]  = I[(o ij), (mn)] @ nob^T[(mn), B]
        S[A, (o B)]   = nob[A, (ij)] @ T'[(ij), (o B)]

    with A = B = (a k) flattened noise-oper x basis indices.  The
    reshuffles between stages are pure data movement (free of f64
    emulation); only the tiny slice decompositions are elementwise.
    """
    from . import config
    n_nops, n_basis, d, _ = nob.shape
    n_w = int2.shape[0]
    d2 = d * d
    A = n_nops * n_basis
    if config.contraction_mode() != 'ozaki':
        return ceinsum('oijmn,akij,blmn->abklo', int2, nob, nob)

    from .ops.ozaki import ozaki_matmul_c
    i2 = int2.reshape(n_w * d2, d2)                       # ((o ij), mn)
    nob_flat = nob.reshape(A, d2)                          # (A, ij|mn)
    nob_t = nob_flat._map(lambda x: x.T)                   # (mn, B)
    t_re, t_im = ozaki_matmul_c(i2.re, i2.im, nob_t.re, nob_t.im)
    t = C(t_re, t_im).reshape(n_w, d2, A)
    t2 = t._map(lambda x: x.transpose(1, 0, 2).reshape(d2, n_w * A))
    s_re, s_im = ozaki_matmul_c(nob_flat.re, nob_flat.im, t2.re, t2.im)
    s = C(s_re, s_im).reshape(n_nops, n_basis, n_w, n_nops, n_basis)
    return s._map(lambda x: x.transpose(0, 3, 1, 4, 2))   # (a,b,k,l,o)


@jax.jit
def _second_order_step_terms_jit(eigvals, eigvecs, propagators, omega,
                                 basis_dev, n_opers, n_coeffs, dt, t):
    """K10 prerequisites (per-step ctrl matrices) as one device call,
    for pulses whose first-order intermediates were not cached."""
    (_, n_t, b_t, ph, integral1) = _ctrlmat_step_terms(
        eigvals, eigvecs, propagators[:-1], omega, basis_dev,
        n_opers, n_coeffs, dt, t[:-1])
    step = _ctrlmat_step_contract(n_t, integral1, b_t, ph)
    return n_t, b_t, step, step.cumsum(axis=0)[:-1]


def _so_matmul(a: C, b: C) -> C:
    """Batched complex matmul on the mode-selected path: Ozaki digit
    slicing for f64 operands in 'ozaki' mode, native Gauss-3
    ``jnp.matmul`` otherwise (float32 pinned to full precision, never
    TF32)."""
    if (a.re.dtype == jnp.float64
            and config.contraction_mode() == 'ozaki'):
        from .ops.ozaki import ozaki_matmul_c
        re, im = ozaki_matmul_c(a.re, a.im, b.re, b.im)
        return C(re, im)
    from .cplx import _bilinear
    return _bilinear(functools.partial(jnp.matmul,
                                       precision=lax.Precision.HIGHEST),
                     a, b)


def _second_order_total(eigvals, n_opers_transformed, basis_transformed,
                        ctrlmat_step, cumul_padded, omega, dt) -> C:
    r"""K10 total without per-step caching: the whole segment sum as
    batched matmuls instead of a serial ``lax.scan``.

    Two rewrites relative to the scan (reference loop:
    /root/reference/filter_functions/numeric.py:1470-1699):

    * complete steps:  sum_g conj(B_step^(g)) (x) B_cumul^(g-1) is,
      per frequency, a (A x G) @ (G x B) matmul with A = B = (a k) the
      flattened noise-oper x basis index -- the serial outer-product
      accumulation becomes one reduction over g on the matrix unit.
    * incomplete steps: sum_g nob_g I2_g nob_g uses the separable-table
      form of the K2 lattice (:func:`_second_order_factored_single`):
      both d^2-indexed slots of the lattice contract against nob
      BEFORE the o/ij/mn coupling is assembled, so the (n_w, d^4)
      lattice is never materialized and the remaining contractions are
      small (g-batched) matmuls.

    The (G, n_w, d^2, A) working set is chunked over g to stay inside
    :func:`config.memory_budget` for large-d pulses.
    """
    G, d = eigvals.shape
    d2 = d * d
    n_nops = n_opers_transformed.shape[0]
    n_basis = basis_transformed.shape[1]
    n_w = omega.shape[0]
    A = n_nops * n_basis

    # n_opers_basis[g,(a k),(i j)] = n_t[a,g,i,j] * b_t[g,k,j,i]
    nob = ceinsum('agij,gkji->gakij', n_opers_transformed,
                  basis_transformed).reshape(G, A, d2)

    # --- complete steps ---
    x = ctrlmat_step.conj().reshape(G, A, n_w)._map(
        lambda v: v.transpose(2, 1, 0))                   # (o, A, G)
    y = cumul_padded.reshape(G, A, n_w)._map(
        lambda v: v.transpose(2, 0, 1))                   # (o, G, B)
    comp = _so_matmul(x, y)                               # (o, A, B)
    complete = comp._map(lambda v: v.transpose(1, 2, 0)).reshape(
        n_nops, n_basis, n_nops, n_basis, n_w)._map(
        lambda v: v.transpose(0, 2, 1, 3, 4))             # (a,b,k,l,o)

    # --- incomplete steps, chunked over g ---
    # Two routes.  On the Ozaki path the (o, d^4) lattice is
    # materialized per chunk and both stages run as Ozaki matmuls.
    # With native f64 matmuls the separable-table form
    # (:func:`_second_order_factored_single`) is cheaper: it never
    # builds the lattice.
    if config.contraction_mode() == 'ozaki' or not _so_factored():
        per_g = n_w * d2 * (d2 + A) * 16
        gc = max(1, min(G, config.memory_budget() // max(per_g, 1)))
        n_chunks = -(-G // gc)
        incomplete = None
        for c in range(n_chunks):
            sl = slice(c * gc, min((c + 1) * gc, G))
            g_here = sl.stop - sl.start
            int2 = jax.vmap(_second_order_integral_single,
                            in_axes=(None, 0, 0))(
                omega, eigvals[sl], dt[sl])               # (g, o, d,d,d,d)
            i2 = int2.reshape(g_here, n_w * d2, d2)
            nob_c = nob[sl]
            nob_t = nob_c._map(lambda v: v.swapaxes(-1, -2))  # (g, d2, A)
            t = _so_matmul(i2, nob_t)                     # (g, o*d2, A)
            t2 = t.reshape(g_here, n_w, d2, A)._map(
                lambda v: v.transpose(0, 2, 1, 3).reshape(g_here * d2,
                                                          n_w * A))
            nob2 = nob_c._map(
                lambda v: v.transpose(1, 0, 2).reshape(A, g_here * d2))
            s = _so_matmul(nob2, t2)                      # (A, o*B)
            incomplete = s if incomplete is None else incomplete + s
        incomplete = incomplete.reshape(
            n_nops, n_basis, n_w, n_nops, n_basis)._map(
            lambda v: v.transpose(0, 3, 1, 4, 2))         # (a,b,k,l,o)
        return incomplete + complete
    per_g = n_w * d2 * A * 16
    gc = max(1, min(G, config.memory_budget() // max(per_g, 1)))
    n_chunks = -(-G // gc)
    incomplete = None
    with jax.default_matmul_precision('highest'):
        for c in range(n_chunks):
            sl = slice(c * gc, min((c + 1) * gc, G))
            f_x, special, f_z, r_b, m0, dks, yks = jax.vmap(
                _second_order_factored_single, in_axes=(None, 0, 0))(
                omega, eigvals[sl], dt[sl])
            nob_c = nob[sl]                               # (g, A|B, d2)
            # first nob slot contracted against the ij-indexed tables
            nf = ceinsum('gai,goi->gao', nob_c, f_x)
            ns = ceinsum('gai,goi->gao', nob_c, special)
            nz = ceinsum('gai,gim->gam', nob_c, f_z)
            nd = ceinsum('gai,gkoi->gkao', nob_c, dks)
            # second nob slot against the mn-indexed tables
            p_t = ceinsum('gom,gbm->gob', r_b, nob_c)
            s_t = ceinsum('gom,gbm->gob', m0, nob_c)
            y_t = ceinsum('gkom,gbm->gkob', yks, nob_c)
            s = ceinsum('gao,gob->aob', nf, p_t) \
                + ceinsum('gao,gob->aob', ns, s_t) \
                + ceinsum('gkao,gkob->aob', nd, y_t) \
                - ceinsum('gam,gom,gbm->aob', nz, r_b, nob_c)
            incomplete = s if incomplete is None else incomplete + s
    incomplete = incomplete.reshape(
        n_nops, n_basis, n_w, n_nops, n_basis)._map(
        lambda v: v.transpose(0, 3, 1, 4, 2))             # (a,b,k,l,o)
    return incomplete + complete


def trapezoid_weights(omega) -> jnp.ndarray:
    """Quadrature weights w with sum_o w_o f_o == trapezoid(f, omega),
    for folding frequency integrals into contractions."""
    omega = jnp.asarray(omega)
    d = jnp.diff(omega)
    return jnp.concatenate([d[:1] / 2, (d[1:] + d[:-1]) / 2, d[-1:] / 2])


def _second_order_diag_shifts(eigvals, n_opers_transformed,
                              basis_transformed, ctrlmat_step,
                              cumul_padded, omega, dt, weights,
                              dtype=None) -> C:
    r"""Frequency shifts Delta[a, k, l] for diagonal (ndim <= 2)
    spectra with the spectrum x trapezoid weight folded into the
    contractions.

    For per-noise-operator spectra the K14 integrand only touches the
    a == b diagonal of the second-order filter function
    (reference /root/reference/filter_functions/numeric.py:1340-1410 via
    the K12 dispatch), so the (a, b, k, l, omega) tensor is never
    materialized: the incomplete-step stage-1 matmul T = I2 @ nob^T is
    reused as in :func:`_second_order_total`, the omega reduction
    happens on T (weighted by S_a(w) w_trapz), and the remaining
    contractions are (a)-batched d^2 x d^2 matmuls.  The complete-steps
    term contracts over (g, omega) jointly in one einsum.

    weights: (n_nops, n_omega) real = S[a, o] * trapz_w[o] / (2 pi).
    Returns C of shape (n_nops, n_basis, n_basis); take ``.re`` for
    the physical shifts.

    Two routes for the incomplete-step term:

    * the lattice route (the default, and the Ozaki path): materialize
      the (n_omega, d^4) K2 lattice per chunk and push the contraction
      through matmuls at *dtype* (float32 in 'ozaki' mode, see
      functional._so_shift_dtype).
    * FF_TPU_SO_FACTORED=1: the separable-table form of the K2
      lattice (:func:`_second_order_factored_single`) with the
      weighted omega reduction folded in -- every contraction is over
      tensors of at most (G, n_omega, n_nops*n_basis) elements and the
      lattice is never materialized.
    """
    G, d = eigvals.shape
    d2 = d * d
    n_nops = n_opers_transformed.shape[0]
    n_basis = basis_transformed.shape[1]
    n_w = omega.shape[0]
    A = n_nops * n_basis

    nob = ceinsum('agij,gkji->gakij', n_opers_transformed,
                  basis_transformed).reshape(G, A, d2)

    # complete steps: contract over (g, omega) jointly, weight folded.
    # One a-batched complex matmul over the joint (g, o) reduction
    # (K = G n_w) -- _so_matmul routes it through Ozaki slices in
    # 'ozaki' mode.
    w64 = jnp.asarray(weights)
    xs = ctrlmat_step.conj().reshape(G, n_nops, n_basis, n_w)._map(
        lambda v: v.transpose(1, 2, 0, 3).reshape(n_nops, n_basis,
                                                  G * n_w))
    wbig = jnp.broadcast_to(w64[:, None, :],
                            (n_nops, G, n_w)).reshape(n_nops, 1,
                                                      G * n_w)
    xs = xs._map(lambda v: v * wbig)
    ys = cumul_padded.reshape(G, n_nops, n_basis, n_w)._map(
        lambda v: v.transpose(1, 0, 3, 2).reshape(n_nops, G * n_w,
                                                  n_basis))
    comp = _so_matmul(xs, ys)                             # (a, k, l)

    f_in = eigvals.dtype
    f_mm = jnp.dtype(dtype) if dtype is not None else f_in
    w = jnp.asarray(weights).astype(f_mm)

    def to_mm(x):
        if f_mm == f_in:
            return x
        if isinstance(x, C):
            return C(x.re.astype(f_mm), x.im.astype(f_mm))
        return x.astype(f_mm)

    if config.contraction_mode() == 'ozaki' or not _so_factored():
        # lattice route: materialize the K2 lattice per chunk (full
        # precision, cancellation-sensitive) and push the big
        # contraction through matmuls (f64, f32 or Ozaki slices).
        # When the working precision is f32, the lattice itself is
        # built in native-f32 double-single arithmetic.
        ds_lattice = (f_mm == jnp.float32
                      and _so_lattice_mode() != 'f64')
        per_g = n_w * d2 * d2 * 16
        gc = max(1, min(G, config.memory_budget() // max(per_g, 1)))
        n_chunks = -(-G // gc)
        inc = None
        with jax.default_matmul_precision('highest'):
            for c in range(n_chunks):
                sl = slice(c * gc, min((c + 1) * gc, G))
                g_here = sl.stop - sl.start
                if ds_lattice:
                    int2 = jax.vmap(_second_order_integral_single_f32,
                                    in_axes=(None, 0, 0))(omega,
                                                          eigvals[sl],
                                                          dt[sl])
                else:
                    int2 = jax.vmap(_second_order_integral_single,
                                    in_axes=(None, 0, 0))(omega,
                                                          eigvals[sl],
                                                          dt[sl])
                # weighted omega reduction FIRST: one (a, o) x (o, d^4)
                # matmul collapses the big lattice to the tiny
                # L[g, a, ij, mn], so the lattice is read exactly once
                # and the nob sandwich runs on d^2 x d^2 tensors
                # (the lattice @ nob^T ordering would round-trip a
                # (g, o d^2, A) intermediate through device memory)
                i2 = to_mm(int2.reshape(g_here, n_w, d2 * d2))
                ell = i2._map(lambda v: jnp.einsum('ao,gox->gax', w, v))
                nob_c = to_mm(nob[sl])
                l4 = ell.reshape(g_here, n_nops, d2, d2)
                nob4 = nob_c.reshape(g_here, n_nops, n_basis, d2)
                m_t = ceinsum('gaxy,galy->gaxl', l4, nob4)
                term = ceinsum('gakx,gaxl->akl', nob4, m_t)
                inc = term if inc is None else inc + term
        if f_mm != f_in:
            inc = C(inc.re.astype(f_in), inc.im.astype(f_in))
        return inc + comp

    # separable K2 tables, chunked over g against the memory budget
    # (the (g, K, n_omega, A) y_t intermediate dominates: ~100+ GB for
    # a 1e4-segment train at 400 frequencies if taken all at once)
    per_g = (_SO_SMALL_K + 3) * n_w * max(A, d2) * 16
    gc = max(1, min(G, config.memory_budget() // max(per_g, 1)))
    n_chunks = -(-G // gc)
    inc = None
    with jax.default_matmul_precision('highest'):
        # T[g,o,ij,(a,l)] = f_x P + special S0 + sum_k D_k Y_k
        # - f_z (r nob), with the omega reduction sum_o w[a,o] folded
        # into each term and the b == a diagonal selected on the
        # trailing index.
        for c in range(n_chunks):
            sl = slice(c * gc, min((c + 1) * gc, G))
            f_x, special, f_z, r_b, m0, dks, yks = jax.vmap(
                _second_order_factored_single, in_axes=(None, 0, 0))(
                omega, eigvals[sl], dt[sl])
            f_x, special, f_z, dks = (to_mm(f_x), to_mm(special),
                                      to_mm(f_z), to_mm(dks))
            r_b, m0, yks = to_mm(r_b), to_mm(m0), to_mm(yks)
            nob4 = to_mm(nob[sl].reshape(sl.stop - sl.start, n_nops,
                                         n_basis, d2))
            p_t = ceinsum('gom,galm->goal', r_b, nob4)      # (r @ N)
            s_t = ceinsum('gom,galm->goal', m0, nob4)       # (m0 @ N)
            y_t = ceinsum('gkom,galm->gkoal', yks, nob4)    # (Y_k @ N)
            term = ceinsum('ao,goi,goal->gail', w, f_x, p_t)
            term = term + ceinsum('ao,goi,goal->gail', w, special, s_t)
            term = term + ceinsum('ao,gkoi,gkoal->gail', w, dks, y_t)
            rw = jnp.einsum('ao,gom->gam', w, r_b)          # sum_o w r
            term = term - ceinsum('gim,gam,galm->gail', f_z, rw, nob4)
            t_c = ceinsum('gakm,gaml->akl', nob4, term)
            inc = t_c if inc is None else inc + t_c
    if f_mm != f_in:
        inc = C(inc.re.astype(f_in), inc.im.astype(f_in))
    return inc + comp


@functools.partial(jax.jit,
                   static_argnames=('cache_int', 'cache_cumulative'))
def _second_order_scan(eigvals, n_opers_transformed, basis_transformed,
                       ctrlmat_step, ctrlmat_cumulative, omega, dt,
                       cache_int: bool, cache_cumulative: bool):
    G, d = eigvals.shape
    n_nops = n_opers_transformed.shape[0]
    n_basis = basis_transformed.shape[1]
    n_w = len(omega)
    f = eigvals.dtype

    def zero(shape):
        return C(jnp.zeros(shape, f), jnp.zeros(shape, f))

    shape_ff = (n_nops, n_nops, n_basis, n_basis, n_w)

    def body(carry, xs):
        complete, incomplete = carry
        ev_g, n_t_g, b_t_g, step_g, cumul_g, dt_g = xs
        int2 = _second_order_integral_single(omega, ev_g, dt_g)
        # n_opers_basis[a,k,i,j] = n_t[a,i,j] * b_t[k,j,i]
        nob = ceinsum('aij,kji->akij', n_t_g, b_t_g)
        incomplete = incomplete + _second_order_incomplete_contract(
            int2, nob)
        complete = complete + ceinsum('ako,blo->abklo',
                                      step_g.conj(), cumul_g)
        out = (int2 if cache_int else None,
               (incomplete + complete) if cache_cumulative else None)
        return (complete, incomplete), out

    # For g = 0 there is no complete-step term: feed zero cumulative.
    cumul_padded = C(
        jnp.concatenate([jnp.zeros((1,) + ctrlmat_cumulative.re.shape[1:],
                                   f), ctrlmat_cumulative.re]),
        jnp.concatenate([jnp.zeros((1,) + ctrlmat_cumulative.im.shape[1:],
                                   f), ctrlmat_cumulative.im]))
    if not cache_int and not cache_cumulative:
        # No per-step outputs needed: take the scan-free batched-matmul
        # formulation (the hot path of the fused error-transfer-matrix
        # pipeline).
        total = _second_order_total(eigvals, n_opers_transformed,
                                    basis_transformed, ctrlmat_step,
                                    cumul_padded, omega, dt)
        return total, None, None, None
    (complete, incomplete), (int2_cache, cumulative_ff) = lax.scan(
        body, (zero(shape_ff), zero(shape_ff)),
        (eigvals, n_opers_transformed.swapaxes(0, 1), basis_transformed,
         ctrlmat_step, cumul_padded, dt))
    return incomplete + complete, int2_cache, complete, cumulative_ff


def calculate_second_order_filter_function_from_atomic(
        basis, filter_function_atomic, control_matrix_atomic,
        control_matrix_atomic_step, control_matrix_atomic_cumulative,
        propagators, propagators_liouville,
        intermediates: Sequence[Mapping[str, Any]],
        show_progressbar: bool = False) -> C:
    r"""K11: concatenation rule for the second-order filter function
    (numeric.py:1702-1818).

    Requires per-pulse intermediates 'eigvecs_propagated',
    'n_opers_transformed', 'second_order_integral',
    'second_order_complete_steps'.
    """
    required = ('eigvecs_propagated', 'n_opers_transformed',
                'second_order_integral', 'second_order_complete_steps')
    for key in required:
        if not all(key in im for im in intermediates):
            raise ValueError(f"Required intermediate term {key} not found "
                             "in all intermediates.")

    basis_dev = basis.dev if isinstance(basis, Basis) else asc(basis)
    result = asc(filter_function_atomic)
    ctrl_step = asc(control_matrix_atomic_step)
    ctrl_cumul = asc(control_matrix_atomic_cumulative)
    props = asc(propagators)
    props_liouville = propagators_liouville
    G = len(asc(control_matrix_atomic))
    if G < 2:
        return result

    def cstack(items):
        return C(jnp.stack([i.re for i in items]),
                 jnp.stack([i.im for i in items]))

    def cconcat(items, axis=0):
        return C(jnp.concatenate([i.re for i in items], axis),
                 jnp.concatenate([i.im for i in items], axis))

    # Terms with pulse-uniform shapes: one batched contraction over the
    # g = 1..G-1 stack each (the reference loops pulses in Python,
    # numeric.py:1775-1818; so did round 1 -- O(G) dispatches).
    # cross term G*_(g) B_(g-1): outer product over basis indices
    result = result + ceinsum('gako,gblo->abklo',
                              ctrl_step[1:G].conj(), ctrl_cumul[:G - 1])
    ql = props_liouville if isinstance(props_liouville, C) \
        else jnp.asarray(props_liouville)                 # (G-1, d^2, d^2)

    # Chunk over pulses so the concatenated second_order_integral stack
    # (n_segments x n_w x d^4) and the complete-steps stack stay within
    # a memory budget: batched-but-bounded, unlike a per-pulse Python
    # loop (O(G) dispatches) or one monolithic stack (OOM for long
    # second-order trains).
    budget = config.memory_budget(fraction=1 / 16, fallback=1 << 30)
    int2_bytes = [np.prod(np.shape(
        asc(intermediates[g]['second_order_integral']).re)) * 16
        for g in range(1, G)]
    groups, current, used = [], [], 0
    for g, nbytes in zip(range(1, G), int2_bytes):
        if current and used + nbytes > budget:
            groups.append(current)
            current, used = [], 0
        current.append(g)
        used += nbytes
    groups.append(current)

    for group in groups:
        # transformed complete steps Q^T N Q
        complete = cstack(
            [asc(intermediates[g]['second_order_complete_steps'])
             for g in group])
        ql_g = ql[jnp.asarray(group) - 1]
        result = result + ceinsum('gpk,gabpqo,gql->abklo', ql_g,
                                  complete, ql_g)

        # Incomplete steps: the g- and within-pulse segment sums flatten
        # into ONE concatenated segment axis (per-pulse segment counts
        # may be ragged, so concatenate rather than stack).
        evs = [asc(intermediates[g]['eigvecs_propagated']) for g in group]
        h_counts = [ev.shape[0] for ev in evs]
        rep_idx = jnp.asarray(np.repeat(np.asarray(group), h_counts))
        props_rep = props._map(lambda x: x[rep_idx - 1])  # (H, d, d)
        eigvecs_propagated = _propagate_eigenvectors(props_rep,
                                                     cconcat(evs))
        n_t = cconcat([asc(intermediates[g]['n_opers_transformed'])
                       for g in group], axis=1)           # (a, H, i, j)
        int2 = cconcat([asc(intermediates[g]['second_order_integral'])
                        for g in group])                  # (H, o, ...)
        b_t = ceinsum('hba,kbc,hcd->hkad', eigvecs_propagated.conj(),
                      basis_dev, eigvecs_propagated)
        nob = ceinsum('ahij,hkji->hakij', n_t, b_t)
        result = result + ceinsum('hoijmn,hakij,hblmn->abklo', int2, nob,
                                  nob)
    return result


# -----------------------------------------------------------------------------
# K12: integrand dispatch
# -----------------------------------------------------------------------------
def _get_integrand(spectrum, omega, idx, which_pulse: str, which_FF: str,
                   control_matrix=None, filter_function=None) -> jnp.ndarray:
    """S(w).F(w) integrand dispatch over spectrum.ndim in {1, 2, 3}
    (numeric.py:259-374).  Returns the (real) integrand.

    Validation/parsing happens host-side; the arithmetic runs in one
    jitted call (eager per-op dispatch dominates small workloads)."""
    spectrum = util.parse_spectrum(spectrum, omega, idx)
    s = jnp.asarray(spectrum.real)
    s_im = jnp.asarray(spectrum.imag) if np.iscomplexobj(spectrum) else None
    if filter_function is not None:
        filter_function = asc(filter_function)
    elif isinstance(control_matrix, (list, tuple)):
        control_matrix = (asc(control_matrix[0]), asc(control_matrix[1]))
    elif control_matrix is not None:
        control_matrix = asc(control_matrix)
    return _integrand_core(s, s_im, control_matrix, filter_function,
                           tuple(int(i) for i in np.asarray(idx)),
                           which_pulse, which_FF)


@functools.partial(jax.jit, static_argnames=('idx', 'which_pulse',
                                             'which_FF'))
def _integrand_core(s, s_im, control_matrix, filter_function, idx,
                    which_pulse: str, which_FF: str) -> jnp.ndarray:
    spectrum_ndim = s.ndim
    idx = np.asarray(idx)

    if filter_function is not None:
        ff = filter_function
        if which_FF == 'generalized':
            # noise-oper axes at (-5, -4), basis at (-3, -2): move nops
            # next to frequency for broadcasting against S
            ff = ff._map(lambda a: jnp.moveaxis(a, (-5, -4), (-3, -2)))
        if spectrum_ndim in (1, 2):
            diag = ff._map(
                lambda a: a[..., tuple(idx), tuple(idx), :])
            integrand = diag.re * s - (0 if s_im is None else diag.im * s_im)
            if which_FF == 'generalized':
                integrand = jnp.moveaxis(integrand, -2, -4)
        else:
            block = ff._map(lambda a: a[..., idx[:, None], idx, :])
            integrand = block.re * s - (0 if s_im is None
                                        else block.im * s_im)
            if which_FF == 'generalized':
                integrand = jnp.moveaxis(integrand, (-3, -2), (-5, -4))
        return integrand

    ctrl = control_matrix
    if isinstance(ctrl, (list, tuple)):
        left, right = ctrl[0].conj(), ctrl[1]
    else:
        left, right = ctrl.conj(), ctrl
    left = left._map(lambda a: a[..., idx, :, :])
    right = right._map(lambda a: a[..., idx, :, :])
    s_c = C(s, jnp.zeros_like(s)) if s_im is None else C(s, s_im)
    if spectrum_ndim in (1, 2):
        if which_pulse == 'correlations':
            sub = ('g...ko,...o,h...ko->gh...o' if which_FF == 'fidelity'
                   else 'g...ko,...o,h...lo->gh...klo')
        else:
            sub = ('...ko,...o,...ko->...o' if which_FF == 'fidelity'
                   else '...ko,...o,...lo->...klo')
    else:
        if which_pulse == 'correlations':
            sub = ('gako,abo,hbko->ghabo' if which_FF == 'fidelity'
                   else 'gako,abo,hblo->ghabklo')
        else:
            sub = ('ako,abo,bko->abo' if which_FF == 'fidelity'
                   else 'ako,abo,blo->abklo')
    return ceinsum(sub, left, s_c, right).re


@jax.jit
def _trapz_2pi(integrand, omega):
    """Trapezoid over the last axis / 2pi, as one device call."""
    return util.integrate(integrand, omega) / (2 * np.pi)


# -----------------------------------------------------------------------------
# K13 / K14: decay amplitudes and frequency shifts
# -----------------------------------------------------------------------------
@util.parse_optional_parameters(which=('total', 'correlations'))
def calculate_decay_amplitudes(pulse, spectrum, omega,
                               n_oper_identifiers=None, which: str = 'total',
                               show_progressbar: bool = False,
                               cache_intermediates: bool = False,
                               memory_parsimonious: bool = False):
    r"""K13: Gamma_{ab,kl} = int dw/2pi B*_{ak} S_{ab} B_{bl}
    (numeric.py:1194-1337)."""
    idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                            n_oper_identifiers)
    if which == 'total':
        if pulse.is_cached('filter_function_gen'):
            control_matrix = None
            filter_function = pulse.get_filter_function(
                omega, which='generalized')
        else:
            control_matrix = pulse.get_control_matrix(
                omega, show_progressbar, cache_intermediates)
            filter_function = None
    else:
        if pulse.is_cached('omega'):
            if not np.array_equal(np.asarray(pulse.omega),
                                  np.asarray(omega)):
                raise ValueError('Pulse correlation decay amplitudes '
                                 'requested but omega not equal to cached '
                                 'frequencies.')
        if pulse.is_cached('filter_function_pc_gen'):
            control_matrix = None
            filter_function = pulse.get_pulse_correlation_filter_function(
                which='generalized')
        else:
            control_matrix = pulse.get_pulse_correlation_control_matrix()
            filter_function = None

    if not memory_parsimonious:
        integrand = _get_integrand(spectrum, omega, idx, which,
                                   'generalized',
                                   control_matrix=control_matrix,
                                   filter_function=filter_function)
        return _trapz_2pi(integrand, jnp.asarray(omega))

    # k-sliced integration to bound the (n,n,d2,d2,n_w) integrand
    n_kl = len(pulse.basis)
    slices = []
    for k in util.progressbar_range(
            n_kl, show_progressbar=show_progressbar, desc='Integrating'):
        if control_matrix is not None:
            part = _get_integrand(
                spectrum, omega, idx, which, 'generalized',
                control_matrix=[control_matrix[..., k:k + 1, :],
                                control_matrix])
        else:
            part = _get_integrand(
                spectrum, omega, idx, which, 'generalized',
                filter_function=filter_function[..., k:k + 1, :, :])
        slices.append(util.integrate(part, jnp.asarray(omega))
                      / (2 * np.pi))
    return jnp.concatenate(slices, axis=-2)


def calculate_frequency_shifts(pulse, spectrum, omega,
                               n_oper_identifiers=None,
                               show_progressbar: bool = False):
    r"""K14: Delta_{ab,kl} = int dw/2pi S_{ab}(w) F^(2)_{ab,kl}(w)
    (numeric.py:1340-1410)."""
    idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                            n_oper_identifiers)
    ff2 = pulse.get_filter_function(omega, order=2,
                                    show_progressbar=show_progressbar)
    integrand = _get_integrand(spectrum, omega, idx, 'total', 'generalized',
                               filter_function=ff2)
    return _trapz_2pi(integrand, jnp.asarray(omega))


# -----------------------------------------------------------------------------
# K15: cumulant function
# -----------------------------------------------------------------------------
def _trace_contract_basis(coeff: jnp.ndarray, basis: Basis,
                          pattern: str) -> jnp.ndarray:
    """Sum_kl coeff_kl tr(C_{p0} C_{p1} C_{p2} C_{p3}) without
    materializing the trace tensor: contraction through the basis.

    Dense replacement for the reference's sparse-COO contraction
    (numeric.py:1160-1188); cost O(n^2 d^3) with einsum path
    optimization instead of O(n^3) sparse ops.
    """
    b = basis.dev
    subs = {pattern[0]: 'ab', pattern[1]: 'bc', pattern[2]: 'cd',
            pattern[3]: 'da'}
    expr = (f"...kl,k{subs['k']},l{subs['l']},j{subs['j']},i{subs['i']}"
            '->...ij')
    return ceinsum(expr, jnp.asarray(coeff), b, b, b, b).re


def _trace_contract(coeff, basis: Basis, pattern: str) -> jnp.ndarray:
    """Dispatch: dense tensor for small bases, through-basis otherwise.

    *coeff* (decay amplitudes / frequency shifts) is real, so only the
    real part of the trace tensor contributes to the (real) result --
    which also keeps the device computation complex-free.
    """
    coeff = jnp.asarray(coeff)
    if len(basis) <= 64:
        traces = np.ascontiguousarray(basis.four_element_traces.real)
        return jnp.einsum(f'...kl,{pattern}->...ij', coeff,
                          jnp.asarray(traces), optimize=True)
    return _trace_contract_basis(coeff, basis, pattern)


def _cumulant_trace_combos(basis: Basis):
    """Host-side precombination of the four trace-tensor transposes
    each of Gamma and Delta contract with (numeric.py:1145-1191), so
    the device does ONE einsum per coefficient set.

    Returns (tg, td) with K = Gamma.tg + Delta.td via
    '...kl,klij->...ij'.
    """
    def compute():
        tr = basis.four_element_traces.real
        x1 = tr.transpose(0, 1, 3, 2)          # T_klji
        tg = -0.5 * (x1
                     - tr.transpose(0, 2, 3, 1)   # T_kjli
                     - tr.transpose(0, 2, 1, 3)   # T_kilj
                     + tr.transpose(0, 3, 1, 2))  # T_kijl
        td = -0.5 * (x1
                     - tr.transpose(1, 0, 3, 2)   # T_lkji
                     - tr                          # T_klij
                     + tr.transpose(1, 0, 2, 3))  # T_lkij
        return (np.ascontiguousarray(tg), np.ascontiguousarray(td))
    return basis._cached('cumulant_trace_combos', compute)


def _cumulant_trace_combos_dev(basis: Basis):
    """Device-resident copies of :func:`_cumulant_trace_combos`,
    cached on the basis: the (d^2)^4 combo tensors are ~0.5 MB each at
    d=4 and re-uploading them on every batched entry-point call costs
    a host->device transfer per call."""
    def upload():
        tg, td = _cumulant_trace_combos(basis)
        return (jnp.asarray(tg), jnp.asarray(td))
    return basis._cached('cumulant_trace_combos_dev', upload)


def _cumulant_contract_core(coeff, combo):
    """K15 trace contraction Gamma/Delta x four-element-trace combos.

    On the Ozaki path with f64 coefficients the '...kl,klij->...ij'
    einsum is a REAL (kl)-reduced matmul: run it through error-free
    Ozaki slices.  Both operands are real (the trace combos are
    precombined from Re[T]; gamma/delta enter as .re)."""
    from . import config
    coeff = jnp.asarray(coeff)
    combo = jnp.asarray(combo)
    if (config.contraction_mode() == 'ozaki'
            and coeff.dtype == jnp.float64):
        from .ops.ozaki import ozaki_matmul
        kl = combo.shape[0] * combo.shape[1]
        lead = coeff.shape[:-2]
        out = ozaki_matmul(coeff.reshape(-1, kl),
                           combo.reshape(kl, -1))
        return out.reshape(*lead, *combo.shape[2:])
    return jnp.einsum('...kl,klij->...ij', coeff, combo)


@functools.partial(jax.jit, static_argnames=('n_basis',))
def _cumulant_1q_core(gamma, delta, n_basis: int):
    """Single-qubit closed form (numeric.py:1120-1143) as one jitted
    call; *delta* is None for first order."""
    N = n_basis
    k_fn = jnp.zeros_like(gamma)
    diag_mask = np.zeros((N, N), dtype=bool)
    diag_mask[1:, 1:] = ~np.eye(N - 1, dtype=bool)
    k_fn = k_fn.at[..., diag_mask].set(gamma[..., diag_mask])
    diag = jnp.diagonal(gamma[..., 1:, 1:], axis1=-2, axis2=-1)
    total = diag.sum(axis=-1)
    for i in range(1, N):
        k_fn = k_fn.at[..., i, i].set(-(total - diag[..., i - 1]))
    if delta is not None:
        upd = delta[..., 1:, 1:].swapaxes(-1, -2) - delta[..., 1:, 1:]
        k_fn = k_fn.at[..., 1:, 1:].add(upd)
    return k_fn


@util.parse_optional_parameters(which=('total', 'correlations'))
def calculate_cumulant_function(
        pulse, spectrum=None, omega=None, n_oper_identifiers=None,
        which: str = 'total', second_order: bool = False,
        decay_amplitudes=None, frequency_shifts=None,
        show_progressbar: bool = False, memory_parsimonious: bool = False,
        cache_intermediates: Optional[bool] = None) -> jnp.ndarray:
    r"""K15: cumulant function K_{ab,ij}(tau) (numeric.py:957-1191).

    Single-qubit Pauli/GGM bases use the closed-form diagonal /
    off-diagonal expression (numeric.py:1120-1143); the general case
    contracts Gamma/Delta with the four-element trace tensor (dense for
    n <= 64, otherwise streamed through the basis)."""
    N, d = pulse.basis.shape[:2]
    if spectrum is None and omega is None:
        if decay_amplitudes is None or (frequency_shifts is None
                                        and second_order):
            raise ValueError('Require either spectrum and frequencies or '
                             'precomputed decay amplitudes (frequency '
                             'shifts)')
    if which == 'correlations' and second_order:
        raise ValueError('Cannot compute correlation cumulant function for '
                         'second order terms')
    if cache_intermediates is None:
        cache_intermediates = second_order

    if decay_amplitudes is None:
        decay_amplitudes = calculate_decay_amplitudes(
            pulse, spectrum, omega, n_oper_identifiers, which,
            show_progressbar, cache_intermediates, memory_parsimonious)
    decay_amplitudes = jnp.asarray(decay_amplitudes)

    if second_order:
        if frequency_shifts is None:
            if memory_parsimonious:
                warn('Memory parsimonious calculation not implemented for '
                     'frequency shifts.')
            frequency_shifts = calculate_frequency_shifts(
                pulse, spectrum, omega, n_oper_identifiers,
                show_progressbar)
        frequency_shifts = jnp.asarray(frequency_shifts)
        if frequency_shifts.shape != decay_amplitudes.shape:
            raise ValueError('Frequency shifts not same shape as decay '
                             'amplitudes')

    if d == 2 and pulse.basis.btype in ('Pauli', 'GGM'):
        # Single-qubit closed form: K_00 row/col zero; K_ii =
        # -sum_{k!=i, k>0} Gamma_kk; off-diagonal K_ij = Gamma_ij
        # (+ Delta_ji - Delta_ij for second order).
        return _cumulant_1q_core(
            decay_amplitudes,
            frequency_shifts if second_order else None, N)

    # General multi-qubit case (numeric.py:1145-1191):
    # K = -1/2 [ Gamma.(T_klji - T_kjli - T_kilj + T_kijl)
    #           + Delta.(T_klji - T_lkji - T_klij + T_lkij) ]
    gamma = decay_amplitudes
    if N <= 64:
        tg, td = _cumulant_trace_combos(pulse.basis)
        k_fn = _cumulant_contract_core(gamma, jnp.asarray(tg))
        if second_order:
            k_fn = k_fn + _cumulant_contract_core(frequency_shifts,
                                                  jnp.asarray(td))
        return k_fn

    # n > 64: stream through the basis without materializing T
    k_fn = -0.5 * (_trace_contract(gamma, pulse.basis, 'klji')
                   - _trace_contract(gamma, pulse.basis, 'kjli')
                   - _trace_contract(gamma, pulse.basis, 'kilj')
                   + _trace_contract(gamma, pulse.basis, 'kijl'))
    if second_order:
        delta = frequency_shifts
        k_fn = k_fn - 0.5 * (
            _trace_contract(delta, pulse.basis, 'klji')
            - _trace_contract(delta, pulse.basis, 'lkji')
            - _trace_contract(delta, pulse.basis, 'klij')
            + _trace_contract(delta, pulse.basis, 'lkij'))
    return k_fn


# -----------------------------------------------------------------------------
# K16: error transfer matrix
# -----------------------------------------------------------------------------
def error_transfer_matrix(pulse=None, spectrum=None, omega=None,
                          n_oper_identifiers=None, second_order: bool = False,
                          cumulant_function=None,
                          show_progressbar: bool = False,
                          memory_parsimonious: bool = False,
                          cache_intermediates: Optional[bool] = None
                          ) -> jnp.ndarray:
    r"""K16: U_tilde = exp K(tau) (numeric.py:1938-2059).  The cumulant
    function is real, so this is a real float64 expm."""
    if cumulant_function is None:
        if pulse is None or spectrum is None or omega is None:
            raise ValueError('Require either precomputed cumulant function '
                             'or pulse, spectrum, and omega as arguments.')
        cumulant_function = calculate_cumulant_function(
            pulse, spectrum, omega, n_oper_identifiers, 'total',
            second_order, show_progressbar=show_progressbar,
            memory_parsimonious=memory_parsimonious,
            cache_intermediates=cache_intermediates)
    try:
        k_total = cumulant_function.sum(
            axis=tuple(range(cumulant_function.ndim - 2)))
    except AttributeError as aerr:
        raise TypeError('cumulant_function invalid type: '
                        f'{type(cumulant_function)}') from aerr
    except (ValueError, TypeError) as verr:
        raise ValueError('cumulant_function invalid shape: '
                         f'{np.shape(cumulant_function)}') from verr
    if k_total.ndim != 2 or k_total.shape[0] != k_total.shape[1]:
        raise ValueError('cumulant_function invalid shape: '
                         f'{np.shape(cumulant_function)}')
    return expm_real(jnp.asarray(k_total))


# -----------------------------------------------------------------------------
# K17: infidelity
# -----------------------------------------------------------------------------
@util.parse_optional_parameters(which=('total', 'correlations'))
def infidelity(pulse, spectrum, omega, n_oper_identifiers=None,
               which: str = 'total', show_progressbar: bool = False,
               cache_intermediates: bool = False,
               return_smallness: bool = False,
               test_convergence: bool = False):
    r"""K17: leading-order entanglement infidelity
    I = 1/(2 pi d) int dw S(w) F(w) (numeric.py:2062-2332).

    With ``test_convergence``, *spectrum* must be a callable and *omega*
    a dict of grid parameters; returns (n_samples, infids)."""
    idx = util.get_indices_from_identifiers(pulse.n_oper_identifiers,
                                            n_oper_identifiers)

    if test_convergence:
        if not callable(spectrum):
            raise TypeError('Spectrum should be callable when '
                            'test_convergence == True.')
        try:
            omega_IR = omega.get('omega_IR', 2 * np.pi / pulse.tau * 1e-2)
        except AttributeError:
            raise TypeError('omega should be dictionary with parameters '
                            'when test_convergence == True.')
        omega_UV = omega.get('omega_UV', 2 * np.pi / pulse.tau * 1e+2)
        spacing = omega.get('spacing', 'linear')
        n_min = omega.get('n_min', 100)
        n_max = omega.get('n_max', 500)
        n_points = omega.get('n_points', 10)
        if spacing == 'linear':
            xspace = np.linspace
        elif spacing == 'log':
            xspace = np.geomspace
        else:
            raise ValueError("spacing should be either 'linear' or 'log'.")
        delta_n = (n_max - n_min) // (n_points - 1)
        n_samples = np.arange(n_min, n_max + delta_n, delta_n)
        convergence_infids = np.empty((len(n_samples), len(idx)))
        # Pad every grid in the sweep to the largest size with repeats
        # of the UV endpoint: repeated abscissae carry zero trapezoid
        # weight, so each integral is EXACTLY that of the unpadded
        # grid, while all n_points evaluations share ONE compiled
        # shape instead of recompiling the full pipeline per n_omega
        # (the dispatch-cliff economics of doc/performance.md; the
        # reference recomputes eagerly and has no such cliff,
        # /root/reference/filter_functions/numeric.py:2254-2292).
        n_pad = int(n_samples[-1])
        for i, n in enumerate(n_samples):
            freqs = xspace(omega_IR, omega_UV, int(n))
            padded = np.concatenate([freqs,
                                     np.full(n_pad - int(n), freqs[-1])])
            convergence_infids[i] = np.asarray(infidelity(
                pulse, spectrum(padded), padded,
                n_oper_identifiers=n_oper_identifiers, which='total'))
        return n_samples, convergence_infids

    if which == 'total':
        if not pulse.basis.istraceless:
            # Non-traceless basis: trace-tensor correction
            # (numeric.py:2294-2309)
            traces_diag = _nontraceless_trace_correction(pulse.basis)
            control_matrix = pulse.get_control_matrix(
                omega, show_progressbar, cache_intermediates)
            filter_function = ceinsum('ako,blo,kl->abo',
                                      control_matrix.conj(), control_matrix,
                                      jnp.asarray(traces_diag)) / pulse.d
        else:
            filter_function = pulse.get_filter_function(
                omega, which='fidelity', show_progressbar=show_progressbar,
                cache_intermediates=cache_intermediates)
    else:
        if pulse.is_cached('omega') and not np.array_equal(
                np.asarray(pulse.omega), np.asarray(omega)):
            raise ValueError('Pulse correlation infidelities requested but '
                             'omega not equal to cached frequencies.')
        filter_function = pulse.get_pulse_correlation_filter_function()

    integrand = _get_integrand(spectrum, omega, idx, which, 'fidelity',
                               filter_function=filter_function)
    infid = util.integrate(integrand, jnp.asarray(omega)) \
        / (2 * np.pi * pulse.d)

    if return_smallness:
        spectrum_arr = np.asarray(spectrum)
        if spectrum_arr.ndim > 2:
            raise NotImplementedError('Smallness parameter only implemented '
                                      'for uncorrelated noise sources')
        t1 = util.integrate(jnp.asarray(spectrum_arr),
                            jnp.asarray(omega)) / (2 * np.pi)
        t2 = (np.asarray(pulse.dt) * np.asarray(pulse.n_coeffs)[idx]).sum(
            axis=-1)**2
        t3 = np.asarray(
            util.abs2(np.asarray(pulse.n_opers)[idx])).sum(axis=(1, 2))
        xi = jnp.sqrt((t1 * t2 * t3).sum())
        return infid, xi
    return infid


def _nontraceless_trace_correction(basis: Basis) -> np.ndarray:
    """traces_diag_kl = sum_m [tr(C_k C_l C_m C_m) - tr(C_k C_m C_l C_m)]
    computed through the basis, never materializing T
    (cf. numeric.py:2299-2301)."""
    b = basis.np
    m1 = np.einsum('mab,mbc->ac', b, b)                 # sum_m C_m C_m
    term1 = np.einsum('kab,lbc,ca->kl', b, b, m1, optimize=True)
    t2 = np.einsum('mab,lbc,mcd->lad', b, b, b, optimize=True)
    term2 = np.einsum('kab,lba->kl', b, t2, optimize=True)
    return (term1 - term2).real
