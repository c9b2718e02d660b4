"""Superoperator utilities (JAX rebuild of
/root/reference/filter_functions/superoperator.py).

Liouville representations of unitaries in a hermitian basis are real,
so they live as plain float64 arrays on device; only the Choi
conversion is complex and uses the split representation.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np

from . import basis as _b
from .cplx import C, asc, ceinsum, eigh

__all__ = ['liouville_representation', 'liouville_to_choi',
           'liouville_is_CP', 'liouville_is_cCP']


def liouville_representation(U, basis: _b.Basis):
    r"""Liouville (transfer-matrix) representation
    U_ij = tr(C_i U C_j U^dag) of a unitary *U* w.r.t. *basis*
    (superoperator.py:51-84).

    Returns a real jnp array for hermitian bases, else a :class:`C`.
    """
    U = asc(U)
    conjugated = ceinsum('...ba,ibc,...cd->...iad', U.conj(),
                         basis.dev, U)
    coeffs = _b.expand(conjugated, basis, normalized=basis.isnorm,
                       hermitian=basis.isherm)
    return coeffs


def liouville_to_choi(superoperator, basis: _b.Basis) -> C:
    r"""choi(S) = sum_ij S_ij C_j^T (x) C_i (superoperator.py:87-135)."""
    s = superoperator
    if not isinstance(s, C):
        s = jnp.asarray(s)
        if jnp.issubdtype(s.dtype, jnp.complexfloating):
            s = asc(s)
    choi = ceinsum('...ij,jba,icd->...acbd', s, basis.dev, basis.dev)
    shape = choi.shape
    d2 = shape[-4] * shape[-3]
    out_shape = shape[:-4] + (d2, d2)
    return choi.reshape(out_shape)


def _robust_eigh(a: C):
    """Hermitian eigendecomposition (the reference falls back to a
    scipy driver on LAPACK failures, superoperator.py:269-286; our
    backend dispatch in cplx.eigh covers this)."""
    return eigh(a)


def liouville_is_CP(superoperator, basis: _b.Basis,
                    return_eig: Optional[bool] = False,
                    atol: Optional[float] = None):
    r"""Complete positivity check: choi(S) >= 0
    (superoperator.py:138-193)."""
    choi = liouville_to_choi(superoperator, basis)
    choi = choi if isinstance(choi, C) else asc(choi)
    d, v = _robust_eigh(choi)
    tol = atol if atol is not None else basis._atol
    cp = np.asarray((d >= -tol).all(axis=-1))
    cp = bool(cp) if cp.ndim == 0 else cp
    if return_eig:
        return cp, (d, v)
    return cp


def liouville_is_cCP(superoperator, basis: _b.Basis,
                     return_eig: Optional[bool] = False,
                     atol: Optional[float] = None):
    r"""Conditional complete positivity: Q choi(S) Q >= 0 with Q the
    projector on the complement of the maximally entangled state
    (superoperator.py:196-266)."""
    s = superoperator
    d2 = (s.shape[-1] if not isinstance(s, (list, tuple))
          else np.shape(s)[-1])
    d = int(np.sqrt(d2))
    omega_vec = np.zeros(d2)
    omega_vec[::d + 1] = 1 / np.sqrt(d)
    q_proj = np.eye(d2) - np.outer(omega_vec, omega_vec)
    q_dev = jnp.asarray(q_proj)

    choi = liouville_to_choi(s, basis)
    choi = choi if isinstance(choi, C) else asc(choi)
    projected = C(q_dev @ choi.re @ q_dev, q_dev @ choi.im @ q_dev)
    dvals, v = _robust_eigh(projected)
    tol = atol if atol is not None else basis._atol
    ccp = np.asarray((dvals >= -tol).all(axis=-1))
    ccp = bool(ccp) if ccp.ndim == 0 else ccp
    if return_eig:
        return ccp, (dvals, v)
    return ccp
