"""Utility functions (JAX rebuild of the reference's ``util``).

Functional parity targets /root/reference/filter_functions/util.py:
``paulis``, ``abs2``, ``cexp``, ``cexpm1``, the ``tensor*`` family,
``mdot``/``adot``, ``integrate``, ``oper_equiv``, ``dot_HS``,
``get_sample_frequencies``, identifier utilities, and
``CalculationError``.

Design differences from the reference:

* ``cexp``/``cexpm1`` return split-complex :class:`~.cplx.C` values and
  rely on XLA fusion instead of NumPy ``out=``/``where=`` buffer reuse
  (util.py:136-182).
* ``adot`` (cumulative matrix product) is a log-depth
  ``jax.lax.associative_scan`` instead of a serial Python
  ``itertools.accumulate`` loop (util.py:868-877) -- the propagator
  accumulation is one of the two serial bottlenecks of the reference.
* ``integrate`` is a pure trapezoid contraction (no in-place tricks).

The tensor-product helpers operate on host NumPy arrays, jnp arrays, or
:class:`~.cplx.C` operands alike.
"""
from __future__ import annotations

import functools
import inspect
import string
from itertools import zip_longest
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import config
from .cplx import C, abs2 as _cabs2, asc, ceinsum, cexp, cexpm1  # noqa: F401 (re-export)

__all__ = ['paulis', 'abs2', 'all_array_equal', 'dot_HS',
           'get_sample_frequencies', 'hash_array_along_axis', 'mdot', 'adot',
           'oper_equiv', 'remove_float_errors', 'tensor', 'tensor_insert',
           'tensor_merge', 'tensor_transpose', 'integrate', 'cexp', 'cexpm1',
           'CalculationError', 'parse_optional_parameters',
           'get_indices_from_identifiers']

#: The unnormalized Pauli matrices (I, X, Y, Z), host-side numpy.
paulis = np.array([
    [[1, 0], [0, 1]],
    [[0, 1], [1, 0]],
    [[0, -1j], [1j, 0]],
    [[1, 0], [0, -1]],
], dtype=complex)


class CalculationError(Exception):
    """A requested quantity was not computed and cannot be derived
    (e.g. pulse-correlation data absent after concatenation;
    cf. util.py:1146-1150)."""


def abs2(x):
    """|x|^2 for numpy/jnp arrays or :class:`C`."""
    if isinstance(x, C):
        return _cabs2(x)
    if np.iscomplexobj(x):
        return x.real**2 + x.imag**2
    return x * x


# -----------------------------------------------------------------------------
# Parameter parsing helpers
# -----------------------------------------------------------------------------
def parse_optional_parameters(**allowed: Sequence) -> Callable:
    """Decorator validating that selected keyword/positional arguments
    take one of a fixed set of values (util.py:185-211 equivalent)."""
    def decorator(func):
        sig = inspect.signature(func)
        names = list(sig.parameters)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            for name, ok in allowed.items():
                pos = names.index(name)
                if pos < len(args):
                    val = args[pos]
                else:
                    val = kwargs.get(name, sig.parameters[name].default)
                if val not in ok:
                    raise ValueError(
                        f"Invalid value for {name}: {val}. "
                        f"Should be one of {tuple(ok)}.")
            return func(*args, **kwargs)
        return wrapper
    return decorator


def parse_operators(opers: Sequence, err_loc: str) -> np.ndarray:
    """Duck-type convert a sequence of operators to a complex ndarray.

    Accepts numpy arrays, anything with ``full()`` (qutip.Qobj),
    ``to_array()``, ``todense()``, or qopt-style ``.data`` + ``.dexp``
    (cf. util.py:230-281)."""
    out = []
    for op in opers:
        if isinstance(op, C):
            out.append(op.to_numpy().squeeze())
        elif isinstance(op, (np.ndarray, jnp.ndarray)):
            out.append(np.asarray(op).squeeze())
        elif hasattr(op, 'full'):
            out.append(op.full())
        elif hasattr(op, 'to_array'):
            out.append(op.to_array())
        elif hasattr(op, 'todense'):
            out.append(op.todense())
        elif hasattr(op, 'data') and hasattr(op, 'dexp'):
            out.append(op.data)
        else:
            raise TypeError(f'Expected operators in {err_loc} to be NumPy '
                            'arrays or QuTiP Qobjs!')

    arr = np.asarray(out, dtype=complex)
    if arr.ndim > 3:
        raise ValueError(f'Expected operators in {err_loc} to be '
                         'two-dimensional!')
    if arr.shape[-1] != arr.shape[-2]:
        raise ValueError(f'Expected operators in {err_loc} to be square!')
    return arr


def parse_spectrum(spectrum, omega, idx) -> np.ndarray:
    """Validate/broadcast a PSD array against (idx, omega)
    (util.py:214-227 equivalent)."""
    spectrum = np.asarray(spectrum)
    shape = (len(idx),) * (spectrum.ndim - 1) + (len(omega),)
    try:
        spectrum = np.broadcast_to(spectrum, shape)
    except ValueError as err:
        raise ValueError(f'Spectrum should be of shape {shape}, not '
                         f'{spectrum.shape}.') from err
    if spectrum.ndim == 3:
        if not np.allclose(spectrum, spectrum.conj().swapaxes(0, 1)):
            raise ValueError('Cross-spectra given but not Hermitian along '
                             'first two axes')
    elif spectrum.ndim > 3:
        raise ValueError('Expected spectrum to have < 4 dimensions, not '
                         f'{spectrum.ndim}')
    return spectrum


def is_sequence_like(obj) -> bool:
    return hasattr(obj, '__len__') and hasattr(obj, '__getitem__')


def get_indices_from_identifiers(
        all_identifiers: Sequence[str],
        identifiers: Union[None, str, Sequence[str]]) -> np.ndarray:
    """Indices of *identifiers* within *all_identifiers*
    (util.py:331-357 equivalent)."""
    if identifiers is None:
        return np.arange(len(all_identifiers))
    table = {ident: i for i, ident in enumerate(all_identifiers)}
    if isinstance(identifiers, str):
        identifiers = [identifiers]
    try:
        return np.array([table[i] for i in identifiers])
    except KeyError:
        raise ValueError('Invalid identifiers given. All available ones '
                         f'are: {all_identifiers}')


# -----------------------------------------------------------------------------
# Tensor-product family
# -----------------------------------------------------------------------------
def _einsum_any(subscripts: str, *ops):
    """einsum dispatching on operand types (numpy / jnp / C)."""
    if any(isinstance(o, C) for o in ops):
        return ceinsum(subscripts, *ops)
    if any(isinstance(o, jnp.ndarray) for o in ops):
        return jnp.einsum(subscripts, *ops)
    return np.einsum(subscripts, *ops)


def _reshape_any(x, shape):
    return x.reshape(shape) if isinstance(x, C) else (
        jnp.reshape(x, shape) if isinstance(x, jnp.ndarray)
        else np.reshape(x, shape))


def _kron_shape(shape_a, shape_b, rank: int):
    """Output shape of a rank-*rank* tensor product with broadcasting of
    the leading axes."""
    lead = []
    for da, db in zip_longest(shape_a[-rank - 1::-1], shape_b[-rank - 1::-1],
                              fillvalue=1):
        if 1 in (da, db):
            lead.insert(0, max(da, db))
        elif da == db:
            lead.insert(0, da)
        else:
            raise ValueError(f'Incompatible shapes {shape_a} and {shape_b} '
                             f'for tensor product of rank {rank}.')
    prod = [da * db for da, db in zip_longest(shape_a[:-rank - 1:-1],
                                              shape_b[:-rank - 1:-1],
                                              fillvalue=1)][::-1]
    return tuple(lead) + tuple(prod)


def _atleast_rank(x, rank: int):
    while x.ndim < rank:
        x = x[None] if isinstance(x, (C, jnp.ndarray)) else x[None, :]
    return x


def tensor(*args, rank: int = 2, optimize=False):
    """Tensor (Kronecker) product over the last *rank* axes with
    broadcasting over leading axes; evaluated as a balanced binary tree
    (util.py:360-463 equivalent).

    >>> import numpy as np
    >>> Z = np.diag([1., -1.])
    >>> bool(np.array_equal(tensor(Z, Z), np.kron(Z, Z)))
    True
    """
    letters = string.ascii_letters
    sub_a, sub_b = letters[:rank], letters[rank:2 * rank]
    interleaved = ''.join(i + j for i, j in zip(sub_a, sub_b))
    subscripts = f'...{sub_a},...{sub_b}->...{interleaved}'

    def pair(a, b):
        a, b = _atleast_rank(a, rank), _atleast_rank(b, rank)
        outshape = _kron_shape(a.shape, b.shape, rank)
        return _reshape_any(_einsum_any(subscripts, a, b), outshape)

    items = list(args)
    while len(items) > 1:
        bit = len(items) % 2
        items = items[:bit] + [pair(items[i], items[i + 1])
                               for i in range(bit, len(items), 2)]
    return items[0]


def _check_dims(name: str, dims, rank: int) -> None:
    if len(dims) != rank:
        raise ValueError(f'{name}_dims should be of length rank = {rank}, '
                         f'not {len(dims)}')
    if len({len(d) for d in dims}) != 1:
        raise ValueError(f'Require all lists in {name}_dims to be of same '
                         'length!')


def tensor_insert(arr, *args, pos, arr_dims, rank: int = 2, optimize=False):
    """Insert tensors into a tensor-product chain at given positions
    (util.py:466-637 equivalent).

    >>> import numpy as np
    >>> I, X, Y, Z = paulis
    >>> r = tensor_insert(tensor(X, I), Y, Z, pos=0,
    ...                   arr_dims=[[2, 2], [2, 2]])
    >>> bool(np.allclose(r, tensor(Y, Z, X, I)))
    True
    """
    if len(args) == 0:
        raise ValueError('Require nonzero number of args!')

    if np.issubdtype(type(pos), np.integer):
        pos = (int(pos),)
        if len(args) > 1:
            args = (tensor(*args, rank=rank),)
    else:
        if len(pos) != len(args):
            raise ValueError('Expected pos to be either an int or a sequence '
                             'of the same length as the number of args, not '
                             f'length {len(pos)}')
    _check_dims('arr', arr_dims, rank)

    def insert_one(target, ins, dims, p):
        nfac = len(dims[0])
        ins_chars = string.ascii_letters[:rank]
        arr_chars = string.ascii_letters[rank:(nfac + 1) * rank]
        out = arr_chars[:p] + ''.join(
            ins_chars[r] + arr_chars[p + r * nfac:p + (r + 1) * nfac]
            for r in range(rank))
        subscripts = f'...{ins_chars},...{arr_chars}->...{out}'
        outshape = _kron_shape(ins.shape, target.shape, rank)
        flat = [d for axis in dims for d in axis]
        reshaped = _reshape_any(target, (*target.shape[:-rank], *flat))
        return _reshape_any(_einsum_any(subscripts, ins, reshaped), outshape)

    result = arr
    dims = [list(axis) for axis in arr_dims]
    nfac = len(dims[0])
    cpos = list(pos)
    divs, mods = zip(*[divmod(p, nfac) if p != nfac else (0, p)
                       for p in cpos])
    order = sorted(range(len(args)), key=lambda i: mods[i])
    for shift, i in enumerate(order):
        if divs[i] not in (-1, 0):
            raise IndexError(f'Invalid position {cpos[i]} specified. Must be '
                             f'between -{nfac} and {nfac}.')
        p = mods[i] + shift
        try:
            result = insert_one(result, _atleast_rank(args[i], rank), dims, p)
        except ValueError as err:
            raise ValueError(
                f'Could not insert arg {i} with shape {result.shape} into '
                f'the array with shape {args[i].shape} at position '
                f'{mods[i]}.') from err
        for axis, d in zip(dims, args[i].shape[-rank:]):
            axis.insert(p, d)
    return result


def tensor_merge(arr, ins, pos, arr_dims, ins_dims, rank: int = 2,
                 optimize=False):
    """Merge two tensor-product chains at positions *pos*
    (util.py:640-780 equivalent).

    >>> import numpy as np
    >>> I, X, Y, Z = paulis
    >>> r = tensor_merge(tensor(X, Y, Z), tensor(I, I), pos=[1, 2],
    ...                  arr_dims=[[2]*3, [2]*3], ins_dims=[[2]*2, [2]*2])
    >>> bool(np.allclose(r, tensor(X, I, Y, I, Z)))
    True
    """
    for name, dims in (('arr', arr_dims), ('ins', ins_dims)):
        _check_dims(name, dims, rank)

    n_ins = len(ins_dims[0])
    n_arr = len(arr_dims[0])
    ins_chars = string.ascii_letters[:n_ins * rank]
    arr_chars = string.ascii_letters[n_ins * rank:(n_ins + n_arr) * rank]
    out_chars = ''
    for r in range(rank):
        arr_part = arr_chars[r * n_arr:(r + 1) * n_arr]
        ins_part = ins_chars[r * n_ins:(r + 1) * n_ins]
        for i, (p, ch) in enumerate(sorted(zip(pos, ins_part))):
            if p != n_arr:
                div, p = divmod(p, n_arr)
                if div not in (-1, 0):
                    raise IndexError(f'Invalid position {pos[i]} specified. '
                                     f'Must be between -{n_arr} and {n_arr}.')
            arr_part = arr_part[:p + i] + ch + arr_part[p + i:]
        out_chars += arr_part

    subscripts = f'...{ins_chars},...{arr_chars}->...{out_chars}'
    outshape = _kron_shape(ins.shape, arr.shape, rank)
    flat_arr = [d for axis in arr_dims for d in axis]
    flat_ins = [d for axis in ins_dims for d in axis]
    try:
        ins_r = _reshape_any(ins, (*ins.shape[:-rank], *flat_ins))
    except (ValueError, TypeError) as err:
        raise ValueError('ins_dims not compatible with ins.shape[-rank:] = '
                         f'{ins.shape[-rank:]}') from err
    try:
        arr_r = _reshape_any(arr, (*arr.shape[:-rank], *flat_arr))
    except (ValueError, TypeError) as err:
        raise ValueError('arr_dims not compatible with arr.shape[-rank:] = '
                         f'{arr.shape[-rank:]}') from err
    return _reshape_any(_einsum_any(subscripts, ins_r, arr_r), outshape)


def tensor_transpose(arr, order: Sequence[int], arr_dims, rank: int = 2):
    """Permute the factors of a tensor-product chain
    (util.py:783-860 equivalent).

    >>> import numpy as np
    >>> I, X, Y, Z = paulis
    >>> r = tensor_transpose(tensor(X, Y, Z), [1, 2, 0],
    ...                      arr_dims=[[2, 2, 2]]*2)
    >>> bool(np.allclose(r, tensor(Y, Z, X)))
    True
    """
    _check_dims('arr', arr_dims, rank)
    nfac = len(arr_dims[0])
    order = list(order)
    if sorted(order) != list(range(nfac)):
        if any(not np.issubdtype(type(o), np.integer) for o in order):
            raise TypeError("Could not transpose the order. Are all elements "
                            "of 'order' integers?")
        raise ValueError("Could not transpose the order. Are all elements of "
                         "'order' unique and match the array?")
    n_lead = arr.ndim - rank
    axes = (list(range(n_lead))
            + [n_lead + r * nfac + o for r in range(rank) for o in order])
    flat = [d for axis in arr_dims for d in axis]
    try:
        reshaped = _reshape_any(arr, (*arr.shape[:-rank], *flat))
    except (ValueError, TypeError) as err:
        raise ValueError('arr_dims not compatible with arr.shape[-rank:] = '
                         f'{arr.shape[-rank:]}') from err
    transposed = (reshaped.transpose(*axes) if isinstance(reshaped, C)
                  else reshaped.transpose(axes))
    return _reshape_any(transposed, arr.shape)


# -----------------------------------------------------------------------------
# Matrix product helpers
# -----------------------------------------------------------------------------
def mdot(arr, axis: int = 0):
    """Reduce a stack of matrices by matrix product along *axis*:
    ``mdot([A0, A1, A2]) = A0 @ A1 @ A2``.

    Device stacks reduce inside one jitted ``lax.scan`` -- a Python
    loop of eager matmuls would pay per-element dispatch for
    thousand-segment stacks (e.g. total propagators of long
    concatenations)."""
    if isinstance(arr, C):
        mats = arr.swapaxes(0, axis) if axis else arr
        if len(mats) == 1:
            return mats[0]
        re, im = _mdot_scan_split(mats.re, mats.im)
        return C(re, im)
    if isinstance(arr, jnp.ndarray):
        mats = jnp.swapaxes(arr, 0, axis) if axis else arr
        if mats.shape[0] == 1:
            return mats[0]
        return _mdot_scan(mats)
    mats = np.swapaxes(np.asarray(arr), 0, axis)
    return functools.reduce(lambda a, b: a @ b, mats)


@jax.jit
def _mdot_scan(mats: jnp.ndarray) -> jnp.ndarray:
    # pairwise tree reduction: log2 G batched matmuls instead of G
    # dependent scan steps (a 1e4-long total-propagator product is
    # 14 batch-parallel levels).  Matrix order is preserved:
    # even[i] @ odd[i] = A_{2i} @ A_{2i+1}.
    while mats.shape[0] > 1:
        n = mats.shape[0]
        prod = jnp.matmul(mats[0:n - (n % 2):2], mats[1:n:2])
        if n % 2:
            prod = jnp.concatenate([prod, mats[n - 1:]], 0)
        mats = prod
    return mats[0]


@jax.jit
def _mdot_scan_split(re: jnp.ndarray, im: jnp.ndarray):
    # same pairwise tree as _mdot_scan, in Gauss 3-mult split-complex
    while re.shape[0] > 1:
        n = re.shape[0]
        er, ei = re[0:n - (n % 2):2], im[0:n - (n % 2):2]
        xr, xi = re[1:n:2], im[1:n:2]
        p1 = jnp.matmul(er, xr)
        p2 = jnp.matmul(ei, xi)
        p3 = jnp.matmul(er + ei, xr + xi)
        pr, pi = p1 - p2, p3 - p1 - p2
        if n % 2:
            pr = jnp.concatenate([pr, re[n - 1:]], 0)
            pi = jnp.concatenate([pi, im[n - 1:]], 0)
        re, im = pr, pi
    return re[0], im[0]


def _adot_use_sequential(n_mats: int, dim: int) -> bool:
    """Pick the cumulative-product strategy by static shape.

    Long stacks (concatenation trains: G up to 1e4) run as a rolled
    ``lax.scan`` -- O(1) ops to compile regardless of G (the log-depth
    associative scan unrolls ~log G slice/pad/interleave levels, which
    costs seconds of XLA compile at G=1e4 and wins nothing when the
    serial step is this small).  Short stacks take the log-depth
    associative scan at EVERY dim: large matrices fill the matrix
    units per level, and for small ones vmapped over a pulse batch the rolled
    scan's G serial steps are pure latency (batched CPMG-16, d=2,
    G=33, batch 1024: the scan's 32 dependent steps dominate the
    diagonalization stage, while the assoc scan runs 6 levels of
    batch-parallel matmuls).
    """
    if n_mats <= 256:
        return False
    # long stacks: the rolled scan's G dependent steps are pure
    # latency on accelerators (one kernel launch each); pay the assoc
    # scan's one-time log-G compile there and keep the O(1)-compile
    # rolled scan on CPU
    return jax.default_backend() == 'cpu'


def adot(arr, axis: int = 0):
    """Accumulated (cumulative) matrix product along *axis*:
    ``out[g] = arr[g] @ arr[g-1] @ ... @ arr[0]``.

    Device path replacing the reference's serial ``accumulate`` loop
    (util.py:868-877): a log-depth ``lax.associative_scan`` for short
    stacks of large matrices, a rolled ``lax.scan`` for long stacks of
    small ones (see :func:`_adot_use_sequential`).
    """
    if isinstance(arr, C):
        mats = arr.swapaxes(0, axis) if axis else arr
        if _adot_use_sequential(mats.shape[0], mats.shape[-1]):
            re, im = _adot_seq_split(mats.re, mats.im)
        else:
            re, im = _adot_scan_split(mats.re, mats.im)
        out = C(re, im)
        return out.swapaxes(0, axis) if axis else out
    if isinstance(arr, jnp.ndarray):
        mats = jnp.swapaxes(arr, 0, axis) if axis else arr
        if _adot_use_sequential(mats.shape[0], mats.shape[-1]):
            out = _adot_seq(mats)
        else:
            out = _adot_assoc(mats)
        return jnp.swapaxes(out, 0, axis) if axis else out
    # host numpy fallback
    mats = np.swapaxes(np.asarray(arr), 0, axis)
    out = np.empty_like(mats)
    out[0] = mats[0]
    for g in range(1, len(mats)):
        out[g] = mats[g] @ out[g - 1]
    return np.swapaxes(out, 0, axis)


@jax.jit
def _adot_assoc(mats: jnp.ndarray):
    return lax.associative_scan(lambda a, b: jnp.matmul(b, a), mats)


@jax.jit
def _adot_seq(mats: jnp.ndarray):
    def step(carry, x):
        out = x @ carry
        return out, out
    _, rest = lax.scan(step, mats[0], mats[1:])
    return jnp.concatenate([mats[:1], rest])


@jax.jit
def _adot_scan_split(re: jnp.ndarray, im: jnp.ndarray):
    """associative_scan of complex matmul on split operands."""
    def combine(a, b):
        # b @ a in complex split arithmetic (Gauss 3-mult)
        (ar, ai), (br, bi) = a, b
        p1 = jnp.matmul(br, ar)
        p2 = jnp.matmul(bi, ai)
        p3 = jnp.matmul(br + bi, ar + ai)
        return p1 - p2, p3 - p1 - p2
    return lax.associative_scan(combine, (re, im))


@jax.jit
def _adot_seq_split(re: jnp.ndarray, im: jnp.ndarray):
    """Rolled-scan cumulative complex matmul on split operands."""
    def step(carry, x):
        cr, ci = carry
        xr, xi = x
        p1 = xr @ cr
        p2 = xi @ ci
        p3 = (xr + xi) @ (cr + ci)
        out = (p1 - p2, p3 - p1 - p2)
        return out, out
    _, rest = lax.scan(step, (re[0], im[0]), (re[1:], im[1:]))
    return (jnp.concatenate([re[:1], rest[0]]),
            jnp.concatenate([im[:1], rest[1]]))


def integrate(f, x=None, dx: float = 1.0):
    """Trapezoidal integration over the last axis (util.py:880-906).

    Works on real/complex numpy, jnp arrays, and :class:`C`."""
    if isinstance(f, C):
        return C(integrate(f.re, x, dx), integrate(f.im, x, dx))
    xp = jnp if isinstance(f, jnp.ndarray) or isinstance(x, jnp.ndarray) \
        else np
    d = xp.diff(x) if x is not None else dx
    return ((f[..., 1:] + f[..., :-1]) * d).sum(axis=-1) / 2


# -----------------------------------------------------------------------------
# Misc numerics
# -----------------------------------------------------------------------------
def remove_float_errors(arr, eps_scale: Optional[float] = None):
    """Zero out entries below dtype-eps * scale (util.py:909-938)."""
    arr = np.array(arr) if not isinstance(arr, np.ndarray) else arr
    if eps_scale is None:
        atol = np.finfo(arr.dtype).eps * (arr.shape[-1] if arr.ndim else 1)
    else:
        atol = np.finfo(arr.dtype).eps * eps_scale
    if np.iscomplexobj(arr):
        arr.real[np.abs(arr.real) <= atol] = 0
        arr.imag[np.abs(arr.imag) <= atol] = 0
    else:
        arr[np.abs(arr) <= atol] = 0
    return arr


def dot_HS(U, V, eps: Optional[float] = None):
    r"""Hilbert-Schmidt inner product tr(U^dag V) (util.py:1003-1051)."""
    U = U.full() if hasattr(U, 'full') else U
    V = V.full() if hasattr(V, 'full') else V
    U, V = np.asarray(U), np.asarray(V)
    if eps is None:
        try:
            eps = max(np.finfo(U.dtype).eps, np.finfo(V.dtype).eps) \
                * np.prod(U.shape) * V.shape[-1] * 2
        except ValueError:
            eps = 0
    res = np.einsum('...ij,...ij', U.conj(), V)
    if eps > 0:
        res = np.around(res, decimals=abs(int(np.log10(eps))))
    return res if np.iscomplexobj(res) and res.imag.any() else res.real


def oper_equiv(psi, phi, eps: Optional[float] = None,
               normalized: bool = False) -> Tuple[bool, float]:
    """Check equality up to global phase; returns (equal, phase)
    (util.py:941-1000)."""
    psi = psi.full() if hasattr(psi, 'full') else psi
    phi = phi.full() if hasattr(phi, 'full') else phi
    psi, phi = np.atleast_2d(np.asarray(psi), np.asarray(phi))
    if eps is None:
        eps = (max(np.finfo(psi.dtype).eps, np.finfo(phi.dtype).eps)
               * np.prod(psi.shape) * phi.shape[-1] * 2)
        if not normalized:
            eps *= (np.prod(psi.shape[-2:]) * phi.shape[-1] * 2)**2
    try:
        inner = dot_HS(psi, phi, eps=0)
    except ValueError as err:
        raise ValueError('psi and phi have incompatible dimensions!') from err
    norm = 1 if normalized else np.sqrt(
        dot_HS(psi, psi, eps=0) * dot_HS(phi, phi, eps=0))
    return abs(norm - abs(inner)) <= eps, np.angle(inner)


@parse_optional_parameters(spacing=('log', 'linear'))
def get_sample_frequencies(pulse, n_samples: int = 300, spacing: str = 'log',
                           include_quasistatic: bool = False,
                           omega_min: Optional[float] = None,
                           omega_max: Optional[float] = None) -> np.ndarray:
    r"""Default angular-frequency grid for a pulse: IR cutoff
    2pi*1e-2/tau, UV cutoff 2pi*10/min(dt) (util.py:1054-1093)."""
    xspace = np.geomspace if spacing == 'log' else np.linspace
    tau = float(pulse.tau)
    dt_min = float(np.min(np.asarray(pulse.dt)))
    omega_min = 2 * np.pi * 1e-2 / tau if omega_min is None else omega_min
    omega_max = 2 * np.pi * 1e+1 / dt_min if omega_max is None else omega_max
    omega = xspace(omega_min, omega_max, n_samples - include_quasistatic)
    if include_quasistatic:
        return np.insert(omega, 0, 0)
    return omega


def hash_array_along_axis(arr, axis: int = 0) -> List[int]:
    """Hashes of subarrays along *axis* (adding 0.0 sanitizes -0.0)."""
    arr = np.asarray(arr)
    return [hash((sub + 0.0).tobytes())
            for sub in np.swapaxes(arr, 0, axis)]


def all_array_equal(it: Iterable) -> bool:
    """True if all (host) arrays in *it* are byte-identical.

    Deduplicates by object identity first: pulse trains built as
    ``[p] * G`` hand the same array object G times, and hashing its
    bytes G times would dominate long concatenations.
    """
    seen_ids: set = set()
    keepalive = []  # pin yielded objects so ids can't be recycled
    hashes: set = set()
    for i in it:
        if id(i) in seen_ids:
            continue
        seen_ids.add(id(i))
        keepalive.append(i)
        hashes.add(hash(np.asarray(i).tobytes()))
        if len(hashes) > 1:
            return False
    return len(hashes) == 1


def progressbar(iterable, *args, **kwargs):
    """tqdm wrapper; host-side loops only (device loops are scans)."""
    try:
        from tqdm.autonotebook import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, *args, **kwargs)


def progressbar_range(*args, show_progressbar: bool = False, **kwargs):
    if show_progressbar:
        return progressbar(range(*args), **kwargs)
    return range(*args)
