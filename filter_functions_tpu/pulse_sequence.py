"""The PulseSequence class (JAX rebuild of
/root/reference/filter_functions/pulse_sequence.py).

Host/device split: Hamiltonian metadata (operators, identifiers,
coefficients, time steps) lives as host numpy arrays -- they drive
shape- and identity-level decisions (sorting, hashing, cache reuse,
concatenation algebra).  All computed quantities (eigendecompositions,
propagators, control matrices, filter functions) are device values:
real jnp arrays or split-complex :class:`~.cplx.C` pytrees.  The
three-tier cache of the reference (``_data`` / ``_frequency_data`` /
``_intermediates``, pulse_sequence.py:262-271) is preserved, as are the
omega-keyed invalidation semantics (pulse_sequence.py:1158-1169) and
the ``cleanup`` tiers (pulse_sequence.py:1188-1245).
"""
from __future__ import annotations

import copy as _copy
from collections.abc import Mapping
from types import MappingProxyType
from typing import Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import numeric, util
from .basis import Basis
from .cplx import C, asc, cexp
from .superoperator import liouville_representation
from .types import Coefficients, Hamiltonian, Operator

__all__ = ['PulseSequence', 'concatenate', 'concatenate_periodic', 'extend',
           'remap', 'concatenate_without_filter_function']


def _parse_hamiltonian(H, n_dt: int, H_str: str):
    """Parse the QuTiP-style nested list [[oper, coeffs, identifier?],...]
    and return (opers, identifiers, coeffs) sorted alphanumerically by
    identifier -- the load-bearing ordering invariant of the reference
    (pulse_sequence.py:1288-1337)."""
    if not util.is_sequence_like(H):
        raise TypeError(f'Expected {H_str} to be a sequence, not of type '
                        f'{type(H)}!')
    # Mappings duck-type as sequences through integer keys but are not
    # valid Hamiltonian entries (reference rejects them too).
    if not all(util.is_sequence_like(item)
               and not isinstance(item, Mapping) for item in H):
        raise TypeError(f'Expected {H_str} to be a sequence of sequences '
                        'but found at least one item of H not a sequence!')

    prefix = 'A' if H_str == 'H_c' else 'B'
    opers, identifiers, coeffs = [], [], []
    for i, item in enumerate(H):
        if len(item) < 2:
            raise TypeError(f'Expected {H_str}[{i}] to contain at least an '
                            'operator and a coefficient list!')
        opers.append(item[0])
        coeffs.append(item[1])
        ident = item[2] if len(item) > 2 and item[2] is not None \
            else f'{prefix}_{i}'
        identifiers.append(ident)

    if len(set(identifiers)) != len(identifiers):
        raise ValueError(f'{H_str} identifiers should be unique')
    for coeff in coeffs:
        if not util.is_sequence_like(coeff):
            raise TypeError(f'Expected coefficients in {H_str} to be a '
                            'sequence')
        if len(coeff) != n_dt:
            raise ValueError(f'Expected all coefficients in {H_str} to be '
                             f'of len(dt) = {n_dt}!')

    opers = util.parse_operators(opers, H_str)
    identifiers = np.asarray(identifiers)
    coeffs = np.asarray(coeffs, dtype=float)
    order = np.argsort(identifiers)
    return opers[order], identifiers[order], coeffs[order]


@jax.jit
def _total_phases_jit(omega, tau):
    return cexp(omega * tau)


@jax.jit
def _propagator_at_t_jit(propagators: C, eigvals, eigvecs: C, idx,
                         t_seg, t) -> C:
    q_prev = propagators[idx]
    phases = cexp((t_seg - t)[:, None] * eigvals[idx])
    u_curr = util.ceinsum('lij,lj,lkj->lik', eigvecs[idx], phases,
                          eigvecs[idx].conj())
    return u_curr @ q_prev


@jax.jit
def _trace_basis_axes(ff_gen: C) -> C:
    """Generalized -> fidelity reduction tr over the basis axes; jitted
    (one dispatch instead of one per eager op)."""
    return ff_gen.trace(axis1=2, axis2=3)


@jax.jit
def _trace_pc_basis_axes(ff_pc_gen: C) -> C:
    return ff_pc_gen.trace(axis1=4, axis2=5)


@jax.jit
def _sum_pulse_axes(f_pc: C) -> C:
    return f_pc.sum(axis=0).sum(axis=0)


def _join_equal_segments(pulse: 'PulseSequence'):
    """Merge consecutive segments with identical control coefficients
    before comparing pulses (pulse_sequence.py:1270-1285)."""
    equal = (np.diff(pulse.c_coeffs) == 0).all(axis=0).nonzero()[0]
    if equal.size == 0:
        return pulse.c_coeffs, pulse.n_coeffs, pulse.dt
    c_coeffs = np.delete(pulse.c_coeffs, equal, axis=1)
    n_coeffs = np.delete(pulse.n_coeffs, equal, axis=1)
    dt = np.delete(pulse.dt, equal)
    for old, new in zip(equal, equal - np.arange(len(equal))):
        dt[new] += pulse.dt[old]
    return c_coeffs, n_coeffs, dt


class PulseSequence:
    r"""A control pulse defined by piecewise-constant control and noise
    Hamiltonians H_c = sum_i a_i(t) A_i, H_n = sum_a s_a(t) b_a(t) B_a
    (see pulse_sequence.py:61-240 for the full semantics).

    Parameters
    ----------
    H_c, H_n : nested lists ``[[oper, coeffs, identifier?], ...]``
    dt : segment durations, shape (n_dt,)
    basis : operator basis; defaults to the GGM basis of dimension d.
    """

    def __init__(self, H_c: Hamiltonian, H_n: Hamiltonian,
                 dt: Coefficients, basis: Optional[Basis] = None):
        if not util.is_sequence_like(dt):
            raise TypeError('Expected a sequence of time steps, not '
                            f'{type(dt)}')
        self.dt = np.asarray(dt)
        if not np.isreal(self.dt).all():
            raise ValueError('Times dt are not (all) real!')
        if (self.dt < 0).any():
            raise ValueError('Time steps are not (all) positive!')
        self.dt = self.dt.astype(float)

        self.c_opers, self.c_oper_identifiers, self.c_coeffs = \
            _parse_hamiltonian(H_c, len(self.dt), 'H_c')
        self.n_opers, self.n_oper_identifiers, self.n_coeffs = \
            _parse_hamiltonian(H_n, len(self.dt), 'H_n')

        if self.c_opers.shape[-2:] != self.n_opers.shape[-2:]:
            raise ValueError('Control and noise Hamiltonian not same '
                             'dimension!')
        self.d = self.c_opers.shape[-1]
        if basis is None:
            self.basis = Basis.ggm(self.d)
        else:
            if not isinstance(basis, Basis):
                raise ValueError("Expected basis to be an instance of the "
                                 "'filter_functions_tpu.basis.Basis' class, "
                                 f"not {type(basis)}!")
            if basis.shape[1:] != (self.d, self.d):
                raise ValueError('Expected basis elements to be of shape '
                                 f'({self.d}, {self.d}), not '
                                 f'{basis.shape[1:]}!')
            self.basis = basis
        self._init_caches()

    def _init_caches(self):
        self._data = {}
        self._frequency_data = {}
        self._intermediates = {}
        self._dev = {}

    @classmethod
    def from_arrays(cls, c_opers, c_oper_identifiers, c_coeffs,
                    n_opers, n_oper_identifiers, n_coeffs, dt,
                    basis: Optional[Basis] = None) -> 'PulseSequence':
        """Construct directly from arrays (pulse_sequence.py:312-357).
        No sorting is applied; arrays are taken as-is."""
        new = cls.__new__(cls)
        new.c_opers = np.asarray(c_opers, dtype=complex)
        new.c_oper_identifiers = np.asarray(c_oper_identifiers)
        new.c_coeffs = np.asarray(c_coeffs, dtype=float)
        new.n_opers = np.asarray(n_opers, dtype=complex)
        new.n_oper_identifiers = np.asarray(n_oper_identifiers)
        new.n_coeffs = np.asarray(n_coeffs, dtype=float)
        new.dt = np.asarray(dt, dtype=float)
        new.d = new.c_opers.shape[-1]
        new.basis = basis if basis is not None else Basis.ggm(new.d)
        if not (len(new.c_opers) == len(new.c_oper_identifiers)
                == len(new.c_coeffs)):
            raise ValueError('Control Hamiltonian not same length!')
        if not (len(new.n_opers) == len(new.n_oper_identifiers)
                == len(new.n_coeffs)):
            raise ValueError('Noise Hamiltonian not same length!')
        if len(set(new.c_opers.shape[1:] + new.n_opers.shape[1:])) != 1:
            raise ValueError('Control and/or noise Hamiltonian not same, '
                             'square dimension!')
        if not (new.dt.size == new.n_coeffs.shape[1]
                == new.c_coeffs.shape[1]):
            raise ValueError('Time steps not same length!')
        if new.basis.d != new.d:
            raise ValueError('Basis dimension not same as Hamiltonian '
                             'dimension!')
        new._init_caches()
        return new

    # -- device views of the static arrays -------------------------------------
    def _dev_arr(self, name: str):
        """Cached device conversion of a host master array."""
        if name not in self._dev:
            host = getattr(self, name)
            if np.iscomplexobj(host):
                self._dev[name] = asc(host)
            else:
                self._dev[name] = jnp.asarray(host)
        return self._dev[name]

    @property
    def c_opers_dev(self) -> C:
        return self._dev_arr('c_opers')

    @property
    def n_opers_dev(self) -> C:
        return self._dev_arr('n_opers')

    # -- dunder methods ---------------------------------------------------------
    def __str__(self):
        return (f'{repr(self)}\n\tof dimension {self.d} and duration '
                f'{self.duration}')

    def __len__(self) -> int:
        return len(self.dt)

    # Tell NumPy this is a scalar object: PulseSequence is iterable via
    # __getitem__, so np.asarray would otherwise unroll it into an array
    # of segment pulses (pulse_sequence.py:241-251 semantics).
    __array_interface__ = {'shape': (), 'typestr': '|O', 'version': 3}

    def __eq__(self, other) -> bool:
        """Physical equality (pulse_sequence.py:363-440): equal-segment
        joining, identifier-sorted comparison of all defining arrays."""
        if not isinstance(other, PulseSequence):
            return NotImplemented
        atol = np.finfo(complex).eps * self.basis.shape[0]
        ca, na, dta = _join_equal_segments(self)
        cb, nb, dtb = _join_equal_segments(other)
        if len(dta) != len(dtb) or not np.allclose(dta, dtb, 1e-10, atol):
            return False
        ia_c = np.argsort(self.c_oper_identifiers)
        ib_c = np.argsort(other.c_oper_identifiers)
        ia_n = np.argsort(self.n_oper_identifiers)
        ib_n = np.argsort(other.n_oper_identifiers)
        checks = (
            (self.c_opers[ia_c], other.c_opers[ib_c]),
            (self.n_opers[ia_n], other.n_opers[ib_n]),
            (self.c_oper_identifiers[ia_c], other.c_oper_identifiers[ib_c]),
            (self.n_oper_identifiers[ia_n], other.n_oper_identifiers[ib_n]),
            (ca[ia_c], cb[ib_c]),
            (na[ia_n], nb[ib_n]),
        )
        for a, b in checks:
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                return False
        return self.basis == other.basis

    def __getitem__(self, key) -> 'PulseSequence':
        """Segment slicing; prefix slices reuse cached cumulative
        intermediates (pulse_sequence.py:445-484)."""
        new_dt = np.atleast_1d(self.dt[key])
        if not new_dt.size:
            raise IndexError('Cannot create empty PulseSequence')
        new = PulseSequence.from_arrays(
            c_opers=self.c_opers,
            c_oper_identifiers=self.c_oper_identifiers,
            c_coeffs=np.atleast_2d(self.c_coeffs.T[key]).T,
            n_opers=self.n_opers,
            n_oper_identifiers=self.n_oper_identifiers,
            n_coeffs=np.atleast_2d(self.n_coeffs.T[key]).T,
            dt=new_dt,
            basis=self.basis,
        )
        is_prefix = (isinstance(key, slice) and key.start in (None, 0)
                     and key.step in (None, 1) and key.stop is not None
                     and key.stop > 0)
        if is_prefix:
            cum = self._intermediates.get('control_matrix_step_cumulative')
            if cum is not None and key.stop - 1 < len(cum):
                new.cache_control_matrix(self.omega, cum[key.stop - 1])
            ff2 = self._intermediates.get('filter_function_2_step_cumulative')
            if ff2 is not None and key.stop - 1 < len(ff2):
                new.cache_filter_function(self.omega, None,
                                          ff2[key.stop - 1], order=2)
        return new

    def __copy__(self) -> 'PulseSequence':
        cls = self.__class__
        new = cls.__new__(cls)
        new.__dict__.update(self.__dict__)
        new._data = _copy.copy(self._data)
        new._frequency_data = _copy.copy(self._frequency_data)
        new._intermediates = _copy.copy(self._intermediates)
        new._dev = _copy.copy(self._dev)
        return new

    def __matmul__(self, other: 'PulseSequence') -> 'PulseSequence':
        if not isinstance(other, PulseSequence):
            raise TypeError('Incompatible type for concatenation: '
                            f'{type(other)}')
        from .sequencing import concatenate
        return concatenate((self, other))

    def __imatmul__(self, other):
        raise NotImplementedError

    # -- cache bookkeeping --------------------------------------------------------
    _DATA_ALIASES = {
        'eigenvalues': 'eigvals',
        'eigenvectors': 'eigvecs',
        'propagators': 'propagators',
        'total propagator': 'total_propagator',
        'total propagator liouville': 'total_propagator_liouville',
    }
    _FREQ_ALIASES = {
        'frequencies': 'omega',
        'total phases': 'total_phases',
        'filter function': 'filter_function',
        'fidelity filter function': 'filter_function',
        'generalized filter function': 'filter_function_gen',
        'pulse correlation filter function': 'filter_function_pc',
        'fidelity pulse correlation filter function': 'filter_function_pc',
        'generalized pulse correlation filter function':
            'filter_function_pc_gen',
        'second order filter function': 'filter_function_2',
        'control matrix': 'control_matrix',
        'pulse correlation control matrix': 'control_matrix_pc',
    }

    # alias -> (storage dict attribute, resolved key); precomputed once
    # at class creation so is_cached is two dict lookups, not string
    # munging -- concatenation scans it once per pulse per attribute
    _ALIAS_LOOKUP: Dict[str, Tuple[str, str]] = {}

    def is_cached(self, attr: str) -> bool:
        """Human-friendly cache query (pulse_sequence.py:508-538)."""
        hit = self._ALIAS_LOOKUP.get(attr)
        if hit is None:
            alias = attr.lower().replace('_', ' ')
            if alias in self._DATA_ALIASES:
                hit = ('_data', self._DATA_ALIASES[alias])
            elif alias in self._FREQ_ALIASES:
                hit = ('_frequency_data', self._FREQ_ALIASES[alias])
            else:
                return (attr in self._intermediates
                        or attr in self._frequency_data
                        or attr in self._data)
            self._ALIAS_LOOKUP[attr] = hit
        return hit[1] in getattr(self, hit[0])

    @property
    def data(self):
        return MappingProxyType(self._data)

    @property
    def frequency_data(self):
        return MappingProxyType(self._frequency_data)

    @property
    def intermediates(self):
        return MappingProxyType(self._intermediates)

    @property
    def nbytes(self) -> int:
        """Estimated cache memory footprint
        (pulse_sequence.py:1171-1186)."""
        total = 0
        for val in (*self._data.values(), *self._frequency_data.values(),
                    *self._intermediates.values()):
            if isinstance(val, C):
                total += val.re.nbytes + val.im.nbytes
            elif hasattr(val, 'nbytes'):
                total += val.nbytes
        return total

    @util.parse_optional_parameters(
        method=('conservative', 'greedy', 'frequency dependent', 'all'))
    def cleanup(self, method: str = 'conservative') -> None:
        """Cache eviction tiers (pulse_sequence.py:1188-1245)."""
        if method == 'all':
            self._data.clear()
            self._frequency_data.clear()
            self._intermediates.clear()
        elif method == 'frequency dependent':
            self._frequency_data.clear()
            self._intermediates.clear()
        elif method == 'greedy':
            self._intermediates.clear()
            for key in ('eigvals', 'eigvecs', 'propagators',
                        'total_propagator', 'total_propagator_liouville'):
                self._data.pop(key, None)
            for key in ('total_phases', 'control_matrix',
                        'control_matrix_pc'):
                self._frequency_data.pop(key, None)
        else:
            for key in ('eigvals', 'eigvecs', 'propagators'):
                self._data.pop(key, None)

    # -- time attributes -------------------------------------------------------
    @property
    def t(self) -> np.ndarray:
        # explicit check: dict.setdefault would evaluate (and pay for)
        # the cumsum on every access, cached or not
        if 't' not in self._data:
            self._data['t'] = np.concatenate(([0], self.dt.cumsum()))
        return self._data['t']

    @t.setter
    def t(self, val):
        self._data['t'] = np.asarray(val)

    @property
    def tau(self) -> float:
        if 'tau' not in self._data:
            self._data['tau'] = (float(self.t[-1]) if 't' in self._data
                                 else float(self.dt.sum()))
        return self._data['tau']

    @tau.setter
    def tau(self, val):
        self._data['tau'] = float(val)

    @property
    def duration(self) -> float:
        return self.tau

    # -- diagonalization --------------------------------------------------------
    def diagonalize(self) -> None:
        """Eigendecompose all segments and accumulate propagators
        (pulse_sequence.py:577-586)."""
        if not all(self.is_cached(a) for a in ('eigvals', 'eigvecs',
                                               'propagators')):
            (self.eigvals, self.eigvecs, self.propagators,
             self.total_propagator) = numeric.assemble_and_diagonalize(
                self.c_opers_dev, self.c_coeffs, self.dt)
        elif not self.is_cached('total_propagator'):
            self.total_propagator = self.propagators[-1]

    @property
    def eigvals(self):
        if not self.is_cached('eigvals'):
            self.diagonalize()
        return self._data['eigvals']

    @eigvals.setter
    def eigvals(self, value):
        self._data['eigvals'] = value

    @property
    def eigvecs(self):
        if not self.is_cached('eigvecs'):
            self.diagonalize()
        return self._data['eigvecs']

    @eigvecs.setter
    def eigvecs(self, value):
        self._data['eigvecs'] = value

    @property
    def propagators(self):
        if not self.is_cached('propagators'):
            self.diagonalize()
        return self._data['propagators']

    @propagators.setter
    def propagators(self, value):
        self._data['propagators'] = value

    @property
    def total_propagator(self):
        if not self.is_cached('total_propagator'):
            self.diagonalize()
        return self._data['total_propagator']

    @total_propagator.setter
    def total_propagator(self, value):
        self._data['total_propagator'] = value

    @property
    def total_propagator_liouville(self):
        if not self.is_cached('total_propagator_liouville'):
            self._data['total_propagator_liouville'] = \
                liouville_representation(self.total_propagator, self.basis)
        return self._data['total_propagator_liouville']

    @total_propagator_liouville.setter
    def total_propagator_liouville(self, value):
        self._data['total_propagator_liouville'] = value

    # -- frequency bookkeeping ----------------------------------------------------
    @property
    def omega(self):
        return self._frequency_data.get('omega', None)

    @omega.setter
    def omega(self, value):
        """Invalidates all frequency-dependent caches when the grid
        changes (pulse_sequence.py:1158-1169)."""
        old = self._frequency_data.get('omega', None)
        new = np.array(value, copy=True)
        if not np.array_equal(old, new):
            self.cleanup('frequency dependent')
        self._frequency_data['omega'] = new

    def get_total_phases(self, omega) -> C:
        """e^{i omega tau} (pulse_sequence.py:1056-1084)."""
        self.omega = omega
        if self.is_cached('total_phases'):
            return self._frequency_data['total_phases']
        self.cache_total_phases(
            self.omega, _total_phases_jit(jnp.asarray(self.omega),
                                          self.tau))
        return self._frequency_data['total_phases']

    def cache_total_phases(self, omega, total_phases=None) -> None:
        self.omega = omega
        if total_phases is None:
            total_phases = self.get_total_phases(self.omega)
        self._frequency_data['total_phases'] = total_phases

    # -- control matrix -----------------------------------------------------------
    def get_control_matrix(self, omega, show_progressbar: bool = False,
                           cache_intermediates: bool = False) -> C:
        """Cache-aware control matrix (pulse_sequence.py:588-636)."""
        self.omega = omega
        if self.is_cached('control_matrix'):
            return self._frequency_data['control_matrix']
        if self.is_cached('control_matrix_pc'):
            self._frequency_data['control_matrix'] = \
                self._frequency_data['control_matrix_pc'].sum(axis=0)
            return self._frequency_data['control_matrix']

        self.diagonalize()
        result = numeric.calculate_control_matrix_from_scratch(
            self.eigvals, self.eigvecs, self.propagators,
            jnp.asarray(self.omega), self.basis, self.n_opers_dev,
            self.n_coeffs, self.dt, t=jnp.asarray(self.t),
            show_progressbar=show_progressbar,
            cache_intermediates=cache_intermediates)
        if cache_intermediates:
            control_matrix, intermediates = result
            self._intermediates.update(intermediates)
        else:
            control_matrix = result
        self.cache_control_matrix(self.omega, control_matrix)
        return self._frequency_data['control_matrix']

    def cache_control_matrix(self, omega, control_matrix=None,
                             show_progressbar: bool = False,
                             cache_intermediates: bool = False) -> None:
        """Cache control matrix plus concatenation byproducts
        (pulse_sequence.py:638-677)."""
        self.omega = omega
        if control_matrix is None:
            control_matrix = self.get_control_matrix(
                self.omega, show_progressbar, cache_intermediates)
        if control_matrix.ndim == 4:
            self._frequency_data['control_matrix_pc'] = control_matrix
        else:
            self._frequency_data['control_matrix'] = control_matrix
        self.cache_total_phases(self.omega)
        if not self.is_cached('total_propagator_liouville'):
            self.total_propagator_liouville = liouville_representation(
                self.total_propagator, self.basis)

    def get_pulse_correlation_control_matrix(self) -> C:
        if self.is_cached('control_matrix_pc'):
            return self._frequency_data['control_matrix_pc']
        raise util.CalculationError(
            "Could not get the pulse correlation control matrix since it "
            "was not computed during concatenation. Please run the "
            "concatenation again with 'calc_pulse_correlation_FF' set to "
            "True.")

    # -- filter functions ----------------------------------------------------------
    @util.parse_optional_parameters(which=('fidelity', 'generalized'),
                                    order=(1, 2))
    def get_filter_function(self, omega, which: str = 'fidelity',
                            order: int = 1,
                            show_progressbar: bool = False,
                            cache_intermediates: bool = False,
                            cache_second_order_cumulative: bool = False):
        """First/second order filter function, cached
        (pulse_sequence.py:691-805)."""
        self.omega = omega
        if order == 1:
            key = ('filter_function' if which == 'fidelity'
                   else 'filter_function_gen')
        else:
            key = 'filter_function_2'
        if self.is_cached(key):
            return self._frequency_data[key]

        control_matrix = None
        if order == 1:
            control_matrix = self.get_control_matrix(
                self.omega, show_progressbar, cache_intermediates)
        self.cache_filter_function(
            self.omega, control_matrix=control_matrix, which=which,
            order=order, show_progressbar=show_progressbar,
            cache_intermediates=cache_intermediates,
            cache_second_order_cumulative=cache_second_order_cumulative)
        return self._frequency_data[key]

    @util.parse_optional_parameters(which=('fidelity', 'generalized'),
                                    order=(1, 2))
    def cache_filter_function(self, omega, control_matrix=None,
                              filter_function=None, which: str = 'fidelity',
                              order: int = 1,
                              show_progressbar: bool = False,
                              cache_intermediates: bool = False,
                              cache_second_order_cumulative: bool = False
                              ) -> None:
        """Cache the filter function; a 4-d control matrix triggers the
        pulse-correlation path (pulse_sequence.py:807-902)."""
        self.omega = omega
        if filter_function is None:
            if order == 1:
                if control_matrix is None:
                    control_matrix = self.get_control_matrix(
                        self.omega, show_progressbar, cache_intermediates)
                self.cache_control_matrix(self.omega, control_matrix)
                if control_matrix.ndim == 4:
                    f_pc = numeric.\
                        calculate_pulse_correlation_filter_function(
                            control_matrix, which)
                    if which == 'fidelity':
                        self._frequency_data['filter_function_pc'] = f_pc
                    else:
                        self._frequency_data['filter_function_pc'] = \
                            _trace_pc_basis_axes(f_pc)
                        self._frequency_data['filter_function_pc_gen'] = f_pc
                    filter_function = _sum_pulse_axes(f_pc)
                else:
                    filter_function = numeric.calculate_filter_function(
                        control_matrix, which)
            else:
                self.diagonalize()
                result = numeric.\
                    calculate_second_order_filter_function_from_scratch(
                        self.eigvals, self.eigvecs, self.propagators,
                        jnp.asarray(self.omega), self.basis,
                        self.n_opers_dev, self.n_coeffs, self.dt,
                        intermediates=dict(self._intermediates),
                        show_progressbar=show_progressbar,
                        cache_intermediates=cache_intermediates,
                        cache_cumulative=cache_second_order_cumulative)
                if cache_intermediates:
                    filter_function, intermediates = result
                    self._intermediates.update(intermediates)
                else:
                    filter_function = result

        if order == 1:
            if which == 'fidelity':
                self._frequency_data['filter_function'] = filter_function
            else:
                self._frequency_data['filter_function'] = \
                    _trace_basis_axes(filter_function)
                self._frequency_data['filter_function_gen'] = filter_function
        else:
            self._frequency_data['filter_function_2'] = filter_function

    @util.parse_optional_parameters(which=('fidelity', 'generalized'))
    def get_pulse_correlation_filter_function(self,
                                              which: str = 'fidelity') -> C:
        """Pulse-correlation FF; only available post-concatenation
        (pulse_sequence.py:904-975)."""
        key = ('filter_function_pc' if which == 'fidelity'
               else 'filter_function_pc_gen')
        if self.is_cached(key):
            return self._frequency_data[key]
        if self.is_cached('control_matrix_pc'):
            f_pc = numeric.calculate_pulse_correlation_filter_function(
                self._frequency_data['control_matrix_pc'], which=which)
            self._frequency_data[key] = f_pc
            return f_pc
        raise util.CalculationError(
            "Could not get the pulse correlation filter function since it "
            "was not computed during concatenation. Please run the "
            "concatenation again with 'calc_pulse_correlation_FF' set to "
            "True.")

    def get_filter_function_derivative(
            self, omega, control_identifiers=None, n_oper_identifiers=None,
            n_coeffs_deriv=None) -> jnp.ndarray:
        """Analytic filter-function derivative
        (pulse_sequence.py:977-1054)."""
        from . import gradient
        c_idx = util.get_indices_from_identifiers(self.c_oper_identifiers,
                                                  control_identifiers)
        n_idx = util.get_indices_from_identifiers(self.n_oper_identifiers,
                                                  n_oper_identifiers)
        if n_coeffs_deriv is not None:
            required = (len(n_idx), len(c_idx), len(self))
            actual = np.shape(n_coeffs_deriv)
            if actual != required:
                raise ValueError('Expected n_coeffs_deriv to be of shape '
                                 f'{required}, not {actual}. Did you forget '
                                 'to specify identifiers?')
        self.omega = omega
        intermediates = {}
        n_t = self._intermediates.get('n_opers_transformed')
        if n_t is not None:
            intermediates['n_opers_transformed'] = n_t[jnp.asarray(n_idx)]
        integral = self._intermediates.get('first_order_integral')
        if integral is not None:
            intermediates['first_order_integral'] = integral

        control_matrix = self.get_control_matrix(
            self.omega, cache_intermediates=True)[jnp.asarray(n_idx)]
        control_matrix_deriv = \
            gradient.calculate_derivative_of_control_matrix_from_scratch(
                jnp.asarray(self.omega), self.propagators, self.eigvals,
                self.eigvecs, self.basis, jnp.asarray(self.t), self.dt,
                self.n_opers_dev[jnp.asarray(n_idx)], self.n_coeffs[n_idx],
                self.c_opers_dev[jnp.asarray(c_idx)], n_coeffs_deriv,
                intermediates)
        return gradient.calculate_filter_function_derivative(
            control_matrix, control_matrix_deriv)

    def propagator_at_arb_t(self, t) -> C:
        """Q(t) at arbitrary times via piecewise-constant exactness
        (pulse_sequence.py:1247-1267)."""
        self.diagonalize()
        t = np.asarray(t)
        idx = np.searchsorted(self.t, t) - 1
        idx = np.clip(idx, 0, len(self.dt) - 1)
        return _propagator_at_t_jit(self.propagators, self.eigvals,
                                    self.eigvecs, jnp.asarray(idx),
                                    jnp.asarray(self.t[idx]),
                                    jnp.asarray(t))


# Re-exported sequencing API (defined in .sequencing to keep modules
# focused; import at end avoids a circular import).
from .sequencing import (concatenate, concatenate_periodic,  # noqa: E402
                         concatenate_without_filter_function, extend, remap)
