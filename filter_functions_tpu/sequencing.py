"""Pulse composition: concatenation in time, periodic repetition, and
extension to larger registers (JAX rebuild of the sequencing
half of /root/reference/filter_functions/pulse_sequence.py:1340-2613).

The identifier/hash bookkeeping is pure host-side string/index logic
(it decides *which* cached device arrays are reused); the array math
(phase cumprods, Liouville products, atomic control-matrix sums,
closed-form periodic series) runs on device through the kernels in
:mod:`.numeric`.
"""
from __future__ import annotations

import bisect
import copy as _copy
import functools
from itertools import accumulate
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, \
    Tuple, Union
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from . import numeric, util
from .basis import (Basis, equivalent_pauli_basis_elements,
                    remap_pauli_basis_elements)
from .cplx import C, asc, cexp, matrix_power
from .pulse_sequence import PulseSequence, _parse_hamiltonian
from .superoperator import liouville_representation
from .types import Coefficients, Hamiltonian, PulseMapping

__all__ = ['concatenate', 'concatenate_periodic', 'extend', 'remap',
           'concatenate_without_filter_function']

#: Diagnostic counters for the len > 64 fast paths (tests assert the
#: branches are actually entered at scale; no runtime semantics).
from collections import Counter as _Counter
_fastpath_hits = _Counter()

#: Escape hatch for the single-dispatch cached-train concatenation
#: program (tests A/B it against the eager multi-op formulation).
_ENABLE_TRAIN_FUSED = True


# -----------------------------------------------------------------------------
# Hamiltonian union (host-side metadata algebra)
# -----------------------------------------------------------------------------
def _concatenate_hamiltonian(opers, identifiers, coeffs, kind: str):
    """Union the operators of several pulses by array-hash, resolve
    identifier clashes, and lay coefficients into the concatenated
    segment grid (pulse_sequence.py:1340-1483).

    Same oper + different identifiers -> error; same identifier +
    different opers -> suffix ``_p`` with the pulse position; missing
    noise sensitivities are inferred when constant, else an error.
    """
    if len(opers) > 1:
        key0 = (id(opers[0]), id(identifiers[0]))
        if all(id(o) == key0[0] and id(i) == key0[1]
               for o, i in zip(opers, identifiers)):
            # Uniform train of one repeated pulse object (periodic
            # trains, concatenate([p] * G)): no union/clash work at
            # all -- operators and identifiers pass through, and the
            # coefficient grid is a single tile/concatenate.  Rows are
            # already identifier-sorted (PulseSequence invariant).
            idents = [str(s) for s in identifiers[0]]
            c0 = id(coeffs[0])
            if all(id(c) == c0 for c in coeffs):
                concat_coeffs = np.tile(np.asarray(coeffs[0]),
                                        (1, len(coeffs)))
            else:
                concat_coeffs = np.concatenate(
                    [np.asarray(c) for c in coeffs], axis=1)
            shared = {i: i for i in idents}
            mapping = {p: shared for p in range(len(opers))}
            return (np.asarray(opers[0]), np.array(idents),
                    concat_coeffs, mapping)

    if len(opers) > 64:
        # Few-distinct fast path (random/Clifford trains of cached
        # pulses): run the union/clash machinery on the DISTINCT
        # (opers, identifiers, coeffs) triples only and expand the
        # coefficient grid by one vectorized gather -- the general
        # path below walks O(G) Python per pulse, which dominates a
        # 1e4-pulse concatenation.  Distinct pulses may have different
        # segment counts (Clifford trains mix 1-3-segment members);
        # the gather then assembles variable-width column blocks.
        # Falls through whenever an identifier rename fires (its
        # position-suffix semantics depend on the full train).
        keyed: Dict[tuple, int] = {}
        didx = np.empty(len(opers), np.int32)
        d_op, d_id, d_co = [], [], []
        for g in range(len(opers)):
            key = (id(opers[g]), id(identifiers[g]), id(coeffs[g]))
            j = keyed.get(key)
            if j is None:
                j = keyed[key] = len(d_op)
                d_op.append(opers[g])
                d_id.append(identifiers[g])
                d_co.append(coeffs[g])
            didx[g] = j
        n_k = len(d_op)
        if n_k <= len(opers) // 4:
            c_opers, c_idents, c_coeffs_d, map_d = \
                _concatenate_hamiltonian(d_op, d_id, d_co, kind)
            no_renames = all(k == v for m in map_d.values()
                             for k, v in m.items())
            if no_renames:
                _fastpath_hits['few_distinct'] += 1
                n_rows = len(c_idents)
                row_of = {ident: r for r, ident in enumerate(c_idents)}
                widths = np.array([np.asarray(c).shape[1] for c in d_co])
                # per-distinct coefficient tiles in the merged row
                # order (NaN where a pulse lacks the operator),
                # concatenated along columns at offsets off[k]
                cat = np.full((n_rows, int(widths.sum())), np.nan)
                off = np.concatenate([[0], np.cumsum(widths)[:-1]])
                for k in range(n_k):
                    rows = [row_of[map_d[k][str(i)]] for i in d_id[k]]
                    cat[rows, off[k]:off[k] + widths[k]] = \
                        np.asarray(d_co[k])
                if kind == 'noise':
                    nan_mask = np.isnan(cat)
                    for row in np.nonzero(nan_mask.any(1))[0]:
                        known = cat[row][~nan_mask[row]]
                        if (known == known[0]).all():
                            cat[row, nan_mask[row]] = known[0]
                        else:
                            raise ValueError(
                                'Not all pulses have the same noise '
                                'operators and non-trivial noise '
                                'sensitivities so I cannot infer them.')
                else:
                    cat[np.isnan(cat)] = 0
                # one gather expands the train: column j of position g
                # reads cat[:, off[didx[g]] + j]
                w_train = widths[didx]
                starts = np.repeat(off[didx], w_train)
                seg0 = np.concatenate([[0], np.cumsum(w_train)[:-1]])
                within = np.arange(int(w_train.sum())) \
                    - np.repeat(seg0, w_train)
                concat_coeffs = cat[:, starts + within]
                mapping = {p: map_d[int(didx[p])]
                           for p in range(len(opers))}
                return c_opers, c_idents, concat_coeffs, mapping

    n_dt_per_pulse = [c.shape[1] for c in coeffs]
    seg_bounds = [0] + list(accumulate(n_dt_per_pulse))
    n_ops_per_pulse = [len(op) for op in opers]
    pulse_bounds = list(accumulate(n_ops_per_pulse))

    # hash each distinct operator-array object once: long trains built
    # from repeated pulse objects hand us the same array G times
    hash_memo: Dict[int, List[int]] = {}
    per_pulse_hashes = []
    for op in opers:
        h = hash_memo.get(id(op))
        if h is None:
            h = util.hash_array_along_axis(op, axis=0)
            hash_memo[id(op)] = h
        per_pulse_hashes.append(h)
    oper_hashes = [h for hs in per_pulse_hashes for h in hs]
    uniq_hashes, first_idx, inverse = np.unique(
        oper_hashes, return_index=True, return_inverse=True)
    uniq_hashes = uniq_hashes.tolist()
    pulse_starts = [0] + pulse_bounds

    def _ident_at(flat):
        # identifier at a flat operator index, without materializing
        # the O(G)-element concatenation of all identifier arrays
        p = bisect.bisect(pulse_bounds, int(flat))
        return str(identifiers[p][int(flat) - pulse_starts[p]])

    uniq_identifiers = [_ident_at(fp) for fp in first_idx]
    # gather only the unique operators instead of concatenating all
    first_pulse = [bisect.bisect(pulse_bounds, int(fp)) for fp in first_idx]
    uniq_opers = np.array(
        [np.asarray(opers[p])[int(fp) - pulse_starts[p]]
         for p, fp in zip(first_pulse, first_idx)])

    # hash tables in both directions to detect clashes (deduped by
    # object identity of the per-pulse arrays: repeated pulse objects
    # contribute identical pairs)
    oper_to_ids: Dict[int, set] = {}
    id_to_opers: Dict[str, set] = {}
    seen_pairs: set = set()
    for p, (op, idents) in enumerate(zip(opers, identifiers)):
        key = (id(op), id(idents))
        if key in seen_pairs:
            continue
        seen_pairs.add(key)
        for h, ident in zip(per_pulse_hashes[p], idents):
            oper_to_ids.setdefault(h, set()).add(ident)
            id_to_opers.setdefault(ident, set()).add(h)

    if any(len(ids) > 1 for ids in oper_to_ids.values()):
        raise ValueError(f'Trying to concatenate pulses with equal {kind} '
                         'operators but different identifiers. Please '
                         f'choose unique {kind} identifiers!')

    # identifier -> identifier maps, aliased per distinct
    # (operator-array, identifier-array) object pair: a train of
    # repeated pulse objects gets ONE shared dict instead of G of them
    # (iterating a numpy str array per pulse dominates long concats).
    # Aliasing is safe: the clash renames below update every pulse
    # carrying the same (identifier, operator) pair identically.
    shared_maps: Dict[tuple, dict] = {}
    mapping = {}
    for p in range(len(opers)):
        key = (id(opers[p]), id(identifiers[p]))
        m = shared_maps.get(key)
        if m is None:
            m = {str(ident): str(ident) for ident in identifiers[p]}
            shared_maps[key] = m
        mapping[p] = m
    hashes_arr = np.asarray(oper_hashes)
    for ident, hashes in id_to_opers.items():
        if len(hashes) > 1:
            # identifier used for different operators: disambiguate by
            # the position of the first pulse carrying each operator
            for h in hashes:
                flat_pos = oper_hashes.index(h)
                pulse_pos = bisect.bisect(pulse_bounds, flat_pos)
                uniq_pos = uniq_hashes.index(h)
                new_ident = f'{uniq_identifiers[uniq_pos]}_{pulse_pos}'
                uniq_identifiers[uniq_pos] = new_ident
                # update the mapping of EVERY pulse carrying this
                # (identifier, operator) pair, not just the first one
                # (the reference updates only the first,
                # pulse_sequence.py:1440-1443, which leaves stale
                # mappings when 3+ pulses are involved)
                for fp in (hashes_arr == h).nonzero()[0]:
                    if _ident_at(fp) == ident:
                        p = bisect.bisect(pulse_bounds, int(fp))
                        mapping[p][ident] = new_ident

    sort_idx = np.argsort(uniq_identifiers)
    concat_opers = uniq_opers[sort_idx]
    concat_identifiers = np.array([uniq_identifiers[i] for i in sort_idx])

    n_dt_total = seg_bounds[-1]
    concat_coeffs = np.full((len(uniq_identifiers), n_dt_total), np.nan)
    n_ops_uniform = len(set(n_ops_per_pulse)) == 1
    if n_ops_uniform:
        inverse2 = inverse.reshape(len(opers), n_ops_per_pulse[0])
    if n_ops_uniform and (inverse2 == inverse2[0]).all():
        # every pulse maps its rows identically (the long-train common
        # case): ONE block write instead of a per-pulse Python loop
        concat_coeffs[inverse2[0]] = np.concatenate(coeffs, axis=1)
    else:
        # one vectorized block write per pulse (per-member bisect loops
        # are O(G * n_ops) Python for long trains)
        start = 0
        for p, pulse_coeffs in enumerate(coeffs):
            rows = inverse[start:start + n_ops_per_pulse[p]]
            concat_coeffs[rows,
                          seg_bounds[p]:seg_bounds[p + 1]] = pulse_coeffs
            start += n_ops_per_pulse[p]

    if kind == 'noise':
        nan_mask = np.isnan(concat_coeffs)
        for row in nan_mask.any(axis=1).nonzero()[0]:
            known = concat_coeffs[row][~nan_mask[row]]
            if (known == known[0]).all():
                concat_coeffs[row, nan_mask[row]] = known[0]
            else:
                raise ValueError(
                    'Not all pulses have the same noise operators and '
                    'non-trivial noise sensitivities so I cannot infer '
                    'them.')
    else:
        concat_coeffs[np.isnan(concat_coeffs)] = 0

    return concat_opers, concat_identifiers, concat_coeffs[sort_idx], mapping


def concatenate_without_filter_function(
        pulses: Iterable[PulseSequence],
        return_identifier_mappings: bool = False):
    """Concatenate pulses, merging Hamiltonians but skipping all filter-
    function work (pulse_sequence.py:1599-1665)."""
    try:
        pulses = tuple(pulses)
    except TypeError:
        raise TypeError(f'Expected pulses to be iterable, not '
                        f'{type(pulses)}')
    if len(pulses) > 1 and len(set(map(id, pulses))) == 1:
        # uniform train: skip the O(G) union/validation machinery
        newpulse = _uniform_newpulse(pulses[0], len(pulses))
        if return_identifier_mappings:
            shared_c = {str(i): str(i)
                        for i in pulses[0].c_oper_identifiers}
            shared_n = {str(i): str(i)
                        for i in pulses[0].n_oper_identifiers}
            return (newpulse,
                    {p: shared_c for p in range(len(pulses))},
                    {p: shared_n for p in range(len(pulses))})
        return newpulse
    # validate once per distinct object (trains repeat pulse objects)
    uniq = {id(p): p for p in pulses}.values()
    if not all(isinstance(p, PulseSequence) for p in uniq):
        raise TypeError('Can only concatenate PulseSequences!')
    if len({p.d for p in uniq}) != 1:
        raise ValueError('Trying to concatenate PulseSequence instances '
                         'with different dimension!')
    if not util.all_array_equal((p.basis.np for p in uniq)):
        raise ValueError('Trying to concatenate PulseSequence instances '
                         'with different bases!')

    control = _concatenate_hamiltonian(
        [p.c_opers for p in pulses], [p.c_oper_identifiers for p in pulses],
        [p.c_coeffs for p in pulses], kind='control')
    noise = _concatenate_hamiltonian(
        [p.n_opers for p in pulses], [p.n_oper_identifiers for p in pulses],
        [p.n_coeffs for p in pulses], kind='noise')
    dt = np.concatenate([p.dt for p in pulses])

    newpulse = PulseSequence.from_arrays(*control[:3], *noise[:3], dt,
                                         pulses[0].basis)
    tau_by_id = {id(p): p.tau for p in uniq}
    newpulse.tau = sum(tau_by_id[id(p)] for p in pulses)
    if return_identifier_mappings:
        return newpulse, control[3], noise[3]
    return newpulse


# -----------------------------------------------------------------------------
# Full concatenation with filter-function reuse
# -----------------------------------------------------------------------------
def _uniform_newpulse(pulse0: PulseSequence, repeats: int) -> PulseSequence:
    """Closed-form Hamiltonian union for ``concatenate([p] * G)``:
    operators and identifiers pass through, coefficients and dt tile."""
    if not isinstance(pulse0, PulseSequence):
        raise TypeError('Can only concatenate PulseSequences!')
    newpulse = PulseSequence.from_arrays(
        c_opers=pulse0.c_opers,
        c_oper_identifiers=pulse0.c_oper_identifiers,
        c_coeffs=np.tile(np.asarray(pulse0.c_coeffs), (1, repeats)),
        n_opers=pulse0.n_opers,
        n_oper_identifiers=pulse0.n_oper_identifiers,
        n_coeffs=np.tile(np.asarray(pulse0.n_coeffs), (1, repeats)),
        dt=np.tile(np.asarray(pulse0.dt), repeats),
        basis=pulse0.basis)
    newpulse.tau = repeats * pulse0.tau
    return newpulse


def _concatenate_uniform(pulse0: PulseSequence, repeats: int,
                         calc_filter_function: Optional[bool],
                         which: str, omega, show_progressbar: bool
                         ) -> PulseSequence:
    """Uniform-train concatenation without O(G) host work.

    Semantically identical to routing ``[pulse0] * repeats`` through the
    general path (pulse_sequence.py:1668-1887): the boundary phases are
    z^g with z = e^{i w tau} and the cumulative Liouvilles are Q^g, so
    K5's sum is the geometric series K6 evaluates in closed form."""
    newpulse = _uniform_newpulse(pulse0, repeats)
    if pulse0.is_cached('total_propagator'):
        newpulse.total_propagator = matrix_power(
            asc(pulse0.total_propagator), repeats)
    if calc_filter_function is False:
        return newpulse
    if omega is None:
        cached_ctrl = pulse0.is_cached('control_matrix')
        if not (cached_ctrl or pulse0.is_cached('omega')):
            # mirrors the general path: no frequencies anywhere
            if calc_filter_function:
                raise ValueError('Calculation of filter function forced '
                                 'but not all pulses have the same '
                                 'frequencies cached and none were '
                                 'supplied!')
            return newpulse
        if calc_filter_function is None and not cached_ctrl:
            return newpulse
        omega = pulse0.omega

    ctrl0 = pulse0.get_control_matrix(omega, show_progressbar)
    if not newpulse.is_cached('total_propagator'):
        newpulse.total_propagator = matrix_power(
            asc(pulse0.total_propagator), repeats)
    newpulse.cache_total_phases(omega)
    newpulse.total_propagator_liouville = liouville_representation(
        newpulse.total_propagator, newpulse.basis)
    control_matrix = numeric.calculate_control_matrix_periodic(
        pulse0.get_total_phases(omega), ctrl0,
        asc(pulse0.total_propagator_liouville), repeats)
    newpulse.cache_filter_function(omega, control_matrix, which=which)
    return newpulse


@util.parse_optional_parameters(which=('fidelity', 'generalized'))
def concatenate(pulses: Iterable[PulseSequence],
                calc_pulse_correlation_FF: bool = False,
                calc_filter_function: Optional[bool] = None,
                calc_second_order_FF: Optional[bool] = None,
                which: str = 'fidelity',
                omega: Optional[Coefficients] = None,
                show_progressbar: bool = False) -> PulseSequence:
    r"""Concatenate pulses left-to-right (B o A for (A, B)), reusing
    cached atomic control matrices where possible -- the headline
    algorithmic feature of the reference (pulse_sequence.py:1668-1887).
    """
    pulses = tuple(pulses)
    if len(pulses) == 1:
        return _copy.copy(pulses[0])

    if (not calc_pulse_correlation_FF and not calc_second_order_FF
            and len(set(map(id, pulses))) == 1):
        # A train of ONE repeated pulse object ([p] * G): every
        # Hamiltonian union, identifier mapping, and cache-equality
        # question is answered by the single distinct pulse, so the
        # O(G) host bookkeeping of the general path is pure overhead.
        return _concatenate_uniform(pulses[0], len(pulses),
                                    calc_filter_function, which, omega,
                                    show_progressbar)

    newpulse, _, n_oper_mapping = concatenate_without_filter_function(
        pulses, return_identifier_mappings=True)

    # Long trains repeat pulse objects ([p] * G, Clifford sequences):
    # evaluate per-pulse properties once per DISTINCT object and fan
    # out by identity instead of O(G) attribute/cache lookups.  The
    # id list is walked several times -- compute it once.
    pulse_ids = [id(p) for p in pulses]
    uniq_pulses = dict(zip(pulse_ids, pulses))

    def per_pulse(fn):
        vals = {k: fn(p) for k, p in uniq_pulses.items()}
        return [vals[i] for i in pulse_ids]

    def set_total_propagator():
        # Deferred so the fused cached-train path can compute it
        # inside its single compiled program instead of paying the
        # eager stack+tree-product dispatches up front.
        if (not newpulse.is_cached('total_propagator')
                and all(p.is_cached('total_propagator')
                        for p in uniq_pulses.values())):
            newpulse.total_propagator = util.mdot(
                _stack_c(per_pulse(lambda p: p.total_propagator)[::-1]))

    if calc_pulse_correlation_FF or calc_second_order_FF is True:
        calc_filter_function = True
    if calc_filter_function is False:
        set_total_propagator()
        return newpulse

    # which noise opers are present in which pulse (post-remapping).
    # pulse_rows[i][j] is the row of the merged (identifier-sorted)
    # noise-operator set that row j of pulse i's control matrix (in the
    # pulse's own identifier-sorted order) maps to -- identifier-clash
    # renaming can permute the relative order, so cached rows must be
    # scattered by position, not by boolean mask.
    unique_identifiers = sorted({new for mapping in n_oper_mapping.values()
                                 for new in mapping.values()})
    row_of = {ident: k for k, ident in enumerate(unique_identifiers)}
    pulse_rows = []
    rows_memo: Dict[tuple, np.ndarray] = {}
    for i, pulse in enumerate(pulses):
        mapping = n_oper_mapping[i]
        # mapping dicts are aliased per distinct pulse object
        # (_concatenate_hamiltonian), so object identity is the key --
        # no per-pulse dict sort for long trains
        key = (id(pulse.n_oper_identifiers), id(mapping))
        rows = rows_memo.get(key)
        if rows is None:
            rows = np.array([row_of[mapping[old]]
                             for old in pulse.n_oper_identifiers])
            rows_memo[key] = rows
        pulse_rows.append(rows)
    n_opers_present = np.zeros((len(pulses), len(unique_identifiers)),
                               dtype=bool)
    for i, rows in enumerate(pulse_rows):
        n_opers_present[i, rows] = True

    if calc_second_order_FF and not n_opers_present.all():
        warn('Second order FF requested but not all pulses have the same '
             'n_opers. Not implemented.', UserWarning)
        calc_second_order_FF = False

    equal_n_opers = (n_opers_present.sum(axis=0) > 1).any()
    if omega is None:
        cached_ctrl_mat = per_pulse(
            lambda p: p.is_cached('control_matrix'))
        if any(cached_ctrl_mat):
            equal_omega = util.all_array_equal(
                (p.omega for p, c in zip(pulses, cached_ctrl_mat) if c))
        else:
            cached_omega = per_pulse(lambda p: p.is_cached('omega'))
            equal_omega = util.all_array_equal(
                (p.omega for p, c in zip(pulses, cached_omega) if c))
        if not equal_omega:
            if calc_filter_function:
                raise ValueError('Calculation of filter function forced '
                                 'but not all pulses have the same '
                                 'frequencies cached and none were '
                                 'supplied!')
            if calc_pulse_correlation_FF:
                raise ValueError('Cannot compute the pulse correlation '
                                 'filter functions; do not have the '
                                 'frequencies at which to evaluate.')
            set_total_propagator()
            return newpulse
        if calc_filter_function is None and (
                not equal_n_opers or not any(cached_ctrl_mat)):
            set_total_propagator()
            return newpulse
        if any(cached_ctrl_mat):
            ind = int(np.nonzero(cached_ctrl_mat)[0][0])
        else:
            ind = int(np.nonzero(cached_omega)[0][0])
        omega = pulses[ind].omega

    if not equal_n_opers:
        # No cache reuse possible: compute afresh on the merged pulse.
        set_total_propagator()
        newpulse.cache_filter_function(omega, which=which)
        return newpulse

    # 'correlations' keeps the per-pulse summands, needed both for the
    # pulse-correlation FF and the second-order concatenation rule.
    keep_steps = calc_pulse_correlation_FF or calc_second_order_FF

    if len(uniq_pulses) == 1 and not keep_steps:
        # A train of ONE repeated pulse object is exactly the periodic
        # case: boundary phases are z^g with z = e^{i w tau} and the
        # cumulative Liouvilles are Q^g, so K5's sum is the geometric
        # series K6 evaluates in closed form (2 log2 G matmuls) --
        # never materialize the (G-1, n_omega) phase grid or the
        # (G-1, d^2, d^2) propagator stack.
        pulse0 = pulses[0]
        ctrl0 = pulse0.get_control_matrix(omega, show_progressbar)
        if not newpulse.is_cached('total_propagator'):
            from .cplx import matrix_power
            newpulse.total_propagator = matrix_power(
                asc(pulse0.total_propagator), len(pulses))
        newpulse.cache_total_phases(omega)
        newpulse.total_propagator_liouville = liouville_representation(
            newpulse.total_propagator, newpulse.basis)
        control_matrix = numeric.calculate_control_matrix_periodic(
            pulse0.get_total_phases(omega), ctrl0,
            asc(pulse0.total_propagator_liouville), len(pulses))
        newpulse.cache_filter_function(omega, control_matrix,
                                       which=which)
        return newpulse

    # atomic control matrices, sorted into the new noise-operator order
    n_nops_new = len(newpulse.n_opers)
    n_w = len(np.asarray(omega))
    n_basis = len(newpulse.basis)
    seg_bounds = [0] + list(accumulate(len(p.dt) for p in pulses))
    # every pulse_rows entry is a rows_memo value, so the unique
    # candidates suffice (O(#distinct pulses), not O(G))
    _expected = np.arange(n_nops_new)
    identity_rows = all(np.array_equal(rows, _expected)
                        for rows in rows_memo.values())
    uniform_ctrl = None
    if identity_rows:
        # common fast path: stack cached device arrays directly.
        # Memoize by object identity: concatenate([p] * G) and long
        # Clifford trains repeat pulse objects, and even a cached
        # get_control_matrix pays an omega revalidation per call.
        by_id: Dict[int, C] = {}
        ctrls = []
        for pulse in pulses:
            ctrl = by_id.get(id(pulse))
            if ctrl is None:
                ctrl = pulse.get_control_matrix(omega, show_progressbar)
                by_id[id(pulse)] = ctrl
            ctrls.append(ctrl)
        if len(by_id) == 1 and not keep_steps:
            # identical atomic pulses, total only: the g-sum factorizes
            # -- never materialize the (G, n_nops, d**2, n_omega) stack
            uniform_ctrl = ctrls[0]
            control_matrix_atomic = None
        elif (_ENABLE_TRAIN_FUSED and not keep_steps
              and len(pulses) > 64
              and len(by_id) * 4 <= len(pulses)
              and newpulse.basis.isnorm and newpulse.basis.isherm
              and all(c.ndim == 3 for c in by_id.values())):
            # Heterogeneous cached train of FEW distinct pulses
            # (Clifford/RB sequences): run the entire device part as
            # one compiled program over per-distinct stacks (see
            # _concat_train_fused) -- the eager formulation pays one
            # dispatch per op, which dominates long-train wall time.
            _fastpath_hits['concat_train_fused'] += 1
            slot = {pid: k for k, pid in enumerate(by_id)}
            didx = np.fromiter((slot[pid] for pid in pulse_ids),
                               np.int32, len(pulse_ids))
            # per-distinct operands go in UNstacked -- the stacks form
            # inside the compiled program, so the caller dispatches
            # exactly one device call (each eager stack op costs one
            # more dispatch)
            ctrls_t = tuple(by_id.values())
            props_t = tuple(asc(uniq_pulses[pid].total_propagator)
                            for pid in by_id)
            tau_d = np.array([float(uniq_pulses[pid].tau)
                              for pid in by_id])
            (control_matrix, total_prop, total_liou, total_phases,
             filter_function) = _concat_train_fused(
                ctrls_t, props_t, jnp.asarray(tau_d), jnp.asarray(didx),
                jnp.asarray(omega), newpulse.basis.dev, which)
            if not newpulse.is_cached('total_propagator'):
                newpulse.total_propagator = total_prop
            newpulse.cache_total_phases(omega, total_phases)
            newpulse.total_propagator_liouville = total_liou
            newpulse.cache_control_matrix(omega, control_matrix)
            newpulse.cache_filter_function(
                omega, filter_function=filter_function, which=which)
            return newpulse
        else:
            control_matrix_atomic = _stack_c(ctrls)
    else:
        atomic_re = np.zeros((len(pulses), n_nops_new, n_basis, n_w))
        atomic_im = np.zeros_like(atomic_re)
        for i, (pulse, rows) in enumerate(zip(pulses, pulse_rows)):
            ctrl = pulse.get_control_matrix(omega, show_progressbar)
            atomic_re[i, rows] = np.asarray(ctrl.re)
            atomic_im[i, rows] = np.asarray(ctrl.im)
            missing = ~n_opers_present[i]
            if missing.any():
                extra = numeric.calculate_control_matrix_from_scratch(
                    pulse.eigvals, pulse.eigvecs, pulse.propagators,
                    jnp.asarray(omega), pulse.basis,
                    asc(newpulse.n_opers[missing]),
                    newpulse.n_coeffs[missing,
                                      seg_bounds[i]:seg_bounds[i + 1]],
                    pulse.dt, t=jnp.asarray(pulse.t),
                    show_progressbar=show_progressbar)
                atomic_re[i, missing] = np.asarray(extra.re)
                atomic_im[i, missing] = np.asarray(extra.im)
        control_matrix_atomic = C(jnp.asarray(atomic_re),
                                  jnp.asarray(atomic_im))

    # cumulative phase factors e^{i w t_{g-1}} of pulse boundaries.
    # Each pulse's total phase is e^{i w tau} (pulse_sequence.py:1056),
    # so the cumulative product has the closed form e^{i w cumsum(tau)}
    # -- one cexp, no per-pulse dispatch and no cumprod scan (and less
    # rounding than the product for long trains).  Computed AFTER the
    # fused-train branch above: that path derives the phases and the
    # cumulative Liouville product inside its single compiled program,
    # and the ~6 eager dispatches per distinct pulse the lazy
    # total_propagator_liouville properties cost here would dominate
    # its wall time.
    t_bound = np.cumsum(per_pulse(lambda p: p.tau)[:-1])
    phases = _boundary_phases(jnp.asarray(omega),
                              jnp.asarray(t_bound))     # (G-1, n_omega) C

    # Liouville transfer matrices of the cumulative boundary propagators
    props_liouville = per_pulse(
        lambda p: p.total_propagator_liouville)[:-1]
    if any(isinstance(pl, C) for pl in props_liouville):
        propagators_liouville = util.adot(_stack_c(props_liouville))
    else:
        if len(props_liouville) > 1 and all(
                pl is props_liouville[0] for pl in props_liouville):
            # concatenate([p] * G): broadcast instead of a G-ary stack
            # (one eager op per pulse otherwise)
            first = jnp.asarray(props_liouville[0])
            stacked = jnp.broadcast_to(
                first, (len(props_liouville),) + first.shape)
        else:
            stacked = _stack_real(props_liouville)
        propagators_liouville = util.adot(stacked)

    if not newpulse.is_cached('total_propagator'):
        newpulse.total_propagator = util.mdot(
            _stack_c([p.total_propagator for p in pulses][::-1]))
    newpulse.cache_total_phases(omega)
    newpulse.total_propagator_liouville = liouville_representation(
        newpulse.total_propagator, newpulse.basis)

    if uniform_ctrl is not None:
        control_matrix = numeric.calculate_control_matrix_from_atomic_uniform(
            phases, uniform_ctrl, propagators_liouville)
    else:
        control_matrix = numeric.calculate_control_matrix_from_atomic(
            phases, control_matrix_atomic, propagators_liouville,
            show_progressbar,
            which='correlations' if keep_steps else 'total')

    if calc_second_order_FF:
        ctrl_step = control_matrix
        ctrl_cumulative = ctrl_step.cumsum(axis=0)
        if not calc_pulse_correlation_FF:
            control_matrix = ctrl_cumulative[-1]
        ff2 = numeric.calculate_second_order_filter_function_from_atomic(
            basis=newpulse.basis,
            filter_function_atomic=pulses[0].get_filter_function(
                omega, order=2),
            control_matrix_atomic=control_matrix_atomic,
            control_matrix_atomic_step=ctrl_step,
            control_matrix_atomic_cumulative=ctrl_cumulative,
            propagators=util.adot(
                _stack_c([p.total_propagator for p in pulses[:-1]])),
            propagators_liouville=propagators_liouville,
            intermediates=[p.intermediates for p in pulses])
        newpulse.cache_filter_function(omega, filter_function=ff2, order=2)

    newpulse.cache_filter_function(omega, control_matrix, which=which)
    return newpulse


@jax.jit
def _boundary_phases(omega: jnp.ndarray, t_bound: jnp.ndarray) -> C:
    """e^{i omega t_g} for all pulse boundaries, fused in one kernel."""
    return cexp(t_bound[:, None] * omega[None, :])


@functools.partial(jax.jit, static_argnames='which')
def _concat_train_fused(ctrls_t, props_t, tau_d: jnp.ndarray,
                        didx: jnp.ndarray, omega: jnp.ndarray,
                        basis_dev: C, which: str):
    """ONE compiled program for the heterogeneous cached-train
    concatenation (the reference's standard-concatenation anchor,
    pulse_sequence.py:1668-1887, for trains drawn from few distinct
    cached pulses).

    The eager formulation of this path -- boundary phases, per-distinct
    Liouville representations, the cumulative Liouville product, the
    K5 atomic sum, the total propagator tree and the filter function --
    dispatches ~150 individual ops, each a host round trip, for little
    arithmetic.  Fusing the whole
    device part over the DISTINCT-pulse operands (gathers by train
    index happen in-graph, where XLA fuses them into the consumers)
    makes the warm train cost one dispatch.

    Operands are per-distinct tuples (stacked IN-graph, where the
    stacks fuse into their consumers): ctrls_t, D atomic control
    matrices C(n_nops, d^2, n_omega); props_t, D total propagators
    C(d, d); tau_d (D,) durations; didx (G,) maps train position ->
    distinct index.  The basis must be normalized and hermitian
    (checked by the caller), so the Liouville representation is the
    real part of the plain double conjugation expansion.

    Returns (control_matrix, total_propagator,
    total_propagator_liouville, total_phases, filter_function).
    """
    ctrl_d = C(jnp.stack([c.re for c in ctrls_t]),
               jnp.stack([c.im for c in ctrls_t]))
    prop_d = C(jnp.stack([q.re for q in props_t]),
               jnp.stack([q.im for q in props_t]))
    tau = tau_d[didx]
    tcum = jnp.cumsum(tau)
    phases = cexp(tcum[:-1][:, None] * omega[None, :])      # (G-1, W)
    # distinct Liouville representations U_ij = tr(C_i U C_j U+)
    conj_d = util.ceinsum('pba,ibc,pcd->piad', prop_d.conj(), basis_dev,
                          prop_d)
    liou_d = util.ceinsum('piab,jba->pij', conj_d, basis_dev).re
    props_liouville = util.adot(liou_d[didx[:-1]])
    control_matrix = numeric.calculate_control_matrix_from_atomic(
        phases, ctrl_d[didx], props_liouville, which='total')
    total_prop = util.mdot(prop_d[didx[::-1]])
    conj_t = util.ceinsum('ba,ibc,cd->iad', total_prop.conj(), basis_dev,
                          total_prop)
    total_liou = util.ceinsum('iab,jba->ij', conj_t, basis_dev).re
    total_phases = cexp(omega * tcum[-1])
    filter_function = numeric.calculate_filter_function(control_matrix,
                                                        which)
    return (control_matrix, total_prop, total_liou, total_phases,
            filter_function)


def _stack_real(items: Sequence) -> jnp.ndarray:
    """Stack real device arrays along a new leading axis, gathering
    from the distinct objects when a long list repeats few of them
    (cf. :func:`_stack_c`)."""
    if len(items) > 64:
        uniq: Dict[int, int] = {}
        distinct = []
        idx = np.empty(len(items), np.int32)
        for i, it in enumerate(items):
            k = uniq.get(id(it))
            if k is None:
                k = uniq[id(it)] = len(distinct)
                distinct.append(it)
            idx[i] = k
        if len(distinct) <= len(items) // 4:
            _fastpath_hits['stack_real_gather'] += 1
            base = jnp.stack([jnp.asarray(d) for d in distinct])
            return jnp.take(base, jnp.asarray(idx), axis=0)
    return jnp.stack([jnp.asarray(pl) for pl in items])


def _stack_c(items: Sequence) -> C:
    """Stack a list of C (or array) matrices along a new leading axis.

    When all entries are the same object (e.g. ``concatenate([p] * G)``)
    this broadcasts instead of building a G-ary concatenate graph; when
    a long list repeats FEW distinct objects (random/Clifford trains of
    cached pulses) it stacks the distinct ones and gathers by index --
    a G-ary ``jnp.stack`` costs O(G) trace operands and minutes of XLA
    compile at G = 1e4."""
    if len(items) > 1 and all(i is items[0] for i in items):
        first = asc(items[0])
        shape = (len(items),) + first.shape
        return C(jnp.broadcast_to(first.re, shape),
                 jnp.broadcast_to(first.im, shape))
    if len(items) > 64:
        uniq: Dict[int, int] = {}
        distinct = []
        idx = np.empty(len(items), np.int32)
        for i, it in enumerate(items):
            k = uniq.get(id(it))
            if k is None:
                k = uniq[id(it)] = len(distinct)
                distinct.append(it)
            idx[i] = k
        if len(distinct) <= len(items) // 4:
            _fastpath_hits['stack_c_gather'] += 1
            base = _stack_c(distinct)
            ind = jnp.asarray(idx)
            return C(jnp.take(base.re, ind, axis=0),
                     jnp.take(base.im, ind, axis=0))
    items = [asc(i) for i in items]
    return C(jnp.stack([i.re for i in items]),
             jnp.stack([i.im for i in items]))


def _cumprod_c(items: Sequence[C]) -> C:
    """Elementwise cumulative product along a stacked leading axis,
    evaluated as a log-depth associative scan on device."""
    stacked = _stack_c(items)
    if len(items) == 1:
        return stacked
    return _cumprod_scan(stacked.re, stacked.im)


@jax.jit
def _cumprod_scan(re, im):
    import jax.lax as lax

    def combine(a, b):
        (ar, ai), (br, bi) = a, b
        return ar * br - ai * bi, ar * bi + ai * br

    out = lax.associative_scan(combine, (re, im))
    return C(out[0], out[1])


def concatenate_periodic(pulse: PulseSequence, repeats: int,
                         check_invertible: bool = True) -> PulseSequence:
    r"""Repeat *pulse* `repeats` times with the closed-form geometric
    series for the control matrix (pulse_sequence.py:1890-1977).

    The series is evaluated by branch-free binary doubling (see
    :func:`~.cplx.geometric_series`); *check_invertible* is accepted
    for API compatibility and ignored.
    """
    if not isinstance(pulse, PulseSequence):
        raise TypeError('Can only concatenate PulseSequences!')

    newpulse = PulseSequence.from_arrays(
        c_opers=pulse.c_opers,
        c_oper_identifiers=pulse.c_oper_identifiers,
        c_coeffs=np.tile(pulse.c_coeffs, (1, repeats)),
        n_opers=pulse.n_opers,
        n_oper_identifiers=pulse.n_oper_identifiers,
        n_coeffs=np.tile(pulse.n_coeffs, (1, repeats)),
        dt=np.tile(pulse.dt, repeats),
        basis=pulse.basis,
    )
    newpulse.tau = repeats * pulse.tau
    if not pulse.is_cached('control_matrix'):
        return newpulse

    phases_at = pulse.get_total_phases(pulse.omega)
    ctrl_at = pulse.get_control_matrix(pulse.omega)
    liouville_at = pulse.total_propagator_liouville

    newpulse.total_propagator = matrix_power(
        asc(pulse.total_propagator), repeats)
    newpulse.cache_total_phases(pulse.omega)
    ctrl_tot = numeric.calculate_control_matrix_periodic(
        phases_at, ctrl_at, asc(liouville_at), repeats)
    newpulse.cache_filter_function(pulse.omega, ctrl_tot)
    return newpulse


# -----------------------------------------------------------------------------
# remap / extend
# -----------------------------------------------------------------------------
def _map_identifiers(identifiers, mapping):
    """Remap identifiers; returns (remapped, sort_idx)
    (pulse_sequence.py:1533-1561)."""
    if mapping is None:
        return np.asarray(identifiers), np.arange(len(identifiers))
    remapped = np.array([mapping[i] for i in identifiers])
    return remapped, np.argsort(remapped)


def _default_extend_mapping(identifiers, mapping, qubits):
    """Default identifier mapping appends the target qubit indices
    (pulse_sequence.py:1564-1596)."""
    if mapping is not None:
        return identifiers, mapping
    try:
        suffix = ('{}' * len(qubits)).format(*qubits)
    except TypeError:
        suffix = f'{qubits}'
    return identifiers, {q: f'{q}_{suffix}' for q in identifiers}


def remap(pulse: PulseSequence, order: Sequence[int], d_per_qubit: int = 2,
          oper_identifier_mapping: Optional[Mapping[str, str]] = None
          ) -> PulseSequence:
    """Permute the qubit order of a pulse's tensor-product operators,
    retaining caches (pulse_sequence.py:1980-2114).  Pauli-basis control
    matrices are permuted via index arithmetic."""
    n_qubits = int(round(np.log(pulse.d) / np.log(d_per_qubit)))
    dims = [[d_per_qubit] * n_qubits] * 2

    c_opers = util.tensor_transpose(pulse.c_opers, order, dims)
    n_opers = util.tensor_transpose(pulse.n_opers, order, dims)
    c_ids, c_sort = _map_identifiers(pulse.c_oper_identifiers,
                                     oper_identifier_mapping)
    n_ids, n_sort = _map_identifiers(pulse.n_oper_identifiers,
                                     oper_identifier_mapping)

    remapped = PulseSequence.from_arrays(
        c_opers=c_opers[c_sort], n_opers=n_opers[n_sort],
        c_oper_identifiers=c_ids[c_sort], n_oper_identifiers=n_ids[n_sort],
        c_coeffs=pulse.c_coeffs[c_sort], n_coeffs=pulse.n_coeffs[n_sort],
        dt=pulse.dt, basis=pulse.basis)
    if 't' in pulse.data:
        remapped.t = pulse.t
    if 'tau' in pulse.data:
        remapped.tau = pulse.tau

    if pulse.is_cached('eigvals'):
        remapped.eigvals = jnp.asarray(util.tensor_transpose(
            np.asarray(pulse.eigvals), order, [[d_per_qubit] * n_qubits],
            rank=1))
    for attr in ('eigvecs', 'propagators', 'total_propagator'):
        if pulse.is_cached(attr):
            setattr(remapped, attr,
                    util.tensor_transpose(getattr(pulse, attr), order, dims))

    if not pulse.is_cached('omega'):
        return remapped
    omega = pulse.omega
    if pulse.is_cached('total_phases'):
        remapped.cache_total_phases(omega, pulse.get_total_phases(omega))
    if pulse.is_cached('filter_function'):
        ff = pulse.get_filter_function(omega)
        perm_ff = ff._map(lambda a: a[n_sort[:, None], n_sort[None, :]])
        remapped.cache_filter_function(omega, filter_function=perm_ff)

    if pulse.is_cached('total_propagator_liouville') \
            or pulse.is_cached('control_matrix'):
        if pulse.basis.btype != 'Pauli':
            warn('pulse does not have a separable basis which is needed to '
                 'retain cached control matrices.')
            return remapped
        perm = remap_pauli_basis_elements(order, n_qubits)
        inv_perm = np.argsort(perm)
        if pulse.is_cached('total_propagator_liouville'):
            tpl = pulse.total_propagator_liouville
            if isinstance(tpl, C):
                remapped.total_propagator_liouville = tpl._map(
                    lambda a: a[jnp.ix_(jnp.asarray(inv_perm),
                                        jnp.asarray(inv_perm))])
            else:
                remapped.total_propagator_liouville = jnp.asarray(
                    tpl)[jnp.ix_(jnp.asarray(inv_perm),
                                 jnp.asarray(inv_perm))]
        if pulse.is_cached('control_matrix'):
            ctrl = pulse.get_control_matrix(omega)
            inv_sort = np.argsort(n_sort)
            # new[inv_sort[a], perm[k]] = old[a, k]
            # <=> new[a, k] = old[n_sort[a], inv_perm[k]]
            remapped_ctrl = ctrl._map(
                lambda a: a[jnp.asarray(n_sort)][:, jnp.asarray(inv_perm)])
            remapped.cache_control_matrix(omega, remapped_ctrl)
    return remapped


def _tensor_chain_merge(old_attrs, new_attrs, d_per_qubit, registers,
                        qubits):
    """Merge each new attribute into the growing tensor chain at the
    register positions *qubits* (pulse_sequence.py:1486-1508)."""
    if registers is None:
        return new_attrs, list(qubits)
    pos = [bisect.bisect(registers, q) for q in qubits]
    merged = [util.tensor_merge(old, new, pos=pos,
                                arr_dims=[[d_per_qubit] * len(registers)] * 2,
                                ins_dims=[[d_per_qubit] * len(pos)] * 2)
              for old, new in zip(old_attrs, new_attrs)]
    for q in qubits:
        bisect.insort(registers, q)
    return merged, registers


def _tensor_chain_insert(old_attrs, new_attrs, d_per_qubit, registers,
                         qubit):
    """Insert each new attribute into the chain at a single qubit
    position (pulse_sequence.py:1511-1530)."""
    if registers is None:
        return new_attrs, [qubit]
    pos = bisect.bisect(registers, qubit)
    inserted = [util.tensor_insert(
        old, new, pos=pos, arr_dims=[[d_per_qubit] * len(registers)] * 2)
        for old, new in zip(old_attrs, new_attrs)]
    bisect.insort(registers, qubit)
    return inserted, registers


def extend(pulse_to_qubit_mapping: PulseMapping, N: Optional[int] = None,
           d_per_qubit: int = 2,
           additional_noise_Hamiltonian: Optional[Hamiltonian] = None,
           cache_diagonalization: Optional[bool] = None,
           cache_filter_function: Optional[bool] = None,
           omega: Optional[Coefficients] = None,
           show_progressbar: bool = False) -> PulseSequence:
    r"""Map pulses onto (subsets of) a larger qubit register, scaling up
    cached attributes (pulse_sequence.py:2117-2613).

    Cached control matrices / filter functions can only be extended for
    separable (Pauli) bases; they are scaled by sqrt(s)/s with
    s = d_per_qubit**(N - n) and scattered into the equivalent basis
    element indices.
    """
    # ---- parse mapping ----
    single_pulses, single_idx, single_maps = [], [], []
    multi_pulses, multi_idx, multi_maps = [], [], []
    active: List[int] = []
    for entry in pulse_to_qubit_mapping:
        pulse, qubit = entry[0], entry[1]
        id_mapping = entry[2] if len(entry) > 2 else None
        if util.is_sequence_like(qubit) and not isinstance(qubit, (int,
                                                                   np.integer)):
            qubit = tuple(int(q) for q in qubit)
            active.extend(qubit)
            if len(qubit) == 1:
                single_idx.append(qubit[0])
                single_pulses.append(pulse)
                single_maps.append(id_mapping)
                continue
            sorted_qubit, order = zip(*sorted(zip(qubit, range(len(qubit)))))
            if qubit == sorted_qubit:
                sorted_pulse = pulse
            else:
                try:
                    sorted_pulse = remap(pulse, order, d_per_qubit)
                except ValueError as err:
                    raise ValueError(f'Could not remap {pulse!r} mapped to '
                                     f'qubits {qubit}. Do the dimensions '
                                     'match?') from err
            multi_idx.append(list(sorted_qubit))
            multi_pulses.append(sorted_pulse)
            multi_maps.append(id_mapping)
        else:
            active.append(int(qubit))
            single_idx.append(int(qubit))
            single_pulses.append(pulse)
            single_maps.append(id_mapping)

    if not all(p.d == d_per_qubit for p in single_pulses):
        raise ValueError('Not all single-qubit pulses have dimension '
                         f'd_per_qubit = {d_per_qubit}.')
    if not all(p.d == d_per_qubit**len(q)
               for p, q in zip(multi_pulses, multi_idx)):
        raise ValueError('Not all multi-qubit pulses have correct '
                         'dimension!')

    pulses = multi_pulses + single_pulses
    idx = multi_idx + single_idx
    if not util.all_array_equal((p.dt for p in pulses)):
        raise ValueError('All pulses should be defined on the same time '
                         'steps')
    active_set = set(active)
    if len(active_set) != len(active):
        raise ValueError('Qubit clash: multiple pulses mapped to same '
                         'qubit!')
    last_qubit = max(active_set)
    if N is None:
        N = last_qubit + 1
    elif last_qubit + 1 > N:
        raise ValueError('Number of qubits N smaller than highest qubit '
                         f'index + 1 = {last_qubit + 1}')

    if len(pulse_to_qubit_mapping) == 1:
        if multi_idx and N == len(multi_idx[0]):
            warn('Single multi-qubit pulse given and mapped to its '
                 'original qubits. Returning the same.')
            return multi_pulses[0]
        if single_idx and N == 1:
            warn('Single single-qubit pulse given and mapped to its '
                 'original qubit. Returning the same.')
            return single_pulses[0]

    # ---- decide what to cache ----
    if cache_filter_function is not False:
        have_ctrl = all(p.is_cached('control_matrix') for p in pulses)
        try:
            equal_omega = util.all_array_equal(
                (p.omega for p in pulses))
        except (AttributeError, TypeError):
            equal_omega = False
        if cache_filter_function is None:
            cache_filter_function = have_ctrl and equal_omega
            if cache_filter_function:
                omega = pulses[0].omega
        elif omega is None:
            if not equal_omega:
                raise ValueError('Filter function should be cached but '
                                 'omega was not provided and could not be '
                                 'inferred.')
            omega = pulses[0].omega

    if cache_diagonalization is None:
        if cache_filter_function and additional_noise_Hamiltonian is not None:
            cache_diagonalization = True
        else:
            cache_diagonalization = all(
                p.is_cached(attr) for attr in ('eigvals', 'eigvecs',
                                               'propagators')
                for p in pulses)
    elif not cache_diagonalization \
            and additional_noise_Hamiltonian is not None:
        raise ValueError('Additional noise Hamiltonian given and '
                         'cache_diagonalization set to False but required.')

    # ---- build extended operator lists ----
    all_qubits = set(range(N))
    d = d_per_qubit**N
    n_dt = len(pulses[0].dt)
    ident = np.identity(d_per_qubit)

    c_opers, c_ids, c_coeffs = [], [], []
    n_opers, n_ids, n_coeffs = [], [], []
    for pulse, qubits, id_map in zip(multi_pulses, multi_idx, multi_maps):
        pos = [bisect.bisect(qubits, q)
               for q in sorted(all_qubits.difference(qubits))]
        c_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.c_oper_identifiers, id_map, qubits))
        n_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.n_oper_identifiers, id_map, qubits))
        c_ids.extend(c_id)
        n_ids.extend(n_id)
        arr_dims = [[d_per_qubit] * len(qubits)] * 2
        c_opers.extend(util.tensor_insert(
            pulse.c_opers, *[ident] * len(pos), pos=pos, arr_dims=arr_dims))
        n_opers.extend(util.tensor_insert(
            pulse.n_opers, *[ident] * len(pos), pos=pos, arr_dims=arr_dims))
        c_coeffs.extend(pulse.c_coeffs)
        n_coeffs.extend(pulse.n_coeffs)

    for pulse, qubit, id_map in zip(single_pulses, single_idx, single_maps):
        pre = [np.identity(d_per_qubit**qubit)] if qubit > 0 else []
        post = [np.identity(d_per_qubit**(N - qubit - 1))] \
            if qubit < N - 1 else []
        c_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.c_oper_identifiers, id_map, qubit))
        n_id, _ = _map_identifiers(*_default_extend_mapping(
            pulse.n_oper_identifiers, id_map, qubit))
        c_ids.extend(c_id)
        n_ids.extend(n_id)
        c_opers.extend(util.tensor(*(pre + [pulse.c_opers] + post)))
        n_opers.extend(util.tensor(*(pre + [pulse.n_opers] + post)))
        c_coeffs.extend(pulse.c_coeffs)
        n_coeffs.extend(pulse.n_coeffs)

    n_ops_from_pulses = len(n_ids)
    if additional_noise_Hamiltonian is not None:
        add_opers, add_ids, add_coeffs = _parse_hamiltonian(
            additional_noise_Hamiltonian, n_dt, 'H_n')
        if add_opers.shape[1:] != (d, d):
            raise ValueError('Expected additional noise operators to have '
                             f'dimensions {(d, d)}, not '
                             f'{add_opers.shape[1:]}.')
        clash = set(n_ids).intersection(add_ids)
        if clash:
            raise ValueError('Found duplicate noise operator identifiers: '
                             f'{clash}')
        n_opers.extend(add_opers)
        n_coeffs.extend(add_coeffs)
        n_ids.extend(add_ids)

    btypes = {p.basis.btype for p in pulses}
    if len(btypes) != 1:
        warn('Not all pulses had the same basis type. Cannot retain cached '
             'control matrices.')
        new_basis = Basis.ggm(d)
    elif btypes == {'GGM'}:
        warn('Original pulses had GGM basis which is not separable into a '
             'tensor product. Cannot retain cached control matrices.')
        new_basis = Basis.ggm(d)
    elif btypes == {'Pauli'}:
        new_basis = Basis.pauli(N)
    else:
        warn('Original pulses had custom basis which I cannot extend.')
        new_basis = Basis.ggm(d)

    c_sort = np.argsort(c_ids)
    n_sort = np.argsort(n_ids)
    newpulse = PulseSequence.from_arrays(
        c_opers=np.asarray(c_opers)[c_sort],
        n_opers=np.asarray(n_opers)[n_sort],
        c_oper_identifiers=np.asarray(c_ids)[c_sort],
        n_oper_identifiers=np.asarray(n_ids)[n_sort],
        c_coeffs=np.asarray(c_coeffs)[c_sort],
        n_coeffs=np.asarray(n_coeffs)[n_sort],
        dt=pulses[0].dt, basis=new_basis)
    if 't' in pulses[0].data:
        newpulse.t = pulses[0].t
    if 'tau' in pulses[0].data:
        newpulse.tau = pulses[0].tau

    if newpulse.basis.btype != 'Pauli':
        if cache_diagonalization:
            newpulse.diagonalize()
        if cache_filter_function:
            newpulse.cache_filter_function(omega)
        return newpulse

    # ---- extend diagonalization by tensoring cached attributes ----
    if cache_diagonalization:
        eigvals = np.zeros((n_dt, d))
        attrs = [None, None]            # eigvecs, propagators
        registers = None
        for pulse, qubits in zip(multi_pulses, multi_idx):
            hd_pos = [bisect.bisect(qubits, q)
                      for q in sorted(all_qubits.difference(qubits))]
            eigvals = eigvals + util.tensor_insert(
                np.asarray(pulse.eigvals),
                *np.ones((len(hd_pos), d_per_qubit)), pos=hd_pos, rank=1,
                arr_dims=[[d_per_qubit] * len(qubits)])
            attrs, registers = _tensor_chain_merge(
                attrs, [pulse.eigvecs, pulse.propagators], d_per_qubit,
                registers, qubits)
        for pulse, qubit in zip(single_pulses, single_idx):
            pre = [np.ones(d_per_qubit**qubit)] if qubit > 0 else []
            post = [np.ones(d_per_qubit**(N - qubit - 1))] \
                if qubit < N - 1 else []
            eigvals = eigvals + util.tensor(
                *(pre + [np.asarray(pulse.eigvals)] + post), rank=1)
            attrs, registers = _tensor_chain_insert(
                attrs, [pulse.eigvecs, pulse.propagators], d_per_qubit,
                registers, qubit)
        id_idx = sorted(all_qubits.difference(active_set))
        if id_idx:
            filler = asc(np.eye(d_per_qubit**len(id_idx)))
            attrs, registers = _tensor_chain_merge(
                attrs, [filler, filler], d_per_qubit, registers, id_idx)
        newpulse.eigvals = jnp.asarray(eigvals)
        newpulse.eigvecs = attrs[0]
        newpulse.propagators = attrs[1]
        newpulse.total_propagator = attrs[1][-1]
    elif all(p.is_cached('total_propagator') for p in pulses):
        attrs = [None]
        registers = None
        for pulse, qubits in zip(multi_pulses, multi_idx):
            attrs, registers = _tensor_chain_merge(
                attrs, [pulse.total_propagator], d_per_qubit, registers,
                qubits)
        for pulse, qubit in zip(single_pulses, single_idx):
            attrs, registers = _tensor_chain_insert(
                attrs, [pulse.total_propagator], d_per_qubit, registers,
                qubit)
        id_idx = sorted(all_qubits.difference(active_set))
        if id_idx:
            filler = asc(np.eye(d_per_qubit**len(id_idx)))
            attrs, registers = _tensor_chain_merge(
                attrs, [filler], d_per_qubit, registers, id_idx)
        newpulse.total_propagator = attrs[0]

    # ---- extend cached control matrices / filter functions ----
    if cache_filter_function:
        # only first-order fidelity quantities are extended; say so if
        # an input pulse carried more (the reference likewise only
        # handles first order, cf. pulse_sequence.py:2459-2467)
        dropped = sorted({
            name for p in pulses for name, key in
            (('second order filter function', 'filter_function_2'),
             ('pulse correlation filter function', 'filter_function_pc'),
             ('generalized pulse correlation filter function',
              'filter_function_pc_gen'))
            if p.is_cached(key)})
        if dropped:
            warn('extend() only extends first-order control matrices and '
                 'fidelity filter functions; cached '
                 + ', '.join(dropped)
                 + ' of the input pulses are discarded and must be '
                 'recomputed on the extended pulse.', UserWarning)
        newpulse.omega = omega
        n_nops_new = len(newpulse.n_opers)
        n_w = len(np.asarray(omega))
        ctrl_re = np.zeros((n_nops_new, d * d, n_w))
        ctrl_im = np.zeros_like(ctrl_re)
        ff_re = np.zeros((n_nops_new, n_nops_new, n_w))
        ff_im = np.zeros_like(ff_re)
        counter = 0
        for ind, pulse in zip(idx, pulses):
            n_nops = len(pulse.n_opers)
            ind_list = [ind] if isinstance(ind, (int, np.integer)) else ind
            basis_idx = equivalent_pauli_basis_elements(ind_list, N)
            rows = slice(counter, counter + n_nops)
            counter += n_nops
            scale = d_per_qubit**(N - len(ind_list))
            ctrl = pulse.get_control_matrix(
                omega, show_progressbar=show_progressbar)
            ctrl_re[np.ix_(range(rows.start, rows.stop), basis_idx)] = \
                np.asarray(ctrl.re) * np.sqrt(scale)
            ctrl_im[np.ix_(range(rows.start, rows.stop), basis_idx)] = \
                np.asarray(ctrl.im) * np.sqrt(scale)
            ff = pulse.get_filter_function(
                omega, show_progressbar=show_progressbar)
            ff_re[rows, rows] = np.asarray(ff.re) * scale
            ff_im[rows, rows] = np.asarray(ff.im) * scale

        if additional_noise_Hamiltonian is not None:
            newpulse_inds = util.get_indices_from_identifiers(
                newpulse.n_oper_identifiers, list(n_ids[counter:]))
            extra_ctrl = numeric.calculate_control_matrix_from_scratch(
                newpulse.eigvals, newpulse.eigvecs, newpulse.propagators,
                jnp.asarray(omega), newpulse.basis,
                asc(newpulse.n_opers[newpulse_inds]),
                newpulse.n_coeffs[newpulse_inds], newpulse.dt,
                t=jnp.asarray(newpulse.t),
                show_progressbar=show_progressbar)
            ctrl_re[counter:] = np.asarray(extra_ctrl.re)
            ctrl_im[counter:] = np.asarray(extra_ctrl.im)
            extra_ff = numeric.calculate_filter_function(extra_ctrl)
            ff_re[counter:, counter:] = np.asarray(extra_ff.re)
            ff_im[counter:, counter:] = np.asarray(extra_ff.im)

        newpulse.cache_total_phases(omega)
        newpulse.total_propagator_liouville = liouville_representation(
            newpulse.total_propagator, newpulse.basis)
        newpulse.cache_control_matrix(
            omega, C(jnp.asarray(ctrl_re[n_sort]),
                     jnp.asarray(ctrl_im[n_sort])))
        newpulse.cache_filter_function(
            omega, filter_function=C(
                jnp.asarray(ff_re[np.ix_(n_sort, n_sort)]),
                jnp.asarray(ff_im[np.ix_(n_sort, n_sort)])))
    return newpulse
