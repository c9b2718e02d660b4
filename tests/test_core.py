"""PulseSequence core tests: construction validation, caching
semantics, cleanup tiers, equality, slicing, noise operators
(cf. reference tests/test_core.py)."""
import copy

import numpy as np
import pytest

import filter_functions_tpu as ff
from filter_functions_tpu import numeric, util
from filter_functions_tpu.basis import Basis, expand
from filter_functions_tpu.cplx import asc
from conftest import HAVE_REFERENCE
from testutil import (assert_allclose, make_pulse, rand_pulse_arrays,
                      rand_pulse_sequence, rng, sigma, to_np)


class TestConstruction:
    def test_identifier_sorting(self):
        X, Z = sigma[1], sigma[3]
        p = ff.PulseSequence([[X, [1.0], 'b'], [Z, [2.0], 'a']],
                             [[Z, [1.0], 'z'], [X, [1.0], 'y']], [1.0])
        assert list(p.c_oper_identifiers) == ['a', 'b']
        assert_allclose(p.c_opers[0], Z)
        assert_allclose(p.c_coeffs[0], [2.0])
        assert list(p.n_oper_identifiers) == ['y', 'z']

    def test_auto_identifiers(self):
        X, Z = sigma[1], sigma[3]
        p = ff.PulseSequence([[X, [1.0]], [Z, [1.0]]],
                             [[Z, [1.0]]], [1.0])
        assert list(p.c_oper_identifiers) == ['A_0', 'A_1']
        assert list(p.n_oper_identifiers) == ['B_0']

    def test_validation_errors(self):
        X, Z = sigma[1], sigma[3]
        with pytest.raises(TypeError):
            ff.PulseSequence([[X, [1.0]]], [[Z, [1.0]]], 4)
        with pytest.raises(TypeError):
            ff.PulseSequence(X, [[Z, [1.0]]], [1.0])
        with pytest.raises(ValueError):
            # rows of X parse as (oper, coeffs) with wrong coeff length
            ff.PulseSequence([X], [[Z, [1.0]]], [1.0])
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0]]], [[Z, [1.0]]], [1.0],
                             basis=Basis.ggm(3))
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0]]], [[Z, [1.0]]], [1.0],
                             basis='not a basis')
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0, 2.0]]], [[Z, [1.0]]], [1.0])

    def test_constructor_validation_matrix(self):
        """The full failure-mode matrix of the reference constructor
        (reference tests/test_core.py:42-222)."""
        bp = rand_pulse_sequence(2, 5, 3, 3)
        H_c = [list(x) for x in zip(np.asarray(bp.c_opers),
                                    np.asarray(bp.c_coeffs),
                                    bp.c_oper_identifiers)]
        H_n = [list(x) for x in zip(np.asarray(bp.n_opers),
                                    np.asarray(bp.n_coeffs),
                                    bp.n_oper_identifiers)]
        dt = np.asarray(bp.dt).copy()

        with pytest.raises(TypeError):
            ff.PulseSequence(H_c, H_n)            # missing dt
        with pytest.raises(TypeError):
            ff.PulseSequence(H_c, H_n, dt[0])     # dt scalar
        bad = dt.copy()
        bad[2] *= -1
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c, H_n, bad)       # negative dt
        badc = dt.astype(complex)
        badc[2] += 1j
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c, H_n, badc)      # imaginary dt
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c, H_n, dt,
                             np.asarray(ff.Basis.pauli(1)))  # raw ndarray
        with pytest.raises(TypeError):
            ff.PulseSequence(15, H_n, dt)
        with pytest.raises(TypeError):
            ff.PulseSequence(H_c, 15, dt)
        hc = copy.deepcopy(H_c)
        hc[1] = dict(enumerate(hc[1]))
        with pytest.raises(TypeError):
            ff.PulseSequence(hc, H_n, dt)         # element a mapping
        hc = copy.deepcopy(H_c)
        hc[1][1] = hc[1][1][0]
        with pytest.raises(TypeError):
            ff.PulseSequence(hc, H_n, dt)         # coefficient scalar
        hc = copy.deepcopy(H_c)
        hc[1][0] = np.tile(hc[1][0], (3, 1, 1))
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n, dt)         # 3d operator
        hc = copy.deepcopy(H_c)
        hc[1][0] = hc[1][0].reshape(1, 4)
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n, dt)         # non-square operator
        hn = copy.deepcopy(H_n)
        hn[1][0] = np.kron(hn[1][0], np.eye(2))
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c, hn, dt)         # mixed dimensions
        hc = copy.deepcopy(H_c)
        hc[1][2] = hc[0][2]
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n, dt)         # duplicate identifiers
        hc = copy.deepcopy(H_c)
        hc[1][1] = hc[1][1][:-2]
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n, dt)         # coeff length != n_dt

        pulse = ff.PulseSequence(H_c, H_n, dt)
        assert repr(pulse)
        assert str(pulse)

    def test_mixed_auto_and_named_identifiers(self):
        p2 = ff.PulseSequence(
            [[util.paulis[1], [1], 'X'], [util.paulis[2], [1]]],
            [[util.paulis[1], [1]], [util.paulis[2], [1], 'Y']], [1])
        assert list(p2.c_oper_identifiers) == ['A_1', 'X']
        assert list(p2.n_oper_identifiers) == ['B_0', 'Y']

    def test_from_arrays_validation(self):
        a = rand_pulse_arrays(2, 3)
        with pytest.raises(ValueError):
            ff.PulseSequence.from_arrays(a[0][:1], a[1], a[2], a[3], a[4],
                                         a[5], a[6])
        with pytest.raises(ValueError):
            ff.PulseSequence.from_arrays(a[0], a[1], a[2][:, :2], a[3],
                                         a[4], a[5], a[6])
        with pytest.raises(ValueError):
            ff.PulseSequence.from_arrays(a[0], a[1], a[2], a[3], a[4],
                                         a[5], a[6], basis=Basis.ggm(3))

    def test_attributes(self):
        p = rand_pulse_sequence(2, 5)
        assert len(p) == 5
        assert p.d == 2
        assert_allclose(p.t, np.concatenate([[0], p.dt.cumsum()]))
        assert_allclose(p.tau, p.dt.sum())
        assert p.duration == p.tau

    def test_equality_matrix(self):
        """Pulses differing in any single ingredient compare unequal
        (reference tests/test_core.py:241-335)."""
        X, Y, Z = sigma[1:]
        n_dt = 4
        cc = rng.standard_normal(n_dt)
        nc = rng.random(n_dt)
        dt = np.abs(rng.standard_normal(n_dt)) + 0.1
        a = ff.PulseSequence([[X, cc, 'X']], [[Z, nc, 'Z']], dt)

        assert not (a == 1)
        assert a != 1
        variants = [
            # different number of time steps
            ff.PulseSequence([[X, np.r_[cc, 1.0], 'X']],
                             [[Z, np.r_[nc, 1.0], 'Z']],
                             np.r_[dt, 1.0]),
            # different durations
            ff.PulseSequence([[X, cc, 'X']], [[Z, nc, 'Z']], dt * 2),
            # different control opers
            ff.PulseSequence([[Y, cc, 'X']], [[Z, nc, 'Z']], dt),
            # different control coeffs
            ff.PulseSequence([[X, cc + 1, 'X']], [[Z, nc, 'Z']], dt),
            # different noise opers
            ff.PulseSequence([[X, cc, 'X']], [[Y, nc, 'Z']], dt),
            # different noise coeffs
            ff.PulseSequence([[X, cc, 'X']], [[Z, nc + 1, 'Z']], dt),
            # different control identifiers
            ff.PulseSequence([[X, cc, 'foobar']], [[Z, nc, 'Z']], dt),
            # different noise identifiers
            ff.PulseSequence([[X, cc, 'X']], [[Z, nc, 'foobar']], dt),
            # different basis
            ff.PulseSequence([[X, cc, 'X']], [[Z, nc, 'Z']], dt,
                             ff.Basis(rand_pulse_arrays(2, 1)[0])),
        ]
        for b in variants:
            assert not (a == b)
            assert a != b
        # physically identical pulse compares equal
        same = ff.PulseSequence([[X, cc.copy(), 'X']],
                                [[Z, nc.copy(), 'Z']], dt.copy())
        assert a == same


class TestCaching:
    def test_lazy_diagonalization(self):
        p = rand_pulse_sequence(2, 4)
        assert not p.is_cached('eigvals')
        _ = p.eigvals
        assert p.is_cached('eigvals') and p.is_cached('eigvecs')
        assert p.is_cached('propagators')

    def test_diagonalization_correct(self):
        p = rand_pulse_sequence(3, 5)
        p.diagonalize()
        ham = np.einsum('ijk,il->ljk', p.c_opers, p.c_coeffs)
        v = to_np(p.eigvecs)
        w = np.asarray(p.eigvals)
        assert_allclose(v.conj().swapaxes(-1, -2) @ ham @ v,
                        np.einsum('gi,ij->gij', w, np.eye(3)), atol=1e-12)
        # propagators are unitary and satisfy the composition rule
        q = to_np(p.propagators)
        assert_allclose(q[0], np.eye(3), atol=1e-15)
        assert_allclose(q @ q.conj().swapaxes(-1, -2),
                        np.broadcast_to(np.eye(3), q.shape), atol=1e-12)

    def test_is_cached_aliases(self):
        p = rand_pulse_sequence(2, 3)
        omega = np.linspace(1, 5, 7)
        assert not p.is_cached('filter function')
        assert not p.is_cached('control matrix')
        p.cache_filter_function(omega)
        for alias in ('filter function', 'fidelity filter function',
                      'control matrix', 'total phases', 'frequencies',
                      'total propagator', 'total propagator liouville'):
            assert p.is_cached(alias), alias

    def test_omega_invalidation(self):
        p = rand_pulse_sequence(2, 3)
        omega = np.linspace(1, 5, 7)
        p.cache_filter_function(omega)
        assert p.is_cached('filter function')
        p.omega = omega * 2
        assert not p.is_cached('filter function')
        assert p.is_cached('eigvals')  # time-domain data survives

    def test_cleanup_tiers(self):
        p = rand_pulse_sequence(2, 3)
        omega = np.linspace(1, 5, 7)
        p.get_filter_function(omega, cache_intermediates=True)
        assert p.nbytes > 0
        p.cleanup()  # conservative
        assert not p.is_cached('eigvals')
        assert p.is_cached('filter function')
        p.diagonalize()
        p.cleanup('greedy')
        assert not p.is_cached('control matrix')
        assert p.is_cached('filter function')
        p.cleanup('all')
        assert not p.is_cached('filter function')
        assert len(p._intermediates) == 0

    def test_cache_intermediates_consistency(self):
        """Control matrix with and without intermediates must agree;
        intermediates must reproduce the result."""
        p1 = rand_pulse_sequence(2, 4)
        p2 = copy.copy(p1)
        p2.cleanup('all')
        omega = np.linspace(0.5, 5, 9)
        c1 = to_np(p1.get_control_matrix(omega, cache_intermediates=True))
        c2 = to_np(p2.get_control_matrix(omega))
        assert_allclose(c1, c2, atol=1e-14)
        steps = to_np(p1._intermediates['control_matrix_step'])
        assert_allclose(steps.sum(axis=0), c1, atol=1e-13)

    def test_equality_segment_joining(self):
        X, Z = sigma[1], sigma[3]
        p1 = ff.PulseSequence([[X, [1.0, 1.0], 'X']],
                              [[Z, [1.0, 1.0], 'Z']], [0.5, 0.5])
        p2 = ff.PulseSequence([[X, [1.0], 'X']], [[Z, [1.0], 'Z']], [1.0])
        assert p1 == p2
        p3 = ff.PulseSequence([[X, [2.0], 'X']], [[Z, [1.0], 'Z']], [1.0])
        assert p1 != p3
        assert p1 != 'a string'

    def test_copy_semantics(self):
        p = rand_pulse_sequence(2, 3)
        omega = np.linspace(1, 5, 7)
        p.cache_filter_function(omega)
        q = copy.copy(p)
        q.cleanup('all')
        assert p.is_cached('filter function')
        assert not q.is_cached('filter function')


class TestNoiseOperators:
    """K7: Hilbert-space noise operators vs the control matrix."""

    @pytest.mark.parametrize('d', [2, 3, 4])
    def test_duality_with_control_matrix(self, d):
        p = rand_pulse_sequence(d, 4)
        omega = np.linspace(0.5, 5, 9)
        p.diagonalize()
        nops = numeric.calculate_noise_operators_from_scratch(
            p.eigvals, p.eigvecs, p.propagators, omega, p.n_opers_dev,
            p.n_coeffs, p.dt)
        ctrl = to_np(p.get_control_matrix(omega))
        # ctrlmat == basis expansion of the noise operators, transposed
        coeffs = expand(nops, p.basis)
        got = coeffs.to_numpy().transpose(1, 2, 0)
        assert_allclose(got, ctrl, atol=1e-12)

    def test_atomic_equals_scratch(self):
        """Concatenating noise operators of segments == from scratch."""
        arrays = rand_pulse_arrays(2, 4)
        p = make_pulse(arrays)
        omega = np.linspace(0.5, 5, 7)
        p.diagonalize()
        full = to_np(numeric.calculate_noise_operators_from_scratch(
            p.eigvals, p.eigvecs, p.propagators, omega, p.n_opers_dev,
            p.n_coeffs, p.dt))
        # per-segment
        pieces = []
        for g in range(len(p)):
            seg = p[g]
            seg.diagonalize()
            pieces.append(numeric.calculate_noise_operators_from_scratch(
                seg.eigvals, seg.eigvecs, seg.propagators, omega,
                seg.n_opers_dev, seg.n_coeffs, seg.dt))
        from filter_functions_tpu.sequencing import _stack_c, _cumprod_c
        atomic = _stack_c(pieces)
        phases = _cumprod_c([p[g].get_total_phases(omega)
                             for g in range(len(p) - 1)])
        props = to_np(p.propagators)
        boundary = _stack_c([asc(props[g]) for g in
                             np.arange(1, len(p))])
        got = to_np(numeric.calculate_noise_operators_from_atomic(
            phases, atomic, boundary))
        assert_allclose(got, full, atol=1e-12)


class TestAtomicRepresentationDuality:
    """Hilbert-space (K7) and Liouville (K5) atomic composition agree
    through the basis expansion (reference test_precision.py:313-355)."""

    @pytest.mark.parametrize('d', [2, 3])
    def test_from_atomic_cross_representation(self, d):
        from filter_functions_tpu.sequencing import _stack_c, _cumprod_c
        from filter_functions_tpu.superoperator import \
            liouville_representation
        base = rand_pulse_arrays(d, 2)
        omega = np.linspace(0.5, 5, 9)
        pulses = []
        for _ in range(3):
            arr = rand_pulse_arrays(d, 2)
            pulses.append(make_pulse((arr[0], arr[1], arr[2], base[3],
                                      base[4], base[5], arr[6])))
        for p in pulses:
            p.diagonalize()
        nops_atomic = _stack_c(
            [numeric.calculate_noise_operators_from_scratch(
                p.eigvals, p.eigvecs, p.propagators, omega,
                p.n_opers_dev, p.n_coeffs, p.dt) for p in pulses])
        ctrl_atomic = _stack_c(
            [numeric.calculate_control_matrix_from_scratch(
                p.eigvals, p.eigvecs, p.propagators, omega, p.basis,
                p.n_opers_dev, p.n_coeffs, p.dt) for p in pulses])
        # atomic-level duality: nops (G, n_w, n_nops, d, d) expands to
        # (G, n_w, n_nops, d^2); ctrl is (G, n_nops, d^2, n_w)
        got = expand(nops_atomic, pulses[0].basis).to_numpy()
        assert_allclose(got.transpose(0, 2, 3, 1),
                        to_np(ctrl_atomic), atol=1e-12)

        phases = _cumprod_c([p.get_total_phases(omega)
                             for p in pulses[:-1]])
        # cumulative boundary propagators Q_{g-1} = U_{g-1} ... U_0
        cums, acc = [], None
        for p in pulses[:-1]:
            u = to_np(p.total_propagator)
            acc = u if acc is None else u @ acc
            cums.append(acc)
        boundary = _stack_c([asc(c) for c in cums])
        props_liouville = np.stack(
            [np.asarray(liouville_representation(asc(c), pulses[0].basis))
             for c in cums])
        b_total = numeric.calculate_noise_operators_from_atomic(
            phases, nops_atomic, boundary)
        r_total = numeric.calculate_control_matrix_from_atomic(
            phases, ctrl_atomic, props_liouville)
        got = expand(b_total, pulses[0].basis).to_numpy()
        assert_allclose(got.transpose(1, 2, 0), to_np(r_total),
                        atol=1e-12)


class TestInfidelityModes:
    def test_convergence_mode(self):
        p = rand_pulse_sequence(2, 3)

        def spectrum(omega):
            return 1e-2 / omega

        n_samples, infids = ff.infidelity(
            p, spectrum, dict(n_min=50, n_max=100, n_points=3),
            test_convergence=True)
        assert len(n_samples) == len(infids)
        assert np.all(np.isfinite(infids))
        with pytest.raises(TypeError):
            ff.infidelity(p, spectrum, np.linspace(1, 2, 5),
                          test_convergence=True)
        with pytest.raises(TypeError):
            ff.infidelity(p, 1.0, dict(), test_convergence=True)

    def test_convergence_single_shape_and_parity(self, monkeypatch):
        """The sweep pads every grid to n_max (zero-weight repeated
        endpoint), so one compiled shape serves all n_points AND the
        results equal unpadded per-size evaluations exactly."""
        p = rand_pulse_sequence(2, 4)

        def spectrum(omega):
            return 1e-2 / omega

        grid = dict(omega_IR=0.2, omega_UV=20.0, n_min=20, n_max=60,
                    n_points=3)
        seen_sizes = set()
        orig = type(p).get_filter_function

        def spy(self, omega, *args, **kwargs):
            seen_sizes.add(len(np.asarray(omega)))
            return orig(self, omega, *args, **kwargs)

        monkeypatch.setattr(type(p), 'get_filter_function', spy)
        n_samples, infids = ff.infidelity(p, spectrum, grid,
                                          test_convergence=True)
        assert seen_sizes == {60}
        monkeypatch.undo()
        for n, row in zip(n_samples, infids):
            freqs = np.linspace(0.2, 20.0, int(n))
            direct = np.asarray(ff.infidelity(p, spectrum(freqs), freqs))
            assert_allclose(row, direct, rtol=1e-13)

    def test_return_smallness(self):
        p = rand_pulse_sequence(2, 3)
        omega = np.linspace(0.5, 5, 51)
        infid, xi = ff.infidelity(p, 1e-2 / omega, omega,
                                  return_smallness=True)
        assert np.isfinite(float(xi)) and float(xi) > 0

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_nontraceless_basis(self):
        """Non-traceless basis triggers the trace-correction path."""
        import filter_functions as ref
        from testutil import pulse_pair
        arrays = rand_pulse_arrays(2, 3)
        # custom basis that is not traceless
        elems = np.array([np.eye(2) + sigma[1], sigma[2], sigma[3],
                          np.eye(2) - sigma[1]]) / np.sqrt(2)
        q, _ = np.linalg.qr(elems.reshape(4, 4).T)
        elems = q.T.reshape(4, 2, 2)
        ours = make_pulse(arrays)
        ours.basis = ff.Basis(elems)
        theirs = make_pulse(arrays, cls=ref)
        theirs.basis = ref.Basis(elems)
        assert not ours.basis.istraceless
        omega = np.linspace(0.5, 5, 21)
        got = np.asarray(ff.infidelity(ours, 1e-2 / omega, omega))
        want = ref.infidelity(theirs, 1e-2 / omega, omega)
        assert_allclose(got, want, atol=1e-12)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_cross_correlated_spectra(self):
        from testutil import pulse_pair
        import filter_functions as ref
        ours, theirs = pulse_pair(2, 4, n_nops=2)
        omega = np.linspace(0.5, 5, 31)
        s_one = 1e-2 / omega
        spectrum = np.array([[s_one, 0.3 * s_one * (1 + 0.5j)],
                             [0.3 * s_one * (1 - 0.5j), 2 * s_one]])
        got = np.asarray(ff.infidelity(ours, spectrum, omega))
        want = ref.infidelity(theirs, spectrum, omega)
        assert_allclose(got, want, atol=1e-14)
        got_d = np.asarray(numeric.calculate_decay_amplitudes(
            ours, spectrum, omega))
        want_d = ref.numeric.calculate_decay_amplitudes(
            theirs, spectrum, omega)
        assert_allclose(got_d, want_d, atol=1e-13)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_memory_parsimonious(self):
        from testutil import pulse_pair
        ours, _ = pulse_pair(2, 3)
        omega = np.linspace(0.5, 5, 21)
        spectrum = 1e-2 / omega
        fat = np.asarray(numeric.calculate_decay_amplitudes(
            ours, spectrum, omega))
        thin = np.asarray(numeric.calculate_decay_amplitudes(
            ours, spectrum, omega, memory_parsimonious=True))
        assert_allclose(thin, fat, atol=1e-14)


class TestIsCachedAliasMatrix:
    """Every human-readable alias maps onto the right raw cache slot
    (reference tests/test_core.py:358-471): set the raw key, query the
    alias; clear, query again."""

    DATA = {'eigenvalues': 'eigvals', 'eigenvectors': 'eigvecs',
            'propagators': 'propagators',
            'total propagator': 'total_propagator',
            'total propagator liouville': 'total_propagator_liouville'}
    FREQ = {'frequencies': 'omega', 'total phases': 'total_phases',
            'filter function': 'filter_function',
            'fidelity filter function': 'filter_function',
            'generalized filter function': 'filter_function_gen',
            'pulse correlation filter function': 'filter_function_pc',
            'fidelity pulse correlation filter function':
                'filter_function_pc',
            'generalized pulse correlation filter function':
                'filter_function_pc_gen',
            'second order filter function': 'filter_function_2',
            'control matrix': 'control_matrix',
            'pulse correlation control matrix': 'control_matrix_pc'}

    def test_alias_matrix(self):
        p = rand_pulse_sequence(2, 3)
        for alias, key in self.DATA.items():
            assert not p.is_cached(alias)
            p._data[key] = np.zeros(1)       # mock attribute
            assert p.is_cached(alias)
            # underscore spelling works too
            assert p.is_cached(alias.replace(' ', '_'))
            del p._data[key]
            assert not p.is_cached(alias)
        for alias, key in self.FREQ.items():
            assert not p.is_cached(alias)
            p._frequency_data[key] = np.zeros(1)
            assert p.is_cached(alias)
            assert p.is_cached(alias.replace(' ', '_'))
            del p._frequency_data[key]
            assert not p.is_cached(alias)
        # raw intermediates keys are queryable directly
        p._intermediates['n_opers_transformed'] = np.zeros(1)
        assert p.is_cached('n_opers_transformed')


class TestCumulantFunctionSemantics:
    """Cumulant function argument handling and structural properties
    (cf. reference tests/test_core.py:1007-1135)."""

    def test_precomputed_amplitudes_and_shifts(self):
        pulse = rand_pulse_sequence(2, 2, 1, 1)
        omega = np.linspace(0.5, 5, 43)
        spectrum = 1e-2 / omega
        gamma = numeric.calculate_decay_amplitudes(pulse, spectrum, omega)
        delta = numeric.calculate_frequency_shifts(pulse, spectrum, omega)
        k1 = np.asarray(numeric.calculate_cumulant_function(
            pulse, spectrum, omega))
        k2 = np.asarray(numeric.calculate_cumulant_function(
            pulse, decay_amplitudes=gamma))
        k3 = np.asarray(numeric.calculate_cumulant_function(
            pulse, spectrum, omega, second_order=True))
        k4 = np.asarray(numeric.calculate_cumulant_function(
            pulse, decay_amplitudes=gamma, frequency_shifts=delta,
            second_order=True))
        assert_allclose(k1, k2, atol=1e-15)
        assert_allclose(k3, k4, atol=1e-15)

        with pytest.raises(ValueError):
            numeric.calculate_cumulant_function(pulse, None, None,
                                                decay_amplitudes=None)
        with pytest.raises(ValueError):
            numeric.calculate_cumulant_function(
                pulse, None, None, decay_amplitudes=gamma,
                frequency_shifts=None, second_order=True)
        with pytest.raises(ValueError):
            numeric.calculate_cumulant_function(
                pulse, spectrum, omega, second_order=True,
                which='correlations')
        with pytest.raises(ValueError):
            numeric.calculate_cumulant_function(
                pulse, spectrum, omega, second_order=True,
                decay_amplitudes=np.asarray(gamma)[..., 1:, :])
        with pytest.warns(UserWarning, match='parsimonious'):
            numeric.calculate_cumulant_function(
                pulse, spectrum, omega, second_order=True,
                memory_parsimonious=True)

    @pytest.mark.parametrize('d', [2, 3, 5])
    def test_second_order_contribution_antihermitian(self, d):
        from filter_functions_tpu import util
        pulse = rand_pulse_sequence(d, 3, 2, 2)
        omega = util.get_sample_frequencies(pulse, n_samples=42)
        spectrum = 4e-3 / np.abs(omega)
        pulse.cache_control_matrix(omega, cache_intermediates=True)
        k1 = np.asarray(numeric.calculate_cumulant_function(
            pulse, spectrum, omega, second_order=False))
        k2 = np.asarray(numeric.calculate_cumulant_function(
            pulse, spectrum, omega, second_order=True))
        second = k2 - k1
        assert_allclose(second, -second.transpose(0, 2, 1), atol=1e-15)
        assert k1.shape == k2.shape

    def test_decay_amplitude_spectrum_raises(self):
        pulse = rand_pulse_sequence(2, 1, 1, 1)
        omega = np.linspace(0.5, 5, 43)
        spectrum = rng.standard_normal(78)
        for i in range(4):
            with pytest.raises(ValueError):
                numeric.calculate_decay_amplitudes(
                    pulse, np.tile(spectrum, [1] * i), omega)

    def test_convergence_defaults_and_identifiers(self):
        pulse = rand_pulse_sequence(2, 5, 3, 3)

        def spectrum(w):
            return w**0

        n, infids = ff.infidelity(pulse, spectrum, {},
                                  test_convergence=True)
        assert len(n) == len(infids)
        ids = [pulse.n_oper_identifiers[i] for i in (0, 2)]
        n, infids = ff.infidelity(
            pulse, spectrum,
            dict(omega_IR=0.1, omega_UV=2, spacing='linear', n_min=10,
                 n_max=50, n_points=4),
            test_convergence=True, n_oper_identifiers=ids)
        assert infids.shape == (len(n), 2)
        with pytest.raises(ValueError):
            ff.infidelity(pulse, spectrum, dict(spacing='foobar'),
                          test_convergence=True)


class TestPropagatorAtArbT:
    def test_matches_segment_boundaries(self):
        p = rand_pulse_sequence(2, 4)
        q_at_t = to_np(p.propagator_at_arb_t(p.t[1:]))
        q = to_np(p.propagators)[1:]
        assert_allclose(q_at_t, q, atol=1e-12)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_matches_reference(self):
        from testutil import pulse_pair
        ours, theirs = pulse_pair(2, 4)
        tt = np.sort(rng.random(7)) * float(ours.tau)
        got = to_np(ours.propagator_at_arb_t(tt))
        want = theirs.propagator_at_arb_t(tt)
        assert_allclose(got, want, atol=1e-12)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_edges_and_boundaries_match_reference(self):
        """t = 0, t = tau, exact segment boundaries, and interior
        points (reference oracle pulse_sequence.py:1247-1267)."""
        from testutil import pulse_pair
        ours, theirs = pulse_pair(3, 5)
        interior = (np.asarray(ours.t[:-1]) + np.asarray(ours.t[1:])) / 2
        tt = np.sort(np.concatenate(
            [[0.0, float(ours.tau)], np.asarray(ours.t), interior]))
        got = to_np(ours.propagator_at_arb_t(tt))
        want = theirs.propagator_at_arb_t(tt)
        assert_allclose(got, want, atol=1e-12)
        # t = 0 is the identity, t = tau the total propagator
        assert_allclose(to_np(ours.propagator_at_arb_t([0.0]))[0],
                        np.eye(3), atol=1e-12)
        assert_allclose(
            to_np(ours.propagator_at_arb_t([float(ours.tau)]))[0],
            to_np(ours.total_propagator), atol=1e-12)


class TestConstructionNegativePaths:
    """Reference test_core pins a large negative-path surface
    (reference tests/test_core.py TestPulseSequence.test_pulse_sequence_constructor)."""

    def test_duplicate_identifiers(self):
        X, Z = sigma[1], sigma[3]
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0], 'X'], [Z, [1.0], 'X']],
                             [[Z, [1.0], 'Z']], [1.0])

    def test_complex_dt(self):
        X, Z = sigma[1], sigma[3]
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0]]], [[Z, [1.0]]], [1.0 + 1j])

    def test_negative_dt(self):
        X, Z = sigma[1], sigma[3]
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0, 1.0]]], [[Z, [1.0, 1.0]]],
                             [1.0, -1.0])

    def test_dimension_mismatch(self):
        X = sigma[1]
        Z3 = np.diag([1., 0., -1.]).astype(complex)
        with pytest.raises(ValueError):
            ff.PulseSequence([[X, [1.0]]], [[Z3, [1.0]]], [1.0])

    def test_coeff_not_sequence(self):
        X, Z = sigma[1], sigma[3]
        with pytest.raises(TypeError):
            ff.PulseSequence([[X, 1.0]], [[Z, [1.0]]], [1.0])

    def test_empty_slice_raises(self):
        p = rand_pulse_sequence(2, 4)
        with pytest.raises(IndexError):
            p[4:4]

    def test_numpy_does_not_unroll(self):
        p = rand_pulse_sequence(2, 4)
        arr = np.asarray([p, p])
        assert arr.shape == (2,) and arr.dtype == object

    def test_imatmul_unsupported(self):
        p = rand_pulse_sequence(2, 2)
        q = rand_pulse_sequence(2, 2)
        with pytest.raises(NotImplementedError):
            p @= q


class TestExplicitCacheSeeding:
    def test_reference_constructor_negative_matrix(self):
        """The full negative surface the reference constructor test pins
        (reference tests/test_core.py:42-222)."""
        base = rand_pulse_sequence(2, 5, 3, 3)
        X = sigma[1]

        def H_c():
            return [[o, c, i] for o, c, i in
                    zip(base.c_opers, base.c_coeffs,
                        base.c_oper_identifiers)]

        def H_n():
            return [[o, c, i] for o, c, i in
                    zip(base.n_opers, base.n_coeffs,
                        base.n_oper_identifiers)]

        dt = np.asarray(base.dt)
        # missing dt
        with pytest.raises(TypeError):
            ff.PulseSequence(H_c(), H_n())
        # dt scalar
        with pytest.raises(TypeError):
            ff.PulseSequence(H_c(), H_n(), dt[0])
        # control / noise Hamiltonian not a sequence
        with pytest.raises(TypeError):
            ff.PulseSequence(15, H_n(), dt)
        with pytest.raises(TypeError):
            ff.PulseSequence(H_c(), 15, dt)
        # Hamiltonian element not a sequence
        for bad in ({'oper': X}, 15):
            hc = H_c()
            hc[1] = bad
            with pytest.raises(TypeError):
                ff.PulseSequence(hc, H_n(), dt)
            hn = H_n()
            hn[1] = bad
            with pytest.raises(TypeError):
                ff.PulseSequence(H_c(), hn, dt)
        # operator of wrong type
        hc = H_c()
        hc[0][0] = {'no': 'oper'}
        with pytest.raises(TypeError):
            ff.PulseSequence(hc, H_n(), dt)
        # coefficients a scalar
        hc = H_c()
        hc[0][1] = float(hc[0][1][0])
        with pytest.raises(TypeError):
            ff.PulseSequence(hc, H_n(), dt)
        # operators not square
        hc = H_c()
        hc[0][0] = np.tile(np.asarray(hc[0][0]).reshape(1, 4), (2, 1))
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n(), dt)
        # control and noise dimensions differ
        hn = H_n()
        o = np.asarray(hn[0][0])
        hn = [[np.kron(np.eye(2), np.asarray(h[0])), h[1], h[2]]
              for h in H_n()]
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c(), hn, dt)
        del o
        # non-unique identifiers (control and noise)
        hc = H_c()
        hc[1][2] = hc[0][2]
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n(), dt)
        hn = H_n()
        hn[1][2] = hn[0][2]
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c(), hn, dt)
        # coefficient length != len(dt), both Hamiltonians
        hc = H_c()
        hc[0][1] = hc[0][1][:-2]
        with pytest.raises(ValueError):
            ff.PulseSequence(hc, H_n(), dt)
        hn = H_n()
        hn[0][1] = hn[0][1][:-2]
        with pytest.raises(ValueError):
            ff.PulseSequence(H_c(), hn, dt)
        # the valid pulse constructs, and __str__/__repr__ work
        pulse = ff.PulseSequence(H_c(), H_n(), dt)
        repr(pulse)
        str(pulse)

    def test_mixed_auto_and_explicit_identifiers(self):
        """Fewer identifiers than operators: auto names fill the gaps
        and sorting interleaves them (reference test_core.py:214-222)."""
        X, Y = sigma[1], sigma[2]
        pulse = ff.PulseSequence(
            [[X, [1], 'X'], [Y, [1]]],
            [[X, [1]], [Y, [1], 'Y']],
            [1])
        assert list(pulse.c_oper_identifiers) == ['A_1', 'X']
        assert list(pulse.n_oper_identifiers) == ['B_0', 'Y']

    def test_cache_filter_function_explicit_value(self):
        p1 = rand_pulse_sequence(2, 3)
        p2 = copy.copy(p1)
        p2.cleanup('all')
        omega = np.linspace(0.5, 5, 9)
        gen = p1.get_filter_function(omega, which='generalized')
        # seed the second pulse with the precomputed generalized FF
        p2.cache_filter_function(omega, filter_function=gen,
                                 which='generalized')
        assert p2.is_cached('generalized filter function')
        # fidelity FF must be derived from the seeded value by trace
        fid = to_np(p2.get_filter_function(omega))
        assert_allclose(fid, to_np(p1.get_filter_function(omega)),
                        atol=1e-14)

    def test_cache_control_matrix_explicit_value(self):
        p1 = rand_pulse_sequence(2, 3)
        p2 = copy.copy(p1)
        p2.cleanup('all')
        omega = np.linspace(0.5, 5, 9)
        ctrl = p1.get_control_matrix(omega)
        p2.cache_control_matrix(omega, ctrl)
        assert p2.is_cached('control matrix')
        # concatenation byproducts cached alongside
        assert p2.is_cached('total phases')
        assert p2.is_cached('total propagator liouville')
        assert_allclose(to_np(p2.get_filter_function(omega)),
                        to_np(p1.get_filter_function(omega)), atol=1e-14)


class TestSecondOrderFactoredRoute:
    """The separable-table (factored) route of the K2 lattice
    (FF_TPU_SO_FACTORED=1) must agree with the default lattice route;
    cf. numeric._second_order_factored_single.
    The factored route's divided-difference branch is exercised by an
    omega grid containing exact and near hits of omega = -Omega_mn."""

    def test_factored_matches_lattice(self, monkeypatch):
        import jax
        import jax.numpy as jnp
        from filter_functions_tpu import numeric
        from filter_functions_tpu.cplx import asc

        rng = np.random.default_rng(5)
        d, G, n_w, n_nops = 3, 4, 41, 2
        ev = rng.standard_normal((G, d))
        dt = 1 - rng.random(G)
        de = ev[0][:, None] - ev[0][None, :]
        omega = np.concatenate([
            np.geomspace(1e-1, 1e1, n_w - 1),
            [-de[0, 1]]])                           # one exact y == 0 hit
        n_b = d * d
        n_t = asc(rng.standard_normal((n_nops, G, d, d))
                  + 1j * rng.standard_normal((n_nops, G, d, d)))
        b_t = asc(rng.standard_normal((G, n_b, d, d))
                  + 1j * rng.standard_normal((G, n_b, d, d)))
        step = asc(rng.standard_normal((G, n_nops, n_b, len(omega)))
                   + 1j * rng.standard_normal((G, n_nops, n_b,
                                               len(omega))))
        cum = asc(rng.standard_normal((G, n_nops, n_b, len(omega)))
                  + 1j * rng.standard_normal((G, n_nops, n_b,
                                              len(omega))))
        w = rng.random((n_nops, len(omega)))
        args = (jnp.asarray(ev), n_t, b_t, step, cum,
                jnp.asarray(omega), jnp.asarray(dt), jnp.asarray(w))

        monkeypatch.delenv('FF_TPU_SO_FACTORED', raising=False)
        lattice = numeric._second_order_diag_shifts(*args).to_numpy()
        tot_lat = numeric._second_order_total(
            args[0], n_t, b_t, step, cum, args[5], args[6]).to_numpy()
        monkeypatch.setenv('FF_TPU_SO_FACTORED', '1')
        factored = numeric._second_order_diag_shifts(*args).to_numpy()
        tot_fac = numeric._second_order_total(
            args[0], n_t, b_t, step, cum, args[5], args[6]).to_numpy()

        # regular grid + exact y == 0 hits: the two routes agree to
        # rounding
        scale = np.abs(lattice).max()
        np.testing.assert_allclose(factored, lattice, atol=1e-11 * scale)
        scale_t = np.abs(tot_lat).max()
        np.testing.assert_allclose(tot_fac, tot_lat,
                                   atol=1e-11 * scale_t)

        # near-singular y (omega ~ -Omega_mn + eps): the lattice's
        # elementwise (f_x - f_z)/y sits at rounding scale / y, so the
        # routes may differ by ~1e-16/|y dt| relative -- with the
        # FACTORED divided-difference branch the accurate one.  Pin
        # the factored value against a dense-quadrature refinement:
        # both routes must agree loosely, and the factored route must
        # be at least as close to itself under a perturbed y (i.e.,
        # continuous), which the lattice is not at 1e-13.
        omega_s = np.concatenate([np.geomspace(1e-1, 1e1, n_w - 2),
                                  [-de[0, 1] + 1e-9, 1e-13]])
        args_s = (jnp.asarray(ev), n_t, b_t, step, cum,
                  jnp.asarray(omega_s), jnp.asarray(dt), jnp.asarray(w))
        monkeypatch.delenv('FF_TPU_SO_FACTORED', raising=False)
        lattice_s = numeric._second_order_diag_shifts(*args_s).to_numpy()
        monkeypatch.setenv('FF_TPU_SO_FACTORED', '1')
        factored_s = numeric._second_order_diag_shifts(*args_s).to_numpy()
        np.testing.assert_allclose(factored_s, lattice_s,
                                   atol=1e-2 * np.abs(lattice_s).max())
