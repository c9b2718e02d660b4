"""Gradient tests: the analytic (closed-form) infidelity derivative vs
central finite differences, vs the reference implementation, and vs
jax.grad through the whole split-complex pipeline (the autodiff path
the reference cannot offer)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import filter_functions_tpu as ff
from filter_functions_tpu import cplx, gradient, numeric
from conftest import HAVE_REFERENCE
from testutil import (assert_allclose, make_pulse, rand_pulse_arrays, rng,
                      sigma, to_np)


def finite_diff_infid(arrays, spectrum, omega, delta=1e-6):
    """Central finite differences of infidelity w.r.t. c_coeffs."""
    c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt = arrays
    n_ctrl, n_dt = c_coeffs.shape
    grad = np.zeros((len(n_opers), n_dt, n_ctrl))
    for h in range(n_ctrl):
        for g in range(n_dt):
            for sign in (+1, -1):
                cc = c_coeffs.copy()
                cc[h, g] += sign * delta
                pulse = make_pulse((c_opers, c_ids, cc, n_opers, n_ids,
                                    n_coeffs, dt))
                infid = np.asarray(ff.infidelity(pulse, spectrum, omega))
                grad[:, g, h] += sign * infid / (2 * delta)
    return grad


class TestGradient:
    def setup_method(self):
        self.arrays = rand_pulse_arrays(2, 4, n_cops=2, n_nops=2)
        self.omega = np.linspace(0.1, 30, 201)
        self.spectrum = 1e-3 / self.omega

    def test_against_finite_differences(self):
        pulse = make_pulse(self.arrays)
        grad_analytic = np.asarray(ff.infidelity_derivative(
            pulse, self.spectrum, self.omega))
        grad_fd = finite_diff_infid(self.arrays, self.spectrum, self.omega)
        # analytic output is identifier-sorted along the control axis;
        # finite differences perturbed the unsorted input arrays
        order = np.argsort(self.arrays[1])
        assert_allclose(grad_analytic, grad_fd[..., order], rtol=1e-5,
                        atol=1e-10)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_against_reference(self):
        import filter_functions as ref
        ours = make_pulse(self.arrays)
        theirs = make_pulse(self.arrays, cls=ref)
        got = np.asarray(ff.infidelity_derivative(ours, self.spectrum,
                                                  self.omega))
        want = ref.infidelity_derivative(theirs, self.spectrum, self.omega)
        assert_allclose(got, want, atol=1e-12)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_ff_derivative_against_reference(self):
        import filter_functions as ref
        ours = make_pulse(self.arrays)
        theirs = make_pulse(self.arrays, cls=ref)
        got = np.asarray(ours.get_filter_function_derivative(self.omega))
        want = theirs.get_filter_function_derivative(self.omega)
        assert_allclose(got, want, atol=1e-12)

    @pytest.mark.skipif(not HAVE_REFERENCE, reason='reference unavailable')
    def test_n_coeffs_deriv_against_reference(self):
        """Noise sensitivities depending on control amplitudes."""
        import filter_functions as ref
        ours = make_pulse(self.arrays)
        theirs = make_pulse(self.arrays, cls=ref)
        n_nops = len(ours.n_opers)
        n_ctrl = len(ours.c_opers)
        ncd = rng.standard_normal((n_nops, n_ctrl, len(ours)))
        got = np.asarray(ff.infidelity_derivative(
            ours, self.spectrum, self.omega, n_coeffs_deriv=ncd))
        want = ref.infidelity_derivative(theirs, self.spectrum, self.omega,
                                         n_coeffs_deriv=ncd)
        assert_allclose(got, want, atol=1e-12)

    def test_identifier_subset(self):
        pulse = make_pulse(self.arrays)
        c_ids = sorted(pulse.c_oper_identifiers)
        n_ids = sorted(pulse.n_oper_identifiers)
        full = np.asarray(ff.infidelity_derivative(pulse, self.spectrum,
                                                   self.omega))
        part = np.asarray(ff.infidelity_derivative(
            pulse, self.spectrum[:], self.omega,
            control_identifiers=[c_ids[1]], n_oper_identifiers=[n_ids[0]]))
        assert_allclose(part[0, :, 0], full[0, :, 1], atol=1e-12)


class TestGradientIdentifierMachinery:
    """Sorting/subset consistency of n_coeffs_deriv and identifier
    selection (cf. reference test_gradient.py:92-157) plus caching
    equivalence and error paths (:178-218)."""

    def test_n_coeffs_deriv_sorting(self):
        from testutil import rand_pulse_sequence
        pulse = rand_pulse_sequence(3, 4)
        omega = ff.util.get_sample_frequencies(pulse, n_samples=37)
        n_nops, n_ctrl, n_dt = (len(pulse.n_opers), len(pulse.c_opers),
                                len(pulse))
        ncd = rng.standard_normal((n_nops, n_ctrl, n_dt))
        n_ids = np.asarray(pulse.n_oper_identifiers)
        c_ids = np.asarray(pulse.c_oper_identifiers)

        n_unsort = rng.permutation(n_nops)
        c_unsort = rng.permutation(n_ctrl)
        n_choice = rng.choice(n_nops, 2, replace=False)
        c_choice = rng.choice(n_ctrl, 2, replace=False)

        grad = np.asarray(pulse.get_filter_function_derivative(
            omega, n_coeffs_deriv=ncd))
        grad_as_given = np.asarray(pulse.get_filter_function_derivative(
            omega, n_oper_identifiers=n_ids[n_unsort],
            control_identifiers=c_ids[c_unsort],
            n_coeffs_deriv=ncd[n_unsort[:, None], c_unsort]))
        grad_n = np.asarray(pulse.get_filter_function_derivative(
            omega, n_oper_identifiers=n_ids[n_choice],
            n_coeffs_deriv=ncd[n_choice]))
        grad_c = np.asarray(pulse.get_filter_function_derivative(
            omega, control_identifiers=c_ids[c_choice],
            n_coeffs_deriv=ncd[:, c_choice]))
        grad_nc = np.asarray(pulse.get_filter_function_derivative(
            omega, control_identifiers=c_ids[c_choice],
            n_oper_identifiers=n_ids[n_choice],
            n_coeffs_deriv=ncd[n_choice[:, None], c_choice]))

        all_dt = np.arange(n_dt)
        assert_allclose(grad[np.ix_(n_unsort, all_dt, c_unsort)],
                        grad_as_given, atol=1e-13)
        assert_allclose(grad[np.ix_(n_choice, all_dt)], grad_n, atol=1e-13)
        assert_allclose(grad[np.ix_(np.arange(n_nops), all_dt, c_choice)],
                        grad_c, atol=1e-13)
        assert_allclose(grad[np.ix_(n_choice, all_dt, c_choice)], grad_nc,
                        atol=1e-13)

    def test_intermediates_caching_equivalence(self):
        from testutil import rand_pulse_sequence
        pulse = rand_pulse_sequence(3, 4)
        omega = ff.util.get_sample_frequencies(pulse, n_samples=27)
        spect = 1 / omega

        pulse.cache_control_matrix(omega, cache_intermediates=False)
        infid_nocache = np.asarray(ff.infidelity(pulse, spect, omega))
        cm_nocache = np.asarray(to_np(
            gradient.calculate_derivative_of_control_matrix_from_scratch(
                omega, pulse.propagators, pulse.eigvals, pulse.eigvecs,
                pulse.basis, pulse.t, pulse.dt, pulse.n_opers_dev,
                pulse.n_coeffs, pulse.c_opers_dev, intermediates={})))

        pulse.cleanup('frequency dependent')
        pulse.cache_control_matrix(omega, cache_intermediates=True)
        infid_cache = np.asarray(ff.infidelity(pulse, spect, omega))
        cm_cache = np.asarray(to_np(
            gradient.calculate_derivative_of_control_matrix_from_scratch(
                omega, pulse.propagators, pulse.eigvals, pulse.eigvecs,
                pulse.basis, pulse.t, pulse.dt, pulse.n_opers_dev,
                pulse.n_coeffs, pulse.c_opers_dev,
                intermediates=dict(pulse.intermediates))))

        assert_allclose(infid_nocache, infid_cache, rtol=1e-12)
        assert_allclose(cm_nocache, cm_cache, atol=1e-13)

    def test_raises(self):
        from testutil import rand_pulse_sequence
        pulse = rand_pulse_sequence(2, 3)
        omega = ff.util.get_sample_frequencies(pulse, n_samples=13)
        with pytest.raises(ValueError):
            ff.infidelity_derivative(pulse, 1 / omega, omega,
                                     control_identifiers=['long string'])
        with pytest.raises(ValueError, match='n_coeffs_deriv'):
            pulse.get_filter_function_derivative(
                omega, n_coeffs_deriv=rng.standard_normal((2, 5, 10)))


class TestJaxGrad:
    """Automatic differentiation through the split-complex pipeline."""

    def test_jax_grad_matches_closed_form(self):
        arrays = rand_pulse_arrays(2, 3, n_cops=2, n_nops=1)
        c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt = arrays
        omega = np.linspace(0.1, 20, 101)
        spectrum = 1e-3 / omega
        basis = ff.Basis.ggm(2)

        def infid_fn(cc):
            ham = ff.util.ceinsum('jmn,jg->gmn', cplx.asc(c_opers), cc)
            eigvals, eigvecs, props = numeric.diagonalize(
                ham, jnp.asarray(dt))
            ctrl = numeric.calculate_control_matrix_from_scratch(
                eigvals, eigvecs, props, jnp.asarray(omega), basis,
                cplx.asc(n_opers), n_coeffs, dt)
            f = numeric.calculate_filter_function(ctrl)
            integrand = f.re[0, 0] * spectrum
            return ff.util.integrate(integrand, jnp.asarray(omega)) \
                / (2 * np.pi * 2)

        grad_ad = np.asarray(jax.grad(infid_fn)(jnp.asarray(c_coeffs)))

        pulse = make_pulse(arrays)
        grad_cf = np.asarray(ff.infidelity_derivative(pulse, spectrum,
                                                      omega))
        # closed form is (n_nops, n_dt, n_ctrl); AD is (n_ctrl, n_dt).
        # Sorting: pulse stores opers sorted by identifier; infid_fn used
        # the unsorted arrays, so match via the identifier order.
        order = np.argsort(c_ids)
        assert_allclose(grad_ad[order].T, grad_cf[0], rtol=1e-8,
                        atol=1e-12)

    def test_jax_grad_through_deep_factored_contraction(self,
                                                        monkeypatch):
        """jax.grad through the DEEP Ozaki regime (K = G d^2 > 1024:
        int32-factored D digit pipeline) must agree with
        the grad of the native-einsum contraction -- the factored path
        is round/int arithmetic whose literal gradient is zero, so
        this pins the ozaki_matmul_c_outer custom VJP inside the full
        control-matrix pipeline."""
        self._deep_ozaki_grad_parity(monkeypatch, factored='1')

    def test_jax_grad_through_deep_contraction(self, monkeypatch):
        """The same through the default deep Ozaki path (f32 P, f64 D):
        the ozaki_matmul_c custom VJP hands back cotangents in each
        operand's own dtype."""
        self._deep_ozaki_grad_parity(monkeypatch, factored='0')

    @staticmethod
    def _deep_ozaki_grad_parity(monkeypatch, factored):
        arrays = rand_pulse_arrays(4, 80, n_cops=2, n_nops=1)
        c_opers, c_ids, c_coeffs, n_opers, n_ids, n_coeffs, dt = arrays
        omega = np.linspace(0.1, 10, 11)
        basis = ff.Basis.ggm(4)
        assert 80 * 16 > 1024      # deep regime

        monkeypatch.setenv('FF_TPU_OZAKI_FACTORED', factored)

        def loss(cc, mode):
            monkeypatch.setenv('FF_TPU_CONTRACT', mode)
            try:
                ham = ff.util.ceinsum('jmn,jg->gmn', cplx.asc(c_opers),
                                      cc)
                eigvals, eigvecs, props = numeric.diagonalize(
                    ham, jnp.asarray(dt))
                ctrl = numeric.calculate_control_matrix_from_scratch(
                    eigvals, eigvecs, props, jnp.asarray(omega), basis,
                    cplx.asc(n_opers), n_coeffs, dt)
                return (ctrl.re**2 + ctrl.im**2).sum()
            finally:
                monkeypatch.delenv('FF_TPU_CONTRACT', raising=False)

        cc = jnp.asarray(c_coeffs)
        g_native = np.asarray(jax.grad(lambda c: loss(c, 'native'))(cc))
        g_ozaki = np.asarray(jax.grad(lambda c: loss(c, 'ozaki'))(cc))
        scale = np.abs(g_native).max()
        assert np.abs(g_ozaki - g_native).max() / scale < 1e-5
