"""Unit tests of the split-complex core (cplx.C and friends) against
native numpy complex arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from filter_functions_tpu import cplx
from testutil import assert_allclose, rng


def randc(*shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


class TestCAlgebra:
    def test_roundtrip(self):
        z = randc(3, 4)
        c = cplx.asc(z)
        assert_allclose(c.to_numpy(), z)
        assert c.shape == (3, 4)
        assert_allclose(c.conj().to_numpy(), z.conj())
        assert_allclose(c.H.to_numpy(), z.conj().T)

    def test_binary_ops(self):
        a, b = randc(4, 4), randc(4, 4)
        ca, cb = cplx.asc(a), cplx.asc(b)
        assert_allclose((ca + cb).to_numpy(), a + b)
        assert_allclose((ca - cb).to_numpy(), a - b)
        assert_allclose((ca * cb).to_numpy(), a * b)
        assert_allclose((ca / cb).to_numpy(), a / b)
        assert_allclose((ca @ cb).to_numpy(), a @ b, rtol=1e-13)
        assert_allclose((2.5 * ca).to_numpy(), 2.5 * a)
        assert_allclose((1j * ca).to_numpy(), 1j * a)
        assert_allclose((ca + 1).to_numpy(), a + 1)
        assert_allclose((1 - ca).to_numpy(), 1 - a)
        assert_allclose((1 / ca).to_numpy(), 1 / a)

    def test_real_array_mixing(self):
        a = randc(3, 3)
        r = rng.standard_normal((3, 3))
        assert_allclose((cplx.asc(a) * r).to_numpy(), a * r)
        assert_allclose((cplx.asc(a) @ r).to_numpy(), a @ r, rtol=1e-13)

    def test_exponentials(self):
        x = rng.standard_normal(100) * 10
        assert_allclose(cplx.cexp(x).to_numpy(), np.exp(1j * x), atol=1e-15)
        assert_allclose(cplx.cexpm1(x).to_numpy(), np.exp(1j * x) - 1,
                        atol=1e-15)
        tiny = np.array([1e-9, -1e-12, 0.0])
        assert_allclose(cplx.cexpm1(tiny).to_numpy(), np.expm1(1j * tiny),
                        rtol=1e-12, atol=1e-30)

    def test_reductions(self):
        z = randc(3, 5, 5)
        c = cplx.asc(z)
        assert_allclose(c.sum(axis=0).to_numpy(), z.sum(axis=0))
        assert_allclose(c.trace().to_numpy(), np.trace(z, axis1=-2,
                                                       axis2=-1))
        assert_allclose(c.cumsum(axis=0).to_numpy(), z.cumsum(axis=0))
        assert_allclose(cplx.abs2(c), np.abs(z)**2)


class TestContractions:
    def test_ceinsum2(self):
        a, b = randc(3, 4, 5), randc(5, 4)
        want = np.einsum('ijk,kj->ik', a, b)
        got = cplx.ceinsum2('ijk,kj->ik', cplx.asc(a), cplx.asc(b))
        assert_allclose(got.to_numpy(), want, rtol=1e-13)

    def test_ceinsum_multi(self):
        a, b, c = randc(4, 4), randc(4, 4), randc(4, 4)
        want = np.einsum('ab,bc,cd->ad', a, b, c)
        got = cplx.ceinsum('ab,bc,cd->ad', cplx.asc(a), cplx.asc(b),
                           cplx.asc(c))
        assert_allclose(got.to_numpy(), want, rtol=1e-12)

    def test_ceinsum_mixed_real(self):
        a = randc(3, 4)
        r = rng.standard_normal((4, 6))
        b = randc(6, 2)
        want = np.einsum('ij,jk,kl->il', a, r, b)
        got = cplx.ceinsum('ij,jk,kl->il', cplx.asc(a), r, cplx.asc(b))
        assert_allclose(got.to_numpy(), want, rtol=1e-12)

    def test_ceinsum_diagonal_subscripts(self):
        # repeated index within one operand (diagonal extraction)
        a = randc(10, 4, 4, 4, 4)
        b = randc(3, 4, 4)
        want = np.einsum('okmmn,amn->aokn', a, b)
        got = cplx.ceinsum('okmmn,amn->aokn', cplx.asc(a), cplx.asc(b))
        assert_allclose(got.to_numpy(), want, rtol=1e-12)

    def test_under_jit_and_vmap(self):
        a, b = randc(6, 3, 3), randc(6, 3, 3)

        def f(x, y):
            return (x @ y).trace()

        got = jax.jit(jax.vmap(f))(cplx.asc(a), cplx.asc(b))
        want = np.trace(a @ b, axis1=-2, axis2=-1)
        assert_allclose(got.to_numpy(), want, rtol=1e-13)


class TestLinalg:
    def test_solve(self):
        a = randc(4, 4) + 4 * np.eye(4)
        b = randc(4, 3)
        got = cplx.solve(cplx.asc(a), cplx.asc(b)).to_numpy()
        assert_allclose(got, np.linalg.solve(a, b), rtol=1e-11)

    def test_matrix_power(self):
        a = randc(3, 3) / 3
        for p in (0, 1, 2, 7, 16):
            got = cplx.matrix_power(cplx.asc(a), p).to_numpy()
            assert_allclose(got, np.linalg.matrix_power(a, p), rtol=1e-10,
                            atol=1e-14)

    @pytest.mark.parametrize('repeats', [1, 2, 3, 10, 1000])
    def test_geometric_series(self, repeats):
        # contractive T so the explicit sum is well conditioned
        t = randc(4, 4) * 0.2
        want = sum(np.linalg.matrix_power(t, g) for g in range(repeats))
        got = cplx.geometric_series(cplx.asc(t), repeats).to_numpy()
        assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_geometric_series_unitary(self):
        # unimodular phases * unitary: the reference's hard case where
        # (I - T) may be singular; binary doubling has no such issue.
        h = randc(3, 3)
        h = h + h.conj().T
        w, v = np.linalg.eigh(h)
        u = (v * np.exp(1j * w)) @ v.conj().T
        want = sum(np.linalg.matrix_power(u, g) for g in range(64))
        got = cplx.geometric_series(cplx.asc(u), 64).to_numpy()
        assert_allclose(got, want, rtol=1e-10, atol=1e-10)

    @pytest.mark.parametrize('d', [2, 3, 4, 6, 16])
    def test_eigh(self, d):
        h = randc(5, d, d)
        h = h + h.conj().swapaxes(-1, -2)
        w, v = cplx.eigh(cplx.asc(h))
        w, vn = np.asarray(w), v.to_numpy()
        assert_allclose(h @ vn, vn * w[..., None, :], atol=1e-12)
        assert_allclose(vn.conj().swapaxes(-1, -2) @ vn,
                        np.broadcast_to(np.eye(d), (5, d, d)), atol=1e-12)

    @pytest.mark.parametrize('d', [2, 4, 6])
    def test_eigh_embedded_matches(self, d):
        """The real-embedding path must agree with the native path
        up to degenerate-subspace gauge; check the invariants."""
        h = randc(3, d, d)
        h = h + h.conj().swapaxes(-1, -2)
        re, im = jnp.asarray(h.real), jnp.asarray(h.imag)
        w, vx, vy = cplx._eigh_embedded(re, im)
        vn = np.asarray(vx) + 1j * np.asarray(vy)
        w = np.asarray(w)
        assert_allclose(h @ vn, vn * w[..., None, :], atol=1e-12)
        assert_allclose(w, np.linalg.eigvalsh(h), atol=1e-12)

    def test_eigh_embedded_degenerate(self):
        h = np.zeros((2, 4, 4), complex)
        h[1] = np.diag([1., 1., 5., 5.])
        w, vx, vy = cplx._eigh_embedded(jnp.asarray(h.real),
                                        jnp.asarray(h.imag))
        vn = np.asarray(vx) + 1j * np.asarray(vy)
        assert_allclose(vn.conj().swapaxes(-1, -2) @ vn,
                        np.broadcast_to(np.eye(4), (2, 4, 4)), atol=1e-12)
        assert_allclose(h @ vn, vn * np.asarray(w)[..., None, :],
                        atol=1e-12)

    def test_eigh_grad(self):
        """custom JVP: gradient of an eigenvalue-based loss vs finite
        differences."""
        h0 = randc(3, 3)
        h0 = h0 + h0.conj().T

        def loss(x):
            hre = jnp.asarray(h0.real) + x * jnp.eye(3)
            w, _ = cplx.eigh(cplx.C(hre, jnp.asarray(h0.imag)))
            return (w**2).sum()

        g = jax.grad(loss)(0.0)
        eps = 1e-6
        fd = (loss(eps) - loss(-eps)) / (2 * eps)
        assert_allclose(g, fd, rtol=1e-5)


class TestOzaki:
    """ops.ozaki: accuracy, K-adaptivity, batching, gradients."""

    def test_accuracy(self):
        from filter_functions_tpu.ops.ozaki import (DEFAULT_PRECISION_BITS,
                                                    ozaki_matmul)
        # Per-test RNG: the shared module RNG makes draws depend on test
        # execution order, which made this flake under the full suite.
        local = np.random.default_rng(seed=7)
        for (m, k, n) in [(32, 64, 16), (20, 300, 10), (8, 4000, 8)]:
            a = local.standard_normal((m, k)) \
                * np.exp(local.standard_normal((m, 1)) * 4)
            b = local.standard_normal((k, n)) \
                * np.exp(local.standard_normal((1, n)) * 4)
            want = a @ b
            # The Ozaki truncation guarantee is relative to the row*col
            # *magnitude* sum |a|@|b| (cancellation-heavy entries can
            # exceed any bound stated relative to |a@b|).
            scale = (np.abs(a) @ np.abs(b)).max()
            # default truncation: ~2^-bits of the magnitude scale
            got = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
            rel = np.abs(got - want).max() / scale
            assert rel < 2**-DEFAULT_PRECISION_BITS * 16, (k, rel)
            # explicit high precision tightens accordingly
            got48 = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b),
                                            48))
            rel48 = np.abs(got48 - want).max() / scale
            assert rel48 < 1e-13, (k, rel48)

    def test_batched(self):
        from filter_functions_tpu.ops.ozaki import (DEFAULT_PRECISION_BITS,
                                                    ozaki_matmul)
        a = rng.standard_normal((4, 10, 128))
        b = rng.standard_normal((4, 128, 6))
        got = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
        # truncation is relative to the row*col magnitude, so elements
        # that cancel need a magnitude-scaled atol
        tol = 2**-DEFAULT_PRECISION_BITS * 16
        scale = (np.abs(a) @ np.abs(b)).max()
        assert_allclose(got, a @ b, rtol=tol, atol=tol * scale)

    def test_gradients(self):
        from filter_functions_tpu.ops.ozaki import (DEFAULT_PRECISION_BITS,
                                                    ozaki_matmul)
        a = jnp.asarray(rng.standard_normal((6, 12)))
        b = jnp.asarray(rng.standard_normal((12, 5)))
        g = jax.grad(lambda a: (ozaki_matmul(a, b, 30)**2).sum())(a)
        want = 2 * (np.asarray(a) @ np.asarray(b)) @ np.asarray(b).T
        # explicit 30-bit precision: this test pins the custom-VJP
        # machinery, not the (performance-tuned) default truncation
        assert_allclose(np.asarray(g), want, rtol=2**-30 * 64, atol=1e-9)

    def test_contraction_mode_equivalence(self):
        """The ozaki control-matrix path equals the native einsum."""
        import os
        from filter_functions_tpu import functional
        from testutil import rand_pulse_sequence
        pulse = rand_pulse_sequence(2, 4)
        omega = jnp.linspace(0.5, 10, 16)
        p = functional.make_pulse_arrays(pulse)
        old = os.environ.get('FF_TPU_CONTRACT')
        try:
            os.environ['FF_TPU_CONTRACT'] = 'native'
            native = functional.control_matrix(p, omega).to_numpy()
            os.environ['FF_TPU_CONTRACT'] = 'ozaki'
            oz = functional.control_matrix(p, omega).to_numpy()
        finally:
            if old is None:
                os.environ.pop('FF_TPU_CONTRACT', None)
            else:
                os.environ['FF_TPU_CONTRACT'] = old
        from filter_functions_tpu.ops.ozaki import DEFAULT_PRECISION_BITS
        # tolerance tracks the default truncation level; the 1e-10
        # application contract is pinned by the integral-averaged
        # infidelity parity tests (test_precision.py)
        np.testing.assert_allclose(oz, native,
                                   atol=2**-DEFAULT_PRECISION_BITS * 16)


class TestExpmReal:
    """Taylor scaling-and-squaring matrix exponential vs scipy
    (solve-free, unlike jax.scipy's Pade form)."""

    @pytest.mark.parametrize('scale', [1e-8, 1e-3, 1.0, 10.0])
    @pytest.mark.parametrize('n', [4, 16, 64])
    def test_against_scipy(self, scale, n):
        from scipy import linalg as sla
        local = np.random.default_rng(int(scale * 1e9) % 2**31 + n)
        a = local.standard_normal((n, n)) * scale
        got = np.asarray(cplx.expm_real(a))
        want = sla.expm(a)
        rel = np.abs(got - want).max() / max(np.abs(want).max(), 1)
        assert rel < 1e-12

    def test_zero_identity_batch_jit(self):
        from scipy import linalg as sla
        import jax
        assert_allclose(np.asarray(cplx.expm_real(np.zeros((3, 3)))),
                        np.eye(3), atol=0)
        local = np.random.default_rng(4)
        b = local.standard_normal((5, 8, 8))
        got = np.asarray(cplx.expm_real(b))
        want = np.stack([sla.expm(x) for x in b])
        assert_allclose(got, want, atol=1e-12)
        a = local.standard_normal((16, 16))
        assert_allclose(np.asarray(jax.jit(cplx.expm_real)(a)),
                        sla.expm(a), atol=1e-12)

    def test_huge_norm_stays_finite(self):
        """Skew-symmetric with astronomic norm: phase is unrecoverable
        in f64 (the input ulp exceeds 2 pi) but the result must not
        overflow to inf/nan."""
        a = np.array([[0.0, 1e21], [-1e21, 0.0]])
        got = np.asarray(cplx.expm_real(a))
        assert np.isfinite(got).all()
        # moderate norms keep structure: rotations stay orthogonal
        a = np.array([[0.0, 1e6], [-1e6, 0.0]])
        got = np.asarray(cplx.expm_real(a))
        assert np.abs(got @ got.T - np.eye(2)).max() < 1e-8


def test_ozaki_cmul_variants_agree(monkeypatch):
    """The 4-multiplication complex Ozaki form (FF_TPU_OZAKI_CMUL=4;
    one fewer slicing, one more matmul set -- measured slower on the
    flagship, kept as a documented experiment) matches Gauss-3."""
    import os
    from filter_functions_tpu.ops.ozaki import (DEFAULT_PRECISION_BITS,
                                                ozaki_matmul_c)
    tol_bits = DEFAULT_PRECISION_BITS - 2
    local = np.random.default_rng(8)
    # NOTE: the env var is read at trace time, so the variant call must
    # use shapes not yet in the jit cache.
    a = local.standard_normal((96, 64)) + 1j * local.standard_normal((96, 64))
    b = local.standard_normal((64, 48)) + 1j * local.standard_normal((64, 48))
    g_re, g_im = ozaki_matmul_c(a.real, a.imag, b.real, b.imag)
    want = a @ b
    scale = np.abs(np.abs(a) @ np.abs(b)).max()
    assert np.abs(np.asarray(g_re) + 1j*np.asarray(g_im) - want).max() \
        < 2**-tol_bits * scale

    monkeypatch.setenv('FF_TPU_OZAKI_CMUL', '4')
    # The env var is resolved eagerly per call and passed as a static
    # argument, so REUSING the first call's shapes exercises that the
    # toggle actually switches executables (regression: it used to be
    # read at trace time and silently ignored after the first compile).
    f_re, f_im = ozaki_matmul_c(a.real, a.imag, b.real, b.imag)
    assert np.abs(np.asarray(f_re) + 1j*np.asarray(f_im) - want).max() \
        < 2**-tol_bits * scale
    a = local.standard_normal((80, 56)) + 1j * local.standard_normal((80, 56))
    b = local.standard_normal((56, 40)) + 1j * local.standard_normal((56, 40))
    f_re, f_im = ozaki_matmul_c(a.real, a.imag, b.real, b.imag)
    want = a @ b
    scale = np.abs(np.abs(a) @ np.abs(b)).max()
    assert np.abs(np.asarray(f_re) + 1j*np.asarray(f_im) - want).max() \
        < 2**-tol_bits * scale


class TestOzakiMxuModes:
    """FF_TPU_OZAKI_MXU selects the element type of the digit slice
    products: 'int8' (7-bit digits, exact int32 accumulation -- the
    default) or 'bf16'.  Both must meet
    the same truncation budget, and the toggle must take effect per
    call (it is resolved eagerly and passed as a static argument)."""

    @pytest.mark.parametrize('mode', ['int8', 'bf16'])
    def test_real_accuracy(self, mode, monkeypatch):
        from filter_functions_tpu.ops.ozaki import (DEFAULT_PRECISION_BITS,
                                                    ozaki_matmul)
        monkeypatch.setenv('FF_TPU_OZAKI_MXU', mode)
        local = np.random.default_rng(11)
        for (m, k, n) in [(24, 48, 16), (8, 3000, 8)]:
            a = local.standard_normal((m, k)) \
                * np.exp(local.standard_normal((m, 1)) * 4)
            b = local.standard_normal((k, n)) \
                * np.exp(local.standard_normal((1, n)) * 4)
            got = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
            scale = (np.abs(a) @ np.abs(b)).max()
            rel = np.abs(got - a @ b).max() / scale
            assert rel < 2**-DEFAULT_PRECISION_BITS * 16, (mode, k, rel)

    def test_modes_agree_complex(self, monkeypatch):
        from filter_functions_tpu.ops.ozaki import (DEFAULT_PRECISION_BITS,
                                                    ozaki_matmul_c)
        local = np.random.default_rng(12)
        a = local.standard_normal((40, 512)) \
            + 1j * local.standard_normal((40, 512))
        b = local.standard_normal((512, 24)) \
            + 1j * local.standard_normal((512, 24))
        want = a @ b
        scale = (np.abs(a) @ np.abs(b)).max()
        tol = 2**-(DEFAULT_PRECISION_BITS - 2) * scale
        for mode in ('int8', 'bf16'):
            # same shapes on purpose: pins that the env toggle switches
            # executables per call instead of reusing the jit cache
            monkeypatch.setenv('FF_TPU_OZAKI_MXU', mode)
            g_re, g_im = ozaki_matmul_c(a.real, a.imag, b.real, b.imag)
            err = np.abs(np.asarray(g_re) + 1j * np.asarray(g_im)
                         - want).max()
            assert err < tol, (mode, err, tol)

    @pytest.mark.parametrize('mode', ['int8', 'bf16'])
    def test_factored_outer(self, mode, monkeypatch):
        from filter_functions_tpu.ops.ozaki import ozaki_matmul_c_outer
        monkeypatch.setenv('FF_TPU_OZAKI_MXU', mode)
        local = np.random.default_rng(13)
        K, M, J, Cc = 2048, 24, 3, 16
        P = local.standard_normal((M, K)) + 1j * local.standard_normal(
            (M, K))
        B = local.standard_normal((K, J)) + 1j * local.standard_normal(
            (K, J))
        Cm = local.standard_normal((K, Cc)) + 1j * local.standard_normal(
            (K, Cc))
        B *= np.exp2(local.integers(-8, 8, (1, J)))
        Cm *= np.exp2(local.integers(-8, 8, (1, Cc)))
        D = (B[:, :, None] * Cm[:, None, :]).reshape(K, -1)
        want = P @ D
        re, im = ozaki_matmul_c_outer(
            jnp.asarray(P.real), jnp.asarray(P.imag),
            jnp.asarray(B.real), jnp.asarray(B.imag),
            jnp.asarray(Cm.real), jnp.asarray(Cm.imag))
        got = np.asarray(re) + 1j * np.asarray(im)
        scale = (np.abs(P) @ np.abs(D)).max()
        assert np.abs(got - want).max() / scale < 2**-22, mode


class TestOzakiRecomb:
    """FF_TPU_OZAKI_RECOMB selects how the int8 path widens and sums
    its per-level int32 matmul outputs: 'ds' (default) double-single
    two-float32 arithmetic on the VPU, 'f64' emulated-f64 widening.
    The ds path must reproduce the f64-path result to double-single
    accuracy (~2^-48 of the running sum: the int32 -> (hi, lo) f32
    split is exact and the power-of-two level scales round nothing)."""

    def test_ds_matches_f64_real(self, monkeypatch):
        from filter_functions_tpu.ops.ozaki import ozaki_matmul
        monkeypatch.setenv('FF_TPU_OZAKI_MXU', 'int8')
        local = np.random.default_rng(14)
        a = jnp.asarray(local.standard_normal((24, 3000))
                        * np.exp(local.standard_normal((24, 1)) * 4))
        b = jnp.asarray(local.standard_normal((3000, 16))
                        * np.exp(local.standard_normal((1, 16)) * 4))
        monkeypatch.setenv('FF_TPU_OZAKI_RECOMB', 'f64')
        want = np.asarray(ozaki_matmul(a, b))
        # same shapes on purpose: pins that the env toggle switches
        # executables per call instead of reusing the jit cache
        monkeypatch.setenv('FF_TPU_OZAKI_RECOMB', 'ds')
        got = np.asarray(ozaki_matmul(a, b))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 2**-44

    def test_ds_matches_f64_factored(self, monkeypatch):
        from filter_functions_tpu.ops.ozaki import ozaki_matmul_c_outer
        monkeypatch.setenv('FF_TPU_OZAKI_MXU', 'int8')
        local = np.random.default_rng(15)
        K, M, J, Cc = 2048, 16, 3, 16
        P = local.standard_normal((M, K)) + 1j * local.standard_normal(
            (M, K))
        B = local.standard_normal((K, J)) + 1j * local.standard_normal(
            (K, J))
        Cm = local.standard_normal((K, Cc)) + 1j * local.standard_normal(
            (K, Cc))
        args = [jnp.asarray(x) for x in (P.real, P.imag, B.real, B.imag,
                                         Cm.real, Cm.imag)]
        monkeypatch.setenv('FF_TPU_OZAKI_RECOMB', 'f64')
        w_re, w_im = ozaki_matmul_c_outer(*args)
        monkeypatch.setenv('FF_TPU_OZAKI_RECOMB', 'ds')
        g_re, g_im = ozaki_matmul_c_outer(*args)
        want = np.asarray(w_re) + 1j * np.asarray(w_im)
        got = np.asarray(g_re) + 1j * np.asarray(g_im)
        assert np.abs(got - want).max() / np.abs(want).max() < 2**-44


class TestDWordDigits:
    """ops/ozaki._d_word_digits, the int32 D-digit pipeline of the
    factored contraction, must be BIT-EXACT against a plain NumPy
    transcription of the same split/word/shift/peel arithmetic."""

    def _numpy_reference(self, zbr, zbi, zcr, zci, n_d, slice_bits):
        from filter_functions_tpu.ops import ozaki
        K, J = zbr.shape
        C = zcr.shape[1]
        sb1, sb0 = ozaki._split12(zbr)
        si1, si0 = ozaki._split12(zbi)
        sc1, sc0 = ozaki._split12(zcr)
        sd1, sd0 = ozaki._split12(zci)

        def outer(b1, b0, c1, c0):
            p2 = b1[:, :, None] * c1[:, None, :]
            p1 = (b1[:, :, None] * c0[:, None, :]
                  + b0[:, :, None] * c1[:, None, :])
            p0 = b0[:, :, None] * c0[:, None, :]
            return (p2 << 6) + (
                (p1 + ((p0 + (1 << 11)) >> 12) + (1 << 5)) >> 6)

        w_rr = outer(sb1, sb0, sc1, sc0)
        w_ii = outer(si1, si0, sd1, sd0)
        w_ri = outer(sb1, sb0, sd1, sd0)
        w_ir = outer(si1, si0, sc1, sc0)
        comps = (w_rr - w_ii, w_ri + w_ir,
                 (w_rr - w_ii) + (w_ri + w_ir))
        nbits = n_d * slice_bits
        digits, shifts = [], []
        for w in comps:
            w = w.reshape(K, J * C)
            colmax = np.abs(w).max(0)
            e_w = np.ceil(np.log2(np.maximum(colmax, 1).astype(
                np.float64))).astype(np.int32)
            shift = min(nbits, 30) - 1 - e_w
            ls = np.maximum(shift, 0)[None, :]
            rs = np.maximum(-shift, 0)[None, :]
            half = (np.int32(1) << rs) >> 1
            z = ((w << ls) + half) >> rs
            sl = []
            for k in range(n_d - 1, 0, -1):
                sh = slice_bits * k
                d = (z + (1 << (sh - 1))) >> sh
                sl.append(d.astype(np.int8))
                z = z - (d << sh)
            sl.append(z.astype(np.int8))
            digits.append(np.stack(sl))
            shifts.append(shift)
        return np.stack(digits), np.stack(shifts)

    @pytest.mark.parametrize('K, J, C, n_d, slice_bits', [
        (512, 3, 128, 4, 7),
        (2048, 18, 16, 5, 6),
        (3328, 18, 64, 5, 7),
    ])
    def test_digits_bit_exact(self, K, J, C, n_d, slice_bits):
        from filter_functions_tpu.ops import ozaki
        local = np.random.default_rng(16)
        mk = lambda shape: local.integers(-2**23, 2**23, shape,
                                          dtype=np.int32)
        zbr, zbi, zcr, zci = mk((K, J)), mk((K, J)), mk((K, C)), \
            mk((K, C))
        outs = ozaki._d_word_digits(
            jnp.asarray(zbr), jnp.asarray(zbi), jnp.asarray(zcr),
            jnp.asarray(zci), n_d, slice_bits)
        want_d, want_s = self._numpy_reference(zbr, zbi, zcr, zci, n_d,
                                               slice_bits)
        for t, (digits, shift) in enumerate(outs):
            assert np.array_equal(np.asarray(shift), want_s[t])
            assert np.array_equal(np.stack([np.asarray(d)
                                            for d in digits]), want_d[t])


class TestOzakiOuterGrad:
    """ozaki_matmul_c_outer is reverse-mode differentiable via a
    custom VJP (the digit pipeline is round/int arithmetic with zero
    literal gradients): the backward pass applies the product rule on (P, B, C) -> P @ D and
    must match finite differences."""

    def test_grad_matches_finite_diff(self):
        from filter_functions_tpu.ops.ozaki import ozaki_matmul_c_outer
        local = np.random.default_rng(17)
        K, M, J, Cc = 512, 4, 2, 3     # K > 256 engages the factored path
        P = local.standard_normal((M, K)) + 1j * local.standard_normal(
            (M, K))
        B = local.standard_normal((K, J)) + 1j * local.standard_normal(
            (K, J))
        Cm = local.standard_normal((K, Cc)) + 1j * local.standard_normal(
            (K, Cc))
        w_re = local.standard_normal((M, J * Cc))
        w_im = local.standard_normal((M, J * Cc))

        def loss(p_re, p_im, b_re, b_im, c_re, c_im):
            o_re, o_im = ozaki_matmul_c_outer(p_re, p_im, b_re, b_im,
                                              c_re, c_im)
            return jnp.sum(w_re * o_re + w_im * o_im)

        args = [jnp.asarray(x) for x in (P.real, P.imag, B.real, B.imag,
                                         Cm.real, Cm.imag)]
        grads = jax.grad(loss, argnums=tuple(range(6)))(*args)

        # analytic expectation from the closed form of the loss
        W = w_re + 1j * w_im
        D = (B[:, :, None] * Cm[:, None, :]).reshape(K, -1)
        dP = W @ np.conj(D).T
        dD = np.conj(P).T @ W
        dDf = dD.reshape(K, J, Cc)
        dB = (dDf * np.conj(Cm)[:, None, :]).sum(-1)
        dC = (dDf * np.conj(B)[:, :, None]).sum(-2)
        for got, want in zip(grads, (dP.real, dP.imag, dB.real, dB.imag,
                                     dC.real, dC.imag)):
            scale = np.abs(want).max()
            assert np.abs(np.asarray(got) - want).max() / scale < 1e-6

        # spot finite-difference check on one B entry.  The forward is
        # 23-bit QUANTIZED, so central differences carry quantization
        # jumps of order 2^-23/eps ~ 1% -- this only pins the gradient
        # to the right value and sign, the analytic check above is the
        # precision assertion.
        eps = 1e-5
        bre = np.asarray(args[2])
        bp, bm = bre.copy(), bre.copy()
        bp[7, 1] += eps
        bm[7, 1] -= eps
        fd = (loss(args[0], args[1], jnp.asarray(bp), args[3], args[4],
                   args[5])
              - loss(args[0], args[1], jnp.asarray(bm), args[3],
                     args[4], args[5])) / (2 * eps)
        assert abs(float(fd) - float(grads[2][7, 1])) < 5e-2 * max(
            1.0, abs(float(fd)))


class TestOzakiFactored:
    """ops.ozaki.ozaki_matmul_c_outer: the factored-operand complex
    matmul whose D = B (*) C digit slices come from native int32
    arithmetic (the flagship deep-reduction fast path)."""

    def _case(self, K, M=40, J=3, Cc=16, seed=0):
        local = np.random.default_rng(seed)
        P = local.standard_normal((M, K)) + 1j * local.standard_normal(
            (M, K))
        B = local.standard_normal((K, J)) + 1j * local.standard_normal(
            (K, J))
        Cm = local.standard_normal((K, Cc)) + 1j * local.standard_normal(
            (K, Cc))
        # exercise the per-column power-of-two scale tracking
        B *= np.exp2(local.integers(-8, 8, (1, J)))
        Cm *= np.exp2(local.integers(-8, 8, (1, Cc)))
        return P, B, Cm

    @pytest.mark.parametrize('K', [2048, 3328, 8192])
    def test_accuracy(self, K):
        from filter_functions_tpu.ops.ozaki import ozaki_matmul_c_outer
        P, B, Cm = self._case(K)
        D = (B[:, :, None] * Cm[:, None, :]).reshape(K, -1)
        want = P @ D
        re, im = ozaki_matmul_c_outer(
            jnp.asarray(P.real), jnp.asarray(P.imag),
            jnp.asarray(B.real), jnp.asarray(B.imag),
            jnp.asarray(Cm.real), jnp.asarray(Cm.imag))
        got = np.asarray(re) + 1j * np.asarray(im)
        scale = (np.abs(P) @ np.abs(D)).max()
        assert np.abs(got - want).max() / scale < 2**-22

    def test_shallow_k_rejected(self):
        from filter_functions_tpu.ops.ozaki import ozaki_matmul_c_outer
        P, B, Cm = self._case(256)
        with pytest.raises(ValueError, match='slice_bits'):
            ozaki_matmul_c_outer(
                jnp.asarray(P.real), jnp.asarray(P.imag),
                jnp.asarray(B.real), jnp.asarray(B.imag),
                jnp.asarray(Cm.real), jnp.asarray(Cm.imag))

    def test_depth_policy(self):
        """Shallow contractions keep full-precision 30-bit f64
        assembly; only the deep regime (slice width 5-6) runs the
        fast path (measured regression: the 24-bit default leaked
        into d=2 raw filter functions at 9e-6 parity)."""
        from filter_functions_tpu.ops.ozaki import (
            DEEP_PRECISION_BITS, DEFAULT_PRECISION_BITS, _slice_params)
        assert DEFAULT_PRECISION_BITS >= 30
        assert DEEP_PRECISION_BITS <= DEFAULT_PRECISION_BITS
        # d=2 pulses: K = 4 G stays shallow for any realistic train
        assert _slice_params(4 * 32, DEFAULT_PRECISION_BITS)[0] not in \
            (5, 6)
        # the flagship K = 13 * 256 lands in the deep window
        assert _slice_params(13 * 256, DEFAULT_PRECISION_BITS)[0] in \
            (5, 6)


class TestEigh2x2:
    """Closed-form d = 2 eigendecomposition (cplx._eigh_2x2): exact
    invariants and eigenvalue agreement with LAPACK across the branch
    structure (off-diagonal-dominant, diagonal-dominant both signs,
    exactly diagonal, proportional to identity)."""

    def _check(self, h):
        w, vre, vim = cplx._eigh_2x2(jnp.asarray(h.real),
                                     jnp.asarray(h.imag))
        w, v = np.asarray(w), np.asarray(vre) + 1j * np.asarray(vim)
        assert_allclose(h @ v, v * w[..., None, :], atol=1e-13)
        eye = np.broadcast_to(np.eye(2), h.shape)
        assert_allclose(v.conj().swapaxes(-1, -2) @ v, eye, atol=1e-13)
        assert_allclose(w, np.linalg.eigvalsh(h), atol=1e-13)

    def test_random(self):
        h = randc(64, 2, 2)
        self._check(h + h.conj().swapaxes(-1, -2))

    def test_branches(self):
        cases = np.array([
            [[0.0, 1.0], [1.0, 0.0]],              # pure off-diagonal
            [[5.0, 1e-3j], [-1e-3j, -5.0]],        # diag-dominant, a > c
            [[-5.0, 1e-3], [1e-3, 5.0]],           # diag-dominant, a < c
            [[2.0, 0.0], [0.0, -1.0]],             # exactly diagonal
            [[3.0, 0.0], [0.0, 3.0]],              # proportional to I
        ], dtype=complex)
        self._check(cases)

    def test_pipeline_uses_it(self):
        # d = 2 propagators through the full public path stay exact
        from math import pi
        import filter_functions_tpu as ff
        X, Z = np.array([[0, 1], [1, 0]], complex), np.diag([1., -1.])
        p = ff.PulseSequence([[X / 2, [pi], 'X']],
                             [[Z.astype(complex) / 2, [1], 'Z']], [1])
        u = np.asarray(p.total_propagator.to_numpy())
        want = np.cos(pi / 2) * np.eye(2) - 1j * np.sin(pi / 2) * X
        assert_allclose(u, want, atol=1e-13)


class TestEighRefined:
    """f32-seed + Newton-refinement eigendecomposition
    (cplx._eigh_refined): the default d > 2 path on no-complex
    backends.  Invariants at f64 level for all sane spectra, bounded
    backward error (<= the gap) for pathological near-degeneracies."""

    def _run(self, h):
        w, vre, vim = jax.jit(cplx._eigh_refined)(
            jnp.asarray(h.real), jnp.asarray(h.imag))
        return np.asarray(w), np.asarray(vre) + 1j * np.asarray(vim)

    def _check(self, h, res_atol=5e-13):
        scale = max(np.abs(np.linalg.eigvalsh(h)).max(), 1e-300)
        w, v = self._run(h)
        assert np.abs(h @ v - v * w[..., None, :]).max() <= \
            res_atol * scale
        eye = np.broadcast_to(np.eye(h.shape[-1]), h.shape)
        assert np.abs(v.conj().swapaxes(-1, -2) @ v - eye).max() < 5e-13
        assert np.abs(w - np.linalg.eigvalsh(h)).max() <= \
            res_atol * scale
        assert (np.diff(w, axis=-1) >= -1e-12 * scale).all()

    def test_random_d16(self):
        h = randc(64, 16, 16)
        self._check(h + h.conj().swapaxes(-1, -2))

    def test_random_d4(self):
        h = randc(128, 4, 4)
        self._check(h + h.conj().swapaxes(-1, -2))

    def test_exact_degeneracy(self):
        # kron(h, I2): every eigenvalue exactly doubled
        h8 = randc(32, 8, 8)
        h8 = h8 + h8.conj().swapaxes(-1, -2)
        self._check(np.kron(h8, np.eye(2)))

    def test_trivial_spectra(self):
        self._check(np.zeros((4, 16, 16), complex))
        self._check(np.broadcast_to(3.0 * np.eye(16),
                                    (4, 16, 16)).astype(complex).copy())

    def test_large_scale(self):
        h = randc(8, 16, 16)
        self._check(1e6 * (h + h.conj().swapaxes(-1, -2)))

    def test_near_degenerate_backward_error(self):
        # Gaps below the cluster tolerance are treated as degenerate:
        # the residual (backward error) stays bounded by the gap, not
        # amplified by it.  Gaps just *above* the tolerance are as
        # hard as the eigenvector problem itself is ill-conditioned:
        # any f64 algorithm mixes the two vectors at the eps/gap level,
        # so orthonormality is only guaranteed to ~eps * scale / gap.
        local = np.random.default_rng(20260817)
        z = local.standard_normal((16, 16)) + \
            1j * local.standard_normal((16, 16))
        q, _ = np.linalg.qr(z)
        for gap in (1e-4, 1e-5, 1e-8):
            w0 = np.sort(local.standard_normal(16))
            w0[8] = w0[7] + gap
            h = (q * w0) @ q.conj().T
            h = (h + h.conj().T) / 2
            scale = np.abs(w0).max()
            w, v = self._run(h[None])
            res = np.abs(h @ v[0] - v[0] * w[0][None, :]).max()
            assert res <= max(2 * gap, 1e-12)
            eye = np.eye(16)
            ortho = np.abs(v[0].conj().T @ v[0] - eye).max()
            if gap < 4e-6 * scale:      # clustered: R/2 keeps V unitary
                assert ortho < 2e-12
            else:                       # conditioning floor eps/gap
                assert ortho < 200 * 2.3e-16 * scale / gap

    def test_matches_production_dispatch(self):
        # on no-complex backends _eigh_impl routes d > 2 through the
        # refined path by default (config.eigh_mode)
        from filter_functions_tpu import config
        assert config.eigh_mode() == 'refined'


class TestTransformDtype:
    """config.transform_dtype / the _ctrlmat_step_terms gate: an
    opt-in fast mode.  Default stays full precision (f32 rounding of
    the eigenvector frame is amplified ~1e4 through the eigenbasis-
    consistency of the integral kernel: measured 9e-7 flagship parity,
    so it must never switch on silently)."""

    def test_default_is_working_precision(self, monkeypatch):
        from filter_functions_tpu import config
        monkeypatch.delenv('FF_TPU_TRANSFORM_DTYPE', raising=False)
        # shallow and deep depths both stay at working precision
        assert config.transform_dtype(4 * 32) is None
        assert config.transform_dtype(13 * 256) is None

    def test_opt_in_modes(self, monkeypatch):
        from filter_functions_tpu import config
        monkeypatch.setenv('FF_TPU_TRANSFORM_DTYPE', 'f32')
        assert config.transform_dtype(4 * 32) == jnp.float32
        monkeypatch.setenv('FF_TPU_TRANSFORM_DTYPE', 'f32-deep')
        # deep-gated: also requires the ozaki factored contraction,
        # which is off on the CPU backend -- stays None here
        got = config.transform_dtype(13 * 256)
        if config.contraction_mode() == 'ozaki':
            assert got == jnp.float32
        else:
            assert got is None

    def test_f32_transforms_compute_correct_values(self, monkeypatch):
        """Forced f32: same result to f32-level accuracy (pins that the
        cast path computes the same quantity, not that it meets the
        1e-10 contract -- it does not, by design)."""
        from filter_functions_tpu import functional
        from testutil import rand_pulse_sequence
        pulse = rand_pulse_sequence(4, 6)
        p = functional.make_pulse_arrays(pulse)
        omega = jnp.linspace(0.5, 10, 24)
        monkeypatch.delenv('FF_TPU_TRANSFORM_DTYPE', raising=False)
        want = functional.control_matrix(p, omega).to_numpy()
        monkeypatch.setenv('FF_TPU_TRANSFORM_DTYPE', 'f32')
        got = functional.control_matrix(p, omega).to_numpy()
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert 0 < rel < 1e-4


class TestTransformMxu:
    """config.transform_mxu / numeric._conjugate_mxu: the EXACT-path
    MXU conjugation (error-free digit slices of the f64 frame; only
    ~2^-30 post-hoc result noise, unlike the f32 frame downcast)."""

    def test_gate_defaults(self, monkeypatch):
        from filter_functions_tpu import config
        monkeypatch.delenv('FF_TPU_TRANSFORM_MXU', raising=False)
        if config.contraction_mode() != 'ozaki':
            # CPU backend: off regardless of depth
            assert not config.transform_mxu(13 * 256)
        monkeypatch.setenv('FF_TPU_TRANSFORM_MXU', '1')
        assert config.transform_mxu(4)
        monkeypatch.setenv('FF_TPU_TRANSFORM_MXU', '0')
        assert not config.transform_mxu(13 * 256)

    def test_conjugation_matches_einsum(self, monkeypatch):
        from filter_functions_tpu import functional
        from filter_functions_tpu import numeric
        from testutil import rand_pulse_sequence
        # direct unit check of the helper
        local = np.random.default_rng(21)
        G, d, n_k = 5, 8, 12
        w = local.standard_normal((G, d, d)) \
            + 1j * local.standard_normal((G, d, d))
        k = local.standard_normal((n_k, d, d)) \
            + 1j * local.standard_normal((n_k, d, d))
        want = np.einsum('gba,kbc,gcd->gkad', w.conj(), k, w)
        got = numeric._conjugate_mxu(cplx.asc(w), cplx.asc(k)).to_numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 2**-26

        # end-to-end: forcing the MXU path through the public pipeline
        pulse = rand_pulse_sequence(4, 6)
        p = functional.make_pulse_arrays(pulse)
        omega = jnp.linspace(0.5, 10, 24)
        monkeypatch.delenv('FF_TPU_TRANSFORM_MXU', raising=False)
        ref = functional.control_matrix(p, omega).to_numpy()
        monkeypatch.setenv('FF_TPU_TRANSFORM_MXU', '1')
        got = functional.control_matrix(p, omega).to_numpy()
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel < 1e-8


class TestConjugateD2:
    """numeric._conjugate_d2: the d = 2 closed-form SU(2) -> SO(3)
    conjugation route (no matmuls) must reproduce the einsum
    V^dag K V to machine precision for generic U(2) frames (arbitrary
    global phase), per-g operand stacks, and degenerate frames
    (diagonal/antidiagonal/identity/pure-phase unitaries, which
    exercise the det-sqrt branch selection)."""

    def _unitaries(self, local, G):
        from scipy.linalg import expm
        vs = []
        for _ in range(G):
            h = local.standard_normal((2, 2)) \
                + 1j * local.standard_normal((2, 2))
            h = h + h.conj().T
            vs.append(expm(1j * h) * np.exp(1j * local.standard_normal()))
        return np.stack(vs)

    def test_matches_einsum(self):
        from filter_functions_tpu import numeric
        from filter_functions_tpu.cplx import asc
        local = np.random.default_rng(21)
        V = self._unitaries(local, 7)
        K = local.standard_normal((5, 2, 2)) \
            + 1j * local.standard_normal((5, 2, 2))
        want = np.einsum('gba,kbc,gcd->gkad', V.conj(), K, V)
        got = numeric._conjugate_d2(asc(V), asc(K)).to_numpy()
        assert_allclose(got, want, atol=1e-13 * np.abs(want).max())

    def test_per_g_operands(self):
        from filter_functions_tpu import numeric
        from filter_functions_tpu.cplx import asc
        local = np.random.default_rng(22)
        V = self._unitaries(local, 6)
        K = local.standard_normal((6, 4, 2, 2)) \
            + 1j * local.standard_normal((6, 4, 2, 2))
        want = np.einsum('gba,gkbc,gcd->gkad', V.conj(), K, V)
        got = numeric._conjugate_d2(asc(V), asc(K)).to_numpy()
        assert_allclose(got, want, atol=1e-13 * np.abs(want).max())

    def test_degenerate_frames(self):
        from scipy.linalg import expm
        from filter_functions_tpu import numeric
        from filter_functions_tpu.cplx import asc
        local = np.random.default_rng(23)
        V = np.stack([np.diag([1, -1]).astype(complex),      # det -1
                      np.array([[0, 1], [1, 0]], complex),   # det -1
                      np.array([[0, -1j], [1j, 0]]),         # sigma_y
                      np.eye(2, dtype=complex),
                      np.diag([1j, 1j]),                     # det -1, im 0
                      expm(1j * np.pi * np.diag([0.5, -0.5]))])
        K = local.standard_normal((3, 2, 2)) \
            + 1j * local.standard_normal((3, 2, 2))
        want = np.einsum('gba,kbc,gcd->gkad', V.conj(), K, V)
        got = numeric._conjugate_d2(asc(V), asc(K)).to_numpy()
        assert_allclose(got, want, atol=1e-13 * np.abs(want).max())

    def test_gradient_flows(self):
        """The route sits on the GRAPE/differentiation path.  The
        einsum V^dag K V and the SO(3) form agree as functions only ON
        the unitary manifold (off it, V^dag . V is not a rotation), so
        their full Jacobians differ in non-tangent directions -- what
        must match is the derivative along any UNITARY tangent
        dV = i H V (H Hermitian), which is what flows through a
        physically parametrized pipeline (V from eigh of a
        parametrized Hamiltonian)."""
        import jax
        import jax.numpy as jnp
        from filter_functions_tpu import numeric
        from filter_functions_tpu.cplx import asc, ceinsum
        local = np.random.default_rng(24)
        V = self._unitaries(local, 3)
        K = local.standard_normal((2, 2, 2)) \
            + 1j * local.standard_normal((2, 2, 2))
        Kc = asc(K)
        h = local.standard_normal((3, 2, 2)) \
            + 1j * local.standard_normal((3, 2, 2))
        h = h + h.conj().swapaxes(-1, -2)
        dV = 1j * h @ V                                # unitary tangent

        # weighted loss: the plain Frobenius norm is unitarily
        # INVARIANT (derivative identically zero along any unitary
        # tangent), so weight the elements to get a nontrivial one
        wt = jnp.asarray(local.standard_normal((3, 2, 2, 2)))

        def loss_d2(vre, vim):
            out = numeric._conjugate_d2(cplx.C(vre, vim), Kc)
            return ((out.re + 0.5 * out.im) * wt).sum()

        def loss_einsum(vre, vim):
            v = cplx.C(vre, vim)
            out = ceinsum('gba,kbc,gcd->gkad', v.conj(), Kc, v)
            return ((out.re + 0.5 * out.im) * wt).sum()

        prim = (jnp.asarray(V.real), jnp.asarray(V.imag))
        tang = (jnp.asarray(dV.real), jnp.asarray(dV.imag))
        val_d2, jvp_d2 = jax.jvp(loss_d2, prim, tang)
        val_es, jvp_es = jax.jvp(loss_einsum, prim, tang)
        assert np.isfinite(float(jvp_d2))
        assert_allclose(float(val_d2), float(val_es), rtol=1e-12)
        assert_allclose(float(jvp_d2), float(jvp_es), rtol=1e-9)
        # reverse mode is finite as well (grad of the composed
        # pipeline is exercised end-to-end by tests/test_gradient.py)
        g = jax.grad(loss_d2, argnums=(0, 1))(*prim)
        assert all(np.isfinite(np.asarray(x)).all() for x in g)
