"""The per-backend precision policy (config) and the compile cache.

The GPU policy is checked here on the CPU by reporting 'gpu' as the
backend: the policy is decided at trace time from ``config.backend()``,
so tracing (never compiling) under that report shows what a GPU runs.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from filter_functions_tpu import config, cplx, functional, numeric
from filter_functions_tpu.basis import Basis
from filter_functions_tpu.cplx import asc

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu_backend(monkeypatch):
    monkeypatch.setattr(config, 'backend', lambda: 'gpu')
    monkeypatch.delenv('FF_TPU_CONTRACT', raising=False)


def _herm_traceless(rng, k, d):
    a = rng.standard_normal((k, d, d)) + 1j * rng.standard_normal((k, d, d))
    a = (a + a.conj().swapaxes(-1, -2)) / 2
    return a - np.trace(a, axis1=-2, axis2=-1)[:, None, None] * np.eye(d) / d


def _pulse_arrays(d, G, batch, seed=0):
    rng = np.random.default_rng(seed)
    return functional.PulseArrays(
        asc(_herm_traceless(rng, 2, d)),
        jnp.asarray(rng.standard_normal((batch, 2, G))),
        asc(_herm_traceless(rng, 2, d)), jnp.ones((batch, 2, G)),
        jnp.ones((batch, G)), Basis.ggm(d).dev)


def test_gpu_policy_is_native(gpu_backend):
    """On a GPU: native float64 contraction, cuSOLVER complex eigh, and
    none of the emulation side paths (digit-slice transforms, float32
    second-order shifts, escalation)."""
    assert config.contraction_mode() == 'native'
    assert config.supports_native_complex()
    assert not config.transform_mxu(16 * 16 * 13)
    assert config.transform_dtype(16 * 16 * 13) is None
    assert functional._so_shift_dtype() is None
    assert functional._escalation_tol(_pulse_arrays(8, 32, 1)) == 0.0


def test_gpu_eigh_is_native_complex(gpu_backend):
    """d > 2 eigendecompositions take the complex128 eigh, not the
    float32-seeded real embedding."""
    h = asc(_herm_traceless(np.random.default_rng(1), 3, 4))
    jaxpr = jax.make_jaxpr(lambda re, im: cplx._eigh_impl(re, im))(
        h.re, h.im)
    dtypes = {str(v.aval.dtype) for eqn in _eqns(jaxpr.jaxpr)
              if eqn.primitive.name == 'eigh' for v in eqn.invars}
    assert dtypes == {'complex128'}


def test_override_still_selects_ozaki(gpu_backend, monkeypatch):
    """The ozaki override assembles D in float64 unless the factored
    variant (outside the 1e-10 contract on the flagship) is asked for,
    so no escalation is armed by default."""
    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    monkeypatch.delenv('FF_TPU_OZAKI_FACTORED', raising=False)
    assert config.contraction_mode() == 'ozaki'
    assert config.transform_mxu(16 * 16 * 13)
    assert not config.ozaki_factored()
    assert functional._escalation_tol(_pulse_arrays(8, 32, 1)) == 0.0
    monkeypatch.setenv('FF_TPU_OZAKI_FACTORED', '1')
    assert functional._escalation_tol(_pulse_arrays(8, 32, 1)) > 0.0


def _backend_names_compared(tree):
    """String constants compared against a ``backend()`` /
    ``default_backend()`` call anywhere in a module's AST."""
    names = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if not any(isinstance(s, ast.Call) and getattr(
                s.func, 'attr', getattr(s.func, 'id', '')) in (
                    'backend', 'default_backend') for s in sides):
            continue
        for side in sides:
            for const in ast.walk(side):
                if isinstance(const, ast.Constant) and isinstance(
                        const.value, str):
                    names.add(const.value)
    return names


def test_only_cpu_and_gpu_branches():
    """The package branches on no backend but the CPU and the GPU, and
    holds no Pallas kernel."""
    for path in (REPO / 'filter_functions_tpu').rglob('*.py'):
        tree = ast.parse(path.read_text())
        assert _backend_names_compared(tree) <= {'cpu', 'gpu'}, path
        imported = {alias.name for node in ast.walk(tree)
                    if isinstance(node, ast.Import) for alias in node.names}
        imported |= {node.module or '' for node in ast.walk(tree)
                     if isinstance(node, ast.ImportFrom)}
        assert not any('pallas' in name for name in imported), path


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else [value]):
                inner = getattr(sub, 'jaxpr', sub)
                if hasattr(inner, 'eqns'):
                    yield from _eqns(inner)


def _unpinned_f32_dots(jaxpr):
    """dot_generals whose operands are all float32 and that do not ask
    for full precision (a GPU runs those in TF32)."""
    bad = []
    for eqn in _eqns(jaxpr.jaxpr):
        if eqn.primitive.name != 'dot_general':
            continue
        dtypes = {v.aval.dtype for v in eqn.invars}
        precision = eqn.params.get('precision')
        if dtypes == {jnp.dtype('float32')} and precision != (
                jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST):
            bad.append(str(eqn)[:200])
    return bad


def _trace_infidelity():
    p = _pulse_arrays(8, 32, 2)
    omega = jnp.geomspace(1e-2, 1e2, 20)
    return jax.make_jaxpr(lambda p: functional.batched_infidelity(
        p, 1e-4 / omega, omega, chunk_size=1))(p)


def _trace_grad():
    p = _pulse_arrays(8, 32, 2)
    omega = jnp.geomspace(1e-2, 1e2, 20)
    return jax.make_jaxpr(jax.grad(
        lambda c: functional.batched_infidelity(
            p._replace(c_coeffs=c), 1e-4 / omega, omega,
            chunk_size=1).sum()))(p.c_coeffs)


def _trace_etm():
    d = 4
    p = _pulse_arrays(d, 8, 2)
    omega = jnp.geomspace(1e-1, 1e1, 20)
    s = jnp.broadcast_to(1e-4 / omega, (2, 20))
    tg, td = numeric._cumulant_trace_combos_dev(Basis.ggm(d))
    return jax.make_jaxpr(lambda p: functional._etm_batched(
        p, s, None, omega, tg, td, True, (0, 1),
        functional._so_shift_dtype()))(p)


def _trace_eigh_seed():
    h = asc(_herm_traceless(np.random.default_rng(2), 3, 4))
    return jax.make_jaxpr(cplx._eigh_refined)(h.re, h.im)


@pytest.mark.parametrize('transform', ['f64', 'f32'])
@pytest.mark.parametrize('trace', [_trace_infidelity, _trace_grad,
                                   _trace_etm, _trace_eigh_seed],
                         ids=['infidelity', 'grad', 'etm', 'eigh_seed'])
def test_ozaki_float32_products_are_pinned(gpu_backend, monkeypatch,
                                           trace, transform):
    """With the ozaki override on a GPU, every float32 matrix product
    (f32 P assembly, f32 second-order shifts, the f32 eigh seed, the
    opt-in f32 transform chain) asks for full precision, never TF32."""
    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    monkeypatch.setenv('FF_TPU_TRANSFORM_DTYPE', transform)
    assert _unpinned_f32_dots(trace()) == []


def _cache_dir_in_child(env_updates):
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_COMPILATION_CACHE_DIR',
                        'FF_TPU_NO_COMPILE_CACHE')}
    env.update(env_updates)
    env['JAX_PLATFORMS'] = 'cpu'
    proc = subprocess.run(
        [sys.executable, '-c',
         'import filter_functions_tpu, jax; '
         'print(jax.config.jax_compilation_cache_dir)'],
        env=env, cwd=str(REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    """Without JAX_COMPILATION_CACHE_DIR the cache is one fixed path in
    the checkout, which .gitignore lists."""
    got = _cache_dir_in_child({})
    assert Path(got) == REPO / '.jax_cache'
    assert '.jax_cache/' in (REPO / '.gitignore').read_text().split()


def test_compile_cache_follows_env(tmp_path):
    got = _cache_dir_in_child({'JAX_COMPILATION_CACHE_DIR': str(tmp_path)})
    assert Path(got) == tmp_path


def test_compile_cache_opt_out():
    assert _cache_dir_in_child({'FF_TPU_NO_COMPILE_CACHE': '1'}) == 'None'


@pytest.fixture
def on_gpu():
    """Skip unless the default device is a GPU (decided when the test
    runs, never at import)."""
    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs a GPU')


@pytest.mark.gpu
def test_float32_products_are_ieee_on_card(on_gpu):
    """The float32 products of the ozaki path run in IEEE float32 on the
    card: TF32 would leave ~1e-3 relative error, float32 ~1e-6."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 64, 64)) + 1j * rng.standard_normal(
        (4, 64, 64))
    b = rng.standard_normal((4, 64, 64)) + 1j * rng.standard_normal(
        (4, 64, 64))
    f32 = lambda z: cplx.C(jnp.asarray(z.real, jnp.float32),
                           jnp.asarray(z.imag, jnp.float32))
    got = numeric._so_matmul(f32(a), f32(b)).to_numpy()
    want = a @ b
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    h = _herm_traceless(rng, 8, 8)
    w = jax.jit(cplx._eigh_refined)(jnp.asarray(h.real),
                                    jnp.asarray(h.imag))[0]
    np.testing.assert_allclose(np.asarray(w), np.linalg.eigvalsh(h),
                               atol=1e-12, rtol=0)
