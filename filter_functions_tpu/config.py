"""Global configuration for filter_functions_tpu.

Precision strategy
------------------
The library targets <=1e-10 infidelity parity with the NumPy reference
package, which requires double precision.  Device kernels are written
against a split representation of complex tensors (see
:mod:`filter_functions_tpu.cplx`): a complex tensor is a pytree of two
real arrays ``(re, im)``, float64 under x64.

Backend policy (CPU and GPU alike): the control-matrix contraction runs
as one native float64 XLA einsum (:func:`contraction_mode`), and d > 2
Hermitian eigendecompositions call the backend's complex128 ``eigh``
(LAPACK on the CPU, cuSOLVER on the GPU; :func:`supports_native_complex`).
The Ozaki int8 emulation of float64 stays reachable through
``FF_TPU_CONTRACT=ozaki``; every float32 matrix product on that path
pins ``precision=HIGHEST`` so it never runs in TF32 on a GPU.

``jax.config.update('jax_enable_x64', True)`` is applied at import time
of the top-level package unless the environment variable
``FF_TPU_NO_X64`` is set.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

#: Whether x64 mode was requested (default yes).
X64 = 'FF_TPU_NO_X64' not in os.environ

if X64:
    jax.config.update('jax_enable_x64', True)

#: Persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is
#: unset: one fixed path inside the checkout (the path is part of the
#: cache key, so it must not move between runs).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / '.jax_cache'

# Compile time dominates small workloads, so compiled executables are
# cached across processes.  JAX itself reads JAX_COMPILATION_CACHE_DIR;
# only when that is unset does the library name a directory.  Opt out
# with FF_TPU_NO_COMPILE_CACHE=1.
if 'FF_TPU_NO_COMPILE_CACHE' not in os.environ:
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir',
                          str(DEFAULT_CACHE_DIR))
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.1)


def float_dtype():
    """The default real dtype (float64 under x64, float32 otherwise)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def complex_dtype():
    """The native complex dtype matching :func:`float_dtype`.

    Only used at host boundaries and on backends with complex support
    (CPU); device kernels use the split representation.
    """
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


def eps() -> float:
    """Machine epsilon of the default real dtype."""
    import numpy as np
    return float(np.finfo(np.dtype(float_dtype())).eps)


def backend() -> str:
    return jax.default_backend()


def enable_host_cpu() -> bool:
    """Make the CPU platform available alongside the accelerator.

    Host-side orchestration math (pulse construction, concatenation
    byproducts) is latency-bound, not FLOP-bound: every tiny
    distinct-shape op is one more accelerator compilation and launch.
    Call this before first backend use; returns True if a CPU device is
    available afterwards.
    """
    try:
        jax.local_devices(backend='cpu')
        return True
    except RuntimeError:
        pass
    try:
        current = jax.config.jax_platforms
        if current and 'cpu' not in current:
            jax.config.update('jax_platforms', current + ',cpu')
        return True
    except Exception:
        return False


def host_device():
    """The CPU device for host-side math, or None."""
    try:
        return jax.local_devices(backend='cpu')[0]
    except RuntimeError:
        return None


class on_host:
    """Context manager running enclosed jax ops on the host CPU device
    (no-op if no CPU backend is registered)."""

    def __enter__(self):
        dev = host_device()
        self._ctx = jax.default_device(dev) if dev is not None else None
        if self._ctx is not None:
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            return self._ctx.__exit__(*exc)
        return False


def _parse_bytes(s: str) -> int:
    """'2G', '512M', '1048576' -> bytes."""
    s = s.strip().upper()
    mult = {'K': 1 << 10, 'M': 1 << 20, 'G': 1 << 30, 'T': 1 << 40}
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(s)


def device_memory_bytes() -> int:
    """Reported memory of the default device (bytes), or 0 if the
    backend does not expose it (e.g. the CPU platform)."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            return int(stats.get('bytes_limit', 0))
    except Exception:
        pass
    return 0


def memory_budget(fraction: float = 1 / 8,
                  fallback: int = 2 << 30) -> int:
    """Working-buffer byte budget for memory-bounded chunked kernels
    (the K4 scan-table chunking and the K11 concat-rule group batching).

    Resolution order: the ``FF_TPU_MEMORY_BUDGET`` env var (bytes, or
    with a K/M/G/T suffix) overrides everything; otherwise *fraction*
    of the device's reported memory; *fallback* when the backend
    reports nothing.  Clamped to
    [64 MiB, 4 GiB] -- the kernels chunk more/less aggressively, the
    result is identical either way.
    """
    env = os.environ.get('FF_TPU_MEMORY_BUDGET')
    if env:
        return _parse_bytes(env)
    total = device_memory_bytes()
    budget = int(total * fraction) if total else int(fallback)
    return max(64 << 20, min(budget, 4 << 30))


def contraction_mode() -> str:
    """How the hot control-matrix contraction is executed.

    'native' -- one fused XLA einsum in the working precision (float64
                GEMMs from cuBLAS on a GPU, from the CPU backend's own
                kernels on the CPU).  The default on every backend: on
                an H100 it beats 'ozaki' at equal parity (PERF.md).
    'ozaki'  -- restructured as batched integer matmuls via the Ozaki
                digit-slice emulation of float64 (see ops/ozaki.py).
                Slower on an H100 and less exact (flagship infidelity
                ~5e-12 from the reference instead of ~1e-18), but
                inside the 1e-10 contract; see :func:`ozaki_factored`
                for the faster variant that is not.

    Override with the FF_TPU_CONTRACT environment variable.
    """
    return os.environ.get('FF_TPU_CONTRACT') or 'native'


def ozaki_operand_dtype(which: str = 'P'):
    """Element dtype in which the Ozaki matmul operand lattices are
    assembled ('P' the frequency-dependent tensor, 'D' the
    frequency-independent one).

    f32 assembly costs ~2^-24 relative element rounding.  Those
    rounding errors grow through the K-deep reduction (full-f32
    operands take the flagship parity past the 1e-10 contract), so the
    default is conservative: P-only f32 -- its per-frequency errors
    average incoherently in the spectral integral -- and f64 for D,
    whose errors are shared by every frequency.
    FF_TPU_OZAKI_OPERANDS=f64|f32|split overrides (f64: all full
    precision; f32: everything fast; split: the default).
    """
    mode = os.environ.get('FF_TPU_OZAKI_OPERANDS', 'split')
    if mode in ('f32', 'float32'):
        return jnp.float32
    if mode in ('f64', 'float64'):
        return jnp.float64
    return jnp.float32 if which == 'P' else jnp.float64


def transform_dtype(reduction_depth: int):
    """Working dtype of the frequency-independent transform chain
    feeding the control-matrix contraction (Q†V, V†BV, the basis
    conjugation), or None for the working precision (the default).

    An OPT-IN fast mode, NOT enabled by default: unlike the factored
    path's post-hoc 23-bit quantization of the finished operands
    (harmless: it perturbs the contraction inputs linearly), f32
    rounding here perturbs the eigenvector frame BEFORE the
    conjugation, making the transformed operators inconsistent with the
    exact eigenvalues that build the frequency-integral kernel.  That
    inconsistency is amplified ~1e4 by the d = 16 QFT spectrum, to
    ~1e-6 infidelity parity -- orders outside the 1e-10 contract.  Use
    FF_TPU_TRANSFORM_DTYPE=f32 (always) or f32-deep (only when the
    contraction runs the deep factored path) when ~1e-6 parity
    suffices; f64 (default) keeps the working precision.
    """
    mode = os.environ.get('FF_TPU_TRANSFORM_DTYPE', 'f64')
    if mode in ('f64', 'float64'):
        return None
    if mode in ('f32', 'float32'):
        return jnp.float32
    from .ops.ozaki import DEFAULT_PRECISION_BITS, _slice_params
    deep = _slice_params(reduction_depth, DEFAULT_PRECISION_BITS)[0] \
        in (5, 6)
    if deep and contraction_mode() == 'ozaki' and ozaki_factored():
        return jnp.float32
    return None


def transform_mxu(reduction_depth: int) -> bool:
    """Whether the frequency-independent conjugations (V†BV, the basis
    conjugation) run as Ozaki digit-slice matmuls
    (numeric._conjugate_mxu) instead of float64 einsums.

    Exact-path alternative to :func:`transform_dtype`: the digit
    slices decompose the f64 eigenvectors error-free, so the only new
    error is ~2^-30-level truncation noise on the RESULT, far below the
    factored contraction's own operand quantization.  Default: on
    whenever the contraction itself runs the Ozaki path.  Override with
    FF_TPU_TRANSFORM_MXU=0|1.
    """
    mode = os.environ.get('FF_TPU_TRANSFORM_MXU')
    if mode is not None:
        return mode != '0'
    return contraction_mode() == 'ozaki'


def ozaki_factored() -> bool:
    """Whether the deep control-matrix contraction forms the D operand's
    digit slices by native int32 factor arithmetic
    (ops/ozaki.ozaki_matmul_c_outer) instead of assembling D in f64.

    Off by default: the factored path quantizes D's factors to 23 bits,
    which leaves the flagship infidelity (4-qubit QFT, 1000
    frequencies) at the edge of the 1e-10 contract (8.8e-11 on the CPU,
    1.08e-10 on an H100), while the f64-assembled D reaches ~5e-12.  It
    saves float64 elementwise work, which the CPU and the GPU both do
    natively.  Enable with FF_TPU_OZAKI_FACTORED=1 (which also arms
    the escalation of :func:`ozaki_escalation_tol`)."""
    return os.environ.get('FF_TPU_OZAKI_FACTORED', '0') != '0'


def ozaki_escalation_tol() -> float:
    """Escalation threshold of the deep factored contraction: when the
    cheap in-graph estimate of the operand-quantization noise on the
    fidelity filter function (numeric._deep_quant_ratio, a sampled
    |P| @ |D| cancellation bound) exceeds this RELATIVE level, the
    contraction re-runs at full precision (f64-assembled operands,
    30-bit truncation) inside a ``lax.cond`` -- so a pathological
    cancellation cannot silently breach the 1e-10 infidelity-parity
    contract.  Calibration (CPU, bit-identical decomposition): the
    estimator reads ~1.2e-3 on the randomized parity ensemble
    (tests/test_accuracy_policy.py; worst TRUE relative parity there
    5.5e-8 ~ 1.1e-11 absolute at flagship infidelity scale) and
    ~1.0e-2 on the flagship, but 5.7 on a deliberately pathological
    deep CPMG-300 train whose refocused F(w -> 0) cancels to 5e-12 of
    its peak (true elementwise FF error there: 9e-4 relative, which
    escalation cuts to the f64 floor).  The default 0.1 sits 10x above
    the flagship and 57x below the pathology: healthy workloads never
    pay the escalation, catastrophic cancellation cannot slip through.
    0 disables escalation entirely.  Override with
    FF_TPU_OZAKI_ESCALATE_TOL."""
    return float(os.environ.get('FF_TPU_OZAKI_ESCALATE_TOL', '0.1'))


def eigh_mode() -> str:
    """How d > 2 Hermitian eigendecompositions run on backends without
    native complex support (cplx._eigh_impl; neither the CPU nor the
    GPU takes this path).

    'refined'  -- f32 real-embedding eigh + Ogita-Aishima Newton
                  refinement to f64 (matmul-only; the default).
                  Caveat: eigenvalue pairs with a *genuine* relative
                  gap inside (1e-12, ~4e-6) are treated as degenerate
                  clusters (backward error up to the gap itself);
                  exact degeneracies are handled exactly.
    'embedded' -- the f64 real-embedding eigh end to end.

    Override with FF_TPU_EIGH.  Read at trace time: set it before the
    first call for a given shape (cached executables keep the mode they
    were traced with).
    """
    return os.environ.get('FF_TPU_EIGH', 'refined')


def supports_native_complex() -> bool:
    """True if the default backend supports the native complex dtype.

    The CPU and GPU backends both support complex128, so d > 2
    eigendecompositions call their complex ``eigh`` (LAPACK, cuSOLVER)
    directly; other backends take the split real-embedding path.
    """
    if not jax.config.jax_enable_x64:
        return True  # complex64 works everywhere
    return backend() in ('cpu', 'gpu')
