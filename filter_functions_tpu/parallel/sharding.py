"""Device-mesh sharding of the filter-function pipeline.

Parallel axes:

* ``omega`` -- the frequency grid.  Control-matrix and filter-function
  evaluation are independent per frequency; sharding the trailing
  omega axis splits the dominant (G x n_omega x d^2 x d^2) contraction
  across devices with zero communication.  The final frequency
  integral is a sum over the sharded axis, which GSPMD lowers to a
  single ``psum`` (an all-reduce over NVLink on a GPU host).
* ``batch`` -- a batch of pulses (e.g. randomized-benchmarking
  sequences or optimal-control candidates) sharded across devices;
  fully independent.

The per-segment eigendecompositions are tiny (G d^3) and replicated.

No point-to-point communication is ever required by the math; the
only collective is the integral reduction (cf. SURVEY.md section 5.8).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import functional, numeric, util
from ..cplx import C

__all__ = ['make_mesh', 'shard_omega', 'sharded_filter_function',
           'sharded_infidelity', 'sharded_batched_infidelity',
           'sharded_error_transfer_matrix', 'grape_step',
           'make_grape_step']


def make_mesh(n_devices: Optional[int] = None,
              batch: int = 1) -> Mesh:
    """A (batch, omega) mesh over the available devices.

    With ``batch == 1`` all devices shard the frequency axis; pass a
    divisor of the device count to split between pulse batch and
    frequency grid.
    """
    devices = np.array(jax.devices()[:n_devices] if n_devices
                       else jax.devices())
    n = len(devices)
    if n % batch:
        raise ValueError(f'batch axis {batch} does not divide device '
                         f'count {n}')
    return Mesh(devices.reshape(batch, n // batch), ('batch', 'omega'))


def shard_omega(x, mesh: Mesh):
    """Place an array (or C) with its trailing axis sharded over the
    mesh's omega axis."""
    def put(a):
        spec = P(*([None] * (a.ndim - 1) + ['omega']))
        return jax.device_put(a, NamedSharding(mesh, spec))
    if isinstance(x, C):
        return C(put(x.re), put(x.im))
    return put(jnp.asarray(x))


def _replicate(x, mesh: Mesh):
    def put(a):
        return jax.device_put(a, NamedSharding(mesh, P()))
    return jax.tree.map(put, x)


# Module-level jit wrappers: a fresh jax.jit(f) per call would
# re-trace on every invocation (the tracing cache is per-wrapper).
_ff_jit = jax.jit(functional.fidelity_filter_function)
_infid_jit = jax.jit(functional.infidelity)
_binfid_jit = jax.jit(functional.batched_infidelity,
                      static_argnames=('chunk_size',))


def sharded_filter_function(p: functional.PulseArrays,
                            omega: jnp.ndarray, mesh: Mesh) -> C:
    """Fidelity filter function with the frequency axis sharded over
    the mesh. Returns a distributed array (omega-sharded)."""
    p = _replicate(p, mesh)
    omega = shard_omega(omega, mesh)
    return _ff_jit(p, omega)


def sharded_infidelity(p: functional.PulseArrays, spectrum, omega,
                       mesh: Mesh) -> jnp.ndarray:
    """Infidelity with the frequency integral reduced across the mesh
    (a single psum)."""
    p = _replicate(p, mesh)
    omega = shard_omega(omega, mesh)
    spectrum = shard_omega(spectrum, mesh)
    return _infid_jit(p, spectrum, omega)


def sharded_batched_infidelity(p: functional.PulseArrays, spectrum,
                               omega, mesh: Mesh) -> jnp.ndarray:
    """The production batched entry point
    (:func:`functional.batched_infidelity` -- the flagship bench path)
    sharded over the FULL (batch, omega) mesh: the pulse batch splits
    over 'batch', the frequency grid over 'omega', and the only
    collective is the frequency-integral psum within each batch row
    (one all-reduce, pinned by
    tests/test_parallel.py::test_sharded_batched_infidelity_flagship).

    The leading batch axis of c_coeffs / n_coeffs / dt must divide the
    mesh's batch-axis size.  Returns (batch, n_nops), distributed."""
    def put_batch(a):
        spec = P('batch', *([None] * (a.ndim - 1)))
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    p = functional.PulseArrays(
        _replicate(p.c_opers, mesh), put_batch(p.c_coeffs),
        _replicate(p.n_opers, mesh), put_batch(p.n_coeffs),
        put_batch(p.dt), _replicate(p.basis, mesh))
    omega = shard_omega(omega, mesh)
    spectrum = shard_omega(spectrum, mesh)
    return _binfid_jit(p, spectrum, omega)


def sharded_error_transfer_matrix(p: functional.PulseArrays, spectrum,
                                  omega, basis, mesh: Mesh,
                                  second_order: bool = False
                                  ) -> jnp.ndarray:
    """Batched error transfer matrices with the pulse batch sharded
    over the mesh's 'batch' axis (operators/spectrum/frequencies
    replicated; each device runs its share of the fused per-pulse
    pipeline independently -- no collectives).

    p carries a leading batch axis on c_coeffs / n_coeffs / dt that
    must divide the mesh's batch-axis size."""
    def put_batch(a):
        spec = P('batch', *([None] * (a.ndim - 1)))
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    p = functional.PulseArrays(
        _replicate(p.c_opers, mesh), put_batch(p.c_coeffs),
        _replicate(p.n_opers, mesh), put_batch(p.n_coeffs),
        put_batch(p.dt), _replicate(p.basis, mesh))
    return functional.batched_error_transfer_matrix(
        p, spectrum, omega, basis, second_order=second_order)


# -----------------------------------------------------------------------------
# GRAPE-style optimal-control training step (batch + omega sharded)
# -----------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def make_grape_step(learning_rate: float = 1e-2):
    """A jitted gradient-descent step on a batch of pulses: loss is the
    summed leading-order infidelity; gradients flow through
    diagonalization, propagator scan, and the omega-lattice contraction.

    Returns ``step(c_coeffs, static: PulseArrays, spectrum, omega)``
    -> (updated c_coeffs, loss).  Batch axis on c_coeffs/n_coeffs/dt.
    """
    def loss_fn(c_coeffs, p, spectrum, omega):
        batched = functional.PulseArrays(p.c_opers, c_coeffs, p.n_opers,
                                         p.n_coeffs, p.dt, p.basis)
        infids = functional.batched_infidelity(batched, spectrum, omega)
        return infids.sum()

    @jax.jit
    def step(c_coeffs, p, spectrum, omega):
        loss, grad = jax.value_and_grad(loss_fn)(c_coeffs, p, spectrum,
                                                 omega)
        return c_coeffs - learning_rate * grad, loss

    return step


def grape_step(c_coeffs, p: functional.PulseArrays, spectrum, omega,
               mesh: Optional[Mesh] = None, learning_rate: float = 1e-2):
    """One sharded GRAPE step: pulse batch over 'batch', frequencies
    over 'omega'."""
    step = make_grape_step(learning_rate)
    if mesh is not None:
        def put_batch(a):
            spec = P('batch', *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(mesh, spec))
        c_coeffs = put_batch(jnp.asarray(c_coeffs))
        p = functional.PulseArrays(
            _replicate(p.c_opers, mesh), put_batch(p.c_coeffs),
            _replicate(p.n_opers, mesh), put_batch(p.n_coeffs),
            put_batch(p.dt), _replicate(p.basis, mesh))
        omega = shard_omega(omega, mesh)
        spectrum = shard_omega(spectrum, mesh)
    return step(c_coeffs, p, spectrum, omega)
