"""On-card smoke test of the filter-function pipeline.

Drives the library's main path once on a GPU, through the entry points a
user calls, at the full size of the flagship configuration: the 4-qubit
QFT pulse (d = 16, 13 segments) at 1000 frequencies, batch 32.  Every
result is compared with the plain reference: the same inputs on the CPU
backend (native float64 contraction, LAPACK complex128 ``eigh``),
computed by a child process that never opens the card.

Phases (one card, the default):

  a  device      the default JAX device is a GPU; card name and power limit
  b  flagship    functional.batched_infidelity (chunk 2): compile time,
                 median ms/pulse, memory; infidelity vs reference
  c  object API  PulseSequence filter function and infidelity vs
                 reference; cached concatenation equals the from-scratch
                 pulse (the flagship split in two, and the README Y2 @ X)
  d  gradient    jax.grad of (b) with respect to the control coefficients
  e  ETM         second-order error transfer matrices, batch 64, d = 4
  f  contraction the non-default contraction mode on the flagship: parity,
                 and alternating timings against the default

    python chip_smoke.py               # one card, phases a-f
    python chip_smoke.py --devices 4   # four cards: sharded batched
                                       # infidelity and GRAPE step on a
                                       # (batch, omega) mesh vs one card

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
A failed phase exits non-zero before printing it.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_QUBITS = 4
N_OMEGA = 1000
BATCH = 32
CHUNK = 2
#: timed calls per measurement
ITERS = 5
#: chunks at each end of the batch that the CPU reference recomputes for
#: (b), (d) and (f) (the CPU takes seconds per pulse at this width): the
#: first chunks run in the pipelined scan body, the last one in its
#: epilogue, in the reference as on the card
REF_CHUNKS = 2
#: seconds to wait for the CPU reference child
REFERENCE_TIMEOUT = 900
#: second-order ETM shape (bench.py config_second_order)
SO_D, SO_N_DT, SO_N_OMEGA, SO_BATCH = 4, 8, 200, 64

#: Tolerances against the CPU reference.  Infidelity: the library's
#: 1e-10 absolute parity contract.  The rest are relative to the largest
#: reference element, except the ETM, whose entries are O(1).
TOL_INFID = 1e-10
TOL_FF = 1e-9
TOL_GRAD = 1e-8
TOL_ETM = 1e-12
#: pulses in the four-card GRAPE comparison: its one-card side vmaps the
#: whole batch through reverse mode at once
GRAPE_BATCH = 8
#: sharded vs one-card results (--devices 4): same arithmetic, only the
#: order of the frequency-integral sum differs
TOL_SHARDED = 1e-12


class PhaseError(RuntimeError):
    """A phase produced a wrong or non-finite result."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value: float, tol: float) -> None:
    """Print a parity figure beside its tolerance; raise if it fails."""
    ok = bool(np.isfinite(value) and value <= tol)
    log(f'  {name}: {value:.3e} (tolerance {tol:.0e}) '
        f'{"ok" if ok else "FAILED"}')
    if not ok:
        raise PhaseError(f'{name} {value:.3e} exceeds {tol:.0e}')


def max_rel(got, want) -> float:
    """Largest absolute deviation over the largest reference magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise PhaseError(f'shape {got.shape} != reference {want.shape}')
    return float(np.abs(got - want).max() / np.abs(want).max())


def max_abs(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise PhaseError(f'shape {got.shape} != reference {want.shape}')
    return float(np.abs(got - want).max())


def timed(fn, iters: int):
    """Median wall time of *iters* calls of fn(), each synchronised."""
    import jax
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


# -----------------------------------------------------------------------------
# inputs (deterministic: the reference child rebuilds them identically)
# -----------------------------------------------------------------------------
def flagship_inputs(n_qubits=N_QUBITS, n_omega=N_OMEGA, batch=BATCH):
    """models.qft.qft_batch with device-resident frequencies and
    spectrum."""
    import jax.numpy as jnp
    from filter_functions_tpu.models import qft
    pulse, batched, omega, spectrum = qft.qft_batch(n_qubits, n_omega,
                                                    batch)
    return pulse, batched, jnp.asarray(omega), jnp.asarray(spectrum)


def so_inputs(d=SO_D, n_dt=SO_N_DT, n_omega=SO_N_OMEGA, batch=SO_BATCH):
    """Random traceless Hermitian controls and noise (seed 7), as in
    bench.py's second_order configuration."""
    import jax.numpy as jnp
    from filter_functions_tpu import functional
    from filter_functions_tpu.basis import Basis
    from filter_functions_tpu.cplx import asc

    rng = np.random.default_rng(7)

    def herm_traceless(k):
        a = rng.standard_normal((k, d, d)) \
            + 1j * rng.standard_normal((k, d, d))
        a = (a + a.conj().swapaxes(-1, -2)) / 2
        return a - (np.trace(a, axis1=-2, axis2=-1)[:, None, None]
                    * np.eye(d) / d)

    c_opers, n_opers = herm_traceless(2), herm_traceless(2)
    c_coeffs = rng.standard_normal((batch, 2, n_dt))
    dt = np.broadcast_to(1 - rng.random(n_dt), (batch, n_dt)).copy()
    omega = np.geomspace(1e-1, 1e1, n_omega)
    basis = Basis.ggm(d)
    p = functional.PulseArrays(
        asc(c_opers), jnp.asarray(c_coeffs), asc(n_opers),
        jnp.ones((batch, 2, n_dt)), jnp.asarray(dt), basis.dev)
    spectrum = jnp.asarray(np.broadcast_to(1e-4 / omega, (2, n_omega)))
    return p, spectrum, jnp.asarray(omega), basis


# -----------------------------------------------------------------------------
# the computations each phase runs (on the card, and in the reference)
# -----------------------------------------------------------------------------
def flagship_fn(chunk: int):
    import jax
    from filter_functions_tpu import functional
    return jax.jit(lambda p, s, o: functional.batched_infidelity(
        p, s, o, chunk_size=chunk))


def grad_fn(chunk: int):
    """d/d c_coeffs of the summed batched infidelity: one
    optimal-control step's gradient."""
    import jax
    from filter_functions_tpu import functional

    def loss(c, p, s, o):
        return functional.batched_infidelity(
            p._replace(c_coeffs=c), s, o, chunk_size=chunk).sum()
    return jax.jit(jax.grad(loss))


def etm_fn(p, spectrum, omega, basis):
    from filter_functions_tpu import functional
    return functional.batched_error_transfer_matrix(
        p, spectrum, omega, basis, second_order=True)


def object_api(pulse, omega, spectrum):
    """Filter function and infidelity through PulseSequence, and the
    cached concatenation of the pulse's two halves."""
    import filter_functions_tpu as ff
    F = np.asarray(pulse.get_filter_function(omega).to_numpy())
    infid = np.asarray(ff.infidelity(pulse, spectrum, omega))
    half = len(pulse.dt) // 2
    first, second = pulse[:half], pulse[half:]
    first.cache_filter_function(omega)
    second.cache_filter_function(omega)
    joined = first @ second
    F_joined = np.asarray(joined.get_filter_function(omega).to_numpy())
    return F, infid, F_joined


def hadamard_concatenation(omega):
    """The README example: Y2 @ X from cached parts vs from scratch."""
    from math import pi
    import filter_functions_tpu as ff
    _, X, Y, Z = ff.util.paulis
    x = ff.PulseSequence([[X / 2, [pi], 'X']], [[Z / 2, [1], 'Z']], [1])
    y2 = ff.PulseSequence([[Y / 2, [pi / 2], 'Y']], [[Z / 2, [1], 'Z']],
                          [1])
    x.cache_filter_function(omega)
    y2.cache_filter_function(omega)
    cached = (y2 @ x).get_filter_function(omega).to_numpy()
    scratch = ff.PulseSequence([[X / 2, [0, pi], 'X'],
                                [Y / 2, [pi / 2, 0], 'Y']],
                               [[Z / 2, [1, 1], 'Z']], [1, 1])
    return (np.asarray(cached),
            np.asarray(scratch.get_filter_function(omega).to_numpy()))


def reference_results(sizes: dict) -> dict:
    """Every phase's result on the current (CPU) backend, native
    contraction: the plain reference the card is compared with."""
    import jax
    t0 = time.perf_counter()
    pulse, batched, omega, spectrum = flagship_inputs(
        sizes['n_qubits'], sizes['n_omega'], sizes['batch'])
    batched = take_rows(batched, sizes['rows'])
    chunk = sizes['chunk']
    out = {}
    out['infid'] = np.asarray(flagship_fn(chunk)(batched, spectrum, omega))
    out['grad'] = np.asarray(grad_fn(chunk)(batched.c_coeffs, batched,
                                            spectrum, omega))
    F, infid, _ = object_api(pulse, np.asarray(omega),
                             np.asarray(spectrum))
    out['F'], out['obj_infid'] = F, infid
    p, s, o, basis = so_inputs(sizes['so_d'], sizes['so_n_dt'],
                               sizes['so_n_omega'], sizes['so_batch'])
    out['etm'] = np.asarray(jax.block_until_ready(etm_fn(p, s, o, basis)))
    print(f'  (CPU reference: {time.perf_counter() - t0:.1f} s)',
          flush=True)
    return out


def reference_rows(batch: int, chunk: int) -> list:
    """Batch rows the CPU reference recomputes: REF_CHUNKS chunks from
    each end of the batch.  Taken as one batch with the same chunk size,
    they keep their place in the chunk pipeline: the first chunks are
    contracted in the scan body and the last one in the epilogue, as in
    the full batch."""
    n = REF_CHUNKS * chunk
    if 2 * n >= batch:
        return list(range(batch))
    return list(range(n)) + list(range(batch - n, batch))


def take_rows(batched, rows):
    idx = np.asarray(rows)
    return batched._replace(c_coeffs=batched.c_coeffs[idx],
                            n_coeffs=batched.n_coeffs[idx],
                            dt=batched.dt[idx])


def start_reference(sizes: dict, workdir: str) -> subprocess.Popen:
    """Launch the reference computation in a CPU-only child process.

    JAX_PLATFORMS=cpu is what keeps the child off the card: JAX still
    registers its CUDA plugin there, but creates no GPU client, so the
    child holds no device memory.  The child compiles afresh, without
    the persistent compile cache: a cache shared between hosts can hold
    CPU executables built for another instruction set."""
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(JAX_PLATFORMS='cpu', FF_TPU_CONTRACT='native',
               FF_TPU_NO_COMPILE_CACHE='1')
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), '--reference-child',
         json.dumps(sizes), os.path.join(workdir, 'reference.npz')],
        env=env, cwd=str(REPO))


def finish_reference(proc: subprocess.Popen, workdir: str,
                     timeout: float) -> dict:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise PhaseError('reference child timed out')
    if rc != 0:
        raise PhaseError(f'reference child exited with {rc}')
    with np.load(os.path.join(workdir, 'reference.npz')) as z:
        return {k: z[k] for k in z.files}


# -----------------------------------------------------------------------------
# phases
# -----------------------------------------------------------------------------
def require_gpu():
    """Phase a: the default device must be a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f'chip_smoke: no GPU (default device is '
                         f'{dev.platform}); refusing to run')
    return dev


def card_line() -> str:
    proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise PhaseError(f'nvidia-smi failed: {proc.stderr.strip()}')
    return proc.stdout.strip()


def memory_report(compiled, device) -> None:
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f'  compiled memory: arguments {mem.argument_size_in_bytes} B, '
            f'outputs {mem.output_size_in_bytes} B, '
            f'temporaries {mem.temp_size_in_bytes} B')
    stats = device.memory_stats() or {}
    log(f'  device peak_bytes_in_use: {stats.get("peak_bytes_in_use")}')


def phase_flagship(batched, spectrum, omega, chunk, iters, ref_ready):
    """Phase b: compile, time and return the batched infidelity."""
    import jax
    t0 = time.perf_counter()
    compiled = flagship_fn(chunk).lower(batched, spectrum, omega).compile()
    log(f'  compile: {time.perf_counter() - t0:.2f} s')
    infid = np.asarray(jax.block_until_ready(
        compiled(batched, spectrum, omega)))
    if not np.isfinite(infid).all():
        raise PhaseError('non-finite infidelity')
    ref_ready()
    med, times = timed(lambda: compiled(batched, spectrum, omega), iters)
    batch = batched.c_coeffs.shape[0]
    log(f'  median {med * 1e3 / batch:.4f} ms/pulse over {iters} calls '
        f'(call times ms: {", ".join(f"{t * 1e3:.2f}" for t in times)})')
    return compiled, infid


def phase_contraction_ab(batched, spectrum, omega, chunk, iters,
                         default_compiled, other_mode):
    """Phase f: compile the non-default contraction mode, then time it
    against the default in alternating order (A B B A ...)."""
    import jax
    previous = os.environ.get('FF_TPU_CONTRACT')
    os.environ['FF_TPU_CONTRACT'] = other_mode
    try:
        jax.clear_caches()
        t0 = time.perf_counter()
        other = flagship_fn(chunk).lower(batched, spectrum,
                                         omega).compile()
        log(f'  {other_mode} compile: {time.perf_counter() - t0:.2f} s')
    finally:
        if previous is None:
            os.environ.pop('FF_TPU_CONTRACT')
        else:
            os.environ['FF_TPU_CONTRACT'] = previous
        jax.clear_caches()
    infid = np.asarray(jax.block_until_ready(
        other(batched, spectrum, omega)))
    runs = {'default': [], other_mode: []}
    fns = {'default': default_compiled, other_mode: other}
    for i in range(iters):
        order = ('default', other_mode) if i % 2 == 0 \
            else (other_mode, 'default')
        for name in order:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[name](batched, spectrum, omega))
            runs[name].append(time.perf_counter() - t0)
    batch = batched.c_coeffs.shape[0]
    for name, times in runs.items():
        log(f'  {name}: median '
            f'{statistics.median(times) * 1e3 / batch:.4f} ms/pulse '
            f'(call times ms: {", ".join(f"{t * 1e3:.2f}" for t in times)})')
    return infid


def run_one_card(args) -> dict:
    import jax
    import filter_functions_tpu  # noqa: F401  (enables x64)
    from filter_functions_tpu import config

    dev = require_gpu()
    log(f'[a] device: {dev.platform} {dev.device_kind}, '
        f'{len(jax.devices())} visible')
    log(f'card: {card_line()}')
    default_mode = config.contraction_mode()
    other_mode = 'ozaki' if default_mode == 'native' else 'native'
    log(f'  contraction mode {default_mode}, native complex eigh '
        f'{config.supports_native_complex()}')

    rows = reference_rows(BATCH, CHUNK)
    sizes = dict(n_qubits=N_QUBITS, n_omega=N_OMEGA, batch=BATCH,
                 chunk=CHUNK, rows=rows, so_d=SO_D, so_n_dt=SO_N_DT,
                 so_n_omega=SO_N_OMEGA, so_batch=SO_BATCH)
    row_text = f'rows {", ".join(map(str, rows))}'
    with tempfile.TemporaryDirectory() as workdir:
        child = start_reference(sizes, workdir)
        ref = {}
        try:
            def ref_ready():
                if not ref:
                    ref.update(finish_reference(child, workdir,
                                                REFERENCE_TIMEOUT))
                    log('  (CPU reference ready)')

            pulse, batched, omega, spectrum = flagship_inputs(
                N_QUBITS, N_OMEGA, BATCH)
            log(f'[b] flagship: batched_infidelity, d={2 ** N_QUBITS}, '
                f'{len(pulse.dt)} segments, {N_OMEGA} frequencies, '
                f'batch {BATCH}, chunk {CHUNK}')
            compiled, infid = phase_flagship(batched, spectrum, omega,
                                             CHUNK, ITERS, ref_ready)
            memory_report(compiled, dev)
            check(f'infidelity max abs error vs CPU reference '
                  f'({row_text})', max_abs(infid[rows], ref['infid']),
                  TOL_INFID)

            log('[c] object API: PulseSequence, infidelity, cached '
                'concatenation')
            om_np, s_np = np.asarray(omega), np.asarray(spectrum)
            F, obj_infid, F_joined = object_api(pulse, om_np, s_np)
            check('filter function max rel error vs CPU reference',
                  max_rel(F, ref['F']), TOL_FF)
            check('object-API infidelity max abs error vs CPU reference',
                  max_abs(obj_infid, ref['obj_infid']), TOL_INFID)
            check('halves @ concatenation vs from scratch (rel)',
                  max_rel(F_joined, F), TOL_FF)
            cached, scratch = hadamard_concatenation(om_np)
            check('README Y2 @ X cached vs from scratch (rel)',
                  max_rel(cached, scratch), TOL_FF)

            log('[d] jax.grad of the flagship batched infidelity')
            t0 = time.perf_counter()
            gfn = grad_fn(CHUNK).lower(batched.c_coeffs, batched,
                                       spectrum, omega).compile()
            log(f'  compile: {time.perf_counter() - t0:.2f} s')
            grad = np.asarray(jax.block_until_ready(
                gfn(batched.c_coeffs, batched, spectrum, omega)))
            med, _ = timed(lambda: gfn(batched.c_coeffs, batched,
                                       spectrum, omega), ITERS)
            log(f'  median {med * 1e3 / BATCH:.4f} ms/pulse')
            check(f'gradient max rel error vs CPU reference ({row_text})',
                  max_rel(grad[rows], ref['grad']), TOL_GRAD)

            log(f'[e] second-order error transfer matrices: d={SO_D}, '
                f'{SO_N_DT} segments, {SO_N_OMEGA} frequencies, '
                f'batch {SO_BATCH}')
            p, s, o, basis = so_inputs(SO_D, SO_N_DT, SO_N_OMEGA, SO_BATCH)
            t0 = time.perf_counter()
            etm = np.asarray(jax.block_until_ready(etm_fn(p, s, o, basis)))
            log(f'  first call (compile + run): '
                f'{time.perf_counter() - t0:.2f} s')
            med, _ = timed(lambda: etm_fn(p, s, o, basis), ITERS)
            log(f'  median {med * 1e3 / SO_BATCH:.4f} ms/evaluation')
            check('ETM max abs error vs CPU reference',
                  max_abs(etm, ref['etm']), TOL_ETM)

            log(f'[f] contraction mode {other_mode} on the flagship, '
                f'alternating with {default_mode}')
            other = phase_contraction_ab(batched, spectrum, omega, CHUNK,
                                         ITERS, compiled, other_mode)
            check(f'{other_mode} infidelity max abs error vs CPU '
                  f'reference ({row_text})',
                  max_abs(other[rows], ref['infid']), TOL_INFID)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices())}


def run_four_cards(args) -> dict:
    """Sharded batched infidelity and GRAPE step on a (batch 2, omega 2)
    mesh of four cards, against the same calls on one card."""
    import jax
    from filter_functions_tpu import functional, parallel

    dev = require_gpu()
    devices = jax.devices()
    if len(devices) < args.devices:
        raise PhaseError(f'need {args.devices} GPUs, found {len(devices)}')
    log(f'[a] devices: {args.devices} x {dev.device_kind}')
    log(f'card: {card_line()}')
    _, batched, omega, spectrum = flagship_inputs(N_QUBITS, N_OMEGA, BATCH)
    mesh = parallel.make_mesh(args.devices, batch=2)
    log(f'  mesh {dict(mesh.shape)}')

    log('[m1] sharded batched infidelity vs one card')
    one = jax.jit(functional.batched_infidelity,
                  static_argnames=('chunk_size',))
    single = np.asarray(one(batched, spectrum, omega, chunk_size=CHUNK))
    t0 = time.perf_counter()
    sharded = np.asarray(parallel.sharded_batched_infidelity(
        batched, spectrum, omega, mesh))
    log(f'  first sharded call (compile + run): '
        f'{time.perf_counter() - t0:.2f} s')
    med, _ = timed(lambda: parallel.sharded_batched_infidelity(
        batched, spectrum, omega, mesh), ITERS)
    log(f'  sharded median {med * 1e3 / BATCH:.4f} ms/pulse')
    check('sharded infidelity max rel error vs one card',
          max_rel(sharded, single), TOL_SHARDED)

    log(f'[m2] sharded GRAPE step vs one card (batch {GRAPE_BATCH})')
    rows = min(GRAPE_BATCH, BATCH)
    grape = batched._replace(c_coeffs=batched.c_coeffs[:rows],
                             n_coeffs=batched.n_coeffs[:rows],
                             dt=batched.dt[:rows])
    c0 = grape.c_coeffs
    c_one, loss_one = parallel.grape_step(c0, grape, spectrum, omega)
    t0 = time.perf_counter()
    c_sh, loss_sh = parallel.grape_step(c0, grape, spectrum, omega, mesh)
    jax.block_until_ready(c_sh)
    log(f'  first sharded step (compile + run): '
        f'{time.perf_counter() - t0:.2f} s')
    med, _ = timed(lambda: parallel.grape_step(c0, grape, spectrum, omega,
                                               mesh), ITERS)
    log(f'  sharded step median {med * 1e3:.2f} ms ({rows} pulses)')
    check('GRAPE loss rel error vs one card',
          abs(float(loss_sh) - float(loss_one)) / abs(float(loss_one)),
          TOL_SHARDED)
    check('GRAPE update max rel error vs one card',
          max_rel(np.asarray(c_sh) - np.asarray(c0),
                  np.asarray(c_one) - np.asarray(c0)), TOL_GRAD)
    for d in devices[:args.devices]:
        log(f'  {d}: peak_bytes_in_use '
            f'{(d.memory_stats() or {}).get("peak_bytes_in_use")}')
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': args.devices}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--devices', type=int, default=1, choices=(1, 4),
                        help='1: all phases on one card; 4: the sharded '
                             'paths on four cards')
    parser.add_argument('--reference-child', nargs=2,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(REPO))
    if args.reference_child:
        sizes, out_path = json.loads(args.reference_child[0]), \
            args.reference_child[1]
        import filter_functions_tpu  # noqa: F401
        np.savez(out_path, **reference_results(sizes))
        return 0

    try:
        if args.devices == 1:
            device = run_one_card(args)
        else:
            device = run_four_cards(args)
    except PhaseError as err:
        log(f'chip_smoke: FAILED: {err}')
        return 1
    print(json.dumps({'ok': True, 'device': device}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
