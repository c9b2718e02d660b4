"""Kernel-level breakdown of the flagship batched infidelity on a GPU.

Traces a few calls of ``functional.batched_infidelity`` on the flagship
(the 4-qubit QFT pulse, 1000 frequencies, batch 32, chunk 2) with
``jax.profiler`` for each contraction mode, and prints from the trace:

- the device's kernel time, the trace window (first kernel start to
  last kernel end) and its busy and idle shares (busy = the union of
  kernel intervals over the window);
- the time of each named scope of ``ops/ozaki.py`` (digit stages and
  digit products) as a share of kernel time;
- the kernels by total time, with the HLO op each ran;
- in the native mode, the rate of the contraction's float64 GEMM kernel
  (the longest-running one), counting the contraction as three real
  GEMMs (Gauss) of n_omega x (G d^2) x (n_nops d^2) per pulse.

Modes: ``native`` (the default contraction), ``ozaki`` (the Ozaki
override, float64-assembled D) and ``ozaki-factored`` (the override with
FF_TPU_OZAKI_FACTORED=1, the int32 D-digit pipeline).

XLA command buffers are off in this process so that every kernel names
its HLO op, through which it is mapped to a named scope; the traced
program can run slightly slower than with them.

    python scripts/trace_flagship.py
"""
import collections
import glob
import os
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_gpu_enable_command_buffer=').strip()

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

MODES = {
    'native': {'FF_TPU_CONTRACT': 'native'},
    'ozaki': {'FF_TPU_CONTRACT': 'ozaki', 'FF_TPU_OZAKI_FACTORED': '0'},
    'ozaki-factored': {'FF_TPU_CONTRACT': 'ozaki',
                       'FF_TPU_OZAKI_FACTORED': '1'},
}
#: named scopes of ops/ozaki.py: the factored contraction's P and D
#: digit stages, the general complex matmul's A and B digit stages (in
#: the flagship contraction A is P and B is D), and the digit products
SCOPES = ('ozaki_p_digits', 'ozaki_d_digits', 'ozaki_a_digits',
          'ozaki_b_digits', 'ozaki_slice_matmuls')
#: H100 SXM float64 tensor-core peak (data sheet), TFLOP/s
FP64_TENSOR_PEAK = 67.0
#: calls timed, then traced, per mode
CALLS = 3
#: kernels listed per mode
TOP = 12

_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=')
_COMP = re.compile(r'^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$')
_CALLS = re.compile(r'calls=%?([\w.\-]+)')
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def op_names_by_instruction(hlo_text: str) -> dict:
    """Map each HLO instruction to the op_names of itself and of the
    instructions of the computation it calls (a fusion's body)."""
    own, calls, comp_names = {}, {}, collections.defaultdict(set)
    comp = None
    for line in hlo_text.splitlines():
        if line.strip() == '}':
            comp = None
            continue
        m = _INSTR.match(line)
        if m is None:
            m = _COMP.match(line)
            if m is not None:
                comp = m.group(1)
            continue
        name = m.group(1)
        names = set(_OP_NAME.findall(line))
        own[name] = names
        called = _CALLS.search(line)
        if called:
            calls[name] = called.group(1)
        if comp is not None:
            comp_names[comp] |= names
    return {name: names | comp_names.get(calls.get(name), set())
            for name, names in own.items()}


def scope_of(names) -> str:
    hit = {s for s in SCOPES if any(s in n for n in names)}
    if len(hit) > 1:
        return 'mixed'
    return hit.pop() if hit else ''


def device_events(trace_dir: str):
    """(kernel name, hlo_op, start_ns, end_ns) of every event on the
    first GPU's stream lines."""
    from jax.profiler import ProfileData
    path, = glob.glob(os.path.join(trace_dir, '**', '*.xplane.pb'),
                      recursive=True)
    data = ProfileData.from_file(path)
    plane = data.find_plane_with_name('/device:GPU:0')
    if plane is None:
        raise SystemExit(f'no /device:GPU:0 plane in {path}')
    out = []
    for line in plane.lines:
        if not line.name.startswith('Stream'):
            continue
        for ev in line.events:
            stats = dict(ev.stats)
            out.append((ev.name, str(stats.get('hlo_op', '')),
                        ev.start_ns, ev.end_ns))
    return out


def busy_ns(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_mode(mode: str, calls: int, top: int) -> None:
    import jax
    from filter_functions_tpu import functional
    from filter_functions_tpu.models import qft

    os.environ.pop('FF_TPU_OZAKI_FACTORED', None)
    os.environ.update(MODES[mode])
    jax.clear_caches()
    _, batched, omega, spectrum = qft.qft_batch(4, 1000, 32)
    omega, spectrum = jax.numpy.asarray(omega), jax.numpy.asarray(spectrum)
    batch = batched.c_coeffs.shape[0]
    fn = jax.jit(lambda p, s, o: functional.batched_infidelity(
        p, s, o, chunk_size=2))
    t0 = time.perf_counter()
    compiled = fn.lower(batched, spectrum, omega).compile()
    print(f'[{mode}] compile {time.perf_counter() - t0:.2f} s', flush=True)
    names = op_names_by_instruction(compiled.as_text())
    jax.block_until_ready(compiled(batched, spectrum, omega))
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(batched, spectrum, omega))
        times.append(time.perf_counter() - t0)
    print(f'[{mode}] untraced median '
          f'{statistics.median(times) * 1e3 / batch:.4f} ms/pulse '
          f'over {calls} calls', flush=True)

    with tempfile.TemporaryDirectory() as trace_dir:
        with jax.profiler.trace(trace_dir):
            for _ in range(calls):
                jax.block_until_ready(compiled(batched, spectrum, omega))
        events = device_events(trace_dir)
    if not events:
        raise SystemExit(f'[{mode}] no device events in the trace')

    kernel = sum(e - s for _, _, s, e in events)
    window = max(e for *_, e in events) - min(s for _, _, s, _ in events)
    busy = busy_ns([(s, e) for _, _, s, e in events])
    print(f'[{mode}] {len(events)} device events over {calls} calls: '
          f'kernel time {kernel / 1e6:.3f} ms, window {window / 1e6:.3f} '
          f'ms, busy {100 * busy / window:.1f} %, idle '
          f'{100 * (1 - busy / window):.1f} %')

    by_scope = collections.Counter()
    by_kernel = collections.defaultdict(lambda: [0, 0, ''])
    for name, hlo_op, s, e in events:
        by_scope[scope_of(names.get(hlo_op, ()))] += e - s
        k = by_kernel[name]
        k[0] += e - s
        k[1] += 1
        k[2] = hlo_op
    for scope in SCOPES + ('mixed',):
        if by_scope[scope]:
            print(f'[{mode}]   scope {scope}: {by_scope[scope] / 1e6:.3f} '
                  f'ms ({100 * by_scope[scope] / kernel:.1f} % of kernel '
                  f'time)')
    for name, (ns, count, hlo_op) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f'[{mode}]   {ns / 1e6:9.3f} ms {100 * ns / kernel:5.1f} % '
              f'{count:5d}x  {name[:110]}  ({hlo_op})')

    # the contraction is the longest-running float64 GEMM kernel; the
    # small ones belong to the transforms
    gemm = max((ns for name, (ns, _, _) in by_kernel.items()
                if 'gemm' in name and 'f64' in name), default=0)
    if mode == 'native' and gemm:
        G = batched.dt.shape[-1]
        d = batched.c_opers.shape[-1]
        n = batched.n_opers.shape[0] * batched.basis.shape[0]
        flop = 3 * 2 * omega.shape[0] * G * d * d * n * batch * calls
        rate = flop / gemm / 1e3
        print(f'[{mode}]   contraction GEMM kernel {gemm / 1e6:.3f} ms '
              f'({100 * gemm / kernel:.1f} %): {rate:.1f} TFLOP/s, '
              f'{100 * rate / FP64_TENSOR_PEAK:.1f} % of '
              f'{FP64_TENSOR_PEAK:.0f} TFLOP/s')


def main() -> int:
    import jax
    import filter_functions_tpu  # noqa: F401  (enables x64)
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f'trace_flagship: no GPU (default device is '
                         f'{dev.platform})')
    print(f'device: {dev.device_kind}', flush=True)
    for mode in MODES:
        trace_mode(mode, CALLS, TOP)
    return 0


if __name__ == '__main__':
    sys.exit(main())
