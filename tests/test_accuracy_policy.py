"""Randomized parity ensemble + escalation guard for the
depth-adaptive Ozaki accuracy policy.

The deep-truncation defaults (numeric._ctrlmat_contract: f32 P
assembly, reduced truncation for 1024 < K <= 16384; the escalation
guards the opt-in 23-bit fixed-point factored D) were tuned on the
flagship QFT + 1/f bench; this suite

1. sweeps seeded random pulses x spectra x dimensions through the
   SAME policy decisions the ozaki mode takes (FF_TPU_CONTRACT=ozaki runs the
   identical int8-digit/int32-accumulator decomposition on any
   backend) and pins the worst-case infidelity parity
   distribution-wide, and
2. pins the automatic full-precision escalation
   (config.ozaki_escalation_tol / numeric._deep_quant_ratio) on a
   deliberately pathological refocusing train whose filter function
   cancels by 11 orders of magnitude,

so a future "free" optimization cannot silently breach the north-star
contract on an unlucky input.

Criterion for (1): the north star is absolute infidelity parity
<= 1e-10 at the flagship's per-noise-operator infidelity scale
(~2e-4, measured: bench parity 7.88e-11 ~ 4e-7 RELATIVE).  Infidelity
is LINEAR in the spectrum, so the scale-free equivalent is relative
parity <= 5e-7; asserted here at HALF that (2.5e-7) for every
(d, seed, spectrum) combination, against the natively-f64 einsum path
(itself pinned against the reference at ~1e-13 by
tests/test_precision.py).  Measured worst case: 5.5e-8 relative
(d=8, 1/f spectrum) -- a 9x margin.
"""
import numpy as np
import pytest

import filter_functions_tpu as ff
from filter_functions_tpu import numeric

from testutil import rand_pulse_arrays, make_pulse, generate_dd_hamiltonian

# (d, G) chosen so the reduction depth K = G d^2 = 2048 lands in the
# DEEP policy window 1024 < K <= 16384 (numeric.py: deep = slice width
# 5-6 bits <=> 2^10 < K <= 2^14)
SHAPES = [(4, 128), (8, 32), (16, 8)]
N_SEEDS = 5
N_OMEGA = 200

# relative-parity ceiling: HALF of the 1e-10-absolute-at-flagship-
# scale equivalent (5e-7); measured worst case 5.5e-8
REL_TOL = 2.5e-7


def _clear_ctrlmat_caches():
    numeric._ctrlmat_scratch_cached.clear_cache()
    numeric._ctrlmat_scratch_scan.clear_cache()


def _spectra(omega):
    return {
        'white': np.full_like(omega, 1e-4),
        'one_over_f': 1e-4 / omega,
        'lorentzian': 1e-3 / (1 + omega**2),
    }


def _infidelities(pulse, omega, spectra):
    return {name: float(np.asarray(ff.infidelity(pulse, s, omega)).sum())
            for name, s in spectra.items()}


@pytest.mark.slow
def test_deep_policy_parity_ensemble(monkeypatch):
    omega = np.geomspace(1e-2, 1e2, N_OMEGA)
    spectra = _spectra(omega)

    arrays = {}
    for d, G in SHAPES:
        for seed in range(N_SEEDS):
            rng = np.random.default_rng(1000 * d + seed)
            arrays[d, seed] = rand_pulse_arrays(d, G, n_cops=2, n_nops=2,
                                                local_rng=rng)

    # Pass 1: the ozaki path (Ozaki int8 digits, deep policy,
    # escalation at its default threshold -- which must NOT fire here)
    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    _clear_ctrlmat_caches()
    got = {}
    for (d, seed), arr in arrays.items():
        pulse = make_pulse(arr)
        got[d, seed] = _infidelities(pulse, omega, spectra)

    # Pass 2: native f64 einsum oracle
    monkeypatch.setenv('FF_TPU_CONTRACT', 'native')
    _clear_ctrlmat_caches()
    worst = (0.0, None)
    for (d, seed), arr in arrays.items():
        pulse = make_pulse(arr)
        want = _infidelities(pulse, omega, spectra)
        for name in spectra:
            rel = abs(got[d, seed][name] - want[name]) / abs(want[name])
            if rel > worst[0]:
                worst = (rel, (d, seed, name))
            assert rel <= REL_TOL, (
                f'deep-policy parity breach at d={d}, seed={seed}, '
                f'spectrum={name}: relative {rel:.2e} > {REL_TOL:.0e} '
                f'(= half of 1e-10 absolute at flagship infidelity '
                f'scale)')
    _clear_ctrlmat_caches()
    print(f'worst-case relative parity {worst[0]:.2e} at {worst[1]} '
          f'(ceiling {REL_TOL:.0e})')


def _walk_eqns(jaxpr, skip_cond_branches):
    """Yield primitive names of every reachable eqn; optionally do not
    descend into ``cond`` branches (their work only runs when taken)."""
    for eqn in jaxpr.eqns:
        yield eqn.primitive.name
        if eqn.primitive.name == 'cond' and skip_cond_branches:
            continue
        for v in eqn.params.values():
            vs = v if isinstance(v, (list, tuple)) else [v]
            for x in vs:
                name = type(x).__name__
                if name == 'ClosedJaxpr':
                    yield from _walk_eqns(x.jaxpr, skip_cond_branches)
                elif name == 'Jaxpr':
                    yield from _walk_eqns(x, skip_cond_branches)


def _deep_batch(d=4, G=128, batch=2, n_omega=32):
    import jax.numpy as jnp
    from filter_functions_tpu import functional
    rng = np.random.default_rng(0)
    arr = rand_pulse_arrays(d, G, n_cops=2, n_nops=2, local_rng=rng)
    p = functional.make_pulse_arrays(make_pulse(arr))
    pb = functional.PulseArrays(
        p.c_opers, jnp.stack([p.c_coeffs * (1 + 0.01 * i)
                              for i in range(batch)]),
        p.n_opers,
        jnp.broadcast_to(p.n_coeffs, (batch,) + p.n_coeffs.shape),
        jnp.broadcast_to(p.dt, (batch,) + p.dt.shape), p.basis)
    omega = jnp.asarray(np.geomspace(1e-1, 1e1, n_omega))
    return pb, 1e-3 / omega, omega


def test_batched_fast_path_carries_no_escalation(monkeypatch):
    """Regression pin: the Ozaki escalation decision in ``batched_infidelity`` must be ONE scalar
    ``lax.cond`` hoisted outside the vmap -- never a per-pulse cond
    under the vmap, which lowers to a both-branches ``select`` and
    makes every healthy batched call pay the full-precision
    recompute.

    Pins, at a deep-policy shape (K = G d^2 = 2048):
    1. the traced program contains exactly ONE cond primitive,
    2. the dot_general count OUTSIDE that cond equals the count of the
       escalation-disabled build -- the steady-state fast pass carries
       zero full-precision contraction work,
    3. the compiled HLO retains a real ``conditional`` (it did not
       degenerate to a select)."""
    import re

    import jax
    from filter_functions_tpu import functional

    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    monkeypatch.setenv('FF_TPU_OZAKI_FACTORED', '1')
    pb, spectrum, omega = _deep_batch()

    # a FRESH callable per trace: jax caches traces on the function
    # object, and the config env knobs are read at trace time
    def fresh():
        return lambda b, s, o: functional.batched_infidelity(b, s, o)

    jx = jax.make_jaxpr(fresh())(pb, spectrum, omega)
    prims_all = list(_walk_eqns(jx.jaxpr, skip_cond_branches=False))
    dots_outside = list(_walk_eqns(jx.jaxpr,
                                   skip_cond_branches=True)
                        ).count('dot_general')
    assert prims_all.count('cond') == 1, (
        f'expected exactly one (outer, scalar) escalation cond, found '
        f'{prims_all.count("cond")}')

    monkeypatch.setenv('FF_TPU_OZAKI_ESCALATE_TOL', '0')
    jx0 = jax.make_jaxpr(fresh())(pb, spectrum, omega)
    prims0 = list(_walk_eqns(jx0.jaxpr, skip_cond_branches=False))
    monkeypatch.delenv('FF_TPU_OZAKI_ESCALATE_TOL')
    assert prims0.count('cond') == 0
    assert dots_outside == prims0.count('dot_general'), (
        f'the batched fast pass carries escalated contraction work: '
        f'{dots_outside} dot_generals outside the cond vs '
        f'{prims0.count("dot_general")} with escalation disabled')

    txt = jax.jit(fresh()).lower(pb, spectrum, omega).compile().as_text()
    assert len(re.findall(r' conditional\(', txt)) >= 1, (
        'the scalar escalation cond was lowered away (select?) -- '
        'the escalated branch would run unconditionally')


@pytest.mark.slow
def test_batched_deep_policy_parity_ensemble(monkeypatch):
    """The randomized deep-policy ensemble through
    the PRODUCTION batched entry points -- ``batched_infidelity`` and
    ``batched_error_transfer_matrix`` -- rather than the object API, so
    the batch-hoisted escalation machinery ('stat' + scalar cond) is
    itself distribution-tested.

    For each deep-policy shape (K = G d^2 = 2048) a batch of seeded
    random coefficient/dt draws over shared operators runs once under
    the ozaki policy (FF_TPU_CONTRACT=ozaki) and once under
    the native f64 oracle, through the same batched executable.
    Criterion as in test_deep_policy_parity_ensemble: relative parity
    <= 2.5e-7 (half the flagship-scale 1e-10-absolute equivalent) for
    every (d, batch entry, spectrum).  The ETM leg additionally pins
    the second-order f32 shift stage at the generator-scale tolerance
    documented in functional._so_shift_dtype (error measured relative
    to the deviation ||ETM - I||, the physical content of the map).
    """
    import jax.numpy as jnp

    from filter_functions_tpu import functional

    omega = np.geomspace(1e-2, 1e2, N_OMEGA)
    spectra = _spectra(omega)
    n_batch = 4

    def batched_arrays(d, G):
        rng = np.random.default_rng(2000 * d)
        arr = rand_pulse_arrays(d, G, n_cops=2, n_nops=2, local_rng=rng)
        p = functional.make_pulse_arrays(make_pulse(arr))
        cc = np.stack([np.asarray(p.c_coeffs)] * n_batch)
        cc *= rng.standard_normal((n_batch, 1, 1)) * 0.3 + 1.0
        nc = np.stack([rng.random(p.n_coeffs.shape) for _ in range(n_batch)])
        dts = np.stack([1 - rng.random(p.dt.shape) for _ in range(n_batch)])
        return functional.PulseArrays(
            p.c_opers, jnp.asarray(cc), p.n_opers, jnp.asarray(nc),
            jnp.asarray(dts), p.basis), p

    batches = {(d, G): batched_arrays(d, G) for d, G in SHAPES}

    def run_all(contract):
        monkeypatch.setenv('FF_TPU_CONTRACT', contract)
        out = {}
        for (d, G), (pb, p) in batches.items():
            for name, s in spectra.items():
                out[d, G, name] = np.asarray(functional.batched_infidelity(
                    pb, jnp.asarray(s), jnp.asarray(omega))).sum(axis=-1)
        return out

    got, want = run_all('ozaki'), run_all('native')
    worst = (0.0, None)
    for key, w in want.items():
        rel = (np.abs(got[key] - w) / np.abs(w)).max()
        if rel > worst[0]:
            worst = (rel, key)
        assert rel <= REL_TOL, (
            f'batched deep-policy parity breach at (d, G, spectrum)='
            f'{key}: relative {rel:.2e} > {REL_TOL:.0e}')
    print(f'batched_infidelity worst-case relative parity {worst[0]:.2e} '
          f'at {worst[1]} (ceiling {REL_TOL:.0e})')

    # ETM leg (second order: exercises the f32 shift stage + cumulant
    # contraction + expm through the batched executable)
    import filter_functions_tpu as ff_mod

    def run_etm(contract, d, G):
        monkeypatch.setenv('FF_TPU_CONTRACT', contract)
        pb, _ = batches[d, G]
        basis = ff_mod.Basis.ggm(d)
        return np.asarray(functional.batched_error_transfer_matrix(
            pb, spectra['one_over_f'], omega, basis, second_order=True))

    for d, G in SHAPES[:2]:             # d=16 ETM: four_element_traces
        got_etm = run_etm('ozaki', d, G)   # scale; covered by d=4, 8
        want_etm = run_etm('native', d, G)
        dev = np.abs(want_etm - np.eye(d * d)).max()
        rel = np.abs(got_etm - want_etm).max() / dev
        assert rel <= 5e-6, (
            f'batched ETM (second order) parity breach at d={d}: '
            f'{rel:.2e} of the deviation scale {dev:.2e}')


@pytest.mark.slow
def test_batched_escalation_on_cancellation_pathology(monkeypatch):
    """The CPMG-300 cancellation pathology through
    the PRODUCTION batched entry point.  With a low-frequency-weighted
    spectrum (S ~ 1/w^2, concentrating the integral where the train
    refocuses by ~11 orders), the unescalated fast path misses at
    ~4e-7 relative; the batch-level escalation cond must fire and
    restore parity to the 30-bit floor (measured 1.9e-9)."""
    import jax
    import jax.numpy as jnp
    from filter_functions_tpu import functional

    H, dt = generate_dd_hamiltonian(300, tau=10, tau_pi=1e-2,
                                    dd_type='cpmg')
    G = len(dt)
    Z = np.array([[1, 0], [0, -1]], complex)
    pulse = ff.PulseSequence(H, [[Z / 2, np.ones(G), 'Z']], dt)
    p = functional.make_pulse_arrays(pulse)
    batch = 2
    pb = functional.PulseArrays(
        p.c_opers, jnp.stack([p.c_coeffs, p.c_coeffs * 1.0000001]),
        p.n_opers,
        jnp.broadcast_to(p.n_coeffs, (batch,) + p.n_coeffs.shape),
        jnp.broadcast_to(p.dt, (batch,) + p.dt.shape), p.basis)
    omega = jnp.asarray(np.geomspace(1e-4, 1e2, 100))
    spectrum = jnp.asarray(1e-3 / np.asarray(omega)**2)

    def run():
        fn = jax.jit(lambda b, s, o: functional.batched_infidelity(
            b, s, o))
        return np.asarray(fn(pb, spectrum, omega))

    monkeypatch.setenv('FF_TPU_CONTRACT', 'native')
    want = run()
    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    monkeypatch.setenv('FF_TPU_OZAKI_FACTORED', '1')
    got_default = run()
    monkeypatch.setenv('FF_TPU_OZAKI_ESCALATE_TOL', '1e30')
    got_fast = run()
    monkeypatch.delenv('FF_TPU_OZAKI_ESCALATE_TOL')

    scale = np.abs(want).max()
    rel_default = np.abs(got_default - want).max() / scale
    rel_fast = np.abs(got_fast - want).max() / scale
    # the unescalated fast path is demonstrably off ...
    assert rel_fast > 1e-7, (
        f'pathology no longer discriminates through the integral: '
        f'{rel_fast:.2e}')
    # ... and the batch-level escalation fixes it
    assert rel_default < 1e-8, (
        f'batch-level escalation failed to fire or to restore parity: '
        f'{rel_default:.2e} (unescalated: {rel_fast:.2e})')


@pytest.mark.slow
def test_escalation_on_cancellation_pathology(monkeypatch):
    """A deep (K = 2404) CPMG-300 train refocuses its dephasing FF by
    ~11 orders of magnitude at small omega; the factored fast path's
    operand quantization leaves ~1e-3 relative error there.  The
    in-graph estimator must fire (it reads 5.7 vs threshold 0.1) and
    the escaped full-precision branch must restore elementwise parity
    to the f64 floor of that dynamic range."""
    H, dt = generate_dd_hamiltonian(300, tau=10, tau_pi=1e-2,
                                    dd_type='cpmg')
    G = len(dt)
    Z = np.array([[1, 0], [0, -1]], complex)
    omega = np.geomspace(1e-4, 1e2, 100)

    def build_ff():
        _clear_ctrlmat_caches()
        pulse = ff.PulseSequence(H, [[Z / 2, np.ones(G), 'Z']], dt)
        return np.asarray(pulse.get_filter_function(omega).to_numpy())

    monkeypatch.setenv('FF_TPU_CONTRACT', 'ozaki')
    monkeypatch.setenv('FF_TPU_OZAKI_FACTORED', '1')
    f_default = build_ff()                      # escalation on (default)
    monkeypatch.setenv('FF_TPU_OZAKI_ESCALATE_TOL', '1e30')
    f_fast = build_ff()                         # escalation disabled
    monkeypatch.delenv('FF_TPU_OZAKI_ESCALATE_TOL')
    monkeypatch.setenv('FF_TPU_CONTRACT', 'native')
    f_native = build_ff()
    _clear_ctrlmat_caches()

    floor = np.abs(f_native).max() * 1e-30
    rel_default = (np.abs(f_default - f_native)
                   / np.maximum(np.abs(f_native), floor)).max()
    rel_fast = (np.abs(f_fast - f_native)
                / np.maximum(np.abs(f_native), floor)).max()
    # the unescalated path is demonstrably broken elementwise ...
    assert rel_fast > 3e-4, f'pathology no longer pathological: {rel_fast:.2e}'
    # ... and the default (escalated) path fixes it
    assert rel_default < 1e-4, (
        f'escalation failed to fire or to restore parity: '
        f'{rel_default:.2e} (fast path: {rel_fast:.2e})')
