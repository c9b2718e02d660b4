"""Author and execute the tutorial notebook corpus under doc/notebooks/.

The reference ships its documentation as executable Sphinx notebooks
(/root/reference/doc/source/examples/*.ipynb); this script is the
repo's analog of that corpus: each notebook below mirrors one
reference notebook topic-for-topic, written against the library's
API.  Notebooks are authored programmatically (so they stay in sync
with the API and are regenerable in CI) and executed on the host CPU
backend before being written, so the committed .ipynb files carry
their outputs -- a rendered doc build.

Usage:
    python scripts/build_notebooks.py                # build + execute all
    python scripts/build_notebooks.py --only getting_started
    python scripts/build_notebooks.py --no-exec      # author only
"""
import argparse
import sys
from pathlib import Path

import nbformat
from nbclient import NotebookClient

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / 'doc' / 'notebooks'

# Shared first cell: locate the package from wherever the notebook is
# opened, and pin the host CPU backend (tutorial-scale problems are
# latency-bound).
BOOTSTRAP = """\
import sys
from pathlib import Path

root = next(p for p in [Path.cwd(), *Path.cwd().parents]
            if (p / 'filter_functions_tpu').is_dir())
sys.path.insert(0, str(root))

import jax

# The tutorials run on the host CPU: at these problem sizes an
# accelerator round trip costs more than the math.  On a GPU, drop
# this line and use the batched fused APIs (the `functional` module)
# that make the accelerator pay off.
jax.config.update('jax_platforms', 'cpu')

import numpy as np
from math import pi

import filter_functions_tpu as ff
from filter_functions_tpu import util"""

PLOT_SETUP = """\
%matplotlib inline
import matplotlib.pyplot as plt
from filter_functions_tpu import plotting"""


def md(text):
    return ('markdown', text)


def code(src):
    return ('code', src)


NOTEBOOKS = {}

# ---------------------------------------------------------------------------
# getting_started
# ---------------------------------------------------------------------------
NOTEBOOKS['getting_started'] = [
    md("""\
# First steps

`filter_functions_tpu` computes **filter functions**: the transfer
functions that tell you how strongly a driven quantum system picks up
noise at each frequency.  Given a pulse sequence -- a piecewise-constant
control Hamiltonian -- and the power spectral density $S(\\omega)$ of a
classical noise source coupling through an operator $B_\\alpha$, the
gate infidelity is (to leading order) a frequency-domain overlap

$$\\mathcal{I} \\approx \\frac{1}{2\\pi d}
  \\int d\\omega\\, S(\\omega)\\, F(\\omega),$$

so the filter function $F(\\omega)$ is all you need to judge a pulse
against *any* noise environment.

This notebook mirrors the reference package's getting-started tutorial
(`filter_functions`' `getting_started.ipynb`): we build a Hadamard gate
from two primitive rotations, compute its dephasing filter function,
and evaluate infidelities for white and $1/f$ spectra."""),
    code(BOOTSTRAP),
    md("""\
## A simple example

A Hadamard can be assembled from a $\\pi/2$ rotation about $y$
followed by a $\\pi$ rotation about $x$.  A `PulseSequence` takes the
control Hamiltonian, the noise Hamiltonian, and the segment durations;
each Hamiltonian is a list of `[operator, coefficients, identifier]`
triples with one coefficient per time segment.  Here the qubit couples
to dephasing ($\\sigma_z$) noise with constant sensitivity 1."""),
    code("""\
I2, X, Y, Z = util.paulis

H_c = [[X / 2, [0, pi], 'X'],
       [Y / 2, [pi / 2, 0], 'Y']]
H_n = [[Z / 2, [1, 1], 'Z']]
dt = [1, 1]

hadamard = ff.PulseSequence(H_c, H_n, dt)
hadamard"""),
    md("""\
The total propagator should implement a Hadamard up to a global
phase -- `util.oper_equiv` checks exactly that.  (Device-side complex
matrices live in the split-real `C` pytree; `.to_numpy()` converts to
an ordinary complex ndarray.)"""),
    code("""\
H_gate = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
equal, phase = util.oper_equiv(hadamard.total_propagator.to_numpy(),
                               H_gate)
print(f'propagator is a Hadamard: {equal} '
      f'(global phase {phase:+.3f} rad)')"""),
    md("""\
## The filter function

`util.get_sample_frequencies` picks a sensible default grid spanning
the pulse's inverse duration and inverse segment length.  The fidelity
filter function has shape `(n_nopers, n_nopers, n_omega)`; its
$\\omega \\to 0$ limit for dephasing noise counts the frozen phase
accumulated by the pulse."""),
    code("""\
omega = util.get_sample_frequencies(hadamard, n_samples=400)
F = hadamard.get_filter_function(omega).to_numpy().real
print(f'F shape: {F.shape}')
print(f'DC limit F(omega -> 0) = {F[0, 0, 0]:.4f}')"""),
    code(PLOT_SETUP),
    code("""\
fig, ax, legend = plotting.plot_filter_function(hadamard, omega)"""),
    md("""\
The pulse train itself (the control coefficients over time) has its
own plot helper:"""),
    code("""\
fig, ax, legend = plotting.plot_pulse_train(hadamard)"""),
    md("""\
## Infidelities

`ff.infidelity` integrates $S(\\omega) F(\\omega)$ over the grid.  The
spectrum can be an array on `omega` or a callable; one value is
returned per noise operator."""),
    code("""\
for name, S in [('white', 1e-4 * np.ones_like(omega)),
                ('1/f', 1e-4 / omega)]:
    infid = np.asarray(ff.infidelity(hadamard, S, omega))
    print(f'{name:>5} noise infidelity: {infid.sum():.3e}')"""),
    md("""\
### Generalized filter functions

`which='fidelity'` (the default) traces out the basis indices needed
for the average gate fidelity.  `which='generalized'` keeps them:
shape `(n_nopers, n_nopers, d^2, d^2, n_omega)`, resolving *which*
basis directions of the error the noise feeds -- the object needed for
decay amplitudes and the error transfer matrix later in the tutorial
series."""),
    code("""\
F_gen = hadamard.get_filter_function(omega, which='generalized')
print('generalized FF shape:', F_gen.shape)"""),
    md("""\
## Convergence of the frequency integral

Since the infidelity is a numerical quadrature, always check it is
converged in the grid density.  `test_convergence=True` sweeps the
number of samples; the sweep runs over a single padded grid shape so
it compiles once."""),
    code("""\
n_samples, infids = ff.infidelity(
    hadamard, lambda w: 1e-4 / w,
    {'n_min': 100, 'n_max': 1000, 'n_points': 5},
    test_convergence=True)
fig, ax = plotting.plot_infidelity_convergence(
    np.asarray(n_samples), np.asarray(infids))"""),
    md("""\
## Where to go next

- `advanced_concatenation.ipynb` -- composing pulses with `@` and
  attributing infidelity to pulse-pair interference terms.
- `periodic_driving.ipynb` -- filter functions of $10^4$-fold repeated
  pulses in closed form.
- `quantum_fourier_transform.ipynb` -- a full 4-qubit algorithm.
- `PERF.md` -- measured performance on the GPU, and the batched
  fused APIs (`functional.batched_infidelity` evaluates hundreds of
  pulses in one device call)."""),
]

# ---------------------------------------------------------------------------
# advanced_concatenation
# ---------------------------------------------------------------------------
NOTEBOOKS['advanced_concatenation'] = [
    md("""\
# Advanced concatenation

Composing pulses is where filter functions earn their keep: the
control matrix of a concatenated sequence is an *algebraic* function
of the constituents' cached control matrices, so a long composite
never has to be recomputed from scratch.  This notebook builds a spin
echo from primitives, shows the cache reuse, and then splits the echo
filter function into **pulse-correlation** contributions
$F^{(gg')}(\\omega)$ that expose the interference between constituent
pulses.  It mirrors the reference's `advanced_concatenation.ipynb`."""),
    code(BOOTSTRAP),
    code(PLOT_SETUP),
    md("""\
## Spin echo from primitives

Free evolution for a time $\\tau$, a $\\pi_x$ pulse, free evolution
again.  Both primitives couple to dephasing noise."""),
    code("""\
tau, segments = 10.0, 50
I2, X, Y, Z = util.paulis
dt = np.full(segments, tau / segments)

wait = ff.PulseSequence([[X / 2, np.zeros(segments), 'X']],
                        [[Z / 2, np.ones(segments), 'Z']], dt)
pi_x = ff.PulseSequence([[X / 2, np.full(segments, pi / tau), 'X']],
                        [[Z / 2, np.ones(segments), 'Z']], dt)

omega = util.get_sample_frequencies(wait, n_samples=400)"""),
    md("""\
Cache the atomic filter functions once; afterwards every composite
built from these pulses reuses them.  The `@` operator concatenates
(rightmost acts first, like operator products)."""),
    code("""\
import time

t0 = time.perf_counter()
wait.cache_filter_function(omega)
pi_x.cache_filter_function(omega)
t_atomic = time.perf_counter() - t0

t0 = time.perf_counter()
echo = wait @ pi_x @ wait
t_echo = time.perf_counter() - t0

print(f'atomic FFs:        {t_atomic:7.4f} s')
print(f'echo = w @ pi @ w: {t_echo:7.4f} s '
      f'(FF cached: {echo.is_cached("filter function")})')"""),
    md("""\
The cached composition is exact -- compare against building the
150-segment sequence and computing its filter function from
scratch:"""),
    code("""\
scratch = ff.concatenate_without_filter_function([wait, pi_x, wait])
f_cached = echo.get_filter_function(omega).to_numpy()
f_scratch = scratch.get_filter_function(omega).to_numpy()
print(f'cached vs scratch max |diff|: '
      f'{np.abs(f_cached - f_scratch).max():.3e}')"""),
    code("""\
fig, ax, legend = plotting.plot_filter_function(echo, omega)
ax.set_title('spin echo dephasing filter function')"""),
    md("""\
The echo's hallmark: $F(\\omega) \\to 0$ as $\\omega^4$ at DC (the
$\\pi$ pulse refocuses quasistatic noise), with the noise sensitivity
pushed out to $\\omega \\sim \\pi/\\tau$.

## Pulse-correlation filter functions

Passing `calc_pulse_correlation_FF=True` to `ff.concatenate` keeps
the cross terms $F^{(gg')}$ between constituents $g, g'$ instead of
summing them.  The diagonal blocks are the constituents' own filter
functions (phase-shifted to their position in the sequence); the
off-diagonal blocks are interference terms, and they are what makes
the echo better than the sum of its parts."""),
    code("""\
echo_pc = ff.concatenate([wait, pi_x, wait],
                         calc_pulse_correlation_FF=True, omega=omega)
f_pc = echo_pc.get_pulse_correlation_filter_function().to_numpy()
print(f'F^(gg\\') shape: {f_pc.shape}   (g indexes the 3 pulses)')

total = f_pc.sum(axis=(0, 1)).real
print('sum over (g, g\\') recovers the total FF:',
      np.allclose(total, f_cached.real, atol=1e-12))"""),
    code("""\
fig, ax, legend = plotting.plot_pulse_correlation_filter_function(
    echo_pc)"""),
    md("""\
With the correlation filter functions cached, `ff.infidelity` can
attribute the total infidelity to pulse pairs
(`which='correlations'`).  For $1/f$ noise the negative off-diagonal
entries are the refocusing at work:"""),
    code("""\
S = 1e-4 / omega
infid_pc = np.asarray(ff.infidelity(echo_pc, S, omega,
                                    which='correlations'))
print('per-(g, g\\') infidelity contributions:')
print(infid_pc.squeeze().round(9))
print(f'total = {infid_pc.sum():.3e}')"""),
    md("""\
## Second-order filter functions

The leading-order infidelity is quadratic in the noise; pushing the
Magnus expansion one order further yields second-order filter
functions, `order=2`.  They feed the frequency-shift terms of the
error transfer matrix (see `calculating_quantum_processes.ipynb`) and
are likewise composable under concatenation -- the concatenation rule
for order 2 reuses the constituents' cached first-order control
matrices plus a cumulative phase cache."""),
    code("""\
F2 = echo.get_filter_function(omega, order=2)
print('second-order FF shape:', F2.shape)"""),
    md("""\
## Composing optimized gates: the X2ID/Y2ID goldens

The reference ships two *optimized* $\\pi/2$ exchange pulses
(`examples/data/X2ID.mat`, `Y2ID.mat`, from Cerfontaine et al.) that
realize $\\sqrt{X}$ and $\\sqrt{Y}$ on an exchange-coupled spin qubit:
100-segment trajectories $J(t) = e^{\\epsilon(t)}$ driving
$H = J(t)\\,\\sigma_x/2 + B\\,\\sigma_z/2$ with charge noise entering
through the exchange (sensitivity $\\partial J/\\partial\\epsilon =
J$).  Composing them into a Hadamard $= Y_{\\pi/2} X_{\\pi/2}
X_{\\pi/2}$ from their cached filter functions exercises the cache
reuse on real optimized-control data instead of textbook primitives
(mirrors reference `advanced_concatenation.ipynb` cells 4-14)."""),
    code("""\
from pathlib import Path
from scipy.io import loadmat

data_path = Path('/root/reference/examples/data')
if data_path.exists():
    gates = {}
    for name in ('X2ID', 'Y2ID'):
        struct = loadmat(str(data_path / (name + '.mat')))
        J = np.exp(np.asarray(struct['eps'], order='C'))[0]
        dt_g = np.asarray(struct['t'].ravel(), order='C')
        B = np.asarray(struct['B'].ravel(), order='C')[0]
        gates[name] = ff.PulseSequence(
            [[X / 2, J, 'J'], [Z / 2, B * np.ones(len(dt_g)), 'B']],
            [[X / 2, J, 'J']], dt_g)
    tau_g = float(np.asarray(gates['X2ID'].tau))
    omega_g = np.linspace(0, 1e2 / tau_g, 301)
    for p in gates.values():
        p.cache_filter_function(omega_g)
    hadamard = ff.concatenate(
        (gates['Y2ID'], gates['X2ID'], gates['X2ID']),
        calc_pulse_correlation_FF=True)
    f_pc_g = hadamard.get_pulse_correlation_filter_function().to_numpy()
    f_tot = hadamard.get_filter_function(omega_g).to_numpy()
    print('correlations sum to total:',
          np.allclose(f_pc_g.sum(axis=(0, 1)), f_tot, atol=1e-12))
    fig, ax, legend = plotting.plot_pulse_correlation_filter_function(
        hadamard, xscale='linear')
else:
    print('golden data not found; skipping')"""),
]

# ---------------------------------------------------------------------------
# calculating_quantum_processes
# ---------------------------------------------------------------------------
NOTEBOOKS['calculating_quantum_processes'] = [
    md("""\
# Calculating quantum processes

Beyond a single infidelity number, the filter-function formalism
yields the full noisy quantum *process*: the error transfer matrix
$\\exp(\\mathcal{K})$ whose cumulant $\\mathcal{K}$ collects decay
amplitudes $\\Gamma$ (second order in noise, dissipative) and
frequency shifts $\\Delta$ (unitary, from the second-order Magnus
term).  This notebook mirrors the reference's
`calculating_quantum_processes.ipynb`: custom bases, decay
amplitudes, frequency shifts, the cumulant function, complete
positivity, and convergence."""),
    code(BOOTSTRAP),
    code(PLOT_SETUP),
    md("""\
## Defining a custom basis

Process quantities are expanded in an operator basis.  Two built-ins
cover most cases -- `Basis.pauli(n)` (separable, required for
`extend`/`remap`) and `Basis.ggm(d)` (generalized Gell-Mann, any
dimension).  `Basis.from_partial` completes a partial set of
orthonormal Hermitian operators into a full basis, which is useful
when you care about specific error channels:"""),
    code("""\
I2, X, Y, Z = util.paulis
partial = [Z / np.sqrt(2)]          # normalize: tr(B_i B_j) = d_ij
basis_z = ff.Basis.from_partial(partial)
print(basis_z)
print('orthonormal:', basis_z.isorthonorm, ' traceless:',
      basis_z.istraceless)"""),
    md("""\
## A NOT gate with two noise channels

A resonant $\\pi_x$ rotation over 20 segments, with dephasing
($\\sigma_z$) *and* amplitude ($\\sigma_x$) noise, both $1/f$."""),
    code("""\
segments = 20
dt = np.full(segments, 1.0 / segments)
pulse = ff.PulseSequence(
    [[X / 2, np.full(segments, pi), 'X']],
    [[Z / 2, np.ones(segments), 'Z'],
     [X / 2, np.ones(segments), 'X']],
    dt, basis=ff.Basis.pauli(1))

omega = util.get_sample_frequencies(pulse, n_samples=400)
S = 1e-4 / omega"""),
    md("""\
## Decay amplitudes and frequency shifts

$\\Gamma_{\\alpha\\beta,kl}$ is the frequency integral of the
generalized filter function against the spectrum -- the dissipative
part of the process.  $\\Delta_{\\alpha\\beta,kl}$ comes from the
second-order (Magnus) filter function -- a coherent, unitary
error."""),
    code("""\
from filter_functions_tpu import numeric

gamma = np.asarray(numeric.calculate_decay_amplitudes(pulse, S, omega))
delta = np.asarray(numeric.calculate_frequency_shifts(pulse, S, omega))
print(f'decay amplitudes  Gamma: {gamma.shape}')
print(f'frequency shifts  Delta: {delta.shape}')"""),
    md("""\
## The cumulant function and the error transfer matrix

`error_transfer_matrix` exponentiates the cumulant.  With
`second_order=True` the frequency shifts are included; for this
weakly-noisy gate they move the process at the $10^{-6}$ level."""),
    code("""\
K1 = np.asarray(numeric.calculate_cumulant_function(
    pulse, S, omega, second_order=False))
U1 = np.asarray(ff.error_transfer_matrix(pulse, S, omega))
U2 = np.asarray(ff.error_transfer_matrix(pulse, S, omega,
                                         second_order=True))
print(f'cumulant shape {K1.shape}')
print(f'second-order shift of exp(K): {np.abs(U2 - U1).max():.3e}')"""),
    code("""\
fig, grid = plotting.plot_cumulant_function(pulse, S, omega)"""),
    md("""\
## Deriving quantities

### Entanglement fidelity

The trace of $\\Gamma$ gives back the leading-order infidelity -- a
useful consistency identity between the process-level and
fidelity-level descriptions:"""),
    code("""\
infid = np.asarray(ff.infidelity(pulse, S, omega)).sum()
approx = gamma.trace(axis1=-2, axis2=-1).sum().real / pulse.d
print(f'infidelity         {infid:.6e}')
print(f'tr(Gamma)/d        {approx:.6e}')"""),
    md("""\
### Complete positivity

The error transfer matrix composed with the ideal propagator's
Liouville representation should be (numerically) a completely
positive map -- its Choi matrix positive semidefinite:"""),
    code("""\
from filter_functions_tpu import superoperator

total = U2 @ np.asarray(pulse.total_propagator_liouville)
cp = superoperator.liouville_is_CP(total, pulse.basis)
print('full process completely positive:', bool(np.asarray(cp)))"""),
    md("""\
## Convergence of the frequency integral

Process quantities inherit the quadrature grid; sweep it the same way
as for infidelities before trusting small numbers:"""),
    code("""\
n_samples, infids = ff.infidelity(
    pulse, lambda w: 1e-4 / w,
    {'n_min': 200, 'n_max': 800, 'n_points': 4},
    test_convergence=True)
fig, ax = plotting.plot_infidelity_convergence(
    np.asarray(n_samples), np.asarray(infids))"""),
    md("""\
## Validating against Monte-Carlo goldens: X2ID / Y2ID

The optimized $\\sqrt{X}\\otimes\\mathbb{1}$ / $\\sqrt{Y}\\otimes
\\mathbb{1}$ exchange pulses ship with Monte-Carlo reference
infidelities (`infid_fast` in `X2ID.mat` / `Y2ID.mat`) -- a
framework-*external* oracle for the full process pipeline.  Rebuild
the 4-spin exchange Hamiltonian on its 6-level zero-spin subspace,
complete the qubit-subspace Pauli basis with `Basis.from_partial`,
compute the second-order error transfer matrix under $1/f^{0.7}$
charge noise on the two active couplings, and compare
$1 - |\\mathrm{tr}\\,\\tilde{U}|/d^2$ against the Monte-Carlo value
(mirrors reference `calculating_quantum_processes.ipynb` cells
4-21)."""),
    code("""\
from pathlib import Path
from scipy.io import loadmat

data_path = Path('/root/reference/examples/data')
if data_path.exists():
    sig = [np.eye(2), X, Y, Z]

    def kron4(*ops):
        out = np.ones((1, 1), complex)
        for op in ops:
            out = np.kron(out, op)
        return out

    Id = sig[0]
    H6 = [sum(kron4(*[P if i in pair else Id for i in range(4)])
              for P in sig[1:]).real / 4
          for pair in ((0, 1), (1, 2), (2, 3))]
    zw = [(-3, 1, 1, 1), (-2, -2, 2, 2), (-1, -1, -1, 3)]
    H6 += [sum(w * kron4(*[Z if i == j else Id for i in range(4)])
               for j, w in enumerate(ws)).real / 8 for ws in zw]
    subspace = np.ix_((3, 5, 6, 9, 10, 12), (3, 5, 6, 9, 10, 12))
    opers = [h[subspace] for h in H6]
    opers = [op - np.trace(op) / 6 * np.eye(6) for op in opers]

    sub = ff.Basis.pauli(2)
    basis6 = ff.Basis.from_partial(
        [np.pad(b, 1, 'constant') for b in sub], labels=list(sub.labels))

    eps0 = 2.7241e-4
    alpha = 0.7
    amp = 4e-11 / eps0**2 * (2 * np.pi * 1e-3)**alpha
    ids = ['J_12', 'J_23', 'J_34', 'b_12', 'b_23', 'b_34']

    print('gate    ours         Monte Carlo  rel. dev.')
    for name in ('X2ID', 'Y2ID'):
        struct = loadmat(str(data_path / (name + '.mat')))
        J = np.exp(np.asarray(struct['eps'], order='C'))
        dt_g = np.asarray(struct['t'].ravel(), order='C')
        B = np.asarray(struct['B'].ravel(), order='C')
        golden = struct['infid_fast'].ravel()[1]
        n = len(dt_g)
        c_coeffs = [J[0], J[1], J[2], B[0] * np.ones(n),
                    B[1] * np.ones(n), B[2] * np.ones(n)]
        n_coeffs = [J[0], J[1], J[2], np.ones(n), np.ones(n), np.ones(n)]
        p6 = ff.PulseSequence(list(zip(opers, c_coeffs, ids)),
                              list(zip(opers, n_coeffs, ids)),
                              dt_g, basis=basis6)
        omega6 = np.geomspace(1 / float(np.asarray(p6.tau)), 1e2, 300)
        etm = np.asarray(ff.error_transfer_matrix(
            p6, amp / omega6**alpha, omega6, ['J_12', 'J_34'],
            second_order=True))
        ours = 1 - abs(np.trace(etm[:16, :16])) / 16
        print(f'{name}  {ours:.6e}  {golden:.6e}  '
              f'{abs(1 - ours / golden):.1e}')
else:
    print('golden data not found; skipping')"""),
]

# ---------------------------------------------------------------------------
# extending_pulses
# ---------------------------------------------------------------------------
NOTEBOOKS['extending_pulses'] = [
    md("""\
# Extending pulses

`ff.extend` maps pulses defined on single qubits onto a larger
register, and `ff.remap` permutes the qubits of an existing pulse.
Both operate on the *cached* filter-function data: a cached control
matrix is scaled and scattered into the larger register's Pauli basis
instead of being recomputed, which is what makes assembling algorithm
filter functions from gate primitives cheap (the QFT notebook leans
on this heavily).  Mirrors the reference's `extending_pulses.ipynb`."""),
    code(BOOTSTRAP),
    md("""\
## Single-qubit primitives

Extension requires a separable (Pauli) basis.  A NOT gate and an
idling pulse, each with dephasing noise:"""),
    code("""\
I2, X, Y, Z = util.paulis
segments = 20
dt = np.full(segments, 1.0 / segments)

not_q = ff.PulseSequence([[X / 2, np.full(segments, pi), 'X']],
                         [[Z / 2, np.ones(segments), 'Z']],
                         dt, basis=ff.Basis.pauli(1))
idle = ff.PulseSequence([[X / 2, np.zeros(segments), 'X']],
                        [[Z / 2, np.ones(segments), 'Z']],
                        dt, basis=ff.Basis.pauli(1))

omega = util.get_sample_frequencies(not_q, n_samples=200)
not_q.cache_filter_function(omega)
idle.cache_filter_function(omega)"""),
    md("""\
## NOT on qubit 0, idle on qubit 1

Each entry of `extend` is `(pulse, qubit, identifier_mapping)`.  The
result is a two-qubit pulse whose filter function arrives *already
cached*:"""),
    code("""\
import time

t0 = time.perf_counter()
two_qubit = ff.extend([(not_q, 0, {'X': 'X_0', 'Z': 'Z_0'}),
                       (idle, 1, {'X': 'X_1', 'Z': 'Z_1'})])
t_ext = time.perf_counter() - t0
print(f'extend with cache reuse: {t_ext:7.4f} s '
      f'(FF cached: {two_qubit.is_cached("filter function")})')
print(f'd = {two_qubit.d}, noise operators: '
      f'{two_qubit.n_oper_identifiers.tolist()}')"""),
    md("""\
Validate against the explicitly constructed register (tensor-product
operators, `Basis.pauli(2)`):"""),
    code("""\
H_c = [[util.tensor(X / 2, I2), np.full(segments, pi), 'X_0'],
       [util.tensor(I2, X / 2), np.zeros(segments), 'X_1']]
H_n = [[util.tensor(Z / 2, I2), np.ones(segments), 'Z_0'],
       [util.tensor(I2, Z / 2), np.ones(segments), 'Z_1']]
explicit = ff.PulseSequence(H_c, H_n, dt, basis=ff.Basis.pauli(2))

f_ext = two_qubit.get_filter_function(omega).to_numpy()
f_exp = explicit.get_filter_function(omega).to_numpy()
print(f'extended vs explicit max |diff|: '
      f'{np.abs(f_ext - f_exp).max():.3e}')"""),
    md("""\
## Additional noise on the register

Noise that only exists on the larger register -- here a $ZZ$
entangling noise term -- is supplied via
`additional_noise_Hamiltonian`.  (Its filter function cannot be
inherited from the constituents, so caches involving it are
recomputed; the package warns when cached data has to be dropped.)"""),
    code("""\
with_zz = ff.extend(
    [(not_q, 0, {'X': 'X_0', 'Z': 'Z_0'}),
     (idle, 1, {'X': 'X_1', 'Z': 'Z_1'})],
    additional_noise_Hamiltonian=[
        [util.tensor(Z, Z) / 4, np.ones(segments), 'ZZ']])
print('noise operators:', with_zz.n_oper_identifiers.tolist())"""),
    md("""\
## Remapping qubit order

`ff.remap` permutes qubits by permuting the Pauli-basis index of the
cached control matrix -- no recomputation.  Relabeling qubits leaves
each identifier's filter function invariant:"""),
    code("""\
swapped = ff.remap(two_qubit, (1, 0))
f_swap = swapped.get_filter_function(omega).to_numpy()
print('remap keeps FF cached:',
      swapped.is_cached('filter function'))
print('per-identifier FFs invariant:',
      np.allclose(f_swap, f_ext, atol=1e-14))"""),
]

# ---------------------------------------------------------------------------
# periodic_driving
# ---------------------------------------------------------------------------
NOTEBOOKS['periodic_driving'] = [
    md("""\
# Periodic driving

Dynamical decoupling sequences and driven gates repeat one atomic
pulse many times.  There are three ways to get the repeated pulse's
filter function, spanning about three orders of magnitude in cost:

1. **from scratch** over all $N \\times n_\\text{seg}$ segments,
2. **standard concatenation** of $N$ cached copies (the phase-update
   rule applied $N-1$ times -- here recognized as a uniform train and
   collapsed further),
3. **`concatenate_periodic`**: the concatenation recursion for an
   identical repeated block is a matrix geometric series
   $\\sum_{n<N} T^n$, evaluated in closed form with
   $2\\log_2 N$ matrix products.

Mirrors the reference's `periodic_driving.ipynb`, where the same
three methods took 38 s / 0.9 s / 0.06 s."""),
    code(BOOTSTRAP),
    code(PLOT_SETUP),
    md("""\
## The atomic pulse

A resonantly driven NOT gate (rotating frame), dephasing noise, on a
log-spaced grid dense enough to resolve the comb the repetition will
produce:"""),
    code("""\
segments, repeats = 20, 10_000
I2, X, Y, Z = util.paulis

amp = pi / segments
atomic = ff.PulseSequence(
    [[X / 2, np.full(segments, amp), 'X']],
    [[Z / 2, np.ones(segments), 'Z']],
    np.full(segments, 1.0 / segments))

omega = util.get_sample_frequencies(atomic, n_samples=400,
                                    spacing='log')"""),
    md("""\
First calls pay one-time jit compilation; warm the executables on a
tiny repeat count so the timings below measure the algorithms, not
the compiler:"""),
    code("""\
import time

t0 = time.perf_counter()
atomic.cache_filter_function(omega)
print(f'atomic FF:              {time.perf_counter() - t0:8.4f} s')

_ = ff.concatenate_periodic(atomic, 3)       # compile warmup
_ = ff.concatenate([atomic] * 3)

t0 = time.perf_counter()
periodic = ff.concatenate_periodic(atomic, repeats)
print(f'periodic (closed form): {time.perf_counter() - t0:8.4f} s')

t0 = time.perf_counter()
standard = ff.concatenate([atomic] * repeats)
print(f'standard concatenate:   {time.perf_counter() - t0:8.4f} s')"""),
    code("""\
f_per = periodic.get_filter_function(omega).to_numpy()
f_std = standard.get_filter_function(omega).to_numpy()
print(f'periodic vs standard max |diff|: '
      f'{np.abs(f_per - f_std).max():.3e}')"""),
    md("""\
## Comparison to the brute-force method

For a (much) smaller repeat count the from-scratch computation over
every segment is still feasible and agrees to machine precision:"""),
    code("""\
small = 100
t0 = time.perf_counter()
brute = ff.concatenate_without_filter_function([atomic] * small)
f_brute = brute.get_filter_function(omega).to_numpy()
t_brute = time.perf_counter() - t0

f_small = ff.concatenate_periodic(
    atomic, small).get_filter_function(omega).to_numpy()
print(f'brute force over {small * segments} segments: '
      f'{t_brute:.2f} s, max |diff| vs closed form '
      f'{np.abs(f_small - f_brute).max():.3e}')"""),
    md("""\
## The frequency comb

Repetition concentrates the filter function into narrow peaks at the
harmonics of the repetition frequency $2\\pi/\\tau_\\text{atomic}$ --
the repeated pulse only passes noise resonant with its own cycle.
This is the working principle of pulsed noise spectroscopy (see
`examples/noise_spectroscopy.py` for the reconstruction built on
it):"""),
    code("""\
fig, ax, legend = plotting.plot_filter_function(periodic, omega)
ax.set_title(f'NOT gate repeated {repeats} times')"""),
    md("""\
## Weak and strong driving

In the weak-driving regime the comb sits at the bare repetition
harmonics.  Driving strongly enough that the Rabi frequency is
comparable to the repetition rate dresses the qubit and splits the
response into Rabi sidebands -- compare the combs:"""),
    code("""\
strong = ff.PulseSequence(
    [[X / 2, np.full(segments, 20 * amp), 'X']],
    [[Z / 2, np.ones(segments), 'Z']],
    np.full(segments, 1.0 / segments))
strong.cache_filter_function(omega)

f_weak = f_per[0, 0].real
f_strong = ff.concatenate_periodic(
    strong, repeats).get_filter_function(omega).to_numpy()[0, 0].real

fig, ax = plt.subplots(figsize=(7, 4))
ax.loglog(omega, f_weak, label='weak driving')
ax.loglog(omega, f_strong, label='strong driving (20x)', alpha=0.7)
ax.set_xlabel(r'$\\omega$ (1/t)')
ax.set_ylabel(r'$F(\\omega)$')
ax.legend()
ax.set_title('dephasing FF of the repeated pulse')"""),
]

# ---------------------------------------------------------------------------
# quantum_fourier_transform
# ---------------------------------------------------------------------------
NOTEBOOKS['quantum_fourier_transform'] = [
    md("""\
# Implementing a quantum Fourier transform

The package's flagship workload: the filter function of a full
4-qubit QFT circuit ($d = 16$, with local and exchange noise on
every qubit -- 18 noise operators), mirroring the
reference's `quantum_fourier_transform.ipynb`.  The circuit is
assembled from single- and two-qubit primitives with exactly the
tools from the earlier notebooks -- `extend` to embed gates into the
register, `remap` to move them between qubits, concatenation to chain
them -- packaged in `filter_functions_tpu.models.qft`."""),
    code(BOOTSTRAP),
    code(PLOT_SETUP),
    md("""\
## Assembling the circuit

`models.qft.qft_pulse` builds the canonical QFT decomposition
(Hadamards + controlled phases via exchange interactions, with the
usual trailing bit-reversal left implicit).  The build groups
reoccurring gates so each distinct primitive's filter function is
computed once and reused at every occurrence."""),
    code("""\
from filter_functions_tpu.models import qft

n_qubits = 4
pulse = qft.qft_pulse(n_qubits)
print(f'd = {pulse.d}, {len(pulse)} segments, '
      f'{len(pulse.n_opers)} noise operators: '
      f'{pulse.n_oper_identifiers.tolist()}')"""),
    md("""\
Check the action: the propagator times the bit-reversal SWAP network
must equal the exact QFT unitary up to global phase."""),
    code("""\
prop = qft.swap_all(n_qubits) @ pulse.total_propagator.to_numpy()
equal, phase = util.oper_equiv(prop, qft.qft_propagator(n_qubits),
                               eps=1e-10)
print(f'correct action: {equal} (global phase {phase:+.4f})')"""),
    md("""\
## Filter functions of the algorithm"""),
    code("""\
omega = np.logspace(-2, 2, 300)
F = pulse.get_filter_function(omega)
print('fidelity FF shape:', F.shape)

fig, ax, legend = plotting.plot_filter_function(pulse, omega)
ax.legend(bbox_to_anchor=(1.05, 1), loc=2, borderaxespad=0.)"""),
    md("""\
## Infidelity with per-channel attribution

One $1/f$ spectrum per noise operator; `ff.infidelity` returns one
number per channel, so you can see which qubit's noise dominates the
algorithm error:"""),
    code("""\
S = 1e-4 / omega
infid = np.asarray(ff.infidelity(pulse, S, omega))
for ident, i in zip(pulse.n_oper_identifiers, infid):
    print(f'  {ident:>6}: {i:.3e}')
print(f'   total: {infid.sum():.3e}')"""),
    md("""\
## Scaling up

This pulse is the benchmark configuration: on one NVIDIA H100 (700 W)
the batched pipeline (`functional` module) evaluates filter function +
infidelity for a *batch* of QFT-sized pulses at about 2 ms per pulse
with 1000 frequencies (see `bench.py`, `chip_smoke.py` and
`PERF.md`).  The same code path, `vmap`ped and `pjit`
sharded over a device mesh, scales across chips
(`parallel/sharding.py`)."""),
]

# ---------------------------------------------------------------------------
# qutip_integration
# ---------------------------------------------------------------------------
NOTEBOOKS['qutip_integration'] = [
    md("""\
# Calculating filter functions of optimized gates (QuTiP integration)

The package boundary is duck-typed: anything exposing `.full()`,
`.to_array()`, or `.todense()` is accepted wherever an operator is
expected -- QuTiP `Qobj`, scipy sparse matrices, and ndarrays can be
mixed freely.  The canonical use (the reference's
`qutip_integration.ipynb`) is feeding the output of a QuTiP GRAPE
optimization straight into `PulseSequence` to judge the optimized
gate against realistic noise.

QuTiP itself is optional; when it is missing this notebook falls back
to a minimal stub with the same `Qobj.full()` interface, so the code
below is identical either way."""),
    code(BOOTSTRAP + """

sys.path.insert(0, str(root / 'tests'))
try:
    import qutip as qt
    print('using real qutip', qt.__version__)
except ImportError:
    import _qutip_stub as qt
    print('qutip not installed; using the minimal test stub')"""),
    md("""\
## A two-qubit control system from Qobj operators

Local $X/Y$ drives on each qubit plus a $ZZ$ exchange coupling -- the
kind of Hamiltonian a GRAPE optimizer manipulates.  A smooth
50-segment amplitude profile stands in for the optimizer's
`final_amps` output (any piecewise-constant amplitude array works
identically)."""),
    code("""\
I2, X, Y, Z = [np.asarray(p) for p in util.paulis]

H_c_qobj = [qt.Qobj(np.kron(X, I2)), qt.Qobj(np.kron(Y, I2)),
            qt.Qobj(np.kron(I2, X)), qt.Qobj(np.kron(I2, Y)),
            qt.Qobj(np.kron(Z, Z))]
identifiers = ['XI', 'YI', 'IX', 'IY', 'ZZ']

n_ts, evo_time = 50, 1.0
t = np.linspace(0, evo_time, n_ts, endpoint=False)
rng = np.random.default_rng(42)
amps = np.stack([np.sin(2 * pi * (k + 1) * t / evo_time + phi)
                 for k, phi in enumerate(rng.uniform(0, 2 * pi, 5))])

pulse = ff.PulseSequence(
    list(zip(H_c_qobj, amps, identifiers)),
    list(zip(H_c_qobj, np.ones((5, n_ts)), identifiers)),
    [evo_time / n_ts] * n_ts)
print(f'PulseSequence from Qobj operators: d = {pulse.d}, '
      f'{len(pulse)} segments')"""),
    md("""\
No conversion step happened above -- the `Qobj`s went into the
constructor as-is.  From here everything is the standard workflow:"""),
    code("""\
omega = util.get_sample_frequencies(pulse, spacing='log',
                                    n_samples=200)
F = np.asarray(pulse.get_filter_function(omega).to_numpy()).real
for ident, f0 in zip(pulse.n_oper_identifiers,
                     F[np.arange(5), np.arange(5), 0]):
    print(f'  F_{ident}(omega_min) = {f0:.4g}')

infid = np.asarray(ff.infidelity(pulse, 1e-3 / omega, omega))
print('1/f infidelities per channel:', np.round(infid, 8))"""),
    code(PLOT_SETUP),
    code("""\
fig, ax, legend = plotting.plot_filter_function(pulse, omega)"""),
    md("""\
## States and Bloch-sphere plotting

Qobj kets pass through the same boundary: `get_states_from_prop`
accepts a `Qobj` initial state, and with real qutip installed
`plotting.plot_bloch_vector_evolution(pulse, psi0=...)` renders the
state trajectory on a `qutip.Bloch` sphere.  (With the stub the
geometry is still computed -- the tests assert it against closed-form
single-qubit trajectories -- only the 3D rendering needs the real
package.)"""),
    code("""\
single = ff.PulseSequence(
    [[np.asarray(X) / 2, [pi / 2], 'X']],
    [[np.asarray(Z) / 2, [1], 'Z']], [1])
states = plotting.get_states_from_prop(
    [single.total_propagator.to_numpy()],
    psi0=qt.Qobj(np.array([[1.0], [0.0]])))
vec = plotting.get_bloch_vector(states)
print('Bloch vector after a pi/2 x-rotation:',
      np.round(vec.ravel(), 6))"""),
]


# ---------------------------------------------------------------------------
# optimal_control (beyond the reference corpus)
# ---------------------------------------------------------------------------
NOTEBOOKS['optimal_control'] = [
    md("""\
# Optimal control: shaping pulses against noise

*(This notebook has no counterpart in the reference's doc corpus --
the reference exposes analytic infidelity derivatives for external
optimizers; here the whole optimization loop is differentiable and
runs on the accelerator.)*

The filter-function infidelity is a smooth function of the control
amplitudes, and the analytic derivative (Le et al., PRApplied 17,
024006 (2022); reference `gradient.py`) is implemented alongside a
fully `jax.grad`-differentiable functional pipeline.  That gives
three routes to the same gradient -- closed form, reverse-mode
autodiff, finite differences -- and makes GRAPE-style pulse shaping a
few lines of optax."""),
    code(BOOTSTRAP),
    md("""\
## A noisy starting pulse

A perturbed $\\pi_x$ rotation over 16 segments with $1/f$ dephasing
noise:"""),
    code("""\
from filter_functions_tpu import functional, gradient, parallel

I2, X, Y, Z = util.paulis
n_dt = 16
rng = np.random.default_rng(0)
dt = np.full(n_dt, 1.0 / n_dt)

c0 = np.pi + 0.3 * rng.standard_normal((2, n_dt))
pulse = ff.PulseSequence(
    [[X / 2, c0[0], 'X'], [Y / 2, c0[1], 'Y']],
    [[Z / 2, np.ones(n_dt), 'Z']], dt, basis=ff.Basis.pauli(1))
omega = util.get_sample_frequencies(pulse, n_samples=200)
S = 1e-3 / np.asarray(omega)"""),
    md("""\
## Analytic gradient equals autodiff

`gradient.infidelity_derivative` is the reference-parity analytic
derivative.  The same number falls out of `jax.grad` applied to the
functional pipeline (`functional.infidelity` over a `PulseArrays`
pytree) -- a strong mutual consistency check:"""),
    code("""\
import jax.numpy as jnp

dI = np.asarray(gradient.infidelity_derivative(pulse, S, omega))
p = functional.make_pulse_arrays(pulse)

def loss(c):
    return functional.infidelity(
        p._replace(c_coeffs=c), jnp.asarray(S),
        jnp.asarray(omega)).sum()

g = np.asarray(jax.grad(loss)(p.c_coeffs))
closed = dI.sum(axis=0).T        # sum noise axis -> (n_ctrl, n_dt)
print(f'analytic vs autodiff gradient, rel diff: '
      f'{np.abs(closed - g).max() / np.abs(g).max():.2e}')"""),
    md("""\
## Multi-start GRAPE on the device

`parallel.optimize_pulse` runs Adam on a *batch* of candidate pulses
inside one jitted loop -- multi-start optimization at the price of
one, and on a device mesh the batch shards across chips:"""),
    code("""\
batch, steps = 8, 200
cb = jnp.asarray(c0)[None] * (
    1 + 0.2 * rng.standard_normal((batch, 1, 1)))
res = parallel.optimize_pulse(
    p._replace(c_coeffs=cb), S, omega, n_steps=steps,
    learning_rate=2e-2)
best = int(np.argmin(np.asarray(res.infidelity)))
print(f'loss {float(res.history[0]):.3e} -> '
      f'{float(res.history[-1]):.3e} in {steps} steps; '
      f'best candidate #{best}')"""),
    code("""\
%matplotlib inline
import matplotlib.pyplot as plt

fig, ax = plt.subplots(figsize=(6, 3.5))
ax.semilogy(np.asarray(res.history))
ax.set_xlabel('Adam step')
ax.set_ylabel('batch mean infidelity')
ax.set_title('GRAPE convergence')"""),
    md("""\
## Back to the object API

The optimized coefficients drop straight back into a
`PulseSequence`:"""),
    code("""\
optimized = ff.PulseSequence(
    [[X / 2, np.asarray(res.c_coeffs[best, 0]), 'X'],
     [Y / 2, np.asarray(res.c_coeffs[best, 1]), 'Y']],
    [[Z / 2, np.ones(n_dt), 'Z']], dt, basis=ff.Basis.pauli(1))
infid0 = np.asarray(ff.infidelity(pulse, S, omega)).sum()
infid1 = np.asarray(ff.infidelity(optimized, S, omega)).sum()
print(f'infidelity {infid0:.3e} -> {infid1:.3e} '
      f'({infid0 / infid1:.1f}x lower)')"""),
]

# ---------------------------------------------------------------------------
# noise_spectroscopy (beyond the reference corpus)
# ---------------------------------------------------------------------------
NOTEBOOKS['noise_spectroscopy'] = [
    md("""\
# Noise spectroscopy: reconstructing $S(\\omega)$

*(No reference-package equivalent.)*  Filter functions run in both
directions: given $S(\\omega)$ they predict infidelities, and given
*measured* infidelities of a family of probe pulses they constrain
$S(\\omega)$.  The Alvarez-Suter protocol in filter-function
language: CPMG trains of varying period probe the spectrum at their
harmonics, and

$$\\mathcal{I}_p = \\frac{1}{2\\pi d}\\int d\\omega\\,
  F_p(\\omega)\\, S(\\omega)$$

becomes a linear inverse problem for $S$ on a node grid, solved by
jitted non-negative least squares (`spectroscopy` module)."""),
    code(BOOTSTRAP),
    md("""\
## The probe family

16 eight-pulse CPMG trains with total durations spanning two decades
-- each train's filter-function comb sits at a different harmonic
ladder:"""),
    code("""\
from filter_functions_tpu import spectroscopy

X, Z = util.paulis[1], util.paulis[3]

def cpmg_pulse(n, tau):
    delta = np.array([0] + [(g - 0.5) / n for g in range(1, n + 1)])
    tau_pi = 1e-4
    s, t = np.array([]), np.array([0.0])
    for i in range(len(delta) - 1):
        s = np.append(s, np.pi / tau_pi * np.array([0, 1]))
        t = np.append(t, tau_pi * np.array([0, 1])
                      + (delta * tau)[i + 1] - tau_pi / 2)
    t = np.append(t, tau)
    s = np.append(s, 0)
    return ff.PulseSequence([[X / 2, s]],
                            [[Z / 2, np.ones_like(np.diff(t))]],
                            np.diff(t))

taus = np.geomspace(0.3, 30, 16)
pulses = [cpmg_pulse(8, tau) for tau in taus]
omega = np.geomspace(2e-1, 2e2, 400)
ffs = np.stack([p.get_filter_function(omega).to_numpy()[0, 0].real
                for p in pulses])
print('probe filter functions:', ffs.shape)"""),
    md("""\
## Synthetic measurements

Ground truth: $1/f^{0.7}$ background plus a Lorentzian line at
$\\omega = 20$.  The 'measured' infidelities get 2% multiplicative
shot noise:"""),
    code("""\
rng = np.random.default_rng(0)
s_model = 1e-3 / omega**0.7 + 5e-6 / (1 + (omega - 20)**2)
measured = np.array([
    float(np.asarray(ff.infidelity(p, s_model, omega))[0])
    for p in pulses])
measured *= 1 + 0.02 * rng.standard_normal(len(measured))"""),
    md("""\
## Reconstruction

A log-log interpolation basis with 12 nodes turns the integral into a
design matrix; `reconstruct` solves the non-negative, curvature-
regularized least-squares problem with jitted FISTA:"""),
    code("""\
a, nodes = spectroscopy.design_matrix(ffs, omega, n_nodes=12)
s_nodes = spectroscopy.reconstruct(a, measured, ridge=1e-9,
                                   curvature=1e-8)
s_hat = np.asarray(spectroscopy.interpolate_spectrum(s_nodes, nodes,
                                                     omega))

resid = np.asarray(a) @ np.asarray(s_nodes) - measured
print(f'fit residual (rel): {np.abs(resid / measured).max():.2e}')
interior = (omega > nodes[1]) & (omega < nodes[-2])
rel = np.abs(s_hat[interior] / s_model[interior] - 1)
print(f'interior median rel error: {np.median(rel):.2%}')"""),
    code("""\
%matplotlib inline
import matplotlib.pyplot as plt

fig, ax = plt.subplots(figsize=(6.5, 4))
ax.loglog(omega, s_model, label=r'true $S(\\omega)$')
ax.loglog(omega, s_hat, '--', label='reconstructed')
ax.loglog(nodes, np.asarray(s_nodes), 'o', ms=4, label='nodes')
ax.set_xlabel(r'$\\omega$')
ax.set_ylabel(r'$S(\\omega)$')
ax.legend()"""),
    md("""\
The $1/f$ slope and the Lorentzian line are both recovered; the node
spacing sets the resolution.  In an experiment `measured` comes from
the lab instead of a forward model -- everything else is
unchanged."""),
]


def build(name, cells):
    nb = nbformat.v4.new_notebook()
    nb.metadata['kernelspec'] = {'name': 'python3',
                                 'display_name': 'Python 3',
                                 'language': 'python'}
    nb.metadata['language_info'] = {'name': 'python'}
    for kind, text in cells:
        if kind == 'markdown':
            nb.cells.append(nbformat.v4.new_markdown_cell(text))
        else:
            nb.cells.append(nbformat.v4.new_code_cell(text))
    return nb


def scrub(nb):
    """Drop machine-specific XLA loader spam from stderr streams.

    The build host's XLA CPU AOT cache logs a benign machine-feature
    mismatch on every first executable load; it is noise about the
    doc-build machine, not about the code, so it has no place in the
    shipped outputs."""
    for cell in nb.cells:
        if cell.cell_type != 'code':
            continue
        cell.outputs = [
            o for o in cell.get('outputs', [])
            if not (o.get('output_type') == 'stream'
                    and o.get('name') == 'stderr'
                    and 'cpu_aot_loader' in ''.join(o.get('text', '')))]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--only', help='build a single notebook')
    parser.add_argument('--no-exec', action='store_true',
                        help='author without executing')
    args = parser.parse_args()

    OUT.mkdir(parents=True, exist_ok=True)
    names = [args.only] if args.only else list(NOTEBOOKS)
    for name in names:
        nb = build(name, NOTEBOOKS[name])
        if not args.no_exec:
            print(f'executing {name} ...', flush=True)
            client = NotebookClient(
                nb, timeout=900, kernel_name='python3',
                resources={'metadata': {'path': str(REPO)}})
            client.execute()
            scrub(nb)
        path = OUT / f'{name}.ipynb'
        nbformat.write(nb, path)
        n_out = sum(len(c.get('outputs', [])) for c in nb.cells)
        print(f'wrote {path} ({len(nb.cells)} cells, '
              f'{n_out} outputs)')


if __name__ == '__main__':
    main()
