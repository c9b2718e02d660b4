"""chip_smoke.py on the CPU: its phases at a tiny size, and its refusal
to run anywhere but on a GPU."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke at a tiny size, with the device check and the card
    query stubbed so its phases run on the CPU."""
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in dict(N_QUBITS=2, N_OMEGA=30, BATCH=8, CHUNK=2,
                            REF_CHUNKS=1, ITERS=2, SO_N_OMEGA=20,
                            SO_BATCH=2).items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(mod, 'require_gpu', lambda: jax.devices()[0])
    monkeypatch.setattr(mod, 'card_line', lambda: 'CPU stand-in, 0 W')
    return mod


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_one_card_phases(smoke, capsys):
    assert smoke.main([]) == 0
    out = capsys.readouterr().out
    for phase in ('[a]', '[b]', '[c]', '[d]', '[e]', '[f]'):
        assert phase in out
    assert 'FAILED' not in out
    assert _last_json(out) == {'ok': True, 'device': {
        'platform': 'cpu', 'kind': 'cpu', 'count': len(jax.devices())}}


def test_four_device_phases(smoke, capsys):
    assert len(jax.devices()) >= 4
    assert smoke.main(['--devices', '4']) == 0
    out = capsys.readouterr().out
    assert '[m1]' in out and '[m2]' in out and 'FAILED' not in out
    assert _last_json(out)['device']['count'] == 4


def test_reference_rows_cover_both_ends(smoke, monkeypatch):
    assert smoke.reference_rows(8, 2) == [0, 1, 6, 7]
    assert smoke.reference_rows(4, 2) == [0, 1, 2, 3]
    monkeypatch.setattr(smoke, 'REF_CHUNKS', 2)
    assert smoke.reference_rows(32, 2) == [0, 1, 2, 3, 28, 29, 30, 31]


def test_reference_matches_phase_functions(smoke):
    """The reference child's results are the phase functions' own, and
    its sampled rows (first chunk in the scan body, last chunk in the
    epilogue) agree with the same rows of the full batch's program."""
    rows = smoke.reference_rows(8, 2)
    sizes = dict(n_qubits=2, n_omega=30, batch=8, chunk=2, rows=rows,
                 so_d=4, so_n_dt=8, so_n_omega=20, so_batch=2)
    ref = smoke.reference_results(sizes)
    assert ref['infid'].shape == (4, 7)
    assert ref['grad'].shape[0] == 4
    assert ref['etm'].shape == (2, 16, 16)
    _, batched, omega, spectrum = smoke.flagship_inputs(2, 30, 8)
    infid = np.asarray(smoke.flagship_fn(2)(batched, spectrum, omega))
    assert smoke.max_abs(infid[rows], ref['infid']) <= smoke.TOL_INFID
    grad = np.asarray(smoke.grad_fn(2)(batched.c_coeffs, batched,
                                       spectrum, omega))
    assert smoke.max_rel(grad[rows], ref['grad']) <= smoke.TOL_GRAD


def test_concatenation_phase_equals_scratch(smoke):
    pulse, _, omega, spectrum = smoke.flagship_inputs(2, 30, 2)
    F, infid, F_joined = smoke.object_api(pulse, np.asarray(omega),
                                          np.asarray(spectrum))
    assert smoke.max_rel(F_joined, F) <= smoke.TOL_FF
    cached, scratch = smoke.hadamard_concatenation(np.asarray(omega))
    assert smoke.max_rel(cached, scratch) <= smoke.TOL_FF


def test_check_fails_loudly(smoke):
    smoke.check('within', 1e-12, 1e-10)
    with pytest.raises(smoke.PhaseError):
        smoke.check('outside', 2e-10, 1e-10)
    with pytest.raises(smoke.PhaseError):
        smoke.check('not finite', float('nan'), 1e-10)
    with pytest.raises(smoke.PhaseError):
        smoke.max_abs(np.zeros(3), np.zeros(4))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_only_process():
    proc = _run([str(REPO / 'chip_smoke.py')], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert 'no GPU' in proc.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(REPO / 'chip_smoke.py', tmp_path)
    proc = _run(['chip_smoke.py'], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
