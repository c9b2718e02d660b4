"""scripts/trace_flagship.py on the CPU: its trace reduction, and its
refusal to run anywhere but on a GPU."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / 'scripts' / 'trace_flagship.py'


@pytest.fixture
def trace(monkeypatch):
    # the script switches XLA command buffers off in its environment at
    # import; keep that out of the rest of the test process
    if 'XLA_FLAGS' in os.environ:
        monkeypatch.setenv('XLA_FLAGS', os.environ['XLA_FLAGS'])
    else:
        monkeypatch.delenv('XLA_FLAGS', raising=False)
    spec = importlib.util.spec_from_file_location('trace_flagship', SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_busy_time_is_the_union_of_intervals(trace):
    assert trace.busy_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_ns([(0, 10), (2, 3), (10, 12)]) == 12
    assert trace.busy_ns([]) == 0


def test_compiled_instructions_map_to_ozaki_scopes(trace):
    """Every stage of an Ozaki complex matmul is found in the optimized
    HLO through the op_names of the instructions (and fusion bodies)
    the kernels run."""
    from filter_functions_tpu.ops.ozaki import ozaki_matmul_c
    rng = np.random.default_rng(0)
    a = [jnp.asarray(rng.standard_normal((8, 64))) for _ in range(2)]
    b = [jnp.asarray(rng.standard_normal((64, 8))) for _ in range(2)]
    text = jax.jit(ozaki_matmul_c).lower(*a, *b).compile().as_text()
    names = trace.op_names_by_instruction(text)
    scopes = {trace.scope_of(v) for v in names.values()}
    assert {'ozaki_a_digits', 'ozaki_b_digits',
            'ozaki_slice_matmuls'} <= scopes
    assert trace.scope_of({'x/ozaki_a_digits/y', 'x/ozaki_b_digits/y'}) \
        == 'mixed'
    assert trace.scope_of({'jit(f)/mul'}) == ''


def test_refuses_cpu_only_process():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, str(SCRIPT)], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert 'no GPU' in proc.stderr
