"""Test configuration.

* Runs on the CPU backend with 8 virtual devices (set through
  jax.config before first backend use) -- sharding tests run on the
  virtual mesh.  Only when JAX_PLATFORMS names another platform (on a
  GPU machine: ``JAX_PLATFORMS=cuda python -m pytest -o addopts=''
  -m gpu tests/``) is the backend left alone, for the ``gpu`` tests.
* Enables x64.
* Installs a dense-backed `sparse` stub and puts /root/reference on
  sys.path so the reference package can be imported as the numerical
  oracle (read-only; we never copy its code).
"""
import os
import sys
from pathlib import Path

# No persistent compile cache under pytest: the cache WRITE path
# (jax compilation_cache.put_executable_and_time) segfaults
# intermittently in this jaxlib build -- observed with a fresh cache
# dir and no concurrent writers, always inside the executable
# serialization.  The suite compiles small CPU graphs, so the cache
# buys little here; correctness of the cache setup itself is covered
# by tests/test_extras.py without writes.  Must be set before
# filter_functions_tpu (whose config module applies the cache dir) is
# first imported.
os.environ.setdefault('FF_TPU_NO_COMPILE_CACHE', '1')

import jax

if os.environ.get('JAX_PLATFORMS', 'cpu') == 'cpu':
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 8)
jax.config.update('jax_enable_x64', True)

sys.path.insert(0, str(Path(__file__).parent))

REFERENCE_PATH = Path('/root/reference')


def _install_reference():
    if not REFERENCE_PATH.exists():
        return False
    try:
        import sparse  # noqa: F401
    except ImportError:
        import _sparse_stub
        sys.modules['sparse'] = _sparse_stub
    if str(REFERENCE_PATH) not in sys.path:
        sys.path.insert(0, str(REFERENCE_PATH))
    try:
        import filter_functions  # noqa: F401
        return True
    except Exception:
        return False


HAVE_REFERENCE = _install_reference()
