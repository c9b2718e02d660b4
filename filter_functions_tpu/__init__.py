"""filter_functions_tpu -- a JAX framework for computing generalized
filter functions of quantum control pulses on accelerators.

A from-scratch rebuild of the capabilities of qutech/filter_functions
(the NumPy reference package) for jit-compiled, batched evaluation:

* complex linear algebra runs on a split (re, im) float64
  representation (:mod:`.cplx`);
* propagator accumulation uses log-depth associative scans;
* the control-matrix segment loop is a batched XLA contraction;
* the trace-tensor contractions for the cumulant function use Pauli
  structure constants (segment-sum + gather) instead of sparse COO;
* frequency-axis/batch sharding over device meshes lives in
  :mod:`.parallel`.
"""
from . import (analytic, basis, config, cplx, functional, gradient, models,
               numeric, parallel, pulse_sequence, spectroscopy,
               superoperator, types, util)
from .basis import Basis
from .gradient import infidelity_derivative
from .numeric import error_transfer_matrix, infidelity
from .pulse_sequence import (PulseSequence, concatenate,
                             concatenate_periodic,
                             concatenate_without_filter_function, extend,
                             remap)
from .superoperator import liouville_representation

__all__ = ['Basis', 'PulseSequence', 'concatenate', 'concatenate_periodic',
           'error_transfer_matrix', 'extend', 'infidelity',
           'liouville_representation', 'remap', 'infidelity_derivative',
           'analytic', 'basis', 'config', 'cplx', 'functional', 'gradient',
           'models', 'numeric', 'parallel', 'pulse_sequence',
           'spectroscopy', 'superoperator', 'types', 'util']

__version__ = '0.1.0'
