r"""Near-f64 matrix multiplication from low-precision products via
Ozaki splitting.

Integer and bf16 matrix units deliver far more throughput than float64
arithmetic on most accelerators.  The Ozaki scheme
(Ozaki et al., Numer. Algorithms 59, 2012; the basis of "DGEMM on
tensor cores" work on GPUs) recovers high precision from low-precision
matmuls using an error-free fixed-point decomposition:

1. scale each row of A (column of B) by a power of two so its largest
   element sits just below ``2**slice_bits``;
2. peel "digit" slices of ``slice_bits`` mantissa bits; every slice is
   an integer of at most ``slice_bits`` bits -- exactly representable
   in bfloat16 (for slice_bits <= 8);
3. a slice product carries ``2*slice_bits`` bits and a K-deep
   accumulation adds ``log2 K`` more; with
   ``2*slice_bits + ceil(log2 K) <= 24`` every pairwise slice matmul
   ``A_i @ B_j`` is **exact** in the f32 accumulator;
4. recombine ``sum_{i+j <= L} 2^{-slice_bits (i+j)} (A_i @ B_j)`` in
   f64 with the row/column scales.

The slice width therefore adapts to the reduction depth:
``slice_bits = (24 - ceil(log2 K)) // 2`` (8 bits up to K = 256, 6
bits up to K = 4096, ...).  ``precision_bits`` selects the truncation
level L: the neglected pairs contribute < 2^-precision_bits relative
to the row*column magnitude.  The default is depth-adaptive: 30 bits
in general, 24 bits for the deep-reduction control-matrix contraction
(K > 1024) where the many-sample frequency integral averages the
truncation noise (flagship infidelity parity ~5e-12; ~1e-10 with the
factored D of config.ozaki_factored);
FF_TPU_OZAKI_BITS / FF_TPU_OZAKI_BITS_DEEP override either level.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

import os

__all__ = ['ozaki_matmul', 'ozaki_matmul_c', 'DEFAULT_PRECISION_BITS']

#: Truncation level; override with FF_TPU_OZAKI_BITS.
DEFAULT_PRECISION_BITS = int(os.environ.get('FF_TPU_OZAKI_BITS', '30'))
#: Truncation level of the DEEP-reduction control-matrix contraction
#: (K > 1024: large-d pulses / long trains, whose results feed
#: many-sample frequency integrals that average the truncation noise;
#: flagship infidelity parity ~5e-12).  Shallow contractions
#: keep DEFAULT_PRECISION_BITS (raw small-d filter functions stay at
#: reference-level parity).  Override with FF_TPU_OZAKI_BITS_DEEP.
DEEP_PRECISION_BITS = int(os.environ.get('FF_TPU_OZAKI_BITS_DEEP',
                                         '24'))
#: f32 accumulator mantissa budget.
_ACC_BITS = 24
#: bf16 holds integers up to 2^8 exactly.
_MAX_SLICE_BITS = 8
#: int8 digit width: 7-bit digits keep every K <= 2^17 slice product
#: sum exactly inside the int32 accumulator.
_INT8_SLICE_BITS = 7


def _mxu_mode() -> str:
    """Element type of the slice products: 'int8' (7-bit digits,
    *exact* int32 accumulation, integer tensor-core GEMMs) or 'bf16'
    (6-8-bit digits, exact f32 accumulation).  Read eagerly per public
    call and passed down as a static argument (like FF_TPU_OZAKI_CMUL);
    inside a user jit the value is baked in at trace time.  Override
    with FF_TPU_OZAKI_MXU.
    """
    return os.environ.get('FF_TPU_OZAKI_MXU', 'int8')


def _slice_fixed_point(x: jnp.ndarray, axis: int, n_slices: int,
                       slice_bits: int, mxu: str = 'bf16'):
    """Split x into n_slices bf16 (or int8) integer 'digit' slices
    with a per-vector power-of-two scale (error-free).

    Digit extraction runs in native integer arithmetic when the total
    digit width fits an int32/int64: one exact f64 multiply+round to a
    fixed-point integer, then shift/mask per digit.  The float cascade
    (round, subtract, scale per digit) costs ~3 f64 passes per digit
    and is kept only as the wide fallback.

    int8 digits reserve ONE headroom bit (the scale is doubled): the
    round-half-up peel bounds every digit below the top one by
    2^(slice_bits - 1), and the headroom bit pulls the top digit under
    the same bound, so all digits fit int8 without saturation logic.
    The headroom costs one effective mantissa bit, accounted for in
    :func:`_slice_params`.
    """
    digit_dtype = jnp.int8 if mxu == 'int8' else jnp.bfloat16
    headroom = 1 if mxu == 'int8' else 0
    radix = float(2**slice_bits)
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    exp = jnp.ceil(jnp.log2(jnp.where(absmax > 0, absmax, 1.0))) \
        + headroom
    scale = jnp.exp2(exp - slice_bits)
    total_bits = n_slices * slice_bits
    if x.dtype == jnp.float32:
        # f32 inputs take the float cascade below: every step is
        # native f32 work AND exact (scaling by powers of two keeps
        # the mantissa; the subtraction y - round(y) retains only
        # low-order mantissa bits), so the digits reconstruct the f32
        # value exactly -- whereas the int path would route a >30-bit
        # window through int64 shifts.
        int_dtype = None
    elif total_bits <= 30:
        int_dtype = jnp.int32
    elif total_bits <= 52 and jnp.zeros((), jnp.float64).dtype == \
            jnp.float64:
        int_dtype = jnp.int64
    else:
        int_dtype = None
    if int_dtype is not None:
        # |x / 2^(exp - slice_bits)| <= 2^slice_bits, so
        # z = round(x * 2^(bits * n - exp)) fits total_bits + 1 bits
        # (exact in f64 for total_bits <= 52).  ONE fused
        # multiply-by-power-of-two per element (no divide).
        z = jnp.round(
            x * jnp.exp2(jnp.asarray(slice_bits * n_slices, x.dtype)
                         - exp)).astype(int_dtype)
        slices = []
        for k in range(n_slices - 1, 0, -1):
            shift = slice_bits * k
            half = jnp.asarray(1 << (shift - 1), int_dtype)
            d = (z + half) >> shift            # round-half-up digit
            slices.append(d.astype(digit_dtype))
            z = z - (d << shift)
        slices.append(z.astype(digit_dtype))
        return slices, scale
    y = x * jnp.exp2(jnp.asarray(slice_bits, x.dtype) - exp)
    slices = []
    for _ in range(n_slices):
        s = jnp.round(y)
        slices.append(s.astype(digit_dtype))
        y = (y - s) * radix
    return slices, scale


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def ozaki_matmul(a: jnp.ndarray, b: jnp.ndarray,
                 precision_bits: int = DEFAULT_PRECISION_BITS
                 ) -> jnp.ndarray:
    """High-precision ``a @ b`` via Ozaki splitting.

    a: (..., M, K) float64, b: (..., K, N) float64; leading batch axes
    must match.  Relative truncation ~2^-precision_bits of the
    row-times-column magnitude.

    Differentiable in reverse mode via a custom VJP (the digit slicing
    uses ``round``, whose literal gradient would be zero); cotangents
    propagate through Ozaki products as well, so optimal-control
    gradients keep high precision.
    """
    return _ozaki_matmul_impl(a, b, precision_bits, _mxu_mode(),
                              _recomb_mode())


#: Deepest reduction handled in one pass (slice_bits = 4); deeper
#: contractions are split into exact sub-reductions summed in f64.
_MAX_K = 2**(_ACC_BITS - 2 * 4)


@functools.partial(jax.jit,
                   static_argnames=('precision_bits', 'mxu', 'recomb'))
def _ozaki_matmul_impl(a: jnp.ndarray, b: jnp.ndarray,
                       precision_bits: int = DEFAULT_PRECISION_BITS,
                       mxu: str = 'bf16',
                       recomb: str = 'f64') -> jnp.ndarray:
    K = a.shape[-1]
    if K > _MAX_K:
        # Chunk the reduction axis: each chunk's slice products stay
        # exact in the accumulator; the cross-chunk sum runs in
        # f64, so accuracy is unchanged.
        n_chunks = -(-K // _MAX_K)
        pad = n_chunks * _MAX_K - K
        a_c = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        b_c = jnp.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
        a_c = jnp.moveaxis(
            a_c.reshape(a.shape[:-1] + (n_chunks, _MAX_K)), -2, 0)
        b_c = jnp.moveaxis(
            b_c.reshape(b.shape[:-2] + (n_chunks, _MAX_K, b.shape[-1])),
            -3, 0)
        out = None
        for c in range(n_chunks):
            term = _ozaki_matmul_impl(a_c[c], b_c[c], precision_bits,
                                      mxu, recomb)
            out = term if out is None else out + term
        return out

    slice_bits, n_slices = _slice_params(K, precision_bits, mxu)
    a_sl, a_scale = _slice_fixed_point(a, -1, n_slices, slice_bits, mxu)
    b_sl, b_scale = _slice_fixed_point(b, -2, n_slices, slice_bits, mxu)
    out = _matmul_from_slices(a_sl, b_sl, slice_bits, a.ndim, recomb)
    return out * a_scale * b_scale


def _slice_params(K: int, precision_bits: int,
                  mxu: str = 'bf16') -> Tuple[int, int]:
    if mxu == 'int8':
        # Exactness: a 2*slice_bits-bit product summed K deep must fit
        # the 31-bit int32 accumulator; the extra level-sum factor
        # (n_slices products per level) stays within the remaining
        # headroom for every K <= _MAX_K.  The one headroom bit spent
        # on digit range costs one effective mantissa bit, so size the
        # slice count against precision_bits + 1.
        slice_bits = min(_INT8_SLICE_BITS,
                         (31 - math.ceil(math.log2(max(K, 2)))) // 2)
        max_level = max(1, -(-(precision_bits + 1) // slice_bits) - 1)
    else:
        slice_bits = min(
            _MAX_SLICE_BITS,
            (_ACC_BITS - math.ceil(math.log2(max(K, 2)))) // 2)
        max_level = max(1, -(-precision_bits // slice_bits) - 1)
    return slice_bits, max_level + 1


def _recomb_mode() -> str:
    """How the int8 path widens and sums its per-level int32 outputs:
    'ds' (default) double-single two-float32 arithmetic,
    'f64' emulated-f64 widening per level.  Override with
    FF_TPU_OZAKI_RECOMB.  Read eagerly per public call and passed down
    as a static argument (like FF_TPU_OZAKI_MXU), so toggling the env
    var between calls switches executables; inside a user jit it is
    (necessarily) baked in at trace time."""
    return os.environ.get('FF_TPU_OZAKI_RECOMB', 'ds')


def _ds_from_int32(v: jnp.ndarray):
    """Exact double-single (hi, lo) f32 representation of an int32
    level sum: hi is a multiple of 2^16 with <= 15 significant bits,
    lo sits in [0, 2^16) -- both convert to f32 without rounding."""
    hi_i = jnp.right_shift(v, 16) << 16
    return (hi_i.astype(jnp.float32), (v - hi_i).astype(jnp.float32))


def _ds_add(a, b):
    """Two-float Knuth/Dekker addition: (ah, al) + (bh, bl) with
    ~2^-48 relative error, all in native f32 ops."""
    ah, al = a
    bh, bl = b
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    e = e + (al + bl)
    hi = s + e
    return hi, e - (hi - s)


def _matmul_from_slices(a_sl, b_sl, slice_bits: int, ndim: int,
                        recomb: str = 'f64'):
    """sum_{i+j <= L} 2^{-slice_bits (i+j)} A_i @ B_j.

    bf16 digits accumulate exactly in f32 and widen to f64 per product;
    int8 digits accumulate exactly in *int32* and whole levels sum in
    native int32.

    The cross-level recombination sum_s 2^{-slice_bits s} L_s is the
    dominant non-matmul cost of the int8 path when done in f64
    (n_slices full-size widen+scale+add sweeps per Gauss component).
    Mode 'ds' (default, :func:`_recomb_mode`) runs it in double-single
    two-float32 arithmetic instead: the int32 -> (hi, lo) f32 split is
    exact, the 2^{-slice_bits s} scales are powers of two (exact f32
    exponent shifts), and the two-float adds keep ~48 result bits --
    well beyond the <= 31 bits a level sum carries -- so the single
    final f64 widening reproduces the f64-path result to ~2^-48
    relative, at native f32 speed."""
    n_slices = len(a_sl)
    int8 = a_sl[0].dtype == jnp.int8
    acc_t = jnp.int32 if int8 else jnp.float32
    ds = int8 and recomb == 'ds'
    batch = tuple(range(ndim - 2))
    dims = (((ndim - 1,), (ndim - 2,)), (batch, batch))
    out = None
    for s in range(n_slices):
        # sum_{i+j=s} A_i @ B_j: each product is exact in the
        # accumulator; the cross-pair f32 sum may overflow the 24-bit
        # budget, so widen first (int32 levels cannot overflow: see
        # _slice_params).
        level = None
        for i in range(s + 1):
            prod = jax.lax.dot_general(
                a_sl[i], b_sl[s - i], dimension_numbers=dims,
                preferred_element_type=acc_t)
            if not int8:
                prod = prod.astype(jnp.float64)
            level = prod if level is None else level + prod
        if ds:
            scale = jnp.float32(2.0**(-slice_bits * s))
            hi, lo = _ds_from_int32(level)
            term = (hi * scale, lo * scale)
            out = term if out is None else _ds_add(out, term)
        else:
            term = level.astype(jnp.float64) * (2.0**(-slice_bits * s))
            out = term if out is None else out + term
    if ds:
        return out[0].astype(jnp.float64) + out[1].astype(jnp.float64)
    return out


def _ozaki_fwd(a, b, precision_bits):
    return _ozaki_matmul_impl(a, b, precision_bits, _mxu_mode(),
                              _recomb_mode()), (a, b)


def _ozaki_bwd(precision_bits, res, g):
    a, b = res
    # d/da (a @ b) . g = g @ b^T ;  d/db (a @ b) . g = a^T @ g
    mxu, recomb = _mxu_mode(), _recomb_mode()
    da = _ozaki_matmul_impl(g, b.swapaxes(-1, -2), precision_bits, mxu,
                            recomb)
    db = _ozaki_matmul_impl(a.swapaxes(-1, -2), g, precision_bits, mxu,
                            recomb)
    return da, db


ozaki_matmul.defvjp(_ozaki_fwd, _ozaki_bwd)


# -----------------------------------------------------------------------------
# Complex (split re/im) Ozaki matmul with shared slice decompositions
# -----------------------------------------------------------------------------
def _cmul_mode() -> str:
    """Resolve the complex-multiply algorithm ('3' Gauss / '4' naive)
    from FF_TPU_OZAKI_CMUL.  Read eagerly per call and passed down as a
    static argument so toggling the env var between calls actually
    switches executables; inside a user jit it is (necessarily) baked
    in at trace time.
    """
    return os.environ.get('FF_TPU_OZAKI_CMUL', '3')


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def ozaki_matmul_c(a_re, a_im, b_re, b_im,
                   precision_bits: int = DEFAULT_PRECISION_BITS):
    """Complex ``a @ b`` on split operands via Gauss 3-multiplication,
    slicing each real component ONCE and reusing the decompositions
    across the three products.  Calling :func:`ozaki_matmul` three times
    (as a naive Gauss would) re-slices every operand per product; the
    slicing is f64-elementwise-bound and dominates for large N.

    Returns (re, im) of shape (..., M, N).
    """
    return _ozaki_matmul_c_impl(a_re, a_im, b_re, b_im, precision_bits,
                                _cmul_mode(), _mxu_mode(),
                                _recomb_mode())


@functools.partial(jax.jit,
                   static_argnames=('precision_bits', 'cmul', 'mxu',
                                    'recomb'))
def _ozaki_matmul_c_impl(a_re, a_im, b_re, b_im,
                         precision_bits: int = DEFAULT_PRECISION_BITS,
                         cmul: str = '3', mxu: str = 'bf16',
                         recomb: str = 'f64'):
    K = a_re.shape[-1]
    if K > _MAX_K:
        # chunk the reduction exactly as the real path does
        n_chunks = -(-K // _MAX_K)
        pad = n_chunks * _MAX_K - K

        def chunk_a(a):
            a_c = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
            return jnp.moveaxis(
                a_c.reshape(a.shape[:-1] + (n_chunks, _MAX_K)), -2, 0)

        def chunk_b(b):
            b_c = jnp.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
            return jnp.moveaxis(
                b_c.reshape(b.shape[:-2] + (n_chunks, _MAX_K,
                                            b.shape[-1])), -3, 0)

        ar, ai, br, bi = (chunk_a(a_re), chunk_a(a_im),
                          chunk_b(b_re), chunk_b(b_im))
        out_re = out_im = None
        for c in range(n_chunks):
            t_re, t_im = _ozaki_matmul_c_impl(ar[c], ai[c], br[c], bi[c],
                                              precision_bits, cmul, mxu,
                                              recomb)
            out_re = t_re if out_re is None else out_re + t_re
            out_im = t_im if out_im is None else out_im + t_im
        return out_re, out_im

    slice_bits, n_slices = _slice_params(K, precision_bits, mxu)
    ndim = a_re.ndim

    def sl_a(x):
        return _slice_fixed_point(x, -1, n_slices, slice_bits, mxu)

    def sl_b(x):
        return _slice_fixed_point(x, -2, n_slices, slice_bits, mxu)

    with jax.named_scope('ozaki_a_digits'):
        ar_sl, ar_sc = sl_a(a_re)
        ai_sl, ai_sc = sl_a(a_im)
    with jax.named_scope('ozaki_b_digits'):
        br_sl, br_sc = sl_b(b_re)
        bi_sl, bi_sc = sl_b(b_im)

    def mm(a_sl, a_sc, b_sl, b_sc):
        with jax.named_scope('ozaki_slice_matmuls'):
            return _matmul_from_slices(a_sl, b_sl, slice_bits, ndim,
                                       recomb) * (a_sc * b_sc)

    if cmul == '4':
        # 4-multiplication form: one fewer slicing of each operand
        # (the f64-elementwise-bound step) at the cost of one more
        # matmul set (the cheap step).
        p_rr = mm(ar_sl, ar_sc, br_sl, br_sc)
        p_ii = mm(ai_sl, ai_sc, bi_sl, bi_sc)
        p_ri = mm(ar_sl, ar_sc, bi_sl, bi_sc)
        p_ir = mm(ai_sl, ai_sc, br_sl, br_sc)
        return p_rr - p_ii, p_ri + p_ir

    with jax.named_scope('ozaki_a_digits'):
        as_sl, as_sc = sl_a(a_re + a_im)
    with jax.named_scope('ozaki_b_digits'):
        bs_sl, bs_sc = sl_b(b_re + b_im)
    p1 = mm(ar_sl, ar_sc, br_sl, br_sc)
    p2 = mm(ai_sl, ai_sc, bi_sl, bi_sc)
    p3 = mm(as_sl, as_sc, bs_sl, bs_sc)
    return p1 - p2, p3 - p1 - p2


# -----------------------------------------------------------------------------
# Factored-operand complex matmul: P @ (B (*) C) with the product
# operand's digit slices formed in native int32 arithmetic
# -----------------------------------------------------------------------------
def _int_fixed_point(x, axis, bits: int):
    """Signed int32 fixed point per slice of *axis* with a
    power-of-two scale: x ~= z * 2^(e - bits), |z| <= 2^bits."""
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    e = jnp.ceil(jnp.log2(jnp.where(absmax > 0, absmax, 1.0)))
    z = jnp.round(x * jnp.exp2(bits - e)).astype(jnp.int32)
    return z, e


def _split12(z):
    """z = hi * 2^12 + lo with |hi| <= 2^11 + 1, |lo| <= 2^11
    (round-to-nearest split of a <= 23-bit signed int)."""
    hi = (z + (1 << 11)) >> 12
    return hi, z - (hi << 12)


def _outer_word(b1, b0, c1, c0):
    """Top-30-bit word W ~= (zB * zC) / 2^18 of the outer product of
    22-bit fixed-point columns, entirely in native int32: the 48-bit
    product zB*zC = p2*2^24 + p1*2^12 + p0 never materializes; the
    dropped tail is < 2^-25 of the product scale."""
    p2 = b1[..., :, None] * c1[..., None, :]
    p1 = b1[..., :, None] * c0[..., None, :] \
        + b0[..., :, None] * c1[..., None, :]
    p0 = b0[..., :, None] * c0[..., None, :]
    return (p2 << 6) + ((p1 + ((p0 + (1 << 11)) >> 12) + (1 << 5)) >> 6)


def _peel_int(v, n_slices: int, slice_bits: int,
              digit_dtype=jnp.bfloat16):
    """Digit slices (high first) of an int32 v with
    |v| < 2^(min(n_slices * slice_bits, 31)), round-half-up cascade."""
    slices = []
    z = v
    for k in range(n_slices - 1, 0, -1):
        shift = slice_bits * k
        half = jnp.asarray(1 << (shift - 1), jnp.int32)
        d = (z + half) >> shift
        slices.append(d.astype(digit_dtype))
        z = z - (d << shift)
    slices.append(z.astype(digit_dtype))
    return slices


@functools.partial(jax.custom_vjp, nondiff_argnums=(6,))
def ozaki_matmul_c_outer(p_re, p_im, b_re, b_im, c_re, c_im,
                         precision_bits: int = DEFAULT_PRECISION_BITS):
    r"""Complex ``P @ D`` where ``D[k, (j c)] = B[k, j] * C[k, c]`` is
    a row-wise outer product (the control-matrix D lattice,
    numeric._ctrlmat_contract), WITHOUT ever assembling D in float.

    B and C are converted to 22-bit int32 fixed point per column
    (tiny tensors), and D's bf16 digit slices are produced by native
    int32 outer-product arithmetic (12-bit factor splits, 30-bit top
    words, round-half-up digit peel) -- the f64 elementwise build and
    slicing of the (K x J*C) product tensor disappears.
    Effective D precision is ~23 bits per factor (~25 of the product)
    below the column scales, matching the standard 24-bit path.

    P: (M, K) split re/im (any float dtype); B: (K, J); C: (K, Cc).
    Returns (re, im) of shape (M, J * Cc) in f64.  Requires the
    K-adapted slice width to be 5-7 bits (256 < K <= 16384); the
    caller falls back to :func:`ozaki_matmul_c` otherwise.

    Differentiable in reverse mode via a custom VJP: the digit
    pipeline is round/int arithmetic (zero literal gradients), so the
    backward pass applies
    the product rule on the MATHEMATICAL map (P, B, C) -> P @ D --
    dP = g D^H (an ozaki_matmul_c), dD = P^H g, then the row-wise
    outer-product chain dB[k,j] = sum_c dD[k,(jc)] conj(C[k,c]) and
    dC[k,c] = sum_j dD[k,(jc)] conj(B[k,j]).
    """
    return _ozaki_matmul_c_outer_impl(p_re, p_im, b_re, b_im, c_re,
                                      c_im, precision_bits, _mxu_mode(),
                                      _recomb_mode())


def _ozaki_c_outer_fwd(p_re, p_im, b_re, b_im, c_re, c_im,
                       precision_bits):
    out = _ozaki_matmul_c_outer_impl(p_re, p_im, b_re, b_im, c_re,
                                     c_im, precision_bits, _mxu_mode(),
                                     _recomb_mode())
    return out, (p_re, p_im, b_re, b_im, c_re, c_im)


def _ozaki_c_outer_bwd(precision_bits, res, g):
    p_re, p_im, b_re, b_im, c_re, c_im = res
    g_re, g_im = g
    K = p_re.shape[-1]
    J, Cc = b_re.shape[-1], c_re.shape[-1]
    # D (K, J*Cc) materialized once, for the backward pass only
    d_re = (b_re[..., :, None] * c_re[..., None, :]
            - b_im[..., :, None] * c_im[..., None, :]).reshape(
        *b_re.shape[:-1], J * Cc)
    d_im = (b_re[..., :, None] * c_im[..., None, :]
            + b_im[..., :, None] * c_re[..., None, :]).reshape(
        *b_re.shape[:-1], J * Cc)
    cmul, mxu, recomb = _cmul_mode(), _mxu_mode(), _recomb_mode()
    # dP = g @ conj(D)^T  (M, K)
    dp_re, dp_im = _ozaki_matmul_c_impl(
        g_re, g_im, d_re.swapaxes(-1, -2), -d_im.swapaxes(-1, -2),
        precision_bits, cmul, mxu, recomb)
    # dD = conj(P)^T @ g  (K, J*Cc)
    dd_re, dd_im = _ozaki_matmul_c_impl(
        p_re.swapaxes(-1, -2), -p_im.swapaxes(-1, -2), g_re, g_im,
        precision_bits, cmul, mxu, recomb)
    dd_re = dd_re.reshape(*dd_re.shape[:-1], J, Cc)
    dd_im = dd_im.reshape(*dd_im.shape[:-1], J, Cc)
    # dB = sum_c dD * conj(C); dC = sum_j dD * conj(B) -- tiny tensors
    db_re = jnp.einsum('...kjc,...kc->...kj', dd_re, c_re) \
        + jnp.einsum('...kjc,...kc->...kj', dd_im, c_im)
    db_im = jnp.einsum('...kjc,...kc->...kj', dd_im, c_re) \
        - jnp.einsum('...kjc,...kc->...kj', dd_re, c_im)
    dc_re = jnp.einsum('...kjc,...kj->...kc', dd_re, b_re) \
        + jnp.einsum('...kjc,...kj->...kc', dd_im, b_im)
    dc_im = jnp.einsum('...kjc,...kj->...kc', dd_im, b_re) \
        - jnp.einsum('...kjc,...kj->...kc', dd_re, b_im)
    return (dp_re.astype(p_re.dtype), dp_im.astype(p_im.dtype),
            db_re.astype(b_re.dtype), db_im.astype(b_im.dtype),
            dc_re.astype(c_re.dtype), dc_im.astype(c_im.dtype))


ozaki_matmul_c_outer.defvjp(_ozaki_c_outer_fwd, _ozaki_c_outer_bwd)


@functools.partial(jax.jit,
                   static_argnames=('precision_bits', 'mxu', 'recomb'))
def _ozaki_matmul_c_outer_impl(p_re, p_im, b_re, b_im, c_re, c_im,
                               precision_bits: int
                               = DEFAULT_PRECISION_BITS,
                               mxu: str = 'bf16',
                               recomb: str = 'f64'):
    K = p_re.shape[-1]
    slice_bits, n_p = _slice_params(K, precision_bits, mxu)
    if slice_bits not in (5, 6, 7) or K <= 256:
        # int8 digits cap at 7 bits for every K, so the slice width no
        # longer distinguishes shallow reductions -- gate on K as well.
        raise ValueError('factored path requires slice_bits in (5..7) '
                         f'and deep K > 256, got slice_bits={slice_bits} '
                         f'for K={K}')
    # D-side digit count: cover the 30-bit product word.  The int8
    # peel still operates on the int32 word, so its left-normalization
    # targets bit 29 (not n_d * slice_bits - 1, which would overflow)
    # -- which leaves D's TOP digit underfilled (~2 of 7 bits).  The
    # level-truncation cutoff is set by the A_top x D_bottom pairs, so
    # the P side must slice as deep as D (n_p = n_d = 5) or the
    # skewed D digits cost ~4 bits of the pair budget (1.25e-9
    # flagship parity at n_p = 4 vs ~1e-10 at 5).  A FULL-WIDTH 4-digit
    # layout (28-bit window, 10 pairs instead of 15) gives 1.41e-9
    # parity -- 28-bit operand quantization alone busts the 1e-10
    # budget, so both sides stay at 5 digits.
    n_d = -(-30 // slice_bits) if mxu == 'int8' else 30 // slice_bits
    if mxu == 'int8':
        n_p = max(n_p, n_d)
    digit_dtype = jnp.int8 if mxu == 'int8' else jnp.bfloat16

    with jax.named_scope('ozaki_p_digits'):
        # P side: standard slicing (f32 assembly upstream)
        pr_sl, pr_sc = _slice_fixed_point(p_re, -1, n_p, slice_bits, mxu)
        pi_sl, pi_sc = _slice_fixed_point(p_im, -1, n_p, slice_bits, mxu)
        ps_sl, ps_sc = _slice_fixed_point(p_re + p_im, -1, n_p, slice_bits,
                                          mxu)

    # factor side: shared 23-bit fixed point per column (one scale per
    # column covering both re and im so sums stay consistent; 23 bits
    # is the int32 headroom limit: the 12-bit-split products reach
    # 2^28 after the word shift, their differences 2^29, and the Gauss
    # sum component 2^30 < 2^31)
    def fix(re, im):
        absmax = jnp.maximum(jnp.max(jnp.abs(re), axis=0),
                             jnp.max(jnp.abs(im), axis=0))
        e = jnp.ceil(jnp.log2(jnp.where(absmax > 0, absmax, 1.0)))
        zr = jnp.round(re * jnp.exp2(23 - e)[None]).astype(jnp.int32)
        zi = jnp.round(im * jnp.exp2(23 - e)[None]).astype(jnp.int32)
        return zr, zi, e

    zbr, zbi, eb = fix(b_re, b_im)
    zcr, zci, ec = fix(c_re, c_im)
    J, Cc = b_re.shape[-1], c_re.shape[-1]
    ndim = p_re.ndim
    nbits = n_d * slice_bits
    e_bc = (eb[..., :, None] + ec[..., None, :]).reshape(
        *eb.shape[:-1], J * Cc)
    outs = []
    for d_sl, shift in _d_word_digits(zbr, zbi, zcr, zci, n_d, slice_bits,
                                      digit_dtype):
        # scale: D = v * 2^(eB + eC - 28 - shift); digit expansion
        # v = 2^(nbits - slice_bits) * sum_s d_s 2^(-slice_bits s)
        d_sc = jnp.exp2((e_bc - 28 - shift
                         + (nbits - slice_bits)).astype(jnp.float64)
                        )[..., None, :]
        outs.append((d_sl, d_sc))

    # slice matmuls + Gauss recombination
    def mm(a_sl, a_sc, d):
        d_sl, d_sc = d
        n = min(len(a_sl), len(d_sl))
        out = _matmul_from_slices(a_sl[:n], d_sl[:n], slice_bits, ndim,
                                  recomb)
        return out * a_sc * d_sc

    with jax.named_scope('ozaki_slice_matmuls'):
        p1 = mm(pr_sl, pr_sc, outs[0])
        p2 = mm(pi_sl, pi_sc, outs[1])
        p3 = mm(ps_sl, ps_sc, outs[2])
    # Gauss: re = Pr Dr - Pi Di; im = (Pr+Pi)(Dr+Di) - p1 - p2
    return p1 - p2, p3 - p1 - p2


def _d_word_digits(zbr, zbi, zcr, zci, n_d: int, slice_bits: int,
                   digit_dtype=jnp.int8):
    """Digit slices of the three Gauss components (Dr, Di, Dr + Di) of
    the row-wise outer product D[k, (j c)] = B[k, j] * C[k, c], from the
    23-bit int32 fixed-point factors, in native int32 arithmetic.

    Returns ``[(digits, shift)] * 3``: *digits* the n_d slices (high
    first) of each component's per-column normalized top-30-bit word,
    *shift* the per-column left shift applied to it (signed)."""
    with jax.named_scope('ozaki_d_digits'):
        J, Cc = zbr.shape[-1], zcr.shape[-1]
        nbits = n_d * slice_bits
        sb1, sb0 = _split12(zbr)
        si1, si0 = _split12(zbi)
        sc1, sc0 = _split12(zcr)
        sd1, sd0 = _split12(zci)

        # W ~= (zB zC)/2^18; complex components via 4 outer words
        w_rr = _outer_word(sb1, sb0, sc1, sc0)
        w_ii = _outer_word(si1, si0, sd1, sd0)
        w_ri = _outer_word(sb1, sb0, sd1, sd0)
        w_ir = _outer_word(si1, si0, sc1, sc0)
        d_comps = (w_rr - w_ii,                 # Dr * 2^(28 - eB - eC)
                   w_ri + w_ir,                 # Di
                   (w_rr - w_ii) + (w_ri + w_ir))   # Dr + Di (Gauss)

        outs = []
        for w in d_comps:
            w = w.reshape(*w.shape[:-2], J * Cc)
            # per-column normalization to EXACTLY the digit budget:
            # columns below it shift left; columns ABOVE it (the word
            # carries up to ~30 bits, the 4x7-bit budget only 28) must
            # shift RIGHT with rounding, or the top digit of the peel
            # overflows int8 and silently wraps.  The rounded right
            # shift costs <= 0.5 ulp of the 28-bit window -- relative
            # column precision is uniform.
            colmax = jnp.max(jnp.abs(w), axis=-2, keepdims=False)
            # bit length via float log2 (exact for int32 magnitudes)
            e_w = jnp.ceil(jnp.log2(jnp.maximum(colmax, 1).astype(
                jnp.float64))).astype(jnp.int32)
            shift = min(nbits, 30) - 1 - e_w       # signed
            lshift = jnp.maximum(shift, 0)[..., None, :]
            rshift = jnp.maximum(-shift, 0)[..., None, :]
            half = (jnp.int32(1) << rshift) >> 1   # 0 when rshift == 0
            v = ((w << lshift) + half) >> rshift
            outs.append((_peel_int(v, n_d, slice_bits, digit_dtype),
                         shift))
        return outs


def _ozaki_c_fwd(a_re, a_im, b_re, b_im, precision_bits):
    return (_ozaki_matmul_c_impl(a_re, a_im, b_re, b_im, precision_bits,
                                 _cmul_mode(), _mxu_mode(),
                                 _recomb_mode()),
            (a_re, a_im, b_re, b_im))


def _ozaki_c_bwd(precision_bits, res, g):
    a_re, a_im, b_re, b_im = res
    g_re, g_im = g
    # da = g @ conj(b)^T, db = conj(a)^T @ g (complex product rules on
    # split components)
    cmul, mxu, recomb = _cmul_mode(), _mxu_mode(), _recomb_mode()
    bt_re, bt_im = b_re.swapaxes(-1, -2), b_im.swapaxes(-1, -2)
    at_re, at_im = a_re.swapaxes(-1, -2), a_im.swapaxes(-1, -2)
    da_re, da_im = _ozaki_matmul_c_impl(g_re, g_im, bt_re, -bt_im,
                                        precision_bits, cmul, mxu,
                                        recomb)
    db_re, db_im = _ozaki_matmul_c_impl(at_re, -at_im, g_re, g_im,
                                        precision_bits, cmul, mxu,
                                        recomb)
    # the products come back in f64; cotangents take their primal's
    # dtype (f32 P operands on the deep path)
    return (da_re.astype(a_re.dtype), da_im.astype(a_im.dtype),
            db_re.astype(b_re.dtype), db_im.astype(b_im.dtype))


ozaki_matmul_c.defvjp(_ozaki_c_fwd, _ozaki_c_bwd)
