"""Counter-based random numbers, bit for bit ``jax.random`` (what the JAX
package reaches through ``jax.random`` on jax 0.9.0, with
``jax_threefry_partitionable`` on and 64-bit types enabled).

A key is two 32-bit words.  PyTorch has no unsigned 32-bit arithmetic on
every device, so a word is carried in an ``int64`` tensor and masked to
``[0, 2**32)`` after each add: a key is an ``int64`` tensor ``[..., 2]``
and every function here takes a batch of keys (leading axes), as
``jax.vmap`` of the JAX function would.

The hash is Threefry-2x32 with 20 rounds (rotations 13, 15, 26, 6 and 17,
29, 16, 24, the key injected every 4 rounds), :func:`threefry2x32`; it
takes tensors or Python ints alike.  Everything JAX derives from it
follows its ``_src/prng.py`` and ``_src/random.py``:

  * an element with flat index ``i`` of a draw of any shape hashes the
    counter ``(i >> 32, i & 0xffffffff)``; ``split(key, num)`` is those
    hashes as keys, so ``split(k, 6)[j] == split(k, 2)[j]``, and
    ``fold_in(key, d)`` hashes the counter ``(0, d)``;
  * 32 random bits are ``b1 ^ b2`` of the hash, 64 bits ``b1 << 32 | b2``
    (:func:`random_bits` returns the latter as its signed ``int64``
    pattern);
  * :func:`uniform` sets the mantissa of a float in ``[1, 2)`` from the
    top bits and subtracts 1; ``minval``/``maxval`` as ``u * (max - min) +
    min`` rounded once (XLA's CPU program contracts it into a fused
    multiply-add), floored at ``min``;
  * :func:`randint` draws two words an element from a 2-way split and
    combines them modulo the span, JAX's two-word modulo scheme, with the
    unsigned arithmetic of the sampled width written out in ``int64``;
  * :func:`exponential` is ``-log1p(-u)`` and :func:`normal` ``sqrt2 *
    erfinv(u)`` on ``u`` uniform in ``(nextafter(-1, 0), 1)``.

Keys, words, uniforms and integers are bitwise JAX's.  The exponential and
the normal reproduce XLA's CPU expansions (:func:`log1p`, the Cephes
rational ``log1p`` XLA emits, and :func:`erfinv`, Giles' polynomials) in
elementwise IEEE operations, with this module's own :func:`log` and
:func:`sqrt` (``torch.log``, ``torch.sqrt`` and ``torch.erfinv`` on the
CPU have been seen to round some elements apart from run to run).  XLA's
CPU program contracts each polynomial step into a fused multiply-add and
its ``log`` is the C library's; here each step rounds twice (an emulated
FMA costs about 35 operations a step) and :func:`log` is fdlibm's.  So on
the CPU the float64 exponential is bitwise JAX's for about 94% of draws
and within an ulp for the rest, the float64 normal bitwise for about 92%
and within 3 ulps, the float32 normal within 3 float32 ulps (the tests
hold them to ``rtol 1e-12`` and ``1e-5``).  Every transform gives the
same bits for an element whatever the tensor around it, on every device.

The ``*_words`` functions turn hash words drawn elsewhere (the key-chain
kernel, :mod:`repro_torch.kernels.threefry`) into the same values.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from .numerics import _two_sum, fma

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter ``(x0, x1)`` under the key ``(k0,
    k1)``: 32-bit words as ``int64`` tensors (broadcast) or Python ints;
    returns the two output words.  On CPU tensors the rounds run in numpy's
    wrapping ``uint32`` (the same integers, a quarter of the operations'
    bytes and no intra-op threads)."""
    words = (k0, k1, x0, x1)
    if any(torch.is_tensor(w) for w in words) and all(
            not torch.is_tensor(w) or w.device.type == "cpu" for w in words):
        with np.errstate(over="ignore"):  # uint32 wraps, as it should
            out = _rounds(*[np.asarray(w.numpy() if torch.is_tensor(w)
                                       else w, dtype=np.int64)
                            .astype(np.uint32) for w in words])
        return tuple(torch.from_numpy(np.asarray(o, dtype=np.int64))
                     for o in out)
    return _rounds(k0, k1, x0, x1)


def _rounds(k0, k1, x0, x1):
    """The 20 rounds on ``int64`` tensors or Python ints (masked to 32
    bits), or on numpy ``uint32`` arrays (wrapping; the masks are no-ops)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def hash_key(key: torch.Tensor, c0, c1) -> torch.Tensor:
    """``threefry2x32(key, (c0, c1))`` as a key ``[..., 2]``: the keys
    broadcast against the counters."""
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], c0, c1)
    return torch.stack(torch.broadcast_tensors(torch.as_tensor(b1),
                                               torch.as_tensor(b2)), -1)


def PRNGKey(seed: int, *, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under x64: the seed's 64 bits as
    ``[hi, lo]``."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & MASK], dtype=torch.int64,
                        device=device)


def seed_keys(seeds, *, device="cuda") -> torch.Tensor:
    """``[L, 2]``: one :func:`PRNGKey` per seed."""
    return torch.stack([PRNGKey(s, device="cpu") for s in seeds]).to(device)


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _bits(key: torch.Tensor, shape: Shape):
    """The two hash words of every element of a draw of ``shape`` from
    each key: ``[..., *shape]`` each."""
    shape = _shape(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k = key.reshape(lead + (1,) * len(shape) + (2,))
    return threefry2x32(k[..., 0], k[..., 1], i >> 32, i & MASK)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., *num, 2]`` keys."""
    b1, b2 = _bits(key, num)
    return torch.stack([b1, b2], -1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``,
    ``data`` taken as a 32-bit word."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    return hash_key(key, torch.zeros_like(d), d)


def _signed64(b1, b2) -> torch.Tensor:
    """The unsigned 64-bit ``b1 << 32 | b2`` as its ``int64`` pattern."""
    return torch.where(b1 >= 1 << 31, b1 - (1 << 32), b1) * (1 << 32) + b2


def random_bits(key: torch.Tensor, bit_width: int = 32,
                shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits``: 32-bit words as ``int64`` in ``[0, 2**32)``,
    64-bit words as the ``int64`` bit pattern of JAX's ``uint64``."""
    b1, b2 = _bits(key, shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return _signed64(b1, b2)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit(b1, b2, dtype) -> torch.Tensor:
    """A float in ``[0, 1)`` from one hash's words: the top mantissa bits
    of the 64-bit (float64) or 32-bit (float32) draw under the exponent of
    1, minus 1."""
    if dtype == torch.float64:
        mant = (b1 << 20) | (b2 >> 12)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    if dtype == torch.float32:
        mant = (b1 ^ b2) >> 9
        return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    raise ValueError(f"uniform draws float32 or float64, got {dtype}")


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA's CPU program contracts
    ``uniform``'s scaling: float64 by :func:`numerics.fma`; float32 as the
    exact float64 product and sum rounded to odd, then to float32 (one
    correct rounding)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    if a.dtype == torch.float64:
        return fma(a, b, c)
    s, e = _two_sum(c.double(), a.double() * b.double())
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((e != 0) & even, torch.nextafter(s, toward),
                       s).to(a.dtype)


def uniform_words(words: torch.Tensor, dtype=torch.float64, minval=0.0,
                  maxval=1.0) -> torch.Tensor:
    """:func:`uniform` of the hash words ``[..., 2]`` of its elements."""
    u = _unit(words[..., 0], words[..., 1], dtype)
    if (isinstance(minval, (int, float)) and isinstance(maxval, (int, float))
            and (minval, maxval) == (0, 1)):
        return u  # u * 1 + 0, floored at 0
    lo = torch.as_tensor(minval, dtype=dtype, device=u.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=u.device)
    return torch.maximum(lo, _fma(u, hi - lo, lo))


def uniform(key: torch.Tensor, shape: Shape = (), dtype=torch.float64,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform``: ``[..., *shape]`` in ``[minval, maxval)``."""
    b1, b2 = _bits(key, shape)
    return uniform_words(torch.stack([b1, b2], -1), dtype, minval, maxval)


# XLA's CPU expansions of log1p and erf_inv (its elemental IR emitter's
# Cephes rational log1p, and M. Giles' erfinv polynomials, "Approximating
# the erfinv function", GPU Computing Gems, 2011)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERFINV64 = (  # w < 6.25, w < 16, else
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))
_ERFINV32 = (  # w < 5, else
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682))


def _horner(coeffs, x, p=None) -> torch.Tensor:
    """``p = p * x + c`` over ``coeffs`` (highest degree first)."""
    for c in coeffs:
        p = torch.full_like(x, c) if p is None else p * x + c
    return p


_LN2_HI, _LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10
_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)


def log(x: torch.Tensor) -> torch.Tensor:
    """The natural log of ``x > 0`` in elementwise IEEE operations (fdlibm's
    ``__ieee754_log``, under an ulp; ``0`` gives ``-inf``): the same bits
    for an element whatever the tensor around it, on every device, where
    ``torch.log`` on the CPU may take another code path for some
    elements."""
    mant, e = torch.frexp(x)
    m, k = mant * 2.0, (e - 1).to(x.dtype)
    big = m > math.sqrt(2.0)
    m = torch.where(big, m * 0.5, m)
    k = torch.where(big, k + 1.0, k)
    f = m - 1.0
    s = f / (2.0 + f)
    z = s * s
    w = z * z
    r = (z * (_LG[0] + w * (_LG[2] + w * (_LG[4] + w * _LG[6])))
         + w * (_LG[1] + w * (_LG[3] + w * _LG[5])))
    hfsq = 0.5 * f * f
    out = k * _LN2_HI - ((hfsq - (s * (hfsq + r) + k * _LN2_LO)) - f)
    return torch.where(x == 0.0, -torch.inf, out)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x >= 0`` whatever
    ``torch.sqrt`` returned: a Newton step from it, then of that value and
    its two neighbours the one whose exact residual ``x - y^2`` is
    smallest (``torch.sqrt`` on the CPU has been seen to return values
    1e-11 off for some elements)."""
    y = torch.sqrt(x)
    y = torch.where(y > 0, 0.5 * (y + x / y), y)
    best = y
    err = _fma(-y, y, x).abs()
    for nb in (torch.nextafter(y, torch.zeros_like(y)),
               torch.nextafter(y, torch.full_like(y, torch.inf))):
        e = _fma(-nb, nb, x).abs()
        take = e < err
        best, err = torch.where(take, nb, best), torch.where(take, e, err)
    return torch.where(torch.isfinite(x) & (x > 0), best, torch.sqrt(x))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log1p``: for ``|x| < sqrt2 - 1`` the Cephes rational
    approximation ``x - x^2 / 2 + x^3 P(x) / Q(x)``, else ``log(1 + x)``."""
    x2 = x * x
    small = _horner(_LOG1P_P, x, torch.zeros_like(x)) / _horner(
        _LOG1P_Q, x, torch.zeros_like(x))
    small = x + (-0.5 * x2 + (x * x2) * small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       log(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``erf_inv`` (Giles' polynomials in ``w = -log1p(-x^2)``);
    ``+-1`` gives ``+-inf``."""
    w = -log1p(-x * x)
    # the tail branches on the tail's elements only (about 0.2% of
    # uniform draws): elementwise, so each element's bits are the same
    if x.dtype == torch.float64:
        p = _horner(_ERFINV64[0], w - 3.125)
        tail = w >= 6.25
        wt = w[tail]
        s = sqrt(wt)
        p[tail] = torch.where(wt < 16.0, _horner(_ERFINV64[1], s - 3.25),
                              _horner(_ERFINV64[2], s - 5.0))
    else:
        p = _horner(_ERFINV32[0], w - 2.5)
        tail = w >= 5.0
        p[tail] = _horner(_ERFINV32[1], sqrt(w[tail]) - 3.0)
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def exponential_words(words: torch.Tensor,
                      dtype=torch.float64) -> torch.Tensor:
    """:func:`exponential` of its elements' hash words."""
    return -log1p(-uniform_words(words, dtype))


def exponential(key: torch.Tensor, shape: Shape = (),
                dtype=torch.float64) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, unit rate."""
    b1, b2 = _bits(key, shape)
    return exponential_words(torch.stack([b1, b2], -1), dtype)


def normal_words(words: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """:func:`normal` of its elements' hash words."""
    lo = math.nextafter(-1.0, 0.0) if dtype == torch.float64 else (
        torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                        torch.tensor(0.0, dtype=dtype)).item())
    # uniform in (lo, 1): the span 1 - lo rounds to 2, so u * 2 is exact
    # and the multiply-add rounds once with or without the contraction
    u = _unit(words[..., 0], words[..., 1], dtype)
    u = torch.clamp_min(u * 2.0 + lo, lo)
    return torch.as_tensor(math.sqrt(2.0), dtype=dtype,
                           device=u.device) * erfinv(u)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype=torch.float64) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt2 * erfinv(u)``."""
    b1, b2 = _bits(key, shape)
    return normal_words(torch.stack([b1, b2], -1), dtype)


def randint_words(high: torch.Tensor, low: torch.Tensor, minval, maxval,
                  dtype=torch.int64) -> torch.Tensor:
    """:func:`randint` of its elements' two hashes: ``high`` and ``low``
    ``[..., 2]`` the words drawn from the first and second key of the
    2-way split.  ``minval``/``maxval`` broadcast against the elements;
    spans up to ``2**31 - 1``."""
    dev = high.device
    mn = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    mx = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = torch.where(mx <= mn, torch.ones_like(mx), mx - mn)
    if bool((span >= 1 << 31).any()):
        raise ValueError("randint spans of 2**31 or more are not ported")
    if dtype == torch.int64:
        # the 64-bit words reduced modulo the span half by half:
        # (hi 2^32 + lo) % s == ((hi % s)(2^32 % s) + lo % s) % s
        m32 = (1 << 32) % span
        hi = ((high[..., 0] % span) * m32 + high[..., 1] % span) % span
        lo = ((low[..., 0] % span) * m32 + low[..., 1] % span) % span
        off = (hi * (m32 * m32 % span) + lo) % span
    elif dtype == torch.int32:
        # uint32 arithmetic: the product and the sum wrap at 2^32
        m16 = (1 << 16) % span
        mult = ((m16 * m16) & MASK) % span
        hi = (high[..., 0] ^ high[..., 1]) % span
        lo = (low[..., 0] ^ low[..., 1]) % span
        off = ((((hi * mult) & MASK) + lo) & MASK) % span
    else:
        raise ValueError(f"randint draws int32 or int64, got {dtype}")
    return (mn + off).to(dtype)


def randint(key: torch.Tensor, shape: Shape, minval, maxval,
            dtype=torch.int64) -> torch.Tensor:
    """``jax.random.randint``: ``[..., *shape]`` in ``[minval, maxval)``
    (``int64`` is JAX's default under x64)."""
    k = split(key)
    high = torch.stack(_bits(k[..., 0, :], shape), -1)
    low = torch.stack(_bits(k[..., 1, :], shape), -1)
    return randint_words(high, low, minval, maxval, dtype)


def chain(key, steps: int):
    """The serial key chain ``k_{i+1} = split(k_i)[0]`` in Python ints:
    ``steps`` keys after ``key`` (two ints), as a list of pairs.  What the
    key-chain kernel's plain version walks, one lane at a time."""
    k0, k1 = int(key[0]), int(key[1])
    out = []
    for _ in range(steps):
        k0, k1 = threefry2x32(k0, k1, 0, 0)
        out.append((k0, k1))
    return out
