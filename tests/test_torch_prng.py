"""The port's counter-based random numbers (``repro_torch.core.prng``) and
the key-chain kernel's plain version against ``jax.random``.

1. Exact: keys of 1,005 seeds (negative and 64-bit ones among them),
   ``split`` 2, 3, 6 and ``(n,)``, ``fold_in``, 32- and 64-bit words,
   uniforms in float32 and float64 (with ``minval``/``maxval``, which XLA
   rounds as one fused multiply-add) and ``randint`` in int32 and int64
   over spans 1 to 1e6, none of them a power of two but 1, with a
   negative ``minval`` too.  The Threefry hash on Python ints equals the
   one on tensors.
2. Within a tolerance: the float64 exponential within one ulp and the
   normal within three, so within ``rtol 1e-12`` (the port runs XLA's
   expansions of ``log1p`` and ``erf_inv``, but XLA's ``log`` is the C
   library's; an ``atol`` of 1e-300 only guards the exact zero), the
   float32 normal at ``rtol 1e-5``.
3. The key chain: ``chain_words_plain`` walks the chain that JAX's
   ``draw_event_blocks`` and ``draw_class_event_blocks`` return, and the
   blocks the port resolves from its words are JAX's (routed clients,
   classes and members exact, services within ``rtol 1e-12``; the
   lognormal's stored normals against ``jax.random.normal`` of JAX's raw
   subkeys); every law's ``unit_words`` of its paths is its ``unit_draw``
   and its ``device_draw`` JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import buzen as jbz
from repro.core import events as JE
from repro.scenario import laws as JL
from repro_torch import convert
from repro_torch.core import events as TE
from repro_torch.core import prng
from repro_torch.scenario import laws as TL

SEEDS = list(range(1000)) + [2**31 - 1, 2**32 + 5, -1, -7, 2**62 + 3]
KEYS = prng.seed_keys(SEEDS, device="cpu")
JKEYS = jnp.asarray(KEYS.numpy().astype(np.uint32))


def _jax(fn):
    """``fn`` vmapped over the seeds' keys, jitted; numpy out, unsigned
    words as int64 (uint64 as its bit pattern)."""
    out = np.asarray(jax.jit(jax.vmap(fn))(JKEYS))
    if out.dtype == np.uint32:
        return out.astype(np.int64)
    if out.dtype == np.uint64:
        return out.view(np.int64)
    return out


def _same_bits(got: torch.Tensor, want: np.ndarray):
    assert got.shape == want.shape and str(got.dtype)[6:] == str(want.dtype)
    if want.dtype.kind == "f":
        want = want.view(np.int64 if want.itemsize == 8 else np.int32)
        got = got.view(torch.int64 if want.itemsize == 8 else torch.int32)
    assert np.array_equal(got.numpy(), want)


def test_keys_match_jax_prngkey():
    want = np.asarray(jax.jit(jax.vmap(jax.random.PRNGKey))(
        jnp.asarray(SEEDS, jnp.int64))).astype(np.int64)
    assert np.array_equal(KEYS.numpy(), want)
    assert prng.PRNGKey(3, device="cpu").tolist() == [0, 3]


@pytest.mark.parametrize("num", [2, 3, 6, (5,)])
def test_split_matches_jax(num):
    _same_bits(prng.split(KEYS, num), _jax(lambda k: jax.random.split(k,
                                                                     num)))


def test_fold_in_and_hash_match_jax():
    for data in (0, 1, 2, 12345, 2**32 - 1):
        _same_bits(prng.fold_in(KEYS, data),
                   _jax(lambda k: jax.random.fold_in(k, data)))
    # the hash on Python ints is the hash on tensors
    k0, k1 = KEYS[:50, 0], KEYS[:50, 1]
    t0, t1 = prng.threefry2x32(k0, k1, 7, 2**32 - 3)
    for i in range(50):
        assert prng.threefry2x32(int(k0[i]), int(k1[i]), 7, 2**32 - 3) == (
            int(t0[i]), int(t1[i]))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)])
def test_words_match_jax(shape):
    _same_bits(prng.random_bits(KEYS, 32, shape),
               _jax(lambda k: jax.random.bits(k, shape, jnp.uint32)))
    _same_bits(prng.random_bits(KEYS, 64, shape),
               _jax(lambda k: jax.random.bits(k, shape, jnp.uint64)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.3, 7.1), (2.5, 2.75)])
def test_uniform_matches_jax(dtype, lo, hi):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _same_bits(prng.uniform(KEYS, (5,), td, lo, hi),
               _jax(lambda k: jax.random.uniform(k, (5,), jd, lo, hi)))


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("lo,span", [(0, 1), (0, 3), (5, 7), (0, 1000),
                                     (-2, 65537), (0, 999_983),
                                     (-40, 1_000_000)])
def test_randint_matches_jax(dtype, lo, span):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _same_bits(prng.randint(KEYS, (6,), lo, lo + span, td),
               _jax(lambda k: jax.random.randint(k, (6,), lo, lo + span,
                                                 jd)))


def test_randint_tensor_bounds_and_empty_span():
    hi = torch.tensor([1, 2, 7, 1000, 999_983])
    want = _jax(lambda k: jax.random.randint(k, (5,), 0,
                                             jnp.asarray(hi.numpy())))
    _same_bits(prng.randint(KEYS, (5,), 0, hi), want)
    # maxval <= minval returns minval, as JAX's
    assert bool((prng.randint(KEYS[:9], (4,), 3, 3) == 3).all())
    with pytest.raises(ValueError, match="2\\*\\*31"):
        prng.randint(KEYS[:1], (2,), 0, 2**31)


def _rel(got, want):
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))


def _ulps(got, want):
    """The largest distance in float64 ulps (both arrays of one sign per
    element, as two roundings of one value are)."""
    return int(np.max(np.abs(got.view(np.int64) - want.view(np.int64))))


def test_exponential_and_normal_within_tolerance():
    e = prng.exponential(KEYS, (100,)).numpy()
    want = _jax(lambda k: jax.random.exponential(k, (100,)))
    assert _rel(e, want) < 1e-12 and _ulps(e, want) <= 1
    z = prng.normal(KEYS, (100,)).numpy()
    want = _jax(lambda k: jax.random.normal(k, (100,)))
    assert _rel(z, want) < 1e-12 and _ulps(z, want) <= 3
    z32 = prng.normal(KEYS, (50,), torch.float32).numpy()
    want32 = _jax(lambda k: jax.random.normal(k, (50,), jnp.float32))
    assert z32.dtype == np.float32 and _rel(z32, want32) < 1e-5


def _leaves(tree):
    def arr(v):
        if isinstance(v, tuple) and v:
            return tuple(np.asarray(x) for x in v)
        return None if v is None else np.asarray(v)

    return {k: arr(v) for k, v in tree._asdict().items()}


_normals = jax.jit(lambda ks: jax.vmap(jax.random.normal)(
    ks.reshape(-1, 2)).reshape(ks.shape[:-1]))


def _close(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300,
                                   err_msg=str(what))
    else:
        assert np.array_equal(got, want), what


@pytest.mark.parametrize("law", ["exponential", "deterministic", "lognormal",
                                 "hyperexponential"])
@pytest.mark.parametrize("classes", [False, True])
def test_plain_chain_and_blocks_match_jax_draws(law, classes):
    rng = np.random.default_rng(4)
    n, N = 5, 300
    leaves = dict(p=rng.dirichlet(np.ones(n)), mu_c=rng.uniform(0.5, 3, n),
                  mu_d=rng.uniform(0.5, 3, n), mu_u=rng.uniform(0.5, 3, n))
    if classes:  # counts up to 400,000: member draws past 2**16
        count = np.array([3, 1, 400_000, 7, 2])
        jp = jbz.ClassParams(count=jnp.asarray(count, jnp.int64), **{
            k: jnp.asarray(v / count if k == "p" else v)
            for k, v in leaves.items()}).with_cs(2.0)
        draw = JE.draw_class_event_blocks
        tp = convert.class_params(_leaves(jp), device="cpu")
    else:
        jp = jbz.NetworkParams(**{k: jnp.asarray(v)
                                  for k, v in leaves.items()}).with_cs(2.0)
        draw = JE.draw_event_blocks
        tp = convert.network_params(_leaves(jp), device="cpu")
    key = jax.random.PRNGKey(11)
    chain, blk = jax.jit(lambda p, k: draw(p, k, N, distribution=law))(
        jp, key)
    if law == "lognormal":  # JAX stores raw subkeys; the port the normals
        blk = blk._replace(up=_normals(blk.up), comp=_normals(blk.comp))
    want = convert.event_blocks(_leaves(blk), device="cpu")
    tkey = torch.as_tensor(np.asarray(key).astype(np.int64))
    got_chain, got = (TE.draw_class_event_blocks if classes
                      else TE.draw_event_blocks)(tp, tkey, N,
                                                 distribution=law)
    assert np.array_equal(got_chain.numpy(),
                          np.asarray(chain).astype(np.int64))
    for name in TE.EventBlocks._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            _close(g, w.numpy(), name)
    if law == "deterministic":  # uniforms and integers only: bitwise
        assert torch.equal(got.svc_down, want.svc_down)


@pytest.mark.parametrize("law", ["exponential", "deterministic", "lognormal",
                                 "hyperexponential"])
def test_law_paths_are_its_unit_draw_and_jax_device_draw(law):
    tl, jl = TL.get_law(law), JL.get_law(law)
    keys = KEYS[:200]

    def follow(path):  # the hashes of a path's counters in turn
        w = keys
        for c in path:
            w = prng.hash_key(w, 0, c)
        return w

    words = (torch.stack([follow(p) for p in tl.paths], -2) if tl.paths
             else torch.zeros(200, 0, 2, dtype=torch.int64))
    assert torch.equal(tl.unit_words(words), tl.unit_draw(keys))
    rate = torch.as_tensor(np.random.default_rng(3).uniform(0.2, 5.0, 200))
    got = tl.device_draw(keys, rate)
    want = np.asarray(jax.jit(jax.vmap(jl.device_draw))(
        JKEYS[:200], jnp.asarray(rate.numpy())))
    _close(got, want, law)
