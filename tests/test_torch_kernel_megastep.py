"""The megastep kernel's plain version (what CPU tensors run) against the
JAX package's Pallas kernel ``megastep_tables`` in interpret mode: exact
on every output column (tables, event times, the ten descriptors per event
with ``keep``), on numpy-made tables whose clocks and FIFO sequence numbers
tie often, with per-lane ``rem`` below ``chunk`` and the ``stop_on_update``
latch.  Inside the port, one megastep equals ``chunk`` single steps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.kernels import events as jk
from repro_torch.core import events as E
from repro_torch.kernels import events as tk


def _tables(seed, K, m_max, n, has_cs, chunk, law):
    """Random lane tables and the scalars of ``chunk`` events.  Under the
    deterministic law every unit variate is 1 and the rates come from a
    small set, so clocks tie after transitions as well as before."""
    rng = np.random.default_rng(seed)
    phase = rng.choice(np.arange(-1, 6 if has_cs else 4),
                       size=(K, m_max)).astype(np.int32)
    phase[0] = E.INACTIVE  # a lane with every clock at +inf
    in_service = np.isin(phase, [E.DOWN, E.COMP_SERV, E.UP, E.CS_SERV])
    finish = np.where(in_service, rng.choice([0.5, 1.0, 1.5], (K, m_max)),
                      np.inf)
    client = rng.integers(0, n, (K, m_max)).astype(np.int32)
    seq = rng.integers(0, 4, (K, m_max)).astype(np.int32)  # frequent ties
    disp = rng.integers(0, 30, (K, m_max)).astype(np.int32)
    if law == "deterministic":
        mu_c = rng.choice([1.0, 2.0], (K, n))
        mu_u = rng.choice([1.0, 2.0], (K, n))
        fscal = np.tile([1.0, 1.0, 0.5, 0.5], (K, chunk))
    else:
        mu_c = rng.uniform(0.3, 4.0, (K, n))
        mu_u = rng.uniform(0.3, 4.0, (K, n))
        fscal = rng.exponential(size=(K, 4 * chunk))
    rem = rng.integers(0, chunk + 1, (K, 1))
    rem[1] = chunk  # at least one full lane
    iscal = np.concatenate([rng.integers(10, 20, (K, 1)),
                            rng.integers(30, 40, (K, 1)), rem,
                            rng.integers(0, n, (K, chunk))],
                           axis=1).astype(np.int32)
    return finish, phase, client, seq, disp, mu_c, mu_u, fscal, iscal


_NAMES = ("finish", "phase", "client", "seq", "disp", "t", "desc")


@pytest.mark.parametrize("law", ["exponential", "deterministic"])
@pytest.mark.parametrize("stop_on_update", [False, True])
@pytest.mark.parametrize("has_cs", [False, True])
@pytest.mark.parametrize("chunk", [1, 2, 7])
def test_plain_matches_pallas_interpret_exactly(chunk, has_cs,
                                                stop_on_update, law):
    args = _tables(chunk + 10 * has_cs, 24, 12, 4, has_cs, chunk, law)
    kw = dict(has_cs=has_cs, chunk=chunk, stop_on_update=stop_on_update)
    want = jk.megastep_tables(*[jnp.asarray(a) for a in args],
                              interpret=True, **kw)
    got = tk.megastep_tables(*[torch.as_tensor(a) for a in args], **kw)
    for name, g, w in zip(_NAMES, got, want):
        w = np.asarray(w)
        assert g.dtype == {"finish": torch.float64,
                           "t": torch.float64}.get(name, torch.int32), name
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    keep = got[-1].reshape(24, chunk, 10)[..., 9]
    assert (keep.sum(1) <= torch.as_tensor(args[-1][:, 2])).all()
    if chunk > 1:  # the cases reach masked events
        assert not keep.all()


@pytest.mark.parametrize("has_cs", [False, True])
def test_one_megastep_equals_chunk_single_steps(has_cs):
    chunk = 7
    (finish, phase, client, seq, disp, mu_c, mu_u, fscal,
     iscal) = [torch.as_tensor(a) for a in
               _tables(5, 16, 20, 5, has_cs, chunk, "deterministic")]
    iscal[:, 2] = chunk
    got = tk.megastep_tables(finish, phase, client, seq, disp, mu_c, mu_u,
                             fscal, iscal, has_cs=has_cs, chunk=chunk)
    tbl = (finish, phase, client, seq, disp)
    seq_ctr, rnd = iscal[:, 0], iscal[:, 1]
    for i in range(chunk):
        one = torch.stack([iscal[:, 3 + i], seq_ctr, rnd], dim=-1)
        *tbl, t, d = tk.event_step_tables(*tbl, mu_c, mu_u,
                                          fscal[:, 4 * i:4 * i + 4], one,
                                          has_cs=has_cs)
        seq_ctr, rnd = d[:, 4], d[:, 5]
        assert torch.equal(got[5][:, i], t[:, 0])
        assert torch.equal(got[6][:, 10 * i:10 * i + 9], d)
    for g, w in zip(got[:5], tbl):
        assert torch.equal(g, w)


def test_cpu_runs_plain_and_counts_no_launch():
    args = [torch.as_tensor(a)
            for a in _tables(3, 4, 6, 3, True, 3, "exponential")]
    before = tk.megastep_tables.launches
    a = tk.megastep_tables(*args, has_cs=True, chunk=3)
    b = tk.megastep_tables_plain(*args, has_cs=True, chunk=3)
    assert tk.megastep_tables.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tk.megastep_tables(*args, has_cs=True, chunk=0)
