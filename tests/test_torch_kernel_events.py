"""The event kernel's plain version (what CPU tensors run) against the JAX
package's Pallas kernel ``event_step_tables`` in interpret mode: bitwise,
on numpy-made tables whose finish clocks and FIFO sequence numbers tie
often, so the lowest-index tie rule is exercised."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.kernels import events as jk
from repro_torch.core import events as E
from repro_torch.kernels import events as tk


def _tables(seed, K, m_max, n, has_cs):
    rng = np.random.default_rng(seed)
    phases = np.arange(-1, 6 if has_cs else 4)
    phase = rng.choice(phases, size=(K, m_max)).astype(np.int32)
    phase[0] = E.INACTIVE  # a lane with every clock at +inf
    in_service = np.isin(phase, [E.DOWN, E.COMP_SERV, E.UP, E.CS_SERV])
    finish = np.where(in_service, rng.choice([0.5, 1.25, 2.0], (K, m_max)),
                      np.inf)
    client = rng.integers(0, n, (K, m_max)).astype(np.int32)
    seq = rng.integers(0, 4, (K, m_max)).astype(np.int32)  # frequent ties
    disp = rng.integers(0, 30, (K, m_max)).astype(np.int32)
    mu_c = rng.uniform(0.3, 4.0, (K, n))
    mu_u = rng.uniform(0.3, 4.0, (K, n))
    fscal = rng.exponential(size=(K, 4))
    iscal = np.stack([rng.integers(0, n, K), rng.integers(10, 20, K),
                      rng.integers(30, 40, K)], axis=1).astype(np.int32)
    return finish, phase, client, seq, disp, mu_c, mu_u, fscal, iscal


@pytest.mark.parametrize("has_cs", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_interpret_bitwise(has_cs, seed):
    args = _tables(seed, 64, 12, 4, has_cs)
    want = jk.event_step_tables(*[jnp.asarray(a) for a in args],
                                has_cs=has_cs, interpret=True)
    got = tk.event_step_tables(*[torch.as_tensor(a) for a in args],
                               has_cs=has_cs)
    names = ("finish", "phase", "client", "seq", "disp", "t", "desc")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.dtype == {"finish": torch.float64,
                           "t": torch.float64}.get(name, torch.int32), name
        assert np.array_equal(g.numpy(), w), name


def test_cpu_runs_plain_and_counts_no_launch():
    args = [torch.as_tensor(a) for a in _tables(3, 4, 6, 3, True)]
    before = tk.event_step_tables.launches
    a = tk.event_step_tables(*args, has_cs=True)
    b = tk.event_step_tables_plain(*args, has_cs=True)
    assert tk.event_step_tables.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))

