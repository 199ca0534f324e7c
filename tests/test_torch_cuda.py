"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is ``cuda``-marked and skips without a CUDA device; the file
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the Buzen kernels (per client and per class) within ``rtol/atol
2e-5`` of their plain float32 versions (both kernels carry their row in
float64 and are closer to the float64 DP than the plain versions are),
padded (load-0 or count-0) columns bitwise identities, the float64
backward kernels (per client and per class) within ``rtol 1e-9`` (plus an
``atol`` of 1e-12 times the largest partial) of their plain adjoints, with
their padded partials exactly 0 and their real ones bitwise the unpadded
run's, and every row's results independent of the batch around it; count-1
class columns are geometric stations (the class kernels against the
per-client ones, forward within ``2e-5``, backward within ``rtol 1e-9``);
both sweeps within ``rtol 1e-4`` of the float64 ones; the event and
megastep kernels bitwise (IEEE division, no contraction), and so their lane
counterparts on every ``EventState`` leaf, in shared and in global memory,
in each timing law's rate form (``x / mu``, the hyperexponential's ``x /
(f mu)`` and the lognormal's ``exp((z - log mu) - 0.5)`` with CUDA's
double ``exp`` and ``log``, which PyTorch's CUDA ``exp`` and ``log`` call),
with the energy integral's fused multiply-adds on the card's DFMA against
the plain version's emulation (both round once); the fused update
bitwise on the new parameters (a rounded multiply, then a rounded
subtract) and within ``rtol 1e-5`` on the squared
gradient norm (another summation order), and the trainer with it bitwise
the trainer without it; flash attention within ``2e-5`` of its plain
version in float32 and ``2e-2`` in bfloat16 (``tests/test_kernels.py``'s
bounds: float32 FFMA in another summation order; in bfloat16 the tensor
cores take p rounded to bfloat16 and the output is rounded to bfloat16),
and the reduced qwen3 LM on the ``kernel`` route within ``1e-4``
of the ``ref`` route in float32; decode attention likewise within ``2e-5``
and ``2e-2`` of its plain version (in bfloat16 the tensor cores take p
rounded to bfloat16, in one part or with the cache split into several; a
cache holding NaN past the lengths gives bitwise the clean cache's
output), and the reduced LM's decode (``kernel`` route, the ring buffer,
the serve loop) within ``1e-4`` of the ``ref`` route and of the
full-sequence forward in float32.  The key-chain kernel is an integer
function: its chain and words bitwise its plain version's and the JAX
package's known answers.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import events as E
from repro_torch.core import prng
from repro_torch.core.buzen import NetworkParams
from repro_torch.core.energy import PowerProfile
from repro_torch.kernels import buzen as kb
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import events as ke
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import fused_update as kf
from repro_torch.kernels import threefry as ktf
from repro_torch.core.buzen import pad_classes
from repro_torch.core.optimize import time_optimal, time_optimal_classes
from repro_torch.scenario.laws import H2_FAST, H2_SLOW
from repro_torch.scenario.spec import (PAPER_CLUSTERS_TABLE1, ClassSpec,
                                       LearningSpec, NetworkSpec)
from repro_torch.sim import simulate_stats_classes_lanes, simulate_stats_lanes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(seed, B, S):
    rng = np.random.default_rng(seed)
    lr = np.log(rng.dirichlet(np.ones(S), size=B)) - np.log(
        rng.uniform(0.2, 8.0, (B, S)))
    lr[::5, -2:] = -np.inf  # padded (load-0) stations
    return lr, np.log(rng.uniform(0.1, 3.0, B))


def _tables(seed, K, m_max, n, has_cs):
    rng = np.random.default_rng(seed)
    phase = rng.choice(np.arange(-1, 6 if has_cs else 4),
                       size=(K, m_max)).astype(np.int32)
    phase[0] = E.INACTIVE  # a lane with every clock at +inf
    in_service = np.isin(phase, [E.DOWN, E.COMP_SERV, E.UP, E.CS_SERV])
    finish = np.where(in_service, rng.choice([0.5, 1.25, 2.0], (K, m_max)),
                      np.inf)
    return (finish, phase,
            rng.integers(0, n, (K, m_max)).astype(np.int32),
            rng.integers(0, 4, (K, m_max)).astype(np.int32),  # seq ties
            rng.integers(0, 30, (K, m_max)).astype(np.int32),
            rng.uniform(0.3, 4.0, (K, n)), rng.uniform(0.3, 4.0, (K, n)),
            rng.exponential(size=(K, 4)),
            np.stack([rng.integers(0, n, K), rng.integers(10, 20, K),
                      rng.integers(30, 40, K)], axis=1).astype(np.int32))


@pytest.mark.parametrize("S,m_max", [(100, 132), (101, 132), (7, 40)])
def test_buzen_kernel_matches_plain(cuda, S, m_max):
    lr, lg = _rows(S, 131, S)
    a = torch.as_tensor(lr, device=cuda)
    b = torch.as_tensor(lg, device=cuda)
    want = kb.buzen_batched_plain(a, b, m_max)
    before = kb.buzen_batched.launches
    got = kb.buzen_batched(a, b, m_max)
    torch.cuda.synchronize()
    assert kb.buzen_batched.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m_max", [0, 1, 31, 32, 33, 132, 1000])
@pytest.mark.parametrize("S", [7, 100, 101])
def test_buzen_kernel_matches_plain_at_every_width(cuda, S, m_max):
    """Row pairs that meet in the middle (odd and even m_pad), one group or
    several rounds of them; against the float32 plain version."""
    lr, lg = _rows(1000 + S, 131 if m_max < 1000 else 9, S)
    a = torch.as_tensor(lr, device=cuda)
    b = torch.as_tensor(lg, device=cuda)
    want = kb.buzen_batched_plain(a, b, m_max)
    got = kb.buzen_batched(a, b, m_max)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _with_pad_columns(lr):
    """``lr`` with -inf (load-0) columns at the front, in the middle and at
    the end; returns the padded array and the real columns' indices."""
    B, S = lr.shape
    pad = np.full((B, 1), -np.inf)
    mid = S // 2
    out = np.concatenate([pad, lr[:, :mid], pad, pad, lr[:, mid:], pad], 1)
    real = [1 + i for i in range(mid)] + [3 + i for i in range(mid, S)]
    return out, real


def _close_partials(got, want):
    """rtol 1e-9 plus an atol of 1e-12 times the largest partial."""
    torch.testing.assert_close(got, want, rtol=1e-9,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("S,m_max", [(100, 132), (7, 40), (12, 1000)])
def test_buzen_padded_stations_bitwise(cuda, S, m_max):
    rng = np.random.default_rng(S)
    lr = np.log(rng.dirichlet(np.ones(S), size=6)) - np.log(
        rng.uniform(0.2, 8.0, (6, S)))
    lg = np.log(rng.uniform(0.1, 3.0, 6))
    padded, real = _with_pad_columns(lr)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    assert torch.equal(kb.buzen_batched(t(padded), t(lg), m_max),
                       kb.buzen_batched(t(lr), t(lg), m_max))
    g = t(rng.normal(size=(6, m_max + 1)))
    base_lr, base_lg = kb.buzen_log_Z_backward(t(lr), t(lg), g, m_max)
    pad_lr, pad_lg = kb.buzen_log_Z_backward(t(padded), t(lg), g, m_max)
    torch.cuda.synchronize()
    assert torch.equal(pad_lr[:, real], base_lr)
    assert torch.equal(pad_lg, base_lg)
    dead = [i for i in range(padded.shape[1]) if i not in real]
    assert bool((pad_lr[:, dead] == 0.0).all())
    # a row's results do not depend on the batch around it
    sub = slice(1, None, 2)
    assert torch.equal(kb.buzen_batched(t(lr[sub]), t(lg[sub]), m_max),
                       kb.buzen_batched(t(padded), t(lg), m_max)[sub])
    sub_lr, sub_lg = kb.buzen_log_Z_backward(t(lr[sub]), t(lg[sub]),
                                             g[sub].contiguous(), m_max)
    assert torch.equal(sub_lr, base_lr[sub])
    assert torch.equal(sub_lg, base_lg[sub])


@pytest.mark.parametrize("B,S,m_max", [(131, 100, 132), (131, 101, 132),
                                       (5, 7, 40), (3, 12, 0), (4, 3, 1),
                                       (2, 5, 1000)])
def test_buzen_backward_kernel_matches_plain(cuda, B, S, m_max):
    lr, lg = _rows(7 * S + m_max, B, S)
    a = torch.as_tensor(lr, device=cuda)
    b = torch.as_tensor(lg, device=cuda)
    g = torch.as_tensor(np.random.default_rng(S).normal(size=(B, m_max + 1)),
                        device=cuda)
    want_lr, want_lg = kb.buzen_log_Z_backward_plain(a, b, g, m_max)
    before = kb.buzen_log_Z_backward.launches
    got_lr, got_lg = kb.buzen_log_Z_backward(a, b, g, m_max)
    torch.cuda.synchronize()
    assert kb.buzen_log_Z_backward.launches == before + 1
    _close_partials(got_lr, want_lr)
    _close_partials(got_lg, want_lg)
    assert bool((got_lr[~torch.isfinite(a)] == 0.0).all())


def test_time_optimal_kernel_matches_torch(cuda):
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1).params(device=cuda)
    consts = LearningSpec().consts
    kb.buzen_batched.launches = 0
    kb.buzen_log_Z_backward.launches = 0
    got = time_optimal(net, consts, 40, steps=30, backend="kernel")
    assert kb.buzen_batched.launches == 31
    assert kb.buzen_log_Z_backward.launches == 30
    want = time_optimal(net, consts, 40, steps=30, backend="torch")
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=1e-4)
    assert got.m == want.m


def _class_rows(seed, B, S, scale, with_cs):
    """Table 1's profiles as ``S`` class columns (counts x ``scale``), two
    more count-0 columns, random per-member routing, and the CS station as
    a count-1 column when ``with_cs``."""
    rng = np.random.default_rng(seed)
    base = np.array([c.count for c in PAPER_CLUSTERS_TABLE1] * 2)[:S]
    counts = np.tile(np.concatenate([base * scale, [0, 0]]), (B, 1))
    mu_c = np.array([c.mu_c for c in PAPER_CLUSTERS_TABLE1] * 2)[:S]
    mass = rng.dirichlet(np.ones(S), size=B)
    lr = np.concatenate([np.log(mass / counts[:, :S]) - np.log(mu_c),
                         np.full((B, 2), -np.inf)], axis=1)
    if with_cs:
        lr = np.concatenate([lr, np.log(rng.uniform(0.1, 1.0, (B, 1)))], 1)
        counts = np.concatenate([counts, np.ones((B, 1), np.int64)], 1)
    return lr, counts.astype(np.float64), np.log(rng.uniform(0.5, 3.0, B))


@pytest.mark.parametrize("scale", [1, 10_000])
@pytest.mark.parametrize("S,with_cs", [(5, False), (5, True), (6, False)])
def test_buzen_classes_kernel_matches_plain(cuda, S, with_cs, scale):
    lr, cnt, lg = [torch.as_tensor(x, device=cuda)
                   for x in _class_rows(S + scale, 131, S, scale, with_cs)]
    want = kb.buzen_classes_batched_plain(lr, cnt, lg, 132)
    before = kb.buzen_classes_batched.launches
    got = kb.buzen_classes_batched(lr, cnt, lg, 132)
    torch.cuda.synchronize()
    assert kb.buzen_classes_batched.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    f64 = kb.reference_class_log_Z(lr, cnt, lg, 132)
    torch.testing.assert_close(got.double(), f64, rtol=3e-5, atol=3e-4)
    # the padded (count-0) columns are identities, bitwise
    keep = [i for i in range(cnt.shape[1]) if i not in (S, S + 1)]
    unpadded = kb.buzen_classes_batched(lr[:, keep].contiguous(),
                                        cnt[:, keep].contiguous(), lg, 132)
    assert torch.equal(unpadded, got)


@pytest.mark.parametrize("m_max", [0, 1, 31, 32, 33, 132, 1000, 4095])
@pytest.mark.parametrize("S,with_cs", [(5, False), (5, True), (6, False)])
def test_buzen_classes_kernel_matches_plain_at_every_width(cuda, S, with_cs,
                                                          m_max):
    """Row pairs that meet in the middle (odd and even m_pad), one group or
    several rounds of them, up to the range's edge (m_pad = 4096, four
    float64 rows in 128 KB of shared memory); against the float32 plain
    version."""
    lr, cnt, lg = [torch.as_tensor(x, device=cuda) for x in _class_rows(
        2000 + 7 * S + m_max, 131 if m_max < 1000 else 3, S, 1, with_cs)]
    want = kb.buzen_classes_batched_plain(lr, cnt, lg, m_max)
    got = kb.buzen_classes_batched(lr, cnt, lg, m_max)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _with_pad_classes(lr, cnt):
    """``lr``/``cnt`` with count-0 columns at the front (log_rho finite)
    and in the middle (-inf); returns them and the real columns' indices
    (the columns ``_class_rows`` padded are real here: dead ones stay)."""
    B, S = lr.shape
    mid = S // 2
    out_lr = np.concatenate([np.full((B, 1), -1.0), lr[:, :mid],
                             np.full((B, 1), -np.inf), lr[:, mid:]], 1)
    out_cnt = np.concatenate([np.zeros((B, 1)), cnt[:, :mid],
                              np.zeros((B, 1)), cnt[:, mid:]], 1)
    real = [1 + i for i in range(mid)] + [2 + i for i in range(mid, S)]
    return out_lr, out_cnt, real


@pytest.mark.parametrize("S,scale,m_max", [(5, 10_000, 132), (3, 1, 40),
                                           (6, 1, 1000)])
def test_buzen_classes_padded_columns_bitwise(cuda, S, scale, m_max):
    """Count-0 columns are identities: the forward bitwise the run without
    them, the backward's real partials and d/d lg bitwise, its padded
    partials exactly 0; a sub-batch of rows bitwise the full batch's."""
    lr, cnt, lg = _class_rows(3000 + S, 6, S, scale, with_cs=True)
    lr_p, cnt_p, real = _with_pad_classes(lr, cnt)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    base = kb.buzen_classes_batched(t(lr), t(cnt), t(lg), m_max)
    assert torch.equal(kb.buzen_classes_batched(t(lr_p), t(cnt_p), t(lg),
                                                m_max), base)
    g = t(np.random.default_rng(S).normal(size=(6, m_max + 1)))
    base_lr, base_lg = kb.buzen_classes_log_Z_backward(t(lr), t(cnt), t(lg),
                                                       g, m_max)
    pad_lr, pad_lg = kb.buzen_classes_log_Z_backward(t(lr_p), t(cnt_p),
                                                     t(lg), g, m_max)
    torch.cuda.synchronize()
    assert torch.equal(pad_lr[:, real], base_lr)
    assert torch.equal(pad_lg, base_lg)
    dead = [i for i in range(lr_p.shape[1]) if i not in real]
    assert bool((pad_lr[:, dead] == 0.0).all())
    assert bool((base_lr[~(torch.isfinite(t(lr)) & (t(cnt) > 0))]
                 == 0.0).all())
    # a row's results do not depend on the batch around it
    sub = slice(1, None, 2)
    assert torch.equal(kb.buzen_classes_batched(t(lr[sub]), t(cnt[sub]),
                                                t(lg[sub]), m_max),
                       base[sub])
    sub_lr, sub_lg = kb.buzen_classes_log_Z_backward(
        t(lr[sub]), t(cnt[sub]), t(lg[sub]), g[sub].contiguous(), m_max)
    assert torch.equal(sub_lr, base_lr[sub])
    assert torch.equal(sub_lg, base_lg[sub])


@pytest.mark.parametrize("m_max", [1, 40, 132])
def test_buzen_classes_count_one_columns_are_stations(cuda, m_max):
    """A class of count 1 is a single-server station (the CS column's
    case): on per-client rows with every count 1 the class kernels agree
    with the per-client ones, both carrying float64 rows."""
    lr, lg = _rows(90 + m_max, 131, 7)
    a = torch.as_tensor(lr, device=cuda)
    b = torch.as_tensor(lg, device=cuda)
    ones = torch.ones_like(a)
    torch.testing.assert_close(kb.buzen_classes_batched(a, ones, b, m_max),
                               kb.buzen_batched(a, b, m_max), rtol=2e-5,
                               atol=2e-5)
    g = torch.as_tensor(np.random.default_rng(m_max).normal(
        size=(131, m_max + 1)), device=cuda)
    got_lr, got_lg = kb.buzen_classes_log_Z_backward(a, ones, b, g, m_max)
    want_lr, want_lg = kb.buzen_log_Z_backward(a, b, g, m_max)
    torch.cuda.synchronize()
    _close_partials(got_lr, want_lr)
    _close_partials(got_lg, want_lg)


@pytest.mark.parametrize("B,S,scale,m_max,with_cs", [
    (131, 5, 10_000, 132, False), (131, 5, 1, 132, True),
    (131, 6, 10_000, 132, True), (5, 5, 1, 40, False), (3, 5, 1, 0, True),
    (4, 5, 1, 1, False), (2, 5, 1, 1000, True), (2, 5, 1, 4095, False)])
def test_buzen_classes_backward_kernel_matches_plain(cuda, B, S, scale,
                                                     m_max, with_cs):
    lr, cnt, lg = [torch.as_tensor(x, device=cuda) for x in _class_rows(
        4000 + S + m_max, B, S, scale, with_cs)]
    g = torch.as_tensor(np.random.default_rng(S).normal(size=(B, m_max + 1)),
                        device=cuda)
    want_lr, want_lg = kb.buzen_classes_log_Z_backward_plain(lr, cnt, lg, g,
                                                             m_max)
    before = kb.buzen_classes_log_Z_backward.launches
    got_lr, got_lg = kb.buzen_classes_log_Z_backward(lr, cnt, lg, g, m_max)
    torch.cuda.synchronize()
    assert kb.buzen_classes_log_Z_backward.launches == before + 1
    _close_partials(got_lr, want_lr)
    _close_partials(got_lg, want_lg)
    assert bool((got_lr[cnt == 0] == 0.0).all())


def test_buzen_classes_log_Z_batched_launches_once_each_way(cuda):
    """Through the autograd function: one forward launch, and one backward
    launch with no autograd recompute, equal to the backward wrapper's."""
    lr, cnt, lg = [torch.as_tensor(x, device=cuda)
                   for x in _class_rows(5000, 131, 5, 10_000, True)]
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(131, 133)),
                        device=cuda)
    a = lr.clone().requires_grad_(True)
    b = lg.clone().requires_grad_(True)
    fwd = kb.buzen_classes_batched.launches
    bwd = kb.buzen_classes_log_Z_backward.launches
    out = kb.buzen_classes_log_Z_batched(a, cnt, b, 132)
    assert kb.buzen_classes_batched.launches == fwd + 1
    assert kb.buzen_classes_log_Z_backward.launches == bwd
    g_lr, g_lg = torch.autograd.grad(out, (a, b), g)
    torch.cuda.synchronize()
    assert kb.buzen_classes_batched.launches == fwd + 1
    assert kb.buzen_classes_log_Z_backward.launches == bwd + 1
    want = kb.buzen_classes_log_Z_backward(lr, cnt, lg, g, 132)
    assert torch.equal(g_lr, want[0]) and torch.equal(g_lg, want[1])


def test_time_optimal_classes_kernel_matches_torch(cuda):
    cp = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1).class_params(
        device=cuda)
    consts = LearningSpec().consts
    kb.buzen_classes_batched.launches = 0
    got = time_optimal_classes(cp, consts, 40, steps=30, backend="kernel")
    assert kb.buzen_classes_batched.launches == 31
    want = time_optimal_classes(cp, consts, 40, steps=30, backend="torch")
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=1e-4)
    padded = time_optimal_classes(pad_classes(cp, 7), consts, 40, steps=30,
                                  backend="kernel")
    assert padded.value == got.value and padded.m == got.m


def test_class_lanes_on_the_card(cuda):
    cp = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale=10).class_params(
        mu_cs=4.0, device=cuda)
    kw = dict(warmup=50, seeds=range(3), distribution="exponential")
    want = simulate_stats_classes_lanes([cp] * 3, [5, 6, 7], 200,
                                        backend="batched", **kw)
    for chunk in (1, 8):
        got = simulate_stats_classes_lanes([cp] * 3, [5, 6, 7], 200,
                                           backend="reference", chunk=chunk,
                                           **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no kernel"):
        simulate_stats_classes_lanes([cp], [5], 10, backend="kernel")


@pytest.mark.parametrize("has_cs", [False, True])
@pytest.mark.parametrize("m_max", [12, 132, 1000])
def test_event_kernel_matches_plain_bitwise(cuda, has_cs, m_max):
    args = [torch.as_tensor(a, device=cuda)
            for a in _tables(m_max, 64, m_max, 100, has_cs)]
    want = ke.event_step_tables_plain(*args, has_cs=has_cs)
    before = ke.event_step_tables.launches
    got = ke.event_step_tables(*args, has_cs=has_cs)
    torch.cuda.synchronize()
    assert ke.event_step_tables.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _mega_tables(seed, K, m_max, n, has_cs, chunk, law):
    """Random tables (clock and seq ties) and the scalars of ``chunk``
    events; the deterministic law's unit variates are 1 and its rates come
    from a small set, so clocks also tie after transitions."""
    rng = np.random.default_rng(seed)
    finish, phase, client, seq, disp = _tables(seed, K, m_max, n,
                                               has_cs)[:5]
    if law == "deterministic":
        mu_c = rng.choice([1.0, 2.0], (K, n))
        mu_u = rng.choice([1.0, 2.0], (K, n))
        fscal = np.tile([1.0, 1.0, 0.5, 0.5], (K, chunk))
    else:
        mu_c = rng.uniform(0.3, 4.0, (K, n))
        mu_u = rng.uniform(0.3, 4.0, (K, n))
        fscal = rng.exponential(size=(K, 4 * chunk))
    rem = rng.integers(0, chunk + 1, (K, 1))
    rem[1] = chunk
    iscal = np.concatenate([rng.integers(10, 20, (K, 1)),
                            rng.integers(30, 40, (K, 1)), rem,
                            rng.integers(0, n, (K, chunk))],
                           axis=1).astype(np.int32)
    return finish, phase, client, seq, disp, mu_c, mu_u, fscal, iscal


@pytest.mark.parametrize("law", ["exponential", "deterministic"])
@pytest.mark.parametrize("stop_on_update", [False, True])
@pytest.mark.parametrize("has_cs", [False, True])
@pytest.mark.parametrize("chunk,m_max", [(1, 132), (7, 12), (7, 1000),
                                         (32, 132)])
def test_megastep_kernel_matches_plain_bitwise(cuda, chunk, m_max, has_cs,
                                               stop_on_update, law):
    args = [torch.as_tensor(a, device=cuda)
            for a in _mega_tables(chunk + m_max, 64, m_max, 100, has_cs,
                                  chunk, law)]
    kw = dict(has_cs=has_cs, chunk=chunk, stop_on_update=stop_on_update)
    want = ke.megastep_tables_plain(*args, **kw)
    before = ke.megastep_tables.launches
    got = ke.megastep_tables(*args, **kw)
    torch.cuda.synchronize()
    assert ke.megastep_tables.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("chunk", [1, 7])
def test_transition_kernels_in_global_memory(cuda, chunk):
    # m_max = 10,000: the transition's rows take about 240 KB, past what a
    # block may stage, so the kernel works on them in place
    args = [torch.as_tensor(a, device=cuda)
            for a in _mega_tables(4 + chunk, 4, 10000, 100, True, chunk,
                                  "exponential")]
    if chunk == 1:
        one = torch.stack([args[-1][:, 3], args[-1][:, 0], args[-1][:, 1]],
                          dim=-1)
        args = args[:7] + [args[7][:, :4].contiguous(), one]
        got = ke.event_step_tables(*args, has_cs=True)
        want = ke.event_step_tables_plain(*args, has_cs=True)
    else:
        kw = dict(has_cs=True, chunk=chunk, stop_on_update=True)
        got = ke.megastep_tables(*args, **kw)
        want = ke.megastep_tables_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("has_cs", [False, True])
def test_megastep_launch_equals_event_launches(cuda, has_cs):
    chunk = 8
    (finish, phase, client, seq, disp, mu_c, mu_u, fscal, iscal) = [
        torch.as_tensor(a, device=cuda)
        for a in _mega_tables(3, 32, 132, 100, has_cs, chunk,
                              "deterministic")]
    iscal[:, 2] = chunk
    got = ke.megastep_tables(finish, phase, client, seq, disp, mu_c, mu_u,
                             fscal, iscal, has_cs=has_cs, chunk=chunk)
    tbl = (finish, phase, client, seq, disp)
    seq_ctr, rnd = iscal[:, 0], iscal[:, 1]
    for i in range(chunk):
        one = torch.stack([iscal[:, 3 + i], seq_ctr, rnd], dim=-1)
        *tbl, t, d = ke.event_step_tables(*tbl, mu_c, mu_u,
                                          fscal[:, 4 * i:4 * i + 4], one,
                                          has_cs=has_cs)
        seq_ctr, rnd = d[:, 4], d[:, 5]
        assert torch.equal(got[5][:, i], t[:, 0])
        assert torch.equal(got[6][:, 10 * i:10 * i + 9], d)
    for g, w in zip(got[:5], tbl):
        assert torch.equal(g, w)


def test_lane_backends_bitwise_on_the_card(cuda):
    rng = np.random.default_rng(3)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    prms = [NetworkParams(p=t(rng.dirichlet(np.ones(20))),
                          mu_c=t(rng.uniform(0.5, 4.0, 20)),
                          mu_d=t(rng.uniform(0.5, 4.0, 20)),
                          mu_u=t(rng.uniform(0.5, 4.0, 20))).with_cs(3.0)
            for _ in range(4)]
    kw = dict(warmup=50, seeds=range(4), distribution="deterministic")
    got = simulate_stats_lanes(prms, [8, 9, 10, 11], 300, backend="kernel",
                               **kw)
    want = simulate_stats_lanes(prms, [8, 9, 10, 11], 300, backend="batched",
                                **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for chunk in (8, 32):
        mega = simulate_stats_lanes(prms, [8, 9, 10, 11], 300,
                                    backend="kernel", chunk=chunk, **kw)
        for g, w in zip(mega, want):
            assert torch.equal(g, w)


def _lane_inputs(seed, K, n, m_max, with_cs, power, law, device,
                 warmup=4, cap=30):
    """``K`` lanes of ``n`` clients on ``device``: lane-stacked network
    rates, a power profile (``power`` None, ``"no_pcs"`` or ``"pcs"``),
    initial states of 3 to ``m_max`` tasks and a function of ``(rng,
    events)`` giving ``fs [K, events, W]`` and ``c_new [K, events]``
    (numpy draws in the law's rate form: the deterministic law's unit
    parts are 1, the lognormal's are normals, the hyperexponential's
    carry their branch factors)."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    prms, pws, states = [], [], []
    for k in range(K):
        prm = NetworkParams(p=t(rng.dirichlet(np.ones(n))),
                            mu_c=t(rng.uniform(0.5, 4.0, n)),
                            mu_d=t(rng.uniform(0.5, 4.0, n)),
                            mu_u=t(rng.uniform(0.5, 4.0, n)))
        prms.append(prm.with_cs(3.0) if with_cs else prm)
        pws.append(PowerProfile(*[t(rng.uniform(1.0, 3.0, n))
                                  for _ in range(3)],
                                P_cs=t(np.float64(2.5)) if power == "pcs"
                                else None))
        key = prng.PRNGKey(seed + k, device=device)
        states.append(E.init_state(prms[-1], 3 + k % (m_max - 2), key,
                                   m_max=m_max, distribution=law,
                                   warmup=warmup, cap=cap))
    params = E.stack_lanes(prms)

    def events(rng, N):
        unit = ((lambda: np.ones((K, N))) if law == "deterministic"
                else (lambda: rng.exponential(size=(K, N))))
        x = ((lambda: rng.normal(size=(K, N))) if law == "lognormal"
             else unit)
        cols = [x(), x(), unit() / 2.0,
                unit() / 3.0 if with_cs else np.zeros((K, N))]
        if law == "hyperexponential":
            cols += [rng.choice([H2_FAST, H2_SLOW], (K, N)) for _ in "uc"]
        return (t(np.stack(cols, -1)),
                t(rng.integers(0, n, (K, N))).to(torch.int32))

    return (params, None if power is None else E.stack_lanes(pws),
            E.stack_lanes(states), events)


def _same_lanes(got, want, what):
    for name, g, w in zip(E.EventState._fields, got[0], want[0]):
        assert torch.equal(g, w), (what, name)
    assert torch.equal(got[1], want[1]), (what, "t")
    assert torch.equal(got[2], want[2]), (what, "desc")


_LANE_CASES = [("exponential", False, None), ("exponential", True, "pcs"),
               ("deterministic", True, "no_pcs"),
               ("deterministic", False, "pcs")]


# clients per lane by storage: at n = 3,000 a lane's rows take about 250 KB
# (320 KB with power), past the 227 KB a block may stage, so the kernel works
# on them in place in global memory
_LANE_N = {"shared": 20, "global": 3000}


@pytest.mark.parametrize("storage", ["shared", "global"])
@pytest.mark.parametrize("law,has_cs,power", _LANE_CASES)
def test_event_lanes_kernel_matches_plain_bitwise(cuda, law, has_cs, power,
                                                  storage):
    params, pw, st, events = _lane_inputs(1, 8, _LANE_N[storage], 24,
                                          has_cs, power, law, cuda, cap=20)
    rng = np.random.default_rng(2)
    fs, cn = events(rng, 160)
    want_st = st
    before = ke.event_step_lanes.launches
    for i in range(160):
        keep = (None if i % 4 == 0 else
                torch.as_tensor(rng.random(8) < 0.8, device=cuda))
        got = ke.event_step_lanes(params, st, fs[:, i], cn[:, i], power=pw,
                                  keep=keep, donate=i > 0)
        want = E.event_step_lanes_plain(params, want_st, fs[:, i],
                                        cn[:, i], power=pw, keep=keep)
        torch.cuda.synchronize()
        _same_lanes(got, want, f"event {i}")
        st, want_st = got[0], want[0]
    assert ke.event_step_lanes.launches == before + 160
    assert int(st.round.min()) > 20  # the window closed inside the run
    if power is not None:  # the energy integral on DFMA == the emulation
        assert bool((st.energy > 0).all())


@pytest.mark.parametrize("storage", ["shared", "global"])
@pytest.mark.parametrize("law,has_cs,power", _LANE_CASES)
@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("stop", [False, True])
def test_megastep_lanes_kernel_matches_plain_bitwise(cuda, stop, chunk, law,
                                                     has_cs, power, storage):
    params, pw, st, events = _lane_inputs(chunk, 8, _LANE_N[storage], 24,
                                          has_cs, power, law, cuda, cap=12)
    rng = np.random.default_rng(chunk + 2)
    want_st = st
    before = ke.megastep_lanes.launches
    steps = max(4, 160 // chunk)
    for s in range(steps):
        fs, cn = events(rng, chunk)
        rem = rng.integers(0, chunk + 1, 8)
        rem[0], rem[1] = chunk, chunk + 5  # full lanes
        rem_arg = (rem.tolist() if s % 2 else
                   torch.as_tensor(rem, dtype=torch.int32, device=cuda))
        got = ke.megastep_lanes(params, st, fs, cn, rem_arg, power=pw,
                                stop_on_update=stop, donate=s > 0)
        want = E.megastep_lanes_plain(params, want_st, fs, cn, rem_arg,
                                      power=pw, stop_on_update=stop)
        torch.cuda.synchronize()
        _same_lanes(got, want, f"megastep {s}")
        st, want_st = got[0], want[0]
    assert ke.megastep_lanes.launches == before + steps
    assert int(st.round.max()) > (2 if stop else 12)  # past the window


_LAW_CASES = [("hyperexponential", False, None),
              ("hyperexponential", True, "pcs"),
              ("lognormal", True, "no_pcs"), ("lognormal", False, "pcs")]


@pytest.mark.parametrize("storage", ["shared", "global"])
@pytest.mark.parametrize("law,has_cs,power", _LAW_CASES)
@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_law_lanes_kernel_matches_plain_bitwise(cuda, chunk, law, has_cs,
                                                power, storage):
    # the H2 and lognormal instantiations: one event with keep masks, or
    # megasteps with per-lane rem, stop_on_update on every other step
    params, pw, st, events = _lane_inputs(chunk + 40, 8, _LANE_N[storage],
                                          24, has_cs, power, law, cuda,
                                          cap=12)
    rng = np.random.default_rng(chunk + 41)
    want_st = st
    steps = 120 if chunk == 1 else max(4, 240 // chunk)
    for s in range(steps):
        fs, cn = events(rng, chunk)
        if chunk == 1:
            keep = (None if s % 4 == 0 else
                    torch.as_tensor(rng.random(8) < 0.8, device=cuda))
            got = ke.event_step_lanes(params, st, fs[:, 0], cn[:, 0],
                                      power=pw, keep=keep, donate=s > 0,
                                      law=law)
            want = E.event_step_lanes_plain(params, want_st, fs[:, 0],
                                            cn[:, 0], power=pw, keep=keep,
                                            law=law)
        else:
            rem = rng.integers(0, chunk + 1, 8)
            rem[0] = chunk
            got = ke.megastep_lanes(params, st, fs, cn, rem.tolist(),
                                    power=pw, stop_on_update=s % 2 == 1,
                                    donate=s > 0, law=law)
            want = E.megastep_lanes_plain(params, want_st, fs, cn,
                                          rem.tolist(), power=pw,
                                          stop_on_update=s % 2 == 1,
                                          law=law)
        torch.cuda.synchronize()
        _same_lanes(got, want, f"{law} step {s}")
        st, want_st = got[0], want[0]
    assert int(st.round.max()) > 12  # past the window


def test_lognormal_lane_kernel_exp_log_bits_over_a_wide_range(cuda):
    # every uplink and computation service of 512 lanes over 32 events,
    # normals of scale 4 and rates from 1e-3 to 1e3: the kernel's exp and
    # log give the bits of PyTorch's on the card
    K, n = 512, 16
    params, _, st, events = _lane_inputs(77, K, n, 40, False, None,
                                         "lognormal", cuda)
    rng = np.random.default_rng(78)
    params = params._replace(**{k: torch.as_tensor(
        10.0 ** rng.uniform(-3, 3, (K, n)), device=cuda)
        for k in ("mu_c", "mu_u")})
    for _ in range(4):
        fs, cn = events(rng, 32)
        fs[..., :2] *= 4.0
        got = ke.megastep_lanes(params, st, fs, cn, 32, law="lognormal")
        want = E.megastep_lanes_plain(params, st, fs, cn, 32,
                                      law="lognormal")
        torch.cuda.synchronize()
        _same_lanes(got, want, "lognormal wide range")
        st = got[0]


@pytest.mark.parametrize("law", ["hyperexponential", "lognormal"])
def test_law_lane_backends_and_next_update_on_the_card(cuda, law):
    rng = np.random.default_rng(13)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    prms = [NetworkParams(p=t(rng.dirichlet(np.ones(20))),
                          mu_c=t(rng.uniform(0.5, 4.0, 20)),
                          mu_d=t(rng.uniform(0.5, 4.0, 20)),
                          mu_u=t(rng.uniform(0.5, 4.0, 20)))
            for _ in range(4)]
    prms[1] = prms[1].with_cs(3.0)  # a CS lane alone, the rest without
    for lanes in ([prms[0], prms[2], prms[3]], [prms[1]]):
        kw = dict(warmup=50, seeds=range(len(lanes)), distribution=law)
        ms = [8, 9, 10][:len(lanes)]
        want = simulate_stats_lanes(lanes, ms, 300, backend="batched", **kw)
        for chunk in (1, 8, 32):
            got = simulate_stats_lanes(lanes, ms, 300, backend="kernel",
                                       chunk=chunk, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (law, chunk)
    params = E.stack_lanes([prms[0], prms[2], prms[3]])
    outs = {}
    for be, chunk in (("batched", 1), ("kernel", 1), ("kernel", 8)):
        keys = prng.seed_keys(range(30, 33), device=cuda)
        st = E.stack_lanes([E.init_state(E.lane(params, i), 9, k, m_max=9,
                                         distribution=law)
                            for i, k in enumerate(keys)])
        stream = E.EventStream([E.lane(params, i) for i in range(3)],
                               E.event_key(keys), distribution=law)
        ups = []
        for _ in range(40):
            st, up = E.next_update(params, st, stream, backend=be,
                                   chunk=chunk)
            ups.append(up)
        outs[(be, chunk)] = (st, ups)
    for key in (("kernel", 1), ("kernel", 8)):
        for a, b in zip(outs[key][0], outs[("batched", 1)][0]):
            assert torch.equal(a, b), key
        for u, v in zip(outs[key][1], outs[("batched", 1)][1]):
            assert all(torch.equal(a, b) for a, b in zip(u, v)), key


@pytest.mark.parametrize("power", [None, "pcs"])
def test_lane_kernels_at_large_n_work_in_global_memory(cuda, power):
    # n = 3,000: a lane's rows take about 250 KB (320 KB with power), past
    # the 227 KB a block may stage, so the kernel works in place
    params, pw, st, events = _lane_inputs(5, 3, 3000, 40, True, power,
                                          "exponential", cuda)
    rng = np.random.default_rng(6)
    want_st = st
    for s in range(3):
        fs, cn = events(rng, 9)
        got = ke.megastep_lanes(params, st, fs, cn, [9, 4, 9], power=pw)
        want = E.megastep_lanes_plain(params, want_st, fs, cn, [9, 4, 9],
                                      power=pw)
        torch.cuda.synchronize()
        _same_lanes(got, want, f"megastep {s}")
        st, want_st = got[0], want[0]
        got = ke.event_step_lanes(params, st, fs[:, 0], cn[:, 0], power=pw)
        want = E.event_step_lanes_plain(params, want_st, fs[:, 0],
                                        cn[:, 0], power=pw)
        torch.cuda.synchronize()
        _same_lanes(got, want, f"event {s}")
        st, want_st = got[0], want[0]


def test_lane_kernels_sub_batch_keeps_its_bits(cuda):
    params, pw, st, events = _lane_inputs(7, 8, 100, 132, False, "no_pcs",
                                          "exponential", cuda)
    fs, cn = events(np.random.default_rng(8), 8)
    full = ke.megastep_lanes(params, st, fs, cn, 8, power=pw)
    one = ke.event_step_lanes(params, st, fs[:, 0], cn[:, 0], power=pw)
    rows = slice(2, 5)
    sub = lambda tree: type(tree)(  # noqa: E731
        *[None if x is None else x[rows].contiguous() for x in tree])
    part = ke.megastep_lanes(sub(params), sub(st), fs[rows], cn[rows], 8,
                             power=sub(pw))
    part_one = ke.event_step_lanes(sub(params), sub(st), fs[rows, 0],
                                   cn[rows, 0], power=sub(pw))
    torch.cuda.synchronize()
    for a, b in ((full, part), (one, part_one)):
        for name, x, y in zip(E.EventState._fields, a[0], b[0]):
            assert torch.equal(x[rows], y), name
        assert torch.equal(a[1][rows], b[1]) and torch.equal(a[2][rows], b[2])


def test_lane_kernels_donated_buffers_and_untouched_callers(cuda):
    params, pw, st, events = _lane_inputs(9, 4, 12, 16, True, "pcs",
                                          "exponential", cuda)
    fs, cn = events(np.random.default_rng(10), 7)
    kept = [x.clone() for x in st]
    fresh = ke.megastep_lanes(params, st, fs, cn, 7, power=pw)
    for x, y in zip(st, kept):  # without donate the input is only read
        assert torch.equal(x, y)
    mine = E.EventState(*[x.clone() for x in st])
    ptrs = [x.data_ptr() for x in mine]
    donated = ke.megastep_lanes(params, mine, fs, cn, 7, power=pw,
                                donate=True)
    torch.cuda.synchronize()
    for name, x, y, p in zip(E.EventState._fields, donated[0], fresh[0],
                             ptrs):
        assert torch.equal(x, y), name
        assert x.data_ptr() == p, name  # written into the donated buffer
    stream = E.EventStream([E.lane(params, i) for i in range(4)],
                           E.event_key(prng.seed_keys(range(4),
                                                      device=cuda)))
    for chunk in (1, 8):
        out = E.run_events(params, st, stream, 50, chunk=chunk, power=pw,
                           backend="kernel")
        out_kept = [x.clone() for x in out]
        E.next_update(params, out, stream, power=pw, backend="kernel",
                      chunk=chunk)
        torch.cuda.synchronize()
        for x, y in zip(st, kept):
            assert torch.equal(x, y)
        for x, y in zip(out, out_kept):
            assert torch.equal(x, y)


@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_kernel_route_launches_once_per_chunk(cuda, chunk):
    prms = [NetworkParams(*[torch.as_tensor(x, device=cuda) for x in (
        np.full(10, 0.1), np.linspace(1.0, 3.0, 10),
        np.linspace(2.0, 4.0, 10), np.linspace(1.5, 2.5, 10))])] * 3
    counters = (ke.event_step_lanes, ke.megastep_lanes, ke.event_step_tables,
                ke.megastep_tables)
    before = [c.launches for c in counters]
    updates, warmup, m = 100, 20, 6
    got = simulate_stats_lanes(prms, [m] * 3, updates, warmup=warmup,
                               backend="kernel", chunk=chunk)
    want = simulate_stats_lanes(prms, [m] * 3, updates, warmup=warmup,
                                backend="batched", chunk=chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    events = 3 * (updates + warmup) + 3 * m + 8  # run_lanes' event count
    launched = [c.launches - b for c, b in zip(counters, before)]
    lane_launches = -(-events // chunk)
    assert launched == ([lane_launches, 0, 0, 0] if chunk == 1
                        else [0, lane_launches, 0, 0])


# the rate forms (scale, H2, lognormal), with and without power
_RING_CASES = [("exponential", False, None), ("exponential", True, "pcs"),
               ("hyperexponential", True, "no_pcs"),
               ("lognormal", False, "pcs")]


@pytest.mark.parametrize("storage", ["shared", "global"])
@pytest.mark.parametrize("law,has_cs,power", _RING_CASES)
@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_lane_kernel_event_ring_matches_plain_bitwise(cuda, chunk, law,
                                                      has_cs, power,
                                                      storage):
    # the ring the kernel writes in its launches == the plain route's
    # appends, bitwise; the states with the ring on == with it off; count
    # == the kept events; a ring of 50 wraps inside the run
    from repro_torch.obs.rings import event_ring_init

    K, cap = 8, 50
    params, pw, st, events = _lane_inputs(chunk + 60, K, _LANE_N[storage],
                                          24, has_cs, power, law, cuda,
                                          cap=12)
    rng = np.random.default_rng(chunk + 61)
    ring_k = event_ring_init(cap, lanes=K, device=cuda)
    ring_p = event_ring_init(cap, lanes=K, device=cuda)
    st_k = st_off = st_p = st
    kept = torch.zeros(K, dtype=torch.int64, device=cuda)
    steps = 120 if chunk == 1 else max(4, 240 // chunk)
    for s in range(steps):
        fs, cn = events(rng, chunk)
        kw = dict(power=pw, law=law)
        if chunk == 1:
            keep = (None if s % 4 == 0 else
                    torch.as_tensor(rng.random(K) < 0.8, device=cuda))
            got = ke.event_step_lanes(params, st_k, fs[:, 0], cn[:, 0],
                                      keep=keep, donate=s > 0, ring=ring_k,
                                      **kw)
            off = ke.event_step_lanes(params, st_off, fs[:, 0], cn[:, 0],
                                      keep=keep, donate=s > 0, **kw)
            want = E.event_step_lanes_plain(params, st_p, fs[:, 0],
                                            cn[:, 0], keep=keep,
                                            ring=ring_p, **kw)
            kept += 1 if keep is None else keep.long()
        else:
            rem = rng.integers(0, chunk + 1, K).tolist()
            rem[0] = chunk
            stop = s % 2 == 1
            got = ke.megastep_lanes(params, st_k, fs, cn, rem,
                                    stop_on_update=stop, donate=s > 0,
                                    ring=ring_k, **kw)
            off = ke.megastep_lanes(params, st_off, fs, cn, rem,
                                    stop_on_update=stop, donate=s > 0, **kw)
            want = E.megastep_lanes_plain(params, st_p, fs, cn, rem,
                                          stop_on_update=stop, ring=ring_p,
                                          **kw)
            kept += got[2].view(K, chunk, 10)[..., 9].sum(dim=1)
        torch.cuda.synchronize()
        _same_lanes(got, want, f"{law} step {s}")
        _same_lanes(off, got, f"{law} step {s}, ring off")
        st_k, st_off, st_p = got[0], off[0], want[0]
    for name, a, b in zip(ring_k._fields, ring_k, ring_p):
        assert torch.equal(a, b), name
    assert ring_k.count.tolist() == kept.tolist()
    assert int(ring_k.count.max()) > cap  # a lane wrapped


@pytest.mark.parametrize("chunk", [1, 8])
def test_traced_kernel_route_equals_batched_and_untraced(cuda, chunk):
    prms = [NetworkParams(*[torch.as_tensor(x, device=cuda) for x in (
        np.full(10, 0.1), np.linspace(1.0, 3.0, 10),
        np.linspace(2.0, 4.0, 10), np.linspace(1.5, 2.5, 10))])] * 3
    updates, warmup, m = 100, 20, 6
    events = 3 * (updates + warmup) + 3 * m + 8  # run_lanes' event count
    counter = ke.event_step_lanes if chunk == 1 else ke.megastep_lanes
    kw = dict(warmup=warmup, chunk=chunk, trace_events=256)
    before = counter.launches
    got, ring = simulate_stats_lanes(prms, [m] * 3, updates,
                                     backend="kernel", **kw)
    assert counter.launches - before == -(-events // chunk)  # no fallback
    want, ring_b = simulate_stats_lanes(prms, [m] * 3, updates,
                                        backend="batched", **kw)
    plain = simulate_stats_lanes(prms, [m] * 3, updates, warmup=warmup,
                                 backend="kernel", chunk=chunk)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, p)
    for name, a, b in zip(ring._fields, ring, ring_b):
        assert torch.equal(a, b), name
    assert ring.count.tolist() == [events] * 3
    with pytest.raises(ValueError, match="ring.time"):
        from repro_torch.obs.rings import event_ring_init

        st = E.stack_lanes([E.init_state(prms[0], m,
                                         prng.PRNGKey(0, device=cuda))] * 3)
        ke.event_step_lanes(E.stack_lanes(prms), st,
                            torch.ones(3, 4, dtype=torch.float64,
                                       device=cuda),
                            torch.zeros(3, dtype=torch.int32, device=cuda),
                            ring=event_ring_init(8, lanes=3, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("N", [1, 4096, 4097, 408767])
def test_fused_update_kernel_matches_plain(cuda, N, L, dtype):
    gen = torch.Generator(device=cuda).manual_seed(N + L)
    w = torch.randn((L, N), generator=gen, device=cuda).to(dtype)
    g = torch.randn((L, N), generator=gen, device=cuda).to(dtype)
    scale = torch.rand(L, generator=gen, device=cuda)
    want, want_sq = kf.fused_async_update_flat_plain(w, g, scale)
    before = kf.fused_async_update_flat.launches
    got, sq = kf.fused_async_update_flat(w, g, scale)
    torch.cuda.synchronize()
    assert kf.fused_async_update_flat.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    torch.testing.assert_close(sq, want_sq, rtol=1e-5, atol=0.0)
    again, sq2 = kf.fused_async_update_flat(w, g, scale)
    assert torch.equal(again, got) and torch.equal(sq2, sq)  # deterministic
    if L == 1:  # the flat form
        flat, flat_sq = kf.fused_async_update_flat(w[0], g[0], scale[0])
        assert torch.equal(flat, got[0]) and torch.equal(flat_sq, sq[0])


def test_trainer_fused_update_bitwise_on_the_card(cuda, monkeypatch):
    from repro_torch.data import iid_partition, make_synthetic_image_dataset
    from repro_torch.fl import AsyncFLConfig, DeviceTrainer, cnn_classifier
    from repro_torch.fl import engine

    ds = make_synthetic_image_dataset(num_classes=5, samples_per_class=20,
                                      image_size=12, seed=1)
    n = 6
    clients = [(ds.x[i], ds.y[i]) for i in iid_partition(ds.y, n, seed=1)]
    rng = np.random.default_rng(2)
    net = NetworkParams(*[torch.as_tensor(rng.uniform(1.0, 4.0, n),
                                          device=cuda) for _ in range(4)])
    net = net._replace(p=net.p / net.p.sum())
    ps = [np.full(n, 1.0 / n), rng.dirichlet(np.ones(n))]
    runs = []
    for fused in (False, True):
        if not fused:  # the apply as plain PyTorch
            monkeypatch.setattr(engine, "fused_async_update_flat",
                                lambda w, g, s: (w - s[:, None] * g, None))
        else:
            monkeypatch.undo()
        cfg = AsyncFLConfig(eta=0.05, batch_size=8, eval_every_time=5.0,
                            eval_batch=32, grad_clip=5.0)
        tr = DeviceTrainer(cnn_classifier(12, 5, channels=(4, 8),
                                          device=cuda),
                           clients, net, cfg, test_data=(ds.x, ds.y),
                           sim_backend="kernel", sim_chunk=8, device=cuda)
        before = kf.fused_async_update_flat.launches
        runs.append(tr.run_lanes(ps, [4, 4], [0.05, 0.05], [0, 1], 20.0))
        torch.cuda.synchronize()
        launched = kf.fused_async_update_flat.launches - before
        assert launched == (0 if not fused else
                            max(lg.updates[-1] for lg in runs[-1][0]) + 1)
    (logs0, fin0), (logs1, fin1) = runs
    assert torch.equal(fin0, fin1)
    for a, b in zip(logs0, logs1):
        assert a.losses == b.losses and a.updates == b.updates
        assert a.throughput == b.throughput and a.energy == b.energy
        assert np.isfinite(a.losses).all() and a.updates[-1] > 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None), (False, 100)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D", [
    (1, 128, 128, 4, 4, 64),     # MHA, tile-aligned
    (2, 100, 100, 8, 2, 64),     # GQA 4:1, ragged
    (1, 33, 257, 4, 1, 128),     # MQA, Sq != Sk, ragged tiles
    (2, 300, 300, 16, 2, 128),   # GQA 8:1, several query tiles
    (1, 2047, 2047, 8, 1, 128),  # MQA, ragged at the main path's length
    (1, 200, 70, 2, 1, 64),      # Sq > Sk: rows with no valid key
    (1, 129, 191, 4, 1, 128),    # ragged against 128-row tiles, TMA's fill
    (2, 255, 255, 8, 2, 64),     # ragged, D = 64
    (1, 64, 2048, 8, 8, 128),    # Sq < Sk
    (1, 512, 512, 48, 1, 128),   # granite-34b's G = 48
    (1, 600, 70, 2, 1, 64),      # windowed query tiles with no key tile
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, D,
                                              causal, window, dtype):
    _flash_kernel_vs_plain(cuda, (B, Sq, Sk, H, KV, D), causal, window,
                           dtype, 1.0)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D", [
    (2, 300, 300, 16, 2, 128), (2, 255, 255, 8, 2, 64),
    (1, 2047, 2047, 8, 1, 128)])
def test_flash_attention_kernel_peaked_softmax(cuda, B, Sq, Sk, H, KV, D,
                                               causal, window):
    """bfloat16 with q and k at 4x unit scale: peaked softmaxes, where p
    rounded to bfloat16 for ``p v`` matters most."""
    _flash_kernel_vs_plain(cuda, (B, Sq, Sk, H, KV, D), causal, window,
                           torch.bfloat16, 4.0)


def _flash_kernel_vs_plain(cuda, shape, causal, window, dtype, scale):
    B, Sq, Sk, H, KV, D = shape
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + H)
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda)
    k = torch.randn((B, Sk, KV, D), generator=gen, device=cuda)
    v = torch.randn((B, Sk, KV, D), generator=gen, device=cuda)
    q, k, v = (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)
    want = kfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    before = kfa.flash_attention.launches
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(q, q, q)
    q = q.contiguous()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kfa.flash_attention(q.half(), q.half(), q.half())
    # contiguous, but 2 bytes past a 16-byte boundary: TMA cannot read it
    n = 1 * 8 * 2 * 64
    q = torch.empty(n + 1, dtype=torch.bfloat16, device=cuda)[1:].view(
        1, 8, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        kfa.flash_attention(q, q, q)


def test_reduced_lm_kernel_route_matches_ref_on_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-8b").reduced()
    ref = build_model(cfg, device=cuda)
    ker = build_model(cfg, attention_impl="kernel", device=cuda)
    params = ref.init(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 150), generator=gen,
                           device=cuda)
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    before = kfa.flash_attention.launches
    logits, cache = ker.prefill(params, batch)
    loss, _ = ker.loss_fn(params, batch)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before + 2 * cfg.n_layers
    want_logits, want_cache = ref.prefill(params, batch)
    want_loss, _ = ref.loss_fn(params, batch)
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(getattr(cache["groups"]["slot0"], name),
                                   getattr(want_cache["groups"]["slot0"],
                                           name), rtol=1e-4, atol=1e-4)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)


def _lengths(form, B, S, gen, dev):
    """The decode lengths of one test form: a Python int or an int32
    tensor [B] on the card."""
    if form == "full":
        return S
    if form == "one":
        return 1
    if form == "zero":
        return 0
    if form == "past":
        return S + 7  # counts as S
    if form == "mid":
        return max(1, (2 * S) // 3 + 1)
    return torch.randint(0, S + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)  # "per-batch"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["full", "one", "zero", "past", "mid",
                                  "per-batch"])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 256, 8, 2, 64),      # tests/test_kernels.py's shapes
    (1, 100, 4, 4, 128),
    (3, 513, 4, 1, 64),      # S not a multiple of the tile
    (16, 320, 32, 8, 128),   # Qwen3-8B at the serve shape
    (2, 300, 48, 1, 128),    # granite-34b's MQA: G = 48
    (2, 130, 96, 1, 64),     # G * D at the kernel's limit
])
def test_decode_attention_kernel_matches_plain(cuda, B, S, H, KV, D, form,
                                               dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + H + D)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device=cuda).to(dtype)
    length = _lengths(form, B, S, gen, cuda)
    want = kda.decode_attention_plain(q, k, v, length)
    before = kda.decode_attention.launches
    got = kda.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert kda.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if form == "zero":
        assert bool((got == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_reads_strided_caches(cuda, dtype):
    """A layer's slice of a stacked cache, cut along S: the kernel reads it
    in place through its batch and row strides."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((3, 1, 16, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((4, 3, 200, 4, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((4, 3, 200, 4, 128), generator=gen, device=cuda).to(dtype)
    kc, vc = k[2, :, :150], v[1, :, 10:160]
    assert not kc.is_contiguous() and not vc.is_contiguous()
    length = torch.tensor([150, 64, 1], dtype=torch.int32, device=cuda)
    got = kda.decode_attention(q, kc, vc, length)
    want = kda.decode_attention_plain(q, kc.contiguous(), vc.contiguous(),
                                      length)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _bf16_decode_inputs(cuda, B, S, H, KV, D, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
               for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
    return gen, q, k, v


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["full", "mid", "per-batch"])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (3, 1000, 4, 4, 128),    # G = 1, ragged S
    (2, 777, 32, 8, 128),    # Qwen3-8B's G = 4
    (2, 500, 48, 1, 128),    # granite-34b's MQA: three m-tiles
    (3, 450, 8, 2, 64),      # D = 64
    (2, 260, 96, 1, 64),     # G = 96 at D = 64: six m-tiles
])
def test_decode_attention_bf16_split_matches_plain(cuda, B, S, H, KV, D,
                                                   form, parts):
    """The bf16 kernel with its cache cut into 1 to 4 parts (the plan
    forced) against the plain version; with a scalar length below S the
    last parts lie wholly past it; the combine runs once per split call."""
    gen, q, k, v = _bf16_decode_inputs(cuda, B, S, H, KV, D, S + H + parts)
    length = _lengths(form, B, S, gen, cuda)
    tiles = -(-S // kda.BLOCK_S)
    per = -(-tiles // parts)
    n = -(-tiles // per)
    launches = kda.decode_attention.launches
    combines = kda.decode_attention.combine_launches
    got = kda._launch(q, k, v, length, plan=(n, per))
    torch.cuda.synchronize()
    assert kda.decode_attention.launches == launches + 1
    assert kda.decode_attention.combine_launches == combines + (n > 1)
    want = kda.decode_attention_plain(q, k, v, length)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (3, 300, 32, 8, 128),
    (2, 200, 48, 1, 128),
    (3, 130, 8, 2, 64),
])
def test_decode_attention_bf16_ignores_a_poisoned_tail(cuda, B, S, H, KV, D,
                                                       parts):
    """Cache rows at and past each length hold NaN (as a buffer never
    written may): the output equals, bitwise, the one from the clean cache
    (TMA loads the last tile's rows past the length; they are masked by a
    select and their values zeroed), and it is finite; in one part and in
    three (the last of which may lie wholly past S)."""
    gen, q, k, v = _bf16_decode_inputs(cuda, B, S, H, KV, D, 11 * S + H)
    lengths = torch.tensor([S // 2 + 3, 1, S - 5][:B], dtype=torch.int32,
                           device=cuda)
    past = (torch.arange(S, device=cuda)[None, :]
            >= lengths[:, None])[:, :, None, None]
    k_bad = torch.where(past, float("nan"), k)
    v_bad = torch.where(past, float("nan"), v)
    force = (parts, -(-S // (parts * kda.BLOCK_S)))
    got = kda._launch(q, k_bad, v_bad, lengths, plan=force)
    clean = kda._launch(q, k, v, lengths, plan=force)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    torch.testing.assert_close(
        got.float(), kda.decode_attention_plain(q, k, v, lengths).float(),
        rtol=2e-2, atol=2e-2)


def test_decode_attention_bf16_splits_only_when_sms_are_idle(cuda):
    """The plan on the card: B = 2 x 8 KV heads over 2,048 entries (16
    CTAs) splits and launches the combine once; the serve shape (B = 16,
    128 CTAs, about one an SM) runs in one part."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, S, splits in ((2, 2048, True), (16, 320, False)):
        gen, q, k, v = _bf16_decode_inputs(cuda, B, S, 32, 8, 128, B)
        combines = kda.decode_attention.combine_launches
        got = kda.decode_attention(q, k, v, S)
        torch.cuda.synchronize()
        assert kda.decode_attention.combine_launches == combines + splits
        assert (kda.split_plan(B, 8, S, S, sms)[0] > 1) == splits
        torch.testing.assert_close(
            got.float(), kda.decode_attention_plain(q, k, v, S).float(),
            rtol=2e-2, atol=2e-2)


def test_decode_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 1, 4, 32), device=cuda)
    k = torch.zeros((2, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kda.decode_attention(q, k, k, 4)
    q = torch.zeros((2, 1, 64, 128), device=cuda)
    k = torch.zeros((2, 8, 1, 128), device=cuda)
    with pytest.raises(ValueError, match="6144"):
        kda.decode_attention(q, k, k, 4)
    q = torch.zeros((2, 1, 4, 64), device=cuda)
    k = torch.zeros((2, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kda.decode_attention(q.half(), k.half(), k.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kda.decode_attention(torch.zeros((2, 1, 4, 128), device=cuda)
                             [..., :64], k, k, 4)
    with pytest.raises(ValueError, match="dense"):
        kda.decode_attention(q, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), k, 4)
    with pytest.raises(ValueError, match="aligned"):
        kda.decode_attention(q, torch.zeros(2 * 8 * 2 * 64 + 1, device=cuda)
                             [1:].view(2, 8, 2, 64), k, 4)
    with pytest.raises(ValueError, match="length"):
        kda.decode_attention(q, k, k, torch.tensor([4, 4], dtype=torch.int32))


def _reduced_decode(cuda, impl, cfg, tokens, **kw):
    from repro_torch.models import build_model

    bundle = build_model(cfg, attention_impl=impl, device=cuda, **kw)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    B, T = tokens.shape
    cache = bundle.init_cache(B, T + 2)
    logits = []
    for t in range(T):
        lg, cache = bundle.decode_step(params, cache, tokens[:, t:t + 1], t)
        logits.append(lg[:, 0])
    torch.cuda.synchronize()
    return params, torch.stack(logits, dim=1), cache


def test_reduced_lm_decode_kernel_route_matches_ref_on_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("qwen3-8b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 70), generator=gen, device=cuda)
    before = kda.decode_attention.launches
    params, got, cache = _reduced_decode(cuda, "kernel", cfg, tokens)
    assert kda.decode_attention.launches == before + 70 * cfg.n_layers
    _, want, want_cache = _reduced_decode(cuda, "ref", cfg, tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(getattr(cache["groups"]["slot0"], name),
                                   getattr(want_cache["groups"]["slot0"],
                                           name), rtol=1e-4, atol=1e-4)
    full = lm.lm_forward(params, cfg, tokens).logits
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)


def test_ring_buffer_decode_on_the_card(cuda):
    """``window_override=16`` over 70 steps: the ring of 16 entries wraps
    four times; decode on the kernel route equals the forward restricted
    to the window."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("internlm2-1.8b").reduced(sliding_window=None)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 70), generator=gen, device=cuda)
    params, got, cache = _reduced_decode(cuda, "kernel", cfg, tokens,
                                         window_override=16)
    assert cache["groups"]["slot0"].k.shape[2] == 16
    full = lm.lm_forward(params, cfg, tokens, window=16).logits
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)


def test_serve_tiny_preset_on_the_card(cuda, capsys):
    """``python -m repro_torch.launch.serve`` (tiny preset) on the card:
    kernel 7 on every step and layer; the greedy tokens teacher-forced
    through the ``ref`` route give the same logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    before = kda.decode_attention.launches
    gen = serve.main(["--arch", "qwen3-8b", "--batch", "3", "--prompt-len",
                      "12", "--new-tokens", "6"])
    assert capsys.readouterr().out.startswith("[serve] qwen3-8b: batch=3")
    cfg = get_config("qwen3-8b").reduced(vocab=512, n_layers=2)
    assert kda.decode_attention.launches == before + (12 + 6 - 1) * 2
    assert gen.tokens.shape == (3, 6) and gen.tokens.is_cuda
    assert bool(torch.isfinite(gen.prompt_logits).all())
    bundle = build_model(cfg, device=cuda)
    params = bundle.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 12)), device=cuda)
    ref = serve.generate(bundle, params, prompts, 6, forced=gen.tokens,
                         keep_logits=True)
    torch.testing.assert_close(ref.prompt_logits, gen.prompt_logits,
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(ref.step_logits[:, 11:].argmax(-1), gen.tokens)


# ---------------------------------------------------------------------------
# the Scenario API on the card: resolution and from_scenario
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_buzen():
    from repro_torch.core import buzen

    saved = buzen.get_backend()
    buzen.set_backend("kernel")
    yield
    buzen.set_backend(saved)


def test_resolve_strategy_on_the_card_is_the_direct_sweep(cuda,
                                                         kernel_buzen):
    from repro_torch.scenario import Scenario, StrategySpec, resolve_strategy

    consts = LearningSpec().consts
    net = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10)
    scn = Scenario(network=net, strategy=StrategySpec("time_opt", m_max=17,
                                                      steps=40))
    p, m = resolve_strategy(scn)
    want = time_optimal(net.params(device=cuda), consts, m_max=17, steps=40,
                        backend="kernel")
    assert m == want.m
    assert np.array_equal(p, want.p.cpu().numpy())
    cls = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, aggregate=True)
    scn = Scenario(network=cls, strategy=StrategySpec("time_opt", m_max=40,
                                                      steps=40))
    p, m = resolve_strategy(scn)
    want = time_optimal_classes(cls.class_params(device=cuda), consts, 40,
                                steps=40, backend="kernel")
    assert m == want.m
    assert np.array_equal(p, want.p.cpu().numpy())


def test_device_trainer_from_scenario_on_the_card_is_hand_built(cuda):
    from repro_torch.data import iid_partition, make_synthetic_image_dataset
    from repro_torch.fl import AsyncFLConfig, DeviceTrainer, mlp_classifier
    from repro_torch.scenario import (EnergySpec, Scenario, SimSpec,
                                      resolve_strategy)

    full = make_synthetic_image_dataset(num_classes=4, samples_per_class=16,
                                        image_size=8, seed=0)
    clients = [(full.x[i], full.y[i]) for i in iid_partition(full.y, 9)]
    test = (full.x[::3], full.y[::3])
    scn = Scenario(network=NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1,
                                                     10),
                   energy=EnergySpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10),
                   learning=LearningSpec(grad_clip=5.0),
                   sim=SimSpec(backend="kernel", chunk=8))
    over = dict(batch_size=8, eval_every_time=50.0)
    tr = DeviceTrainer.from_scenario(
        scn, mlp_classifier(64, 4, hidden=(16,), device=cuda), clients,
        test_data=test, **over)
    hand = DeviceTrainer(
        mlp_classifier(64, 4, hidden=(16,), device=cuda), clients,
        scn.params(device=cuda), AsyncFLConfig(eta=0.05, grad_clip=5.0,
                                               **over),
        test_data=test, power=scn.power(device=cuda), sim_backend="kernel",
        sim_chunk=8, device=cuda)
    p, m = resolve_strategy(scn)
    args = ([p, p], [m, m], [0.05, 0.05], [0, 1], 400.0)
    ke.megastep_lanes.launches = 0
    logs_a, fin_a = tr.run_lanes(*args)
    assert ke.megastep_lanes.launches > 0
    logs_b, fin_b = hand.run_lanes(*args)
    assert torch.equal(fin_a, fin_b)
    for a, b in zip(logs_a, logs_b):
        assert a.updates[-1] > 10
        assert (a.times, a.losses, a.updates, a.energy) == (
            b.times, b.losses, b.updates, b.energy)


# ---------------------------------------------------------------------------
# ScenarioSuite on the card: lane-stacked Buzen routes, simulate backends
# ---------------------------------------------------------------------------

def _lane_nets(dev, sizes, mu_cs=None):
    from repro_torch.core.buzen import pad_network

    rng = np.random.default_rng(sum(sizes))
    nets = []
    for n in sizes:
        t = [torch.as_tensor(x, dtype=torch.float64, device=dev)
             for x in (rng.dirichlet(np.ones(n)), rng.uniform(0.5, 3, n),
                       rng.uniform(0.5, 3, n), rng.uniform(0.5, 3, n))]
        net = NetworkParams(*t)
        nets.append(net if mu_cs is None else net.with_cs(mu_cs))
    n_max = max(sizes)
    return nets, E.stack_lanes([pad_network(x, n_max) for x in nets])


@pytest.mark.parametrize("mu_cs", [None, 2.5])
def test_kernel_route_lane_stacked_networks_bitwise_alone(cuda, mu_cs):
    from repro_torch.core.buzen import log_normalizing_constants

    nets, lanes = _lane_nets(cuda, (5, 9, 12), mu_cs)
    kb.buzen_batched.launches = 0
    got = log_normalizing_constants(lanes, 20, backend="kernel")
    assert kb.buzen_batched.launches == 1
    for i, net in enumerate(nets):
        want = log_normalizing_constants(net, 20, backend="kernel")
        assert torch.equal(got[i], want), i
    # a shared network with a batch of routing rows is what it was: the
    # wrapper's rows, one by one, through the same kernel
    net = nets[1]
    rows = torch.stack([net.p, net.p.flip(0)])
    shared = log_normalizing_constants(net._replace(p=rows), 20,
                                       backend="kernel")
    from repro_torch.core.numerics import seqsum

    log_rho = torch.log(rows) - torch.log(net.mu_c)[None, :]
    gamma = rows * (1.0 / net.mu_d + 1.0 / net.mu_u)[None, :]
    if mu_cs is not None:
        log_rho = torch.cat([log_rho, (torch.log(seqsum(rows, dim=-1))
                                       - torch.log(net.mu_cs))[:, None]], -1)
    assert torch.equal(shared, kb.buzen_log_Z_batched(
        log_rho, torch.log(seqsum(gamma, dim=-1)), 20))


def test_kernel_route_lane_stacked_classes_bitwise_alone(cuda):
    from repro_torch.core.buzen import (ClassParams,
                                        class_log_normalizing_constants)

    rng = np.random.default_rng(3)
    sets = []
    for counts in ([3, 4, 0], [1, 5, 2], [7, 0, 0]):
        t = [torch.as_tensor(x, dtype=torch.float64, device=cuda)
             for x in (rng.uniform(0.01, 0.1, 3), rng.uniform(0.5, 3, 3),
                       rng.uniform(0.5, 3, 3), rng.uniform(0.5, 3, 3))]
        sets.append(ClassParams(*t, count=torch.as_tensor(
            counts, dtype=torch.int64, device=cuda)))
    lanes = E.stack_lanes(sets)
    kb.buzen_classes_batched.launches = 0
    got = class_log_normalizing_constants(lanes, 24, backend="kernel")
    assert kb.buzen_classes_batched.launches == 1
    for i, cp in enumerate(sets):
        assert torch.equal(got[i], class_log_normalizing_constants(
            cp, 24, backend="kernel")), i


def test_suite_simulate_kernel_equals_batched(cuda):
    from repro_torch.scenario import (EnergySpec, Scenario, ScenarioSuite,
                                      SimSpec, StrategySpec)

    rng = np.random.default_rng(8)
    scns = {}
    for n, m in ((4, 3), (7, 5), (9, 4)):
        scns[f"n{n}"] = Scenario(
            network=NetworkSpec(mu_c=rng.uniform(0.5, 3, n),
                                mu_d=rng.uniform(0.5, 3, n),
                                mu_u=rng.uniform(0.5, 3, n)),
            strategy=StrategySpec("explicit", p=rng.dirichlet(np.ones(n)),
                                  m=m), sim=SimSpec(chunk=8))
    scns["power"] = Scenario(
        network=NetworkSpec(mu_c=rng.uniform(0.5, 3, 5),
                            mu_d=rng.uniform(0.5, 3, 5),
                            mu_u=rng.uniform(0.5, 3, 5), mu_cs=2.0),
        energy=EnergySpec(kappa=rng.uniform(0.1, 2, 5),
                          P_u=rng.uniform(0.5, 3, 5),
                          P_d=rng.uniform(0.5, 3, 5), P_cs=0.5),
        strategy=StrategySpec("asyncsgd"), sim=SimSpec(chunk=8))
    out = {}
    for be in ("batched", "kernel"):
        suite = ScenarioSuite(scns, seeds=(0, 1))
        ke.megastep_lanes.launches = 0
        out[be] = suite.run(mode="simulate", num_updates=300, warmup=50,
                            backend=be)
        assert out[be].programs == 2
        assert (ke.megastep_lanes.launches > 0) == (be == "kernel")
    for name in scns:
        for a, b in zip(out["batched"].entries[name],
                        out["kernel"].entries[name]):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)


# jax.random's answers on jax 0.9.0 (x64, threefry partitionable) for
# these seeds: split(k, 6), the key after 1,024 steps of the chain
# split(k, 6)[0], fold_in(k, 1) and fold_in(k, 2), randint(k, (3,), 0,
# 1000003) and the float64 bits of uniform(k, (2,))
JAX_ANSWERS = {
    0: dict(
        split6=[1797259609, 2579123966, 928981903, 3453687069, 4146024105,
            2718843009, 2467461003, 3840466878, 2285895361, 433833334,
            1524306142, 1887795613],
        chain1024=[2708596157, 547718659],
        fold12=[928981903, 3453687069, 4146024105, 2718843009],
        randint=[333962, 466642, 300875],
        uniform_bits=[4601209873087491728, 4596960885320641928],
    ),
    1: dict(
        split6=[507451445, 1853169794, 1948878966, 4237131848, 2441914641,
            3819641963, 3568232559, 2761185182, 869452973, 3597360905,
            3243370355, 1313272271],
        chain1024=[3242012521, 2967396320],
        fold12=[1948878966, 4237131848, 2441914641, 3819641963],
        randint=[295633, 633437, 147554],
        uniform_bits=[4593178043172680992, 4601845810764653408],
    ),
    42: dict(
        split6=[1832780943, 270669613, 64467757, 2916123636, 2465931498,
            255383827, 3134548294, 894150801, 2954079971, 3276725750,
            2765691542, 824333390],
        chain1024=[1462872883, 2291380616],
        fold12=[64467757, 2916123636, 2465931498, 255383827],
        randint=[887067, 284202, 871285],
        uniform_bits=[4601358860358518916, 4579806337745978368],
    ),
    4294967303: dict(
        split6=[3751178690, 325998405, 1741727090, 2326748124, 1591882673,
            3522270390, 2836227758, 3199787836, 3575481439, 1729507223,
            2152786599, 114884099],
        chain1024=[642391304, 1820099952],
        fold12=[1741727090, 2326748124, 1591882673, 3522270390],
        randint=[176036, 269114, 483935],
        uniform_bits=[4606042011437526474, 4600976952820673492],
    ),
}


def test_prng_known_answers_on_the_card(cuda):
    for seed, want in JAX_ANSWERS.items():
        key = prng.PRNGKey(seed, device=cuda)
        assert prng.split(key, 6).reshape(-1).tolist() == want["split6"]
        chain, _ = ktf.chain_words(key[None], 1024,
                                   ktf.paths_tensor([(1, 0)], cuda))
        assert chain[0, -1].tolist() == want["chain1024"]
        folds = torch.stack([prng.fold_in(key, 1), prng.fold_in(key, 2)])
        assert folds.reshape(-1).tolist() == want["fold12"]
        assert prng.randint(key, (3,), 0, 1000003).tolist() == want["randint"]
        u = prng.uniform(key, (2,))
        assert u.view(torch.int64).tolist() == want["uniform_bits"]


def _chain_vs_plain(cuda, keys, n, paths):
    pt = ktf.paths_tensor(paths, cuda)
    before = ktf.chain_words.launches
    chain, words = ktf.chain_words(keys, n, pt)
    torch.cuda.synchronize()
    assert ktf.chain_words.launches == before + 1
    want_c, want_w = ktf.chain_words_plain(keys.cpu(), n, pt.cpu())
    assert torch.equal(chain.cpu(), want_c)
    assert torch.equal(words.cpu(), want_w)


@pytest.mark.parametrize("lanes,n", [(1, 1), (7, 257), (64, 1024)])
@pytest.mark.parametrize("engine", ["client", "class"])
@pytest.mark.parametrize("law", ["exponential", "deterministic",
                                 "lognormal", "hyperexponential"])
def test_threefry_chain_kernel_bitwise_plain(cuda, lanes, n, engine, law):
    """Every word of a block of events, both engines, all four laws, with
    the CS draws: the kernel's chain and words are its plain version's."""
    paths, _ = E.block_paths(law, True, engine == "class")
    keys = E.event_key(prng.seed_keys(range(lanes), device=cuda))
    _chain_vs_plain(cuda, keys, n, paths)


@pytest.mark.parametrize("lanes,batch", [(1, 32), (4, 64)])
def test_threefry_data_chain_bitwise_plain(cuda, lanes, batch):
    """The trainer's data chain: a 2-way split a round and ``randint``'s
    two words of every minibatch element."""
    paths = ([(1, 0, j) for j in range(batch)]
             + [(1, 1, j) for j in range(batch)])
    keys = prng.fold_in(prng.seed_keys(range(lanes), device=cuda), 2)
    _chain_vs_plain(cuda, keys, 256, paths)


@pytest.mark.parametrize("law", ["exponential", "hyperexponential"])
def test_event_stream_draws_one_launch_a_block(cuda, law):
    """A kernel-route run launches the key chain once a block of events
    for all lanes, and gives the plain CPU route's statistics: discrete
    leaves exact, float leaves within ``rtol 1e-12`` (PyTorch's CUDA and
    CPU ``log1p`` may round apart)."""
    rng = np.random.default_rng(3)
    lanes = [NetworkParams(p=torch.as_tensor(rng.dirichlet(np.ones(6))),
                           mu_c=torch.as_tensor(rng.uniform(0.5, 3, 6)),
                           mu_d=torch.as_tensor(rng.uniform(0.5, 3, 6)),
                           mu_u=torch.as_tensor(rng.uniform(0.5, 3, 6)))
             for _ in range(3)]
    kw = dict(warmup=40, seeds=(5, 6, 7), distribution=law, draw_events=100)
    want = simulate_stats_lanes(lanes, [4, 5, 6], 400, backend="batched",
                                **kw)
    on_card = [NetworkParams(*[None if x is None else x.to(cuda)
                               for x in prm]) for prm in lanes]
    ktf.chain_words.launches = 0
    got = simulate_stats_lanes(on_card, [4, 5, 6], 400, backend="kernel",
                               chunk=8, **kw)
    events = 3 * (400 + 40) + 3 * 6 + 8
    assert ktf.chain_words.launches == -(-events // 100)
    for name, g, w in zip(want._fields, got, want):
        g = g.cpu()
        if w.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12,
                                       msg=name)
        else:
            assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the pruned, Pareto and sequential searches and jump_chain_throughput
# ---------------------------------------------------------------------------

def _table1_on(dev, scale):
    spec = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, scale)
    return spec, spec.params(device=dev), LearningSpec().consts


def test_pruned_sweep_kernel_matches_torch_on_the_card(cuda):
    """The pruned search on ``kernel`` against ``torch`` on the card (Table
    1 at scale 5, m = 2..40, 100 steps): the same rows and optimum, values
    within ``rtol 1e-4``, and two sweeps' Buzen launches (each Adam step's
    forward and backward and the final forward)."""
    from repro_torch.core.batched import make_time_objective_padded
    from repro_torch.core.optimize import pruned_concurrency_sweep

    _, net, consts = _table1_on(cuda, 5)
    M, steps = 40, 100
    obj = make_time_objective_padded(net, consts, M)
    kb.buzen_batched.launches = kb.buzen_log_Z_backward.launches = 0
    got = pruned_concurrency_sweep(obj, net, m_grid=np.arange(2, M + 1),
                                   steps=steps, backend="kernel")
    assert kb.buzen_batched.launches == 2 * (steps + 1)
    assert kb.buzen_log_Z_backward.launches == 2 * steps
    want = pruned_concurrency_sweep(obj, net, m_grid=np.arange(2, M + 1),
                                    steps=steps, backend="torch")
    assert kb.buzen_batched.launches == 2 * (steps + 1)  # torch: none
    np.testing.assert_array_equal(got.m_grid, want.m_grid)
    assert len(got.m_grid) < M - 1 and got.best.m == want.best.m
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    assert got.p.device.type == "cuda"


def test_pareto_sweep_kernel_matches_torch_on_the_card(cuda):
    """``pareto_sweep`` (Table 1 at scale 10 with its power profile, 3
    rhos, m = 1..16): each rho's m equal on both routes, values within
    ``rtol 1e-4``, one sweep's launches on ``kernel``."""
    from repro_torch.core.energy import minimal_energy
    from repro_torch.core.optimize import pareto_sweep
    from repro_torch.scenario.spec import EnergySpec

    spec, net, consts = _table1_on(cuda, 10)
    power = EnergySpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10).profile(
        spec, device=cuda)
    e_star = float(minimal_energy(net, consts, power))
    kw = dict(m_max=16, steps=100)
    kb.buzen_batched.launches = kb.buzen_log_Z_backward.launches = 0
    gk, pk = pareto_sweep(net, consts, power, (0.0, 0.3, 1.0), 30.0, e_star,
                          backend="kernel", **kw)
    assert kb.buzen_batched.launches == kw["steps"] + 1
    assert kb.buzen_log_Z_backward.launches == kw["steps"]
    gt, pt = pareto_sweep(net, consts, power, (0.0, 0.3, 1.0), 30.0, e_star,
                          backend="torch", **kw)
    np.testing.assert_allclose(gk.values, gt.values, rtol=1e-4)
    assert [r.m for r in pk] == [r.m for r in pt]
    assert pk[-1].m == 1


def test_sequential_search_kernel_matches_torch_on_the_card(cuda):
    """The sequential search on the static objectives with the Buzen
    backend ``kernel`` process-wide (kernel 1 and its backward 1b reached
    through ``log_normalizing_constants``) against ``torch``, n = 4."""
    from repro_torch.core import buzen as cbz
    from repro_torch.core.optimize import time_optimal

    rng = np.random.default_rng(42)
    net = NetworkParams(
        p=torch.as_tensor(rng.dirichlet(np.ones(4)), device=cuda),
        **{k: torch.as_tensor(rng.uniform(0.3, 8.0, 4), device=cuda)
           for k in ("mu_c", "mu_d", "mu_u")})
    consts = LearningSpec().consts
    saved = cbz.get_backend()
    out = {}
    try:
        for be in ("kernel", "torch"):
            cbz.set_backend(be)
            kb.buzen_batched.launches = kb.buzen_log_Z_backward.launches = 0
            out[be] = time_optimal(net, consts, m_max=10, steps=150,
                                   search="sequential")
            out[be + "_launches"] = (kb.buzen_batched.launches,
                                     kb.buzen_log_Z_backward.launches)
    finally:
        cbz.set_backend(saved)
    got, want = out["kernel"], out["torch"]
    assert min(out["kernel_launches"]) > 0
    assert out["torch_launches"] == (0, 0)
    assert got.m == want.m
    assert [m for m, _ in got.history] == [m for m, _ in want.history]
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=1e-4)
    assert got.p.device.type == "cuda"


@pytest.mark.parametrize("mu_cs,chunk", [(None, 1), (2.5, 8)])
def test_jump_chain_throughput_on_the_card(cuda, mu_cs, chunk):
    """``jump_chain_throughput`` on the ``kernel`` route is bitwise the
    ``simulate_stats`` call it wraps, and launches the lane kernel."""
    from repro_torch.core.events import simulate_stats
    from repro_torch.core.simulator import jump_chain_throughput

    _, net, _ = _table1_on(cuda, 10)
    if mu_cs is not None:
        net = net.with_cs(mu_cs)
    m, steps = 9, 6000
    counter = ke.event_step_lanes if chunk == 1 else ke.megastep_lanes
    counter.launches = 0
    lam, counts = jump_chain_throughput(net, m, steps, seed=4,
                                        backend="kernel", chunk=chunk)
    assert counter.launches > 0
    total = steps // (4 if mu_cs is not None else 3)
    st = simulate_stats(net, m, total - total // 3, warmup=total // 3,
                        seed=4, backend="kernel", chunk=chunk)
    assert lam == float(st.throughput)
    np.testing.assert_array_equal(counts,
                                  st.mean_queue_counts[:-1].cpu().numpy())
    assert counts.shape == (3 * net.n,)


# ---------------------------------------------------------------------------
# the suite server on the card (repro_torch.serve)
# ---------------------------------------------------------------------------

_SERVE_MODEL = {"kind": "mlp", "input_dim": 28 * 28, "num_classes": 2,
                "hidden": [4]}
_SERVE_KERNELS = (kb.buzen_batched, ke.event_step_lanes, ke.megastep_lanes,
                  kf.fused_async_update_flat, ktf.chain_words)


def _serve_scenario(n, seed, chunk=1):
    from repro_torch.scenario import (DataSpec, NetworkSpec, Scenario,
                                      SimSpec, StrategySpec)

    rng = np.random.default_rng(seed)
    return Scenario(
        network=NetworkSpec(mu_c=list(rng.uniform(1.0, 2.0, n)),
                            mu_d=[2.0] * n, mu_u=[2.0] * n),
        strategy=StrategySpec("explicit", p=list(np.full(n, 1.0 / n)), m=2),
        data=DataSpec(dataset="synthetic", num_classes=2,
                      samples_per_class=6),
        sim=None if chunk == 1 else SimSpec(chunk=chunk))


@pytest.fixture(scope="module")
def served_on_card(tmp_path_factory):
    """A server on the card with both routes on ``kernel`` (the CLI's
    defaults there), the process-wide routes restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import sim
    from repro_torch.core import buzen as cbz
    from repro_torch.serve.server import ServeConfig, Server

    saved = cbz.get_backend(), sim.get_backend()
    cbz.set_backend("kernel")
    sim.set_backend("kernel")
    sock = str(tmp_path_factory.mktemp("serve") / "s.sock")
    server = Server(ServeConfig(socket_path=sock, max_wait=0.25,
                                device="cuda"))
    server.start()
    yield sock
    server.stop()
    cbz.set_backend(saved[0])
    sim.set_backend(saved[1])


@pytest.mark.parametrize("mode", ["analyze", "simulate", "train"])
def test_serve_on_the_card_bitwise_and_repeats_launch_nothing(
        served_on_card, mode):
    """Served payloads are bitwise a direct ``ScenarioSuite.run`` on the
    card on the same routes (a mixed-``n`` simulate pair coalesced into
    one dispatch on the lane kernel); a repeat is answered from the
    response cache and launches no kernel."""
    import json

    from repro_torch.fl.models import mlp_classifier
    from repro_torch.scenario import ScenarioSuite
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.protocol import encode_entry

    opts = {"analyze": {}, "simulate": dict(num_updates=200, warmup=20),
            "train": dict(horizon_time=4.0, batch_size=4,
                          eval_every_time=2.0, model=_SERVE_MODEL)}[mode]
    scns = [_serve_scenario(3, 60, chunk=8), _serve_scenario(5, 61, chunk=8)]
    for k in _SERVE_KERNELS:
        k.launches = 0
    with ServeClient(served_on_card, timeout=300) as a, \
            ServeClient(served_on_card, timeout=300) as b:
        ids = [c.submit(s, mode=mode, seeds=(0, 1), **opts)
               for c, s in zip((a, b), scns)]
        got = [c.unwrap(c.collect(r)) for c, r in zip((a, b), ids)]
        sched = [e for e in a.events_for(ids[0]) if e["event"] == "scheduled"]
        launched = {k.__name__: k.launches for k in _SERVE_KERNELS}
        assert sched[0]["requests"] == 2 and sched[0]["lanes"] == 4
        rep = a.collect(a.submit(scns[0], mode=mode, seeds=(0, 1), **opts))
        assert rep["cached"] is True and rep["value"] == got[0]
        assert {k.__name__: k.launches for k in _SERVE_KERNELS} == launched
    want_kernels = {"analyze": ("buzen_batched",),
                    "simulate": ("megastep_lanes", "chain_words"),
                    "train": ("megastep_lanes", "fused_async_update_flat",
                              "chain_words")}[mode]
    assert all(launched[k] > 0 for k in want_kernels), launched
    for scn, payload in zip(scns, got):
        options = dict(opts)
        if mode == "train":
            spec = options.pop("model")
            options["model"] = mlp_classifier(
                spec["input_dim"], spec["num_classes"],
                hidden=tuple(spec["hidden"]), device="cuda")
        (entry,) = ScenarioSuite(scn, seeds=(0, 1), device="cuda").run(
            mode=mode, **options).entries.values()
        assert json.dumps(payload) == json.dumps(encode_entry(mode, entry))


_RESTART = r"""
import json, os, sys
from repro_torch.serve.build_cache import enable_build_cache, prebuild
enable_build_cache(sys.argv[1])
prebuild("cuda")
from repro_torch import sim
from repro_torch.core import buzen
from repro_torch.kernels import build
from repro_torch.scenario import (NetworkSpec, Scenario, SimSpec,
                                  StrategySpec)
from repro_torch.serve.client import ServeClient
from repro_torch.serve.server import ServeConfig, Server
buzen.set_backend("kernel")
sim.set_backend("kernel")
sock = os.path.join(sys.argv[2], "r.sock")
server = Server(ServeConfig(socket_path=sock, max_wait=0.02))
server.start()
scn = Scenario(network=NetworkSpec(mu_c=[1.0, 1.5, 2.0], mu_d=[2.0] * 3,
                                   mu_u=[2.0] * 3),
               strategy=StrategySpec("explicit", p=[1 / 3] * 3, m=2),
               sim=SimSpec(chunk=8))
with ServeClient(sock, timeout=300) as c:
    out = [c.run(scn, mode="analyze"),
           c.run(scn, mode="simulate", num_updates=40)]
server.stop()
print(json.dumps({"builds": len(build.spans()), "payloads": out}))
"""


def test_serve_warm_restart_pays_zero_builds(cuda, tmp_path):
    """Two boots of a server process over one fresh build directory: the
    first builds the scenario path's kernels, the second builds nothing
    and answers bitwise the same."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src")]
        + [x for x in [os.environ.get("PYTHONPATH")] if x]))

    def boot():
        out = subprocess.run([sys.executable, "-c", _RESTART,
                              str(tmp_path / "build"), str(tmp_path)],
                             capture_output=True, text=True, env=env,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold, warm = boot(), boot()
    assert cold["builds"] == 4 and warm["builds"] == 0
    assert json.dumps(cold["payloads"]) == json.dumps(warm["payloads"])


# -- the sharded lane backend and shard= on the sweep, on one card -----------

def _split_on_card(monkeypatch, split):
    """``lane_devices`` patched to three copies of the card (three worker
    threads and streams, the gather) or left as it is (one card: the
    ``batched`` runner itself)."""
    from repro_torch.sim import sharded

    if split:
        monkeypatch.setattr(sharded, "lane_devices",
                            lambda device: [torch.device("cuda", 0)] * 3)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("chunk,trace", [(1, 0), (8, 512)])
def test_sharded_lanes_on_the_card_bitwise_batched(cuda, monkeypatch, split,
                                                   chunk, trace):
    """Five lanes (n = 6, CS on) under ``sharded`` bitwise ``batched`` in
    every leaf, traced or not; no event lane kernel runs (``sharded`` is
    the ``batched`` program), the key-chain kernel does."""
    from repro_torch.sim import build_lanes_fn, stack_lanes

    _split_on_card(monkeypatch, split)
    rng = np.random.default_rng(40)
    lanes = stack_lanes([NetworkParams(
        p=torch.as_tensor(rng.dirichlet(np.ones(6)), device=cuda),
        mu_c=torch.as_tensor(rng.uniform(0.5, 4.0, 6), device=cuda),
        mu_d=torch.as_tensor(rng.uniform(0.5, 4.0, 6), device=cuda),
        mu_u=torch.as_tensor(rng.uniform(0.5, 4.0, 6), device=cuda),
    ).with_cs(1.5) for _ in range(5)])
    keys = prng.seed_keys(range(5), device=cuda)
    args = (lanes, [3, 4, 5, 3, 4], keys, None)
    want = build_lanes_fn("batched", 100, 20, "exponential", 5, False,
                          trace_events=trace, chunk=chunk)(*args)
    before = (ke.event_step_lanes.launches, ke.megastep_lanes.launches,
              ktf.chain_words.launches)
    got = build_lanes_fn("sharded", 100, 20, "exponential", 5, False,
                         trace_events=trace, chunk=chunk)(*args)
    torch.cuda.synchronize()
    after = (ke.event_step_lanes.launches, ke.megastep_lanes.launches,
             ktf.chain_words.launches)
    assert after[:2] == before[:2] and after[2] > before[2]
    flat_w = list(want) if not trace else list(want[0]) + list(want[1])
    flat_g = list(got) if not trace else list(got[0]) + list(got[1])
    for a, b in zip(flat_g, flat_w):
        if b is None:
            assert a is None
        else:
            assert a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("kind", ["client", "class"])
def test_shard_sweep_on_the_card_bitwise_unsharded(cuda, monkeypatch, split,
                                                   kind):
    """``batched_concurrency_sweep(shard=True)`` on the ``kernel`` Buzen
    route (kernels 1, 1b or 5, 5b in every shard) bitwise the unsharded
    sweep; the grid's last shard stops below the padded m."""
    from repro_torch.core.batched import (make_time_objective_classes,
                                          make_time_objective_padded)
    from repro_torch.core.optimize import batched_concurrency_sweep

    _split_on_card(monkeypatch, split)
    spec = NetworkSpec.from_clusters(PAPER_CLUSTERS_TABLE1, 10)
    consts = LearningSpec().consts
    M = 20
    if kind == "client":
        params = spec.params(device=cuda)
        obj = make_time_objective_padded(params, consts, M)
        fwd, bwd = kb.buzen_batched, kb.buzen_log_Z_backward
    else:
        params = ClassSpec.from_clusters(PAPER_CLUSTERS_TABLE1
                                         ).class_params(device=cuda)
        obj = make_time_objective_classes(params, consts, M)
        fwd, bwd = kb.buzen_classes_batched, kb.buzen_classes_log_Z_backward
    kw = dict(m_grid=np.arange(2, 18), m_max=M, steps=10, backend="kernel")
    want = batched_concurrency_sweep(obj, params, **kw)
    fwd.launches = bwd.launches = 0
    got = batched_concurrency_sweep(obj, params, shard=True, **kw)
    torch.cuda.synchronize()
    shards = 3 if split else 1
    assert (fwd.launches, bwd.launches) == (11 * shards, 10 * shards)
    assert got.p.device == want.p.device and torch.equal(got.p, want.p)
    assert np.array_equal(got.values, want.values)
    assert got.best.m == want.best.m


# -- the analysis gates on the card (repro_torch.analysis) --------------------

@pytest.mark.parametrize("name,kernel", [
    ("kernel_buzen", "buzen_batched"),
    ("kernel_buzen_classes", "buzen_classes_batched"),
    ("kernel_events", "event_step_lanes"),
    ("kernel_events_megastep", "megastep_lanes")])
def test_audit_kernel_programs_launch_their_kernel(cuda, name, kernel):
    """The audit on ``cuda`` runs each kernel program through its wrapper
    on the card: its kernel launches (once: the recorded run after the
    warm one), and a kernel wrapper pulls nothing to the host."""
    from repro_torch.analysis import audit

    report = audit.build_report(names=[name], device="cuda")
    entry = report["programs"][name]
    assert report["device"].startswith("cuda")
    assert entry["launches"] == {kernel: 1}
    assert entry["host_syncs"]["count"] == 0 and entry["graph_capturable"]


def test_cached_kernel_suite_repeat_builds_nothing(cuda):
    """A ``kernel``-route suite run again (result cache) and with new
    seeds through the shared caches (runner cache): no ``nvcc``, no runner
    built, no Dynamo compile; the second launches the lane kernel."""
    from repro_torch.analysis import tracecheck
    from repro_torch.core.complexity import LearningConstants
    from repro_torch.scenario import (EXPLICIT, LearningSpec, Scenario,
                                      ScenarioSuite, StrategySpec,
                                      SuiteCaches)

    def suite(seeds, caches):
        scns = {}
        for i, n in enumerate((3, 4, 6)):
            rng = np.random.default_rng(40 + i)
            net = NetworkSpec(mu_c=rng.uniform(0.5, 6.0, n),
                              mu_d=rng.uniform(0.5, 6.0, n),
                              mu_u=rng.uniform(0.5, 6.0, n))
            scns[f"n{n}"] = Scenario(
                network=net, learning=LearningSpec(
                    consts=LearningConstants(M=2.0, G=5.0)),
                strategy=StrategySpec(EXPLICIT, p=rng.dirichlet(np.ones(n)),
                                      m=n - 1))
        return ScenarioSuite(scns, seeds=seeds, caches=caches, device=cuda)

    caches = SuiteCaches()
    first = suite((0, 1), caches)
    with tracecheck.expect(max_programs=2,
                           pattern=tracecheck.PLANNER_PROGRAMS) as w:
        res = first.run(mode="simulate", num_updates=197, backend="kernel")
    assert res.programs == 1 and w.launches.get("event_step_lanes", 0) > 0
    with tracecheck.forbid("the same run again"):
        again = first.run(mode="simulate", num_updates=197, backend="kernel")
    assert again.cache_hits == 3
    with tracecheck.forbid("new seeds through the shared caches") as w:
        new = suite((2,), caches).run(mode="simulate", num_updates=197,
                                      backend="kernel")
    assert new.programs == 0 and w.launches.get("event_step_lanes", 0) > 0


def test_audit_on_cuda_without_a_visible_card_fails(cuda):
    """``audit --device cuda`` where no card is visible raises: no CPU
    fallback."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parents[1] / "src")]
                   + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "audit", "--device", "cuda", "--programs",
                          "kernel_buzen"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert '"programs"' not in out.stdout
