"""The quickstart pipeline end to end in both packages (Table 1 at scale 10):
closed forms, the time-optimal sweep and the event engine at the optimum;
plus the port's import hygiene (no ``jax``, nothing of ``repro``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.core import complexity as jcx
from repro.core import events as JE
from repro.core import jackson as jjk
from repro.core import optimize as jopt
from repro.scenario import spec as jspec
from repro_torch import convert
from repro_torch.core import complexity as tcx
from repro_torch.core import events as TE
from repro_torch.core import jackson as tjk
from repro_torch.core import optimize as topt
from repro_torch.core.simulator import AsyncNetworkSim
from repro_torch.scenario import spec as tspec
from repro_torch.sim import simulate_stats_lanes

ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree):
    return {k: None if v is None else np.asarray(v)
            for k, v in tree._asdict().items()}


def test_quickstart_pipeline_matches_jax():
    jnet = jspec.NetworkSpec.from_clusters(jspec.PAPER_CLUSTERS_TABLE1, 10)
    tnet = tspec.NetworkSpec.from_clusters(tspec.PAPER_CLUSTERS_TABLE1, 10)
    assert tnet.n == jnet.n
    jp, tp = jnet.params(), tnet.params(device="cpu")
    jc, tc = jspec.LearningSpec().consts, tspec.LearningSpec().consts
    assert tc == convert.learning_constants(jc._asdict())
    n = m = tnet.n

    # closed forms (Theorem 2 / Proposition 4 / Theorem 3)
    np.testing.assert_allclose(
        tjk.expected_relative_delay(tp, m).numpy(),
        np.asarray(jjk.expected_relative_delay(jp, m)), rtol=1e-10)
    lam = float(tjk.throughput(tp, m))
    assert lam == pytest.approx(float(jjk.throughput(jp, m)), rel=1e-10)
    assert float(tcx.wallclock_time(tp, m, tc)) == pytest.approx(
        float(jcx.wallclock_time(jp, m, jc)), rel=1e-10)

    # the time-optimal sweep over m = 2..n+6
    want = jopt.time_optimal(jp, jc, m_max=n + 6, steps=40)
    got = topt.time_optimal(tp, tc, m_max=n + 6, steps=40)
    assert got.m == want.m
    assert got.value == pytest.approx(want.value, rel=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), atol=1e-6)

    # the event engine at the optimum, fed the blocks JAX drew: bitwise
    jopt_p = jp._replace(p=jnp.asarray(got.p.numpy()))
    st0 = JE.init_state(jopt_p, got.m, jax.random.PRNGKey(0), m_max=got.m,
                        warmup=20, cap=100)
    _, blk = JE.draw_event_blocks(jopt_p, jax.random.PRNGKey(1), 330)

    def body(s, b):
        return JE.step_event_block(jopt_p, s, b)[0], None

    want_st, _ = jax.jit(lambda s, b: jax.lax.scan(body, s, b))(st0, blk)
    lanes = TE.stack_lanes
    tblk = convert.event_blocks(_leaves(blk), device="cpu")
    got_st = TE.run_event_blocks(
        lanes([convert.network_params(_leaves(jopt_p), device="cpu")]),
        lanes([convert.event_state(_leaves(st0), device="cpu")]),
        TE.EventBlocks(*[None if x is None else x[:, None] for x in tblk]),
        backend="kernel")
    for a, b in zip(TE.finalize_stats(got_st), JE.finalize_stats(want_st)):
        assert np.array_equal(a[0].numpy(), np.asarray(b))

    # and its own draws against Prop. 4 at the optimum, as is the host sim
    p_star = tp._replace(p=got.p)
    lam_star = float(tjk.throughput(p_star, got.m))
    stats = simulate_stats_lanes([p_star] * 8, [got.m] * 8, 2_000,
                                 warmup=400, backend="kernel")
    assert float(stats.throughput.mean()) == pytest.approx(lam_star, rel=0.05)
    host = AsyncNetworkSim(p_star, got.m, seed=0).run(20_000, warmup=2_000)
    assert host.throughput == pytest.approx(lam_star, rel=0.05)


def test_entry_points_default_to_the_card():
    net = tspec.NetworkSpec.from_clusters(tspec.PAPER_CLUSTERS_TABLE1, 10)
    if torch.cuda.is_available():
        assert net.params().p.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            net.params()


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert examples
    smoke = ROOT / "chip_smoke.py"
    return files + examples + ([smoke] if smoke.exists() else [])


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(nm) for nm in names), (path, names)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
