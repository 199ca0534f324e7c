"""The port's data stack and models against the JAX package.

1. ``repro_torch.data`` (numpy only) gives the reference's arrays bit for
   bit: the synthetic images, the train/test split, the three partitioners,
   the EMNIST loader's synthetic fallback and its local ``.npz`` path.
2. The MLP and a narrow CNN (channels (4, 8), image 12, 5 classes), with
   the reference's weights carried across by ``convert.model_params``,
   give the reference's logits, loss and gradients at ``rtol 1e-5,
   atol 1e-6`` (float32 in two frameworks), and its accuracy exactly.
3. The strategy helpers and ``run_strategy_grid``'s lane layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.numerics  # noqa: F401  (the JAX package's float64 mode)
from repro.data import emnist as jem
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl import models as jmodels
from repro.fl import strategies as jstrat
from repro_torch import convert
from repro_torch import data as tdata
from repro_torch.core import prng
from repro_torch.data import emnist as tem
from repro_torch.fl import models as tmodels
from repro_torch.fl import strategies as tstrat
from repro_torch.scenario.registry import PARTITIONS


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# data: bit for bit
# ---------------------------------------------------------------------------

def test_synthetic_dataset_and_split_bitwise():
    kw = dict(num_classes=3, samples_per_class=6, image_size=12, seed=4)
    ds = tdata.make_synthetic_image_dataset(**kw)
    want = jsyn.make_synthetic_image_dataset(**kw)
    _same(ds, want)
    assert ds.x.shape == (18, 12, 12, 1) and ds.x.dtype == np.float32
    for got, ref in zip(tdata.train_test_split(ds, 0.25, seed=2),
                        jsyn.train_test_split(want, 0.25, seed=2)):
        _same(got, ref)


@pytest.mark.parametrize("name,kw", [
    ("iid", {}), ("dirichlet", dict(alpha=0.3)),
    ("pathological", dict(classes_per_client=2))])
def test_partitions_bitwise_and_registered(name, kw):
    y = np.random.default_rng(5).integers(0, 6, 120).astype(np.int32)
    got = PARTITIONS.get(name)(y, 7, seed=3, **kw)
    want = jpart.__dict__[f"{name}_partition"](y, 7, seed=3, **kw)
    assert len(got) == 7
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_emnist_fallback_and_local_cache_bitwise(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_EMNIST_PATH", str(tmp_path / "absent.npz"))
    kw = dict(num_classes=3, samples_per_class=4, seed=1)
    fb = tdata.load_emnist(**kw)
    _same(fb, jem.load_emnist(**kw))
    assert fb.x.shape == (12, 28, 28, 1)
    # a different dataset from the "synthetic" one of the same seed
    assert not np.array_equal(
        fb.x, tdata.get_dataset("synthetic", num_classes=3,
                                samples_per_class=4, seed=1).x)
    rng = np.random.default_rng(0)
    path = tmp_path / "emnist.npz"
    np.savez(path, x=rng.integers(0, 256, (60, 28, 28)).astype(np.uint8),
             y=np.repeat(np.arange(6), 10))
    monkeypatch.setenv("REPRO_EMNIST_PATH", str(path))
    assert tem.emnist_cache_path() == str(path)
    got = tdata.get_dataset("emnist", num_classes=4, samples_per_class=5,
                            seed=2)
    _same(got, jem.load_emnist(num_classes=4, samples_per_class=5, seed=2))
    assert got.x.max() <= 1.0 and got.x.shape == (20, 28, 28, 1)
    with pytest.raises(ValueError, match="registered datasets"):
        tdata.get_dataset("kmnist", num_classes=2, samples_per_class=2,
                          seed=0)
    with pytest.raises(ValueError, match="classes"):
        tdata.load_emnist(num_classes=7, samples_per_class=2)


# ---------------------------------------------------------------------------
# models: logits, loss and gradients with the reference's weights
# ---------------------------------------------------------------------------

def _models(kind):
    if kind == "mlp":
        return (jmodels.mlp_classifier(12 * 12, 5, hidden=(16, 8)),
                tmodels.mlp_classifier(12 * 12, 5, hidden=(16, 8),
                                       device="cpu"))
    return (jmodels.cnn_classifier(12, 5, channels=(4, 8)),
            tmodels.cnn_classifier(12, 5, channels=(4, 8), device="cpu"))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_model_matches_reference_with_converted_weights(kind):
    jm, tm = _models(kind)
    params = jm.init(jax.random.PRNGKey(3))
    # non-zero biases, so their layout is checked too
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype
                                        ).reshape(a.shape) / a.size, params)
    tm.load_state_dict(convert.model_params(
        jax.tree_util.tree_map(np.asarray, params), tm))
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(9, 12, 12, 1))  # float64: must not promote
    y = rng.integers(0, 5, 9).astype(np.int32)

    logits = tm(torch.as_tensor(x))
    assert logits.dtype == torch.float32
    want = jm.apply(params, jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    yt = torch.as_tensor(y).long()
    loss = tmodels.cross_entropy_loss(logits, yt)
    np.testing.assert_allclose(
        loss.item(), float(jmodels.cross_entropy_loss(want, jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)
    assert float(tmodels.accuracy(logits, yt)) == float(
        jmodels.accuracy(want, jnp.asarray(y)))

    grads = torch.autograd.grad(loss, list(tm.parameters()))
    jgrads = jax.grad(lambda p: jmodels.cross_entropy_loss(
        jm.apply(p, jnp.asarray(x, jnp.float32)), jnp.asarray(y)))(params)
    want_g = convert.model_params(jax.tree_util.tree_map(np.asarray, jgrads),
                                  tm)
    for (name, _), g in zip(tm.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_paper_cnn_width_and_init():
    tm = tmodels.cnn_classifier(28, 47, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == 408_767
    assert sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(
        jmodels.cnn_classifier(28, 47).init(jax.random.PRNGKey(0)))) \
        == 408_767
    tm.init_parameters(prng.PRNGKey(5, device="cpu"))
    first = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.init_parameters(prng.PRNGKey(5, device="cpu"))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, first[k])
        if k.endswith(".b"):
            assert not v.any()
    # He-normal: std sqrt(2 / fan_in), fan_in = 7 * 7 * 20 for conv2
    std = float(first["conv2.w"].std())
    assert abs(std - np.sqrt(2.0 / 980)) < 0.05 * np.sqrt(2.0 / 980)


def test_model_params_rejects_mismatches():
    jm, tm = _models("mlp")
    leaves = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="no parameter"):
        convert.model_params(leaves + [{"w": np.zeros(2)}], tm)
    with pytest.raises(ValueError, match="no reference leaf"):
        convert.model_params(leaves[:-1], tm)
    leaves[0]["w"] = leaves[0]["w"][:3]
    with pytest.raises(ValueError, match="shape"):
        convert.model_params(leaves, tm)


# ---------------------------------------------------------------------------
# strategies and the strategy grid
# ---------------------------------------------------------------------------

def test_strategy_helpers_match_reference():
    from repro.scenario.spec import PAPER_CLUSTERS_TABLE1 as JT1
    from repro_torch.scenario.spec import PAPER_CLUSTERS_TABLE1 as TT1

    for scale, mu_cs in ((1, None), (10, 4.0)):
        got = tstrat.build_network_params(TT1, scale, mu_cs, device="cpu")
        want = jstrat.build_network_params(JT1, scale, mu_cs)
        for k in ("p", "mu_c", "mu_d", "mu_u", "mu_cs"):
            a, b = getattr(got, k), getattr(want, k)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b)), k
        assert (tstrat.cluster_labels(TT1, scale)
                == jstrat.cluster_labels(JT1, scale))
    strategies = {"asyncsgd": (np.full(3, 1 / 3), 3),
                  "max_throughput": (np.array([0.5, 0.3, 0.2]), 2)}
    assert tstrat.default_etas(strategies) == jstrat.default_etas(strategies)
    for etas in (None, 0.2, {"asyncsgd": 0.3}):
        _same(tstrat.strategy_batch(strategies, etas)[1:],
              jstrat.strategy_batch(strategies, etas)[1:])


def test_run_strategy_grid_lanes():
    from repro_torch.core.buzen import NetworkParams
    from repro_torch.fl import (AsyncFLConfig, DeviceTrainer,
                                run_strategy_grid)

    rng = np.random.default_rng(1)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    net = NetworkParams(p=t(np.full(3, 1 / 3)),
                        mu_c=t(rng.uniform(1, 3, 3)),
                        mu_d=t(rng.uniform(1, 3, 3)),
                        mu_u=t(rng.uniform(1, 3, 3)))
    ds = tdata.make_synthetic_image_dataset(num_classes=3,
                                            samples_per_class=8,
                                            image_size=10, seed=0)
    clients = [(ds.x[i::3], ds.y[i::3]) for i in range(3)]
    model = tmodels.mlp_classifier(100, 3, hidden=(4,), device="cpu")
    cfg = AsyncFLConfig(batch_size=4, eval_every_time=2.0, eval_batch=8)
    strategies = {"a": (np.full(3, 1 / 3), 2),
                  "b": (np.array([.6, .3, .1]), 3)}
    res = run_strategy_grid(model, clients, net, strategies, cfg,
                            horizon_time=6.0, seeds=(0, 1),
                            etas={"a": 0.05, "b": 0.1},
                            test_data=(ds.x, ds.y), device="cpu")
    assert res.lanes == 4 and res.seeds == (0, 1) and res.updates_per_lane > 0
    tr = DeviceTrainer(model, clients, net, cfg, test_data=(ds.x, ds.y),
                       device="cpu")
    logs, fin = tr.run_lanes([strategies["a"][0]] * 2
                             + [strategies["b"][0]] * 2, [2, 2, 3, 3],
                             [0.05, 0.05, 0.1, 0.1], [0, 1, 0, 1], 6.0)
    for got, want in zip(res.logs["a"] + res.logs["b"], logs):
        assert got.losses == want.losses and got.updates == want.updates
    assert torch.equal(res.final_params, fin)
