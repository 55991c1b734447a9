"""The port's data plane against the JAX package: synthetic data, the shard
partition, the CNN, local SGD and Eq. (2) FedAvg.

Tolerances: labels and indices exact; pixels rtol=1e-5 (atol=1e-5 for
pixels that cancel near 0: erfinv and log1p differ by an ulp between XLA
and torch); CNN forward, loss and gradients rtol=1e-5 (matmul sums in
another order); local SGD rtol=1e-4 (rounding carried
through chained SGD updates); FedAvg rtol=1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_dataset as j_make_dataset  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import server as j_server  # noqa: E402
from repro.fl.partition import shard_partition as j_shard  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.fl import client, server  # noqa: E402
from repro_torch.fl.partition import shard_partition  # noqa: E402
from repro_torch.interop import (key_from_numpy, params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import cnn  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

SMALL = dict(c1=4, c2=8, hidden=16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, **tol):
    for k in want:
        for leaf in want[k]:
            np.testing.assert_allclose(got[k][leaf], want[k][leaf], **tol,
                                       err_msg=f"{k}.{leaf}")


@pytest.mark.parametrize("name,seed", [("mnist", 0), ("cifar10", 3)])
def test_make_dataset_matches_jax(name, seed):
    with jax.threefry_partitionable(True):
        want = j_make_dataset(name, seed=seed, n_train=60, n_test=30)
    got = make_dataset(name, seed=seed, n_train=60, n_test=30)
    for split in ("train", "test"):
        y_w = np.asarray(getattr(want, f"y_{split}"))
        y_g = getattr(got, f"y_{split}")
        assert y_g.dtype == torch.int32
        np.testing.assert_array_equal(y_g.numpy(), y_w)
        np.testing.assert_allclose(getattr(got, f"x_{split}").numpy(),
                                   np.asarray(getattr(want, f"x_{split}")),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,users,spu", [(120, 12, 2), (125, 12, 2),
                                         (4000, 50, 2), (97, 5, 3)])
def test_shard_partition_matches_jax(n, users, spu):
    rs = np.random.default_rng(n)
    labels = rs.integers(0, 10, n).astype(np.int32)
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(n + users)
        want = np.asarray(j_shard(key, jnp.asarray(labels), users, spu))
    got = shard_partition(key_from_numpy(np.asarray(key)),
                          torch.from_numpy(labels), users, spu)
    np.testing.assert_array_equal(got.numpy(), want)


def _model_and_data(seed, cfg, batch=6):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(batch, cfg.height, cfg.width, cfg.channels)) \
        .astype(np.float32)
    y = rs.integers(0, 10, batch).astype(np.int32)
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(seed)
        params = j_cnn.init(key, j_cnn.CNNConfig(
            height=cfg.height, width=cfg.width, channels=cfg.channels,
            c1=cfg.c1, c2=cfg.c2, hidden=cfg.hidden))
    return key, _np_tree(params), x, y


@pytest.mark.parametrize("shape", [(28, 28, 1), (32, 32, 3), (9, 11, 2)])
def test_cnn_init_apply_loss_grad_match_jax(shape):
    h, w, c = shape
    cfg = cnn.CNNConfig(height=h, width=w, channels=c, **SMALL)
    key, jp, x, y = _model_and_data(h * w, cfg)
    # init draws the same weights from the same key
    _assert_tree_close(params_to_numpy(cnn.init(key_from_numpy(
        np.asarray(key)), cfg)), jp, rtol=1e-5, atol=1e-7)

    tp = params_from_numpy(jp)
    np.testing.assert_allclose(cnn.apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(j_cnn.apply(jp, x)),
                               rtol=1e-5, atol=1e-5)
    for leaf in (p for sub in tp.values() for p in sub.values()):
        leaf.requires_grad_(True)
    loss = cnn.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))
    j_loss, j_grad = jax.value_and_grad(j_cnn.loss_fn)(jp, x, y)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    leaves = [p for sub in tp.values() for p in sub.values()]
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    got = {k: {leaf: next(it).numpy() for leaf in sub} for k, sub in tp.items()}
    _assert_tree_close(got, _np_tree(j_grad), rtol=1e-5, atol=1e-6)
    assert cnn.n_params(tp) == j_cnn.n_params(jp)
    np.testing.assert_allclose(
        cnn.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(j_cnn.accuracy(jp, x, y)))


def test_paper_scale_cnn_size():
    cfg = cnn.CNNConfig.paper_scale()
    params = cnn.init(torch.tensor([0, 0]), cfg)
    assert cnn.n_params(params) == 105866
    assert params["fc1"]["w"].shape == (1568, 64)
    assert abs(cnn.model_mbit(params) - 105866 * 32 / 1e6) < 1e-12


def test_fleet_local_sgd_one_epoch_matches_jax():
    cfg = cnn.CNNConfig(**SMALL)
    key, jp, _, _ = _model_and_data(5, cfg)
    rs = np.random.default_rng(5)
    x_all = rs.normal(size=(4, 30, 28, 28, 1)).astype(np.float32)
    y_all = rs.integers(0, 10, (4, 30)).astype(np.int32)
    with jax.threefry_partitionable(True):
        keys = jax.random.split(key, 4)
        want = j_client.fleet_local_sgd(j_cnn.loss_fn, jp, x_all, y_all,
                                        keys, epochs=1, batch_size=8, lr=0.05)
    got = client.fleet_local_sgd(params_from_numpy(jp),
                                 torch.from_numpy(x_all),
                                 torch.from_numpy(y_all),
                                 key_from_numpy(np.asarray(keys)), epochs=1,
                                 batch_size=8, lr=0.05)
    _assert_tree_close(params_to_numpy(got), _np_tree(want), rtol=1e-4,
                       atol=1e-6)


def test_local_sgd_two_epochs_matches_jax_and_rejects_oversized_batch():
    cfg = cnn.CNNConfig(**SMALL)
    key, jp, _, _ = _model_and_data(6, cfg)
    rs = np.random.default_rng(6)
    x = rs.normal(size=(20, 28, 28, 1)).astype(np.float32)
    y = rs.integers(0, 10, 20).astype(np.int32)
    with jax.threefry_partitionable(True):
        want = j_client.local_sgd(j_cnn.loss_fn, jp, jnp.asarray(x),
                                  jnp.asarray(y), key, epochs=2,
                                  batch_size=6, lr=0.05)
    tkey = key_from_numpy(np.asarray(key))
    got = client.local_sgd(params_from_numpy(jp), torch.from_numpy(x),
                           torch.from_numpy(y), tkey, epochs=2, batch_size=6,
                           lr=0.05)
    _assert_tree_close(params_to_numpy(got), _np_tree(want), rtol=1e-4,
                       atol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        client.local_sgd(params_from_numpy(jp), torch.from_numpy(x),
                         torch.from_numpy(y), tkey, epochs=1, batch_size=21,
                         lr=0.05)


@pytest.mark.parametrize("case", ["plain", "poisoned", "clip", "weights",
                                  "empty"])
def test_fedavg_matches_jax(case):
    rs = np.random.default_rng(8)
    n = 9
    g = {"a": {"w": rs.normal(size=(3, 4)).astype(np.float32)},
         "b": {"w": rs.normal(size=(5,)).astype(np.float32),
               "b": rs.normal(size=(2, 2)).astype(np.float32)}}
    c = jax.tree.map(lambda v: (v[None] + rs.normal(size=(n,) + v.shape))
                     .astype(np.float32), g)
    sel = rs.random(n) < 0.6
    sizes = rs.integers(5, 40, n).astype(np.int32)
    kw = {}
    if case == "poisoned":
        sel[1] = True
        c["b"]["b"][1, 0, 1] = np.nan
    if case == "clip":
        kw["clip_norm"] = 1.5
    if case == "weights":
        kw["weights"] = rs.uniform(0.1, 1.0, n).astype(np.float32)
    if case == "empty":
        sel[:] = False
    want = _np_tree(j_server.fedavg(g, c, sel, sizes, **kw))
    t_kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    got = server.fedavg(params_from_numpy(g), params_from_numpy(c),
                        torch.from_numpy(sel), torch.from_numpy(sizes), **t_kw)
    _assert_tree_close(params_to_numpy(got), want, rtol=1e-6, atol=1e-7)
    ok = server.finite_update_mask(params_from_numpy(c)).numpy()
    np.testing.assert_array_equal(
        ok, np.asarray(j_server.finite_update_mask(c)))
