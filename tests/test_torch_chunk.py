"""User chunks (``--user-chunk``) in the port against the JAX package:
the channel's distances and shadowing field in user blocks, the chunked
selection twins, the chunked compression twins, and the wireless sweep
with ``user_chunk=7``.

The chunked port is held bit for bit to the port's unchunked call, and to
the JAX package's chunked call as the unchunked ones are held elsewhere:
selection indices, compression codes, thresholds and scales exact, the
shadowing field rtol 1e-5 (the port's cosine is another approximation),
the sweep records as tests/test_torch_sweep.py holds them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as j_channel  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.kernels import compress_topk as jct  # noqa: E402
from repro.kernels import select_topk as jsel  # noqa: E402
from repro.launch import sweep as j_sweep  # noqa: E402
from repro_torch.core import channel  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from repro_torch.kernels import compress_topk as ct  # noqa: E402
from repro_torch.kernels import select_topk as ks  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy


def test_dist_and_shadow_in_user_chunks_matches_jax():
    jk = jax.random.PRNGKey(9)
    tk = key_from_numpy(np.asarray(jk))
    rs = np.random.default_rng(4)
    pos = rs.uniform(0, 1000, (53, 2)).astype(np.float32)
    bs = rs.uniform(0, 1000, (6, 2)).astype(np.float32)
    cfg = WirelessConfig(n_users=53, n_bs=6)
    with jax.threefry_partitionable(True):
        d, sh = jax.jit(lambda p, b: j_channel.dist_and_shadow(
            p, b, jnp.float32(8.0), jk, JWireless(n_users=53, n_bs=6), 7))(
            pos, bs)
    tpos, tbs = T(pos), T(bs)
    cd, csh = channel.dist_and_shadow(tpos, tbs, 8.0, tk, cfg, user_chunk=7)
    ud, ush = channel.dist_and_shadow(tpos, tbs, 8.0, tk, cfg)
    assert torch.equal(cd, ud) and torch.equal(csh, ush)
    np.testing.assert_allclose(cd.numpy(), np.asarray(d), rtol=1e-6)
    np.testing.assert_allclose(csh.numpy(), np.asarray(sh), rtol=1e-5,
                               atol=1e-4)


def _plane(dtype, n=53, m=7, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-40, 40, (n, m)).astype(np.float32)
    x[20] = x[5]                                    # tied users
    x[:, m - 1] = x[:, 2]                           # tied BSs
    scale = None
    if dtype == "int8":
        x = np.clip(np.round(x), -127, 127).astype(np.int8)
        scale = rs.uniform(0.05, 0.5, m).astype(np.float32)
    elif dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, scale


def _t(x, dtype):
    t = T(np.array(x))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_chunked_selection_matches_jax_and_dense(dtype):
    x, scale = _plane(dtype)
    rem = np.random.default_rng(1).random(53) < 0.5
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bf16" else x
    jc, jb = jsel.masked_bs_argmax_chunked(jx, rem, 7, scale)
    jbest = jsel.best_bs_argmax_chunked(jx, 7, scale)
    ts = None if scale is None else T(scale)
    tx = _t(x, dtype)
    c, b = ks.masked_bs_argmax_chunked(tx, T(rem), 7, ts)
    best = ks.best_bs_argmax_chunked(tx, 7, ts)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    dc, db = ks.masked_bs_argmax_plain(tx, T(rem), ts)
    assert torch.equal(c, dc) and torch.equal(b, db)
    assert torch.equal(best, ks.best_bs_argmax_plain(tx, ts))
    # nothing remains: (0, -inf) as the dense version gives
    c0, b0 = ks.masked_bs_argmax_chunked(tx, torch.zeros(53, dtype=bool), 7,
                                         ts)
    assert (c0 == 0).all() and torch.isinf(b0).all()


@pytest.mark.parametrize("quantize", [False, True])
def test_chunked_compression_matches_jax(quantize):
    rs = np.random.default_rng(3)
    x = rs.normal(size=(9, 101)).astype(np.float32)
    x[4] = 0.0
    x[2, 7] = x[2, 8]                               # a tie at the top
    k = 13
    jt, jm = jct.topk_threshold_chunked(x, k, 16)
    tt, tm = ct.topk_threshold_chunked(T(x), k, 16)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    dt, dm = ct.topk_threshold(T(x), k)
    assert torch.equal(tt, dt) and torch.equal(tm, dm)
    scale = ct.quant_scale(tm)
    u = T(rs.uniform(size=x.shape).astype(np.float32))
    jq = jct.sparsify_quantize_chunked(
        x, np.asarray(jt), np.asarray(scale), u.numpy(), quantize=quantize,
        block=4)
    tq = ct.sparsify_quantize_chunked(T(x), tt, scale, u, quantize=quantize,
                                      block=4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert torch.equal(tq, ct.sparsify_quantize_plain(
        T(x), tt, scale, u, quantize=quantize))
    # the tree compressor with a block, against JAX's chunked one
    delta = {"a": {"w": x[:, :60].reshape(9, 6, 10)}, "b": {"w": x[:, 60:]}}
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(2)
        jc, js = jct.compress_delta_tree(delta, 0.2, quantize=quantize,
                                         key=key, backend="jax", block=8)
    tdelta = {g: {"w": T(np.array(v["w"]))} for g, v in delta.items()}
    tc, ts = ct.compress_delta_tree(tdelta, 0.2, quantize=quantize,
                                    key=key_from_numpy(np.asarray(key)),
                                    block=8)
    dc, _ = ct.compress_delta_tree(tdelta, 0.2, quantize=quantize,
                                   key=key_from_numpy(np.asarray(key)))
    for g in delta:
        np.testing.assert_array_equal(tc[g]["w"].numpy(),
                                      np.asarray(jc[g]["w"]))
        np.testing.assert_array_equal(ts[g]["w"].numpy(),
                                      np.asarray(js[g]["w"]))
        assert torch.equal(tc[g]["w"], dc[g]["w"])


def test_wireless_sweep_in_user_chunks_matches_jax():
    """``user_chunk=7`` at 20 users (a partial last block) on a shadowed
    world and the paper's: the records of JAX's chunked sweep, and the
    port's unchunked records exactly."""
    names = ["paper-default", "shadowed"]
    kw = dict(n_seeds=2, n_rounds=2, seed=3)
    with jax.threefry_partitionable(True):
        want = j_sweep.run_sweep(names, cfg=JWireless(n_users=20, n_bs=4),
                                 user_chunk=7, **kw)
    cfg = WirelessConfig(n_users=20, n_bs=4)
    got = sweep.run_sweep(names, cfg=cfg, user_chunk=7, device="cpu", **kw)
    assert got == sweep.run_sweep(names, cfg=cfg, device="cpu", **kw)
    for w, g in zip(want, got):
        assert g["curves"]["n_selected"] == w["curves"]["n_selected"]
        for k in ("t_round_mean_s", "t_round_p95_s", "participants_mean",
                  "min_part_rate"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"{w['scenario']} {k}")
        np.testing.assert_allclose(g["curves"]["t_round_s"],
                                   w["curves"]["t_round_s"], rtol=1e-5)
