"""repro_torch's sharded sweeps and FLConfig.shard against the unsharded
port and the JAX package (``repro.launch.shard_sweep``).

* The padding helpers and ``make_data_mesh``'s checks against JAX's on
  the same inputs (tests/test_shard_sweep.py's cases).
* A world of one, in this process: ``run_shard_sweep`` on the uneven
  2 x 3 grid is byte-identical to the port's ``run_sweep`` and holds
  JAX's live ``run_shard_sweep`` to test_torch_sweep.py's record
  tolerances.
* A world of two gloo ranks on the CPU: one ``torchrun`` job
  (``tests/_torch_shard_job.py``, its own processes, spawned) runs every
  sharded path once, and the tests below hold its outputs against this
  process's unsharded runs: the sweeps' records byte-identical (JAX's
  contract at any world size), ``shard_schedule_batch`` field for field,
  ``FLSimulation(shard=True)`` numerically equal (decisions and
  ``t_round`` exact, parameters rtol 1e-4 / atol 1e-5: a rank trains 25
  clients at once where the unsharded run trains 50, and the batched
  matmuls may round differently).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl import FLConfig as JConfig  # noqa: E402
from repro.launch import shard_sweep as j_shard  # noqa: E402
from repro.launch import sharding as j_sharding  # noqa: E402
from repro_torch.core.dagsa_jit import dagsa_schedule_batch  # noqa: E402
from repro_torch.fl.rounds import FLConfig  # noqa: E402
from repro_torch.launch import shard_sweep, sharding, sweep  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402

from test_torch_slice import cap_torch_threads  # noqa: E402
from test_torch_sweep import _check_wireless  # noqa: E402
import _torch_shard_job as job  # noqa: E402

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
UNEVEN = dict(n_seeds=3, n_rounds=2)       # 2 scenarios x 3 seeds


def _same(a, b) -> bool:
    """Byte-level record equality (the JAX package's CI diff)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ----------------------------------------------------------------- padding --
@pytest.mark.parametrize("n,shards", [(15, 8), (16, 8), (1, 8), (7, 1),
                                      (0, 8), (8, 0)])
def test_padded_count_is_the_references(n, shards):
    try:
        want = j_sharding.padded_count(n, shards)
    except ValueError:
        with pytest.raises(ValueError):
            sharding.padded_count(n, shards)
        return
    assert sharding.padded_count(n, shards) == want


def test_pad_leading_wraps_as_the_reference():
    a = np.arange(5, dtype=np.int32)
    b = np.arange(10, dtype=np.float32).reshape(5, 2)
    want = j_sharding.pad_leading({"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                  8)
    got = sharding.pad_leading(
        ({"a": torch.from_numpy(a)}, [torch.from_numpy(b)]), 8)
    assert np.array_equal(got[0]["a"].numpy(), np.asarray(want["a"]))
    assert np.array_equal(got[1][0].numpy(), np.asarray(want["b"]))
    back = sharding.unpad_leading(got, 5)
    assert np.array_equal(back[0]["a"].numpy(), a)
    assert np.array_equal(back[1][0].numpy(), b)
    x = torch.arange(4)
    assert sharding.pad_leading(x, 4) is x


def test_make_data_mesh_validates_as_the_reference():
    mesh = make_data_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.world_size) == (1, 0, 1)
    assert list(mesh.block(5)) == [0, 1, 2, 3, 4]
    assert mesh.gather("x") == ["x"]
    with pytest.raises(ValueError):
        j_shard.make_data_mesh(0)
    with pytest.raises(ValueError):
        make_data_mesh(0, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        make_data_mesh(mesh.world_size + 1, device="cpu")


def test_mesh_devices_requires_shard_as_the_reference():
    with pytest.raises(ValueError, match="mesh_devices"):
        JConfig(mesh_devices=2)
    with pytest.raises(ValueError, match="mesh_devices"):
        FLConfig(mesh_devices=2)


# ----------------------------------------------------------- world of one --
def test_world_of_one_shard_sweep_matches_run_sweep_and_live_jax():
    names = ["paper-default", "high-mobility"]
    plain = sweep.run_sweep(names, device="cpu", **UNEVEN)
    got = shard_sweep.run_shard_sweep(names, device="cpu", **UNEVEN)
    assert _same(plain, got)
    with jax.threefry_partitionable(True):
        want = j_shard.run_shard_sweep(names, cfg=JWireless(), **UNEVEN)
    assert [r["scenario"] for r in got] == names
    _check_wireless(want, got, "shard")


# ----------------------------------------------------------- world of two --
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The torchrun job's per-rank outputs and its directory."""
    out = tmp_path_factory.mktemp("shard")
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT)]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(ROOT / "tests" / "_torch_shard_job.py"),
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, out


def test_two_ranks_split_the_padded_grid(two_ranks):
    ranks, _ = two_ranks
    assert [(r["rank"], r["world_size"]) for r in ranks] == [(0, 2), (1, 2)]
    # 3 cells pad to 4: rank 0 runs cells 0-1, rank 1 cell 2 (3 is padding)
    assert [r["block"] for r in ranks] == [[0, 1], [2]]


def test_two_rank_wireless_sweep_is_byte_identical(two_ranks):
    ranks, _ = two_ranks
    three = dict(job.THREE)
    want = sweep.run_sweep(three.pop("scenarios"), device="cpu", **three)
    for r in ranks:
        assert _same(r["wireless"], want), r["rank"]


def test_two_rank_learning_sweep_is_byte_identical(two_ranks):
    ranks, _ = two_ranks
    learn = dict(job.LEARNING)
    want = sweep.run_learning_sweep(learn.pop("scenarios"), device="cpu",
                                    **learn)
    assert want[0]["scheduler"] == "dagsa-r"
    assert 0.0 <= want[0]["delivered_rate_mean"] <= 1.0
    for r in ranks:
        assert _same(r["learning"], want), r["rank"]


def test_two_rank_schedule_batch_matches_the_batch(two_ranks):
    ranks, _ = two_ranks
    probs, keys = job.fleet_problems(5)
    ref = dagsa_schedule_batch(probs, keys)
    for r in ranks:
        for f in dataclasses.fields(ref):
            want = getattr(ref, f.name)
            if want is None:
                continue
            np.testing.assert_array_equal(r["schedule"][f.name],
                                          want.numpy(), err_msg=f.name)


def test_two_rank_fl_sim_meets_the_contract(two_ranks):
    ranks, _ = two_ranks
    want_recs, want_params = job.fl_run(shard=False)
    for r in ranks:
        recs, params = r["fl"]
        for g, w in zip(recs, want_recs):
            for k in ("round_idx", "n_selected", "t_round", "wall_clock",
                      "min_part_rate"):
                assert g[k] == w[k], (r["rank"], k)
            # a test sample whose two top logits tie within float32
            # rounding may take either class
            assert abs(g["test_acc"] - w["test_acc"]) <= 1.0 / 32 + 1e-7
        for k in want_params:
            for leaf in want_params[k]:
                np.testing.assert_allclose(params[k][leaf],
                                           want_params[k][leaf], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{k}.{leaf}")


def test_two_rank_fl_sim_rejects_indivisible_users(two_ranks):
    ranks, _ = two_ranks
    for r in ranks:
        assert "divisible" in r["indivisible"]


def test_two_rank_cli_writes_the_unsharded_json(two_ranks, tmp_path):
    _, out = two_ranks
    plain = tmp_path / "plain.json"
    sweep.main(job.CLI + ["--device", "cpu", "--out", str(plain)])
    assert (out / "cli.json").read_text() == plain.read_text()
