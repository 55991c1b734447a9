"""The four sweep cases of tests/test_golden_trajectories.py, in the port
against a live run of ``repro.launch.sweep.run_learning_sweep``.

Each case runs with the golden test's exact arguments (12 users, 4 BSs,
2 seeds, 3 rounds, 120 / 40 samples, 1 local epoch, batch 10, seed 7);
the records are held field by field as tests/test_torch_sweep.py's
``_check_learning`` holds them: ``n_selected`` and the delivery and
queue curves exact, the clock and ``t_round`` rtol 1e-5, ``test_acc``
within one of the 40 test samples.  A file of its own, so that the test
runner's per-file workers share the sweeps' JAX compiles.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.launch import sweep as j_sweep  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402

from test_torch_sweep import GOLDEN, LEARN, _check_learning  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_sweep_case_matches_live_jax(case):
    """The arguments of test_golden_trajectories.py's sweep case, both
    packages, records held field by field."""
    names, kw = GOLDEN[case]
    with jax.threefry_partitionable(True):
        want = j_sweep.run_learning_sweep(
            names, cfg=JWireless(n_users=12, n_bs=4), **LEARN, **kw)
    got = sweep.run_learning_sweep(
        names, cfg=WirelessConfig(n_users=12, n_bs=4), device="cpu",
        **LEARN, **kw)
    _check_learning(want, got)
