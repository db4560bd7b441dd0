"""The port's K-min select (hybridneuralrendering_tpu_torch/ops/select.py)
against the JAX package's Pallas kernel, run in interpret mode, and its XLA
twin, on the three cases of tests/test_pallas_select.py.  Selection does no
arithmetic, so the distances must be equal, not close; ids must be equal
too, since both sides break ties toward the lowest column."""

import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.ops import pallas_select as PS
from hybridneuralrendering_tpu_torch.ops import select as TS

CASES = [(70, 53, 4, 0), (40, 96, 6, 1)]


def _case(S, C, k, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, (S, C)).astype(np.float32)
    d[rng.random((S, C)) < 0.3] = PS.BIG
    i = rng.integers(0, 10_000, (S, C)).astype(np.int32)
    return d, i


def _port(d, i, k):
    od, oi = TS.k_smallest(torch.from_numpy(d), torch.from_numpy(i), k)
    return od.numpy(), oi.numpy()


@pytest.mark.parametrize("S,C,k,seed", CASES)
def test_matches_pallas_interpret(S, C, k, seed):
    d, i = _case(S, C, k, seed)
    pd, pi = PS.k_smallest(d, i, k, interpret=True)
    od, oi = _port(d, i, k)
    np.testing.assert_array_equal(od, np.asarray(pd))
    np.testing.assert_array_equal(oi, np.asarray(pi))


@pytest.mark.parametrize("S,C,k,seed", CASES)
def test_matches_xla(S, C, k, seed):
    d, i = _case(S, C, k, seed)
    xd, xi = PS.k_smallest_xla(d, i, k)
    od, oi = _port(d, i, k)
    np.testing.assert_array_equal(od, np.asarray(xd))
    np.testing.assert_array_equal(oi, np.asarray(xi))
    assert (np.diff(od, axis=1) >= 0).all()


def test_all_invalid_row():
    d = np.full((8, 32), PS.BIG, np.float32)
    i = np.arange(8 * 32, dtype=np.int32).reshape(8, 32)
    pd, pi = PS.k_smallest(d, i, 3, interpret=True)
    od, oi = _port(d, i, 3)
    assert (od >= PS.BIG).all()
    np.testing.assert_array_equal(od, np.asarray(pd))
    np.testing.assert_array_equal(oi, np.asarray(pi))


def test_ties_go_to_lowest_column():
    d = np.array([[0.5, 0.25, 0.25, 0.5, 0.25]], np.float32)
    i = np.array([[10, 11, 12, 13, 14]], np.int32)
    xd, xi = PS.k_smallest_xla(d, i, 4)
    od, oi = _port(d, i, 4)
    np.testing.assert_array_equal(oi, [[11, 12, 14, 10]])
    np.testing.assert_array_equal(oi, np.asarray(xi))
    np.testing.assert_array_equal(od, np.asarray(xd))


def test_cpu_tensor_takes_plain_version_uncounted():
    d, i = _case(16, 32, 8, 3)
    before = TS.k_smallest.launches
    od, oi = _port(d, i, 8)
    pd, pi = TS.k_smallest_plain(torch.from_numpy(d), torch.from_numpy(i), 8)
    np.testing.assert_array_equal(od, pd.numpy())
    np.testing.assert_array_equal(oi, pi.numpy())
    assert TS.k_smallest.launches == before


def test_rejects_bad_inputs():
    d = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        TS.k_smallest(d, torch.zeros(4, 8, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        TS.k_smallest(d, torch.zeros(4, 7, dtype=torch.int32), 2)
