"""The port's K-min select (hybridneuralrendering_tpu_torch/ops/select.py)
against the JAX package's Pallas kernel, run in interpret mode, and its XLA
twin, on the three cases of tests/test_pallas_select.py.  Selection does no
arithmetic, so the distances must be equal, not close; ids must be equal
too, since both sides break ties toward the lowest column.

`kernel_model` is a numpy model of csrc/k_smallest.cu's thread-per-row
path: a sorted list of the min(K, C) smallest (value, column) pairs, filled
in column order, and the closed-form fill rule for rows with fewer than K
entries below BIG.  It is held against all three on
the edge rows of tests/torch_port_select_rows.py."""

import numpy as np
import pytest
import torch

from hybridneuralrendering_tpu.ops import pallas_select as PS
from hybridneuralrendering_tpu_torch.ops import select as TS
from torch_port_select_rows import edge_rows

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


def kernel_model(d, ids, k):
    """The kernel's algorithm on the host: each value inserted in column
    order after the equal values before it, the list cut to min(k, C)."""
    S, C = d.shape
    big = np.float32(TS.BIG)
    out_d = np.empty((S, k), np.float32)
    out_i = np.empty((S, k), np.int32)
    for r in range(S):
        L = []                                  # ascending (value, column)
        for c in range(C):
            j = sum(v <= d[r, c] for v, _ in L)
            L.insert(j, (d[r, c], c))
            del L[min(k, C):]
        n = sum(v < big for v, _ in L)
        F = [c for _, c in L[:n]]
        if n < len(L) and L[n][0] == big:
            F.append(L[n][1])
        picks = L[:n]
        if F:
            picks += [(big, min(F))] * (k - n)
        else:                                   # n = 0, every entry > BIG
            picks = [L[0]] + [(big, L[0][1])] * (k - 1)
        out_d[r] = [v for v, _ in picks]
        out_i[r] = [ids[r, c] for _, c in picks]
    return out_d, out_i


def _pallas_padded(d, i):
    """The rows as the Pallas kernel's body sees them: columns padded to a
    multiple of 128 with BIG and id -1.  The padding is a BIG column, so a
    row with no entry at or below BIG picks it where the unpadded rule
    picks the row's own smallest."""
    S, C = d.shape
    C_pad = -(-C // 128) * 128
    dp = np.full((S, C_pad), PS.BIG, np.float32)
    ip = np.full((S, C_pad), -1, np.int32)
    dp[:, :C], ip[:, :C] = d, i
    return dp, ip


@pytest.mark.parametrize("C,k", [(C, k) for C in (5, 32, 33, 64)
                                 for k in (4, 8)] + [(1, 4), (1, 8), (3, 4)])
def test_kernel_model_on_edge_rows(C, k):
    d, i = edge_rows(C, k, seed=C * 100 + k)
    md, mi = kernel_model(d, i, k)
    xd, xi = PS.k_smallest_xla(d, i, k)
    pd, pi = TS.k_smallest_plain(torch.from_numpy(d), torch.from_numpy(i), k)
    for ref_d, ref_i in ((xd, xi), (pd.numpy(), pi.numpy())):
        np.testing.assert_array_equal(md, np.asarray(ref_d))
        np.testing.assert_array_equal(mi, np.asarray(ref_i))
    kd, ki = PS.k_smallest(d, i, k, interpret=True)
    md, mi = kernel_model(*_pallas_padded(d, i), k)
    np.testing.assert_array_equal(md, np.asarray(kd))
    np.testing.assert_array_equal(mi, np.asarray(ki))
