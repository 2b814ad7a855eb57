"""chip_smoke.pool_reductions, the host count of what one K3
coo_pool_rows launch sends to device memory, against a slot-by-slot walk
of each design it counts: the first design's flat walk of each 256-slot
tile's products (thread t takes products t, t + 256, ...; one scalar
atomic at each change of target) and the strip walk of csrc/coo_pool.cu
(one reduction per run of equal dest within a strip and column group).
Counts only: no device is involved."""

import numpy as np
import pytest
import torch

import chip_smoke as CS


def _flat_walk(dest, w, k):
    """Targets of the first design's atomics, in the order sent."""
    sent, m = [], dest.size
    for t0 in range(0, m, 256):
        rows = min(256, m - t0)
        for t in range(256):
            cur = None
            for j in range(t, rows * k, 256):
                r, c = divmod(j, k)
                if w[t0 + r] == 0:
                    continue
                o = int(dest[t0 + r]) * k + c
                if o != cur:
                    if cur is not None:
                        sent.append(cur)
                    cur = o
            if cur is not None:
                sent.append(cur)
    return sent


def _strip_walk(dest, w, k, strip):
    """Addresses (dest, column group) of the strip design's reductions."""
    sent, groups = [], -(-k // 4)
    for i0 in range(0, dest.size, strip):
        cur = None
        for i in range(i0, min(dest.size, i0 + strip)):
            if w[i] == 0:
                continue
            if dest[i] != cur:
                if cur is not None:
                    sent.append(cur)
                cur = int(dest[i])
        if cur is not None:
            sent.append(cur)
    return [(d, grp) for d in sent for grp in range(groups)]


def _chain(addresses):
    _, counts = np.unique(np.asarray(addresses), axis=0, return_counts=True)
    return int(counts.max())


@pytest.mark.parametrize("m,g,k,pad,order", [
    (3_000, 40, 16, 300, "runs"),  # packer order: runs of equal dest, then padding
    (1_000, 7, 5, 0, "runs"),
    (777, 30, 17, 50, "shuffled"),
    (515, 3, 48, 0, "runs"),
    (600, 20, 16, 0, "holes"),  # w = 0 slots inside the runs end none of them
])
def test_pool_reductions_match_the_walks(m, g, k, pad, order):
    rng = np.random.default_rng(m)
    dest = rng.integers(0, g, size=m)
    dest = np.sort(dest) if order != "shuffled" else dest
    w = rng.random(m) + 0.5
    if order == "holes":
        w[::5] = 0.0
    dest = np.concatenate([dest, np.zeros(pad, dtype=dest.dtype)]).astype(np.int32)
    w = np.concatenate([w, np.zeros(pad)]).astype(np.float32)
    flat, strips = _flat_walk(dest, w, k), _strip_walk(dest, w, k, CS.K3_STRIP)
    got = CS.pool_reductions(torch.from_numpy(dest), torch.from_numpy(w), k)
    assert got == (len(flat), int(np.bincount(flat).max()), len(strips), _chain(strips))
