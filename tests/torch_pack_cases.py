"""Seeded pack_select inputs for the chain's edges and a Python model of
csrc/pack_select.cu's decision order (with its step count), shared by the
CPU tests (tests/test_torch_pack.py), the card tests
(tests/test_torch_cuda.py) and chip_smoke.py.  Imports no JAX."""

import numpy as np

from firedancer_tpu_torch.ops import pack_select as PS

WINDOW = 32  # csrc/pack_select.cu PS_WINDOW
seg_rows = PS.seg_rows


def _w2(rows) -> int:
    """32-bit words a row of `rows` (32-bit or u64 words)."""
    a = np.asarray(rows)
    return a.shape[1] * a.itemsize // 4


def _row_bits(words) -> list[int]:
    """(K, W2) or (W2,) 32-bit words -> one Python int per row."""
    a = np.ascontiguousarray(np.atleast_2d(words)).view(np.uint32)
    return [int.from_bytes(r.tobytes(), "little") for r in a]


def windowed_greedy(rw, wr, in_rw, in_w, costs, cu_limit, txn_limit):
    """The kernel's decision order in Python ints: per segment of rows,
    the rows that pass against the current state (phase 1), then windows
    of WINDOW live rows, the first passer taken and the next window right
    after it, a window with none retired whole.  Rows of 32-bit or u64
    words.  -> (take, steps)."""
    rws, ws = _row_bits(rw), _row_bits(wr)
    sel_rw, sel_w = _row_bits(in_rw)[0], _row_bits(in_w)[0]
    cu, taken, steps = 0, 0, 0
    take = np.zeros(len(costs), bool)

    def passes(i):
        return (not ((ws[i] & sel_rw) | (rws[i] & sel_w))
                and int(costs[i]) <= cu_limit - cu and taken < txn_limit)

    seg = seg_rows(_w2(rw))
    for s0 in range(0, len(costs), seg):
        live = [i for i in range(s0, min(s0 + seg, len(costs))) if passes(i)]
        p = 0
        while p < len(live) and taken < txn_limit:
            steps += 1
            f = next((q for q in range(p, min(p + WINDOW, len(live)))
                      if passes(live[q])), None)
            if f is None:
                p += WINDOW
                continue
            i = live[f]
            sel_rw, sel_w = sel_rw | rws[i], sel_w | ws[i]
            cu, taken = cu + int(costs[i]), taken + 1
            take[i] = True
            p = f + 1
    return take, steps


def step_bound(rw, wr, in_rw, in_w, costs, cu_limit, txn_limit, take) -> int:
    """ceil(live / 32) + takes, live counted against the starting state,
    plus one per segment after the first (each segment's last window may
    be partial); rows of 32-bit or u64 words."""
    rws, ws = _row_bits(rw), _row_bits(wr)
    s_rw, s_w = _row_bits(in_rw)[0], _row_bits(in_w)[0]
    live = sum(1 for i in range(len(costs))
               if not ((ws[i] & s_rw) | (rws[i] & s_w))
               and int(costs[i]) <= cu_limit and txn_limit > 0)
    segs = max(1, -(-len(costs) // seg_rows(_w2(rw))))
    return -(-live // WINDOW) + int(take.sum()) + segs - 1


def edge_case(case: str, K: int, W2: int, seed: int):
    """Seeded (K, W2) word rows for the chain's edges; the arguments of
    select_plain as numpy (words as int32)."""
    rng = np.random.default_rng(seed)
    one = np.uint32(1)
    rw = np.zeros((K, W2), np.uint32)
    wr = np.zeros((K, W2), np.uint32)
    in_rw = np.zeros(W2, np.uint32)
    in_w = np.zeros(W2, np.uint32)
    costs = rng.integers(1_000, 200_000, K).astype(np.int64)
    cu_limit, txn_limit = 1_500_000, 31

    def random_rows():
        for i in range(K):
            for b in rng.integers(0, W2 * 32, 3):
                rw[i, b >> 5] |= one << np.uint32(b & 31)
            b = rng.integers(0, W2 * 32)
            wr[i, b >> 5] |= one << np.uint32(b & 31)

    if case.startswith("take_at_"):
        # row 0 and rows 1..m-1 write bit 0; row m and the rest are free of
        # it: after taking row 0 the next take is live row m
        m = int(case[len("take_at_"):])
        wr[:m, 0] = one
        rw[:m, 0] = one
        for i in range(m, K):
            b = 1 + (i % (W2 * 32 - 1))
            rw[i, b >> 5] |= one << np.uint32(b & 31)
        txn_limit = 2
    elif case == "random":
        random_rows()
    elif case.startswith("txn_limit_"):
        random_rows()
        txn_limit = int(case[len("txn_limit_"):])
    elif case == "budget_exact":
        # no conflicts: the budget alone decides, and it ends at zero
        cu_limit = int(costs[: min(5, K)].sum())
    elif case == "zero_cost_cu_limit_0":
        random_rows()
        cu_limit = 0
        costs[::3] = 0
    elif case == "all_dead":
        random_rows()
        costs[:] = PS.PAD_COST
    elif case == "in_use_most":
        random_rows()
        hot = rng.random(K) < 0.9
        for i in np.flatnonzero(hot):
            in_rw |= wr[i]  # its write meets a selected bit
        in_w[:] = 0
    rw |= wr
    return (rw.view(np.int32), wr.view(np.int32), in_rw.view(np.int32),
            in_w.view(np.int32), costs, cu_limit, txn_limit)


EDGE_CASES = ["take_at_31", "take_at_32", "take_at_33", "take_at_64", "random",
              "txn_limit_1", "txn_limit_31", "budget_exact", "zero_cost_cu_limit_0",
              "all_dead", "in_use_most"]
