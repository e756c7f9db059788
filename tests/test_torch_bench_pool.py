"""The port's transfer corpus (tiles/bench.py::make_transfer_pool) against
the JAX package's, byte for byte.

The JAX corpus signs with its device batch signer, whose base
multiplication compiles for minutes on a CPU; here its two calls
(`public_keys`, `sign_many` on firedancer_tpu.tiles.bench's `dsign`) are
replaced by golden's, which give the same bytes (tests/test_bench_pool.py
holds sign_batch against golden.sign).  The port signs with its own
ops/ed25519/sign.py, the plain version on the CPU."""

import numpy as np
import pytest

from firedancer_tpu.ops.ed25519 import golden as GJ
from firedancer_tpu.tiles import bench as BJ
from firedancer_tpu_torch.ballet import txn as T
from firedancer_tpu_torch.ops.ed25519 import golden
from firedancer_tpu_torch.tiles import bench as TB
from firedancer_tpu_torch.tiles import wire
from firedancer_tpu_torch.tiles.synth import SynthTile


class _GoldenSigner:
    """public_keys / sign_many with golden's bytes (the JAX signer's)."""

    @staticmethod
    def public_keys(secrets, **_kw):
        return [GJ.public_from_secret(s) for s in secrets]

    @staticmethod
    def sign_many(pairs, pubs=None, **_kw):
        return [GJ.sign(sk, m) for sk, m in pairs]


@pytest.fixture(scope="module")
def pools():
    mp = pytest.MonkeyPatch()
    mp.setattr(BJ, "dsign", _GoldenSigner)
    try:
        want = BJ.make_transfer_pool(24, n_signers=5, seed=8, amount_base=3)
    finally:
        mp.undo()
    got = TB.make_transfer_pool(24, n_signers=5, seed=8, amount_base=3, device="cpu")
    return got, want


def test_transfer_pool_matches_jax(pools):
    (rows, pubs), (rows_j, pubs_j) = pools
    assert rows.dtype == np.uint8 and rows.shape == rows_j.shape
    assert np.array_equal(rows, rows_j)
    assert pubs == pubs_j
    assert TB.SYSTEM_PROGRAM_ID == bytes(32)


def test_transfer_pool_is_distinct_and_signed(pools):
    (rows, pubs), _ = pools
    n = len(rows)
    assert len({rows[i, 1:65].tobytes() for i in range(n)}) == n
    payers = set()
    for i in range(n):
        payload = rows[i].tobytes()
        d = T.parse(payload)
        assert d is not None and d.signature_cnt == 1
        payer = bytes(d.acct_addr(payload, 0))
        payers.add(payer)
        assert payer == pubs[i % len(pubs)]
        assert golden.verify(d.message(payload), payload[1:65], payer) == 0
    assert len(payers) == 5


def test_wire_pool_feeds_the_synth(pools):
    (rows, _), _ = pools
    wrows, szs, good = TB.wire_pool(rows)
    assert wrows.shape == (len(rows), wire.LINK_MTU) and good.all()
    assert (szs == rows.shape[1] + wire.TRAILER_SZ).all()
    tr = wire.parse_trailers(wrows, szs.astype(np.int64))
    for i in range(len(rows)):
        assert wrows[i, : rows.shape[1]].tobytes() == rows[i].tobytes()
        d = T.parse(rows[i].tobytes())
        assert tr["sig_off"][i] == d.signature_off and tr["msg_off"][i] == d.message_off
    synth = SynthTile(wrows, szs)
    want = rows[:, 1:9].copy().view("<u8")[:, 0]
    assert np.array_equal(synth.tags, want)


def test_udp_blaster_is_refused():
    """UdpBlaster delivers every row, in order, to a loopback socket within
    its window: the reader feeds `landed` and the sender never has more
    than window + burst datagrams in flight.  Rows are u8 array rows or
    bytes of different sizes."""
    import socket
    import time

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, 256, 40 + i, np.uint8).tobytes() for i in range(48)]
    rows += list(rng.integers(0, 256, (16, 64), np.uint8))
    window, burst = 8, 4
    b = TB.UdpBlaster(rows, rx.getsockname(), burst=burst, window=window)
    assert not b.done
    b.start()
    got, peak = [], 0
    try:
        while len(got) < len(rows):
            data, _ = rx.recvfrom(2048)
            got.append(data)
            peak = max(peak, b.sent - len(got))
            b.landed = len(got)
        deadline = time.monotonic() + 5.0
        while not b.done and time.monotonic() < deadline:
            time.sleep(1e-3)
    finally:
        b.stop()
        rx.close()
    assert b.done and b.sent == len(rows)
    assert got == [r if isinstance(r, bytes) else r.tobytes() for r in rows]
    assert peak <= window + burst
