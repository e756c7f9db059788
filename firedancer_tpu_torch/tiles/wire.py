"""Inter-tile wire format for the ingress pipeline.

A copy of firedancer_tpu/tiles/wire.py, without the numpy lane expansion
(expand_native does it natively).

Reference model: the quic tile publishes payload + parsed fd_txn_t + sz as
one dcache entry (FD_TPU_DCACHE_MTU = 2086, src/disco/fd_disco_base.h:31-35)
so downstream tiles never re-parse.  Our equivalent is leaner: the parse
descriptor fields the verify/dedup/pack tiles actually need are packed into
a fixed 16-byte trailer appended to the raw txn bytes:

    [ txn bytes (txn_sz)
      | u16 sig_off | u16 pub_off | u16 msg_off | u16 msg_len | u16 txn_sz
      | u8 sig_cnt | u8 acct_cnt | u8 ro_signed_cnt | u8 ro_unsigned_cnt
      | u16 blockhash_off ]

frag.sz = txn_sz + 16.  All trailer fields are little-endian, and every
consumer extracts them with vectorized numpy gathers — no per-frag Python
on the hot path.
"""

from __future__ import annotations

import numpy as np

from ..ballet import txn as T
from ..tango import rings as R

TRAILER_SZ = 16
#: dcache MTU for pipeline links carrying txn+trailer payloads
LINK_MTU = T.MTU + TRAILER_SZ


def expand_native(
    dcache: R.DCache,
    frags: np.ndarray,
    msg_width: int,
    with_digests: bool = False,
    with_msgs: bool = True,
) -> dict:
    """One native call: dcache gather + trailer parse + per-sig lane
    expansion + dedup tags + (optionally) the SHA512(R||A||M) k-digests
    (fdt_verify_expand) — the verify tile's whole host prep, GIL-released (the
    SHA-512 is the ring library's fdt_sha512.c).

    with_msgs=False skips the per-lane message copy entirely (the digest
    path never ships messages to the device).

    Returns dict(rows, szs, sig_cnt, tags, sigs, pubs, txn_idx
    [, msgs, lens][, digests]) with lane arrays truncated to the lane
    count."""
    chunks = np.ascontiguousarray(frags["chunk"], np.uint32)
    szs = np.ascontiguousarray(frags["sz"], np.uint16)
    n = len(chunks)
    width = dcache.mtu
    # worst-case lanes/txn: the C bounds check admits sig_cnt only while
    # 64*cnt fits inside the payload, i.e. cnt <= (width - TRAILER_SZ)/64
    max_lanes = n * max((width - TRAILER_SZ) // 64, 1)
    rows = np.empty((n, width), np.uint8)
    msgs = np.empty((max_lanes, msg_width), np.uint8) if with_msgs else None
    lens = np.empty(max_lanes, np.int32) if with_msgs else None
    sigs = np.empty((max_lanes, 64), np.uint8)
    pubs = np.empty((max_lanes, 32), np.uint8)
    txn_idx = np.empty(max_lanes, np.int32)
    sig_cnt = np.empty(n, np.int32)
    tags = np.empty(n, np.uint64)
    digests = np.empty((max_lanes, 64), np.uint8) if with_digests else None
    lanes = R._lib.fdt_verify_expand(
        R._ptr(dcache.mem), chunks.ctypes.data, szs.ctypes.data, n, width,
        rows.ctypes.data, msg_width,
        msgs.ctypes.data if msgs is not None else None,
        lens.ctypes.data if lens is not None else None,
        sigs.ctypes.data, pubs.ctypes.data, txn_idx.ctypes.data,
        sig_cnt.ctypes.data, tags.ctypes.data,
        digests.ctypes.data if digests is not None else None,
    )
    out = dict(
        rows=rows, szs=szs, sig_cnt=sig_cnt.astype(np.int64), tags=tags,
        sigs=sigs[:lanes], pubs=pubs[:lanes], txn_idx=txn_idx[:lanes],
    )
    if msgs is not None:
        out["msgs"] = msgs[:lanes]
        out["lens"] = lens[:lanes]
    if digests is not None:
        out["digests"] = digests[:lanes]
    return out


def append_trailer(payload: bytes, desc: T.TxnDesc) -> bytes:
    """Producer side (synth/quic tile): serialize the trailer."""
    n = len(payload)
    tr = np.zeros(TRAILER_SZ, dtype=np.uint8)
    u16 = tr[:10].view("<u2")
    u16[0] = desc.signature_off
    u16[1] = desc.acct_addr_off
    u16[2] = desc.message_off
    u16[3] = n - desc.message_off
    u16[4] = n
    tr[10] = desc.signature_cnt
    tr[11] = desc.acct_addr_cnt
    tr[12] = desc.readonly_signed_cnt
    tr[13] = desc.readonly_unsigned_cnt
    tr[14:16].view("<u2")[0] = desc.recent_blockhash_off
    return payload + tr.tobytes()


def parse_trailers(rows: np.ndarray, szs: np.ndarray) -> dict[str, np.ndarray]:
    """Vectorized trailer extraction from gathered (n, width) payload rows.

    Returns int32 arrays per trailer field.
    """
    n = len(rows)
    base = (szs.astype(np.int64) - TRAILER_SZ)[:, None]
    idx = base + np.arange(TRAILER_SZ, dtype=np.int64)[None, :]
    tb = rows[np.arange(n)[:, None], idx].astype(np.int32)
    u16 = tb[:, 0:10:2] | (tb[:, 1:10:2] << 8)
    return {
        "sig_off": u16[:, 0],
        "pub_off": u16[:, 1],
        "msg_off": u16[:, 2],
        "msg_len": u16[:, 3],
        "txn_sz": u16[:, 4],
        "sig_cnt": tb[:, 10],
        "acct_cnt": tb[:, 11],
        "ro_signed_cnt": tb[:, 12],
        "ro_unsigned_cnt": tb[:, 13],
        "bh_off": tb[:, 14] | (tb[:, 15] << 8),
    }
