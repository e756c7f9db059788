"""Feature-gate registry: named runtime behavior switches activated by
on-chain feature accounts.

A copy of firedancer_tpu/flamenco/features.py.

Reference model: src/flamenco/features/ (fd_features.h + 1,437 generated
LoC from feature_map.json) — each feature is a pubkey-addressed account
owned by the feature program; its state is `Feature { activated_at:
Option<Slot> }` (bincode).  The runtime derives a flat activation-slot
table from the account database; FD_FEATURE_DISABLED (u64 max) marks
inactive.  This build keeps the same shape declaratively: a name->pubkey
map, a Features table with enable_all/disable_all (the reference's dev
harness defaults), and from_accounts() deriving activations from funk.

Feature pubkeys are consensus constants (reference feature_map.json).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ballet.base58 import decode_32

#: sentinel activation slot: not activated (FD_FEATURE_DISABLED)
DISABLED = (1 << 64) - 1

#: the feature program that owns activation accounts
FEATURE_OWNER_ID = decode_32("Feature111111111111111111111111111111111111")

#: name -> feature account pubkey (subset of the reference's 180-entry
#: feature_map.json: the gates this runtime's surface can meaningfully
#: switch, plus well-known ids kept for wire parity)
FEATURE_IDS: dict[str, bytes] = {
    name: decode_32(b58)
    for name, b58 in {
        "versioned_tx_message_enabled":
            "3KZZ6Ks1885aGBQ45fwRcPXVBCtzUvxhUTkwKMR41Tca",
        "blake3_syscall_enabled":
            "HTW2pSyErTj4BV6KBM9NZ9VBUJVxt7sacNWcf76wtzb3",
        "curve25519_syscall_enabled":
            "7rcw5UtqgDTBBv2EcynNfYckgdAaH1MAsCjKgXMkN7Ri",
        "ed25519_program_enabled":
            "6ppMXNYLhVd7GcsZ5uV11wQEW7spppiMVfqQv5SXhDpX",
        "secp256k1_program_enabled":
            "E3PHP7w8kB7np3CTQ1qQ2tW3KCtjRSXBQgW9vM2mWv2Y",
        "system_transfer_zero_check":
            "BrTR9hzw4WBGFP65AJMbpAo64DcA3U6jdPSga9fMV5cS",
        "require_rent_exempt_accounts":
            "BkFDxiJQWZXGTZaJQxH7wVEHkAmwCgSEVkrvswFfRJPD",
        "return_data_syscall_enabled":
            "DwScAzPUjuv65TMbDnFY7AgwmotzWy3xpEJMXM3hZFaB",
        "sol_log_data_syscall_enabled":
            "6uaHcKPGUy4J7emLBgUTeufhJdiwhngW6a1R9B7c2ob9",
        "secp256k1_recover_syscall_enabled":
            "6RvdSWHh8oh72Dp7wMTS2DBkf3fRPtChfNrAo3cZZoXJ",
        "tx_wide_compute_cap":
            "5ekBxc8itEnPv4NzGJtr8BVVQLNMQuLMNQQj7pHoLNZ9",
    }.items()
}


def encode_feature_account(activated_at: int | None) -> bytes:
    """Feature account data: bincode Option<u64> activation slot."""
    if activated_at is None:
        return b"\x00"
    return b"\x01" + activated_at.to_bytes(8, "little")


def decode_feature_account(data: bytes) -> int | None:
    """-> activation slot, or None when pending/malformed."""
    if not data or data[0] == 0:
        return None
    if len(data) < 9:
        return None
    return int.from_bytes(data[1:9], "little")


@dataclass
class Features:
    """Flat activation table: name -> activation slot (DISABLED if not
    activated)."""

    slots: dict[str, int] = field(default_factory=dict)

    @classmethod
    def all_enabled(cls) -> "Features":
        """Every known feature active from slot 0 (the reference's
        fd_features_enable_all dev default)."""
        return cls({name: 0 for name in FEATURE_IDS})

    @classmethod
    def all_disabled(cls) -> "Features":
        return cls({name: DISABLED for name in FEATURE_IDS})

    def active(self, name: str, slot: int) -> bool:
        a = self.slots.get(name, DISABLED)
        return a != DISABLED and slot >= a

    def activate(self, name: str, slot: int) -> None:
        self.slots[name] = slot

    @classmethod
    def from_accounts(cls, load, default: "Features | None" = None):
        """Derive activations from feature accounts (`load(pubkey) ->
        Account | None`).  An existing feature account OVERRIDES the
        default table: pending (activated_at None) means disabled; a
        missing account keeps the default entry (dev harnesses run
        all-enabled, like the reference's)."""
        out = dict((default or cls.all_enabled()).slots)
        for name, pk in FEATURE_IDS.items():
            acct = load(pk)
            if acct is None or acct.owner != FEATURE_OWNER_ID:
                continue
            at = decode_feature_account(acct.data)
            out[name] = DISABLED if at is None else at
        return cls(out)
