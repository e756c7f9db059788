"""ComputeBudgetProgram instruction parsing + the pack cost model.

A copy of firedancer_tpu/ballet/compute_budget.py over the port's
ballet/txn.py and ballet/base58.py.

Behavior contract re-implemented from the reference's consensus-critical
rules (src/ballet/pack/fd_compute_budget_program.h and fd_pack_cost.h):

  * instruction kinds: 0 RequestUnitsDeprecated (u32 cu, u32 fee),
    1 RequestHeapFrame (u32, 1KiB granular), 2 SetComputeUnitLimit (u32),
    3 SetComputeUnitPrice (u64 micro-lamports/CU); each at most once per
    txn (0 counts as both 2 and 3); any violation fails the txn
  * default CU limit: 200k per non-budget instruction, capped at 1.4M
  * priority reward: ceil(cu_limit * micro_lamports_per_cu / 1e6),
    saturating
  * cost model: 720/signature + 300/writable account + instr-data-bytes/4
    + built-in per-instruction costs (BPF programs cost their CU limit)

All constants below are consensus data, not code.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import txn as T
from .base58 import decode_32

# base58 decode of ComputeBudget111111111111111111111111111111
COMPUTE_BUDGET_PROGRAM_ID = bytes(
    [
        0x03, 0x06, 0x46, 0x6F, 0xE5, 0x21, 0x17, 0x32,
        0xFF, 0xEC, 0xAD, 0xBA, 0x72, 0xC3, 0x9B, 0xE7,
        0xBC, 0x8C, 0xE5, 0xBB, 0xC5, 0xF7, 0x12, 0x6B,
        0x2C, 0x43, 0x9B, 0x3A, 0x40, 0x00, 0x00, 0x00,
    ]
)

HEAP_FRAME_GRANULARITY = 1024
MICRO_LAMPORTS_PER_LAMPORT = 1_000_000
DEFAULT_INSTR_CU_LIMIT = 200_000
MAX_CU_LIMIT = 1_400_000

COST_PER_SIGNATURE = 720
COST_PER_WRITABLE_ACCT = 300
INV_COST_PER_INSTR_DATA_BYTE = 4

FEE_PER_SIGNATURE = 5000  # lamports

_FLAG_SET_CU = 0x01
_FLAG_SET_FEE = 0x02
_FLAG_SET_HEAP = 0x04
_FLAG_SET_TOTAL_FEE = 0x08

_U32_MAX = (1 << 32) - 1
_U64_MAX = (1 << 64) - 1


@dataclass
class BudgetState:
    flags: int = 0
    instr_cnt: int = 0
    compute_units: int = 0
    total_fee: int = 0
    heap_size: int = 0
    micro_lamports_per_cu: int = 0

    def parse_instr(self, data: bytes) -> bool:
        """Digest one ComputeBudgetProgram instruction; False = txn fails."""
        if len(data) < 5:
            return False
        kind = data[0]
        if kind == 0:
            if len(data) != 9:
                return False
            if self.flags & (_FLAG_SET_CU | _FLAG_SET_FEE):
                return False
            self.compute_units = int.from_bytes(data[1:5], "little")
            self.total_fee = int.from_bytes(data[5:9], "little")
            if self.compute_units > MAX_CU_LIMIT:
                return False
            self.flags |= _FLAG_SET_CU | _FLAG_SET_FEE | _FLAG_SET_TOTAL_FEE
        elif kind == 1:
            if len(data) != 5:
                return False
            if self.flags & _FLAG_SET_HEAP:
                return False
            self.heap_size = int.from_bytes(data[1:5], "little")
            if self.heap_size % HEAP_FRAME_GRANULARITY:
                return False
            self.flags |= _FLAG_SET_HEAP
        elif kind == 2:
            if len(data) != 5:
                return False
            if self.flags & _FLAG_SET_CU:
                return False
            self.compute_units = int.from_bytes(data[1:5], "little")
            if self.compute_units > MAX_CU_LIMIT:
                return False
            self.flags |= _FLAG_SET_CU
        elif kind == 3:
            if len(data) != 9:
                return False
            if self.flags & _FLAG_SET_FEE:
                return False
            self.micro_lamports_per_cu = int.from_bytes(data[1:9], "little")
            self.flags |= _FLAG_SET_FEE
        else:
            return False
        self.instr_cnt += 1
        return True

    def finalize(self, total_instr_cnt: int) -> tuple[int, int]:
        """(priority_rewards_lamports, cu_limit)."""
        if self.flags & _FLAG_SET_CU:
            cu_limit = self.compute_units
        else:
            cu_limit = (total_instr_cnt - self.instr_cnt) * DEFAULT_INSTR_CU_LIMIT
        cu_limit = min(cu_limit, MAX_CU_LIMIT)
        if self.flags & _FLAG_SET_TOTAL_FEE:
            rewards = self.total_fee
        else:
            # ceil(cu_limit * price / 1e6), saturating at u64 max (Python
            # ints don't overflow, so the reference's split-multiply dance
            # collapses to one expression)
            rewards = min(
                -(-cu_limit * self.micro_lamports_per_cu // MICRO_LAMPORTS_PER_LAMPORT),
                _U64_MAX,
            )
        return rewards, cu_limit


# built-in program costs (block_cost_limits.rs values mirrored by
# fd_pack_cost.h MAP_PERFECT_0..11, consensus constants); keyed by raw
# program id.  Programs not in this table are BPF: they cost their CU
# limit.  Without this table every native-program txn would fall through
# to the 200K default CU and a block would cap at ~240 txns.
def _pid(b58: str) -> bytes:
    return decode_32(b58)


BUILTIN_COSTS: dict[bytes, int] = {
    COMPUTE_BUDGET_PROGRAM_ID: 150,
    _pid("Stake11111111111111111111111111111111111111"): 750,
    _pid("Config1111111111111111111111111111111111111"): 450,
    _pid("Vote111111111111111111111111111111111111111"): 2100,
    bytes(32): 150,  # system program
    _pid("AddressLookupTab1e1111111111111111111111111"): 750,
    _pid("BPFLoaderUpgradeab1e11111111111111111111111"): 2370,
    _pid("BPFLoader1111111111111111111111111111111111"): 1140,
    _pid("BPFLoader2111111111111111111111111111111111"): 570,
    _pid("LoaderV411111111111111111111111111111111111"): 2000,
    _pid("KeccakSecp256k11111111111111111111111111111"): 720,
    _pid("Ed25519SigVerify111111111111111111111111111"): 720,
}


@dataclass(frozen=True)
class TxnEstimate:
    rewards: int  # lamports (saturated to u32 like the reference)
    cost: int  # total cost units charged against block/account budgets
    cu_limit: int
    ok: bool


def estimate(payload: bytes, desc: T.TxnDesc) -> TxnEstimate:
    """Rewards + cost for one parsed txn (fd_pack_estimate_rewards_and_compute
    behavior, src/ballet/pack/fd_pack.c:541-580)."""
    st = BudgetState()
    data_bytes = 0
    builtin_cost = 0
    bpf = False
    for ins in desc.instr:
        data_bytes += ins.data_sz
        prog = desc.acct_addr(payload, ins.program_id)
        if prog == COMPUTE_BUDGET_PROGRAM_ID:
            if not st.parse_instr(
                payload[ins.data_off : ins.data_off + ins.data_sz]
            ):
                return TxnEstimate(0, 0, 0, False)
            builtin_cost += BUILTIN_COSTS[bytes(prog)]
        elif bytes(prog) in BUILTIN_COSTS:
            builtin_cost += BUILTIN_COSTS[bytes(prog)]
        else:
            bpf = True
    adtl_rewards, cu_limit = st.finalize(desc.instr_cnt)
    sig_rewards = FEE_PER_SIGNATURE * desc.signature_cnt
    rewards = min(sig_rewards + adtl_rewards, _U32_MAX)
    writable_cnt = len(desc.writable_idxs()) + desc.addr_table_adtl_writable_cnt
    cost = (
        COST_PER_SIGNATURE * desc.signature_cnt
        + COST_PER_WRITABLE_ACCT * writable_cnt
        + data_bytes // INV_COST_PER_INSTR_DATA_BYTE
        + builtin_cost
        + (cu_limit if bpf else 0)
    )
    return TxnEstimate(rewards, cost, cu_limit, True)
