"""`@hot_path`: the marker for the port's device dispatch path.

The counterpart of firedancer_tpu/utils/hotpath.py.  The marker is a no-op
at run time (it only records metadata on the function); its value is the
contract it declares, which firedancer_tpu_torch.analysis.purity enforces by
AST:

  * no host synchronization inside the marked function (`.item()`,
    `.cpu()`, `.tolist()`, `.numpy()`, `bool(t)` / `int(t)` on a tensor,
    `torch.cuda.synchronize()`, `np.asarray` / `np.array` /
    `np.frombuffer`): PyTorch launches asynchronously on the card, the
    caller (the verify pool's land, the step's owner) holds the one
    device-to-host sync, and a hidden sync inside device code serializes
    the batches a pool keeps in flight;
  * no Python floats: the crypto and dedup math is exact integer
    arithmetic, so a float is a nondeterminism bug.

Usage:

    @hot_path(static=("txn_limit",))
    def select_impl(..., txn_limit): ...

`static` names arguments that are host values (Python ints), so `int(x)`
or `bool(x)` on them is not a sync and is exempt.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def hot_path(fn: F | None = None, *, static: tuple[str, ...] = ()) -> F:
    """Mark `fn` as hot-path code (see module docstring).  Usable bare
    (`@hot_path`) or configured (`@hot_path(static=("flag",))`)."""

    def mark(f: F) -> F:
        f.__fdt_hot_path__ = {"static": tuple(static)}
        return f

    return mark(fn) if fn is not None else mark
