"""Structured logging layer — the build's analog of src/util/log/.

A copy of firedancer_tpu/utils/log.py.

Reference behavior (fd_log, src/util/fd_util.h:46-140): 8 severity
levels DEBUG..EMERG, a dual-stream design (an "ephemeral" human stream on
stderr filtered at one level, a "permanent" log file capturing more),
per-message attribution (timestamp, thread/tile, source), and consecutive
-duplicate suppression.  Re-designed for this runtime: the tile name is a
contextvar the topology runner sets per tile thread, so every message a
tile emits is attributed without plumbing.

Usage:
    from ..utils import log
    log.init(path="fdt.log", stderr_level="NOTICE")
    log.notice("booted %d tiles", n)
    with log.scope("verify"): ...      # or log.set_tile("verify")
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time

DEBUG, INFO, NOTICE, WARNING, ERR, CRIT, ALERT, EMERG = range(8)

_NAMES = ("DEBUG", "INFO", "NOTICE", "WARNING", "ERR", "CRIT", "ALERT", "EMERG")
_LEVELS = {n: i for i, n in enumerate(_NAMES)}

_tile: contextvars.ContextVar[str] = contextvars.ContextVar(
    "fdt_log_tile", default="main"
)


class _State:
    def __init__(self):
        self.stderr_level = _LEVELS[
            os.environ.get("FDT_LOG_LEVEL_STDERR", "NOTICE").upper()
        ]
        self.file_level = _LEVELS[
            os.environ.get("FDT_LOG_LEVEL_FILE", "INFO").upper()
        ]
        self.file = None
        self.lock = threading.Lock()
        self.last_line = None
        self.dup_count = 0


_S = _State()


def init(
    path: str | None = None,
    stderr_level: str | int = "NOTICE",
    file_level: str | int = "INFO",
) -> None:
    """Open the permanent stream and set both filter levels."""
    with _S.lock:
        _S.stderr_level = _lvl(stderr_level)
        _S.file_level = _lvl(file_level)
        if _S.file is not None:
            _S.file.close()
            _S.file = None
        if path is not None:
            _S.file = open(path, "a")


def _lvl(v) -> int:
    return v if isinstance(v, int) else _LEVELS[v.upper()]


def set_tile(name: str) -> None:
    """Attribute subsequent messages on this thread to `name`."""
    _tile.set(name)


@contextlib.contextmanager
def scope(name: str):
    tok = _tile.set(name)
    try:
        yield
    finally:
        _tile.reset(tok)


def _emit(level: int, fmt: str, *args) -> None:
    if level < _S.stderr_level and (
        _S.file is None or level < _S.file_level
    ):
        return
    msg = fmt % args if args else fmt
    now = time.time()
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now))
    line = "%s.%03d %-7s %-10s %s" % (
        stamp, int(now * 1000) % 1000, _NAMES[level], _tile.get(), msg,
    )
    with _S.lock:
        # consecutive-duplicate suppression (level+tile+message identical)
        key = (level, _tile.get(), msg)
        if key == _S.last_line:
            _S.dup_count += 1
            return
        if _S.dup_count:
            rep = "... last message repeated %d times" % _S.dup_count
            _write(level, rep)
            _S.dup_count = 0
        _S.last_line = key
        _write(level, line)


def _write(level: int, line: str) -> None:
    if level >= _S.stderr_level:
        print(line, file=sys.stderr)
    if _S.file is not None and level >= _S.file_level:
        _S.file.write(line + "\n")
        _S.file.flush()


def debug(fmt, *a):
    _emit(DEBUG, fmt, *a)


def info(fmt, *a):
    _emit(INFO, fmt, *a)


def notice(fmt, *a):
    _emit(NOTICE, fmt, *a)


def warning(fmt, *a):
    _emit(WARNING, fmt, *a)


def err(fmt, *a):
    _emit(ERR, fmt, *a)


def crit(fmt, *a):
    _emit(CRIT, fmt, *a)


def alert(fmt, *a):
    _emit(ALERT, fmt, *a)


def emerg(fmt, *a):
    _emit(EMERG, fmt, *a)
