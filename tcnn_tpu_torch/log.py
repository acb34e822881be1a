"""Logging with severities + redirectable callback.

Mirror of the reference's log facility (common_host.h:46-69,
src/common_host.cu:50-72): five severities, a global callback hook, default
behavior prints warnings/errors to stderr and everything under verbose mode.
"""

from __future__ import annotations

import enum
import sys
import threading


class LogSeverity(enum.IntEnum):
    Debug = 0
    Info = 1
    Success = 2
    Warning = 3
    Error = 4


_lock = threading.Lock()
_verbose = False
_callback = None


def set_verbose(flag: bool) -> None:
    global _verbose
    _verbose = bool(flag)


def verbose() -> bool:
    return _verbose


def set_log_callback(fn) -> None:
    """fn(severity: LogSeverity, message: str); None restores the default."""
    global _callback
    _callback = fn


def log(severity: LogSeverity, msg: str) -> None:
    with _lock:
        if _callback is not None:
            _callback(severity, msg)
            return
        if severity >= LogSeverity.Warning or _verbose:
            prefix = {
                LogSeverity.Debug: "DEBUG   ",
                LogSeverity.Info: "INFO    ",
                LogSeverity.Success: "SUCCESS ",
                LogSeverity.Warning: "WARNING ",
                LogSeverity.Error: "ERROR   ",
            }[severity]
            print(f"tcnn_tpu_torch: {prefix}{msg}", file=sys.stderr)


def log_debug(msg: str) -> None:
    log(LogSeverity.Debug, msg)


def log_info(msg: str) -> None:
    log(LogSeverity.Info, msg)


def log_success(msg: str) -> None:
    log(LogSeverity.Success, msg)


def log_warning(msg: str) -> None:
    log(LogSeverity.Warning, msg)


def log_error(msg: str) -> None:
    log(LogSeverity.Error, msg)
