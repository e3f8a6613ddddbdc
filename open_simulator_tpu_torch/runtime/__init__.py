"""Execution-guard runtime: deadline budgets, the error taxonomy, fault
injection, retrying external I/O, the resumable planning journal
(`journal.py`) and the chunked executor of device work (`guard.py`,
imported where it is used).
"""

from .budget import Budget, sigint_to_budget
from .errors import (
    EXIT_INFEASIBLE,
    EXIT_INPUT_ERROR,
    EXIT_INTERRUPTED,
    EXIT_OK,
    EXIT_PARTIAL_DEADLINE,
    BackendUnavailable,
    CompileFailure,
    ConformanceError,
    DeadlineExceeded,
    DeviceOOM,
    ExecutionHalted,
    ExternalIOError,
    GuardError,
    Interrupted,
)
from .inject import INJECT, InjectedCrash
from .journal import Journal, JournalMismatch

__all__ = [
    "INJECT",
    "InjectedCrash",
    "Journal",
    "JournalMismatch",
    "Budget",
    "sigint_to_budget",
    "GuardError",
    "DeviceOOM",
    "CompileFailure",
    "BackendUnavailable",
    "ConformanceError",
    "DeadlineExceeded",
    "Interrupted",
    "ExecutionHalted",
    "ExternalIOError",
    "EXIT_OK",
    "EXIT_INFEASIBLE",
    "EXIT_INPUT_ERROR",
    "EXIT_PARTIAL_DEADLINE",
    "EXIT_INTERRUPTED",
]
