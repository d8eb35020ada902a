"""Run supervision for the mega runs: fault classification, retry with
backoff, SIGTERM preemption and the deterministic chaos drills; port of
``srnn_tpu/resilience`` (see the ``supervisor`` and ``chaos`` docstrings).
A lost host of a multi-process run exits ``EXIT_HOST_LOST`` for the
launcher's re-ramp (``distributed.launch``); the in-process topology
re-ramp onto surviving cards waits for ROADMAP.md A.6."""

from .chaos import ChaosEvent, ChaosMonkey, parse_schedule
from .supervisor import (DEVICE_LOSS, EXIT_CODE_NAMES, EXIT_HOST_LOST,
                         EXIT_PREEMPTED_CLEAN, EXIT_RECOVERED,
                         EXIT_RETRIES_EXHAUSTED, FATAL, HOST_LOSS, IO, PREEMPT,
                         RETRYABLE, STALL, AttemptContext, BackoffPolicy,
                         Preempted, Supervisor, classify_fault,
                         exit_code_for_report, preempt_requested,
                         probe_card, supervised_run)

__all__ = [
    "AttemptContext",
    "BackoffPolicy",
    "ChaosEvent",
    "ChaosMonkey",
    "DEVICE_LOSS",
    "EXIT_CODE_NAMES",
    "EXIT_HOST_LOST",
    "EXIT_PREEMPTED_CLEAN",
    "EXIT_RECOVERED",
    "EXIT_RETRIES_EXHAUSTED",
    "FATAL",
    "HOST_LOSS",
    "IO",
    "PREEMPT",
    "Preempted",
    "RETRYABLE",
    "STALL",
    "Supervisor",
    "classify_fault",
    "exit_code_for_report",
    "parse_schedule",
    "preempt_requested",
    "probe_card",
    "supervised_run",
]
