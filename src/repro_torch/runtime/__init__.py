from .clock import ManualClock, SystemClock
from .fault_tolerance import RestartPolicy, StragglerMonitor, run_with_restarts

__all__ = [
    "RestartPolicy",
    "run_with_restarts",
    "StragglerMonitor",
    "ManualClock",
    "SystemClock",
]
