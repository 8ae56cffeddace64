from .clock import ManualClock, SystemClock
from .elastic import ElasticTopology
from .fault_tolerance import RestartPolicy, StragglerMonitor, run_with_restarts

__all__ = [
    "RestartPolicy",
    "run_with_restarts",
    "StragglerMonitor",
    "ElasticTopology",
    "ManualClock",
    "SystemClock",
]
