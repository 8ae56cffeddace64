from .clock import ManualClock, SystemClock

__all__ = ["ManualClock", "SystemClock"]
