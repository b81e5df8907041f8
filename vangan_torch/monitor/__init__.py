"""Monitoring: ``TBSummary`` (``tb``), ``GanMonitor`` (``gan_monitor``), and
the spans and profiler hooks of ``profiling``. The first two load on first
use, so the layers that open spans import ``profiling`` alone."""


def __getattr__(name: str):
    if name == "TBSummary":
        from vangan_torch.monitor.tb import TBSummary
        return TBSummary
    if name == "GanMonitor":
        from vangan_torch.monitor.gan_monitor import GanMonitor
        return GanMonitor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
