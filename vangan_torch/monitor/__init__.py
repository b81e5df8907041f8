from vangan_torch.monitor.tb import TBSummary  # noqa: F401
from vangan_torch.monitor.gan_monitor import GanMonitor  # noqa: F401
