from .pcair import PCAIR
from .hierarchy import DeviceHierarchy, Hierarchy, LevelData, setup_hierarchy
from .smooth import fc_point_richardson, vcycle_full, vcycle_kaskade
from .stats import compute_stats, print_stats

__all__ = ["PCAIR", "DeviceHierarchy", "Hierarchy", "LevelData",
           "setup_hierarchy", "fc_point_richardson", "vcycle_full",
           "vcycle_kaskade", "compute_stats", "print_stats"]
