from .analytical import AnalyticalHopperCost
from .base import CostBackend, CountingCost, SleepingCost, backend_from_spec
from .flash_analytical import FlashAnalyticalHopperCost
from .measured import HopperTimedCost

__all__ = [
    "CostBackend", "CountingCost", "SleepingCost", "backend_from_spec", "AnalyticalHopperCost",
    "FlashAnalyticalHopperCost", "HopperTimedCost",
]
