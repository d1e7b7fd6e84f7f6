from .analytical import AnalyticalHopperCost
from .base import CostBackend, CountingCost, SleepingCost
from .flash_analytical import FlashAnalyticalHopperCost
from .measured import HopperTimedCost

__all__ = [
    "CostBackend", "CountingCost", "SleepingCost", "AnalyticalHopperCost",
    "FlashAnalyticalHopperCost", "HopperTimedCost",
]
