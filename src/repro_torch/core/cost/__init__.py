from .analytical import AnalyticalHopperCost
from .base import CostBackend, CountingCost
from .flash_analytical import FlashAnalyticalHopperCost
from .measured import HopperTimedCost

__all__ = [
    "CostBackend", "CountingCost", "AnalyticalHopperCost",
    "FlashAnalyticalHopperCost", "HopperTimedCost",
]
