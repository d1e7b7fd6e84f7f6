from .analytical import AnalyticalHopperCost
from .base import CostBackend, CountingCost
from .measured import HopperTimedCost

__all__ = ["CostBackend", "CountingCost", "AnalyticalHopperCost", "HopperTimedCost"]
