from .base import Budget, BudgetExhausted, Trial, TuneResult, Tuner, TuningContext
from .gbfs import GBFSTuner

TUNERS = {
    "g-bfs": GBFSTuner,
}

__all__ = [
    "Budget",
    "Trial",
    "TuneResult",
    "Tuner",
    "TuningContext",
    "BudgetExhausted",
    "GBFSTuner",
    "TUNERS",
]
