from .base import Budget, BudgetExhausted, Trial, TuneResult, Tuner, TuningContext
from .classic import AnnealingTuner, GeneticTuner, GridTuner, RandomTuner
from .gbfs import GBFSTuner
from .gbt import GBTTuner, GradientBoostedTrees
from .na2c import NA2CTuner
from .rnn_controller import RNNControllerTuner

#: the JAX package's eight tuners, under its names
TUNERS = {
    "g-bfs": GBFSTuner,
    "n-a2c": NA2CTuner,
    "xgboost-like": GBTTuner,
    "rnn-controller": RNNControllerTuner,
    "random": RandomTuner,
    "grid": GridTuner,
    "sim-anneal": AnnealingTuner,
    "genetic": GeneticTuner,
}

__all__ = [
    "Budget",
    "Trial",
    "TuneResult",
    "Tuner",
    "TuningContext",
    "BudgetExhausted",
    "GBFSTuner",
    "NA2CTuner",
    "GBTTuner",
    "GradientBoostedTrees",
    "RNNControllerTuner",
    "RandomTuner",
    "GridTuner",
    "AnnealingTuner",
    "GeneticTuner",
    "TUNERS",
]
