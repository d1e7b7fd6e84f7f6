"""repro_torch.core — operator-level schedule autotuning on PyTorch.

Public surface:
  SearchSpace / State / Action            — the op-agnostic MDP protocol
  GemmConfigSpace / TilingState           — the GEMM instance
  FlashAttnConfigSpace / FlashScheduleState — the flash-attention instance
  ops.* (OpSpec / get_op / OPS)           — the operator registry
  cost.*                                  — measured and analytical oracles
  analysis.* (ScheduleAnalyzer, HopperSpec) — compile-free legality verdicts
  executor.* (Simulated/Thread/ProcessExecutor) — measurement lanes
  fault.* (RetryPolicy, FaultPlan)        — failure taxonomy, retries, fault injection
  shard.* (ShardSpec)                     — sharded search over one journal
  learn.*  (RankingCostModel / ProposalFilter) — journal-trained cost models
  tuners.*                                — G-BFS, N-A2C and the paper's baselines
  TuneCheckpointer / TuneInterrupted      — crash-safe snapshots and resume
  TuningSession / Workload                — orchestration
  TuningRecords / TrialJournal            — persisted best configs and trials
"""

from .analysis import (
    ILLEGAL,
    OK,
    WASTEFUL,
    AnalysisResult,
    HopperSpec,
    ScheduleAnalyzer,
    analyzer_for_backend,
    should_prune,
)
from .config_space import Action, GemmConfigSpace, TilingState
from .cost import (
    AnalyticalHopperCost,
    CostBackend,
    CountingCost,
    FlashAnalyticalHopperCost,
    HopperTimedCost,
    SleepingCost,
)
from .executor import (
    EXECUTORS,
    LaneExecutor,
    LaneResult,
    ProcessExecutor,
    SimulatedExecutor,
    ThreadExecutor,
    make_executor,
)
from .fault import (
    PERMANENT_KINDS,
    TRANSIENT_KINDS,
    FaultInjectionCost,
    FaultPlan,
    RetryPolicy,
    classify_error,
)
from .flash_space import FlashAttnConfigSpace, FlashScheduleState
from .learn import (
    JournalDataset,
    ProposalFilter,
    RankingCostModel,
    build_dataset,
    learn_cache_dir_for,
)
from .measure import MeasureEngine, MeasureOutcome, MeasureStats
from .ops import OPS, OpSpec, get_op, op_names, register_op
from .records import (
    TrialJournal,
    TuningRecords,
    global_records,
    parse_workload_key_generic,
    set_global_records,
    workload_key_for,
)
from .session import ArchTuneReport, TuningSession, Workload
from .shard import (
    ShardSpec,
    await_markers,
    elect_best,
    parse_shard,
    read_done_markers,
    shard_dir_for,
    shard_of,
    write_done_marker,
)
from .snapshot import TuneCheckpointer, TuneInterrupted
from .space import FactoredSearchSpace, SearchSpace, State, state_from_lists
from .tuners import (
    TUNERS,
    AnnealingTuner,
    Budget,
    GBFSTuner,
    GBTTuner,
    GeneticTuner,
    GridTuner,
    NA2CTuner,
    RandomTuner,
    RNNControllerTuner,
    Trial,
    TuneResult,
    Tuner,
)

__all__ = [
    "ILLEGAL", "OK", "WASTEFUL", "AnalysisResult", "HopperSpec",
    "ScheduleAnalyzer", "analyzer_for_backend", "should_prune",
    "Action", "GemmConfigSpace", "TilingState",
    "FlashAttnConfigSpace", "FlashScheduleState",
    "AnalyticalHopperCost", "CostBackend", "CountingCost",
    "FlashAnalyticalHopperCost", "HopperTimedCost", "SleepingCost",
    "EXECUTORS", "LaneExecutor", "LaneResult", "ProcessExecutor",
    "SimulatedExecutor", "ThreadExecutor", "make_executor",
    "PERMANENT_KINDS", "TRANSIENT_KINDS", "FaultInjectionCost", "FaultPlan",
    "RetryPolicy", "classify_error",
    "JournalDataset", "ProposalFilter", "RankingCostModel", "build_dataset",
    "learn_cache_dir_for",
    "ShardSpec", "await_markers", "elect_best", "parse_shard",
    "read_done_markers", "shard_dir_for", "shard_of", "write_done_marker",
    "MeasureEngine", "MeasureOutcome", "MeasureStats",
    "OPS", "OpSpec", "get_op", "op_names", "register_op",
    "TrialJournal", "TuningRecords", "global_records",
    "parse_workload_key_generic", "set_global_records", "workload_key_for",
    "ArchTuneReport", "TuningSession", "Workload",
    "FactoredSearchSpace", "SearchSpace", "State", "state_from_lists",
    "TuneCheckpointer", "TuneInterrupted",
    "TUNERS", "Budget", "Trial", "TuneResult", "Tuner", "GBFSTuner", "NA2CTuner",
    "GBTTuner", "RNNControllerTuner", "RandomTuner", "GridTuner", "AnnealingTuner",
    "GeneticTuner",
]
