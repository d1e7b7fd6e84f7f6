"""The kernels' one door on the CPU: the loader builds and binds each
source once, and the launch ledger gives every reader its view
(``ops.launch_counts()``, ``measured.worker_stats()``, by role and by
dtype)."""

import collections
import sys
import threading
import time
from unittest import mock

import pytest
import torch

from repro_torch.core.cost import measured
from repro_torch.kernels import build, flash_attention, gemm, ops, ssd
from repro_torch.kernels.ledger import launch_role, launches, note_launch, reset_launches

#: a launch of each kind: its dims and its operands' dtype
KINDS = {"gemm": ((256, 512, 1024), torch.bfloat16),
         "flash": ((4096, 4096, 128), torch.float32),
         "ssd": ((256, 128), torch.bfloat16)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_the_ledger_gives_each_reader_its_view(kind):
    dims, dtype = KINDS[kind]
    name = str(dtype).removeprefix("torch.")
    reset_launches()
    with launch_role("dB"):
        note_launch(kind, dims, dtype)
    note_launch(kind, dims, dtype)
    assert ops.launch_counts() == collections.Counter({(kind, dims): 2})
    assert launches(kind) == collections.Counter({dims: 2})
    assert launches(kind, "role", "dims") == collections.Counter(
        {("dB", dims): 1, ("forward", dims): 1})
    assert launches(kind, "dtype") == collections.Counter({name: 2})
    # worker_stats: GEMM and flash launches by shape, flash's by dtype
    want = {"gemm_launches": {}, "flash_launches": {}, "flash_dtype_launches": {}}
    if kind != "ssd":
        want[f"{kind}_launches"] = {"x".join(map(str, dims)): 2}
    if kind == "flash":
        want["flash_dtype_launches"] = {name: 2}
    stats = measured.worker_stats()
    assert {k: stats[k] for k in want} == want
    # launches from many threads at once: none lost, each under its own thread's role
    reset_launches()

    def launch(role):
        with launch_role(role):
            for _ in range(500):
                note_launch(kind, dims, dtype)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(f"r{i % 2}",)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launches(kind, "role") == collections.Counter({"r0": 4000, "r1": 4000})
    reset_launches()
    stats = measured.worker_stats()
    assert not ops.launch_counts() and not launches(kind, "role") and not launches(kind, "dtype")
    assert not (stats["gemm_launches"] or stats["flash_launches"]
                or stats["flash_dtype_launches"])


def test_the_loader_builds_and_binds_each_source_once(monkeypatch):
    """Each wrapper's ``build_kernel()`` loads its source through the one
    loader: built and bound at the first call, from any number of
    threads at once, and the same library and report after."""
    built = []

    def build_library(source):
        built.append(source)
        time.sleep(0.05)  # a build takes a while: the other threads wait
        return mock.MagicMock(), f"ptxas {source}"

    monkeypatch.setattr(build, "build_library", build_library)
    monkeypatch.setattr(build, "_LOADED", {})
    wrappers = (gemm, flash_attention, ssd)
    threads = [threading.Thread(target=w.build_kernel) for w in wrappers for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(built) == ["flash_attention.cu", "gemm.cu", "ssd.cu"]
    for w in wrappers:
        lib, log = w.build_kernel()
        assert w.build_kernel()[0] is lib and log.startswith("ptxas ")
    assert len(built) == 3
