"""Reading a trace: busy seconds, time by kernel, idle gaps by host event."""

import pytest

from perfbench.trace import TRACED_RANGE, Event, summarize


def ev(name, start, dur, dev=True):
    return Event(name, start, dur, dev)


def test_busy_union_names_and_gaps():
    events = [
        ev(TRACED_RANGE, 1000, 10_000, dev=False),
        ev("serve.prefill", 1000, 5000, dev=False),
        ev("aten::index_put_", 3000, 1500, dev=False),
        ev("void gemm_tiled_wgmma<64, 2, 256>(bf16 const*)", 1500, 1000),
        ev("void gemm_tiled_wgmma<64, 2, 256>(bf16 const*)", 2000, 1000),  # overlaps
        ev("void flash_fwd_bf16<128, 128>(x)", 5000, 2000),
        ev("Memcpy DtoH", 9000, 500),
        ev("void gemm_tiled_stream<256>(a)", 20_000, 100),  # after the range: not counted
    ]
    s = summarize(events)
    assert s.window_s == pytest.approx(10e-6)
    assert s.busy_s == pytest.approx((1500 + 2000 + 500) * 1e-9)  # [1500,3000) [5000,7000) [9000,9500)
    assert s.device_s("gemm_tiled") == pytest.approx(2000e-9)
    assert s.device_s("flash_fwd") == pytest.approx(2000e-9)
    assert s.top_ops(2)[0][0] in ("void gemm_tiled_wgmma<64, 2, 256>", "void flash_fwd_bf16<128, 128>")
    # gaps: [3000,5000) 2000 (mid 4000: index_put_ inside prefill), [7000,9000) 2000,
    # [1000,1500) 500, [9500,11000) 1500
    assert [round(g[1] * 1e9) for g in s.gaps] == [2000, 2000, 1500, 500]
    assert s.gaps[0][0] == "aten::index_put_"
    assert s.gaps[1][0] == "no host event"


def test_no_device_work_reads_nothing():
    s = summarize([ev(TRACED_RANGE, 0, 100, dev=False)])
    assert s.busy_s == 0 and s.by_name == {} and s.gaps == []
