"""The harness's arithmetic on hand-made inputs: percentiles, the union
of device intervals, idle gaps and their names, roofline and MFU shares,
and the frozen K5a counts against the kernel table's own."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest
import torch

from pose_bench import trace
from pose_bench.counts import k5a


@pytest.mark.parametrize("values", [[5.0], [3.0, 1.0], [1.0, 2.0, 3.0, 4.0, 10.0], list(range(1, 202))])
def test_percentile_interpolates_between_order_statistics(values):
    xs = sorted(values)
    assert trace.percentile(values, 0) == xs[0]
    assert trace.percentile(values, 100) == xs[-1]
    assert trace.percentile(values, 50) == pytest.approx(statistics.median(values))


def test_percentile_95_of_201_is_the_191st():
    assert trace.percentile(list(range(1, 202)), 95) == 191.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert trace.merge(iv) == [(0, 3), (5, 6), (9, 12)]
    assert trace.union_length(trace.clipped(iv, 1, 10)) == 2 + 1 + 1
    assert trace.gaps(iv, 1, 10) == [(3, 5), (6, 9)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def test_gaps_are_named_by_the_innermost_open_host_operation():
    host = [(0, 100, "pose_bench.pose"), (10, 40, "aten::conv2d"), (12, 20, "aten::empty"),
            (60, 80, "aten::copy_"), (200, 300, "aten::mm")]
    named = trace.name_gaps([(13, 15), (30, 34), (70, 72), (150, 154)], host)
    assert named == {"pose_bench.pose/aten::empty": 2, "pose_bench.pose/aten::conv2d": 4,
                     "pose_bench.pose/aten::copy_": 2, "idle host": 4}


def test_roofline_takes_the_larger_bound():
    # 3.35e9 bytes at 3.35 TB/s is 1 ms; 1.979e12 ops at 1,979 TOP/s is 1 ms
    assert trace.least_seconds(3.35e9, 0.0, 3.35e12, 1.979e15) == pytest.approx(1e-3)
    assert trace.roofline_pct(3.35e9, 3.958e12, 4e-3, 3.35e12, 1.979e15) == pytest.approx(50.0)
    assert trace.mfu_pct(9.89e14, 2.0, 9.89e14) == pytest.approx(50.0)


SERVED_SITES = [  # (x, w, stride, out_f32): sites of the served int8 R101 (8 x 768^2) and HRNet-W32 (128 x 512^2)
    ((8, 192, 192, 64), (1, 1, 64, 64), 1, False),
    ((8, 192, 192, 256), (1, 1, 256, 512), 2, False),
    ((8, 48, 48, 1024), (3, 3, 256, 256), 1, False),
    ((128, 256, 256, 64), (3, 3, 64, 64), 2, False),
    ((128, 128, 128, 32), (3, 3, 32, 32), 1, False),
    ((128, 16, 16, 256), (1, 1, 256, 128), 1, False),
    ((128, 128, 128, 32), (1, 1, 32, 11), 1, True),
]


@pytest.mark.parametrize("x, w, stride, out_f32", SERVED_SITES)
def test_k5a_counts_equal_the_kernel_tables(x, w, stride, out_f32):
    smoke = pytest.importorskip("chip_smoke")
    from spacecraft_pose_estimation_tpu_torch.ops import int8_conv

    cout = w[3]
    a = {"x": torch.empty(x, dtype=torch.int8), "w": torch.empty(w, dtype=torch.int8), "stride": stride,
         "out_f32": out_f32, "m": torch.empty(cout), "b": torch.empty(cout)}
    assert k5a.conv_numbers(x, w, stride, out_f32) == smoke.conv_numbers(SimpleNamespace(int8_conv=int8_conv), a)


def test_k5a_tally_counts_each_launch():
    calls = []
    module = SimpleNamespace(int8_conv=lambda *a, **kw: calls.append((a, kw)))
    x, w = torch.empty(2, 8, 8, 4, dtype=torch.int8), torch.empty(3, 3, 4, 16, dtype=torch.int8)
    with k5a.Tally(module) as tally:
        module.int8_conv(x, w, torch.empty(16), torch.empty(16), stride=2, relu=True)
        module.int8_conv(x, w, torch.empty(16), torch.empty(16), out_f32=True)
    assert tally.launches == 2 and len(calls) == 2
    b1, o1 = k5a.conv_numbers(x.shape, w.shape, 2, False)
    b2, o2 = k5a.conv_numbers(x.shape, w.shape, 1, True)
    assert (tally.bytes, tally.ops) == (b1 + b2, o1 + o2)
    assert o1 == 2.0 * 2 * 4 * 4 * 16 * 9 * 4


def test_fp8_control_rounds_to_e4m3_at_each_scale():
    from pose_bench.reference.quant import fake_fp8

    x = torch.tensor([[448.0, -1.0, 0.0123], [2.0, 0.5, -0.25]])
    row = fake_fp8(x, dim=1)
    assert row[0, 0] == 448.0 and row[1].tolist() == [2.0, 0.5, -0.25]  # e4m3 values at their row's scale
    y = torch.linspace(-3.0, 3.0, 1001)
    err = (fake_fp8(y) - y).abs() / y.abs().clamp(min=1e-3)
    assert err[y.abs() > 0.1].max() <= 2.0**-4  # three mantissa bits: half a step is 2^-4 of the value
