"""The roofline yardstick and the trace reduction on hand counts."""

import pytest
import torch

from harness import profile, yardstick
from harness.spans import PREPARE_RANGE

TRI = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])


def _planes(rows):
    t = torch.tensor(rows, dtype=torch.float32)
    return tuple(t[:, c] for c in range(3))


def test_one_triangle_hand_counts():
    acc = yardstick.build(TRI)
    assert acc.blocks == 1 and int(acc.blk_real.sum()) == 1
    assert int(acc.cl_real.sum()) == 1 and int(acc.real.sum()) == 1
    o = _planes([[0.25, 0.25, 1.0],    # hits: 1 block slab + 1 cluster
                 [5.0, 5.0, 1.0],      # misses the block's box: 1 slab
                 [0.9, 0.9, 1.0]])     # in the box, fails u + v <= 1
    d = _planes([[0, 0, -1]] * 3)
    gen = torch.Generator().manual_seed(0)
    full = sum(yardstick.STAGE_OPS)
    for i, want in ((0, 24 + 24 + full), (1, 24), (2, 24 + 24 + full - 6)):
        w = yardstick.batch_work(acc, "closest", tuple(p[i:i + 1] for p in o),
                                 tuple(p[i:i + 1] for p in d), 1e-4, 10.0,
                                 gen)
        assert w["ops"] == want
        assert w["bytes"] == 32 + 16 + 36


def test_dead_lanes_need_no_work_and_bytes_count_every_lane():
    acc = yardstick.build(TRI)
    o = _planes([[0.25, 0.25, 1.0]] * 4)
    d = _planes([[0, 0, -1]] * 4)
    gen = torch.Generator().manual_seed(0)
    w = yardstick.batch_work(acc, "any", o, d, torch.tensor(0.0),
                             torch.tensor([2.0, -1.0, -1.0, -1.0]), gen)
    assert w["ops"] == 24 + 24 + sum(yardstick.STAGE_OPS)
    assert w["bytes"] == 4 * (32 + 1) + 36
    assert w["least_s"] == max(w["ops"] / 67e12, w["bytes"] / 3.35e12)


def test_occlusion_stops_at_the_first_cluster_holding_a_hit():
    # two clusters' worth of triangles: 64 far ones (z = -2), then 64 near
    far = TRI.repeat(64, 1, 1) + torch.tensor([0.0, 0.0, -2.0])
    near = TRI.repeat(64, 1, 1)
    acc = yardstick.build(torch.cat([far, near]))
    o = _planes([[0.25, 0.25, 1.0]])
    d = _planes([[0, 0, -1]])
    gen = torch.Generator().manual_seed(0)
    any_ = yardstick.batch_work(acc, "any", o, d, 0.0, 10.0, gen)["ops"]
    closest = yardstick.batch_work(acc, "closest", o, d, 1e-4, 10.0,
                                   gen)["ops"]
    # the near cluster alone for both: the far one starts beyond the hit
    assert any_ == closest == 24 + 24 * 2 + 64 * sum(yardstick.STAGE_OPS)


def test_yardstick_is_the_same_for_any_kernel():
    """It reads only the rays and the triangles: two calls on the same
    batch give the same work."""
    g = torch.Generator().manual_seed(3)
    tris = torch.rand((300, 3, 3), generator=g)
    acc = yardstick.build(tris)
    o = tuple(torch.rand(500, generator=g) for _ in range(3))
    d = tuple(torch.rand(500, generator=g) - 0.5 for _ in range(3))
    w1 = yardstick.batch_work(acc, "closest", o, d, 1e-4, 10.0,
                              torch.Generator().manual_seed(9))
    w2 = yardstick.batch_work(acc, "closest", o, d, 1e-4, 10.0,
                              torch.Generator().manual_seed(9))
    assert w1 == w2 and w1["ops"] > 0


def _trace():
    ev = [
        dict(cat="user_annotation", name=profile.WINDOW_RANGE, ts=0, dur=100),
        dict(cat="user_annotation", name=PREPARE_RANGE, ts=10, dur=10),
        dict(cat="cpu_op", name="aten::add", ts=40, dur=30),
        # launches (host) and their kernels (device)
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=12, dur=1,
             args=dict(correlation=1)),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=25, dur=1,
             args=dict(correlation=2)),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=30, dur=1,
             args=dict(correlation=3)),
        dict(cat="kernel", name="sort_kernel", ts=20, dur=10,
             args=dict(correlation=1)),
        dict(cat="kernel", name="void (anonymous namespace)::stream_kernel"
             "<false>(float const*)", ts=30, dur=20,
             args=dict(correlation=2)),
        dict(cat="kernel", name="elementwise_kernel", ts=80, dur=10,
             args=dict(correlation=3)),
        dict(cat="gpu_memset", name="Memset", ts=45, dur=10),
    ]
    return {"traceEvents": ev}


def test_trace_reduction_on_a_hand_trace():
    s = profile.summarize(_trace())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)       # [20, 55) + [80, 90)
    assert s["launches"] == 3
    assert s["kernel_s"] == pytest.approx(40e-6)
    assert s["trace_kernel_s"] == pytest.approx(20e-6)
    assert s["prepare_kernel_s"] == pytest.approx(10e-6)
    gaps = dict(s["idle_gaps"])
    # [0, 20): mid 10 in the prepare range; [55, 80): mid 67.5 in aten::add
    assert gaps["host:" + PREPARE_RANGE] == pytest.approx(20e-6)
    assert gaps["host:aten::add"] == pytest.approx(25e-6)
    assert gaps["host:(between operations)"] == pytest.approx(10e-6)
    assert s["device_ops"][0][0].startswith("void (anonymous namespace)")


def test_device_window_on_a_hand_trace():
    """With CUDA activity alone the window runs from the first device
    operation's start to the last one's end."""
    s = profile.summarize(_trace(), window="device")
    assert s["window_s"] == pytest.approx(70e-6)      # [20, 90)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["launches"] == 3
    ev = [e for e in _trace()["traceEvents"] if e["cat"] == "cpu_op"]
    with pytest.raises(ValueError):
        profile.summarize({"traceEvents": ev}, window="device")


def test_readers_on_a_hand_context():
    from harness.manifest import load_reader

    s = profile.summarize(_trace())
    frame = dict(kind="frame", summary=s, frame_ms=[1.0, 2.0, 3.0, 4.0],
                 prepare_ms=1.5, least_s=2e-6,
                 lean=profile.summarize(_trace(), window="device"))
    assert load_reader("trace_roofline.frame")(frame) == pytest.approx(10.0)
    assert load_reader("trace_roofline.trace")(frame) is None
    assert load_reader("passes_device_ms")(frame) == pytest.approx(0.01)
    # 45 us busy in the traced frame against the window's 2.5 ms frames
    assert load_reader("device_idle_pct.frame")(frame) == pytest.approx(
        100.0 * (1.0 - 0.045 / 2.5))
    assert load_reader("frame_ms_p90")(frame) == pytest.approx(3.7)
    assert load_reader("launches_per_frame")(frame) == 3
    assert load_reader("prepare_ms.frame")(frame) == 1.5
    assert load_reader("trace_kernel_ms.frame")(frame) == pytest.approx(0.02)
    wave = dict(frame, kind="wavefront")
    assert load_reader("prepare_ms.trace")(wave) == 1.5
    assert load_reader("device_idle_pct.trace")(wave) is None
    assert load_reader("device_idle_pct.trace")(
        dict(wave, wave_ms=0.05)) == pytest.approx(10.0)
    assert load_reader("passes_device_ms")(wave) is None
    none = dict(frame, least_s=None)
    assert load_reader("trace_roofline.frame")(none) is None
