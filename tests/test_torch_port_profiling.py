"""``pggan_tpu_torch/utils/profiling.py`` on a CPU profiler window: rows per
operator with counts and times, the per-step total, the printed summary,
the busy share's interval union and the grouping of the card's kernel
names. On the card the same functions read the CUDA kernels
(``chip_smoke.py`` phases 4 and 8); a CPU window gives no device number."""

import torch
import torch.nn.functional as F

from pggan_tpu_torch.utils import profiling


def _work(steps=3):
    x, w = torch.randn(2, 4, 16, 16), torch.randn(8, 4, 3, 3)

    def run():
        for _ in range(steps):
            F.conv2d(x, w, padding=1).relu_()
    return run


def test_kernel_rows_count_and_time_each_operator():
    rows = profiling.capture_kernel_stats(_work(3), device="cpu")
    by_name = {r["name"]: r for r in rows}
    assert by_name["aten::conv2d"]["count"] == 3
    assert by_name["aten::relu_"]["count"] == 3
    assert all(r["device_time_us"] >= 0 for r in rows)
    times = [r["device_time_us"] for r in rows]
    assert times == sorted(times, reverse=True)
    assert profiling.self_time_ms_per_step(_work(3), 3, device="cpu") > 0


def test_summarize_prints_groups_and_top_rows():
    rows = [{"name": "void conv3x3_kernel<16, 1>(float*)", "count": 4,
             "device_time_us": 3000.0, "group": "conv3x3 kernel"},
            {"name": "void avgpool2x_vec<float>(uint4 const*)", "count": 2,
             "device_time_us": 1000.0, "group": "pool kernel"}]
    lines = []
    profiling.summarize(rows, 2, top=1, log=lines.append)
    assert lines[0] == ("total device time: 4.000 ms over 2 steps -> "
                        "2.000 ms/step")
    assert any("75.0%" in ln and "conv3x3 kernel" in ln for ln in lines)
    top = lines[lines.index("--- top kernels by device time:") + 1:]
    assert len(top) == 1 and "x2" in top[0] and "conv3x3_kernel" in top[0]


def test_busy_share_is_the_union_of_intervals():
    assert profiling.busy_us([(5, 6), (0, 2), (1, 3), (2.5, 2.7)]) == 4
    assert profiling.busy_us([]) == 0


def test_device_profile_of_a_cpu_window():
    prof, wall_ms = profiling.capture(_work(4), device="cpu")
    lines = []
    out = profiling.device_profile(prof, wall_ms, 4, "cpu window", "step",
                                   device="cpu", log=lines.append)
    assert lines[0].startswith("  cpu window: ")
    assert 0 < out["device_busy_share"] <= 1.05
    assert out["wall_ms_per_step"] == wall_ms / 4
    assert abs(sum(out["ms_per_step_by_name"].values())
               - sum(out["ms_per_step_by_group"].values())) < 1e-9
    assert out["host_launches_per_step"] == 0  # nothing queued on a card


def test_kernel_names_fall_in_their_groups():
    names = {
        "void (anonymous namespace)::conv3x3_wgmma<16, 2>(CUtensorMap)":
            "conv3x3 kernel",
        "void (anonymous namespace)::conv3x3_dw_partial<16, 8>(CUtensorMap)":
            "conv3x3_dw kernel",
        "void (anonymous namespace)::conv3x3_dw_reduce(float const*)":
            "conv3x3_dw kernel",
        "void (anonymous namespace)::upsample2x_rows<uint2, uint4>(uint2 "
        "const*)": "upsample kernel",
        "void (anonymous namespace)::avgpool2x_vec<__nv_bfloat16>(uint4 "
        "const*)": "pool kernel",
        "void (anonymous namespace)::chain_kernel<32>(CUtensorMap)":
            "chain kernel",
        "Memcpy DtoH (Device -> Pinned)": "device-to-host copy",
        "something else": "other",
    }
    for name, group in names.items():
        assert profiling.group_of(name) == group, name
