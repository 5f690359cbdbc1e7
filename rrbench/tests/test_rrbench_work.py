"""The frozen work arithmetic reproduces the bounds PERF.md records for
kernels 2 and 4 at full load, and counts less work when frames stop
early."""

import pytest
import torch

from rrbench import work

# the headline QC code: 180 variable and 90 check blocks, 540 base edges,
# z = 360, 128 frames
QC = (180, 90, 540, 360, 128)


def test_kernel2_bound_at_full_load():
    # PERF.md §6: a bf16 tanh-F/B step at [180, 360, 128] is bound at
    # 0.0149 ms by its operations; §5: a 50-step headline round at 0.743
    _, ops = work.decode_rounds_work(*QC, torch.bfloat16, torch.bfloat16,
                                     "tanhfb", frame_steps=128)
    step_s, by = work.bound(0, ops)
    assert step_s * 1e3 == pytest.approx(0.0149, abs=5e-5)
    nbytes, ops = work.decode_rounds_work(*QC, torch.bfloat16,
                                          torch.bfloat16, "tanhfb",
                                          frame_steps=50 * 128)
    call_s, by = work.bound(nbytes, ops)
    assert by == "operations"
    assert call_s * 1e3 == pytest.approx(0.743, abs=5e-4)


def test_kernel4_bound_at_full_load():
    # PERF.md §6: [7, 32400, 128] f32 phi is bound at 0.1093 ms by bytes
    nbytes, ops = work.check_phase_generic_work(7, 32400, 128, torch.float32,
                                                "sumproduct")
    s, by = work.bound(nbytes, ops)
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(0.1093, abs=5e-5)


def test_frames_that_stop_early_are_charged_less():
    B, n = 8, 50
    before = torch.zeros(B, dtype=torch.int32)
    after = torch.tensor([1, 1, 0, 0, 0, 0, 0, 1], dtype=torch.int32)
    iters = torch.tensor([3, 19, 0, 0, 0, 0, 0, 49], dtype=torch.int32)
    steps = int(work.frame_steps(before, after, iters, 0, n))
    assert steps == 4 + 20 + 5 * n + 50
    full = int(work.frame_steps(before, before, iters, 0, n))
    assert full == B * n
    _, ops_early = work.decode_rounds_work(*QC[:4], B, torch.bfloat16,
                                           torch.bfloat16, "tanhfb", steps)
    _, ops_full = work.decode_rounds_work(*QC[:4], B, torch.bfloat16,
                                          torch.bfloat16, "tanhfb", full)
    assert ops_early < ops_full
    # frames done before a call are charged nothing in it
    assert int(work.frame_steps(after, after, iters, 50, n)) == 5 * n
