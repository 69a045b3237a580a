"""The check catches what it is there to catch: a run through the control
(the frames rounded to bfloat16) or through any planted fault comes out
with ``correct`` false, and the sound run with it true.  The harness's look
for a card is skipped: the run drives the program's plain torch versions
on the CPU at a small size."""

import pytest

from portbench_small import CELLS, small_cell

from portbench import core, faults

WRAPS = {**faults.CONTROL, **faults.FAULTS}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = core.run(small_cell(cell), 2147483661, 0.5, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["max_err_over_bound"]["value"] <= 1.0
    assert out["checks"]["frames_unreadable"]["value"] == 0
    assert out["checks"]["frames_not_their_input"]["value"] == 0


@pytest.mark.parametrize("wrap", sorted(WRAPS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, wrap):
    small = small_cell(cell)
    small.traffic["check_frames"] = 8
    out = core.run(small, 11, 0.5, False, device="cpu",
                   wrap=WRAPS[wrap](small.config))
    assert not out["correct"], (wrap, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_crossed_answers_show_in_every_frames_header(cell):
    """A few crossed answers fail the check on every frame, not only on
    the decoded sample: with a sample of one frame the headers still
    catch them."""
    small = small_cell(cell)
    small.traffic["check_frames"] = 1
    out = core.run(small, 12, 0.5, False, device="cpu",
                   wrap=faults.foreign_answer(small.config))
    assert not out["correct"]
    assert out["checks"]["frames_not_their_input"]["value"] > 0
