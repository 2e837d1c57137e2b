"""On the card: each cell at a size a test holds is correct as the program
states it, and its control (the program one precision lower, the
workload file's `control`) is not. Run on the chip:

    python3 -m pytest portbench/tests/test_portbench_card.py -q
"""

import pytest

from portbench import control
from portbench.tests.pb_small import small

CELLS = {"mcl_floorplan.track_100k": 4096, "slam_floorplan_1m.explore": 4096,
         "mcl_floorplan.relocalize_1m": 4096}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_is_correct_and_the_control_is_not(cell, card):
    over = small(cell, CELLS[cell])
    for ctl in (False, True):
        for seed, out in control.readings(cell, [2**31 + 3, 2**31 + 4, 2**31 + 5], 1.0, ctl, card,
                                          overrides=over):
            assert out["correct"] != ctl, (seed, out["checks"])
