"""A cell cut to a size a CPU test holds: a 299 x 420 floor plan of the
same rooms and doors, a lap of the same shape through its door, and few
particles. Only the tests use it.

At a few hundred particles one resampler slot is a share of 0.001-0.004,
and the port's CPU route rounds its beam weights otherwise than its card
route does, so a slot can move there; the small MCL cells hold the
particle mismatch to 0.05 (the card's cells, bit for bit on the card, to
their own limit)."""

import copy

SMALL = {"config": {"plan": {"height": 299, "width": 420}},
         "traffic": {"lap": {"cx": 279.5, "y_bottom": 40.0, "radius": 25.0, "frames": 200},
                     "clearance_px": 8.0}}


def small(cell: str, particles: int) -> dict:
    o = copy.deepcopy(SMALL)
    o["cell"] = {"particles": particles, "trace": {"start": 5, "requests": 5}, "point_at": 5}
    if "slam" in cell:
        o["config"]["grid"] = [299, 420]
    else:
        o["cell"]["limits"] = {"particle_mismatch_share": 0.05}
    return o
