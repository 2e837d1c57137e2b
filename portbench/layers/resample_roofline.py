"""resample_roofline (%): the public systematic resampler,
`slam_tpu_torch.ops.resample.resample(particles, "systematic")`, called
alone on the cell's particles at the window's fixed point, against the
32 N bytes its poses and log weights need."""

import torch

from portbench import roofline, trace


def read(ctx):
    from slam_tpu_torch.ops import resample

    particles = ctx.engine.particles(ctx.point_state)
    g = torch.Generator(device=ctx.dev)
    g.manual_seed(7)
    ms = trace.device_ms(lambda: resample.resample(particles, "systematic", generator=g))
    return roofline.share(*roofline.resample_work(particles.n), ms)
