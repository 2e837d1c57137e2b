"""lut_weights_roofline (%): one launch of the fused predict -> LUT-weigh
kernel through the public `slam_tpu_torch.models.mcl.predict_weigh`,
called alone on the cell's cloud at the window's fixed point (on the
relocalize cell an episode's freshly woken cloud) with the next
request's odometry and scan, against the bytes and operations of
`roofline.lut_weights_work`; the distinct sensor cells are counted on the
poses the call returns."""

import math

import torch

from portbench import roofline, trace


def sensor_cells(cfg, shape, x, y, theta):
    h, w = shape
    ox, oy, _ = cfg["scanner_offset"]
    d, a = math.hypot(ox, oy), math.atan2(oy, ox)
    i = torch.floor(h - (y + torch.sin(theta + a) * d) - 1.0).long().clamp(0, h - 1)
    j = torch.floor(x + torch.cos(theta + a) * d).long().clamp(0, w - 1)
    return int(torch.unique(i * w + j).numel())


def read(ctx):
    call = ctx.engine.predict_weigh(ctx.point_state, ctx.point_request)
    pose, _ = call()
    cells = sensor_cells(ctx.cfg, ctx.blocked.shape, pose.x, pose.y, pose.theta)
    ms = trace.device_ms(call)
    return roofline.share(*roofline.lut_weights_work(pose.x.shape[0], cells,
                                                     ctx.cfg["lidar"]["n_rays"]), ms)
