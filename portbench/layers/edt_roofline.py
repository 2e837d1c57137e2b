"""edt_roofline (%): the public capped distance transform,
`slam_tpu_torch.ops.edt.edt_capped`, called alone on the cell's grid at
the window's fixed point (blocked where the log-odds are positive, capped
at 5 sigma + 2 as the SLAM step caps it), against the bytes and
operations of `roofline.edt_capped_work`."""

from portbench import roofline, trace


def read(ctx):
    from slam_tpu_torch.ops import edt

    blocked = ctx.point_state.grid > 0.0
    cap = 5.0 * ctx.cfg["meas_stddev"] + 2.0
    ms = trace.device_ms(lambda: edt.edt_capped(blocked, cap))
    h, w = blocked.shape
    return roofline.share(*roofline.edt_capped_work(h, w, cap), ms)
