"""rbpf_map_copy_roofline (%): the maps' gather on resample as the RBPF
makes it, `torch.index_select` along the particles into a buffer, called
alone on the maps of the window's fixed point with a seeded index,
against the 2 N H W bytes it must move (each map read once and written
once; the index's 8 N bytes left out)."""

import torch

from portbench import roofline, trace


def map_copy_work(n: int, h: int, w: int):
    """(bytes, operations) of gathering n u8 maps of h x w."""
    return 2.0 * n * h * w, 0.0


def read(ctx):
    maps = ctx.point_state.maps
    n, h, w = maps.shape
    g = torch.Generator(device=maps.device)
    g.manual_seed(7)
    idx = torch.randint(0, n, (n,), generator=g, device=maps.device)
    out = torch.empty_like(maps)
    ms = trace.device_ms(lambda: torch.index_select(maps, 0, idx, out=out))
    return roofline.share(*map_copy_work(n, h, w), ms)
