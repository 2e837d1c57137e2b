"""plan_round_us (us/round): what one lattice round costs the device, the
`hastar.search` span's device time over the `hastar.rounds` counter."""

from portbench import plan_spans


def read(ctx):
    ms = plan_spans.per_query("device_ms", "hastar.search")
    rounds = plan_spans.per_query("counts", "hastar.rounds")
    return None if ms is None or not rounds else 1e3 * ms / rounds
