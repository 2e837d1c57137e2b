"""plan_rounds (rounds/request): the lattice search's rounds (the
program's `hastar.rounds` counter: batched pop-expand-commit rounds, as
the JAX loop counts them), a query."""

from portbench import plan_spans


def read(ctx):
    return plan_spans.per_query("counts", "hastar.rounds")
