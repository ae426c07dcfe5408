"""The whole train call's share of the card's bf16 peak, in percent: the
reference's operations for one call (counted on the meta device, forward
and backward without recomputation) times the calls a second of the window,
over the published peak at 700 W (the run prints the card's power limit)."""


def read(run):
    if run.kind != "train" or run.flops_per_call is None:
        return None
    return 100.0 * run.flops_per_call * run.calls_per_s / run.peaks["bf16_flops"]
