"""The card's idle share over the stretch every run traced: 100 minus the
union of all runs' device intervals (their contexts time-slice the card),
as a share of the stretch."""


def read(runs, card):
    if card["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - card["busy_s"] / card["window_s"])
