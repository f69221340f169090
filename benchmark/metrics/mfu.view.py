"""The window's field work over (the window's seconds × the roof), in %:
the whole view's share of the chip's peak (benchmark/roof.py; the work is
the views driver's `work`)."""

from benchmark import roof


def read(obs):
    if obs.get("kind") != "views" or "trace" not in obs:
        return None
    flop, nbytes = obs["window_work"]
    return roof.share_percent(flop, nbytes, obs["window_s"])
