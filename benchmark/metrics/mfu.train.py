"""The window's step work over (the window's seconds × the roof), in %:
the whole step's share of the chip's peak (benchmark/roof.py; the work is
the train driver's `work`)."""

from benchmark import roof


def read(obs):
    if obs.get("kind") != "train" or "trace" not in obs:
        return None
    flop, nbytes = obs["window_work"]
    return roof.share_percent(flop, nbytes, obs["window_s"])
