"""Rays of every view completed in the window over the window's seconds
(host clock; the window ends at the first boundary of the cycle of
poses after its length)."""


def read(obs):
    if obs.get("kind") != "views":
        return None
    return obs["rays_done"] / obs["window_s"]
