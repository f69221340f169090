"""Batch rays of every train step completed in the window over the
window's seconds (host clock; the window ends at the first epoch boundary
after its length)."""


def read(obs):
    if obs.get("kind") != "train":
        return None
    return obs["rays_done"] / obs["window_s"]
