"""The device's idle share of a view, in %: 1 − (the device's busy time a
traced view: the union of its kernel, copy and set intervals) / (the
untraced window's seconds a view). The traced views are a whole cycle of
the poses, as the window is, and the profiler's own host cost stays out of
the denominator."""


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "views" or not t:
        return None
    busy_view = t["busy_s"] / obs["traced_views"]
    return 100.0 * (1.0 - busy_view / (obs["window_s"] / obs["views"]))
