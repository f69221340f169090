"""The device's idle share of a train step, in %: 1 − (the device's busy
time a traced step: the union of its kernel, copy and set intervals) / (the
untraced window's seconds a step). The profiler's own host cost stays out
of the denominator."""


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "train" or not t:
        return None
    busy_step = t["busy_s"] / obs["traced_steps"]
    return 100.0 * (1.0 - busy_step / (obs["window_s"] / obs["steps"]))
