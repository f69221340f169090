"""Summed device time a traced train step (kernels, copies, sets), in
ms."""


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "train" or not t:
        return None
    return 1e3 * t["device_s"] / obs["traced_steps"]
