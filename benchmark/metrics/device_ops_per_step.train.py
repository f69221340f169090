"""Device events (kernels, copies, sets) a traced train step."""


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "train" or not t:
        return None
    return t["device_events"] / obs["traced_steps"]
