"""The port's kernel launches a window view: its ops modules' launch
counters (`launches*`), summed, over the window's views."""


def read(obs):
    if obs.get("kind") != "views":
        return None
    return obs["launches_per_view"]
