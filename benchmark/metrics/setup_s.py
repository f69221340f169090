"""Set-up seconds: from the process's start (imports, CUDA initialisation,
weights, calibration, scene, any kernel build) to the window's start."""


def read(obs):
    return obs.get("setup_s")
