DATASETS = {}


def register(name):
    def deco(cls):
        DATASETS[name] = cls
        return cls
    return deco


def get_dataset(name: str):
    # populate the registry: every loader of the JAX package is ported
    from . import blender, real_arkit, real_colmap  # noqa: F401
    if name not in DATASETS:
        raise NotImplementedError(
            f"unknown dataset {name!r}: the port loads {sorted(DATASETS)}, "
            "the loaders of the JAX package")
    return DATASETS[name]
