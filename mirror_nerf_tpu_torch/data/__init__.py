DATASETS = {}


def register(name):
    def deco(cls):
        DATASETS[name] = cls
        return cls
    return deco


def get_dataset(name: str):
    # populate registry lazily
    from . import blender  # noqa: F401
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md queue 1, item 5: "
            "real-capture loaders); only 'blender' is")
    return DATASETS[name]
