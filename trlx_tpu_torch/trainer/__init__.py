"""Trainer layer (the counterpart of ``trlx_tpu.trainer``): the registry of
trainer classes by name."""

from typing import Dict

_MODELS: Dict[str, type] = {}


def register_model(name=None):
    """Decorator registering a trainer class by (lowercased) name."""

    def register_class(cls, registered_name):
        _MODELS[registered_name.lower()] = cls
        return cls

    if isinstance(name, str):
        return lambda cls: register_class(cls, name)
    if name is None:
        return lambda cls: register_class(cls, cls.__name__)
    cls = name
    return register_class(cls, cls.__name__)


register_trainer = register_model


def get_model(name: str) -> type:
    name = name.lower()
    if name in _MODELS:
        return _MODELS[name]
    raise ValueError(f"no trainer registered under {name!r}")


get_trainer = get_model


def intervals(train_cfg, steps: int) -> Dict[str, bool]:
    """Which per-step side effects fire at step ``steps`` (checkpointing is
    not ported, so there is no ``do_checkpoint``)."""
    return {
        "do_eval": steps % train_cfg.eval_interval == 0,
        "do_log": steps % train_cfg.log_interval == 0,
    }
