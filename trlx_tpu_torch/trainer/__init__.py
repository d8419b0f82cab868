"""Trainer layer (the counterpart of ``trlx_tpu.trainer``): the registry of
trainer classes by name and the BaseRL protocol every trainer derives
from."""

from abc import ABC, abstractmethod
from typing import Any, Dict, Iterable

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


class BaseRLTrainer(ABC):
    """The abstract RL trainer (the JAX package's ``BaseRLTrainer``):
    experience goes into ``store``; ``act`` rolls out a batch, ``sample``
    samples continuations, ``learn`` trains on the store, ``save`` and
    ``load`` checkpoint the whole state. A subclass that leaves one of them
    out cannot be instantiated."""

    def __init__(self, config):
        self.store = None
        self.config = config

    def push_to_store(self, data: Iterable[Any]):
        self.store.push(data)

    @abstractmethod
    def act(self, data) -> Any:
        """Roll out a batch of prompts."""

    @abstractmethod
    def sample(self, prompts, length: int, n_samples: int) -> Any:
        """Sample continuations of prompts."""

    @abstractmethod
    def learn(self):
        """Train on the stored experience."""

    @abstractmethod
    def save(self, directory=None):
        ...

    @abstractmethod
    def load(self, directory=None):
        ...

    def intervals(self, steps: int) -> Dict[str, bool]:
        """Which per-step side effects fire at step ``steps``."""
        train_cfg = self.config.train
        return {
            "do_checkpoint": steps % train_cfg.checkpoint_interval == 0,
            "do_eval": steps % train_cfg.eval_interval == 0,
            "do_log": steps % train_cfg.log_interval == 0,
        }
