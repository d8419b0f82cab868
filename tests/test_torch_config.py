"""Every shipped PPO and ILQL config loads in both packages to equal
flattened dicts, the port ships its own copy of each and loads all seven by
name (fault C7), the PPO and ILQL data types and method configs carry the
same fields, and the ILQL registry names resolve as in the JAX package."""

import dataclasses
import glob
import os

import pytest

import trlx_tpu.data as jax_data
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.method_configs import ILQLConfig as JaxILQLConfig
from trlx_tpu.data.method_configs import PPOConfig as JaxPPOConfig
from trlx_tpu_torch import data as torch_data
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import ILQLConfig, PPOConfig, get_method

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "trlx_tpu", "configs")
PORT_CONFIG_DIR = os.path.join(ROOT, "trlx_tpu_torch", "configs")
RECIPES = ["ppo", "ilql", "ppo_softprompt", "ppo_gptj", "ppo_long", "ppo_neox20b_rm", "test"]
PPO_CONFIGS = sorted(glob.glob(os.path.join(CONFIG_DIR, "ppo*.yml")))
ILQL_CONFIGS = sorted(glob.glob(os.path.join(CONFIG_DIR, "ilql*.yml")))


def test_ppo_configs_found():
    assert len(PPO_CONFIGS) >= 5


@pytest.mark.parametrize("path", PPO_CONFIGS, ids=os.path.basename)
def test_config_loads_to_equal_dicts(path):
    ours = TRLConfig.load_yaml(path).to_dict()
    theirs = JaxTRLConfig.load_yaml(path).to_dict()
    assert ours == theirs


def test_ppo_method_fields_and_defaults_match():
    ours = {f.name: f.default for f in dataclasses.fields(PPOConfig) if f.default is not dataclasses.MISSING}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxPPOConfig) if f.default is not dataclasses.MISSING}
    assert ours == theirs
    assert {f.name for f in dataclasses.fields(PPOConfig)} == {f.name for f in dataclasses.fields(JaxPPOConfig)}


@pytest.mark.parametrize("path", ILQL_CONFIGS, ids=os.path.basename)
def test_ilql_config_loads_to_equal_dicts(path):
    ours = TRLConfig.load_yaml(path).to_dict()
    theirs = JaxTRLConfig.load_yaml(path).to_dict()
    assert ours == theirs


def test_load_default_ilql_yaml():
    """The twin of tests/test_configs.py::test_load_default_ilql_yaml."""
    assert [os.path.basename(p) for p in ILQL_CONFIGS] == ["ilql_config.yml"]
    cfg = TRLConfig.load_yaml(ILQL_CONFIGS[0])
    assert cfg.method.name == "ilqlconfig"
    assert cfg.method.two_qs is True
    assert cfg.method.betas == [16]
    assert cfg.method.steps_for_target_q_sync == 1


def test_ilql_method_fields_and_defaults_match():
    def defaults(cls):
        out = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
        return out

    assert defaults(ILQLConfig) == defaults(JaxILQLConfig)
    assert get_method("ILQLConfig") is ILQLConfig and get_method("ilqlconfig") is ILQLConfig


def test_ilql_registry_names():
    """The JAX package's trainer names (tests/test_configs.py) and the
    offline orchestrator resolve in the port's registries."""
    import trlx_tpu_torch.trainer.api  # noqa: F401  (populates the registries)
    from trlx_tpu_torch.orchestrator import get_orchestrator
    from trlx_tpu_torch.orchestrator.offline_orchestrator import OfflineOrchestrator
    from trlx_tpu_torch.trainer import get_model
    from trlx_tpu_torch.trainer.ilql import ILQLTrainer

    assert get_model("TPUJaxILQLModel") is ILQLTrainer
    assert get_model("ILQLModel") is get_model("ilql") is get_model("AccelerateILQLModel") is ILQLTrainer
    assert get_orchestrator("OfflineOrchestrator") is OfflineOrchestrator


@pytest.mark.parametrize("name", ["PromptElement", "PromptBatch", "PPORLElement", "PPORLBatch", "ILQLElement",
                                  "ILQLBatch"])
def test_data_types_have_the_same_fields(name):
    ours = [f.name for f in dataclasses.fields(getattr(torch_data, name))]
    theirs = [f.name for f in dataclasses.fields(getattr(jax_data, name))]
    assert ours == theirs


@pytest.mark.parametrize("name", RECIPES)
def test_default_config_loads_every_recipe_from_the_port(name, monkeypatch):
    """C7: the port's ``default_config(name)`` reads
    ``trlx_tpu_torch/configs/<name>_config.yml`` (never the JAX package's
    directory) into the dict ``trlx_tpu.trainer.api.default_config(name)``
    gives."""
    from trlx_tpu.trainer.api import default_config as jax_default_config
    from trlx_tpu_torch.trainer import api

    read = []
    load = TRLConfig.load_yaml
    monkeypatch.setattr(TRLConfig, "load_yaml", classmethod(lambda cls, path: read.append(path) or load(path)))
    ours = api.default_config(name).to_dict()
    assert read == [os.path.join(PORT_CONFIG_DIR, f"{name}_config.yml")]
    assert ours == jax_default_config(name).to_dict()


def test_every_jax_recipe_has_its_port_copy():
    """Every ``*.yml`` of ``trlx_tpu/configs`` has a copy of the same name in
    ``trlx_tpu_torch/configs`` with the same keys and values, and the two
    directories hold the same files; each copy's header names the JAX file it
    copies and no longer says the port ignores the mesh."""
    import yaml

    jax_files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.yml")))
    port_files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(PORT_CONFIG_DIR, "*.yml")))
    assert jax_files == port_files == sorted(f"{n}_config.yml" for n in RECIPES)
    for name in jax_files:
        with open(os.path.join(CONFIG_DIR, name)) as f:
            theirs = yaml.safe_load(f)
        with open(os.path.join(PORT_CONFIG_DIR, name)) as f:
            text = f.read()
        assert yaml.safe_load(text) == theirs, name
        header = "".join(ln for ln in text.splitlines(keepends=True) if ln.startswith("#"))
        assert f"trlx_tpu/configs/{name}" in " ".join(header.replace("#", " ").split()), name
        assert "does not read" not in header, name
