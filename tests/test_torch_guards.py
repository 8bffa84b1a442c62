"""Guards of the port: no JAX in the port, the default-device rule, and one
config schema shared by both packages."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dsnt_pose2d_tpu_torch
from dsnt_pose2d_tpu.utils import config as jconfig
from dsnt_pose2d_tpu_torch.models.factory import (build_mpii_pose_model,
                                                  build_pose_model)
from dsnt_pose2d_tpu_torch.train.loop import (make_eval_fn, make_infer_fn,
                                             make_train_fn)
from dsnt_pose2d_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dsnt_pose2d_tpu_torch"
CONFIGS = sorted((ROOT / "configs").glob("*.json"))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        dsnt_pose2d_tpu_torch.__path__, "dsnt_pose2d_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "dsnt_pose2d_tpu_torch.train.loop" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dsnt_pose2d_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b"
    r"|dsnt_pose2d_tpu(?!_torch)\b", re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    # Docstrings and comments may cite the reference by file path
    # (``dsnt_pose2d_tpu/ops/...``); imports and dotted module names may not.
    hits = [m.group(0) for m in _FORBIDDEN.finditer(text)
            if not text[m.end():m.end() + 1] == "/"]
    assert not hits, hits


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_defaults_to_cuda_and_raises_without_it(no_cuda):
    cfg = tconfig.ModelConfig(base="hg1", hg_features=16, input_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pose_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_mpii_pose_model("hg1", hg_features=16, input_size=32)
    assert build_pose_model(cfg, device="cpu").device.type == "cpu"


def test_steps_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = tconfig.Config(model=tconfig.ModelConfig(base="hg1", hg_features=16,
                                                   input_size=32))
    model = build_pose_model(cfg.model, device="cpu")
    for make in (make_infer_fn, make_eval_fn, make_train_fn):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(model, cfg)
        assert callable(make(model, cfg, device="cpu"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_json_loads_in_both_packages(path):
    text = path.read_text()
    j = jconfig.config_from_json(text)
    t = tconfig.config_from_json(text)
    assert json.loads(tconfig.config_to_json(t)) == json.loads(
        jconfig.config_to_json(j))
    # Written by either package, read by the other.
    assert tconfig.config_from_json(jconfig.config_to_json(j)) == t
    assert json.loads(jconfig.config_to_json(
        jconfig.config_from_json(tconfig.config_to_json(t)))) == json.loads(
        tconfig.config_to_json(t))
    assert tconfig.MODEL_VERSION == jconfig.MODEL_VERSION == 2
