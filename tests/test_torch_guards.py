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


NEW_MODULES = ("bench.kernel", "bench.step", "bench.timing", "cli",
               "cli.common", "cli.evaluate", "cli.infer", "cli.train",
               "data.loader", "data.mpii", "data.pack", "data.prepare",
               "data.resident", "models.import_torch", "models.resnet",
               "models.vit", "native", "ops.cuda.calib", "ops.decode",
               "parallel", "parallel.mesh", "parallel.tp",
               "train.checkpoint", "train.dashboard", "train.metrics",
               "train.profiling", "utils.visualization", "tools",
               "tools.ablation_common", "tools.ablation_heads",
               "tools.ablation_reg", "tools.ablation_resolution",
               "tools.bench_infer", "tools.dress_rehearsal",
               "tools.flagship_report", "tools.profile_step",
               "tools.sweep_train_step")


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "dsnt_pose2d_tpu_torch.train.loop" in mods
    assert {f"dsnt_pose2d_tpu_torch.{m}" for m in NEW_MODULES} <= set(mods)
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


def test_benches_default_to_cuda_and_raise_without_it(no_cuda, monkeypatch):
    from dsnt_pose2d_tpu_torch.bench import kernel, step
    from dsnt_pose2d_tpu_torch.data import resident

    for main in (step.main, kernel.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
    monkeypatch.delenv("DSNT_RESIDENT_BUDGET_BYTES", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resident.resident_budget_bytes()


def test_trainer_defaults_to_cuda_and_raises_without_it(no_cuda):
    from dsnt_pose2d_tpu_torch.data.loader import ShardedLoader
    from dsnt_pose2d_tpu_torch.data.mpii import ArrayDataset
    from dsnt_pose2d_tpu_torch.data.synthetic import make_synthetic_mpii
    from dsnt_pose2d_tpu_torch.train.loop import Trainer

    cfg = tconfig.Config(model=tconfig.ModelConfig(base="hg1", hg_features=16,
                                                   input_size=32),
                         train=tconfig.TrainConfig(batch_size=2))
    model = build_pose_model(cfg.model, device="cpu")
    loader = ShardedLoader(ArrayDataset(make_synthetic_mpii(4, 16)), 2,
                           shuffle=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model=model, cfg=cfg, train_loader=loader)
    trainer = Trainer(model=model, cfg=cfg, train_loader=loader, device="cpu")
    assert trainer.device.type == "cpu" and trainer.resident is not None


@pytest.fixture(scope="module")
def tiny_experiment(tmp_path_factory):
    """A one-epoch run of a tiny hg1 through the train CLI on the CPU."""
    from dsnt_pose2d_tpu_torch.cli import train as train_cli

    out = tmp_path_factory.mktemp("cli")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert train_cli.main(TINY_TRAIN + ["--out-dir", str(out), "--device",
                                            "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    return out / "e"


TINY_TRAIN = ["--base-model", "hg1", "--hg-features", "16", "--input-size",
              "64", "--dtype", "float32", "--data-source", "synthetic",
              "--synthetic-size", "8", "--batch-size", "4", "--epochs", "1",
              "--experiment-id", "e"]


@pytest.mark.parametrize("name", ["train", "evaluate", "infer"])
def test_clis_default_to_cuda_and_raise_without_it(no_cuda, name, tiny_experiment,
                                                   tmp_path):
    import importlib

    cli = importlib.import_module(f"dsnt_pose2d_tpu_torch.cli.{name}")
    assert cli.build_parser().get_default("device") == "cuda"
    if name == "train":
        argv = TINY_TRAIN + ["--out-dir", str(tmp_path)]
    else:
        argv = ["--model-dir", str(tiny_experiment), "--data-source", "synthetic"]
        if name == "infer":
            argv += ["--preds-file", str(tmp_path / "p.mat")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    if name == "train":
        assert not (tmp_path / "e").exists()
    else:
        assert cli.main(argv + ["--device", "cpu"]) == 0


@pytest.mark.parametrize("name", [
    "ablation_heads", "ablation_reg", "ablation_resolution", "bench_infer",
    "dress_rehearsal", "flagship_report", "profile_step", "sweep_train_step"])
def test_drivers_default_to_cuda_and_raise_without_it(no_cuda, name, tmp_path,
                                                      monkeypatch):
    import importlib

    from dsnt_pose2d_tpu_torch.tools import ablation_common

    def no_cli(argv, timeout=None):
        raise AssertionError(f"started {argv} without a card")

    monkeypatch.setattr(ablation_common, "run", no_cli)
    driver = importlib.import_module(f"dsnt_pose2d_tpu_torch.tools.{name}")
    argv = {"dress_rehearsal": ["--root", str(tmp_path / "dress")],
            "bench_infer": [], "profile_step": ["--out", str(tmp_path)],
            "sweep_train_step": []}.get(name, ["--data-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(argv)
    assert not (tmp_path / "dress").exists()
