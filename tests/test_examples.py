"""Example CLI smoke tests (no data needed: parse args + build models)."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_train_eval_models_buildable():
    mod = _load(ROOT / "examples/implicit-recsys/train_eval.py",
                "train_eval_example")
    import argparse
    ns = argparse.Namespace(
        num_components=8, learning_rate=0.01, weight_decay=0.01,
        weight=10.0, lam_y=1.0, clip_value=0.1, batch_size=256)
    for name, build in mod.MODELS.items():
        model = build(ns)
        assert model.num_components == 8, name


def test_glove_example_importable():
    mod = _load(ROOT / "examples/word-embeddings/glove_example.py",
                "glove_example_mod")
    assert callable(mod.main)


def test_parity_script_importable():
    # parity_ml100k imports at module scope but only touches data in main
    spec = importlib.util.spec_from_file_location(
        "parity_script", ROOT / "scripts/parity_ml100k.py")
    assert spec is not None
