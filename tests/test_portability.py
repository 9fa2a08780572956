"""What the package needs on a machine with only JAX, numpy and scipy:
imports without scikit-learn, pandas or tqdm, bit-identical replacements
for the scikit-learn calls, the compile-cache helper, and the options of
removed engines raising."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from scipy import sparse

ROOT = Path(__file__).resolve().parent.parent

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{{name}} is blocked")
            return None

    sys.meta_path.insert(0, Block())
""")


@pytest.mark.parametrize("blocked", [("sklearn",), ("pandas",), ("tqdm",),
                                     ("sklearn", "pandas", "tqdm")])
def test_import_without_optional_packages(blocked):
    code = _BLOCKER.format(blocked=blocked) + textwrap.dedent("""
        import cymf_tpu
        from cymf_tpu.dataset import SyntheticImplicitDataset
        d = SyntheticImplicitDataset(num_user=30, num_item=20, seed=1)
        m = cymf_tpu.BPR(num_components=4, batch_size=64)
        m.fit(d.train, num_epochs=1, verbose=True)
        assert not [k for k in sys.modules if k.split(".")[0] in BLOCKED]
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_plain_progress_without_tqdm(monkeypatch, capsys):
    from cymf_tpu.models import base
    monkeypatch.setattr(base, "_tqdm", None)
    with base.progress(3, initial=1) as bar:
        bar.set_description("EPOCH=2")
        bar.update(1)
    assert "EPOCH=2 [2/3]" in capsys.readouterr().err
    with base.progress(3, disable=True) as bar:
        bar.update(1)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("n", [1, 17, 5000])
def test_shuffle_matches_sklearn(n):
    """``np.random.permutation`` draws sklearn.utils.shuffle's stream."""
    sk_utils = pytest.importorskip("sklearn.utils")
    a, b = np.arange(n) * 3, np.arange(n) % 7
    np.random.seed(123)
    sa, sb = sk_utils.shuffle(a, b)
    np.random.seed(123)
    perm = np.random.permutation(n)
    np.testing.assert_array_equal(a[perm], sa)
    np.testing.assert_array_equal(b[perm], sb)


@pytest.mark.parametrize("n", [2, 10, 999, 4321])
def test_split_matches_sklearn(n):
    ms = pytest.importorskip("sklearn.model_selection")
    from cymf_tpu.dataset.synthetic import split_indices
    idx = np.arange(n) + 100
    tr, te = ms.train_test_split(idx, test_size=0.1, random_state=12345)
    tr2, te2 = split_indices(idx)
    np.testing.assert_array_equal(tr, tr2)
    np.testing.assert_array_equal(te, te2)


def test_synthetic_dataset_split_matches_sklearn():
    ms = pytest.importorskip("sklearn.model_selection")
    from cymf_tpu.dataset.synthetic import (SyntheticImplicitDataset,
                                            synthetic_interactions)
    d = SyntheticImplicitDataset(num_user=40, num_item=30, seed=3)
    coo = synthetic_interactions(40, 30, seed=3).tocoo()
    idx = np.arange(coo.nnz)
    tr, te = ms.train_test_split(idx, test_size=0.1, random_state=12345)
    tr, va = ms.train_test_split(tr, test_size=0.1, random_state=12345)
    for sel, got in ((tr, d.train), (va, d.valid), (te, d.test)):
        want = sparse.coo_matrix(
            (coo.data[sel], (coo.row[sel], coo.col[sel])), shape=(40, 30))
        assert (want.tocsr() != got.tocsr()).nnz == 0


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_helper(tmp_path, monkeypatch, preset):
    import jax

    from cymf_tpu.utils.runtime import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if preset:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
            assert enable_compile_cache(tmp_path) == "/some/where"
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = enable_compile_cache(tmp_path)
            assert path == str(tmp_path.resolve() / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_library_import_sets_no_jax_config():
    code = ("import jax; before = jax.config.values.copy(); "
            "import cymf_tpu, cymf_tpu.utils.runtime; "
            "changed = {k for k, v in jax.config.values.items() "
            "if before.get(k) != v}; assert not changed, changed; "
            "print('ok')")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("cls,kw", [
    ("BPR", {"engine": "pallas"}), ("BPR", {"packed": "on"}),
    ("BPR", {"neg_pool": 1024}), ("RelMF", {"engine": "pallas"}),
    ("RelMF", {"packed": "on"}), ("GloVe", {"engine": "pallas"}),
    ("GloVe", {"packed": "on"}),
])
def test_removed_engine_options_raise(cls, kw):
    import cymf_tpu
    with pytest.raises(TypeError, match=next(iter(kw))):
        getattr(cymf_tpu, cls)(**kw)


def test_removed_cholesky_kernel_mode_raises(monkeypatch):
    from cymf_tpu.ops.als import resolve_chol_solver
    monkeypatch.setenv("CYMF_TPU_ALS_CHOL", "pallas")
    with pytest.raises(ValueError, match="auto|xla|blocked"):
        resolve_chol_solver("cholesky", 256)


@pytest.mark.parametrize("leaf,schema", [("owp/m", "packed"),
                                         ("ohw/accum", "wide")])
def test_removed_engine_checkpoint_raises(tmp_path, leaf, schema):
    from cymf_tpu import BPR
    X = sparse.random(40, 30, density=0.2, random_state=0, format="csr")
    X.data[:] = 1.0
    p = tmp_path / "old.npz"
    np.savez(p, W=np.zeros((40, 4), np.float32),
             H=np.zeros((30, 4), np.float32),
             **{leaf: np.zeros((40, 128), np.float32)},
             __epoch__=np.asarray(0))
    with pytest.raises(ValueError, match=schema):
        BPR(num_components=4, batch_size=64).fit(
            X, num_epochs=2, verbose=False, checkpoint_path=str(p),
            resume=True)


@pytest.mark.parametrize("smi,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", "NVIDIA H100 80GB HBM3, 700.00 W"),
    ("A, 700.00 W\nA, 700.00 W\n", "2 x A, 700.00 W"),
    ("A, 700.00 W\nA, 400.00 W\n", "A, 700.00 W; A, 400.00 W"),
])
def test_card_info_line(monkeypatch, smi, want):
    import subprocess as sp

    from cymf_tpu.utils import runtime
    monkeypatch.setattr(runtime.subprocess, "run", lambda *a, **k:
                        sp.CompletedProcess(a, 0, stdout=smi))
    assert runtime.card_info() == want


def test_card_info_without_nvidia_smi(monkeypatch):
    from cymf_tpu.utils import runtime

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(runtime.subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        runtime.card_info()


def test_require_gpu_refuses_cpu():
    from cymf_tpu.utils.runtime import require_gpu
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
