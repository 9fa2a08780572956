"""chip_smoke.py's own rules, on the CPU: the device check, the result
line, the update-agreement, top-k tie and solve-error rules, and the
phase selection.  The phases themselves need the card."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Dev:
    def __init__(self, platform, kind="k"):
        self.platform, self.device_kind = platform, kind


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_device_check_refuses_non_gpu(smoke, platform):
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.check_devices([_Dev(platform)], 1)


def test_device_check_counts_devices(smoke):
    assert len(smoke.check_devices([_Dev("gpu")] * 4, 1)) == 1
    assert len(smoke.check_devices([_Dev("gpu")] * 4, 4)) == 4
    with pytest.raises(SystemExit, match="need 4"):
        smoke.check_devices([_Dev("gpu")], 4)


def test_script_exits_nonzero_on_cpu_before_any_phase():
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert "phase" not in r.stdout and '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_result_line_format(smoke):
    line = smoke.result_line([_Dev("gpu", "NVIDIA H100 80GB HBM3")])
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("four,expected", [
    (False, ("bpr_ml20m", "wmf_ml20m_d256", "chol_forms",
             "relmf_expomf_glove", "eval_recommend")),
    (True, ("four_bpr", "four_wmf", "four_relmf_expomf_glove",
            "four_eval_recommend")),
])
def test_phase_selection(smoke, four, expected):
    phases = smoke.select_phases(four)
    assert phases == expected
    assert all(name in smoke.PHASES for name in phases)
    if four:  # --four runs its path and nothing of the default set
        assert not set(phases) & set(smoke.select_phases(False))


def test_four_flag_parses(smoke):
    assert smoke.parse_args(["--four"]).four
    assert not smoke.parse_args([]).four
    assert smoke.parse_args([]).seed == 0
    with pytest.raises(SystemExit):  # no toy-shape or CPU mode
        smoke.parse_args(["--tiny"])


@pytest.mark.parametrize("case,ok", [
    ("equal", True), ("tiny_noise", True), ("rare_adam_outlier", True),
    ("one_flip", True), ("outlier_too_far", False), ("many_outliers", False),
    ("two_in_one_row", False), ("outlier_not_ill", False),
    ("ill_outlier", True),
])
def test_update_agreement_rule(smoke, case, ok):
    rng = np.random.default_rng(0)
    start = rng.normal(size=(2000, 60))  # 120,000 elements
    step = rng.normal(size=start.shape) * 1e-3
    ref = start + step
    got = ref.copy()
    flip_cap = 0.002
    ill = None
    if case == "tiny_noise":
        got += 1e-7
    elif case == "rare_adam_outlier":
        got[3, 4] += 1e-4  # an ill-conditioned Adam step moved
    elif case == "one_flip":
        got[5, 6] = start[5, 6] - step[5, 6]  # the update took the other sign
    elif case == "outlier_too_far":
        got[5, 6] += 1.5 * flip_cap  # beyond what one flip can move
    elif case == "many_outliers":
        got[[1, 9, 17], 0] += 1e-4  # 2.5e-5 of elements
    elif case == "two_in_one_row":
        got[7, [0, 30]] += 1e-4  # a fault confined to one row
    elif case in ("outlier_not_ill", "ill_outlier"):
        got[3, 4] += 1e-4
        ill = np.zeros(start.shape, bool)
        ill[3, 4 if case == "ill_outlier" else 5] = True
    assert smoke.compare_updates(got, ref, flip_cap, ill=ill)[0] is ok


def test_update_rule_without_outliers_allowed(smoke):
    ref = np.full((10, 10), 1e-3)
    got = ref.copy()
    got[0, 0] += 2e-5
    assert not smoke.compare_updates(got, ref, 0.0)[0]
    assert smoke.compare_updates(ref + 5e-6, ref, 0.0)[0]


def test_ill_conditioned_reads_the_smallest_second_moment(smoke):
    """An element is ill-conditioned when, after any step that touched
    it, sqrt(v / (1 - beta2)) was at most ILL_GRAD; an untouched element
    (v = 0) is not."""
    g = smoke.ILL_GRAD
    v1 = 1e-3 * np.array([[(0.5 * g) ** 2, (2 * g) ** 2, 0.0]])
    # a later, larger gradient does not undo an ill-conditioned touch
    v2 = v1 * 0.999 + 1e-3 * np.array([[1e-2 ** 2, 0.0, 0.0]])
    assert smoke.ill_conditioned([v1, v2]).tolist() == [[True, False,
                                                         False]]


@pytest.mark.parametrize("case,ok", [
    ("identical", True), ("boundary_tie", True), ("inner_tie", True),
    ("wrong_item", False), ("excluded_item", False),
])
def test_topk_tie_rule(smoke, case, ok):
    rng = np.random.default_rng(1)
    s = rng.normal(size=(4, 30))
    s[:, 29] = -np.inf  # excluded
    order = np.argsort(-s, axis=1, kind="stable")
    ids = order[:, :10].copy()
    if case == "boundary_tie":
        # make the 10th and 11th nearly equal, and swap them
        s[0, order[0, 10]] = s[0, order[0, 9]] * (1 - 1e-7)
        ids[0, 9] = order[0, 10]
    elif case == "inner_tie":
        s[1, order[1, 3]] = s[1, order[1, 2]] * (1 + 1e-8)
        order = np.argsort(-s, axis=1, kind="stable")
        ids = order[:, :10].copy()
        ids[1, 2], ids[1, 3] = ids[1, 3], ids[1, 2]
    elif case == "wrong_item":
        ids[2, 0] = order[2, 20]
    elif case == "excluded_item":
        ids[3, 9] = 29
    assert smoke.topk_matches(ids, s, 10)[0] is ok


@pytest.mark.parametrize("err,err_ref,ok", [
    (1e-6, 1e-6, True), (2.9e-6, 1e-6, True), (3.5e-6, 1e-6, False),
    (5e-4, 2e-6, False), (0.0, 0.0, True),
])
def test_solve_error_rule(smoke, err, err_ref, ok):
    assert smoke.solve_rule(err, err_ref) is ok


def test_solve_rule_separates_f32_from_tf32(smoke):
    """The rule's teeth on the CPU: a solve whose products carry TF32's
    10-bit mantissa fails against the float32 error."""
    rng = np.random.default_rng(2)
    Y = rng.normal(size=(400, 32)) * 0.1
    A = Y.T @ Y + 0.01 * np.eye(32)
    b = Y.sum(axis=0)
    ref = np.linalg.solve(A, b)

    def solve(Yr):
        A = (Yr.T @ Yr + 0.01 * np.eye(32)).astype(np.float32)
        return np.linalg.solve(A, Yr.sum(axis=0).astype(np.float32))

    def tf32(x):  # round to 10 mantissa bits
        m, e = np.frexp(x)
        return np.ldexp(np.round(m * 2048) / 2048, e)

    e32 = smoke.rel_err(solve(Y.astype(np.float32).astype(np.float64)),
                        ref)
    etf = smoke.rel_err(solve(tf32(Y)), ref)
    assert smoke.solve_rule(e32, e32)
    assert not smoke.solve_rule(etf, e32)


def test_scaled_close(smoke):
    assert smoke.scaled_close([100.0, 1e-6], [100.0005, 0.0])[0]
    assert not smoke.scaled_close([100.0, 2e-5], [100.0, 0.0])[0]
