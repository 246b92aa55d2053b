"""scripts/gen_eval_torch.py, the port's run of scripts/gen_eval.py's
trajectory matrix: the same rows with the same settings, the same
acceptance rule, and the only file written is --out. The tracking runs
themselves are replaced by a recorder here (150 VGA frames per row need
the GPU: tests/test_torch_cuda_slam.py's seed-0 rows and the matrix run
on the card)."""

import importlib.util
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_matrix_rows_and_settings_match_gen_eval():
    port, jax_script = _load("gen_eval_torch"), _load("gen_eval")
    assert port.HARD == jax_script.HARD and (port.W, port.H, port.SCALE) == (jax_script.W, jax_script.H,
                                                                            jax_script.SCALE)
    rows = []
    port.matrix(lambda tag, **kw: rows.append((tag, kw)))
    assert [t for t, _ in rows] == ["baseline"] * 6 + ["ba1", "ba1+drop", "ba1+refresh"]
    assert [(kw["seed"], kw["loop_closure"]) for _, kw in rows[:6]] == [(s, lp) for s in (0, 1, 2)
                                                                        for lp in (True, False)]
    assert rows[7][1] == dict(seed=0, ba_every_kf=1, reassoc_mode=1, reassoc_gate=16.0)
    assert rows[8][1] == dict(seed=0, ba_every_kf=1, reassoc_mode=2, reassoc_gate=16.0)


def test_acceptance_rule_and_output(tmp_path, monkeypatch):
    port = _load("gen_eval_torch")
    from ra_slam_tpu_torch.eval import trajectory_bench

    calls = []

    def fake(**kw):
        calls.append(kw)
        on = kw.get("loop_closure", True)
        return {"ate_rmse_m": 0.009 if on else 0.0134, "lost_frames": 0, "loop_closures": 4 if on else 0,
                "loop_closure": on}

    monkeypatch.setattr(trajectory_bench, "run_trajectory_eval", fake)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "eval.json")
    r = port.main(["--out", out, "--device", "cpu"])
    assert os.listdir(tmp_path) == ["eval.json"] and json.load(open(out)) == r
    assert r["acceptance_pass"] and len(r["rows"]) == 9
    assert all(c["width"] == 640 and c["height"] == 480 and c["n_frames"] == 150 and c["device"] == "cpu"
               and c["scene_kw"] == port.HARD for c in calls)
    rows = r["rows"]
    rows[0]["loop_closures"] = 0
    assert not port.acceptance(rows)
