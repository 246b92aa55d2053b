"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Modules are compared by their
top-level name (before the first dot), whole: `ra_slam_tpu_torch` is not
`ra_slam_tpu`."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ra_slam_tpu"}


def _top_level_after(code: str) -> set:
    prog = textwrap.dedent(code) + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT / 'benchmark' / 'tests'}",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, the reference's check included."""
    mods = _top_level_after("""
        import torch
        import small
        import ra_slam_tpu_torch.io.jpeg as jpeg
        jpeg.decode_jpeg_numpy = small.cv2_decode_jpeg
        from benchmark import run
        from benchmark.harness.spec import load_module
        res = run.run_cell(small.small_cell("scannet_gt_seg", 4), small.args(seconds=0.3), torch.device("cpu"), load_module)
        assert res is not None and res["correct"], res
    """)
    assert "ra_slam_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = _top_level_after("""
        import benchmark.reference.compare, benchmark.reference.fusion, benchmark.reference.sens
        import benchmark.reference.unet
    """)
    assert not mods & (FORBIDDEN | {"ra_slam_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("ra_slam_tpu", None)
        sys.modules["ra_slam_tpu_torch_fake"] = sys
        assert "ra_slam_tpu" not in run.forbidden_modules()
        sys.modules["ra_slam_tpu.core"] = sys
        assert "ra_slam_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
