"""The port imports without JAX, Triton or nvcc, and uses no library
attention in place of its kernel."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpat_tpu_torch")
MODULES = (
    "tpat_tpu_torch, tpat_tpu_torch.models.vit, tpat_tpu_torch.utils.serving, "
    "tpat_tpu_torch.cli.export_serving, tpat_tpu_torch.cli.profile_forward, "
    "tpat_tpu_torch.cli.profile_train, "
    "tpat_tpu_torch.engine.train, tpat_tpu_torch.engine.optimizer, "
    "tpat_tpu_torch.engine.schedules"
)


def _python(code, env=None):
    # a subprocess: this test process already imported jax (tests/conftest.py)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_leaves_jax_and_flax_out():
    proc = _python(
        f"import {MODULES}, sys; "
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules, "
        "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))"
    )
    assert proc.returncode == 0, proc.stderr


def test_import_needs_no_triton_or_nvcc():
    """Kernels build only when a CUDA tensor reaches them: importing the
    package works with triton unimportable and no nvcc on PATH."""
    env = dict(os.environ, PATH="", CUDA_HOME=os.path.join(REPO, "no-cuda"))
    proc = _python(
        "import sys; sys.modules['triton'] = None; "
        f"import {MODULES}, tpat_tpu_torch.ops.qkv_attention as qa, torch; "
        "out, s = qa.fused_qkv_attention(torch.zeros(1, 3, 384), 2, 'cls', 1); "
        "assert s.shape == (1, 2) and qa.launches == 0",
        env=env,
    )
    assert proc.returncode == 0, proc.stderr


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


def test_sources_import_no_jax_and_no_library_attention():
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    for path in _sources():
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, REPO)
        assert not jax_import.search(text), f"{rel} imports jax/flax"
        assert "scaled_dot_product_attention" not in text, rel
        assert not re.search(r"^\s*(import|from)\s+tpat_tpu\.models\b", text, re.M), (
            f"{rel} imports tpat_tpu.models, which imports flax"
        )
