"""The port imports without JAX, Triton or nvcc, imports nothing of the JAX
package, and uses no library attention in place of its kernels."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpat_tpu_torch")
MODULES = (
    "tpat_tpu_torch, tpat_tpu_torch.config, tpat_tpu_torch.models.vit, "
    "tpat_tpu_torch.models.mae, tpat_tpu_torch.utils.serving, "
    "tpat_tpu_torch.utils.weights, tpat_tpu_torch.ops.window_attention, "
    "tpat_tpu_torch.cli.export_serving, tpat_tpu_torch.cli.profile_forward, "
    "tpat_tpu_torch.cli.profile_train, tpat_tpu_torch.cli.profile_pretrain, "
    "tpat_tpu_torch.engine.train, tpat_tpu_torch.engine.optimizer, "
    "tpat_tpu_torch.engine.schedules, tpat_tpu_torch.engine.pretrain, "
    "tpat_tpu_torch.ops.layernorm, tpat_tpu_torch.probes.probe_attn_softmax, "
    "tpat_tpu_torch.probes.probe_attn_grouping, "
    "tpat_tpu_torch.probes.probe_ln_matmul, tpat_tpu_torch.probes._bench, "
    "tpat_tpu_torch.ops.fbank, tpat_tpu_torch.data, tpat_tpu_torch.data.wav, "
    "tpat_tpu_torch.data.native, tpat_tpu_torch.data.augment, "
    "tpat_tpu_torch.data.sampler, tpat_tpu_torch.data.datasets, "
    "tpat_tpu_torch.data.loader, tpat_tpu_torch.engine.metrics, "
    "tpat_tpu_torch.engine.evaluate, tpat_tpu_torch.utils.logging, "
    "tpat_tpu_torch.models.pos_embed, tpat_tpu_torch.utils.torch_import, "
    "tpat_tpu_torch.utils.checkpoint, tpat_tpu_torch.cli.finetune, "
    "tpat_tpu_torch.cli.get_norm_stats, "
    "tpat_tpu_torch.cli.create_voxceleb1_csv, tpat_tpu_torch.cli.run_ast, "
    "tpat_tpu_torch.analysis, tpat_tpu_torch.analysis.stats, "
    "tpat_tpu_torch.analysis.extract_stats, tpat_tpu_torch.analysis.reducers, "
    "tpat_tpu_torch.utils.features, tpat_tpu_torch.ops.frontend, "
    "tpat_tpu_torch.cli.pretrain, tpat_tpu_torch.data.device_cache, "
    "tpat_tpu_torch.parallel, tpat_tpu_torch.parallel.distributed, "
    "tpat_tpu_torch.parallel.mesh"
)
FORBIDDEN = ("jax", "flax", "tpat_tpu")  # top-level package names
LIBRARY_ATTENTION = "scaled_dot_product_attention"


def _python(code, env=None):
    # a subprocess: this test process already imported jax (tests/conftest.py)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_leaves_jax_and_flax_out():
    """Nor any module of the JAX package, even a pure-Python one."""
    proc = _python(
        f"import {MODULES}, sys; "
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
        "assert not bad, bad"
    )
    assert proc.returncode == 0, proc.stderr


def test_import_needs_no_triton_or_nvcc():
    """Kernels build only when a CUDA tensor reaches them: importing the
    package works with triton unimportable and no nvcc on PATH."""
    env = dict(os.environ, PATH="", CUDA_HOME=os.path.join(REPO, "no-cuda"))
    proc = _python(
        "import sys; sys.modules['triton'] = None; "
        f"import {MODULES}, tpat_tpu_torch.ops.qkv_attention as qa, torch; "
        "import tpat_tpu_torch.ops.window_attention as wa; "
        "out, s = qa.fused_qkv_attention(torch.zeros(1, 3, 384), 2, 'cls', 1); "
        "assert s.shape == (1, 2) and qa.launches == 0; "
        "o = wa.fused_window_attention(torch.zeros(1, 64, 384), "
        "torch.ones(4), torch.zeros(4, 64, 64)); "
        "assert o.shape == (1, 64, 128) and wa.launches == 0; "
        "import tpat_tpu_torch.ops.layernorm as ln; "
        "y = ln.fused_layernorm(torch.zeros(2, 3, 768), torch.ones(768), "
        "torch.zeros(768)); "
        "assert y.shape == (2, 3, 768) and ln.launches == ln.bwd_launches == 0",
        env=env,
    )
    assert proc.returncode == 0, proc.stderr


def _sources(ext):
    paths = [os.path.join(REPO, "chip_smoke.py")] if ext == ".py" else []
    for root, _dirs, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(ext)]
    return paths


def _imported(tree):
    """Top-level package names of every import statement in a module,
    function bodies included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_sources_import_no_jax_and_no_library_attention():
    """No source imports jax, flax or tpat_tpu (function bodies included),
    and no package source names the library attention."""
    for path in _sources(".py"):
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, REPO)
        for top, line in _imported(ast.parse(text, path)):
            assert top not in FORBIDDEN, f"{rel}:{line} imports {top}"
    for path in _sources(".py") + _sources(".cu") + _sources(".cuh"):
        if os.path.basename(path) == "chip_smoke.py":
            continue
        with open(path) as f:
            assert LIBRARY_ATTENTION not in f.read(), os.path.relpath(path, REPO)


def test_chip_smoke_names_library_attention_in_one_yardstick_only():
    """chip_smoke.py times the library call beside the kernels (its
    ``library_ms``): every line that names it lies inside one function,
    which calls it and times it with CUDA events."""
    path = os.path.join(REPO, "chip_smoke.py")
    with open(path) as f:
        text = f.read()
    tree = ast.parse(text, path)
    uses = [n for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and n.attr == LIBRARY_ATTENTION]
    assert uses, "chip_smoke.py no longer times the library attention"
    funcs = [f for f in tree.body if isinstance(f, ast.FunctionDef)]

    def owner(node):
        """The module-level function whose body holds the node."""
        return next((f for f in funcs
                     if f.lineno <= node.lineno <= f.end_lineno), None)

    owners = {owner(n) for n in uses}
    assert len(owners) == 1 and None not in owners, owners
    (yardstick,) = owners
    lines = [i for i, line in enumerate(text.splitlines(), 1)
             if LIBRARY_ATTENTION in line]
    assert all(yardstick.lineno <= i <= yardstick.end_lineno for i in lines)
    body = ast.unparse(yardstick)
    assert "Event" in body and "elapsed_time" in body, yardstick.name


def test_parallel_package_is_covered():
    """The data-parallel package is among the modules imported above and
    the sources scanned above."""
    for name in ("parallel", "parallel.distributed", "parallel.mesh"):
        assert f"tpat_tpu_torch.{name}" in MODULES.split(", ")
    scanned = {os.path.relpath(p, PORT) for p in _sources(".py")}
    for f in ("__init__.py", "distributed.py", "mesh.py"):
        assert os.path.join("parallel", f) in scanned
