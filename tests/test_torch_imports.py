"""The port stands alone and never runs on the CPU unasked.

* Importing every ``repro_torch`` module and ``chip_smoke``, and running
  every collective of the port on the CPU (the data movers, the two-pass
  codec, the two-kernel hop, every codec and ``codec="auto"`` included;
  the ``fallback`` policy with ``verify_streams`` under an injected
  overflow and NaN, and a wire bitflip caught by its checksum),
  the gradient sync, the dense model's loss forward (both attention paths)
  and decode, the serve loop, ``convert.params_from_jax`` on numpy input,
  and the train CLI with a checkpoint, leaves ``jax``, ``ml_dtypes`` and
  the ``repro`` package out of ``sys.modules``
  (in a fresh interpreter), and importing ``chip_smoke`` runs nothing.
* No module of the port, nor ``chip_smoke.py``, imports ``jax`` or
  ``repro.*`` anywhere in its source (AST scan, function bodies too).
* On a machine without CUDA, every entry point that defaults to the card
  raises instead of running on the CPU, and so does ``chip_smoke.py``.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import grad_sync, transport
from repro_torch.core.comm import GZCommunicator
from repro_torch.core.compressor import ErrorBoundedLorenzo
from repro_torch.configs import registry
from repro_torch.kernels import build
from repro_torch.checkpoint import checkpoint
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import ThreadMesh
from repro_torch.models import parallel
from repro_torch.models.model import Model

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_modules_import_without_jax():
    mods = _module_names()
    assert "repro_torch.kernels.lorenzo" in mods and "repro_torch.convert" in mods
    for new in ("core.entropy", "kernels.entropy", "core.buckets", "core.grad_sync",
                "kernels.flash_attn", "models.model", "launch.serve", "configs.registry",
                "data.pipeline", "core.faults", "optim.adamw", "checkpoint.checkpoint",
                "launch.shapes", "launch.training", "launch.train"):
        assert f"repro_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import torch\n"
        "from repro_torch.core import transport\n"
        "from repro_torch.core.collectives import GZConfig\n"
        "from repro_torch.core.comm import GZCommunicator\n"
        "xs = [torch.linspace(0, 1, 2400) * (r + 1) for r in range(3)]\n"
        "cfgs = [GZConfig(), GZConfig(fused=False, fused_hop=False, pipeline_chunks=2)]\n"
        "cfgs += [GZConfig(codec=k) for k in ('lorenzo+entropy', 'lossless',\n"
        "                                      'passthrough', 'auto')]\n"
        "for cfg in cfgs:\n"
        "    c = GZCommunicator('x', config=cfg, axis_size=3, device='cpu')\n"
        "    for op in ('allreduce', 'reduce_scatter', 'allgather', 'scatter',\n"
        "               'broadcast', 'all_to_all'):\n"
        "        transport.ThreadGroup(3, 'cpu').run(getattr(c, op), xs)\n"
        "from repro_torch.core import faults\n"
        "c = GZCommunicator('x', config=GZConfig(on_overflow='fallback', verify_streams=True,\n"
        "                   algo='redoub'), axis_size=3, device='cpu')\n"
        "for spec in (faults.FaultSpec('overflow', ranks=(1,)), faults.FaultSpec('nan'),\n"
        "             faults.FaultSpec('bitflip', ranks=(2,), n=64)):\n"
        "    with faults.inject(spec):\n"
        "        for op in ('all_to_all', 'reduce_scatter', 'allgather', 'scatter',\n"
        "                   'broadcast', 'allreduce'):\n"
        "            res = transport.ThreadGroup(3, 'cpu').run(getattr(c, op), xs)\n"
        "    assert bool(res[0].overflow | res[0].nonfinite)\n"
        "    assert all(bool(torch.isfinite(r.value).all()) for r in res)\n"
        "from repro_torch.core import grad_sync\n"
        "for sync in (grad_sync.SyncConfig(), grad_sync.SyncConfig(gz=None)):\n"
        "    transport.ThreadGroup(3, 'cpu').run(lambda x: grad_sync.dp_allreduce_grads(\n"
        "        {'w': x, 'b': [x[:7]]}, ('x',), sync, device='cpu'), xs)\n"
        "import dataclasses, io, contextlib\n"
        "import numpy as np\n"
        "from repro_torch import convert\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.data.pipeline import SyntheticStream\n"
        "from repro_torch.launch.serve import serve\n"
        "from repro_torch.models.attention import KVCacheSpec\n"
        "from repro_torch.models.model import Model\n"
        "cfg = registry.get('minitron-8b', smoke=True)\n"
        "m = Model(cfg, device='cpu')\n"
        "tree = convert.params_to_numpy(m.params())\n"
        "p = convert.params_from_jax(tree, 'cpu')\n"
        "batch = next(SyntheticStream(cfg, 2, 64))\n"
        "for c in (cfg, dataclasses.replace(cfg, use_flash_kernel=True)):\n"
        "    assert np.isfinite(float(Model(c, params=p, device='cpu').loss_fn(p, batch)))\n"
        "spec = KVCacheSpec(s_total=8, cp_axis=None, cp_size=1)\n"
        "cache = {k: torch.zeros(v) for k, v in m.cache_defs(2, spec).items()}\n"
        "m.decode_fn(p, cache, batch['tokens'][:, :1], 0, spec)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    serve(['--smoke', '--device', 'cpu', '--gen', '2'])\n"
        "import tempfile\n"
        "from repro_torch.launch.train import train\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    train(['--smoke', '--device', 'cpu', '--steps', '2', '--batch', '2', '--seq',\n"
        "           '16', '--grad-gz', 'ring', '--ckpt-dir', tempfile.mkdtemp(),\n"
        "           '--ckpt-every', '1'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes')\n"
        "print('BAD', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == ["BAD []"], proc.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def _all_of(path) -> set:
    """A module's ``__all__``, read from its source (no import)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


def test_grad_sync_exports_every_name_of_the_references():
    # the FSDP gather and reduce-scatter (ROADMAP A11.6) included
    want = _all_of(ROOT / "src" / "repro" / "core" / "grad_sync.py")
    assert {"fsdp_all_gather", "fsdp_reduce_scatter", "fsdp_reduce_scatter_stats"} <= want
    assert want <= set(grad_sync.__all__)
    assert all(callable(getattr(grad_sync, name)) for name in grad_sync.__all__)
    assert set(grad_sync.__all__) - want == {"tree_flatten", "FsdpStep", "fsdp_gather",
                                                   "fsdp_recompute_context"}


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        transport.ThreadGroup(2)
    with pytest.raises(RuntimeError, match="cuda"):
        GZCommunicator("x")
    with pytest.raises(RuntimeError, match="cuda"):
        GZCommunicator("x", device="cuda:0", axis_size=4)
    d = convert.compressed_to_numpy(
        ErrorBoundedLorenzo().compress(torch.zeros(300), 1e-3))
    with pytest.raises(RuntimeError, match="cuda"):
        convert.compressed_from_numpy(d)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.tree_from_numpy({"w": [np.zeros(3, np.float32)]})
    group = transport.ThreadGroup(1, "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        group.run(lambda x: grad_sync.dp_allreduce_grads({"w": x}, ("x",)),
                  [torch.zeros(8)])
    cfg = registry.get("minitron-8b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.init_params(Model(cfg, device="cpu").param_defs(), torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve(["--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.train(["--smoke"])
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.restore("/nonexistent", 1, {})
    with pytest.raises(RuntimeError, match="cuda"):
        ThreadMesh((1, 1), ("data", "model"))


def test_communicator_refuses_tensors_on_another_device():
    comm = GZCommunicator("x", axis_size=2, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        comm.allreduce(torch.zeros(4, device="meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_chip_smoke_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
