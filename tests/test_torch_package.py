"""recstudio_torch stands alone: no JAX, no recstudio_tpu, no pandas or YAML.

The port runs on a machine without JAX, pandas or PyYAML, so none of its
modules (nor chip_smoke.py) may import them, and its entry points run on
the card unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "recstudio_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml", "recstudio_tpu"}


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
    assert not found & FORBIDDEN, f"{path} imports {sorted(found & FORBIDDEN)}"


def test_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter where jax, flax, pandas
    and yaml cannot be imported, and recstudio_tpu is never loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import recstudio_torch\n"
        "for info in pkgutil.walk_packages(recstudio_torch.__path__, 'recstudio_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert not [m for m in sys.modules if m.startswith('recstudio_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


RANKER_MODULES = ("recstudio_torch.models.basemodel.baseranker",
                  "recstudio_torch.models.module.ctr", "recstudio_torch.models.fm.deepfm",
                  "recstudio_torch.models.fm.fm", "recstudio_torch.models.fm.lr",
                  "recstudio_torch.serving", "recstudio_torch.eval",
                  "recstudio_torch.data.synthetic")


def test_ranker_modules_import_with_jax_blocked():
    """The ranker path's modules, named one by one, import where jax,
    flax, pandas and yaml cannot, and load nothing of recstudio_tpu."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {RANKER_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from recstudio_torch.serving import ScorePredictor\n"
        "from recstudio_torch.utils import get_model\n"
        "assert [get_model(n)[0].__name__ for n in ('DeepFM', 'FM', 'LR')] == "
        "['DeepFM', 'FM', 'LR']\n"
        "assert not [m for m in sys.modules if m.startswith('recstudio_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


GRAPH_MODULES = ("recstudio_torch.models.graph", "recstudio_torch.models.graph.base",
                 "recstudio_torch.models.graph.lightgcn", "recstudio_torch.models.graph.ngcf",
                 "recstudio_torch.models.graph.simgcl",
                 "recstudio_torch.models.module.data_augmentation")


def test_graph_modules_import_with_jax_blocked():
    """The graph family's modules, named one by one, import where jax,
    flax, pandas and yaml cannot, and load nothing of recstudio_tpu."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {GRAPH_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from recstudio_torch.utils import get_model\n"
        "assert [get_model(n)[0].__name__ for n in ('LightGCN', 'NGCF', 'SimGCL')] == "
        "['LightGCN', 'NGCF', 'SimGCL']\n"
        "assert not [m for m in sys.modules if m.startswith('recstudio_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name", ["LightGCN", "NGCF", "SimGCL"])
def test_graph_models_need_cuda_unless_cpu_is_asked(monkeypatch, name):
    from recstudio_torch.utils import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls, conf = get_model(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(conf)
    assert cls(conf, device="cpu").device == torch.device("cpu")


CTR_CORE_MODULES = ("recstudio_torch.models.fm.widedeep", "recstudio_torch.models.fm.dcn",
                    "recstudio_torch.models.fm.nfm", "recstudio_torch.models.fm.autoint",
                    "recstudio_torch.models.module.layers", "recstudio_torch.models.optim",
                    "recstudio_torch.models.basemodel.recommender")


def test_ctr_core_modules_import_with_jax_blocked():
    """The packed step's, the batch norm's and the four new rankers'
    modules, named one by one, import where jax, flax, pandas and yaml
    cannot, and load nothing of recstudio_tpu."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {CTR_CORE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from recstudio_torch.models.module.layers import (Dice, MultiHeadAttention,\n"
        "                                                  SimpleBatchNorm)\n"
        "from recstudio_torch.models.module.ctr import CrossNetwork, packed_tables\n"
        "from recstudio_torch.models.optim import fused_table_lazy_adam_packed\n"
        "from recstudio_torch.utils import get_model\n"
        "assert [get_model(n)[0].__name__ for n in ('WideDeep', 'DCN', 'NFM', 'AutoInt')] == "
        "['WideDeep', 'DCN', 'NFM', 'AutoInt']\n"
        "assert not [m for m in sys.modules if m.startswith('recstudio_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name", ["DeepFM", "FM", "LR", "WideDeep", "DCN", "NFM", "AutoInt"])
def test_rankers_need_cuda_unless_cpu_is_asked(monkeypatch, name):
    from recstudio_torch.utils import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls, conf = get_model(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(conf)
    assert cls(conf, device="cpu").device == torch.device("cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from recstudio_torch.models.basemodel.recommender import batch_to_device
    from recstudio_torch.utils import get_model, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls, conf = get_model("SASRec")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_to_device({"x": np.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert cls(conf, device="cpu").device == torch.device("cpu")
    assert batch_to_device({"x": np.zeros(2)}, "cpu")["x"].device.type == "cpu"


def test_cpu_wrappers_use_the_plain_version_and_count_nothing():
    from recstudio_torch.ops import (catalog_logsumexp, fused_mha, fused_transformer_layer,
                                     fused_transformer_layer_bwd, launch_counts,
                                     reset_launch_counts)
    from recstudio_torch.ops.transformer_layer import param_shapes
    reset_launch_counts()
    q = torch.randn(1, 1, 4, 8)
    fused_mha(q, q, q)
    x = torch.randn(1, 4, 8)
    params = {n: torch.randn(shape) for n, shape in param_shapes(8, 16).items()}
    fused_transformer_layer(x, params, None, None, 2, 0.5, "gelu", 1e-12, True, 3)
    fused_transformer_layer_bwd(torch.ones_like(x), x, params, None, None, 2, 0.5, "gelu",
                                1e-12, 3)
    q, items = torch.randn(5, 8, requires_grad=True), torch.randn(7, 8, requires_grad=True)
    catalog_logsumexp(q, items).sum().backward()
    long_q = torch.randn(1, 1, 600, 4, requires_grad=True)   # Lk > 512: the flash route
    fused_mha(long_q, long_q, long_q).sum().backward()
    assert launch_counts() == {"fused_transformer_layer": 0,
                               "fused_transformer_layer_bwd": 0, "fused_mha": 0,
                               "flash_mha_fwd": 0, "flash_mha_bwd_dq": 0,
                               "flash_mha_bwd_dkv": 0,
                               "catalog_logsumexp_fwd": 0, "catalog_logsumexp_dq": 0,
                               "catalog_logsumexp_ditems": 0}
    assert fused_transformer_layer.launches == 0


def test_kernel_build_is_lazy():
    """Importing the ops builds nothing: no nvcc here, no build directory touched."""
    from recstudio_torch.ops import _native
    assert _native._library is None
