"""The PyTorch port stands alone: no JAX, flax, optax, PyYAML or JAX
package, and kernels that build with plain nvcc into a git-ignored
directory."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "flax", "optax", "yaml", "stylesinger_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import stylesinger_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    stylesinger_torch.__path__, "stylesinger_torch."))
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
sys.path.insert(0, ".")
for script in ("profile_train_step", "data_parallel_check",
               "serving_export_check"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.main)
blocked = [m for m in ("jax", "flax", "optax", "yaml", "stylesinger_tpu")
           if sys.modules.get(m) is not None]
assert not blocked, blocked
print(" ".join(names))
"""


def test_port_imports_without_jax_flax_yaml_or_jax_package():
    """optax is blocked too: the port writes its optimizers out."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    names = out.stdout.split()
    for expected in ("stylesinger_torch.inference", "stylesinger_torch.convert",
                     "stylesinger_torch.kernels.diffnet",
                     "stylesinger_torch.kernels.mel",
                     "stylesinger_torch.kernels.mrf",
                     "stylesinger_torch.models.hifigan",
                     "stylesinger_torch.models.stylesinger",
                     "stylesinger_torch.run",
                     "stylesinger_torch.vocoder_infer",
                     "stylesinger_torch.dsp.denoise",
                     "stylesinger_torch.dsp.align",
                     "stylesinger_torch.data.batching",
                     "stylesinger_torch.data.dataset",
                     "stylesinger_torch.data.indexed_dataset",
                     "stylesinger_torch.training.checkpoint",
                     "stylesinger_torch.training.losses",
                     "stylesinger_torch.training.schedules",
                     "stylesinger_torch.training.step",
                     "stylesinger_torch.training.trainer",
                     "stylesinger_torch.training.vocoder_task",
                     "stylesinger_torch.training.test_runner",
                     "stylesinger_torch.eval.metrics",
                     "stylesinger_torch.eval.evaluate_gen",
                     "stylesinger_torch.text",
                     "stylesinger_torch.text_norm_zh",
                     "stylesinger_torch.text_processors",
                     "stylesinger_torch.dsp.loudness",
                     "stylesinger_torch.dsp.textgrid_align",
                     "stylesinger_torch.dsp.cwt",
                     "stylesinger_torch.dsp.dtw",
                     "stylesinger_torch.dsp.griffin_lim",
                     "stylesinger_torch.data.preprocess",
                     "stylesinger_torch.data.native_loader",
                     "stylesinger_torch.data.tsd_dataset",
                     "stylesinger_torch.data.binarize",
                     "stylesinger_torch.models.precision",
                     "stylesinger_torch.parallel.mesh",
                     "stylesinger_torch.yaml_io",
                     "stylesinger_torch.models.fs2",
                     "stylesinger_torch.models.pe",
                     "stylesinger_torch.models.diffnet",
                     "stylesinger_torch.models.legacy_vocoders",
                     "stylesinger_torch.training.fs2_task",
                     "stylesinger_torch.training.graphs",
                     "stylesinger_torch.utils.meters",
                     "stylesinger_torch.utils.plot",
                     "stylesinger_torch.utils.profiling",
                     "stylesinger_torch.utils.multiprocess",
                     "stylesinger_torch.serving",
                     "stylesinger_torch.serving.export"):
        assert expected in names


def test_cuda_sources_have_a_plain_c_interface():
    sources = sorted((REPO / "stylesinger_torch" / "csrc").glob("*.cu"))
    assert [s.name for s in sources] == ["diffnet.cu", "mel.cu", "mrf.cu"]
    for src in sources:
        text = src.read_text()
        assert "torch/extension.h" not in text, src
        assert 'extern "C"' in text, src


def test_data_path_runs_without_jax_flax_yaml_or_jax_package(tmp_path):
    """The text front-end, the binarizer's resolution of the recipe's
    JAX class name and the TSD reader's host build, with the four names
    blocked."""
    code = _IMPORT_ALL.split("import stylesinger_torch")[0] + r"""
from stylesinger_torch.config import load_config
from stylesinger_torch.data.binarize import resolve_binarizer_cls
from stylesinger_torch.data.native_loader import TsdReader, TsdWriter
from stylesinger_torch.text_processors import get_txt_processor_cls
import numpy as np, sys
print(get_txt_processor_cls("zh").process("我爱你")[1])
print(resolve_binarizer_cls(load_config(recipe="stylesinger")
                            ["binarizer_cls"]).__name__)
w = TsdWriter(sys.argv[1]); w.add_item({"mel": np.ones((3, 2), np.float32)})
w.finalize()
print(TsdReader(sys.argv[1]).gather_pad([0], "mel", 4).sum())
assert not [m for m in ("jax", "flax", "optax", "yaml", "stylesinger_tpu")
            if sys.modules.get(m) is not None]
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "x")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines() == ["wo3 ai4 ni3", "StyleSingingBinarizer",
                                       "6.0"]


def test_build_directory_is_git_ignored():
    from stylesinger_torch.kernels import _build

    ignored = [line.strip() for line in
               (REPO / ".gitignore").read_text().splitlines()]
    rel = _build.BUILD_DIR.relative_to(REPO).as_posix()
    assert f"{rel}/" in ignored or rel in ignored


def test_recipe_file_reads_without_jax_flax_yaml_or_jax_package(tmp_path):
    """``load_config`` of ``egs/stylesinger.yaml`` (its ``base_config``
    chain) and ``save_config``, with the four names blocked."""
    code = _IMPORT_ALL.split("import stylesinger_torch")[0] + r"""
from stylesinger_torch.config import load_config, load_work_dir_config, \
    save_config
import sys
cfg = load_config("egs/stylesinger.yaml", "mesh_shape.data=2")
save_config(cfg, sys.argv[1])
assert load_work_dir_config(sys.argv[1]) == cfg
print(cfg["hidden_size"], cfg["mesh_shape"]["data"], cfg["lr"])
assert not [m for m in ("jax", "flax", "optax", "yaml", "stylesinger_tpu")
            if sys.modules.get(m) is not None]
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "work")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["256", "2", "2.0"]
