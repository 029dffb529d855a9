"""Recipe files in the port: its own YAML reader against the JAX package's
``load_config`` (PyYAML) on every YAML file under ``egs/``, key for key; the
YAML subset the reader takes; dotted ``--hparams``; ``save_config`` read
back equal by both packages, both ways; ``run.py train --config``; and
work dirs that earlier versions of ``run.py train`` left with a
``config.json``.  Exact equality throughout (tuples and lists alike)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from stylesinger_tpu import config as jcfg
from test_torch_load_params import trained_run

from stylesinger_torch import yaml_io
from stylesinger_torch.config import (
    DEFAULTS, _load_yaml_cascade, apply_overrides, load_config,
    load_work_dir_config, recipe_names, save_config,
)
from stylesinger_torch.inference import StyleSingerInfer

REPO = Path(__file__).resolve().parents[1]
EGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "egs").rglob("*.yaml"))


def _norm(value):
    """Tuples and lists alike."""
    return json.loads(json.dumps(value))


@pytest.fixture(autouse=True)
def _in_repo(monkeypatch):
    monkeypatch.chdir(REPO)


@pytest.mark.parametrize("path", EGS)
def test_every_egs_file_reads_as_jax_reads_it(path):
    assert yaml_io.load(path) == yaml.safe_load(open(path))
    assert _load_yaml_cascade(path) == jcfg._load_yaml_cascade(path)
    ours, ref = load_config(path), jcfg.load_config(path)
    keys = set(DEFAULTS) | set(jcfg._load_yaml_cascade(path))
    assert keys <= set(ours) and keys <= set(ref)
    assert {k: _norm(ours[k]) for k in keys} == \
        {k: _norm(ref[k]) for k in keys}


def test_a_recipe_name_is_its_file_in_egs():
    names = recipe_names()
    assert names == sorted(p[len("egs/"):-len(".yaml")] for p in EGS
                           if p.count("/") == 1)
    for name in names:
        assert load_config(recipe=name) == load_config(f"egs/{name}.yaml")
    with pytest.raises(KeyError, match="unknown recipe"):
        load_config(recipe="egs_bases/tts/fs2")
    with pytest.raises(ValueError, match="not both"):
        load_config("egs/stylesinger.yaml", recipe="stylesinger")


def test_the_yaml_subset_reads_as_pyyaml_reads_it(tmp_path):
    base = tmp_path / "bases" / "a.yaml"
    base.parent.mkdir()
    base.write_text("""# a base
lr: 2.0   # inline comment
warmup_updates: 8000
binarization_args:
  with_wav: false
  inner:
    deep: [1, {x: y}]
frame_buckets:
- 128
- 256
nested:
  - - 1
    - 2
  - key: value
    other: 'it''s'
flags: {data: -1, model: 1}
empty: []
none: ~
words: yes
sci: 1e-5
sci2: 1.0e-05
hexa: 0x1f
quoted: "a # not a comment"
""")
    other = tmp_path / "bases" / "b.yaml"
    other.write_text("lr: 3.0\nextra: [a, 'b c', \"d\"]\n")
    child = tmp_path / "child.yaml"
    child.write_text("base_config:\n  - bases/a.yaml\n  - bases/b.yaml\n"
                     "binarization_args:\n  with_wav: true\n"
                     "mesh_shape: {data: -1, model: 1}\n")
    for f in (base, other, child):
        assert yaml_io.load(str(f)) == yaml.safe_load(open(f)), f
    assert _load_yaml_cascade(str(child)) == \
        jcfg._load_yaml_cascade(str(child))
    merged = _load_yaml_cascade(str(child))
    assert merged["lr"] == 3.0 and merged["sci"] == "1e-5"
    assert merged["binarization_args"] == {
        "with_wav": True, "inner": {"deep": [1, {"x": "y"}]}}
    for bad in ("a: &anchor 1\n", "a: |\n  text\n", "a: !!str 1\n"):
        with pytest.raises(yaml_io.YamlError):
            yaml_io.loads(bad)


def test_dotted_hparams_as_jax_applies_them():
    overrides = ("mesh_shape.data=2,binarization_args.with_wav=false,"
                 "lr=1.5,frame_buckets=[32, 64],new.key=x")
    ours = load_config("egs/stylesinger.yaml", overrides, max_updates=3)
    ref = jcfg.load_config("egs/stylesinger.yaml", overrides, max_updates=3)
    for k in ("mesh_shape", "binarization_args", "lr", "frame_buckets",
              "new", "max_updates"):
        assert _norm(ours[k]) == _norm(ref[k]), k
    assert ours["mesh_shape"] == {"data": 2, "model": 1}
    cfg = apply_overrides(load_config(), "a.b.c=1")
    assert cfg["a"] == {"b": {"c": 1}}


def test_save_config_round_trip_both_ways(tmp_path):
    cfg = load_config("egs/stylesinger.yaml", "mesh_shape.data=2",
                      extra={"x": [1.5, None, "s"], "tup": (1, 2)},
                      tiny=1e-7, text="a: b # c", empty="")
    path = save_config(cfg, str(tmp_path / "ours"))
    assert path.endswith("config.yaml")
    ref = jcfg.load_config(path)
    assert {k: _norm(ref[k]) for k in cfg} == _norm(dict(cfg))
    assert _norm(load_work_dir_config(str(tmp_path / "ours"))) == \
        _norm(dict(cfg))
    # the JAX package's config.yaml (PyYAML's block style) in the port
    jax_cfg = jcfg.load_config("egs/stylesinger.yaml", "mesh_shape.data=2")
    jcfg.save_config(jax_cfg, str(tmp_path / "jax"))
    assert load_work_dir_config(str(tmp_path / "jax")) == \
        yaml.safe_load(open(tmp_path / "jax" / "config.yaml"))
    assert _norm(load_config(str(tmp_path / "jax" / "config.yaml"))) == \
        _norm({**load_config(), **jax_cfg})


def test_run_train_with_a_recipe_file(tmp_path):
    """``run.py train --config egs/stylesinger.yaml`` with tiny overrides
    trains and leaves a ``config.yaml`` both packages read back equal."""
    from test_torch_trainer import _write_corpus, tiny

    cfg = tiny(max_updates=2)
    _write_corpus(tmp_path / "binary", cfg)
    recipe = load_config("egs/stylesinger.yaml")
    overrides = dict({k: v for k, v in cfg.items()
                      if json.dumps(v) != json.dumps(recipe[k])},
                     binary_data_dir=str(tmp_path / "binary"))
    hparams = ",".join(
        f"{k}={json.dumps(v) if isinstance(v, (list, tuple)) else v}"
        for k, v in overrides.items())
    out = subprocess.run(
        [sys.executable, "-m", "stylesinger_torch.run", "train", "--device",
         "cpu", "--config", "egs/stylesinger.yaml", "--hparams", hparams,
         "--exp_name", "tiny", "--work_dir_root", str(tmp_path / "ckpts")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    work = tmp_path / "ckpts" / "tiny"
    assert (work / "ckpt" / "model_ckpt_steps_2.pt").exists()
    saved = load_work_dir_config(str(work))
    expected = load_config("egs/stylesinger.yaml", hparams,
                           work_dir=str(work))
    assert _norm(dict(saved)) == _norm(dict(expected))
    ref = jcfg.load_config(str(work / "config.yaml"))
    assert {k: _norm(ref[k]) for k in saved} == _norm(dict(saved))


def test_a_work_dir_with_config_json_still_loads(tmp_path):
    cfg, state, _ = trained_run(tmp_path)
    work = tmp_path / "ckpts" / "tiny"
    (work / "config.yaml").unlink()
    with open(work / "config.json", "w") as f:   # as run.py train wrote it
        json.dump(dict(cfg, work_dir=str(work)), f, indent=1,
                  sort_keys=True)
    loaded = load_work_dir_config(str(work))
    assert _norm(dict(loaded)) == _norm(dict(cfg, work_dir=str(work)))
    infer = StyleSingerInfer(loaded, device="cpu")
    infer.load_params(str(work))
    sd = state.model.state_dict()
    for k, v in infer.model.state_dict().items():
        assert torch.equal(v.cpu(), sd[k].cpu()), k
    assert np.isfinite(sum(float(v.float().sum()) for v in sd.values()))
