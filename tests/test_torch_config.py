"""The port's configuration against the JAX package's: its defaults and
the repo's recipe, on every key the port reads."""

import json

import pytest

from stylesinger_tpu.config import load_config as jax_load_config

from stylesinger_torch.config import (
    DEFAULTS, READ_WITH_GET, load_config, parse_hparams, recipe_names,
)


def _norm(value):
    """Tuples and lists alike."""
    return json.loads(json.dumps(value))


@pytest.mark.parametrize("recipe", [None] + recipe_names())
def test_recipe_matches_jax_yaml_on_every_key_the_port_reads(recipe):
    jax_cfg = jax_load_config(None if recipe is None
                              else f"egs/{recipe}.yaml")
    cfg = load_config(recipe=recipe)
    assert set(DEFAULTS) <= set(jax_cfg)
    differ = {k: (cfg[k], jax_cfg[k]) for k in DEFAULTS
              if _norm(cfg[k]) != _norm(jax_cfg[k])}
    assert not differ


def test_recipe_is_the_bf16_vocoder_and_overrides_win():
    assert load_config()["vocoder_compute_dtype"] == "float32"
    assert load_config(recipe="stylesinger")["vocoder_compute_dtype"] == \
        "bfloat16"
    cfg = load_config(recipe="stylesinger", f0_speedup=5, dpm_steps=10)
    assert (cfg["f0_speedup"], cfg["dpm_steps"]) == (5, 10)
    with pytest.raises(KeyError, match="unknown recipe"):
        load_config(recipe="nope")


def test_hparams_parse_as_the_jax_cli_does():
    assert parse_hparams("f0_speedup=5,dpm_steps=10,mrf_block=0") == dict(
        f0_speedup=5, dpm_steps=10, mrf_block=0)
    assert parse_hparams("upsample_rates=[4, 4, 2, 2],use_nsf=false,"
                         "vocoder_compute_dtype=bfloat16") == dict(
        upsample_rates=[4, 4, 2, 2], use_nsf=False,
        vocoder_compute_dtype="bfloat16")
    assert parse_hparams("") == {}
    with pytest.raises(ValueError, match="nested"):
        parse_hparams("mesh_shape.data=2")


def test_vocoder_training_keys_are_the_jax_tasks_get_defaults(tmp_path):
    """The JAX package's config has neither the vocoder-training keys nor
    ``test_ids``; its vocoder task and its dataset (on the test split) read
    them with ``cfg.get(key, default)``.  Recorded from their own calls
    (the vocoder state's init traced, not run): every key and default of
    ``READ_WITH_GET``, and ``load_config`` carries them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stylesinger_tpu.config import tiny_test_config
    from stylesinger_tpu.data.dataset import StyleSingerDataset
    from stylesinger_tpu.training import vocoder_task as jvt

    seen = {}

    class Recording(dict):
        def get(self, key, default=None):
            seen[key] = default
            return dict.get(self, key, default)

    cfg = Recording(tiny_test_config())
    jvt.make_vocoder_bodies(cfg)
    jax.eval_shape(lambda: jvt.init_vocoder_state(
        cfg, jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
        jnp.zeros((1, 8))))
    np.save(tmp_path / "test_lengths.npy", np.asarray([20, 30]))
    StyleSingerDataset(cfg, "test", data_dir=str(tmp_path))
    assert not set(READ_WITH_GET) & set(jax_load_config(None))
    assert {k: seen[k] for k in READ_WITH_GET} == READ_WITH_GET
    assert {k: load_config()[k] for k in READ_WITH_GET} == READ_WITH_GET
