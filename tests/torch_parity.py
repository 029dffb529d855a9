"""Helpers for the parity tests of the PyTorch port against the JAX package.

- :func:`random_variables`: seeded numpy weights for a flax module, shaped
  by tracing its init (``jax.eval_shape``, no compile), as the JAX
  package's training-path init would create them.
- :func:`stash_draws`, :func:`sampler_keys`, :func:`gm_dual_draws`,
  :func:`shallow_draws`, :func:`prodiff_draws`: collect the normal,
  uniform, randint and bernoulli draws a JAX function makes, in order (per
  PRNG stream when asked): directly where they are made outside
  ``lax.scan``, and by replaying the samplers' key splits for the draws
  inside their scans.
- :class:`Replay`: hands those draws to the port in the same order, so
  both sides see the same noise.
- :func:`no_dropout`: every flax ``nn.Dropout`` the identity, as if each
  rate were 0.
- :func:`one_torch_thread`: a module fixture that runs torch on one
  intra-op thread.
- :func:`reference_stylesinger_sd`, :func:`reference_pwg_sd`,
  :func:`reference_melgan_sd` (from ``tests/reference_layout.py``, which
  needs no JAX): reference-layout state dicts from flax variables, the
  inverses of the JAX package's ``convert_stylesinger``, ``convert_pwg``
  and ``convert_melgan``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch
from reference_layout import (  # noqa: F401 (re-exported)
    reference_melgan_sd, reference_pwg_sd, reference_stylesinger_sd,
)


def _leaf_value(path, shape, rng, gain):
    name = str(path[-1].key)
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1])) or 1
        return rng.standard_normal(shape) * gain / np.sqrt(fan_in)
    if name == "bias":
        return 0.1 * rng.standard_normal(shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "embedding":
        return rng.standard_normal(shape) / np.sqrt(shape[-1])
    if name == "pos_embed_alpha":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "cluster_size_ema":
        return np.zeros(shape)
    return rng.standard_normal(shape)


def random_variables(init_fn, *args, seed: int = 0, gain: float = 1.0,
                     **kwargs):
    """numpy variables with the tree of ``init_fn(*args, **kwargs)``."""
    shapes = jax.eval_shape(functools.partial(init_fn, **kwargs), *args)
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_leaf_value(p, s.shape, rng, gain),
                                np.float32), shapes)
    _sync_ema(out.get("codebook", {}))
    return out


def _sync_ema(tree) -> None:
    """The EMA copy of each codebook starts equal to the codebook."""
    for v in tree.values():
        if isinstance(v, dict):
            if "embed_ema" in v:
                v["embed_ema"] = v["embedding"].copy()
            else:
                _sync_ema(v)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for a module's tests: on the tiny
    models it is as fast, and the suite's parallel workers then do not
    oversubscribe the cores.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the PRNG stream of a draw, by the file that makes it: flax's Dropout,
# and the JAX package's UMLN, RQ, diffusion and HiFi-GAN (its NSF source's
# "noise" stream) modules
_STREAM_OF_FILE = {"stochastic.py": "dropout", "umln.py": "umln",
                   "rq.py": "rq", "diffusion.py": "diffusion",
                   "hifigan.py": "noise"}
_KINDS = {"normal": "n", "uniform": "u", "randint": "i", "bernoulli": "b"}


@contextlib.contextmanager
def stash_draws(draws):
    """Record every ``jax.random`` normal, uniform, randint and bernoulli
    output as (kind, value) while active: appended to ``draws`` when it is
    a list; when it is a dict, appended to ``draws[stream]``, the stream
    named after the file that drew (``dropout``, ``umln``, ``rq``,
    ``diffusion``).  Under ``jax.jit`` the values are tracers: return them
    from the jitted function."""
    saved = {name: getattr(jax.random, name) for name in _KINDS}

    def recorder(name):
        fn = saved[name]

        def rec(*a, **k):
            out = fn(*a, **k)
            if isinstance(draws, dict):
                caller = os.path.basename(sys._getframe(1).f_code.co_filename)
                draws.setdefault(_STREAM_OF_FILE[caller], []).append(
                    (_KINDS[name], out))
            else:
                draws.append((_KINDS[name], out))
            return out
        return rec

    for name in _KINDS:
        setattr(jax.random, name, recorder(name))
    try:
        yield draws
    finally:
        for name, fn in saved.items():
            setattr(jax.random, name, fn)


@contextlib.contextmanager
def no_dropout():
    """Every flax ``nn.Dropout`` returns its input while active."""
    import flax.linen as nn

    call = nn.Dropout.__call__
    nn.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    try:
        yield
    finally:
        nn.Dropout.__call__ = call


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _gm_dual_values(rng, steps, batch, length, num_classes):
    rng, ra, rb, rua, rub = jax.random.split(rng, 5)
    f0_shape, uv_shape = (batch, length, 1), (batch, num_classes, length)
    out = [jax.random.normal(ra, f0_shape), jax.random.normal(rb, f0_shape),
           jax.random.uniform(rua, uv_shape),
           jax.random.uniform(rub, uv_shape)]
    for rng_i in jax.random.split(rng, steps):
        for r in jax.random.split(rng_i):
            rg, rc = jax.random.split(r)
            out += [jax.random.normal(rg, f0_shape),
                    jax.random.uniform(rc, uv_shape)]
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _gm_dual_strided_values(rng, n_steps, batch, length, num_classes):
    rng, ra, rb, rua, rub = jax.random.split(rng, 5)
    f0_shape, uv_shape = (batch, length, 1), (batch, num_classes, length)
    out = [jax.random.normal(ra, f0_shape), jax.random.normal(rb, f0_shape),
           jax.random.uniform(rua, uv_shape),
           jax.random.uniform(rub, uv_shape)]
    for rng_i in jax.random.split(rng, n_steps):
        out += [jax.random.uniform(r, uv_shape)
                for r in jax.random.split(rng_i)]
    return out


def gm_dual_draws(rng, steps: int, batch: int, length: int,
                  num_classes: int = 2, speedup: int = 1):
    """The draws of ``diffusion.sample_gm_dual(rng, speedup=speedup)``, in
    order, replayed from its key splits: normal z_a, z_b, uniform u_a, u_b,
    then per step and chain (a, b) a normal and a uniform (ancestral) or
    a uniform alone (strided, ``speedup`` > 1)."""
    if speedup > 1:
        n = len(range(steps - 1, -1, -speedup))
        kinds = ["n", "n", "u", "u"] + ["u"] * (2 * n)
        return list(zip(kinds, _gm_dual_strided_values(
            rng, n, batch, length, num_classes)))
    kinds = ["n", "n", "u", "u"] + ["n", "u"] * (2 * steps)
    return list(zip(kinds, _gm_dual_values(rng, steps, batch, length,
                                           num_classes)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _shallow_values(rng, k_step, shape):
    rng, rng_q = jax.random.split(rng)
    return [jax.random.normal(rng_q, shape)] + [
        jax.random.normal(r, shape) for r in jax.random.split(rng, k_step)]


def shallow_draws(rng, k_step: int, shape, ancestral: bool = True):
    """The draws of ``diffusion.sample_shallow(rng)``, in order; with
    ``ancestral=False`` those of ``sample_shallow_plms`` and
    ``sample_shallow_dpmpp``, which draw only the q-sample's normal."""
    values = _shallow_values(rng, k_step, tuple(shape))
    return [("n", v) for v in (values if ancestral else values[:1])]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _prodiff_values(rng, timesteps, shape):
    rng, rng0 = jax.random.split(rng)
    return [jax.random.normal(rng0, shape)] + [
        jax.random.normal(r, shape)
        for r in jax.random.split(rng, timesteps)]


def prodiff_draws(rng, timesteps: int, shape):
    """The draws of ``diffusion.sample_prodiff(rng)``: normal x_T, then one
    normal per step (t = 0 included), in order."""
    return [("n", v) for v in _prodiff_values(rng, timesteps, tuple(shape))]


_SAMPLERS = {"gm": ("sample_gm_dual",), "sh": (
    "sample_shallow", "sample_shallow_plms", "sample_shallow_dpmpp"),
    "pd": ("sample_prodiff",)}


@contextlib.contextmanager
def sampler_keys(keys: dict):
    """Capture the keys the StyleSinger model hands its samplers: "gm" (the
    F0 chains), "sh" (any shallow mel sampler, with its name under
    "sh_name") and "pd" (ProDiff)."""
    from stylesinger_tpu.models import diffusion as diff

    saved = {name: getattr(diff, name)
             for names in _SAMPLERS.values() for name in names}
    rng_pos = {"sample_gm_dual": 5, "sample_prodiff": 4}

    def recorder(slot, name):
        fn = saved[name]

        def rec(*a, **k):
            keys[slot] = a[rng_pos.get(name, 3)]
            if slot == "sh":
                keys["sh_name"] = name
            return fn(*a, **k)
        return rec

    for slot, names in _SAMPLERS.items():
        for name in names:
            setattr(diff, name, recorder(slot, name))
    try:
        yield keys
    finally:
        for name, fn in saved.items():
            setattr(diff, name, fn)


class Replay:
    """Noise source for the port that returns recorded draws in order."""

    def __init__(self, draws, device="cpu"):
        self.draws = list(draws)
        self.device = device

    def _next(self, kind, shape):
        assert self.draws, f"no recorded draw left for {kind}{tuple(shape)}"
        k, a = self.draws.pop(0)
        assert k == kind and a.shape == tuple(shape), (
            f"draw order differs: recorded {k}{a.shape}, "
            f"asked {kind}{tuple(shape)}")
        return torch.tensor(np.asarray(a), device=self.device)

    def normal(self, shape):
        return self._next("n", shape)

    def uniform(self, shape):
        return self._next("u", shape)

    def randint(self, shape, low, high):
        return self._next("i", shape).long()

    def bernoulli(self, p, shape=()):
        return self._next("b", shape)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_reference_ckpt(path: str, variables, **kwargs) -> str:
    """``variables`` as a reference ``model_ckpt_steps_N.ckpt`` file
    (``{"state_dict": {"model": sd}}``)."""
    torch.save({"state_dict": {"model": reference_stylesinger_sd(
        variables, **kwargs)}, "global_step": 100}, path)
    return path


def acoustic_variables(ji, seed: int):
    """Seeded numpy variables of the JAX ``StyleSingerInfer``'s acoustic
    model, shaped by its training-path init, with the duration head's bias
    at log(5): random weights give ~0-frame phones, this ~4 frames."""
    import jax.numpy as jnp

    ex = ji._example_inputs()
    t_ref = ex["ref_mels"].shape[1]
    keys = {k: jax.random.PRNGKey(n) for n, k in enumerate(
        ["params", "dropout", "umln", "rq", "diffusion", "noise"])}
    av = random_variables(
        ji.model.init, keys, ex["txt_tokens"],
        jnp.ones((1, t_ref), jnp.int32), ex["spk_embed"], ex["emo_embed"],
        ex["ref_mels"], ex["ref_f0"], jnp.full((1, t_ref), 8.0),
        jnp.zeros((1, t_ref)), ex["note"], ex["note_dur"], ex["note_type"],
        infer=False, use_rq=True, forcing=False, use_diff=True, seed=seed)
    av["params"]["dur_predictor"]["out"]["bias"][:] = np.log(5.0)
    return av


def inference_pair(cfg_kwargs: dict, phones, request: dict, seed: int = 1,
                   ckpt_dir=None):
    """One request through the JAX package's ``StyleSingerInfer`` (model +
    vocoder under one ``jax.jit``) and through the port's, with the same
    seeded weights and JAX's draws replayed into the port.  With
    ``ckpt_dir``, the acoustic weights are written there as a reference
    ``.ckpt`` file that both sides read through ``load_params``.  Returns a
    dict: ``ret``/``wav`` (JAX), ``tret``/``twav`` (port), ``noise`` (the
    replay, empty when every draw was used), ``draws`` (all of them, in
    order), ``jax_batch``, ``cfg``, ``ti`` and ``ji``."""
    import jax.numpy as jnp

    from stylesinger_tpu.config import tiny_test_config
    from stylesinger_tpu.inference import StyleSingerInfer as JaxInfer
    from stylesinger_torch.config import tiny_test_config as torch_tiny
    from stylesinger_torch.convert import from_jax_params
    from stylesinger_torch.inference import StyleSingerInfer

    cfg = tiny_test_config(**cfg_kwargs)
    ji = JaxInfer(cfg, phone_list=phones)
    keys = {k: jax.random.PRNGKey(n) for n, k in enumerate(
        ["params", "dropout", "umln", "rq", "diffusion", "noise"])}
    av = acoustic_variables(ji, seed)
    vv = random_variables(
        ji.vocoder.init, {"params": keys["params"], "noise": keys["noise"]},
        jnp.zeros((1, 16, cfg["audio_num_mel_bins"])),
        jnp.full((1, 16), 200.0), seed=seed + 1, gain=0.5)
    sv = random_variables(ji.spk_encoder.init, keys["params"],
                          jnp.zeros((1, 160, 40)), seed=seed + 2)
    ev = random_variables(ji.emo_encoder.init, keys["params"],
                          jnp.zeros((1, 160, 40)), seed=seed + 3)
    ji.variables, ji.voc_variables = av, vv
    ji.spk_variables, ji.emo_variables = sv, ev
    ckpt = None
    if ckpt_dir is not None:
        ckpt = write_reference_ckpt(
            os.path.join(ckpt_dir, "model_ckpt_steps_100.ckpt"), av)
        ji.load_params(ckpt)
        av = ji.variables
    jax_batch = ji.preprocess_input(request)
    voc_kinds, names = [], {}

    def fwd(variables, voc_variables, batch):
        keys_seen, voc_draws = {}, []
        with sampler_keys(keys_seen):
            ret = ji.model.apply(
                variables, batch["txt_tokens"], None, batch["spk_embed"],
                batch["emo_embed"], batch["ref_mels"], batch["ref_f0"], None,
                None, batch["note"], batch["note_dur"], batch["note_type"],
                infer=True, use_diff=True, max_frames=cfg["max_frames"],
                rngs={"diffusion": ji._rng, "rq": ji._rng})
        with stash_draws(voc_draws):
            wav = ji.vocoder.apply(voc_variables, ret["mel_out"],
                                   ret["f0_denorm"], rngs={"noise": ji._rng})
        voc_kinds[:] = [kind for kind, _ in voc_draws]
        names["sh"] = keys_seen.pop("sh_name", None)
        outs = {k: ret[k] for k in ("mel_out", "f0_denorm", "mel2ph",
                                    "pitch_pred")}
        return outs, wav, keys_seen, [value for _, value in voc_draws]

    jb = {k: jnp.asarray(v) for k, v in jax_batch.items()}
    ret, wav, keys_seen, voc_draws = jax.jit(fwd)(av, vv, jb)
    b, t = ret["mel2ph"].shape
    mel_shape = ret["mel_out"].shape
    draws = []
    if "gm" in keys_seen:
        draws += gm_dual_draws(keys_seen["gm"], cfg["f0_timesteps"], b, t,
                               speedup=int(cfg.get("f0_speedup", 1)))
    if "sh" in keys_seen:
        draws += shallow_draws(keys_seen["sh"], cfg["K_step"], mel_shape,
                               ancestral=names["sh"] == "sample_shallow")
    if "pd" in keys_seen:
        draws += prodiff_draws(keys_seen["pd"], cfg["timesteps"], mel_shape)
    draws += list(zip(voc_kinds, voc_draws))

    tcfg = torch_tiny(**{k: v for k, v in cfg_kwargs.items()
                         if k != "mrf_pallas"})
    ti = StyleSingerInfer(tcfg, phone_list=phones, device="cpu")
    for module, variables in ((ti.vocoder, vv), (ti.spk_encoder, sv),
                              (ti.emo_encoder, ev)):
        module.load_state_dict(from_jax_params(variables))
    if ckpt is None:
        ti.model.load_state_dict(from_jax_params(av))
    else:
        ti.load_params(ckpt)
    tb = {k: torch.as_tensor(v) for k, v in jax_batch.items()}
    noise = Replay(draws)
    with torch.no_grad():
        tret = ti.model(**tb, noise=noise)
        twav = ti.vocoder(tret["mel_out"], tret["f0_denorm"], noise)
    return dict(cfg=cfg, ret=ret, wav=wav, tret=tret, twav=twav,
                noise=noise, draws=draws, jax_batch=jax_batch, ti=ti, ji=ji,
                sampler=names["sh"])
