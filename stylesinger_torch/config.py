"""Configuration of the port: the flagship defaults as Python.

A copy of the JAX package's ``config.py``: the keys of ``DEFAULTS`` that the
ported modules read (model, training, data), ``apply_spec_stats`` and
``tiny_test_config``, and ``READ_WITH_GET`` / ``READ_WITH_GET_TRAINER`` /
``READ_WITH_GET_DATA``, the keys that the JAX package's vocoder task,
dataset, trainer and data CLI read with ``cfg.get``.

Recipe files: ``load_config(path, overrides, recipe=None, **kwargs)`` is
the defaults <- the YAML file ``path`` with its ``base_config`` cascade
(``_load_yaml_cascade``, children over parents) <- the ``--hparams``
string ``overrides`` (``apply_overrides``; dotted keys reach nested maps)
<- the keyword overrides.  ``recipe=NAME`` names the file
``egs/NAME.yaml`` of the repo.  The YAML is read by the port's own reader
(``yaml_io.py``; the GPU machine has no PyYAML), and ``save_config``
writes ``<work_dir>/config.yaml``, which the JAX package's ``load_config``
reads back equal.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

from stylesinger_torch import yaml_io


class Config(dict):
    """A dict with attribute access. Values are plain Python scalars/lists."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def copy(self) -> "Config":
        return Config(dict.copy(self))

    def replace(self, **kwargs: Any) -> "Config":
        out = self.copy()
        out.update(kwargs)
        return out


# fmt: off
SPEC_MIN_48K = [-6.0] * 80
SPEC_MAX_48K = [
    0.03640973940491676, 0.039425432682037354, 0.29524752497673035, 0.45784831047058105,
    0.48333120346069336, 0.5335848927497864, 0.6071611046791077, 0.5474293828010559,
    0.6076506972312927, 0.5390501022338867, 0.5743886232376099, 0.485751211643219,
    0.4248744249343872, 0.4843744933605194, 0.43331536650657654, 0.5356124639511108,
    0.4875929355621338, 0.48614853620529175, 0.44228559732437134, 0.5027499198913574,
    0.6554337739944458, 0.3469322919845581, 0.33981558680534363, 0.37933868169784546,
    0.34751009941101074, 0.22094282507896423, 0.252963662147522, 0.18274202942848206,
    0.1976650059223175, 0.1770155429840088, 0.18206502497196198, 0.1002601608633995,
    0.18640224635601044, 0.27240633964538574, 0.04153885692358017, -0.010289354249835014,
    -0.012929759919643402, 0.035185474902391434, 0.18124309182167053, -0.14512233436107635,
    -0.1778590828180313, -0.20491982996463776, -0.30119436979293823, -0.1735714226961136,
    -0.1039585992693901, -0.177497997879982, -0.28803232312202454, -0.24049188196659088,
    -0.4682924747467041, -0.5791841745376587, -0.5170156955718994, -0.6380605697631836,
    -0.7147259712219238, -0.6607836484909058, -0.7288452982902527, -0.6338580250740051,
    -0.7092624306678772, -0.8101216554641724, -0.7633087038993835, -0.8251329660415649,
    -0.6936700940132141, -0.5180960297584534, -0.7972619533538818, -0.807314932346344,
    -0.7151175737380981, -0.7785399556159973, -0.8709449768066406, -0.8360402584075928,
    -0.8253681659698486, -0.9778416156768799, -1.12929368019104, -1.3274869918823242,
    -1.3071579933166504, -1.5234452486038208, -1.6191706657409668, -1.708594799041748,
    -1.8246771097183228, -1.9193823337554932, -2.1361801624298096, -2.3829283714294434,
]
# fmt: on

DEFAULTS: Dict[str, Any] = dict(
    # --- audio format (reference egs/stylesinger.yaml:29-36) ---
    audio_sample_rate=48000,
    hop_size=256,
    win_size=1024,
    fft_size=1024,
    fmin=20,
    fmax=24000,
    audio_num_mel_bins=80,
    # --- sequence bounds ---
    max_frames=3000,
    # shape buckets that infer_batch pads its requests to
    frame_buckets=(256, 512, 1024, 1536, 2048, 3000),
    token_buckets=(64, 128, 256, 512, 1000, 2000),
    # --- model switches (reference egs/stylesinger.yaml:20-26) ---
    emo=True,
    style=True,
    umln=True,
    f0_gen="gmdiff",       # gmdiff | conv
    decoder="diffsinger",  # diffsinger | fft | prodiff
    use_nsf=True,
    # --- transformer dims (egs/egs_bases/tts/base.yaml:64-76) ---
    hidden_size=256,
    enc_layers=4,
    dec_layers=4,
    num_heads=2,
    enc_ffn_kernel_size=9,
    dec_ffn_kernel_size=9,
    # --- duration predictor (egs/egs_bases/tts/fs2.yaml) ---
    predictor_hidden=-1,
    predictor_kernel=5,    # the conv pitch predictors (f0_gen: conv)
    dur_predictor_kernel=3,
    dur_predictor_layers=2,
    predictor_layers=5,    # FastSpeech2's and the PitchExtractor's predictors
    # --- pitch ---
    pitch_type="frame",
    pitch_norm="log",
    cwt_std_scale=0.8,     # FastSpeech2, pitch_type cwt
    use_pitch_embed=True,  # FastSpeech2
    use_energy_embed=False,  # FastSpeech2
    use_uv=True,
    f0_mean=400.0,
    f0_std=100.0,
    # --- speaker ---
    use_spk_id=False,
    num_spk=150,
    # reference quirk: the speaker d-vector is computed from the NATIVE-
    # rate wav through the 16 kHz front-end (style_binarizer.py:325,
    # inference/StyleSinger.py:100-104); False = proper 16 kHz resample
    spk_embed_at_native_rate=True,
    # pretrained GE2E d-vector encoders (torch .pt, converted at load,
    # convert.py::load_ge2e_checkpoint): the reference's emotion encoder
    # (checkpoints/global.pt) and resemblyzer's pretrained.pt; empty ->
    # random weights
    emotion_encoder_path="",
    speaker_encoder_path="",
    # --- note encoder ---
    note_vocab=100,
    note_type_vocab=5,
    # --- style / RQ (egs/stylesinger.yaml:102-110) ---
    nRQ=128,
    rq_depth=4,
    guided_sigma=0.3,
    aligner_layers=2,
    aligner_ffn_dim=2048,
    style_wn_layers=4,
    style_conv_dilations=(1, 1, 1, 1, 1),
    # --- f0 gmdiff (egs/stylesinger.yaml:112-135) ---
    f0_timesteps=100,
    f0_max_beta=0.06,
    f0_residual_layers=10,
    f0_residual_channels=192,
    f0_dilation_cycle_length=4,
    # >1 strides the F0 sampler (DDIM for f0, strided posterior for uv)
    f0_speedup=1,
    # --- mel diffusion (egs/stylesinger.yaml:137-147) ---
    timesteps=100,
    K_step=100,
    max_beta=0.06,
    schedule_type="linear",
    diff_decoder_type="wavenet",  # wavenet | fft
    # >1: PLMS mel sampling; dpm_steps > 0: DPM-Solver++(2M) with that many
    # denoiser calls (takes precedence over pndm_speedup)
    pndm_speedup=1,
    dpm_steps=0,
    # the shallow diffusion's conditioner includes the decoder input
    use_txt_cond=True,
    residual_layers=20,
    residual_channels=256,
    dilation_cycle_length=4,
    keep_bins=80,
    spec_min=SPEC_MIN_48K,
    spec_max=SPEC_MAX_48K,
    seed=1234,
    # --- vocoder ---
    vocoder="HifiGAN_NSF",  # vocoder_infer.py::get_vocoder_cls
    upsample_rates=(8, 8, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4),
    upsample_initial_channel=512,
    resblock="1",
    resblock_kernel_sizes=(3, 7, 11),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    harmonic_num=8,
    # overlap-save block length for the generator's MRF groups (0 = off);
    # the blocked groups the kernel takes run the MRF kernel
    # (models/hifigan.py::HifiGanGenerator.mrf_route)
    mrf_block=2048,
    # float32 | bfloat16 (the recipe's; the MRF kernel's bf16 mode)
    vocoder_compute_dtype="float32",
    # > 0: spectral-subtraction denoise of the vocoder's output
    vocoder_denoise_c=0.0,
    # trained generator weights (vocoder_infer.py::load_vocoder_state_dict)
    vocoder_ckpt="",
    # --- dropout (egs/egs_bases/tts/base.yaml, fs2.yaml) ---
    dropout=0.1,
    predictor_dropout=0.5,
    vae_dropout=0.0,
    predictor_grad=1.0,
    rq_decay=0.99,
    # --- curriculum (egs/stylesinger.yaml:102-133) ---
    rq_start=20500,
    forcing=20000,
    diff_start=100000,
    # --- losses (egs/egs_bases/tts/fs2.yaml) ---
    mel_loss="l1:0.5|ssim:0.5",
    pitch_loss="l1",
    lambda_f0=1.0,
    lambda_uv=1.0,
    lambda_ph_dur=0.1,
    lambda_word_dur=0.0,
    lambda_sent_dur=1.0,
    # --- optimizer (egs/egs_bases/tts/base.yaml) ---
    lr=2.0,
    scheduler="rsqrt",
    warmup_updates=8000,
    optimizer_adam_beta1=0.9,
    optimizer_adam_beta2=0.98,
    weight_decay=0.0,
    clip_grad_norm=1.0,
    accumulate_grad_batches=1,
    # --- training loop and checkpoints ---
    max_updates=320000,
    val_check_interval=5000,
    valid_infer_interval=5000,
    tb_log_interval=100,
    num_ckpt_keep=3,
    save_best=True,
    milestone_interval=0,
    load_ckpt="",
    # host-RSS watchdog: 0 = auto, which arms only on a remote-PJRT backend
    # in the JAX package and so never in the port; -1 = off; > 0 = a GB
    # ceiling, at which the trainer checkpoints and raises
    # HostMemoryExceeded (run.py train exits 75, --supervise restarts)
    max_host_rss_gb=0.0,
    # > 1: windows of up to this many steps over a device-resident epoch
    # (training/trainer.py), each step replayed as a CUDA graph on the card
    steps_per_dispatch=1,
    device_data_budget_mb=1024,
    # --- data and work dirs ---
    binary_data_dir="data/binary/style",
    # raw corpus -> processed metadata.json (run.py preprocess): a
    # registered meta adapter (pre_align_cls: lj / emotion / libritts /
    # vctk) reads raw_data_dir, or raw_data_dir/metadata.json is read; the
    # language picks the text processor
    processed_data_dir="data/processed/style",
    raw_data_dir="",
    pre_align_cls="",
    language="zh",
    # binarizer (run.py binarize, data/binarize.py): item names holding one
    # of these substrings go to the valid / test split (test names leave
    # train)
    valid_prefixes=[],
    test_prefixes=[],
    binarization_args=dict(
        with_align=True, with_f0=True, with_spk_embed=True, with_emotion=True,
        with_wav=True, shuffle=False, trim_eos_bos=False, trim_sil=False,
    ),
    pitch_extractor="autocorr",
    # kept so that configs carry over from the JAX package, where it pins
    # the binarizer to the host CPU; the port's binarize runs on --device
    # (the mel kernel, the F0 tracker and the GE2E encoders on the card)
    binarize_platform="cpu",
    work_dir="",
    train_set_name="train",
    valid_set_name="valid",
    test_set_name="test",
    max_tokens=10000,
    max_sentences=100000,
    max_valid_tokens=60000,
    max_valid_sentences=1,
    sort_by_len=True,
    min_frames=0,
    max_input_tokens=2000,
    use_spk_embed=True,
    # --- test split (training/test_runner.py) ---
    save_gt=True,
    gen_dir_name="",
)


# Keys the JAX package's config does not hold and its modules read with
# ``cfg.get`` and these defaults: the vocoder task's optimizer and loss
# weights (``training/vocoder_task.py:62-68,82-87``) and the dataset's
# ``test_ids`` (``data/dataset.py:41-44``), the items of the test split to
# synthesize (None: all of them).  tests/test_torch_config.py holds them
# against the JAX package's calls.
READ_WITH_GET: Dict[str, Any] = dict(
    vocoder_lr=2e-4,
    vocoder_adam_b1=0.8,
    vocoder_adam_b2=0.99,
    vocoder_optimizer="adamw",  # adamw | radam
    lambda_fm=2.0,
    lambda_mel=45.0,
    lambda_ms_stft=0.0,
    test_ids=None,
)


# Keys the JAX package's config does not hold and its trainer reads with
# ``cfg.get`` and these defaults (``training/trainer.py:322-324,393-413``):
# NaN trapping and the profiled window.  ``prefetch_batches`` is read the
# same way, with a default that depends on the host (2 with more than one
# CPU core, else 0: ``trainer.py:368``), so it has no entry here.
READ_WITH_GET_TRAINER: Dict[str, Any] = dict(
    debug_nans=False,
    profile_step=-1,
    profile_n_steps=5,
)


# Keys the JAX package's config does not hold and its data CLI reads with
# ``cfg.get`` and these defaults: the binarizer's class
# (``run.py:154-156``) and whether it also writes the TSD shards
# (``data/binarize.py:211``).  ``binarizer_cls`` names a class path;
# ``data/binarize.py::resolve_binarizer_cls`` maps the JAX package's name
# to the port's own class without importing the module it names.
READ_WITH_GET_DATA: Dict[str, Any] = dict(
    binarizer_cls="stylesinger_tpu.data.binarize.StyleSingingBinarizer",
    write_tsd=True,
)


# The repo's recipe files: ``recipe=NAME`` is ``egs/NAME.yaml``.
EGS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "egs")


def recipe_names() -> list:
    """The recipes of ``egs/`` (its top-level YAML files), sorted."""
    if not os.path.isdir(EGS_DIR):
        return []
    return sorted(f[:-len(".yaml")] for f in os.listdir(EGS_DIR)
                  if f.endswith(".yaml"))


def recipe_path(name: str) -> str:
    """The file of the recipe ``name``: ``egs/<name>.yaml``; an unknown
    name raises."""
    if name not in recipe_names():
        raise KeyError(f"unknown recipe {name!r}; known: {recipe_names()}")
    return os.path.join(EGS_DIR, f"{name}.yaml")


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _load_yaml_cascade(path: str, visited: Optional[set] = None
                       ) -> Dict[str, Any]:
    """The YAML file ``path`` merged over its ``base_config`` chain (a path
    or a list, relative to the file, else as given), children over
    parents, depth first; a cycle raises."""
    visited = visited if visited is not None else set()
    apath = os.path.abspath(path)
    if apath in visited:
        raise ValueError(f"base_config cycle at {path}")
    visited.add(apath)
    raw = yaml_io.load(path) or {}
    merged: Dict[str, Any] = {}
    bases = raw.pop("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    for base in bases:
        base_path = base if os.path.isabs(base) else os.path.join(
            os.path.dirname(path), base)
        if not os.path.exists(base_path):
            base_path = base
        _deep_merge(merged, _load_yaml_cascade(base_path, visited))
    _deep_merge(merged, raw)
    return merged


def _split_overrides(overrides: str) -> list:
    """``"a=1,b=[2,3]"`` split on the commas outside brackets."""
    return re.split(r",(?![^\[\(]*[\]\)])", overrides or "")


def apply_overrides(cfg: Config, overrides: str) -> Config:
    """``"a=1,b.c=2"`` applied to ``cfg`` in place, values coerced as the
    JAX CLI's ``--hparams``; a dotted key sets a key of a nested map."""
    for part in _split_overrides(overrides):
        if not part.strip():
            continue
        key, value = part.split("=", 1)
        node: Dict[str, Any] = cfg
        subkeys = key.strip().split(".")
        for sk in subkeys[:-1]:
            node = node.setdefault(sk, {})
        node[subkeys[-1]] = _coerce(value.strip())
    return cfg


def load_config(path: Optional[str] = None, overrides: str = "",
                recipe: Optional[str] = None, **kwargs: Any) -> Config:
    """Defaults (``DEFAULTS`` and the ``READ_WITH_GET*`` maps)
    <- the YAML cascade of ``path`` <- the ``overrides`` string <- keyword
    overrides.  The config defaults are ``load_config()``; the repo's recipe
    is ``load_config("egs/stylesinger.yaml")``, or
    ``load_config(recipe="stylesinger")`` (a recipe name in place of its
    path)."""
    cfg = Config(json.loads(json.dumps(
        {**DEFAULTS, **READ_WITH_GET, **READ_WITH_GET_TRAINER,
          **READ_WITH_GET_DATA})))
    if recipe is not None:
        if path is not None:
            raise ValueError("load_config: a path or a recipe, not both")
        path = recipe_path(recipe)
    if path is not None:
        _deep_merge(cfg, _load_yaml_cascade(path))
    explicit = {p.split("=", 1)[0].strip()
                for p in _split_overrides(overrides)
                if p.strip() and "=" in p} | set(kwargs)
    apply_overrides(cfg, overrides)
    cfg.update(kwargs)
    apply_spec_stats(cfg, explicit)
    return cfg


def save_config(cfg: Dict[str, Any], work_dir: str) -> str:
    """The config written to ``<work_dir>/config.yaml`` (one sorted key a
    line, values in flow style); returns the path."""
    os.makedirs(work_dir, exist_ok=True)
    out = os.path.join(work_dir, "config.yaml")
    with open(out, "w", encoding="utf-8") as f:
        f.write(yaml_io.dumps(dict(cfg)))
    return out


def load_work_dir_config(work_dir: str) -> Config:
    """The config a training run saved in ``work_dir``: its
    ``config.yaml``, or the ``config.json`` that ``run.py train`` wrote
    before it wrote YAML."""
    fn = os.path.join(work_dir, "config.yaml")
    if os.path.exists(fn):
        return Config(yaml_io.load(fn))
    with open(os.path.join(work_dir, "config.json")) as f:
        return Config(json.load(f))


def _coerce(value: str) -> Any:
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.startswith(("[", "{", "(")):
        try:
            return json.loads(value.replace("(", "[").replace(")", "]"))
        except json.JSONDecodeError:
            pass
    return value


def parse_hparams(overrides: str) -> Dict[str, Any]:
    """``"a=1,b=[2,3]"`` -> {"a": 1, "b": [2, 3]}, values coerced as the
    JAX package's ``--hparams`` does (commas inside brackets stay), as
    keyword overrides: a dotted key raises (``apply_overrides`` /
    ``load_config(overrides=...)`` take those)."""
    out: Dict[str, Any] = {}
    for part in _split_overrides(overrides):
        if not part.strip():
            continue
        key, value = part.split("=", 1)
        key = key.strip()
        if "." in key:
            raise ValueError(f"--hparams {key!r}: a nested key is no "
                             "keyword; pass it to load_config(overrides=)")
        out[key] = _coerce(value.strip())
    return out


def apply_spec_stats(cfg: Config, explicit: Optional[set] = None) -> Config:
    """Opt-in per-dataset diffusion bounds: when ``use_data_spec_stats`` is
    true and the binarizer wrote ``<binary_data_dir>/spec_stats.json``
    (per-bin train-mel min/max), swap them in for the hand-made yaml tables
    the reference ships (egs/stylesinger.yaml:142-143).

    Explicit ``spec_min``/``spec_max`` overrides or kwargs win over the
    data stats (``explicit`` = keys the user set on the CLI/call)."""
    if not cfg.get("use_data_spec_stats"):
        return cfg
    if explicit and ("spec_min" in explicit or "spec_max" in explicit):
        print("| spec_min/spec_max set explicitly; skipping "
              "spec_stats.json swap")
        return cfg
    fn = os.path.join(cfg.get("binary_data_dir", ""), "spec_stats.json")
    if os.path.exists(fn):
        with open(fn) as f:
            stats = json.load(f)
        cfg["spec_min"] = stats["spec_min"]
        cfg["spec_max"] = stats["spec_max"]
    return cfg


def tiny_test_config(**kwargs: Any) -> Config:
    """A miniature config for fast unit tests."""
    cfg = load_config()
    cfg.update(
        hidden_size=32,
        enc_layers=1,
        dec_layers=1,
        num_heads=2,
        enc_ffn_kernel_size=3,
        dec_ffn_kernel_size=3,
        predictor_layers=2,
        f0_residual_layers=1,
        f0_residual_channels=16,
        residual_layers=1,
        residual_channels=16,
        timesteps=4,
        K_step=4,
        f0_timesteps=4,
        nRQ=8,
        rq_depth=2,
        aligner_layers=1,
        aligner_ffn_dim=32,
        style_wn_layers=2,
        style_conv_dilations=(1,),
        audio_num_mel_bins=16,
        keep_bins=16,
        upsample_rates=(4, 4, 2, 2),
        upsample_kernel_sizes=(8, 8, 4, 4),
        upsample_initial_channel=16,
        harmonic_num=2,
        max_frames=64,
        frame_buckets=(32, 64),
        token_buckets=(8, 16),
        warmup_updates=10,
    )
    cfg.update(kwargs)
    return cfg
