"""The port's serving export (``stylesinger_torch/serving/export.py``,
``torch.export``) against its live function and against the JAX package's
``serving/export.py``.

One module fixture: seeded numpy weights for the JAX model and vocoder
(``from_jax_params`` for the port), one JAX compile of its
``make_synthesize_fn`` under ``jax.jit`` (its vocoder on XLA convs, the
Pallas MRF kernel's plain reference, ``mrf_pallas`` off), and one
``torch.export`` of the port's on the CPU at ``mrf_block=64``, where the
vocoder's stages take the MRF kernel's operator.  Tolerances: the artifact against the live function
atol 1e-5 (``tests/test_serving.py``), against JAX atol 1e-3
(``tests/test_torch_slice.py``); ``mel2ph`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    gm_dual_draws, one_torch_thread, random_variables, sampler_keys,
    shallow_draws, stash_draws, to_np,
)

from stylesinger_torch.serving import (
    export_synthesizer, load_synthesizer, make_synthesize_fn,
    noise_from_seed, save_synthesizer, synthesize,
)
from stylesinger_torch.serving.export import _example_batch

VOCAB, B, T_TXT, T_REF, FRAMES = 12, 1, 6, 24, 32
# the fast samplers keep the unrolled graph small: 1 strided F0 step
# (2 denoiser calls) and 2 DPM-Solver++ mel steps
CFG = dict(hop_size=64, mrf_block=64, max_frames=FRAMES, f0_speedup=4,
           dpm_steps=2)


@pytest.fixture(scope="module")
def served(tmp_path_factory, one_torch_thread):
    from stylesinger_tpu.config import tiny_test_config
    from stylesinger_tpu.models.hifigan import HifiGanGenerator as JaxVoc
    from stylesinger_tpu.models.stylesinger import StyleSinger as JaxSS
    from stylesinger_tpu.serving import export as jexport

    from stylesinger_torch.config import tiny_test_config as torch_tiny
    from stylesinger_torch.convert import from_jax_params

    cfg = tiny_test_config(**CFG)
    tcfg = torch_tiny(**CFG)
    batch = _example_batch(tcfg, VOCAB, B, T_TXT, T_REF, seed=3)
    jb = {k: jnp.asarray(to_np(v)) for k, v in batch.items()}
    keys = {k: jax.random.PRNGKey(n) for n, k in enumerate(
        ["params", "dropout", "umln", "rq", "diffusion", "noise"])}
    av = random_variables(
        JaxSS(cfg, VOCAB).init, keys, jb["txt_tokens"],
        jnp.ones((B, T_REF), jnp.int32), jb["spk_embed"], jb["emo_embed"],
        jb["ref_mels"], jb["ref_f0"], jnp.full((B, T_REF), 8.0),
        jnp.zeros((B, T_REF)), jb["note"], jb["note_dur"], jb["note_type"],
        infer=False, use_rq=True, forcing=False, use_diff=True, seed=1)
    # random weights give ~0-frame phones: make phones ~4 frames long
    av["params"]["dur_predictor"]["out"]["bias"][:] = np.log(5.0)
    vv = random_variables(
        JaxVoc(cfg).init, {"params": keys["params"], "noise": keys["noise"]},
        jnp.zeros((1, 16, cfg["audio_num_mel_bins"])),
        jnp.full((1, 16), 200.0), seed=2, gain=0.5)

    # JAX: the jitted synthesis function; its samplers' keys and its
    # vocoder's draws come back out to be replayed into the port
    jfn = jexport.make_synthesize_fn(cfg, VOCAB, FRAMES)

    def run(variables, voc_variables, b, rng):
        seen, draws = {}, {}
        with sampler_keys(seen), stash_draws(draws):
            out = jfn(variables, voc_variables, b, rng)
        seen.pop("sh_name")
        return out, seen, [v for _, v in draws["noise"]], \
            [k for k, _ in draws["noise"]]

    kinds = []

    def traced(*args):
        out, seen, values, k = run(*args)
        kinds[:] = k
        return out, seen, values

    out, seen, voc_values = jax.jit(traced)(av, vv, jb,
                                            jax.random.PRNGKey(7))
    t = out[3].shape[1]
    mel_shape = out[1].shape
    draws = (gm_dual_draws(seen["gm"], cfg["f0_timesteps"], B, t,
                           speedup=cfg["f0_speedup"]) +
             shallow_draws(seen["sh"], cfg["K_step"], mel_shape,
                           ancestral=False) +
             list(zip(kinds, voc_values)))
    jax_noise = tuple(torch.tensor(np.asarray(v)) for _, v in draws)

    params = from_jax_params(av)
    voc_params = from_jax_params(vv)
    exported = export_synthesizer(
        tcfg, VOCAB, batch=B, t_txt=T_TXT, t_ref=T_REF, max_frames=FRAMES,
        device="cpu", variables=params, voc_variables=voc_params)
    path = save_synthesizer(exported, str(tmp_path_factory.mktemp("art") /
                                          "tiny.pt2"))
    loaded = load_synthesizer(path)
    return dict(tcfg=tcfg, batch=batch, params=params,
                voc_params=voc_params, exported=exported, loaded=loaded,
                jax_out=out, jax_noise=jax_noise)


def _call(s, params=None, noise=None, batch=None):
    """The loaded artifact on the fixture's batch (seed 7's draws)."""
    return synthesize(
        s["loaded"], s["params"] if params is None else params,
        s["voc_params"], s["batch"] if batch is None else batch,
        noise_from_seed(s["loaded"], 7) if noise is None else noise)


def test_export_roundtrip_matches_the_live_function(served):
    """Export -> save -> load -> call equals the live function with the
    same weights and draws; the loaded program keeps its list of draws and
    its dict key orders (a batch built in another key order gives the
    same output)."""
    s = served
    loaded = s["loaded"]
    assert loaded.draws == s["exported"].draws
    assert loaded.synth_keys == s["exported"].synth_keys
    assert loaded.synth_device == torch.device("cpu")
    noise = noise_from_seed(loaded, 7)
    got = _call(s, noise=noise)
    reordered = {k: s["batch"][k] for k in reversed(list(s["batch"]))}
    for a, b in zip(got, _call(s, noise=noise, batch=reordered)):
        assert torch.equal(a, b)
    live = make_synthesize_fn(s["tcfg"], VOCAB, FRAMES)
    want = live(s["params"], s["voc_params"], s["batch"], noise)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-5)
    np.testing.assert_array_equal(to_np(got[3]), to_np(want[3]))
    assert (to_np(got[3]) > 0).sum() > 4   # the phones cover frames
    assert np.isfinite(to_np(got[0])).all()


def test_noise_from_seed_is_what_a_seeded_noise_draws(served):
    """The artifact on ``noise_from_seed(seed)`` computes what the model
    and vocoder compute drawing from ``Noise(seed)`` (``forward_model``)."""
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.models.hifigan import HifiGanGenerator
    from stylesinger_torch.models.stylesinger import StyleSinger

    s = served
    model = StyleSinger(s["tcfg"], VOCAB).eval()
    vocoder = HifiGanGenerator(s["tcfg"]).eval()
    model.load_state_dict(s["params"])
    vocoder.load_state_dict(s["voc_params"])
    noise = Noise(11, "cpu")
    with torch.no_grad():
        ret = model(**s["batch"], noise=noise, max_frames=FRAMES)
        wav = vocoder(ret["mel_out"], ret["f0_denorm"], noise)
    got = _call(s, noise=noise_from_seed(s["loaded"], 11))
    np.testing.assert_allclose(to_np(got[0]), to_np(wav), atol=1e-5)
    np.testing.assert_allclose(to_np(got[1]), to_np(ret["mel_out"]),
                               atol=1e-5)


def test_export_weights_are_arguments(served):
    """Other weights through the same artifact give another mel: the
    weights are inputs of the program, not constants in it."""
    s = served
    ep = s["exported"]
    kinds = {spec.kind for spec in ep.graph_signature.input_specs}
    assert torch.export.graph_signature.InputKind.PARAMETER not in kinds
    assert not ep.state_dict and ep.example_inputs is None
    # the program's constants are the config's tables (the networks'
    # non-persistent buffers), none of the weights
    live = make_synthesize_fn(s["tcfg"], VOCAB, FRAMES)
    tables = {tuple(b.shape) for t in live._tables[torch.device("cpu")]
              for b in t.values()}
    assert all(p.is_meta for net in live.nets for p in net.parameters())
    consts = [v for v in s["loaded"].constants.values()
              if isinstance(v, torch.Tensor)]
    assert consts and all(tuple(v.shape) in tables for v in consts)
    out1 = _call(s)
    scaled = {k: v * 1.05 if v.is_floating_point() else v
              for k, v in s["params"].items()}
    out2 = _call(s, params=scaled)
    assert not np.allclose(to_np(out1[1]), to_np(out2[1]))


def test_export_matches_jax_with_its_draws(served):
    """The artifact with JAX's draws as its ``noise`` against JAX's jitted
    ``make_synthesize_fn`` on the same weights."""
    s = served
    wav, mel, f0, mel2ph = _call(s, noise=s["jax_noise"])
    jwav, jmel, jf0, jmel2ph = s["jax_out"]
    np.testing.assert_array_equal(to_np(mel2ph), np.asarray(jmel2ph))
    np.testing.assert_allclose(to_np(mel), np.asarray(jmel), atol=1e-3)
    np.testing.assert_allclose(to_np(f0), np.asarray(jf0), atol=1e-3)
    np.testing.assert_allclose(to_np(wav), np.asarray(jwav), atol=1e-3)


def test_exported_graph_holds_the_mrf_operator(served):
    """Each vocoder stage of at least two 64-sample blocks is one node of
    the MRF kernel's operator (the 128- to 2048-sample stages here)."""
    s = served
    for ep in (s["exported"], s["loaded"]):
        nodes = [n for n in ep.graph.nodes if n.op == "call_function" and
                 n.target == torch.ops.stylesinger.fused_mrf_blocks.default]
        assert len(nodes) == 4
