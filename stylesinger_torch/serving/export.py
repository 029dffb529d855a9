"""Ahead-of-time serving export (port of
``stylesinger_tpu/serving/export.py``): the zero-shot synthesis step frozen
with ``torch.export`` into one artifact per serving bucket.

The synthesis function (:func:`make_synthesize_fn`) is the acoustic model
with its diffusion samplers and the NSF HiFi-GAN vocoder, the body of
``StyleSingerInfer.forward_model`` without object state.  Its artifact:

- has static shapes: one artifact per (batch, t_txt, t_ref, max_frames)
  bucket, the buckets ``infer_batch`` pads to.  The samplers' loops are
  unrolled into the graph;
- takes the weights as call arguments (the acoustic model's and the
  vocoder's ``state_dict``), not baked constants, so one artifact serves
  every checkpoint of the architecture.  What the config alone fixes (the
  diffusion schedules, the positional tables) is held in the artifact;
- takes its randomness as an argument too: ``noise``, a tuple of tensors,
  one per draw in the order the model draws them
  (``models/diffusion.py::TensorNoise``).  ``torch.export`` takes no
  ``torch.Generator``, so where the JAX artifact takes an ``rng`` key the
  port's takes the draws.  :func:`noise_from_seed` makes them from a seed
  as ``Noise(seed, device)`` would draw them, so the artifact called on
  ``noise_from_seed(exported, seed)`` computes what ``forward_model`` with
  ``noise=Noise(seed)`` computes;
- is for one device (``cuda`` unless the caller asks for ``cpu``), where
  a JAX artifact can carry several platforms' lowerings.  On ``cuda`` its
  vocoder stages launch the MRF kernel, the registered operator
  ``stylesinger::fused_mrf_blocks`` (``kernels/mrf.py``), and the
  denoisers' residual layers at widths the layer kernel takes launch it,
  the registered operator ``stylesinger::diffnet_layer``
  (``kernels/diffnet.py``): one node of the graph per call, counted per
  launch as any call.

Loading an artifact needs those operators' registrations, i.e. this
package installed (``load_synthesizer`` imports it), but not the model
code, where JAX's StableHLO artifact needs no package at all.  Export
under ``torch.no_grad()`` with detached weights: with autograd on, the
vocoder would take its resblock modules instead of the kernel
(``HifiGanGenerator.mrf_route``), and the denoisers their module layers
(``models/diffnet.py::ResidualBlock.takes_kernel``).

Usage::

    ep = export_synthesizer(cfg, vocab_size, batch=1, t_txt=96, t_ref=512,
                            max_frames=1024, variables=sd, voc_variables=vsd)
    save_synthesizer(ep, "stylesinger_b1.pt2")
    ep = load_synthesizer("stylesinger_b1.pt2")
    wav, mel, f0, mel2ph = synthesize(ep, sd, vsd, batch,
                                      noise_from_seed(ep, seed=1234))
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.kernels import diffnet  # noqa: F401  registers the op
from stylesinger_torch.kernels import mrf  # noqa: F401  registers the op
from stylesinger_torch.models.diffusion import (
    Noise, TensorNoise, draw_values,
)
from stylesinger_torch.models.hifigan import HifiGanGenerator
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training.graphs import RecordingNoise

Params = Dict[str, torch.Tensor]
# the artifact's draws, device and dict key orders (an extra file)
SIGNATURE_FILE = "synthesizer.json"


class Synthesizer(nn.Module):
    """The synthesis step as a pure function of its arguments:
    ``(params, voc_params, batch, noise) -> (wav, mel, f0_denorm,
    mel2ph)``.  ``params`` / ``voc_params`` are the state dicts of
    ``StyleSinger`` / ``HifiGanGenerator``; ``batch`` holds ``txt_tokens``,
    ``spk_embed``, ``emo_embed``, ``ref_mels``, ``ref_f0``, ``note``,
    ``note_dur`` and ``note_type``.

    The networks are kept in a tuple, which ``torch.export`` does not
    register, with their own weights freed (moved to the ``meta``
    device).  Each call runs them through ``torch.func.functional_call``
    on the given state dicts and the config's fixed tables (their
    non-persistent buffers, kept per device), so nothing of their own
    enters an export."""

    def __init__(self, cfg: Any, vocab_size: int,
                 max_frames: Optional[int] = None):
        super().__init__()
        self.max_frames = int(max_frames or cfg["max_frames"])
        self.nets = (StyleSinger(cfg, vocab_size).eval(),
                     HifiGanGenerator(cfg).eval())
        self._keys = tuple(frozenset(net.state_dict()) for net in self.nets)
        self._tables = {torch.device("cpu"): tuple(
            {k: b for k, b in net.named_buffers() if k not in keys}
            for net, keys in zip(self.nets, self._keys))}
        for net in self.nets:
            net.to_empty(device="meta")

    def _tables_on(self, device: torch.device) -> Tuple[Params, Params]:
        if device not in self._tables:
            cpu = self._tables[torch.device("cpu")]
            self._tables[device] = tuple({k: b.to(device) for k, b in
                                          t.items()} for t in cpu)
        return self._tables[device]

    def run(self, params: Params, voc_params: Params,
            batch: Dict[str, torch.Tensor], source) -> Tuple[torch.Tensor,
                                                             ...]:
        """The step with the noise source ``source``."""
        for keys, given, what in zip(self._keys, (params, voc_params),
                                     ("params", "voc_params")):
            if set(given) != keys:
                raise KeyError(f"{what}: missing "
                               f"{sorted(keys - set(given))[:4]}, unknown "
                               f"{sorted(set(given) - keys)[:4]}")
        (model, vocoder), (tables, voc_tables) = \
            self.nets, self._tables_on(batch["txt_tokens"].device)
        call = torch.func.functional_call
        # (a grad-mode switch inside a traced function costs export a pass
        # over the whole graph: export runs under no_grad already)
        with torch.no_grad() if torch.is_grad_enabled() else \
                contextlib.nullcontext():
            ret = call(model, {**tables, **params}, (), dict(
                batch, noise=source, max_frames=self.max_frames))
            wav = call(vocoder, {**voc_tables, **voc_params},
                       (ret["mel_out"], ret["f0_denorm"], source))
        return wav, ret["mel_out"], ret["f0_denorm"], ret["mel2ph"]

    def forward(self, params: Params, voc_params: Params,
                batch: Dict[str, torch.Tensor],
                noise: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        source = TensorNoise(noise)
        out = self.run(params, voc_params, batch, source)
        if not source.done():
            raise ValueError(f"noise: {len(noise)} tensors, the step drew "
                             "fewer")
        return out

    def draws(self, params: Params, voc_params: Params,
              batch: Dict[str, torch.Tensor]) -> List[tuple]:
        """The step's draws at this batch's shapes, in order: (method,
        arguments, dtype) each (one run of the step)."""
        rec = RecordingNoise(Noise(0, batch["txt_tokens"].device))
        self.run(params, voc_params, batch, rec)
        return rec.draws


def make_synthesize_fn(cfg: Any, vocab_size: int,
                       max_frames: Optional[int] = None) -> Synthesizer:
    """The full zero-shot synthesis step as one pure function:
    ``(params, voc_params, batch, noise) -> (wav, mel, f0_denorm,
    mel2ph)`` (:class:`Synthesizer`).  Mirrors
    ``StyleSingerInfer.forward_model`` (``inference.py``), which crops the
    same outputs to the predicted length."""
    return Synthesizer(cfg, vocab_size, max_frames)


def _example_batch(cfg: Any, vocab_size: int, batch: int, t_txt: int,
                   t_ref: int, device: Union[str, torch.device] = "cpu",
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded batch of the bucket's shapes (the values of JAX's
    ``_example_batch``'s ranges)."""
    rng = np.random.default_rng(seed)
    m = cfg["audio_num_mel_bins"]
    arrays = dict(
        txt_tokens=rng.integers(1, vocab_size, (batch, t_txt)),
        spk_embed=rng.standard_normal((batch, 256)),
        emo_embed=rng.standard_normal((batch, 256)),
        ref_mels=rng.standard_normal((batch, t_ref, m)) * 0.5 - 2.0,
        ref_f0=rng.uniform(7.0, 9.0, (batch, t_ref)),
        note=rng.integers(40, 80, (batch, t_txt)),
        note_dur=rng.uniform(0.08, 0.5, (batch, t_txt)),
        note_type=np.ones((batch, t_txt), np.int64))
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype.kind == "i"
                               else torch.float32, device=device)
            for k, v in arrays.items()}


def _init_variables(cfg: Any, vocab_size: int, batch: int, t_txt: int,
                    t_ref: int, device: Union[str, torch.device] = "cpu",
                    seed: int = 0) -> Tuple[Params, Params,
                                            Dict[str, torch.Tensor]]:
    """Seeded random weights of the right structure (the acoustic model's
    and the vocoder's state dicts, ``inference.init_random_`` from
    ``torch.Generator(seed)``, the vocoder's convs N(0, 0.01)) and an
    example batch, all on ``device``."""
    from stylesinger_torch.inference import init_random_

    g = torch.Generator().manual_seed(seed)
    model, vocoder = StyleSinger(cfg, vocab_size), HifiGanGenerator(cfg)
    init_random_(model, g)
    init_random_(vocoder, g, 0.01)
    return ({k: v.to(device) for k, v in model.state_dict().items()},
            {k: v.to(device) for k, v in vocoder.state_dict().items()},
            _example_batch(cfg, vocab_size, batch, t_txt, t_ref, device))


def noise_from_seed(draws: Union[torch.export.ExportedProgram,
                                 Sequence[tuple]], seed: int,
                    device: Union[str, torch.device, None] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The ``noise`` argument for a seed: what ``Noise(seed, device)``
    draws for ``draws`` (an exported synthesizer's, or a list from
    :meth:`Synthesizer.draws`), in order.  ``device`` defaults to the
    artifact's."""
    if isinstance(draws, torch.export.ExportedProgram):
        device = device if device is not None else draws.synth_device
        draws = draws.draws
    return draw_values(draws, Noise(seed, device if device is not None
                                    else "cuda"))


def export_synthesizer(cfg: Any, vocab_size: int, *, batch: int = 1,
                       t_txt: int = 96, t_ref: int = 512,
                       max_frames: Optional[int] = None,
                       device: Union[str, torch.device] = "cuda",
                       variables: Optional[Params] = None,
                       voc_variables: Optional[Params] = None
                       ) -> torch.export.ExportedProgram:
    """``torch.export`` of the synthesis function for one serving bucket
    (batch, t_txt, t_ref -> max_frames) on ``device``, under
    ``torch.no_grad()``.  The weights, the batch and the draws are inputs
    of the program; ``variables`` / ``voc_variables`` (state dicts; seeded
    random weights when omitted) serve as examples of their shapes, and
    the step runs once on them to list its draws.  The program carries
    that list as ``.draws``, its device as ``.synth_device``
    (:func:`noise_from_seed`) and its dict arguments' key orders as
    ``.synth_keys`` (:func:`synthesize`)."""
    device = torch.device(device)
    if variables is None or voc_variables is None:
        variables, voc_variables, example = _init_variables(
            cfg, vocab_size, batch, t_txt, t_ref, device)
    else:
        example = _example_batch(cfg, vocab_size, batch, t_txt, t_ref,
                                 device)
    params = {k: v.detach().to(device) for k, v in variables.items()}
    voc_params = {k: v.detach().to(device) for k, v in voc_variables.items()}
    fn = make_synthesize_fn(cfg, vocab_size, max_frames)
    draws = fn.draws(params, voc_params, example)
    noise = draw_values(draws, Noise(0, device))
    with torch.no_grad():
        exported = torch.export.export(
            fn, (params, voc_params, example, noise), strict=False)
    exported.example_inputs = None  # else the artifact would carry weights
    return _annotate(exported, draws, device,
                     [list(d) for d in (params, voc_params, example)])


def _annotate(exported: torch.export.ExportedProgram, draws: Sequence[tuple],
              device: torch.device, keys: Sequence[Sequence[str]]
              ) -> torch.export.ExportedProgram:
    exported.draws = [tuple(d) for d in draws]
    exported.synth_device = torch.device(device)
    exported.synth_keys = [list(k) for k in keys]
    return exported


def _signature_to_json(exported: torch.export.ExportedProgram) -> str:
    return json.dumps({"device": str(exported.synth_device),
                       "keys": exported.synth_keys, "draws": [
        [kind, list(args[0]) if kind != "bernoulli" else [args[0],
                                                          list(args[1])],
         list(args[1:]) if kind == "randint" else [], str(dtype)[6:]]
        for kind, args, dtype in exported.draws]})


def _annotate_from_json(exported: torch.export.ExportedProgram,
                        text: str) -> torch.export.ExportedProgram:
    doc = json.loads(text)
    draws = []
    for kind, shape, extra, dtype in doc["draws"]:
        if kind == "bernoulli":
            args = (shape[0], tuple(shape[1]))
        else:
            args = (tuple(shape),) + tuple(extra)
        draws.append((kind, args, getattr(torch, dtype)))
    return _annotate(exported, draws, doc["device"], doc["keys"])


def save_synthesizer(exported: torch.export.ExportedProgram,
                     path: str) -> str:
    """``torch.export.save`` of the program, with its list of draws, its
    device and its dict arguments' key orders."""
    torch.export.save(exported, path, extra_files={
        SIGNATURE_FILE: _signature_to_json(exported)})
    return path


def load_synthesizer(path: str) -> torch.export.ExportedProgram:
    """``torch.export.load`` of a saved synthesizer (this package's
    registration of ``stylesinger::fused_mrf_blocks`` is imported above;
    the model code is not needed), with its module built, ready to call
    with :func:`synthesize`."""
    extra = {SIGNATURE_FILE: ""}
    exported = _annotate_from_json(torch.export.load(path, extra_files=extra),
                                   extra[SIGNATURE_FILE])
    exported.synth_call = exported.module()
    return exported


def synthesize(exported: torch.export.ExportedProgram, params: Params,
               voc_params: Params, batch: Dict[str, torch.Tensor],
               noise: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Calls an exported synthesizer under ``torch.no_grad()``: (wav, mel,
    f0_denorm, mel2ph).  The dicts go in the artifact's key order
    (``torch.export`` takes a dict's values by position, not by key), and
    the program's module is built at the first call and kept."""
    call = getattr(exported, "synth_call", None)
    if call is None:
        call = exported.synth_call = exported.module()
    args = [{k: d[k] for k in keys} for d, keys in
            zip((params, voc_params, batch), exported.synth_keys)]
    with torch.no_grad():
        return call(*args, tuple(noise))
