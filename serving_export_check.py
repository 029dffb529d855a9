"""The serving export (``stylesinger_torch/serving/export.py``) of the
recipe's synthesizer on one GPU, with the recipe's own samplers (100-step
F0 chains and mel diffusion: 300 denoiser calls unrolled into the graph).
``chip_smoke.py`` exports the fast samplers' bucket (``dpm10_f0fast5``: 50
calls) itself; this one takes too long to export for the smoke's time.

``chip_smoke.py``'s ``serving export`` phase, run alone: random weights
from its seed, the bucket of its example phrase and 4 s clip, export on
``cuda``, save, load, four calls on the same draws with TF32 off; the
artifact against the live function and ``forward_model``, and 27 bf16 MRF
launches per call.  Prints the export, save and load seconds, the
artifact's MB, the first and warm call ms, the card's ``nvidia-smi`` name
and power limit, and as the last line ``{"ok": true, ...}``.

Run from the repo root on a machine with a GPU:

    python3 serving_export_check.py
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

REPO = Path(__file__).resolve().parent


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serving_export_check: no CUDA device", file=sys.stderr)
        return 2
    from stylesinger_torch.config import load_config

    t0 = time.perf_counter()
    cfg = load_config(recipe="stylesinger")
    wav = cs.reference_clip(np, sr=cfg["audio_sample_rate"])
    try:
        with tempfile.TemporaryDirectory(dir=REPO) as tmp:
            out = cs.phase_serving_export(t0, torch, np, cfg, "recipe", wav,
                                          Path(tmp))
    except cs.Failure as e:
        print(f"serving_export_check: FAILED: {e}", file=sys.stderr)
        return 1
    print("RESULT " + json.dumps(dict(sampler="recipe", **{
        k: round(v, 2) for k, v in out.items()})))
    print(cs.nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
