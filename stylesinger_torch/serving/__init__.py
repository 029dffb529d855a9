"""Ahead-of-time serving export (``torch.export``)."""

from stylesinger_torch.serving.export import (  # noqa: F401
    export_synthesizer, load_synthesizer, make_synthesize_fn,
    noise_from_seed, save_synthesizer, synthesize,
)
