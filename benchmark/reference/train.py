"""Acoustic training worked out again: the plain reference's first three
steps (``plain/train.py``) from the same items, seed and draws, held
against what the program's trainer kept of its own first three:

- ``loss``: each step's total loss, relative to the reference's;
- ``grad1``: the first step's gradient as the optimizer got it (after
  clipping), read from the program's first moments after one step
  (mu / (1 - b1)), by the worst leaf's gap of norms;
- ``change3``: each leaf's change after three steps, by the worst leaf's
  gap of norms, over the leaves whose first gradient in the reference is
  at least a thousandth of the median leaf's (a leaf whose gradient is
  nought to rounding moves under Adam by round-off alone).

A gap of norms is taken against the reference leaf's norm or the median
leaf's, whichever is larger.  The control runs the same three steps with
TF32 on in cuBLAS and cuDNN and holds them against the reference's.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from benchmark.harness.checks import Checks
from benchmark.harness.run_args import precision_as_stated
from benchmark.reference.plain.stylesinger import StyleSinger
from benchmark.reference.plain.train import (
    epoch_batches, first_steps, leaf_gaps, stack_epoch,
)

STEPS = 3
KEEP = 1e-3          # of the median leaf's first gradient


def reference_steps(cfg, items, vocab, device, noises):
    """(the leaves' names, the reference's first steps)."""
    batches = epoch_batches(cfg, items)
    stacked = stack_epoch(batches, device)
    with torch.device(device):
        model = StyleSinger(cfg, vocab)
    names = [n for n, _ in model.named_parameters()]
    return names, first_steps(model, cfg, stacked, len(batches), noises,
                              STEPS)


def worst(checks: Checks, name: str, gaps: List[float],
          names: List[str]) -> None:
    i = int(np.argmax(gaps))
    checks.add(name, gaps[i])
    print(f"train check {name}: worst leaf {names[i]} {gaps[i]!r}",
          file=sys.stderr)


def compare(checks: Checks, ref, totals: List[float],
            grad1: List[torch.Tensor], after3: List[torch.Tensor]) -> None:
    names, (before, ref_totals, ref_g1, ref_after) = ref
    if len(totals) < STEPS:
        checks.fail(f"{len(totals)} steps of the first {STEPS} were kept")
        return
    checks.add("loss", max(abs(a - b) / max(abs(b), 1e-30)
                           for a, b in zip(totals, ref_totals)))
    worst(checks, "grad1", leaf_gaps(grad1, ref_g1), names)
    norms = [float(torch.linalg.vector_norm(g.double())) for g in ref_g1]
    med = float(np.median(norms))
    keep = [n >= KEEP * med for n in norms]
    worst(checks, "change3", leaf_gaps(
        [a - b for a, b in zip(after3, before)],
        [a - b for a, b in zip(ref_after, before)], keep), names)


def check_train(cfg, limits, items, vocab, device, noises, totals, mu1,
                after3) -> Checks:
    checks = Checks(limits)
    if mu1 is None or after3 is None:
        checks.fail("the first three steps were not kept")
        return checks
    precision_as_stated()
    ref = reference_steps(cfg, items, vocab, device, noises)
    b1 = float(cfg["optimizer_adam_beta1"])
    compare(checks, ref, totals, [m / (1 - b1) for m in mu1], after3)
    return checks


def control_train(cfg, limits, items, vocab, device, noises) -> Checks:
    checks = Checks(limits)
    precision_as_stated()
    ref = reference_steps(cfg, items, vocab, device, noises)
    precision_as_stated(allow_tf32=True)
    try:
        _, (_, totals, g1, after) = reference_steps(cfg, items, vocab,
                                                    device, noises)
    finally:
        precision_as_stated()
    compare(checks, ref, totals, g1, after)
    return checks
