"""Faults planted under a cell's timed path, each a function that a loop
calls on its system after set-up (``RunArgs.fault``): the CPU tests see
``correct`` come out false with each, and ``readings.py --fault`` reads
what a fault gives on the card.

- ``alter_output(module, what)``: an answer altered where it is produced
  (one element of the module's output moved by ``what``);
- ``frozen_state``: a training step that returns its state unchanged (the
  optimizer's update left out);
- ``half_batch``: half of each training batch left out, the mean taken
  over the rest.
"""

from __future__ import annotations


def alter_output(module, what: float = 0.05):
    def hook(m, args, out):
        out = out.clone().contiguous()
        out.view(-1)[out.numel() // 2] += what
        return out
    return module.register_forward_hook(hook)


def frozen_state(trainer) -> None:
    init = trainer.init_state

    def frozen():
        state = init()
        state.opt._adamw = lambda *args, **kw: None
        return state
    trainer.init_state = frozen


def half_batch(trainer) -> None:
    """Wraps ``training.step.train_step`` for the rest of the process (a
    test undoes it)."""
    from stylesinger_torch.training import step as step_mod

    whole = step_mod.train_step

    def half(state, batch, *args, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return whole(state, {k: v[:rows] for k, v in batch.items()}, *args,
                     **kw)
    step_mod.train_step = half


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch}
