"""The train step, trainer, sampling, checkpoints and bulk generation of
the port.

The names below are imported on first use (PEP 562): the trainer imports
the data layer and ``utils``, and ``utils.misc`` imports
``train.checkpoint``, so importing the trainer here would close a cycle.
"""

import importlib

_SOURCES = {
    "ExperimentConfig": "trainer",
    "GANState": "train_step",
    "PDGNTrainer": "trainer",
    "TrainConfig": "train_step",
    "init_state": "train_step",
    "make_batched_sampler": "sampler",
    "make_optimizer": "train_step",
    "make_sampler": "sampler",
    "normalize_point_clouds": "trainer",
}

# names of pdgn_tpu.train.__all__ that the port has no counterpart of, and
# why
NOT_PORTED = {
    "NetState": "the port keeps each model and its optimizer in GANState "
                "(no separate params/batch_stats/opt_state triple)",
    "make_train_step": "the port's step is train.train_step.train_step, "
                       "called as it is: there is no jitted step to build",
}

__all__ = sorted(_SOURCES)


def __getattr__(name: str):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_SOURCES[name]}"),
                   name)
