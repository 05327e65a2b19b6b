"""Generator, discriminators and layers of the port.

The names below are imported on first use (PEP 562): the kernels under
``ops/kernels`` import ``models.layers``, and the generator imports the
kernels, so importing the generator here would close a cycle whenever a
kernel module is imported first.
"""

import importlib

_SOURCES = {
    "BilateralBlock": "generator",
    "BilateralUpsampleEdgeConv": "generator",
    "EdgeConv": "generator",
    "PointDiscriminator": "discriminator",
    "PointDiscriminator1": "discriminator",
    "PointDiscriminator2": "discriminator",
    "PointDiscriminator3": "discriminator",
    "PointDiscriminator4": "discriminator",
    "PointGenerator": "generator",
    "UpsampleEdgeConv": "generator",
}

__all__ = sorted(_SOURCES)


def __getattr__(name: str):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_SOURCES[name]}"),
                   name)
