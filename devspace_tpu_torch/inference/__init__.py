"""Inference: the continuous-batching serving engine, its sampler, and
the train -> serve checkpoint seam.

Exports resolve lazily (PEP 562), as the reference's do: importing a
leaf module such as :mod:`.quantization` (which ``models.convert``
needs) does not load the engine.
"""

_EXPORTS = {
    "load_serving_params": ".checkpoint",
    "InferenceEngine": ".engine",
    "Request": ".engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(mod, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
