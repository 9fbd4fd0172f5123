"""Inference: the continuous-batching serving engine and its sampler."""

from .engine import InferenceEngine, Request

__all__ = ["InferenceEngine", "Request"]
