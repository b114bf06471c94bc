"""Serving: the ``ServingEngine`` over fixed request slots.

The continuous batcher and the streaming stack wait for ROADMAP A8; the
reference ``repro.serve.ContinuousBatcher`` can drive this engine.
"""

from .batcher import PendingStep, ServingEngine

__all__ = ["PendingStep", "ServingEngine"]
