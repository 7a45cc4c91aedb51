"""Serving layer of the port::

    from repro_torch.serving import LLM, SamplingParams
"""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.llm import LLM
from repro_torch.serving.params import RequestOutput, SamplingParams
from repro_torch.serving.scheduler import (PrefillChunk, RequestState,
                                           Scheduler, Sequence, StepPlan)

__all__ = ["LLM", "SamplingParams", "RequestOutput", "ServingEngine",
           "RequestState", "Scheduler", "Sequence", "StepPlan",
           "PrefillChunk"]
