"""Serving layer of the port::

    from repro_torch.serving import LLM, SamplingParams

Deprecated (one-release shim, as in the reference)::

    from repro_torch.serving import ServingEngine, Request
"""
from repro_torch.serving.engine import (EngineOverloadedError, Request,
                                        ServingEngine)
from repro_torch.serving.faults import (FaultInjector, FaultSpec,
                                        PoisonedDispatchError,
                                        TransientDeviceError, random_schedule)
from repro_torch.serving.llm import LLM
from repro_torch.serving.params import RequestOutput, SamplingParams
from repro_torch.serving.scheduler import (PrefillChunk, RequestState,
                                           Scheduler, Sequence, StepPlan)

__all__ = ["LLM", "SamplingParams", "RequestOutput", "ServingEngine",
           "Request", "RequestState", "Scheduler", "Sequence",
           "StepPlan", "PrefillChunk",
           "EngineOverloadedError", "FaultInjector", "FaultSpec",
           "PoisonedDispatchError", "TransientDeviceError",
           "random_schedule"]
