from repro_torch.serving.engine import EngineReport, ServingEngine
from repro_torch.serving.request import Microbatch, Request, form_microbatches
from repro_torch.serving.sampling import greedy

__all__ = ["EngineReport", "Microbatch", "Request", "ServingEngine",
           "form_microbatches", "greedy"]
