from repro_torch.serving.engine import EngineReport, ServingEngine
from repro_torch.serving.request import Microbatch, Request, form_microbatches
from repro_torch.serving.sampling import TopKSampler, greedy

__all__ = ["EngineReport", "Microbatch", "Request", "ServingEngine",
           "TopKSampler", "form_microbatches", "greedy"]
