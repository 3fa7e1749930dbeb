from repro_torch.serving.engine import EngineReport, ServingEngine
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import greedy

__all__ = ["EngineReport", "Request", "ServingEngine", "greedy"]
