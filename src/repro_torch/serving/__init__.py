# Beyond-paper integration: the paper's cache-based MQO applied to LLM
# serving (shared-prefix admission under a device-memory budget).
from .costs import ServingCostModel
from .engine import ServingEngine, ServingReport
from .request import GenerationRequest, TokenBlock, plan_requests
