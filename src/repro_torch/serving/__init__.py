"""The port's serving core: the ranking service, its batch engine with the
prefetch thread and straggler policy, the one-query ``Reranker`` client,
the paged device doc cache and the fault injector."""
from repro_torch.serving.doc_cache import DeviceDocCache
from repro_torch.serving.faults import FaultInjected, FaultPlan, FaultSpec
from repro_torch.serving.reranker import Reranker
from repro_torch.serving.service import (BatchEngine, DeadlinePriorityPolicy,
                                         RankRequest, RankResponse,
                                         RankingService, RerankStats,
                                         SchedulerPolicy,
                                         ServiceOverloadError, ServiceStats,
                                         validate_doc_routing,
                                         validate_index_compat)

__all__ = ["BatchEngine", "DeadlinePriorityPolicy", "DeviceDocCache",
           "FaultInjected", "FaultPlan", "FaultSpec", "RankRequest",
           "RankResponse", "RankingService", "Reranker", "RerankStats",
           "SchedulerPolicy", "ServiceOverloadError", "ServiceStats",
           "validate_doc_routing", "validate_index_compat"]
