"""The port's serving core: the ranking service, its batch engine with the
prefetch thread and straggler policy, the scale-out router and shard
workers (``repro_torch.serving.sharded``), the one-query ``Reranker``
client, the paged device doc cache and the fault injector."""
from repro_torch.serving import faults
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
from repro_torch.serving.sharded import (RankingRouter, ShardWorker,
                                         WorkerHealth)

__all__ = ["BatchEngine", "DeadlinePriorityPolicy", "DeviceDocCache",
           "FaultInjected", "FaultPlan", "FaultSpec", "RankRequest",
           "RankResponse", "RankingRouter", "RankingService", "Reranker",
           "RerankStats", "SchedulerPolicy", "ServiceOverloadError",
           "ServiceStats", "ShardWorker", "WorkerHealth", "faults",
           "validate_doc_routing", "validate_index_compat"]
