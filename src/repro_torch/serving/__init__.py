"""The port's serving core: the ranking service, its batch engine and the
paged device doc cache."""
from repro_torch.serving.doc_cache import DeviceDocCache
from repro_torch.serving.service import (BatchEngine, RankRequest,
                                         RankResponse, RankingService,
                                         RerankStats, ServiceStats)

__all__ = ["BatchEngine", "DeviceDocCache", "RankRequest", "RankResponse",
           "RankingService", "RerankStats", "ServiceStats"]
