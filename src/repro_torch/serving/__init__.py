"""The port's serving core."""
from repro_torch.serving.service import (RankRequest, RankResponse,
                                         RankingService, RerankStats)

__all__ = ["RankRequest", "RankResponse", "RankingService", "RerankStats"]
