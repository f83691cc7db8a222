"""Scale-out serving, the port of ``repro.serving.sharded``: a
:class:`RankingRouter` (admission, one query encode a query, shard-
affinity routing, concurrent timed drains, the retry -> failover ->
degrade ladder, merged stats) over one :class:`ShardWorker` a serving
shard, each owning its shard's ``ShardIndexView``, doc cache and batch
engine.  A doc's bytes never leave the shard that stores them but
through the counted failover; merged scores equal the single-process
``RankingService``'s bit for bit."""
from repro_torch.serving.sharded.router import RankingRouter, WorkerHealth
from repro_torch.serving.sharded.worker import ShardTask, ShardWorker

__all__ = ["RankingRouter", "ShardTask", "ShardWorker", "WorkerHealth"]
