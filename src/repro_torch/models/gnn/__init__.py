"""GNN models of the port (``repro.models.gnn``): DimeNet, message passing
by gathers and ``index_add``."""
