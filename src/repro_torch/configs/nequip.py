"""NequIP  [arXiv:2101.03164] — the port's copy of ``repro/configs/nequip.py``.

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5 — O(3)-equivariant
interatomic potential; irrep tensor-product message passing with a
deterministic segment sum (see repro_torch.models.gnn.nequip).
"""

from .base import GNNConfig

CONFIG = GNNConfig(
    name="nequip",
    n_layers=5,
    d_hidden=32,
    l_max=2,
    n_rbf=8,
    cutoff=5.0,
    n_species=64,
)
