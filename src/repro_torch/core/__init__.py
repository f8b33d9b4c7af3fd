"""Gossip, the minimax problem, DRGDA/DRSGDA, the paper's baselines and the
M_t metric."""
from repro_torch.core.baselines import DMHSGD, GNSDA, GTGDA, GTSRVR
from repro_torch.core.gda import DRGDA, DRSGDA

#: every optimizer by its name in the paper's figures, as the JAX package's
#: ``repro.core.OPTIMIZERS``
OPTIMIZERS = {
    "drgda": DRGDA,
    "drsgda": DRSGDA,
    "gt-gda": GTGDA,
    "gnsd-a": GNSDA,
    "dm-hsgd": DMHSGD,
    "gt-srvr": GTSRVR,
}
