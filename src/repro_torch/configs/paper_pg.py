"""The paper's own 'architecture': FastPGT tuning workload defaults
(a copy of ``repro/configs/paper_pg.py``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PGWorkload:
    name: str = "paper_pg"
    n: int = 4000           # dataset size (laptop scale; paper: 1e6)
    d: int = 64             # Sift-class dimensionality scaled
    n_queries: int = 200
    k: int = 10
    budget: int = 40        # configs explored (paper: 100)
    batch: int = 10         # mEHVI batch (paper: 10)
    pg: str = "vamana"


CONFIG = PGWorkload()
