"""Experiment harnesses — the reference's L5 layer, rebuilt natively.

Rebuilds `experiments/dss_tss/run_simulation.py` (DSS/TSS simulations),
`experiments/collab_vs_non_collab/train.py` (real-corpus comparisons),
`src/aux_modules/tmWrapper/tm_wrapper.py` (the centralized-baseline harness) and
`aux_scripts/evaluation/wmd.py` (word-mover's-distance evaluation) on top of
the port's model stack — no Java Mallet, Spark, or subprocess launchers. The
counterpart of ``gfedntm_tpu/experiments/``: the same names, every model on
a torch ``device``.
"""

from gfedntm_tpu_torch.experiments.dss_tss import (  # noqa: F401
    SimulationConfig,
    run_iter_simulation,
    run_simulation,
)
from gfedntm_tpu_torch.experiments.tm_wrapper import TMWrapper  # noqa: F401
from gfedntm_tpu_torch.experiments.collab import (  # noqa: F401
    CollabExperimentConfig,
    run_collab_experiment,
)
from gfedntm_tpu_torch.experiments.wmd import (  # noqa: F401
    topic_set_wmd_matrix,
    wmd_centralized_vs_nodes,
)
