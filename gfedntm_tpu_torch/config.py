"""Typed configuration for models, training, and federation.

A copy of ``gfedntm_tpu/config.py``, kept here so the port never imports
the JAX package: ``ModelConfig``, ``TrainConfig``, ``FederationConfig``,
``DataConfig``, ``GfedConfig``, ``_coerce`` and ``from_ini``, with the share
lists ``SHARE_ALL`` and ``SHARE_MINIMAL`` as they are (the same tuples as
:mod:`gfedntm_tpu_torch.models.params`). ``tests/test_torch_cli.py`` holds
the source to the original's and the dataclasses to the JAX ones on the
same INI files.

One dataclass-based config system replacing the reference's two mechanisms
(argparse flags in ``main.py:187-205`` + hand-typed INI coercion in
``src/utils/auxiliary_functions.py:387-438``). Defaults mirror
``config/dft_params.cf`` exactly; ``from_ini`` reads the reference's INI
format for drop-in compatibility. The reference's ``grads_to_share`` (CSV
of torch state-dict keys, ``dft_params.cf:50``) selects the port's
state-dict entries by the same names.
"""

from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass, field
from typing import Any

# The reference's operative default: federate the FULL model state — all
# encoder weights, priors, beta, and batch-norm running stats
# (config/dft_params.cf:50). "SHARE_ALL" selects every param/stat leaf.
SHARE_ALL = ("__all__",)
# The reference's code-level default (server.py:71, client.py:205).
SHARE_MINIMAL = ("prior_mean", "prior_variance", "beta")


@dataclass(frozen=True)
class ModelConfig:
    """NTM hyperparameters (reference: ``[ntms]`` in dft_params.cf:6-31)."""

    n_components: int = 50
    model_type: str = "prodLDA"  # 'prodLDA' | 'LDA'
    hidden_sizes: tuple[int, ...] = (50, 50)
    activation: str = "softplus"
    dropout: float = 0.2
    learn_priors: bool = True
    topic_prior_mean: float = 0.0
    topic_prior_variance: float | None = None
    # CTM-only:
    ctm_model_type: str = "CombinedTM"  # 'CombinedTM' | 'ZeroShotTM'
    contextual_size: int = 768
    label_size: int = 0
    loss_beta_weight: float = 1.0  # ctm.py:148 weights["beta"]

    def inference_type(self, family: str) -> str:
        if family == "avitm":
            return "bow"
        return "combined" if self.ctm_model_type.lower() == "combinedtm" else "zeroshot"


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop hyperparameters (dft_params.cf:8-29)."""

    batch_size: int = 64
    lr: float = 2e-3
    momentum: float = 0.99  # Adam beta1 (avitm.py:142-143: betas=(momentum, 0.99))
    solver: str = "adam"  # adam | sgd | adagrad | adadelta | rmsprop
    num_epochs: int = 100
    num_samples: int = 20  # MC passes for theta inference
    reduce_on_plateau: bool = False
    thetas_thr: float = 3e-3  # federated_model.py:172 threshold
    seed: int = 0
    # TPU-specific:
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclass(frozen=True)
class FederationConfig:
    """Federation topology + sharing policy (dft_params.cf:46-50)."""

    n_clients: int = 1
    grads_to_share: tuple[str, ...] = SHARE_ALL
    max_iters: int = 25_000  # server-driven global step cap (main.py:204)
    mesh_axis: str = "clients"


@dataclass(frozen=True)
class DataConfig:
    """Vocabulary / vectorization settings (dft_params.cf:31, client.py:358-376)."""

    max_features: int = 2000
    lowercase: bool = True
    stop_words: str | None = None  # 'english' for prepare_dataset parity
    val_fraction: float = 0.25  # data_preparation.py:30 train/val split
    split_seed: int = 42


@dataclass(frozen=True)
class GfedConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    federation: FederationConfig = field(default_factory=FederationConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def replace(self, **sections) -> "GfedConfig":
        return dataclasses.replace(self, **sections)


def _coerce(value: str) -> Any:
    """Typed coercion matching ``read_config_experiments``
    (auxiliary_functions.py:387-438): int, float, bool, tuple, None, str."""
    s = value.strip()
    if s == "":
        return None
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if s.startswith("(") and s.endswith(")"):
        inner = [p.strip() for p in s[1:-1].split(",") if p.strip()]
        return tuple(int(p) for p in inner)
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def from_ini(path: str) -> GfedConfig:
    """Read a reference-format INI file (``config/dft_params.cf``)."""
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_file(f)

    raw: dict[str, Any] = {}
    for section in cp.sections():
        for key, val in cp.items(section):
            raw[key] = _coerce(val)

    def pick(cls, **overrides):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in names and v is not None}
        kwargs.update(overrides)
        return cls(**kwargs)

    model = pick(ModelConfig)
    train = pick(TrainConfig)
    data = pick(DataConfig)

    gts = raw.get("grads_to_share")
    fed_kwargs: dict[str, Any] = {}
    if isinstance(gts, str):
        fed_kwargs["grads_to_share"] = tuple(
            t.strip() for t in gts.split(",") if t.strip()
        )
    federation = pick(FederationConfig, **fed_kwargs)
    return GfedConfig(model=model, train=train, federation=federation, data=data)
