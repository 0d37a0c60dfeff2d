"""FLOP and MFU accounting of the port (``gfedntm_tpu_torch.utils.flops``)
against the analytic model count and the JAX package's XLA count, on the
CPU.

The port counts one training step's GEMMs under ``FlopCounterMode``, and
the fused decoder reports its own 2·B·K·V forward and 4·B·K·V backward, so
the fused and the unfused model count the same: the analytic count of the
encoder's layers, the two heads and ``theta @ beta``, times three (forward,
input and weight gradients), less the input layer's unneeded input
gradient. XLA's cost analysis of the JAX step also counts elementwise work,
so the JAX number is larger: the port's lies in [0.75, 1.0] of it.
"""

import numpy as np
import pytest
import torch

from gfedntm_tpu_torch import AVITM, BowDataset, FederatedTrainer
from gfedntm_tpu_torch.ops import fused_decoder as fd
from gfedntm_tpu_torch.parallel.mesh import DpMpGroups
from gfedntm_tpu_torch.parallel.sharded import fit_data_sharded
from gfedntm_tpu_torch.utils import flops
from gfedntm_tpu_torch.utils.observability import MetricsLogger

V, K, H, B = 2000, 20, (64, 64), 64
PEAK_SOURCES = ("nominal-spec", "measured-matmul-probe", "unavailable", "caller")


def analytic_flops(b, v, k, hidden):
    """One step's GEMM FLOPs: forward 2·B·(V·H1 + sum H_i·H_i+1 + 2·H_last·K
    + K·V), times three, less the input layer's input gradient."""
    widths = (v,) + tuple(hidden)
    fwd = sum(a * c for a, c in zip(widths, widths[1:])) + 2 * widths[-1] * k + k * v
    return 3 * 2 * b * fwd - 2 * b * v * hidden[0]


def corpus(n_docs, vocab=V, seed=0):
    rng = np.random.default_rng(seed)
    return BowDataset(X=rng.integers(0, 3, size=(n_docs, vocab)).astype(np.float32),
                      idx2token={i: f"wd{i}" for i in range(vocab)})


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("widths", [(V, K, H, B), (300, 5, (16,), 8), (120, 4, (16, 8, 8), 32)])
def test_step_flops_equal_the_analytic_count(fused, widths):
    v, k, hidden, b = widths
    model = AVITM(input_size=v, n_components=k, hidden_sizes=hidden, batch_size=b,
                  num_epochs=1, fused_decoder=fused, device="cpu")
    before = {k2: p.detach().clone() for k2, p in model.model.state_dict().items()}
    assert model.step_flops(corpus(b // 2 + 1, v)) == analytic_flops(b, v, k, hidden)
    # The count runs on a replica: the model is untouched.
    for key, value in model.model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_fused_loss_reports_its_model_flops_only():
    """The autograd function adds 2·B·K·V forward and 4·B·K·V backward and
    counts nothing inside, though its plain versions run GEMMs here."""
    rng = np.random.default_rng(1)
    b, k, v = 16, 5, 40
    theta = torch.tensor(rng.random((b, k)), dtype=torch.float32, requires_grad=True)
    beta = torch.tensor(rng.normal(size=(k, v)), dtype=torch.float32, requires_grad=True)
    x = torch.tensor(rng.integers(0, 3, size=(b, v)), dtype=torch.float32)

    def step():
        rl, _mean, _var = fd.prodlda_recon_loss(theta, beta, x, torch.zeros(v), torch.ones(v))
        rl.sum().backward()

    assert flops.measure_step_flops(step) == 6 * b * k * v
    assert not flops.counting()
    flops.add_model_flops(1e9)  # outside a measurement: nothing to add to


def test_fit_data_sharded_reports_flops_and_mfu():
    model = AVITM(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=2,
                  fused_decoder=False, device="cpu")
    metrics = MetricsLogger(validate=True)
    summary = fit_data_sharded(model, corpus(200), DpMpGroups(1, 1, 0), metrics=metrics,
                               device="cpu")
    assert summary["flops_per_step"] == analytic_flops(B, V, K, H)
    assert summary["steps_per_epoch"] == 4
    assert summary["flops_per_epoch"] == summary["flops_per_step"] * 4
    assert summary["peak_flops_source"] == "measured-matmul-probe"
    assert summary["mfu"] is not None and summary["mfu"] > 0
    assert metrics.registry.gauge("sharded_mfu").value > 0


def test_port_count_within_the_jax_xla_count():
    """The JAX package's ``fit_data_sharded`` on one CPU device at the same
    widths: XLA's count holds the GEMMs and the elementwise work."""
    from gfedntm_tpu.data.datasets import BowDataset as JBowDataset
    from gfedntm_tpu.models.avitm import AVITM as JAVITM
    from gfedntm_tpu.parallel.sharded import fit_data_sharded as j_fit_data_sharded

    data = corpus(2 * B)
    jmodel = JAVITM(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=1,
                    fused_decoder=False)
    jsummary = j_fit_data_sharded(jmodel, JBowDataset(X=data.X, idx2token=data.idx2token),
                                  n_devices=1)
    model = AVITM(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=1,
                  fused_decoder=False, device="cpu")
    ratio = model.step_flops(data) / jsummary["flops_per_step"]
    assert 0.75 <= ratio <= 1.0, ratio


def test_trainer_sets_the_mfu_gauge():
    template = AVITM(input_size=300, n_components=5, hidden_sizes=(16,), batch_size=8,
                     num_epochs=3, device="cpu")
    metrics = MetricsLogger(validate=True)
    # Segments of 2 steps: the first pays the warm-up, the rest are steady.
    FederatedTrainer(template, n_clients=2, device="cpu").fit(
        [corpus(16, 300, seed=c) for c in range(2)], checkpoint_every=2, metrics=metrics)
    assert metrics.registry.gauge("mfu").value > 0
    assert metrics.registry.gauge("docs_per_s").value > 0


def test_mfu_math_and_guards():
    assert flops.mfu(1e9, 1.0, 2, 1e9) == pytest.approx(0.5)
    assert flops.mfu(None, 1.0, 2, 1e9) is None
    assert flops.mfu(1e9, 0.0, 2, 1e9) is None
    assert flops.mfu(1e9, 1.0, 2, None) is None
    assert flops.mfu(1e9, 1.0, 0, 1e9) is None


def test_peaks_by_card_and_probe(monkeypatch):
    peak, source = flops.resolve_peak_flops_per_device("cpu")
    assert peak > 0 and source == "measured-matmul-probe" and source in PEAK_SOURCES
    for name, want in (("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 NVL", 835.5e12),
                       ("NVIDIA H100 PCIe", 756.5e12), ("NVIDIA H200", 989.4e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda _d=None, n=name: n)
        assert flops.resolve_peak_flops_per_device("cuda:0") == (want, "nominal-spec")
