"""Measured compute baseline: a plain PyTorch AVITM on the same regime as
the port's bench, on the card or the CPU.

The twin of ``experiments_scripts/torch_baseline.py``. It trains
:class:`_LocalTorchAVITM`, the reference's AVITM
(``src/models/base/pytorchavitm/avitm_network/avitm.py:323-443``) written
again in plain PyTorch; the report's ``impl`` says so. The JAX script's
other model, the reference's own AVITM imported from a checkout of it
(``make_reference_avitm``), waits until that checkout is in the
repository. On the GPU this is BASELINE.json's "PyTorch-GPU" arm: plain
PyTorch and cuBLAS, no kernel of the port.

Regime (the JAX script's): V=5,000, K=50, hidden (50, 50), batch 64,
Adam(lr 2e-3, beta1 0.99), 5 x 2,000 synthetic documents trained centrally.
One warm epoch (the CUDA context, cuBLAS handles and the allocator are paid
there), then ``epochs`` timed epochs of ``_train_epoch``.

:class:`_LocalTorchAVITM` draws its initial weights from a CPU
``torch.Generator`` seeded ``seed``, and its noise, dropout and shuffling
from a generator on its device seeded ``seed + 1``: no draw touches the
global generator.

Run: python -m gfedntm_tpu_torch.experiments_scripts.torch_baseline
[out_json] [epochs] [--device cpu|cuda]; writes
``results_torch/torch_baseline.json`` by default.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch
from torch import nn

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.experiments_scripts import RESULTS, card

class _Dropout(nn.Module):
    """``nn.Dropout`` drawing its mask from ``generator``."""

    def __init__(self, p: float, generator: torch.Generator):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep / (1.0 - self.p)


def _init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """``nn.Linear.reset_parameters`` from ``generator``."""
    nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=generator)
    bound = 1.0 / math.sqrt(layer.in_features)
    nn.init.uniform_(layer.bias, -bound, bound, generator=generator)


class _LocalTorchAVITM:
    """Reference-equivalent torch AVITM for hosts without the reference.

    Same architecture and per-doc compute profile as the reference
    (prodLDA: V -> softplus MLP encoder -> K-dim mu/logvar heads with
    BatchNorm, reparameterized softmax theta -> BN'd beta decode -> V
    softmax; KL + reconstruction loss; Adam(lr 2e-3, beta1 0.99)), in plain
    PyTorch. ``model`` holds every part (its ``state_dict`` is what a
    federated arm averages); ``_train_epoch(loader)`` is the timed boundary.
    """

    def __init__(self, input_size, n_components, hidden_sizes=(50, 50),
                 dropout=0.2, lr=2e-3, beta1=0.99, device=None, seed=0):
        dev = resolve_device(device)
        init = torch.Generator().manual_seed(seed)
        #: The noise, dropout and shuffling draws.
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        layers, prev = [], input_size
        for h in hidden_sizes:
            layers += [nn.Linear(prev, h), nn.Softplus()]
            _init_linear(layers[-2], init)
            prev = h
        self.encoder = nn.Sequential(*layers, _Dropout(dropout, self.generator))
        self.f_mu = nn.Linear(prev, n_components)
        self.f_mu_bn = nn.BatchNorm1d(n_components, affine=False)
        self.f_sigma = nn.Linear(prev, n_components)
        self.f_sigma_bn = nn.BatchNorm1d(n_components, affine=False)
        for layer in (self.f_mu, self.f_sigma):
            _init_linear(layer, init)
        self.beta = nn.Parameter(torch.empty(n_components, input_size))
        nn.init.xavier_uniform_(self.beta, generator=init)
        self.beta_bn = nn.BatchNorm1d(input_size, affine=False)
        self.drop_theta = _Dropout(dropout, self.generator)
        self.prior_mean = nn.Parameter(torch.zeros(n_components))
        self.prior_var = nn.Parameter(
            torch.full((n_components,), 1.0 - 1.0 / n_components)
        )
        self.model = nn.Module()
        for name in ("encoder", "f_mu", "f_mu_bn", "f_sigma", "f_sigma_bn", "beta_bn",
                     "drop_theta"):
            setattr(self.model, name, getattr(self, name))
        for name in ("beta", "prior_mean", "prior_var"):
            self.model.register_parameter(name, getattr(self, name))
        self.model.to(dev)
        self.device = dev
        params = (
            list(self.encoder.parameters()) + list(self.f_mu.parameters())
            + list(self.f_sigma.parameters())
            + [self.beta, self.prior_mean, self.prior_var]
        )
        self.optimizer = torch.optim.Adam(
            params, lr=lr, betas=(beta1, 0.999)
        )

    def _loss(self, x):
        h = self.encoder(x)
        mu = self.f_mu_bn(self.f_mu(h))
        log_var = self.f_sigma_bn(self.f_sigma(h))
        eps = torch.randn(mu.shape, generator=self.generator, device=mu.device, dtype=mu.dtype)
        theta = torch.softmax(mu + eps * torch.exp(0.5 * log_var), dim=1)
        theta = self.drop_theta(theta)
        word_dist = torch.softmax(
            self.beta_bn(torch.matmul(theta, self.beta)), dim=1
        )
        recon = -(x * torch.log(word_dist + 1e-10)).sum(dim=1)
        var = torch.exp(log_var)
        kl = 0.5 * (
            (var / self.prior_var).sum(dim=1)
            + ((self.prior_mean - mu) ** 2 / self.prior_var).sum(dim=1)
            - mu.shape[1]
            + torch.log(self.prior_var).sum() - log_var.sum(dim=1)
        )
        return (recon + kl).sum()

    def step(self, x) -> torch.Tensor:
        """One minibatch forward, backward and Adam step; the loss, on the
        device (no host sync)."""
        self.optimizer.zero_grad()
        loss = self._loss(x)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _train_epoch(self, loader):
        self.model.train()
        total, n = 0.0, 0
        for batch in loader:
            x = batch["X"] if isinstance(batch, dict) else batch
            x = x.float()
            total += float(self.step(x))
            n += x.shape[0]
        return None, total / max(n, 1)


class Batches:
    """``X``'s rows in shuffled minibatches, a new order each epoch (each
    ``iter``), drawn on X's device from ``generator``:
    ``DataLoader(shuffle=True)`` without its host copies."""

    def __init__(self, X: torch.Tensor, batch_size: int, generator: torch.Generator):
        self.X, self.batch_size, self.generator = X, batch_size, generator

    def __iter__(self):
        X = self.X
        order = torch.randperm(X.shape[0], generator=self.generator, device=X.device)
        for i in range(0, X.shape[0], self.batch_size):
            yield X[order[i:i + self.batch_size]]


def run(epochs: int = 3, out_path: str | None = None, device=None,
        vocab: int = 5000, k: int = 50,
        docs_per_node: int = 2000, n_clients: int = 5) -> dict:
    """The baseline (the JAX ``run_torch_baseline``); returns the report,
    written to ``out_path`` when given."""
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus

    dev = resolve_device(device)
    batch = 64
    corpus = generate_synthetic_corpus(
        vocab_size=vocab, n_topics=k, n_docs=docs_per_node,
        nwords=(150, 250), n_nodes=n_clients, frozen_topics=5, seed=0,
        materialize_docs=False,
    )
    X = np.concatenate([node.bow for node in corpus.nodes]).astype(np.float32)

    model = _LocalTorchAVITM(input_size=vocab, n_components=k, hidden_sizes=(50, 50),
                             device=dev)
    loader = Batches(torch.as_tensor(X, device=dev), batch, model.generator)

    # Warm epoch (CUDA context, cuBLAS handles, the allocator), then timed
    # epochs (each ends in a host sync: its loss sum).
    model._train_epoch(loader)
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        _sp, loss = model._train_epoch(loader)
        losses.append(float(loss))
    elapsed = time.perf_counter() - t0

    docs = epochs * X.shape[0]
    report = {
        "impl": "local torch AVITM (reference-equivalent architecture)",
        "source": "src/models/base/pytorchavitm/avitm_network/avitm.py:323-443",
        "docs_per_s": round(docs / elapsed, 1),
        "epoch_s": round(elapsed / epochs, 2),
        "step_ms": round(elapsed / (epochs * np.ceil(X.shape[0] / batch)) * 1e3, 2),
        "epochs_timed": epochs,
        "final_train_loss": losses[-1],
        "device": str(dev),
        "card": card(dev),
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "torch_version": torch.__version__,
        "torch_threads": torch.get_num_threads(),
        "host_cores": len(os.sched_getaffinity(0)),
        "regime": {
            "n_docs": int(X.shape[0]), "vocab": vocab, "k": k,
            "batch": batch, "hidden": [50, 50], "lr": 2e-3,
            "beta1": 0.99,
        },
        "note": (
            "centralized fit = the reference's compute-only best case; its "
            "federated loop adds >=3 s/client/step orchestration on top "
            "(server.py:417-420,472); one warm epoch before the timed ones"
        ),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv: list[str] | None = None) -> int:
    p = device_parser(__doc__)
    p.add_argument("out_json", nargs="?", default=str(RESULTS / "torch_baseline.json"))
    p.add_argument("epochs", nargs="?", type=int, default=3)
    args = p.parse_args(argv)
    report = run(epochs=args.epochs, out_path=args.out_json, device=args.device)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
