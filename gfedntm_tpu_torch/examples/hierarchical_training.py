"""Hierarchical (second-level) topic modeling with ``TMWrapper`` over the
port: train a father model, then expand one of its topics into a child
model on the topic-restricted subcorpus.

The twin of ``examples/hierarchical_training.py`` (the reference's
``--hierarchical`` workflow, ``tm_wrapper.py:298-357``: HTM-WS and HTM-DS):
``TMWrapper.train_model`` for the father (B=16), then
``TMWrapper.train_htm_submodel`` for each version (B=8), all on the port's
:class:`~gfedntm_tpu_torch.experiments.tm_wrapper.TMWrapper`. On the GPU
every training step runs the fused decoder's kernels K1-K3.

Run: python -m gfedntm_tpu_torch.examples.hierarchical_training [--device cpu|cuda]
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

from gfedntm_tpu_torch.device import device_parser, resolve_device
from gfedntm_tpu_torch.examples import report

VERSIONS = ("HTM-WS", "HTM-DS")


def run(vocab_size: int = 400, n_topics: int = 6, n_docs: int = 200,
        nwords: tuple[int, int] = (25, 45), frozen_topics: int = 2, seed: int = 0,
        father_kwargs: dict | None = None, child_topics: int = 3,
        child_kwargs: dict | None = None, expansion_topic: int = 0,
        models_root: str | Path | None = None, device=None) -> dict:
    """The script's flow; returns its printed values and the trained models
    (``models["father"]`` and one per version). ``models_root`` defaults to
    a new temporary directory, as the script's ``tempfile.mkdtemp``."""
    from gfedntm_tpu_torch.data.synthetic import generate_synthetic_corpus
    from gfedntm_tpu_torch.experiments.tm_wrapper import TMWrapper

    device = resolve_device(device)
    father_kwargs = father_kwargs or dict(hidden_sizes=(32, 32), num_epochs=5, batch_size=16)
    child_kwargs = child_kwargs or dict(hidden_sizes=(16, 16), num_epochs=3, batch_size=8)
    corpus = generate_synthetic_corpus(
        vocab_size=vocab_size, n_topics=n_topics, n_docs=n_docs, nwords=nwords, n_nodes=1,
        frozen_topics=frozen_topics, seed=seed,
    )
    docs = corpus.nodes[0].documents

    root = Path(models_root) if models_root is not None else Path(
        tempfile.mkdtemp(prefix="htm_"))
    wrapper = TMWrapper(root, device=device)
    father, father_dir = wrapper.train_model(
        "father", docs, model_type="avitm", n_topics=n_topics, model_kwargs=father_kwargs,
    )
    out = {
        "device": str(device),
        "models_root": str(root),
        "father_topics": father.get_topics(6),
        "father_steps": len(father.step_losses),
        "father_final_loss": father.epoch_losses[-1],
        "children": {},
        "models": {"father": father},
    }
    for version in VERSIONS:
        child, child_dir, child_corpus = wrapper.train_htm_submodel(
            version=version,
            father_model=father,
            father_dir=father_dir,
            corpus=docs,
            name=f"child_{version.lower().replace('-', '_')}",
            expansion_topic=expansion_topic,
            model_type="avitm",
            n_topics=child_topics,
            model_kwargs=child_kwargs,
        )
        out["children"][version] = {
            "n_docs": len(child_corpus),
            "dir": str(child_dir),
            "steps": len(child.step_losses),
            "final_loss": child.epoch_losses[-1],
            "topics": child.get_topics(6),
        }
        out["models"][version] = child
    out["steps"] = out["father_steps"] + sum(c["steps"] for c in out["children"].values())
    out["losses"] = [v for model in out["models"].values() for v in model.step_losses]
    return out


def lines(out: dict) -> list[str]:
    """The JAX script's printed lines."""
    text = ["father topics:"] + [f"  {i}: {topic}" for i, topic in
                                 enumerate(out["father_topics"])]
    for version, child in out["children"].items():
        text.append(f"\n{version}: child trained on {child['n_docs']} docs -> {child['dir']}")
        text += [f"  {i}: {topic}" for i, topic in enumerate(child["topics"])]
    return text


def main(argv: list[str] | None = None) -> int:
    return report(run, lines, device_parser(__doc__).parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
