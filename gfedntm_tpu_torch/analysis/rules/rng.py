"""GL006 rng-discipline: noise paths must never draw ambient randomness.

Ground truth (the privacy plane): every DP noise draw must be a pure
function of an explicit ``(seed, application index)`` — the accountant's
ledger, the crash-autorecovery contract (a restored server resumes the
exact noise stream), and the host-oracle/device parity tests all depend
on it. On the port the failure shapes come in a numpy and a torch form:

- ``np.random.<fn>(...)`` **module-level** draws (``np.random.normal``,
  ``np.random.rand``, even ``np.random.seed`` — mutating the ambient
  global stream is as bad as reading it): any other library touching
  the global ``RandomState`` silently reorders the draws. The seeded
  factories (``np.random.default_rng``, ``Generator``, ``PCG64``, ...)
  are the sanctioned spelling and stay quiet. (A copy of the JAX check.)
- a torch draw from the **global generator**: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``normal``, ``bernoulli``, ``multinomial``
  or ``poisson``, or an in-place ``Tensor.normal_``, ``uniform_``,
  ``bernoulli_``, ``exponential_``, ``random_``, ``cauchy_``,
  ``geometric_`` or ``log_normal_``, with no ``generator=`` keyword. The
  global generator is shared with every other draw in the process (model
  init, dropout, a library), so the noise stream depends on whatever ran
  before it.
- **global seeding**: ``torch.manual_seed``, ``torch.seed``,
  ``torch.random.manual_seed`` / ``seed`` and ``torch.cuda.manual_seed``
  / ``manual_seed_all`` / ``seed`` / ``seed_all`` reseed the ambient
  stream — the twin of ``np.random.seed``.
- a **hard-coded generator seed**, ``<generator>.manual_seed(<int
  literal>)`` or ``torch.Generator(...).manual_seed(<int literal>)``:
  every process draws the SAME stream, so per-client / per-round noise is
  perfectly correlated — exactly the independence assumption the RDP
  composition theorem needs. This is the twin of the JAX rule's
  ``PRNGKey(<literal>)``. A seed must derive from one that was passed in
  (``gen.manual_seed(noise_seed(seed, index))``, as
  ``DeviceAggEngine.noise_vector`` seeds its Philox generator).

Scope: the privacy package plus the two aggregation modules whose
noise/estimator paths the mechanisms ride through. Test files configure
the rule onto fixtures; the live-repo self-run must stay clean.
"""

from __future__ import annotations

import ast

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
    dotted_name,
)

NP_ROOTS = frozenset({"np", "numpy"})

#: ``np.random.<name>`` attributes that are seeded constructors / types,
#: not draws from (or mutations of) the ambient global stream.
SEEDED_FACTORIES = frozenset({
    "default_rng",
    "Generator",
    "SeedSequence",
    "BitGenerator",
    "Philox",
    "PCG64",
    "PCG64DXSM",
    "MT19937",
    "SFC64",
})

#: ``torch.<fn>`` draws that take a ``generator=`` keyword.
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson",
})

#: In-place ``Tensor.<fn>_`` draws that take a ``generator=`` keyword.
INPLACE_DRAWS = frozenset({
    "normal_", "uniform_", "bernoulli_", "exponential_", "random_",
    "cauchy_", "geometric_", "log_normal_",
})

#: Dotted calls that reseed torch's ambient (CPU or CUDA) generators.
GLOBAL_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed",
    "torch.random.manual_seed", "torch.random.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
})


def _np_random_fn(func: ast.AST) -> str | None:
    """``np.random.<fn>`` / ``numpy.random.<fn>`` -> ``fn`` (else None)."""
    if not isinstance(func, ast.Attribute):
        return None
    mid = func.value
    if not (isinstance(mid, ast.Attribute) and mid.attr == "random"):
        return None
    if not (isinstance(mid.value, ast.Name) and mid.value.id in NP_ROOTS):
        return None
    return func.attr


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _literal_int(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, int)
        and not isinstance(node.value, bool)
    )


class RngDisciplineRule(Rule):
    id = "GL006"
    name = "rng-discipline"
    description = (
        "noise paths must not draw from np.random's or torch's global "
        "stream, reseed it, or hard-code a generator seed — DP noise is "
        "a pure function of (seed, index)"
    )
    default_paths = (
        "gfedntm_tpu_torch/privacy/",
        "gfedntm_tpu_torch/federation/device_agg.py",
        "gfedntm_tpu_torch/federated/aggregation.py",
    )

    NP_HINT = (
        "draw from an explicitly-seeded generator — "
        "np.random.default_rng((seed, index)) — so the stream is a pure "
        "function of the mechanism seed, not ambient process state"
    )
    TORCH_HINT = (
        "draw from an explicit torch.Generator seeded from (seed, index) "
        "and pass it as generator=, so the stream is a pure function of "
        "the mechanism seed, not of every draw the process made before"
    )
    SEED_HINT = (
        "derive the generator's seed from a seed that was passed in "
        "(gen.manual_seed(noise_seed(seed, index))), never a hard-coded "
        "literal — a constant seed correlates every process's noise"
    )

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = _np_random_fn(node.func)
            if fn is not None and fn not in SEEDED_FACTORIES:
                out.append(self.finding(
                    src, node.lineno,
                    f"np.random.{fn}() draws from (or mutates) the "
                    "ambient global stream in a noise path",
                    hint=self.NP_HINT,
                ))
                continue
            f = self._check_torch(node, src)
            if f is not None:
                out.append(f)
        return out

    def _check_torch(self, node: ast.Call, src: SourceFile) -> Finding | None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return None
        dotted = dotted_name(func)
        if dotted in GLOBAL_SEEDING:
            return self.finding(
                src, node.lineno,
                f"{dotted}() reseeds torch's global generator in a noise "
                "path",
                hint=self.TORCH_HINT,
            )
        if (
            dotted is not None
            and dotted.startswith("torch.")
            and dotted.count(".") == 1
            and func.attr in TORCH_DRAWS
            and not _has_generator(node)
        ):
            return self.finding(
                src, node.lineno,
                f"{dotted}() without generator= draws from torch's global "
                "stream in a noise path",
                hint=self.TORCH_HINT,
            )
        if func.attr in INPLACE_DRAWS and not _has_generator(node):
            return self.finding(
                src, node.lineno,
                f"{ast.unparse(func)}() without generator= draws from "
                "torch's global stream in a noise path",
                hint=self.TORCH_HINT,
            )
        if (
            func.attr == "manual_seed"
            and node.args
            and _literal_int(node.args[0])
        ):
            return self.finding(
                src, node.lineno,
                f"{ast.unparse(func)}({node.args[0].value!r}) hard-codes "
                "the generator seed in a noise path",
                hint=self.SEED_HINT,
            )
        return None
