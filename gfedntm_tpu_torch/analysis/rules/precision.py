"""GL002 precision-pin: gram-path products run in float64 or with TF32 off.

Ground truth: the gram identity ``||a-b||^2 = ||a||^2 + ||b||^2 - 2ab``
cancels catastrophically for nearby rows — exactly the distances Krum
ranks and the cosines contribution analytics report. On the H100 a
float32 matmul may run in TF32 (10 mantissa bits) when
``torch.backends.cuda.matmul.allow_tf32`` is on, and a bf16 matmul may
reduce in bf16 when ``allow_bf16_reduced_precision_reduction`` is. Neither
exists on the CPU, so a float32 gram or one ``allow_tf32 = True`` passes
every CPU test and is wrong on the card the code exists for. The JAX
rule's per-call ``precision=HIGHEST`` has no torch counterpart; the
port's pin is the operand dtype or the global switch:

- ``federation/device_agg.py`` takes Krum's distances and the
  contribution analytics from grams in float64
  (``DeviceAggEngine._gram``: ``r64 = rows.to(torch.float64)``), which
  TF32 never touches whatever the global setting;
- ``device.resolve_device`` turns TF32 and reduced-precision bf16
  reductions off for the process (``allow_tf32 = False`` for cuBLAS and
  cuDNN, ``allow_bf16_reduced_precision_reduction = False``);
- ``utils/flops.py``'s MFU probe saves ``allow_tf32``, sets it to
  ``False``, measures, and restores the saved value.

Two checks:

(a) **Gram-path scopes** (``federation/device_agg.py``,
    ``federated/aggregation.py``, ``eval/monitor.py``,
    ``utils/flops.py``). A scope is checked when its own statements name
    ``torch``, or when its module imports torch (a gram's operands arrive
    as tensor parameters, and ``rows @ rows.T`` names no torch root).
    Inside it, ``torch.{matmul,mm,bmm,mv,dot,inner,tensordot,einsum}``,
    ``Tensor.{matmul,mm}`` and a bare ``@`` are findings unless

    - every operand is float64-derived: ``.to(torch.float64)``,
      ``.double()``, ``dtype=torch.float64``, or a name bound from one of
      those (taint follows assignments, ``for`` targets and comprehension
      targets in statement order; elementwise arithmetic with a float64
      operand promotes to float64);
    - every operand is numpy-derived (host oracles such as
      ``aggregation.Krum`` and ``monitor._cosine_matrix`` run pure numpy
      and are exempt both ways, as in JAX);
    - the scope first sets ``torch.backends.cuda.matmul.allow_tf32 =
      False`` (or ``set_float32_matmul_precision("highest")``): the flops
      probe's pattern.

(b) **The whole port.** A literal ``True`` assigned to
    ``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32`` or
    ``...allow_bf16_reduced_precision_reduction``, or
    ``torch.set_float32_matmul_precision("high" | "medium")``, is a
    finding wherever it stands: each changes every later product in the
    process, grams included. Restoring a saved value (``= allow``) is not
    a literal and passes.

The training-step products (``train/steps.py``, the model modules, the
kernels) stay out of check (a): their precision is the model's storage
policy, not a gram identity.
"""

from __future__ import annotations

import ast

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
    dotted_name,
    expr_roots,
    iter_scopes,
    walk_scope,
)

TORCH_ROOTS = frozenset({"torch"})
NP_ROOTS = frozenset({"np", "numpy"})
#: ``torch.<fn>`` products.
TORCH_MATMULS = frozenset(
    {"matmul", "mm", "bmm", "mv", "dot", "inner", "tensordot", "einsum"}
)
#: ``<tensor>.<fn>`` products.
TENSOR_MATMULS = frozenset({"matmul", "mm"})
F64_DTYPES = frozenset({"float64", "double"})
#: torch dtype attribute names (a ``.to(<dtype>)`` that names one of these
#: other than float64 casts the tensor away from float64).
TORCH_DTYPES = frozenset({
    "float64", "double", "float32", "float", "float16", "half", "bfloat16",
    "int64", "long", "int32", "int", "int16", "short", "int8", "uint8",
    "bool", "complex64", "complex128", "cfloat", "cdouble",
})
#: Tensor methods that cast to a fixed non-float64 dtype.
CASTS = frozenset({
    "float", "half", "bfloat16", "int", "long", "short", "char", "byte",
    "bool", "cfloat", "cdouble",
})
#: Process-wide switches that let float32/bf16 products lose precision.
SWITCHES = (
    "backends.cuda.matmul.allow_tf32",
    "backends.cudnn.allow_tf32",
    "allow_bf16_reduced_precision_reduction",
)
TF32_SWITCH = "matmul.allow_tf32"
LOSSY_MATMUL_PRECISIONS = frozenset({"high", "medium"})


def _is_dtype(node: ast.AST, names=TORCH_DTYPES) -> bool:
    """``torch.<dtype>`` for a dtype in ``names``."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr in names
        and dotted_name(node) is not None
    )


def _mentions_torch(body: list) -> bool:
    for n in walk_scope(body):
        if isinstance(n, ast.Name) and n.id in TORCH_ROOTS:
            return True
    return False


def _imports_torch(tree: ast.AST) -> bool:
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Import) and any(
            a.name.split(".")[0] == "torch" for a in node.names
        ):
            return True
        if (
            isinstance(node, ast.ImportFrom)
            and node.module
            and node.level == 0
            and node.module.split(".")[0] == "torch"
        ):
            return True
    return False


def _targets(nodes) -> list[str]:
    return [
        n.id for tgt in nodes for n in ast.walk(tgt) if isinstance(n, ast.Name)
    ]


def _f64(node: ast.AST, tainted: set[str]) -> bool:
    """Whether ``node`` evaluates to a float64 tensor, as far as the
    statement-order taint can tell."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        return _f64(node.value, tainted)
    if isinstance(node, ast.UnaryOp):
        return _f64(node.operand, tainted)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.MatMult):
            return _f64(node.left, tainted) and _f64(node.right, tainted)
        # Elementwise arithmetic promotes to the wider float.
        return _f64(node.left, tainted) or _f64(node.right, tainted)
    if isinstance(node, ast.IfExp):
        return _f64(node.body, tainted) and _f64(node.orelse, tainted)
    if isinstance(node, (ast.List, ast.Tuple)):
        return bool(node.elts) and all(_f64(e, tainted) for e in node.elts)
    if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
        return _f64(node.elt, tainted)
    if isinstance(node, ast.Call):
        return _f64_call(node, tainted)
    return False


def _f64_call(node: ast.Call, tainted: set[str]) -> bool:
    for kw in node.keywords:
        if kw.arg == "dtype":
            return _is_dtype(kw.value, F64_DTYPES)
    func = node.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr == "double":
        return True
    if func.attr in CASTS:
        return False
    dotted = dotted_name(func)
    if dotted is not None and dotted.split(".")[0] in TORCH_ROOTS:
        # A torch function: float64 when a float64 operand promotes the
        # result (torch.cat/stack of float64 rows, torch.where, ...).
        return any(_f64(a, tainted) for a in node.args)
    if func.attr in ("to", "type"):
        dtypes = [a for a in node.args if _is_dtype(a)]
        if dtypes:
            return _is_dtype(dtypes[0], F64_DTYPES)
    # A method keeps its receiver's dtype (.T, .t(), .sum(), .clone(),
    # .reshape(), .to(device), ...).
    return _f64(func.value, tainted)


class PrecisionPinRule(Rule):
    id = "GL002"
    name = "precision-pin"
    description = (
        "gram-path torch products take float64 operands or run with TF32 "
        "off; no literal TF32/bf16-reduction switch anywhere in the port"
    )
    default_paths = ("gfedntm_tpu_torch/", "chip_smoke.py")
    #: Check (a)'s modules: the JAX gram-path scope, mapped.
    default_gram_paths = (
        "gfedntm_tpu_torch/federation/device_agg.py",
        "gfedntm_tpu_torch/federated/aggregation.py",
        "gfedntm_tpu_torch/eval/monitor.py",
        "gfedntm_tpu_torch/utils/flops.py",
    )

    HINT = (
        "take the gram in float64 (r64 = rows.to(torch.float64); "
        "r64 @ r64.T, as device_agg._gram does), or set "
        "torch.backends.cuda.matmul.allow_tf32 = False before the product "
        "and restore the saved value after it (utils/flops.py's probe) — "
        "TF32 keeps 10 mantissa bits and the gram identity cancels "
        "catastrophically for nearby rows"
    )
    SWITCH_HINT = (
        "leave TF32 and reduced-precision reductions off "
        "(device.resolve_device turns them off for the process); code "
        "that needs another setting saves the old value and restores it "
        "(= saved), never a literal True"
    )

    def __init__(self, paths: tuple[str, ...] | None = None,
                 gram_paths: tuple[str, ...] | None = None):
        super().__init__(paths)
        # A rule re-scoped onto fixtures runs both checks there.
        if gram_paths is None:
            gram_paths = (
                paths if paths is not None else self.default_gram_paths
            )
        self.gram_paths = gram_paths

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out = self._check_switches(src)
        if any(
            src.rel == p or src.rel.startswith(p) for p in self.gram_paths
        ):
            out.extend(self._check_grams(src))
        return out

    # ---- (b) process-wide switches ------------------------------------
    def _check_switches(self, src: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign):
                if not (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is True
                ):
                    continue
                for tgt in node.targets:
                    name = dotted_name(tgt)
                    if name is not None and name.endswith(SWITCHES):
                        out.append(self.finding(
                            src, node.lineno,
                            f"{name} = True lets every later product in "
                            "the process lose precision, grams included",
                            hint=self.SWITCH_HINT,
                        ))
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr == "set_float32_matmul_precision"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value in LOSSY_MATMUL_PRECISIONS
                ):
                    out.append(self.finding(
                        src, node.lineno,
                        f"{ast.unparse(func)}({node.args[0].value!r}) lets "
                        "every later float32 product in the process run "
                        "in TF32 or bf16 passes, grams included",
                        hint=self.SWITCH_HINT,
                    ))
        return out

    # ---- (a) gram-path products ---------------------------------------
    def _check_grams(self, src: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        module_torch = _imports_torch(src.tree)
        for scope, body in iter_scopes(src.tree):
            if not (
                _mentions_torch(body)
                or (module_torch and scope is not src.tree)
            ):
                continue
            out.extend(self._check_scope(body, src))
        return out

    def _check_scope(self, body: list, src: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        np_tainted: set[str] = set()
        f64: set[str] = set()
        tf32_off = False
        kinds = (
            ast.Assign, ast.For, ast.BinOp, ast.Call, ast.ListComp,
            ast.SetComp, ast.GeneratorExp, ast.DictComp,
        )
        nodes = sorted(
            (n for n in walk_scope(body) if isinstance(n, kinds)),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for node in nodes:
            if isinstance(node, ast.Assign):
                switch = self._tf32_assignment(node)
                if switch is not None:
                    tf32_off = switch
                    continue
                self._propagate_np(node, np_tainted)
                names = _targets(node.targets)
                if _f64(node.value, f64):
                    f64.update(names)
                else:
                    f64.difference_update(names)
            elif isinstance(node, ast.For):
                names = _targets([node.target])
                if _f64(node.iter, f64):
                    f64.update(names)
                else:
                    f64.difference_update(names)
            elif isinstance(
                node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                       ast.DictComp)
            ):
                # Comprehension targets bind before the element runs.
                for gen in node.generators:
                    if _f64(gen.iter, f64):
                        f64.update(_targets([gen.target]))
            elif isinstance(node, ast.Call):
                if self._precision_call(node):
                    tf32_off = True
                    continue
                operands = self._matmul_operands(node)
                if operands is None or tf32_off:
                    continue
                if self._pinned(operands, f64, np_tainted):
                    continue
                out.append(self.finding(
                    src, node.lineno,
                    f"{ast.unparse(node.func)}() in a gram-path module has "
                    "neither float64 operands nor TF32 off",
                    hint=self.HINT,
                ))
            elif isinstance(node.op, ast.MatMult) and not tf32_off:
                if self._pinned([node.left, node.right], f64, np_tainted):
                    continue
                out.append(self.finding(
                    src, node.lineno,
                    "bare '@' matmul in a torch scope has neither float64 "
                    "operands nor TF32 off",
                    hint=self.HINT,
                ))
        return out

    @staticmethod
    def _tf32_assignment(node: ast.Assign) -> bool | None:
        """``True`` for ``...matmul.allow_tf32 = False`` (TF32 off from
        here), ``False`` for any other assignment to it (a restore), None
        when the statement does not touch the switch."""
        for tgt in node.targets:
            name = dotted_name(tgt)
            if name is not None and name.endswith(TF32_SWITCH):
                return (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is False
                )
        return None

    @staticmethod
    def _precision_call(node: ast.Call) -> bool:
        """``torch.set_float32_matmul_precision("highest")``."""
        func = node.func
        return (
            isinstance(func, ast.Attribute)
            and func.attr == "set_float32_matmul_precision"
            and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "highest"
        )

    @staticmethod
    def _matmul_operands(node: ast.Call) -> list | None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return None
        dotted = dotted_name(func)
        if dotted is not None and dotted.split(".")[0] in TORCH_ROOTS:
            if func.attr not in TORCH_MATMULS or dotted.count(".") != 1:
                return None
            args = list(node.args)
            if func.attr == "einsum" and args:
                args = args[1:]  # the subscripts string
                if len(args) == 1 and isinstance(args[0], (ast.List, ast.Tuple)):
                    args = list(args[0].elts)
            return args
        if func.attr in TENSOR_MATMULS:
            root = func.value
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name) and root.id in NP_ROOTS:
                return None  # np.matmul: a numpy product
            return [func.value] + list(node.args)
        return None

    def _pinned(self, operands, f64: set[str], np_tainted: set[str]) -> bool:
        if not operands:
            return True
        return all(_f64(o, f64) for o in operands) or all(
            self._np_derived(o, np_tainted) for o in operands
        )

    @staticmethod
    def _propagate_np(node: ast.Assign, tainted: set[str]) -> None:
        roots = expr_roots(node.value)
        is_np = bool(roots & NP_ROOTS) or (
            bool(roots) and roots <= (tainted | NP_ROOTS)
        )
        is_torch = bool(roots & TORCH_ROOTS)
        for name in _targets(node.targets):
            if is_np and not is_torch:
                tainted.add(name)
            else:
                tainted.discard(name)

    @staticmethod
    def _np_derived(node: ast.AST, tainted: set[str]) -> bool:
        roots = expr_roots(node)
        if not roots:
            return False
        return all(r in NP_ROOTS or r in tainted for r in roots)
