"""GL003 donation-safety: donated buffers must not be touched again.

The JAX mechanics, unchanged, over the whole port. PyTorch has no buffer
donation: no port module builds a donating program, and the live port
gives no finding. On the port the rule guards against the JAX idiom being
copied in with a module: a ``donate=True``, ``donate_argnums`` or
``donation_argnums`` build whose inputs are read after the call is the
same use-after-free it was in JAX, wherever it reappears.

Ground truth (the JAX package): ``avitm`` built its epoch program with
``donate=True`` while the fused-decoder fallback path *retried the same
call with the same state arrays* — an execution-time failure of a
donating program leaves its donated inputs deleted, so the retry would
read dead buffers. The same composition hazard applies to any
``jax.jit(..., donate_argnums=...)`` program whose inputs are referenced
after the call.

Mechanics, per function scope:

- a name assigned from a call carrying ``donate=True`` (literal),
  a literal ``donate_argnums=(...)``, or the repo's
  ``donation_argnums((...))`` helper with a literal position tuple is a
  *donating program*; the literal positions are its donated argument
  slots (``donate=True`` alone donates every positional argument —
  conservative, because the build function's convention is unknown
  statically);
- at each later call of that program, the names passed in donated slots
  are *consumed*;
- any ``Load`` of a consumed name after the call — before the name is
  rebound — is a finding. Rebinding through the calling statement's own
  assignment targets (``state = prog(state, ...)``) is the sanctioned
  linear-state pattern and passes; a retry of the program with the same
  name (e.g. in an ``except`` handler) is exactly the fused-fallback
  hazard and fails.
"""

from __future__ import annotations

import ast

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
    iter_scopes,
    walk_scope,
)

#: The JAX package's backend-gated donation helper (its train/steps.py).
DONATION_HELPER = "donation_argnums"


def _literal_positions(node: ast.AST) -> tuple[int, ...] | None:
    """Donated positions from a literal int / tuple-of-ints AST node."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            if not (
                isinstance(elt, ast.Constant) and isinstance(elt.value, int)
            ):
                return None
        return tuple(elt.value for elt in node.elts)
    return None


def _donated_positions(call: ast.Call) -> tuple[int, ...] | None | bool:
    """Classify a call expression: ``False`` when it is not a donating
    build, a position tuple when the donated slots are known, ``None``
    when it donates but the slots are unknown (all positionals)."""
    for kw in call.keywords:
        if kw.arg == "donate":
            if isinstance(kw.value, ast.Constant) and kw.value.value is True:
                return None
            continue
        if kw.arg == "donate_argnums":
            pos = _literal_positions(kw.value)
            if pos is not None:
                return pos
            # donation_argnums((0, 1, 2)[, donate=...]): the repo helper
            # returns its literal argnums on accelerators — donating
            # unless its own donate flag is literally False.
            v = kw.value
            if (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Name)
                and v.func.id == DONATION_HELPER
                and v.args
            ):
                gate_off = any(
                    k.arg == "donate"
                    and isinstance(k.value, ast.Constant)
                    and k.value.value is False
                    for k in v.keywords
                )
                if not gate_off:
                    return _literal_positions(v.args[0])
            continue
    return False


def _pos(node: ast.AST) -> tuple[int, int]:
    return (
        getattr(node, "end_lineno", node.lineno),
        getattr(node, "end_col_offset", node.col_offset),
    )


class DonationSafetyRule(Rule):
    id = "GL003"
    name = "donation-safety"
    description = (
        "arrays passed to a buffer-donating jitted program must not be "
        "referenced after the call (fallback retries included)"
    )
    default_paths = None  # donation can appear anywhere in the package

    HINT = (
        "a donating program deletes its donated inputs even when it "
        "FAILS at execution time — rebind the result "
        "(state = prog(state)), copy before the call "
        "(jax.tree.map(jnp.copy, state)), or build the program with "
        "donate=False on paths that may retry"
    )

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for _scope, body in iter_scopes(src.tree):
            out.extend(self._check_scope(body, src))
        return out

    def _check_scope(
        self, body: list[ast.stmt], src: SourceFile
    ) -> list[Finding]:
        # Pass 1: donating-program names and their donated slots.
        programs: dict[str, tuple[int, ...] | None] = {}
        for node in walk_scope(body):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            donated = _donated_positions(node.value)
            if donated is False:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    programs[tgt.id] = donated
        if not programs:
            return []

        # Pass 2: donation events (call site, consumed names) and name
        # accesses, in source order. An assignment's targets bind AFTER
        # its value evaluates, so target stores are emitted at the
        # statement's END position — `state = prog(state)` rebinds
        # `state` after the donation, which is the sanctioned pattern.
        consumed: list[tuple[tuple[int, int], ast.Call, list[str]]] = []
        accesses: list[tuple[tuple[int, int], str, str, int]] = []
        assign_spans: list[tuple[tuple[int, int], tuple[int, int]]] = []
        for node in walk_scope(body):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in programs
            ):
                slots = programs[node.func.id]
                names = [
                    a.id for i, a in enumerate(node.args)
                    if isinstance(a, ast.Name)
                    and (slots is None or i in slots)
                ]
                if names:
                    consumed.append((_pos(node), node, names))
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                end = _pos(node)
                assign_spans.append(
                    ((node.lineno, node.col_offset), end)
                )
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            accesses.append(
                                (end, n.id, "store", n.lineno)
                            )
                            if isinstance(node, ast.AugAssign):
                                # `x += ...` also READS x, at its own
                                # position — a donated-buffer use.
                                accesses.append((
                                    (n.lineno, n.col_offset), n.id,
                                    "load", n.lineno,
                                ))
        for node in walk_scope(body):
            if not isinstance(node, ast.Name):
                continue
            own = (node.lineno, node.col_offset)
            if isinstance(node.ctx, ast.Load):
                accesses.append((own, node.id, "load", node.lineno))
            elif not any(
                start <= own <= end for start, end in assign_spans
            ):
                # Store/Del outside any assignment (for-targets,
                # with-as, except-as): binds at its own position.
                accesses.append((own, node.id, "store", node.lineno))
        if not consumed:
            return []
        accesses.sort(key=lambda a: a[0])

        out: list[Finding] = []
        flagged: set[tuple[str, int]] = set()
        for call_end, call, names in consumed:
            pending = set(names)
            for pos, name, kind, line in accesses:
                if not pending:
                    break
                if name not in pending:
                    continue
                if kind == "store":
                    # Rebound at-or-after the donating call (the
                    # `state = prog(state)` assign's target store is
                    # emitted at the statement end, which EQUALS the
                    # call end): the old buffer is no longer reachable
                    # through this name.
                    if pos >= call_end:
                        pending.discard(name)
                    continue
                if pos <= call_end:
                    continue
                key = (name, line)
                if key not in flagged:
                    flagged.add(key)
                    out.append(self.finding(
                        src, line,
                        f"{name!r} was donated to "
                        f"{ast.unparse(call.func)}() on line "
                        f"{call.lineno} and is referenced again here",
                        hint=self.HINT,
                    ))
                pending.discard(name)
        return out
