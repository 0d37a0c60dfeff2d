"""GL004 lock-discipline: guarded attributes mutate only under their lock.

A copy of the JAX rule. It is driven by annotations, so its scope is the
whole port: the ``# guarded-by:`` comments came along with the copied
control plane (``federation/registry.py``, ``server.py``, ``client.py``,
``pacing.py``, ``relay.py``, ``serving/service.py``).

The federation control plane is multi-threaded: gRPC servicer threads
(OfferVocab / ReadyForTraining / disconnects) race the training loop and
its poll/push pool workers. Shared mutable state is declared with a
``# guarded-by: <lock>[, <lock2>...]`` comment on the attribute's
declaration line (a dataclass field, or its ``__init__`` assignment):

    self._push_acked: set[int] = set()  # guarded-by: _push_lock
    _clients: dict = field(default_factory=dict)  # guarded-by: _lock, _cond

Naming several locks means holding ANY of them suffices — the idiom for
a ``threading.Condition`` wrapping the same ``RLock`` (``with
self._cond:`` acquires ``_lock``).

The rule then checks every method of the class: assignments to
``self.<attr>``, item/attribute stores through it, ``del``, and calls to
known mutator methods (``add``/``discard``/``pop``/``update``/...) must
sit lexically inside ``with self.<lock>:`` for one of the declared
locks. ``__init__``/``__post_init__`` are exempt (construction
happens-before publication), and a nested function body does NOT
inherit the enclosing ``with`` — closures handed to thread pools run
after the lock is released, which is exactly the bug class this catches.
Reads are not checked (snapshot-read-then-act patterns are reviewed by
humans); the write side is what corrupts registries.
"""

from __future__ import annotations

import ast
import re

from gfedntm_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
)

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([\w, |]+)")

#: Mutating container/set/dict/list method names.
MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "pop", "popitem", "popleft", "remove", "reverse",
    "setdefault", "sort", "update",
})

EXEMPT_METHODS = frozenset({"__init__", "__post_init__"})


def _guarded_decls(cls: ast.ClassDef, src: SourceFile) -> dict[str, tuple[str, ...]]:
    """Attribute -> allowed locks, from guarded-by comments on class-level
    field declarations and ``__init__``/``__post_init__`` self-assignments."""
    decls: dict[str, tuple[str, ...]] = {}

    def note(attr: str, line: int) -> None:
        m = GUARDED_BY_RE.search(src.lines[line - 1]) if line <= len(src.lines) else None
        if m:
            locks = tuple(
                p.strip() for p in re.split(r"[|,]", m.group(1)) if p.strip()
            )
            if locks:
                decls[attr] = locks

    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            note(stmt.target.id, stmt.lineno)
        elif isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    note(tgt.id, stmt.lineno)
        elif (
            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            and stmt.name in EXEMPT_METHODS
        ):
            for node in ast.walk(stmt):
                attr = _self_attr_target(node)
                if attr is not None:
                    note(attr, node.lineno)
    return decls


def _self_attr_target(node: ast.AST) -> str | None:
    """``self.<attr>`` assignment target name for Assign/AnnAssign."""
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for tgt in targets:
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                return tgt.attr
    return None


def _with_locks(node: ast.With) -> set[str]:
    """Lock attribute names acquired by ``with self.<lock>[, ...]:``."""
    out: set[str] = set()
    for item in node.items:
        expr = item.context_expr
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            out.add(expr.attr)
    return out


class LockDisciplineRule(Rule):
    id = "GL004"
    name = "lock-discipline"
    description = (
        "attributes declared '# guarded-by: <lock>' are only mutated "
        "inside 'with self.<lock>:' (closures do not inherit the lock)"
    )
    default_paths = None  # annotation-driven: fires only where declared

    def check_file(self, src: SourceFile, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(node, src))
        return out

    def _check_class(
        self, cls: ast.ClassDef, src: SourceFile
    ) -> list[Finding]:
        guarded = _guarded_decls(cls, src)
        if not guarded:
            return []
        out: list[Finding] = []
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in EXEMPT_METHODS:
                continue
            self._walk(stmt.body, frozenset(), guarded, src, out)
        return out

    def _walk(
        self,
        body: list[ast.stmt],
        held: frozenset[str],
        guarded: dict[str, tuple[str, ...]],
        src: SourceFile,
        out: list[Finding],
    ) -> None:
        """Visit one statement block with the set of lexically held
        locks; recurse into sub-blocks (with-bodies gain their locks,
        nested function bodies LOSE everything — a closure runs when
        called, usually on another thread)."""
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(stmt.body, frozenset(), guarded, src, out)
                continue
            if isinstance(stmt, ast.With):
                self._check_stmt(stmt, held, guarded, src, out)
                self._walk(
                    stmt.body, held | _with_locks(stmt), guarded, src, out
                )
                continue
            self._check_stmt(stmt, held, guarded, src, out)
            for block in self._sub_blocks(stmt):
                self._walk(block, held, guarded, src, out)

    @staticmethod
    def _sub_blocks(stmt: ast.stmt) -> list[list[ast.stmt]]:
        blocks: list[list[ast.stmt]] = []
        for name in ("body", "orelse", "finalbody"):
            child = getattr(stmt, name, None)
            if isinstance(child, list) and child and isinstance(
                child[0], ast.stmt
            ):
                blocks.append(child)
        for handler in getattr(stmt, "handlers", ()):
            blocks.append(handler.body)
        return blocks

    @staticmethod
    def _expr_parts(stmt: ast.stmt):
        """Every expression node belonging to this statement itself —
        pruned at nested statements and nested functions/lambdas."""
        stack: list[ast.AST] = []
        for child in ast.iter_child_nodes(stmt):
            if not isinstance(
                child,
                (ast.stmt, ast.ExceptHandler, ast.FunctionDef,
                 ast.AsyncFunctionDef, ast.Lambda),
            ):
                stack.append(child)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(
                    child,
                    (ast.stmt, ast.ExceptHandler, ast.FunctionDef,
                     ast.AsyncFunctionDef, ast.Lambda),
                ):
                    stack.append(child)

    def _check_stmt(
        self, stmt, held, guarded, src, out
    ) -> None:
        candidates: list[ast.AST] = [stmt]
        candidates.extend(
            n for n in self._expr_parts(stmt) if isinstance(n, ast.Call)
        )
        for node in candidates:
            attr, how = self._mutation(node)
            if attr is None or attr not in guarded:
                continue
            allowed = guarded[attr]
            if not (held & set(allowed)):
                locks = " or ".join(f"self.{lk}" for lk in allowed)
                out.append(self.finding(
                    src, node.lineno,
                    f"self.{attr} is '# guarded-by: "
                    f"{', '.join(allowed)}' but is {how} without "
                    f"holding {locks}",
                    hint=(
                        f"wrap the mutation in 'with self.{allowed[0]}:' "
                        "(note: a closure does not inherit an enclosing "
                        "with-block's lock)"
                    ),
                ))

    def _mutation(self, node: ast.AST) -> tuple[str | None, str]:
        """``(attr, description)`` when this node mutates ``self.<attr>``."""
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for tgt in targets:
                attr = self._target_attr(tgt)
                if attr is not None:
                    return attr, "assigned"
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                attr = self._target_attr(tgt)
                if attr is not None:
                    return attr, "deleted"
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in MUTATORS
            and isinstance(node.func.value, ast.Attribute)
            and isinstance(node.func.value.value, ast.Name)
            and node.func.value.value.id == "self"
        ):
            return (
                node.func.value.attr,
                f"mutated via .{node.func.attr}()",
            )
        return None, ""

    def _target_attr(self, tgt: ast.AST) -> str | None:
        """self.<attr> (direct) or self.<attr>[...] (item store)."""
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
        ):
            return tgt.attr
        return None
    # NOTE: reads are deliberately unchecked — see module docstring.
