"""The port's static-analysis suite (``gfedntm_tpu_torch/analysis``) on the CPU.

- On every fixture of ``tests/test_analysis.py`` that the two suites share
  (core suppressions and the parse error, GL001 under a fixture contract,
  GL003, GL004 and GL005, GL006's numpy cases, the baseline round trip and
  expiry, the CLI's exit codes), the port's rules give the JAX rules'
  findings: the same ``(rule_id, rule_name, path, line, message, hint)``.
- GL002 and GL006 catch the torch violations they exist for (a float32
  gram, an unpinned ``torch.mm``, a literal TF32 switch; a draw from
  torch's global generator, global seeding, a literal generator seed) and
  stay quiet on the port's own patterns.
- A self-run over the live port: no finding outside the port's baseline,
  every baseline entry justified and live, the whole package and
  ``chip_smoke.py`` scanned, the JAX rule ids and names, and the port's
  span names and required-event groups equal to the JAX ones.
- Seeded mutations of a copy of the live port fire each rule at the
  mutated file, and ``python -m gfedntm_tpu_torch.analysis`` keeps its exit
  codes and loads nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from gfedntm_tpu.analysis import run_lint as j_run_lint
from gfedntm_tpu.analysis import baseline as j_baseline
from gfedntm_tpu.analysis.__main__ import main as j_main
from gfedntm_tpu.analysis.rules import make_default_rules as j_rules
from gfedntm_tpu_torch.analysis import run_lint
from gfedntm_tpu_torch.analysis import baseline as p_baseline
from gfedntm_tpu_torch.analysis.__main__ import main as p_main
from gfedntm_tpu_torch.analysis.core import collect_default_files
from gfedntm_tpu_torch.analysis.rules import make_default_rules
from gfedntm_tpu_torch.analysis.rules.precision import PrecisionPinRule
from gfedntm_tpu_torch.analysis.rules.rng import RngDisciplineRule
from gfedntm_tpu_torch.analysis.runner import default_baseline_path, repo_root

REPO = Path(__file__).resolve().parents[1]
EVERYWHERE = ("",)  # path-prefix scope matching every fixture file
GROUPS = ("DATA_PLANE_EVENTS", "MODEL_QUALITY_EVENTS", "SCALEOUT_EVENTS",
          "SERVING_EVENTS", "SCENARIO_EVENTS", "FLEET_EVENTS", "SURVIVAL_EVENTS",
          "PRIVACY_EVENTS", "INCIDENT_EVENTS")
JAX_NAMES = ("telemetry-contract", "precision-pin", "donation-safety",
             "lock-discipline", "exception-hygiene", "rng-discipline")


def _rule(factory, name):
    rule = next(r for r in factory() if r.name == name)
    return type(rule)(paths=EVERYWHERE)


def _lint(run, root: Path, rule, source: str, name: str, options=None) -> list:
    root.mkdir(parents=True, exist_ok=True)
    path = root / name
    path.write_text(textwrap.dedent(source))
    result = run(root=str(root), paths=[str(path)], rules=[rule],
                 use_baseline=False, options=options)
    return [(f.rule_id, f.rule_name, f.path, f.line, f.message, f.hint)
            for f in result.new]


# ---- E1: the shared fixtures, through both packages' rules ---------------------

BAD_EXCEPT = """
try:
    x = 1
except Exception:
    pass
"""


def _contract(**over):
    base = {"events": {"good_event": frozenset({"x"})}, "required": {},
            "spans": (), "schema_module": "schemas.py"}
    base.update(over)
    return {"telemetry": base}


_SURVIVAL = {"relay_recovered": frozenset({"relay", "round"}),
             "member_rehomed": frozenset({"client"}),
             "journal_write_failed": frozenset({"round", "error"})}
_SURVIVAL_SRC = ('metrics.log("relay_recovered", relay=1, round=3)\n'
                 'metrics.log("member_rehomed", client=2)\n')
_INCIDENT = {"incident_captured": frozenset({"reason", "incident_id", "records", "path"}),
             "flightrec_requested": frozenset({"incident_id", "reason"}),
             "flightrec_received": frozenset({"incident_id"})}
_INCIDENT_SRC = ('metrics.log("incident_captured", reason="r", incident_id="i", '
                 'records=1, path="p")\n'
                 'metrics.log("flightrec_requested", incident_id="i", reason="r")\n')

_LOCK_HEADER = """
import threading

class Registry:
    def __init__(self):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._items = {}  # guarded-by: _lock, _cond

"""


def _locked(methods: str) -> str:
    return textwrap.dedent(_LOCK_HEADER) + textwrap.indent(textwrap.dedent(methods), "    ")


def _handler(body: str, catch="Exception", bind="") -> str:
    clause = f"except {catch}{bind}:" if catch else "except:"
    body = textwrap.indent(textwrap.dedent(body).strip("\n"), "        ")
    return ("import logging\nlogger = logging.getLogger(__name__)\n\n"
            "def f(metrics):\n    try:\n        risky()\n"
            f"    {clause}\n{body}\n")


#: (case id, rule name, fixture source, options)
FIXTURES = [
    # core: suppressions and the parse error
    ("core-silent-except", "exception-hygiene", BAD_EXCEPT, None),
    ("core-suppress-same-line", "exception-hygiene", BAD_EXCEPT.replace(
        "except Exception:", "except Exception:  # graftlint: disable=exception-hygiene"), None),
    ("core-suppress-line-above", "exception-hygiene", BAD_EXCEPT.replace(
        "except Exception:", "# graftlint: disable=exception-hygiene -- probe, silence is"
        "\n# the answer here\nexcept Exception:"), None),
    ("core-suppress-other-rule", "exception-hygiene", BAD_EXCEPT.replace(
        "except Exception:", "except Exception:  # graftlint: disable=precision-pin"), None),
    ("core-suppress-all", "exception-hygiene", BAD_EXCEPT.replace(
        "except Exception:", "except Exception:  # graftlint: disable=all"), None),
    ("core-parse-error", "exception-hygiene", "def broken(:\n    pass\n", None),
    # GL001 under a fixture contract
    ("gl001-unregistered", "telemetry-contract",
     'metrics.log("rogue_event", x=1)\n', _contract()),
    ("gl001-registered", "telemetry-contract",
     'metrics.log("good_event", x=1)\n', _contract()),
    ("gl001-required-unemitted", "telemetry-contract", 'metrics.log("good_event", x=1)\n',
     _contract(events={"good_event": frozenset(), "guard_event": frozenset()},
               required={"DEFENSE": ("guard_event",)})),
    ("gl001-required-unregistered", "telemetry-contract",
     'metrics.log("good_event", x=1)\nmetrics.log("good_event", x=2)\n',
     _contract(required={"DEFENSE": ("gone_event",)})),
    ("gl001-missing-span", "telemetry-contract",
     'metrics.log("good_event", x=1)\nwith span(metrics, "poll"):\n    pass\n',
     _contract(spans=("round", "poll"))),
    ("gl001-spans-present", "telemetry-contract",
     'metrics.log("good_event", x=1)\nwith span(metrics, "round"):\n    pass\n',
     _contract(spans=("round",))),
    ("gl001-fleet-disconnect", "telemetry-contract",
     'metrics.log("alert_pending", alert="a")\n',
     _contract(events={"alert_pending": frozenset({"alert"}),
                       "alert_firing": frozenset({"alert"})},
               required={"FLEET_EVENTS": ("alert_pending", "alert_firing")})),
    ("gl001-survival-emission", "telemetry-contract", _SURVIVAL_SRC,
     _contract(events=_SURVIVAL, required={"SURVIVAL_EVENTS": tuple(_SURVIVAL)})),
    ("gl001-survival-schema", "telemetry-contract",
     _SURVIVAL_SRC + 'metrics.log("journal_write_failed", round=3, error="e")\n',
     _contract(events={k: v for k, v in _SURVIVAL.items() if k != "journal_write_failed"},
               required={"SURVIVAL_EVENTS": tuple(_SURVIVAL)})),
    ("gl001-incident-emission", "telemetry-contract", _INCIDENT_SRC,
     _contract(events=_INCIDENT, required={"INCIDENT_EVENTS": tuple(_INCIDENT)})),
    ("gl001-incident-schema", "telemetry-contract",
     _INCIDENT_SRC + 'metrics.log("flightrec_received", incident_id="i")\n',
     _contract(events={k: v for k, v in _INCIDENT.items() if k != "flightrec_received"},
               required={"INCIDENT_EVENTS": tuple(_INCIDENT)})),
    ("gl001-scanner-selfcheck", "telemetry-contract", "x = 1\n", _contract()),
    # GL003
    ("gl003-use-after-donation", "donation-safety", """
     import jax

     def run(step, state, batch):
         prog = jax.jit(step, donate_argnums=(0,))
         out = prog(state, batch)
         return out, state.shape
     """, None),
    ("gl003-rebind", "donation-safety", """
     import jax

     def run(step, state, batches):
         prog = jax.jit(step, donate_argnums=(0,))
         for batch in batches:
             state = prog(state, batch)
         return state
     """, None),
    ("gl003-fallback-retry", "donation-safety", """
     def run(build, state):
         prog = build(donate=True)
         try:
             return prog(state)
         except RuntimeError:
             return prog(state)
     """, None),
    ("gl003-non-donated-position", "donation-safety", """
     import jax

     def run(step, state, batch):
         prog = jax.jit(step, donate_argnums=(0,))
         new_state = prog(state, batch)
         return new_state, batch.shape
     """, None),
    ("gl003-helper-positions", "donation-safety", """
     from gfedntm_tpu.train.steps import donation_argnums

     def run(timed_jit, fn, params, opt_state, batch):
         prog = timed_jit(fn, donate_argnums=donation_argnums((0, 1)))
         out = prog(params, opt_state, batch)
         loss = params["w"].sum()
         return out, loss
     """, None),
    ("gl003-donate-false", "donation-safety", """
     def run(build, state):
         prog = build(donate=False)
         out = prog(state)
         return out, state.shape
     """, None),
    # GL004
    ("gl004-lockfree-pop", "lock-discipline", _locked("""
     def bad(self, k):
         self._items.pop(k, None)
     """), None),
    ("gl004-under-lock", "lock-discipline", _locked("""
     def good(self, k, v):
         with self._lock:
             self._items[k] = v
     """), None),
    ("gl004-condition-alias", "lock-discipline", _locked("""
     def good(self, k, v):
         with self._cond:
             self._items[k] = v
     """), None),
    ("gl004-subscript-store", "lock-discipline", _locked("""
     def bad(self, k, v):
         self._items[k] = v
     """), None),
    ("gl004-whole-rebind", "lock-discipline", _locked("""
     def bad(self):
         self._items = {}
     """), None),
    ("gl004-closure", "lock-discipline", _locked("""
     def bad(self, pool):
         with self._lock:
             def worker(k):
                 self._items.pop(k, None)
             return pool.submit(worker, 1)
     """), None),
    ("gl004-nested-with", "lock-discipline", _locked("""
     def good(self, k):
         with self._lock:
             if k in self._items:
                 self._items.pop(k, None)
     """), None),
    ("gl004-init-exempt", "lock-discipline", _locked("""
     def read_ok(self):
         return len(self._items)
     """), None),
    ("gl004-unannotated", "lock-discipline", """
     class Plain:
         def __init__(self):
             self._free = set()

         def touch(self):
             self._free.add(1)
     """, None),
    # GL005
    ("gl005-silent-pass", "exception-hygiene", _handler("pass\n"), None),
    ("gl005-fallback-assignment", "exception-hygiene", _handler("mode = 'numpy'\n"), None),
    ("gl005-logger-warning", "exception-hygiene",
     _handler("logger.warning('backend probe failed')\n"), None),
    ("gl005-counter-inc", "exception-hygiene",
     _handler("metrics.registry.counter('errors').inc()\n"), None),
    ("gl005-reraise", "exception-hygiene", _handler("raise\n"), None),
    ("gl005-delegate", "exception-hygiene", _handler("note_failure(exc)\n", bind=" as exc"),
     None),
    ("gl005-surface", "exception-hygiene",
     _handler("body = f'error: {exc}'\nsend(body)\n", bind=" as exc"), None),
    ("gl005-bound-unused", "exception-hygiene", _handler("pass\n", bind=" as exc"), None),
    ("gl005-narrow", "exception-hygiene", _handler("pass\n", catch="ValueError"), None),
    ("gl005-bare", "exception-hygiene", _handler("pass\n", catch=""), None),
    # GL006, numpy
    ("gl006-np-ambient-draw", "rng-discipline", """
     import numpy as np

     def noise(dim):
         return np.random.normal(size=dim)
     """, None),
    ("gl006-np-seed", "rng-discipline", """
     import numpy as np

     def setup(seed):
         np.random.seed(seed)
     """, None),
    ("gl006-np-seeded-factories", "rng-discipline", """
     import jax
     import numpy as np

     def host_noise(dim, seed, index):
         rng = np.random.default_rng((seed, index))
         return rng.standard_normal(dim)

     def device_key(seed, shard):
         return jax.random.fold_in(
             jax.random.PRNGKey(int(seed)), shard
         )

     def entropy(seed):
         return np.random.SeedSequence(seed)
     """, None),
    ("gl006-np-generator-method", "rng-discipline", """
     import numpy as np

     def noise(rng: np.random.Generator, dim):
         return rng.normal(size=dim)
     """, None),
]


#: The fixtures on which the JAX suite expects no finding.
QUIET_FIXTURES = {
    "core-suppress-same-line", "core-suppress-line-above", "core-suppress-all",
    "gl001-registered", "gl001-spans-present",
    "gl003-rebind", "gl003-non-donated-position", "gl003-donate-false",
    "gl004-under-lock", "gl004-condition-alias", "gl004-nested-with", "gl004-init-exempt",
    "gl004-unannotated",
    "gl005-logger-warning", "gl005-counter-inc", "gl005-reraise", "gl005-delegate",
    "gl005-surface", "gl005-narrow",
    "gl006-np-seeded-factories", "gl006-np-generator-method",
}


@pytest.mark.parametrize("case, rule_name, source, options", FIXTURES,
                         ids=[c[0] for c in FIXTURES])
def test_fixture_findings_are_the_jax_rules(tmp_path, case, rule_name, source, options):
    got = _lint(run_lint, tmp_path / "port", _rule(make_default_rules, rule_name), source,
                "fixture.py", options)
    want = _lint(j_run_lint, tmp_path / "jax", _rule(j_rules, rule_name), source,
                 "fixture.py", options)
    assert got == want
    assert (got == []) == (case in QUIET_FIXTURES), got


# ---- E1: the baseline workflow, step by step through both packages -------------

def _baseline_trace(run, bl, rule_cls, tmp: Path, scenario: str) -> list:
    """One baseline scenario of ``tests/test_analysis.py``'s TestBaseline;
    returns what each step observed, for comparison across packages."""
    tmp.mkdir(parents=True, exist_ok=True)
    mod, path = tmp / "mod.py", tmp / "baseline.json"

    def lint(**kw):
        res = run(root=str(tmp), paths=[str(mod)], rules=[rule_cls(paths=EVERYWHERE)],
                  baseline_path=str(path), **kw)
        return (res.ok, [(f.path, f.line, f.message) for f in res.new],
                len(res.baselined), [(e.rule, e.line_text, e.index) for e in res.stale],
                [(e.rule, e.line_text, e.index) for e in res.unjustified])

    def justify(text):
        bl.save_baseline(str(path), [
            bl.BaselineEntry(e.rule, e.path, e.line_text, e.index, text)
            for e in bl.load_baseline(str(path))])

    trace = []
    if scenario == "roundtrip":
        mod.write_text(BAD_EXCEPT)
        trace += [lint(), lint(update_baseline=True), lint()]
        justify("probe loop: silence is the signal")
        trace.append(lint())
        mod.write_text(BAD_EXCEPT.replace("pass", "raise"))
        trace += [lint(), lint(update_baseline=True), path.read_text(), lint()]
    elif scenario == "content-keyed":
        mod.write_text(BAD_EXCEPT)
        trace.append(lint(update_baseline=True))
        justify("ok")
        mod.write_text("# pad\n# pad\n# pad\n" + BAD_EXCEPT)
        trace.append(lint())
        mod.write_text(BAD_EXCEPT.replace("except Exception:", "except (Exception,):"))
        trace.append(lint())
    elif scenario == "index":
        mod.write_text(BAD_EXCEPT + "\n" + BAD_EXCEPT)
        trace += [lint(), lint(update_baseline=True)]
        justify("ok")
        trace += [path.read_text(), lint()]
    elif scenario == "subset-update":
        mod.write_text(BAD_EXCEPT)
        bl.save_baseline(str(path), [bl.BaselineEntry(
            "precision-pin", "other/module.py", "x = a @ b", 0, "reviewed: host-side oracle")])
        trace += [lint(), lint(update_baseline=True), path.read_text()]
    elif scenario == "malformed":
        mod.write_text("x = 1\n")
        path.write_text("{not json")
        try:
            lint()
        except bl.BaselineError as err:
            trace.append(type(err).__name__)
    return trace


@pytest.mark.parametrize("scenario", ["roundtrip", "content-keyed", "index", "subset-update",
                                      "malformed"])
def test_baseline_workflow_is_the_jax_one(tmp_path, scenario):
    from gfedntm_tpu.analysis.rules.exceptions import ExceptionHygieneRule as JRule
    from gfedntm_tpu_torch.analysis.rules.exceptions import ExceptionHygieneRule as PRule

    got = _baseline_trace(run_lint, p_baseline, PRule, tmp_path / "port", scenario)
    want = _baseline_trace(j_run_lint, j_baseline, JRule, tmp_path / "jax", scenario)
    assert got == want and got


# ---- E1: the CLI's exit codes ----------------------------------------------------

CLI_CASES = {
    "clean-fixture": ("import jax.numpy as jnp\n\ndef gram(mat):\n"
                      "    return jnp.matmul(mat, mat.T)\n", ["--no-baseline"], 0),
    "one-finding": (_locked("""
     def bad(self, k):
         self._items.pop(k, None)
     """), ["--no-baseline"], 1),
    "unknown-rule": (None, ["--rules", "no-such-rule"], 2),
    "baseline-conflict": (None, ["--no-baseline", "--update-baseline"], 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes_are_the_jax_ones(tmp_path, capsys, case):
    source, flags, rc = CLI_CASES[case]
    outs = []
    for main in (p_main, j_main):
        argv = list(flags)
        if source is not None:
            mod = tmp_path / "mod.py"
            mod.write_text(source)
            argv = [str(mod), "--root", str(tmp_path)] + argv
        outs.append((main(argv), capsys.readouterr()))
    (p_rc, p_out), (j_rc, j_out) = outs
    assert p_rc == j_rc == rc
    if source is not None:
        assert (p_out.out, p_out.err) == (j_out.out, j_out.err)


def test_rule_table_is_the_jax_one(capsys):
    assert p_main(["--list-rules"]) == 0
    port = [line.split()[:2] for line in capsys.readouterr().out.splitlines()]
    assert j_main(["--list-rules"]) == 0
    jax_ = [line.split()[:2] for line in capsys.readouterr().out.splitlines()]
    assert port == jax_
    assert port == [[f"GL00{i}", name] for i, name in enumerate(JAX_NAMES, start=1)]


# ---- E2: the torch twins of GL002 and GL006 ---------------------------------------

GL002_SEEDED = {
    "float32-gram": """
        import torch

        def gram(rows):
            r = rows.to(torch.float32)
            return r @ r.T
        """,
    "float32-gram-without-torch-name": """
        import torch

        def gram(rows):
            return rows @ rows.T
        """,
    "unpinned-mm": """
        import torch

        def gram(rows):
            return torch.mm(rows, rows.t())
        """,
    "tensor-matmul": """
        import torch

        def gram(rows):
            return rows.matmul(rows.T)
        """,
    "einsum": """
        import torch

        def gram(rows):
            return torch.einsum("id,jd->ij", rows, rows)
        """,
    "half-cast-back": """
        import torch

        def gram(rows):
            r64 = rows.to(torch.float64)
            r = r64.float()
            return r @ r.T
        """,
    "allow-tf32-true": """
        import torch

        def fast():
            torch.backends.cuda.matmul.allow_tf32 = True
        """,
    "cudnn-tf32-true": """
        import torch

        torch.backends.cudnn.allow_tf32 = True
        """,
    "bf16-reduction-true": """
        import torch

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        """,
    "matmul-precision-high": """
        import torch

        torch.set_float32_matmul_precision("high")
        """,
    "matmul-precision-medium": """
        import torch

        def setup():
            torch.set_float32_matmul_precision("medium")
        """,
    "restored-then-product": """
        import torch

        def probe(a):
            allow = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = allow
            return torch.matmul(a, a)
        """,
}

GL002_QUIET = {
    "gram-pattern": """
        import torch

        def _gram(rows):
            r64 = rows.to(torch.float64)
            return _host(r64 @ r64.T)
        """,
    "double-and-dtype": """
        import torch

        def grams(rows, n):
            a = rows.double()
            b = torch.zeros((n, n), dtype=torch.float64)
            return a @ a.T, torch.mm(b, b)
        """,
    "contribution-rows": """
        import torch

        def stats(mat, gvec, avg_vec):
            g64 = gvec.to(torch.float64)
            rows = torch.cat([mat.to(torch.float64) - g64,
                              (avg_vec.to(torch.float64) - g64)[None]])
            return rows @ rows.T
        """,
    "gate-norms": """
        import torch

        def norms(mat, gvec):
            g64 = gvec.to(torch.float64)
            return torch.stack([torch.dot(d, d) for d in (row.to(torch.float64) - g64
                                                         for row in mat)])
        """,
    "numpy-oracle": """
        import numpy as np

        def gram(mat):
            flat = np.stack(mat)
            return flat @ flat.T
        """,
    "numpy-in-torch-scope": """
        import numpy as np
        import torch

        def mixed(mat):
            dev = torch.ones((2, 2))
            host = np.asarray(mat)
            return dev, host @ host.T
        """,
    "flops-probe": """
        import torch

        def probe(n):
            allow = torch.backends.cuda.matmul.allow_tf32
            try:
                torch.backends.cuda.matmul.allow_tf32 = False
                a = torch.ones((n, n), dtype=torch.float32)
                torch.matmul(a, a)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow
        """,
    "resolve-device-pin": """
        import torch

        def resolve():
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            torch.set_float32_matmul_precision("highest")
        """,
}


@pytest.mark.parametrize("case", sorted(GL002_SEEDED))
def test_precision_pin_catches_torch_violations(tmp_path, case):
    found = _lint(run_lint, tmp_path, PrecisionPinRule(paths=EVERYWHERE), GL002_SEEDED[case],
                  "fixture.py")
    assert len(found) == 1 and found[0][1] == "precision-pin", found


@pytest.mark.parametrize("case", sorted(GL002_QUIET))
def test_precision_pin_quiet_on_the_port_patterns(tmp_path, case):
    assert _lint(run_lint, tmp_path, PrecisionPinRule(paths=EVERYWHERE), GL002_QUIET[case],
                 "fixture.py") == []


def test_precision_pin_scopes(tmp_path):
    rule = PrecisionPinRule()
    for rel in ("gfedntm_tpu_torch/federation/device_agg.py", "gfedntm_tpu_torch/device.py",
                "gfedntm_tpu_torch/train/steps.py", "chip_smoke.py"):
        assert rule.applies_to(rel)
    assert not rule.applies_to("tests/test_torch_chaos.py")
    # Check (a) is the gram path only: a float32 product in the training
    # step is the model's storage policy, while a literal switch there
    # still fires.
    root = tmp_path / "gfedntm_tpu_torch" / "train"
    root.mkdir(parents=True)
    (root / "steps.py").write_text("import torch\n\ndef f(a):\n    return a @ a.T\n"
                                   "torch.backends.cuda.matmul.allow_tf32 = True\n")
    res = run_lint(root=str(tmp_path), paths=[str(root / "steps.py")], rules=[rule],
                   use_baseline=False)
    assert [f.line for f in res.new] == [5]


def test_precision_pin_scope_pruning_no_duplicates(tmp_path):
    found = _lint(run_lint, tmp_path, PrecisionPinRule(paths=EVERYWHERE), """
        import torch

        def outer():
            y = torch.ones(3)
            def gram(mat):
                return torch.matmul(mat, mat.T)
            return gram
        """, "fixture.py")
    assert len(found) == 1


GL006_SEEDED = {
    "randn-global": "import torch\n\ndef noise(n):\n    return torch.randn(n)\n",
    "manual-seed-global": "import torch\n\ndef setup():\n    torch.manual_seed(0)\n",
    "generator-literal-seed": ("import torch\n\ndef gen():\n"
                               "    return torch.Generator().manual_seed(1234)\n"),
    "named-generator-literal": ("import torch\n\ndef gen():\n    g = torch.Generator()\n"
                                "    g.manual_seed(7)\n    return g\n"),
    "cuda-seed-all": "import torch\n\ntorch.cuda.manual_seed_all(3)\n",
    "inplace-normal": "import torch\n\ndef noise(t):\n    return t.normal_(0.0, 1.0)\n",
    "bernoulli-global": "import torch\n\ndef mask(p):\n    return torch.bernoulli(p)\n",
}

GL006_QUIET = {
    "randn-generator": ("import torch\n\ndef noise(n, g):\n"
                        "    return torch.randn(n, generator=g)\n"),
    "derived-seed": ("import torch\n\ndef gen(device, s, i):\n"
                     "    gen = torch.Generator(device=device)\n"
                     "    gen.manual_seed(noise_seed(s, i))\n    return gen\n"),
    "numpy-default-rng": ("import numpy as np\n\ndef noise(dim, seed, index):\n"
                          "    return np.random.default_rng((seed, index)).standard_normal(dim)\n"),
    "inplace-with-generator": ("import torch\n\ndef noise(t, g):\n"
                               "    return t.normal_(0.0, 1.0, generator=g)\n"),
}


@pytest.mark.parametrize("case", sorted(GL006_SEEDED))
def test_rng_discipline_catches_torch_violations(tmp_path, case):
    found = _lint(run_lint, tmp_path, RngDisciplineRule(paths=EVERYWHERE), GL006_SEEDED[case],
                  "fixture.py")
    assert len(found) == 1 and found[0][1] == "rng-discipline", found


@pytest.mark.parametrize("case", sorted(GL006_QUIET))
def test_rng_discipline_quiet_on_explicit_generators(tmp_path, case):
    assert _lint(run_lint, tmp_path, RngDisciplineRule(paths=EVERYWHERE), GL006_QUIET[case],
                 "fixture.py") == []


def test_rng_discipline_scope_is_the_noise_path():
    rule = RngDisciplineRule()
    for rel in ("gfedntm_tpu_torch/privacy/mechanisms.py",
                "gfedntm_tpu_torch/federation/device_agg.py",
                "gfedntm_tpu_torch/federated/aggregation.py"):
        assert rule.applies_to(rel)
    assert not rule.applies_to("gfedntm_tpu_torch/data/synthetic.py")
    assert not rule.applies_to("tests/test_torch_privacy.py")


# ---- E3: the self-run over the live port -----------------------------------------

@pytest.fixture(scope="module")
def live():
    return run_lint()


def test_live_port_has_no_new_findings(live):
    assert live.new == [], "\n".join(f.render() for f in live.new)
    assert live.ok


def test_live_baseline_is_justified_and_live(live):
    assert live.unjustified == [] and live.stale == []
    entries = p_baseline.load_baseline(default_baseline_path(repo_root()))
    assert len(live.baselined) == len(entries) and entries
    assert all(e.justification.strip() for e in entries)
    assert {e.path for e in entries} == {"gfedntm_tpu_torch/federation/resilience.py"}


def test_scan_covers_the_port_and_the_smoke(live):
    scanned = {os.path.relpath(p, REPO) for p in collect_default_files(str(REPO))}
    want = {str(p.relative_to(REPO)) for p in (REPO / "gfedntm_tpu_torch").rglob("*.py")
            if "__pycache__" not in p.parts}
    assert want | {"chip_smoke.py", "tests/test_torch_chaos.py"} == scanned
    assert live.files == len(scanned)


@pytest.mark.parametrize("name", ("TRACE_PLANE_SPANS",) + GROUPS)
def test_contract_groups_are_the_jax_ones(name):
    from gfedntm_tpu.utils import observability as jo
    from gfedntm_tpu_torch.utils import observability as po

    assert getattr(po, name) == getattr(jo, name)
    for event in getattr(po, name) if name != "TRACE_PLANE_SPANS" else ():
        assert event in po.EVENT_SCHEMAS


def test_telemetry_contract_reads_the_port(live):
    from gfedntm_tpu_torch.analysis.core import LintContext
    from gfedntm_tpu_torch.analysis.rules.telemetry import TelemetryContractRule

    contract = TelemetryContractRule()._contract(LintContext(root=str(REPO)))
    assert contract["schema_module"] == "gfedntm_tpu_torch/utils/observability.py"
    assert set(contract["required"]) == set(GROUPS)
    res = run_lint(rules=[TelemetryContractRule()], use_baseline=False)
    assert res.new == [], "\n".join(f.render() for f in res.new)


def test_subset_lint_of_the_schema_module_is_clean():
    res = run_lint(paths=[str(REPO / "gfedntm_tpu_torch/utils/observability.py")])
    assert res.new == [], "\n".join(f.render() for f in res.new)


# ---- E4: seeded mutations of a copy of the live port -------------------------------

def _copy_port(dst: Path) -> None:
    shutil.copytree(REPO / "gfedntm_tpu_torch", dst / "gfedntm_tpu_torch",
                    ignore=lambda d, names: [n for n in names if n == "__pycache__"
                                             or (not n.endswith(".py")
                                                 and not os.path.isdir(os.path.join(d, n)))])
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / "tests").mkdir()
    shutil.copy(REPO / "tests/test_torch_chaos.py", dst / "tests/test_torch_chaos.py")


def _mutate(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


MUTATIONS = {
    # (rule, file to mutate, old, new, file the finding anchors at, text in the message)
    "drop-quality-computed": (
        "telemetry-contract", "gfedntm_tpu_torch/eval/monitor.py",
        '"quality_computed", round=', '"topic_drift", round=',
        "gfedntm_tpu_torch/utils/observability.py", "'quality_computed'"),
    "lockfree-registry-store": (
        "lock-discipline", "gfedntm_tpu_torch/federation/registry.py",
        "    def __len__(self) -> int:",
        "    def purge(self, client_id: int) -> None:\n"
        "        self._clients.pop(client_id, None)\n\n"
        "    def __len__(self) -> int:",
        "gfedntm_tpu_torch/federation/registry.py", "self._clients"),
    "float32-gram": (
        "precision-pin", "gfedntm_tpu_torch/federation/device_agg.py",
        "r64 = rows.to(torch.float64)", "r64 = rows",
        "gfedntm_tpu_torch/federation/device_agg.py", "'@'"),
    "noise-without-generator": (
        "rng-discipline", "gfedntm_tpu_torch/federation/device_agg.py",
        "torch.randn(plane.dim, generator=gen, ", "torch.randn(plane.dim, ",
        "gfedntm_tpu_torch/federation/device_agg.py", "torch.randn"),
    "silent-server-except": (
        "exception-hygiene", "gfedntm_tpu_torch/federation/server.py",
        "def build_template_model(",
        "def _swallow():\n    try:\n        return 1\n    except Exception:\n        pass\n\n\n"
        "def build_template_model(",
        "gfedntm_tpu_torch/federation/server.py", "broad except"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_seeded_mutation_fires_its_rule(tmp_path, case):
    rule_name, target, old, new, anchor, text = MUTATIONS[case]
    _copy_port(tmp_path)
    rule = next(r for r in make_default_rules() if r.name == rule_name)
    clean = run_lint(root=str(tmp_path), rules=[rule], use_baseline=False)
    assert [f for f in clean.new if f.path != "gfedntm_tpu_torch/federation/resilience.py"] == []
    _mutate(tmp_path / target, old, new)
    res = run_lint(root=str(tmp_path), rules=[rule], use_baseline=False)
    fired = [f for f in res.new if f not in clean.new]
    assert fired and all(f.rule_name == rule_name and f.path == anchor for f in fired), fired
    assert any(text in f.message for f in fired), [f.message for f in fired]


# ---- E5: the CLI in a subprocess -----------------------------------------------------

def _port_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_cli_subprocess_exit_codes(tmp_path):
    def run(*argv):
        return subprocess.run([sys.executable, "-m", "gfedntm_tpu_torch.analysis", *argv],
                              cwd=tmp_path, env=_port_env(), capture_output=True, text=True,
                              timeout=300)

    live = run()
    assert live.returncode == 0, live.stdout + live.stderr
    assert "0 new finding(s)" in live.stdout
    bad = tmp_path / "mod.py"
    bad.write_text(_locked("""
     def bad(self, k):
         self._items.pop(k, None)
     """))
    one = run(str(bad), "--root", str(tmp_path), "--no-baseline")
    assert one.returncode == 1 and "mod.py:12: [lock-discipline GL004]" in one.stderr, one.stderr
    assert run("--rules", "no-such-rule").returncode == 2


def test_cli_loads_nothing_of_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['graftlint']\n"
        "try:\n"
        "    runpy.run_module('gfedntm_tpu_torch.analysis', run_name='__main__',"
        " alter_sys=True)\n"
        "except SystemExit as exc:\n"
        "    rc = exc.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'gfedntm_tpu'))\n"
        "print(rc, bad)\n"
        "sys.exit(0 if rc == 0 and not bad else 1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_port_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "0 []", proc.stdout


def test_baseline_file_is_the_port_s_own():
    path = Path(default_baseline_path(str(REPO)))
    assert path == REPO / "gfedntm_tpu_torch/analysis/lint_baseline.json"
    doc = json.loads(path.read_text())
    assert doc["version"] == 1 and all(e["justification"].strip() for e in doc["entries"])
