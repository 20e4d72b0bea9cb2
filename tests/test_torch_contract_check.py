"""The port's contract analyzer (spark_rapids_tpu_torch/analysis/):

- every shared rule family gives the JAX analyzer's findings (rule, key,
  scope and line) and suppressions on the JAX package's fixtures in
  tests/fixtures/contract/, which are read, never written;
- each retargeted rule (trace-module-tensor, trace-host-sync,
  dispatch-ledger) fires on a fixture written to tmp_path and stays
  quiet on its ok twin;
- the suppression, baseline and CLI cases of the JAX package's suite,
  run through `python -m spark_rapids_tpu_torch.analysis`'s main();
- the registry's specs name real port modules, README's port rule table
  lists exactly RULES, every non-meta rule is fixture-proven;
- THE tier-1 gate: the whole port (and chip_smoke.py) analyzes clean
  against analysis/baseline.json.
"""

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from spark_rapids_tpu import analysis as janalysis
from spark_rapids_tpu.analysis import registry as jreg

from spark_rapids_tpu_torch import analysis
from spark_rapids_tpu_torch.analysis import __main__ as cli
from spark_rapids_tpu_torch.analysis import core as acore
from spark_rapids_tpu_torch.analysis import registry as reg_mod
from spark_rapids_tpu_torch.analysis.registry import ContractRegistry

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "contract"

#: the families both analyzers share; the JAX package's three traced-
#: program rules are retargeted in the port and tested below instead
RETARGETED = {"trace-module-tensor", "trace-host-sync", "dispatch-ledger"}
SHARED = sorted(set(reg_mod.RULES) - RETARGETED)


def fixture_registry(fname: str, cls=ContractRegistry, specs=None):
    """The fixture twin of DEFAULT_REGISTRY scoped to one fixture module,
    as the JAX package's suite builds it (`specs`: that package's
    registry module, for its analyzer)."""
    m = specs or reg_mod
    return cls(
        locks=[
            m.LockSpec("fx-outer", fname, "Engine", "self._outer",
                       reentrant=False, note="fixture outer lock"),
            m.LockSpec("fx-lock", fname, "Engine", "self._lock",
                       reentrant=False, note="fixture lock"),
        ],
        lock_order=["fx-outer", "fx-lock"],
        cross_query_entries=[
            m.EntrySpec(fname, None, "writer_loop", "fixture producer")],
        pairs=[m.PairSpec("fx-budget", "reserve", "release", "budget",
                          (fname,),
                          {"escrowed": "fixture: ownership transfers"})],
        adopt_helpers=m.ADOPT_HELPERS,
        extra_blocking_calls={},
        scope_prefix="",
    )


def run_fixture(path: Path, rules=None):
    return analysis.analyze_paths([path], ROOT,
                                  registry=fixture_registry(path.name),
                                  rules=rules)


def run_jax_fixture(path: Path, rules=None):
    reg = fixture_registry(path.name, cls=jreg.ContractRegistry,
                           specs=jreg)
    return janalysis.analyze_paths([path], ROOT, registry=reg, rules=rules)


def shape(findings):
    return sorted((f.rule, f.key, f.scope, f.line) for f in findings)


def write_fixture(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return p


# -- the shared families against the JAX analyzer ----------------------------

SHARED_FIXTURES = [
    "fx_locks.py", "fx_locks_ok.py", "fx_bounded_wait.py",
    "fx_bounded_wait_ok.py", "fx_threads.py", "fx_threads_ok.py",
    "fx_conf.py", "fx_conf_ok.py", "fx_accounting.py",
    "fx_accounting_ok.py", "fx_registry.py", "fx_registry_ok.py",
    "fx_stage.py", "fx_stage_ok.py", "fx_suppress_empty.py",
]


@pytest.mark.parametrize("fname", SHARED_FIXTURES)
def test_shared_families_match_the_jax_analyzer(fname):
    path = FIXTURES / fname
    shared = [r for r in SHARED if reg_mod.RULES[r].checker is not None]
    got = run_fixture(path, rules=shared)
    want = run_jax_fixture(path, rules=shared)
    assert shape(got.findings) == shape(want.findings)
    assert shape(f for f, _w, _l in got.suppressed) == \
        shape(f for f, _w, _l in want.suppressed)
    assert got.files_scanned == want.files_scanned == 1


def test_shared_fixtures_fire_every_shared_family():
    fired = set()
    for fname in SHARED_FIXTURES:
        fired |= {f.rule for f in run_fixture(FIXTURES / fname).findings}
    non_meta = {r for r in SHARED if reg_mod.RULES[r].checker is not None}
    assert non_meta <= fired, sorted(non_meta - fired)


# -- the retargeted rules ----------------------------------------------------

TENSOR_BAD = '''
    import numpy as np
    import torch

    _BAD = torch.tensor(7)           # trace-module-tensor
    _BAD_VIEW = torch.arange(4).view(2, 2)  # trace-module-tensor
    _OK_DTYPE = torch.int64          # attribute reference: quiet
    _OK_NP = np.uint32(7)            # numpy scalar: quiet
'''

TENSOR_OK = '''
    import numpy as np
    import torch

    _OK_DTYPE = torch.int64
    _OK_MAX = torch.iinfo(torch.int64).max   # not a tensor
    _OK_NP = np.int64(7)


    def seed(device):
        return torch.tensor(7, device=device)  # built on the caller's


    # contract: ok trace-module-tensor — fixture: a CPU-only table
    _ACCEPTED = torch.zeros(3)
'''


def test_trace_module_tensor_fires(tmp_path):
    rep = run_fixture(write_fixture(tmp_path, "fx_tensor.py", TENSOR_BAD))
    assert sorted((f.rule, f.key) for f in rep.findings) == [
        ("trace-module-tensor", "_BAD"),
        ("trace-module-tensor", "_BAD_VIEW")]


def test_trace_module_tensor_quiet_on_its_twin(tmp_path):
    rep = run_fixture(write_fixture(tmp_path, "fx_tensor_ok.py", TENSOR_OK))
    assert rep.findings == [], [f.render() for f in rep.findings]
    assert [f.rule for f, _w, _l in rep.suppressed] == \
        ["trace-module-tensor"]


def test_trace_module_tensor_spares_scripts(tmp_path):
    """The engine registry scopes the rule to the package: a script's
    module scope is its main."""
    path = write_fixture(tmp_path, "fx_script.py", TENSOR_BAD)
    rep = analysis.analyze_paths([path], ROOT, rules=["trace-module-tensor"])
    assert rep.findings == []


HOST_SYNC_BAD = '''
    from spark_rapids_tpu_torch.obs.dispatch import instrument


    def _read(flag):
        return int(flag.item())              # one hop down: flagged


    class Stage:
        def __init__(self, cause):
            self._site_a = self._site(self._body, label="S.body",
                                      graph=cause is None, cause=cause)
            self._site_b = instrument(lambda b: b.tolist(), label="S.l")

        def _body(self, batch, flag):
            n = flag.item()                  # trace-host-sync
            host = batch.cpu()               # trace-host-sync
            _read(flag)
            return batch, n, host
'''

HOST_SYNC_OK = '''
    from spark_rapids_tpu_torch.obs.dispatch import instrument


    class Stage:
        def __init__(self):
            # a body that reads the host, declared eager with its cause
            self._site_a = self._site(self._reads, label="S.reads",
                                      graph=False, cause="host-read")
            self._site_b = instrument(self._pure, label="S.pure")

        def _reads(self, batch, flag):
            return batch, int(flag.item())   # eager by declaration

        def _pure(self, batch):
            return batch * 2

        def drive(self, batch, flag):
            out = self._site_b(batch)
            return out, flag.item()          # at the stage boundary

        def _accepted(self, batch):
            # contract: ok trace-host-sync — fixture: read at capture
            # only, a static shape
            return batch.shape[0], batch.numel().item()

        def build(self):
            self._site_c = self._site(self._accepted, label="S.acc")
'''


def test_trace_host_sync_fires(tmp_path):
    rep = run_fixture(write_fixture(tmp_path, "fx_sync.py", HOST_SYNC_BAD))
    got = sorted((f.rule, f.scope, f.key) for f in rep.findings)
    assert got == [("trace-host-sync", "<lambda>", "tolist"),
                   ("trace-host-sync", "_body", "cpu"),
                   ("trace-host-sync", "_body", "item"),
                   ("trace-host-sync", "_body", "item")], got
    # the one-hop finding sits in the helper
    lines = {f.line for f in rep.findings if f.key == "item"}
    assert len(lines) == 2


def test_trace_host_sync_quiet_on_its_twin(tmp_path):
    rep = run_fixture(write_fixture(tmp_path, "fx_sync_ok.py",
                                    HOST_SYNC_OK))
    assert rep.findings == [], [f.render() for f in rep.findings]
    assert [f.rule for f, _w, _l in rep.suppressed] == ["trace-host-sync"]


DISPATCH_BAD = '''
    import torch

    from spark_rapids_tpu_torch.kernels.build import csrc_library
    from spark_rapids_tpu_torch.obs.dispatch import kernel_site


    def uncounted(x):
        lib = csrc_library("k.cu", {})
        lib.k_run(x)                          # dispatch-ledger
        uncounted.launches += 1               # dispatch-ledger


    def site_without_count(x, dev):
        with kernel_site("k", (1,), dev) as site:
            csrc_library("k.cu", {}).k_run(x)  # dispatch-ledger


    def timing(mod, args):
        return mod.launcher(*args)            # dispatch-ledger


    def capture(fn):
        g = torch.cuda.CUDAGraph()            # dispatch-ledger
        with torch.cuda.graph(g):             # dispatch-ledger
            fn()
'''

DISPATCH_OK = '''
    from spark_rapids_tpu_torch.kernels.build import csrc_library
    from spark_rapids_tpu_torch.obs.dispatch import kernel_site


    def wrapper(x, dev):
        with kernel_site("k", (1,), dev, counter=wrapper) as site:
            _partials(x)                      # one hop down: counted
            site.count()
        return x


    def _partials(x):
        lib = csrc_library("k.cu", {})
        lib.k_run(x)
        wrapper.launches += 1


    def limits():
        return csrc_library("k.cu", {}).k_limits()   # not a launch


    def timing(mod, args):
        # contract: ok dispatch-ledger — fixture: a timing launcher
        return mod.launcher(*args)
'''


def test_dispatch_ledger_fires(tmp_path):
    rep = run_fixture(write_fixture(tmp_path, "fx_launch.py", DISPATCH_BAD))
    got = sorted((f.scope, f.key) for f in rep.findings)
    assert all(f.rule == "dispatch-ledger" for f in rep.findings)
    assert got == [
        ("capture", "torch.cuda.CUDAGraph"),
        ("capture", "torch.cuda.graph"),
        ("site_without_count", "csrc_library('k.cu', {}).k_run"),
        ("timing", "mod.launcher"),
        ("uncounted", "lib.k_run"),
        ("uncounted", "uncounted.launches +=")], got


def test_dispatch_ledger_quiet_on_its_twin(tmp_path):
    rep = run_fixture(write_fixture(tmp_path, "fx_launch_ok.py",
                                    DISPATCH_OK))
    assert rep.findings == [], [f.render() for f in rep.findings]
    assert [f.rule for f, _w, _l in rep.suppressed] == ["dispatch-ledger"]


def test_dispatch_ledger_spares_the_chokepoint():
    """obs/dispatch.py owns the graphs and the replay's launch bump."""
    path = ROOT / "spark_rapids_tpu_torch" / "obs" / "dispatch.py"
    rep = analysis.analyze_paths([path], ROOT, rules=["dispatch-ledger"])
    assert rep.findings == [] and rep.suppressed == []


def test_every_kernel_wrapper_counts_through_a_site():
    """The port's six kernel modules: every launch reached from a counted
    kernel site, the one timing hand-out suppressed with its why."""
    ops = ROOT / "spark_rapids_tpu_torch" / "ops"
    paths = [ops / f"{m}.py" for m in ("fused_scan_agg", "murmur3_lanes",
                                       "probe_verify", "row_gather",
                                       "dict_gather")]
    rep = analysis.analyze_paths(paths, ROOT, rules=["dispatch-ledger"])
    assert rep.findings == []
    assert [(f.path.rsplit("/", 1)[1], f.key)
            for f, _w, _l in rep.suppressed] == [("row_gather.py",
                                                   "launcher")]


# -- suppressions ------------------------------------------------------------

@pytest.mark.parametrize("fname,n_suppressed", [
    ("fx_locks_ok.py", 4),
    ("fx_bounded_wait_ok.py", 3),
    ("fx_threads_ok.py", 2),
    ("fx_conf_ok.py", 1),
    ("fx_accounting_ok.py", 2),
    ("fx_registry_ok.py", 2),
    ("fx_stage_ok.py", 1),
])
def test_suppressions_silence(fname, n_suppressed):
    rep = run_fixture(FIXTURES / fname)
    assert rep.findings == [], [f.render() for f in rep.findings]
    assert len(rep.suppressed) == n_suppressed
    for _f, why, _line in rep.suppressed:
        assert why.strip(), "suppression accepted without justification"


def test_empty_justification_is_its_own_finding():
    rep = run_fixture(FIXTURES / "fx_suppress_empty.py")
    meta = [f for f in rep.findings if f.rule == "suppression-empty"]
    assert {f.key for f in meta} == {"lock-blocking-call",
                                     "lock-blocking-cal"}
    real = [f for f in rep.findings if f.rule == "lock-blocking-call"]
    assert len(real) == 1 and real[0].scope == "Engine.typo"


def test_a_jax_rule_id_is_unknown_to_the_port(tmp_path):
    """A suppression naming the JAX package's trace-module-jnp (gone from
    the port) silences nothing and is a finding of its own."""
    path = write_fixture(tmp_path, "fx_old_id.py", '''
        import torch
        # contract: ok trace-module-jnp — a stale rule id
        _T = torch.ones(2)
    ''')
    rep = run_fixture(path)
    assert sorted((f.rule, f.key) for f in rep.findings) == [
        ("suppression-empty", "trace-module-jnp"),
        ("trace-module-tensor", "_T")]


# -- baseline ----------------------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    findings = run_fixture(FIXTURES / "fx_locks.py").sorted_findings()
    bl_path = tmp_path / "baseline.json"
    entries = acore.write_baseline(bl_path, findings)
    assert all(e["why"] == acore.UNREVIEWED_WHY for e in entries.values())
    loaded = acore.load_baseline(bl_path)
    new, stale, lint = acore.apply_baseline(findings, loaded)
    assert new == [] and stale == []
    assert lint and all(f.rule == "baseline-invalid" for f in lint)
    assert {f.path for f in lint} == {acore.BASELINE_REL}
    for e in loaded.values():
        e["why"] = "fixture: accepted"
    assert acore.apply_baseline(findings, loaded) == ([], [], [])
    new, stale, lint = acore.apply_baseline(findings[1:], loaded)
    assert len(stale) == 1 and new == []
    one = {findings[0].fingerprint: {"count": 1, "why": "x"}}
    new, _stale, _lint = acore.apply_baseline([findings[0]] * 2, one)
    assert len(new) == 1


def test_partially_fixed_baseline_entry_is_stale():
    f = run_fixture(FIXTURES / "fx_locks.py").sorted_findings()[0]
    baseline = {f.fingerprint: {"count": 2, "why": "accepted debt"}}
    new, stale, lint = acore.apply_baseline([f], baseline)
    assert new == [] and lint == [] and stale == [f.fingerprint]
    new, stale, _ = acore.apply_baseline([f, f], baseline)
    assert new == [] and stale == []


def test_baseline_write_refuses_scoped_runs(tmp_path, monkeypatch, capsys):
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps(
        {"version": 1,
         "findings": {"keep::me::alive::slot":
                      {"count": 1, "why": "precious"}}}))
    monkeypatch.setattr(cli, "DEFAULT_BASELINE", bl)
    assert cli.main([str(FIXTURES / "fx_registry.py"),
                     "--baseline", "write"]) == 2
    assert cli.main(["--rules", "conf-key-registered",
                     "--baseline", "write"]) == 2
    capsys.readouterr()
    assert "precious" in bl.read_text()


def test_baseline_write_preserves_existing_whys(tmp_path):
    findings = run_fixture(FIXTURES / "fx_registry.py").sorted_findings()
    prev = {findings[0].fingerprint: {"count": 1,
                                      "why": "kept justification"}}
    entries = acore.write_baseline(tmp_path / "bl.json", findings, prev)
    assert entries[findings[0].fingerprint]["why"] == "kept justification"
    assert entries[findings[1].fingerprint]["why"] == acore.UNREVIEWED_WHY


def test_baseline_write_on_the_full_set(tmp_path, monkeypatch, capsys):
    """`--baseline write` with no paths and no rules rewrites the file
    from the full scan, keeping every reviewed why."""
    checked_in = cli.DEFAULT_BASELINE
    bl = tmp_path / "bl.json"
    bl.write_text(checked_in.read_text())
    monkeypatch.setattr(cli, "DEFAULT_BASELINE", bl)
    assert cli.main(["--baseline", "write"]) == 0
    assert "UNREVIEWED" not in capsys.readouterr().out
    assert json.loads(bl.read_text()) == json.loads(checked_in.read_text())


# -- CLI ---------------------------------------------------------------------

def test_cli_json_golden(tmp_path, capsys):
    rc = cli.main([str(FIXTURES / "fx_registry.py"), "--format", "json",
                   "--baseline", str(tmp_path / "missing.json")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["exit"] == 1 and out["files_scanned"] == 1
    assert out["stale_baseline"] == [] and out["baseline_lint"] == []
    assert {(f["rule"], f["key"], f["scope"]) for f in out["findings"]} == {
        ("conf-key-registered",
         "spark.rapids.tpu.fixture.not.registered", "<module>"),
        ("event-kind-registered", "fixture_unregistered_kind",
         "<module>"),
    }
    for f in out["findings"]:
        assert set(f) == {"rule", "path", "line", "scope", "key",
                          "message", "fingerprint"}


def test_cli_clean_exit_zero(tmp_path, capsys):
    rc = cli.main([str(FIXTURES / "fx_registry_ok.py"), "--format",
                   "json", "--baseline", str(tmp_path / "missing.json")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["findings"] == [] and out["suppressed"] == 2


def test_cli_rule_filter(tmp_path, capsys):
    rc = cli.main([str(FIXTURES / "fx_registry.py"), "--format", "json",
                   "--rules", "conf-key-registered",
                   "--baseline", str(tmp_path / "missing.json")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {f["rule"] for f in out["findings"]} == {"conf-key-registered"}


def test_cli_usage_error_and_module_entry(tmp_path, capsys):
    assert cli.main(["--format", "yaml"]) == 2
    capsys.readouterr()
    proc = subprocess.run(
        [sys.executable, "-m", "spark_rapids_tpu_torch.analysis",
         str(FIXTURES / "fx_registry_ok.py"),
         "--baseline", str(tmp_path / "missing.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "0 new finding(s)" in proc.stdout


# -- registry / docs coherence -----------------------------------------------

def test_registry_specs_name_real_port_modules():
    reg = reg_mod.DEFAULT_REGISTRY
    assert reg.scope_prefix == "spark_rapids_tpu_torch/"
    pkg = ROOT / "spark_rapids_tpu_torch"
    modules = {p.relative_to(ROOT).as_posix(): p.read_text()
               for p in pkg.rglob("*.py")}

    def module(suffix):
        hits = [m for m in modules if m.endswith(suffix)]
        assert len(hits) == 1, (suffix, hits)
        return modules[hits[0]]

    for spec in reg.locks:
        src = module(spec.module)
        # the lock exists where it is declared: bound at module or class
        # level, and held somewhere with the declared expression
        name = spec.expr.split(".")[-1]
        assert re.search(rf"\b{re.escape(name)} = threading\.", src), spec
        assert f"with {spec.expr}:" in src, spec
        if spec.cls is not None:
            assert f"class {spec.cls}" in src, spec
    for e in reg.cross_query_entries:
        assert f"def {e.func}(" in module(e.module), e.func
    for p in reg.pairs:
        for m in p.modules:
            module(m)
        for qual in p.escrow:
            assert f"def {qual.split('.')[-1]}(" in module(p.modules[0])
    names = {s.name for s in reg.locks}
    assert set(reg.lock_order) == names
    assert len(reg.lock_order) == len(names)


def test_registry_keeps_the_jax_packages_contract_data():
    """The 19 locks and 10 cross-query entries of the JAX package exist
    at the same paths and names in the port, and are all declared."""
    port = {(s.module, s.cls, s.expr) for s in
            reg_mod.DEFAULT_REGISTRY.locks}
    for s in jreg.DEFAULT_REGISTRY.locks:
        assert (s.module, s.cls, s.expr) in port, s.name
    port_entries = {(e.module, e.cls, e.func) for e in
                    reg_mod.DEFAULT_REGISTRY.cross_query_entries}
    assert port_entries == {(e.module, e.cls, e.func) for e in
                            jreg.DEFAULT_REGISTRY.cross_query_entries}


def test_readme_rule_table_matches_registry():
    readme = (ROOT / "README.md").read_text()
    section = readme.split("#### The port's contract rules", 1)[1]
    section = section.split("\n#", 1)[0]
    rows = set(re.findall(r"^\|\s*`([a-z0-9-]+)`\s*\|", section,
                          re.MULTILINE))
    assert rows == set(reg_mod.RULES), (
        f"missing={sorted(set(reg_mod.RULES) - rows)} "
        f"stale={sorted(rows - set(reg_mod.RULES))}")


def test_rule_ids_against_the_jax_package():
    """The port keeps every JAX rule id but the jnp one, which becomes
    trace-module-tensor."""
    assert set(reg_mod.RULES) == \
        set(jreg.RULES) - {"trace-module-jnp"} | {"trace-module-tensor"}
    assert [r.family for r in reg_mod.RULES.values()] == \
        [r.family for r in jreg.RULES.values()]


# -- THE tier-1 gate ---------------------------------------------------------

def test_whole_port_is_clean_or_baselined():
    """The analyzer over the port's package and chip_smoke.py: every
    finding is suppressed with a why or covered by a justified entry of
    analysis/baseline.json; no stale entries; no empty whys."""
    report = cli.build_report()
    assert report.files_scanned == len(analysis.default_source_files(ROOT))
    assert any(p.name == "chip_smoke.py"
               for p in analysis.default_source_files(ROOT))
    baseline = acore.load_baseline(cli.DEFAULT_BASELINE)
    new, stale, lint = acore.apply_baseline(report.sorted_findings(),
                                            baseline)
    assert new == [], "new contract findings:\n" + "\n".join(
        f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    assert lint == [], "\n".join(f.render() for f in lint)
    for _f, why, _line in report.suppressed:
        assert why.strip()
    # every family of the port's own findings is accounted for
    assert {f.rule for f, _w, _l in report.suppressed} >= {
        "dispatch-ledger", "lock-blocking-call", "thread-adopt",
        "bounded-wait"}


# -- the faults the analyzer turned up, repaired -----------------------------

def test_unspill_rebuild_failure_releases_its_reservation(monkeypatch):
    """The accounting-symmetry finding at memory/catalog._unspill_locked:
    the promotion charged the quota and then rebuilt the batch, so a
    rebuild that raised left the budget reservation counted (and the
    quota charged) for an entry still on the host. The rebuild now sits
    inside the guarded step, and the charge comes last."""
    import numpy as np

    from spark_rapids_tpu_torch import types as tt
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.memory import (
        SpillableBatch, StorageTier, buffer_catalog, memory_budget,
        register_task, reset_buffer_catalog, reset_memory_budget)
    reset_buffer_catalog(async_write=False)
    reset_memory_budget(512 * 1024)
    register_task(1)
    try:
        a = np.arange(100, dtype=np.int64)
        batch = ColumnarBatch(
            [Column.from_numpy(a, tt.LONG, device="cpu")], 100,
            tt.Schema((tt.StructField("a", tt.LONG),)))
        s = SpillableBatch.from_batch(batch)
        cat = buffer_catalog()
        cat.synchronous_spill(None)
        assert cat.tier_of(s._handle) == StorageTier.HOST
        used = memory_budget().used

        def broken(treedef, leaves):
            raise RuntimeError("rebuild failed")

        monkeypatch.setattr(ColumnarBatch, "unflatten",
                            staticmethod(broken))
        with pytest.raises(RuntimeError, match="rebuild failed"):
            s.get_batch()
        assert memory_budget().used == used
        assert cat.tier_of(s._handle) == StorageTier.HOST
        monkeypatch.undo()
        assert s.get_batch().to_pydict()["a"] == list(range(100))
        assert cat.tier_of(s._handle) == StorageTier.DEVICE
        s.close()
        assert memory_budget().used == 0
    finally:
        reset_buffer_catalog()
        reset_memory_budget()
